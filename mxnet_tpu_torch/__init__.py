"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one: the same public names and semantics,
on ``torch`` tensors on ``cuda`` devices, with every Pallas kernel of the
reference rewritten by hand for Hopper (``csrc/``). The port goes slice by
slice. It serves a causal TransformerLM through the paged-KV decode
engine:

    DecodeScheduler -> DecodeEngine -> lm_prefill / paged decode step
    -> ops.flash_attention.decode_attention -> csrc/paged_decode_attention.cu

and trains it, with the vision model zoo and BERT, the reference's
benchmark way:

    mesh = parallel.make_mesh({"dp": 1})
    trainer = parallel.ShardedTrainer(net, loss_fn, mesh, ...)
    -> parallel.functionalize(net) -> the Gluon block's forward over the
       trainer's parameter values (gluon.block.run_bound)
    -> models.transformer.MultiHeadAttention
       -> ops.attention.fused_attention -> ops.flash_attention
       -> csrc/flash_attention_fwd.cu (forward), csrc/flash_attention_bwd.cu
          (backward, through torch.autograd)
    -> gluon.nn conv/BN/pool layers -> ops.nn Convolution (cuDNN),
       BatchNorm, Pooling (gluon.model_zoo.vision)
    -> gluon.loss.SoftmaxCrossEntropyLoss, optimizer.fused.lower_update

and trains it imperatively, the reference's way, and as a Gluon block:

    from mxnet_tpu_torch import autograd, nd
    with autograd.record(): loss = ...; loss.backward()
    -> nd.* -> ndarray.invoke -> the registered ops (ops/registry.py), on
       the torch.autograd tape; attention through
       invoke_fn(ops.attention.fused_attention) -> the flash kernels
    -> nd.sgd_update(w, g, out=w)

    net = models.transformer_lm(); net.initialize(); net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam", {...})
    with autograd.record(): loss = loss_fn(net(x), y)
    loss.backward(); trainer.step(batch)
    -> gluon.HybridBlock / CachedOp -> the same registered ops and
       attention (models/transformer.py MultiHeadAttention)
    -> optimizer.Updater.update_batch -> optimizer.fused (multi-tensor)

and trains it symbolically, the reference's classic way:

    data = mx.sym.var("data", shape=(B, S)); logits = net(data)
    out = mx.sym.SoftmaxOutput(logits.reshape((-1, V)), ...)
    mod = mx.mod.Module(out, context=mx.gpu(0)); mod.bind(...)
    mod.init_params(arg_params=...); mod.init_optimizer("adam", ...)
    mod.forward_backward(batch); mod.update()   (or mod.fit(NDArrayIter))
    -> gluon.HybridBlock traced to a symbol.Symbol (the same op names;
       attention an invoke_fn node) -> executor.Executor: the graph as
       one function of its argument tensors on the torch.autograd tape
       -> the registered ops and the flash kernels
    -> optimizer.Updater.update_batch; checkpoints through
       ndarray.serialization (.params, the reference's bytes) and
       checkpoint.CheckpointManager

and feeds them from the data plane:

    loader = gluon.data.DataLoader(dataset, batch_size, num_workers=4,
                                   pin_memory=True)
    it = io.PrefetchingIter(io.ImageRecordIter(path_imgrec=..., ...))
    -> samples, transforms and batches made on the host (numpy, PIL, the
       C++ RecordIO + JPEG decoder of native/ built by native.py), one
       copy per batch to the card (pinned, non_blocking; the prefetcher's
       own CUDA stream)
    -> gluon.contrib.estimator.Estimator(net, loss, trainer=...).fit(loader)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``ctx=mx.cpu()``, ``with mx.cpu():`` for ``nd``); with no card and no
explicit CPU request they raise (``context.py``).
Importing the package builds no kernel: ``ops/_kernels.py`` compiles a
kernel at its first launch.
"""
from __future__ import annotations

import importlib as _importlib

import torch as _torch

__version__ = "0.1.0"

# fp32 matmuls are true fp32, the reference's promise
# (jax_default_matmul_precision=highest): no TF32 in cuBLAS or cuDNN.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .base import GraphAnalysisError, MXNetError, get_env  # noqa: E402,F401
from .context import (Context, cpu, cpu_pinned,  # noqa: E402,F401
                      current_context, default_device, gpu, num_gpus)

_SUBMODULES = ("amp", "analysis", "attribute", "autograd", "callback",
               "chaos", "checkpoint", "contrib", "engine", "executor",
               "gluon", "image", "initializer", "io", "kvstore", "metric",
               "model", "models", "module", "monitor", "name", "native",
               "ndarray", "obs", "operator", "ops", "optimizer", "parallel",
               "platform", "profiler", "random", "registry", "rnn",
               "runtime", "serve", "subgraph",
               "symbol", "test_utils", "util", "visualization")
# the reference's short names
_ALIASES = {"nd": "ndarray", "init": "initializer", "sym": "symbol",
            "mod": "module", "mon": "monitor", "viz": "visualization",
            "recordio": "io.recordio", "np": "numpy", "kv": "kvstore",
            "npx": "numpy_extension", "lr_scheduler": "optimizer.lr_scheduler"}


def __getattr__(name):
    # lazy submodules keep `import mxnet_tpu_torch` light and cycle-free
    if name in _SUBMODULES or name in _ALIASES:
        return _importlib.import_module(f".{_ALIASES.get(name, name)}",
                                        __name__)
    if name == "NDArray":
        from .ndarray import NDArray

        return NDArray
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
