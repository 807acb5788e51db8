"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one: the same public names and semantics,
on ``torch`` tensors on ``cuda`` devices, with every Pallas kernel of the
reference rewritten by hand for Hopper (``csrc/``). The port goes slice by
slice. It serves a causal TransformerLM through the paged-KV decode
engine:

    DecodeScheduler -> DecodeEngine -> lm_prefill / paged decode step
    -> ops.flash_attention.decode_attention -> csrc/paged_decode_attention.cu

and trains it:

    parallel.ShardedTrainer.step -> TransformerLM.forward
    -> TransformerEncoderCell -> multi_head_attention
    -> ops.attention.fused_attention -> ops.flash_attention.flash_attention
    -> csrc/flash_attention_fwd.cu (forward), csrc/flash_attention_bwd.cu
       (backward, through torch.autograd)
    -> gluon.loss.SoftmaxCrossEntropyLoss, optimizer.fused.lower_update

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise (``context.py``).
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

from .base import MXNetError, get_env  # noqa: E402,F401
from .context import cpu, default_device, gpu  # noqa: E402,F401

_SUBMODULES = ("gluon", "models", "ops", "optimizer", "parallel", "serve")


def __getattr__(name):
    # lazy submodules keep `import mxnet_tpu_torch` light and cycle-free
    if name in _SUBMODULES:
        return _importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
