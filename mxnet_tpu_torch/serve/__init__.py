"""``mxnet_tpu_torch.serve`` — batch inference with dynamic batching and
SLO-aware scheduling, and autoregressive decode serving (counterpart of
``mxnet_tpu/serve``).

Layers
------
- :class:`InferenceEngine` — bucketed batch inference over a symbolic
  graph, parameters device-resident and hot-reloadable (``engine.py``);
- :class:`DynamicBatcher` — micro-batching with deadlines, priority lanes
  and load shedding (``batcher.py``);
- :class:`ServeServer` / :class:`ServeClient` — a threaded socket front
  end on the parameter-server framing, with health and readiness probes,
  draining shutdown, hot model reload and token streaming (``server.py``,
  ``client.py``; the wire is byte-identical with the reference's);
- :class:`DecodeEngine` / :class:`DecodeScheduler` — the paged-KV decode
  engine and its continuous-batching scheduler (``decode.py``, the page
  pool in ``kvcache.py``), which ``ServeServer(decode=...)`` streams.

The replica fleet and the autoscaler (``fleet.py``, ``autoscale.py``) are
queue item A13(b) of the port; the persisted programs of
:func:`ship_programs` are A15.

Typical session::

    import mxnet_tpu_torch as mx

    engine = mx.serve.load("model/ckpt", epoch=3)        # any artifact kind
    engine.warmup((3, 224, 224))                         # every bucket
    server = mx.serve.ServeServer(engine, port=9191)
    server.start()
    ...
    client = mx.serve.ServeClient("localhost", 9191)
    probs = client.infer(batch, deadline_ms=50, priority=0)

``load`` understands three artifact kinds:

1. a ``Module.save_checkpoint`` prefix (``prefix-symbol.json`` +
   ``prefix-NNNN.params``) — ``epoch`` picks the file (default: newest);
2. a ``HybridBlock.export`` path whose descriptor embeds the traced graph;
3. a ``checkpoint/`` manager directory — pass ``symbol=``, since training
   checkpoints store only tensors.
"""
from __future__ import annotations

import glob
import json
import os
import re
from typing import Optional, Tuple

from ..base import MXNetError
from .batcher import DynamicBatcher, Future
from .client import ServeClient
from .decode import (DecodeEngine, DecodeScheduler,  # noqa: F401
                     StreamHandle, default_decode_buckets)
from .engine import (DeadlineExceeded, Draining, InferenceEngine,
                     RequestRejected, ServeError, default_buckets)
from .kvcache import PageLeakError, PagePool, PagesExhausted
from .server import ServeServer

__all__ = ["load", "load_params", "ship_programs", "programs_dir_for",
           "InferenceEngine", "DynamicBatcher", "Future", "ServeServer",
           "ServeClient", "ServeError", "RequestRejected",
           "DeadlineExceeded", "Draining", "default_buckets",
           "DecodeEngine", "DecodeScheduler", "StreamHandle",
           "default_decode_buckets", "PagePool", "PageLeakError",
           "PagesExhausted"]


def _newest_epoch(path: str) -> int:
    pat = re.compile(re.escape(os.path.basename(path))
                     + r"-(\d{4,})\.params$")
    epochs = [int(m.group(1)) for f in glob.glob(f"{path}-*.params")
              for m in [pat.match(os.path.basename(f))] if m]
    if not epochs:
        raise ServeError(f"no {path}-NNNN.params files found")
    return max(epochs)


def _split_arg_aux(params: dict, symbol) -> Tuple[dict, dict]:
    aux_names = set(symbol.list_auxiliary_states())
    arg = {k: v for k, v in params.items() if k not in aux_names}
    aux = {k: v for k, v in params.items() if k in aux_names}
    return arg, aux


def _checkpoint_dir_params(path: str, epoch: Optional[int], prefix: str):
    from ..checkpoint import CheckpointManager

    mgr = CheckpointManager(path, prefix=prefix)
    state = mgr.load(epoch) if epoch is not None else mgr.load_latest()
    if state is None:
        raise ServeError(f"no valid checkpoint found in {path!r}")
    return state.arg_params(), state.aux_params()


def _load_artifact(path: str, epoch: Optional[int], symbol, prefix: str):
    """Resolve an artifact to ``(symbol, arg_params, aux_params)``; the
    parameters are read onto the host (the engine places them)."""
    from ..context import cpu
    from ..symbol import load_json as sym_load_json

    if os.path.isdir(path):
        if symbol is None:
            raise ServeError(
                f"{path!r} is a checkpoint directory; training checkpoints "
                "store tensors only — pass symbol= (the trained graph)")
        arg, aux = _checkpoint_dir_params(path, epoch, prefix)
        return symbol, arg, aux

    sym_file = f"{path}-symbol.json"
    if not os.path.exists(sym_file):
        raise ServeError(
            f"{path!r} is neither a checkpoint directory nor a checkpoint "
            f"prefix ({sym_file} missing)")
    with open(sym_file) as f:
        desc = json.load(f)
    if isinstance(desc, dict) and "nodes" in desc:
        # Module.save_checkpoint artifact: graph json + arg:/aux: params
        from ..model import load_checkpoint

        if epoch is None:
            epoch = _newest_epoch(path)
        sym, arg, aux = load_checkpoint(path, epoch, ctx=cpu())
        return (symbol or sym), arg, aux
    if isinstance(desc, dict) and desc.get("format") == "mxnet_tpu-hybrid":
        # HybridBlock.export artifact: descriptor + save_parameters file
        from ..ndarray import load as nd_load

        if symbol is None:
            if "symbol" not in desc:
                raise ServeError(
                    f"{sym_file} has no embedded graph (the block does not "
                    "trace symbolically); re-export, or pass symbol=")
            symbol = sym_load_json(desc["symbol"])
        if epoch is None:
            epoch = _newest_epoch(path)
        loaded = nd_load(f"{path}-{epoch:04d}.params", ctx=cpu())
        # save_parameters keys are attribute paths; the embedded map takes
        # them to the graph's variable names
        param_map = desc.get("param_map") or {}
        renamed = {param_map.get(k, k): v for k, v in loaded.items()}
        arg, aux = _split_arg_aux(renamed, symbol)
        return symbol, arg, aux
    raise ServeError(f"unrecognized artifact descriptor {sym_file}")


def programs_dir_for(path: str) -> str:
    raise MXNetError("serve.programs_dir_for: persisted programs are queue "
                     "item A15 of the port")


def ship_programs(engine: InferenceEngine, path: str) -> int:
    raise MXNetError("serve.ship_programs: persisted programs are queue "
                     "item A15 of the port")


def load(path: str, epoch: Optional[int] = None, symbol=None, *,
         prefix: str = "ckpt", **engine_kwargs) -> InferenceEngine:
    """Build an :class:`InferenceEngine` from any trained artifact (see
    the module docstring for the three kinds). Extra kwargs go to the
    engine (``max_batch_size``, ``buckets``, ``data_names``, ``lint``,
    ``ctx``)."""
    sym, arg, aux = _load_artifact(path, epoch, symbol, prefix)
    return InferenceEngine(sym, arg, aux, **engine_kwargs)


def load_params(path: str, epoch: Optional[int] = None, *,
                prefix: str = "ckpt", symbol=None) -> Tuple[dict, dict]:
    """Load just ``(arg_params, aux_params)`` from an artifact — the hot
    reload path (``ServeServer.reload`` / ``engine.reload``)."""
    if os.path.isdir(path):
        return _checkpoint_dir_params(path, epoch, prefix)
    _sym, arg, aux = _load_artifact(path, epoch, symbol, prefix)
    return arg, aux
