"""Lift a Gluon block into a function of a parameter dict (counterpart of
``mxnet_tpu/parallel/functional.py``).

The reference runs the forward unrecorded, since ``jax.value_and_grad``
traces it. Here torch records what the forward's ops do only while
``autograd`` records, so ``apply`` turns recording on around the forward:
its result carries the graph to the given tensors, and the caller takes
``torch.autograd.grad`` with respect to them. No ``NDArray.grad`` is
written: nothing calls ``backward``. The parameters are swapped in and
restored by ``gluon.block.run_bound``, the same code a hybridized block's
cached op runs.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from .. import autograd
from ..gluon.block import run_bound
from ..ndarray import NDArray

__all__ = ["functionalize"]


def functionalize(net, train: bool = True) -> Tuple[List[str], Callable]:
    """Return ``(param_names, apply)`` where
    ``apply(param_vals, *inputs) -> (outputs, aux_updates)``.

    - ``param_vals``: dict name -> tensor (a leaf that requires grad, or a
      cast of one), keyed by ``Parameter.name``.
    - ``outputs``: a tensor or a tuple of them.
    - ``aux_updates``: dict name -> new value of each parameter the
      forward rebound (BatchNorm's running statistics); merge these back
      after the step.
    """
    params = [p for p in net._iter_params() if p._data is not None]
    names = [p.name for p in params]
    if len(set(names)) != len(names):
        raise ValueError("duplicate parameter names; cannot functionalize")

    def apply(param_vals: Dict[str, torch.Tensor], *inputs):
        in_nds = [x if isinstance(x, NDArray) else NDArray(x)
                  for x in inputs]

        def forward():
            with autograd._Scope(True, train):
                return net(*in_nds)

        out, aux = run_bound(params, [param_vals[n] for n in names],
                             forward)
        aux = {names[i]: v for i, v in aux.items()}
        if isinstance(out, (list, tuple)):
            return tuple(o._data for o in out), aux
        return out._data, aux

    return names, apply
