"""Control flow: ``foreach``, ``while_loop`` and ``cond`` (counterpart of
``mxnet_tpu/ops/control_flow.py``), exposed as ``nd.contrib.*``.

Each is a Python loop (or branch) over the body, whose ops autograd
records one by one, so gradients flow through every step, as through
the reference's ``lax.scan``/``lax.while_loop``/``lax.cond``.
``while_loop`` reads its condition on the host once a step, and stacks
the step outputs into ``max_iterations`` rows padded with zeros, as the
reference does.
"""
from __future__ import annotations

from typing import Callable

__all__ = ["foreach", "while_loop", "cond"]


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _truth(v) -> bool:
    """A predicate's value (an NDArray, tensor or Python scalar) read on
    the host."""
    import numpy as np

    if hasattr(v, "asnumpy"):
        v = v.asnumpy()
    elif hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return bool(np.asarray(v).reshape(()))


def foreach(body: Callable, data, init_states):
    """Run ``body(item, states) -> (out, new_states)`` over axis 0 of
    ``data``; returns (the outputs stacked on axis 0, the final states)."""
    from ..ndarray import stack

    single_data = not isinstance(data, (list, tuple))
    single_state = not isinstance(init_states, (list, tuple))
    data_list, state_list = _as_list(data), _as_list(init_states)
    states = state_list
    rows, out_single = [], True
    for t in range(data_list[0].shape[0]):
        x = [d[t] for d in data_list]
        out, new_states = body(x[0] if single_data else x,
                               states[0] if single_state else states)
        out_single = not isinstance(out, (list, tuple))
        rows.append(_as_list(out))
        states = _as_list(new_states)
    outs = [stack(*[r[i] for r in rows], axis=0)
            for i in range(len(rows[0]))] if rows else []
    out = outs[0] if outs and (out_single or len(outs) == 1) else outs
    return out, states[0] if single_state else states


def while_loop(cond_fn: Callable, func: Callable, loop_vars,
               max_iterations=None):
    """Run ``func(vars) -> (out, new_vars)`` while ``cond_fn(vars)`` holds,
    at most ``max_iterations`` times (required, as the reference). Returns
    (the outputs stacked into ``max_iterations`` rows, zero past the last
    step; the final loop variables)."""
    from .. import autograd
    from ..ndarray import concat, stack, zeros

    assert max_iterations is not None and max_iterations > 0, \
        "max_iterations is required"
    single = not isinstance(loop_vars, (list, tuple))
    lv = _as_list(loop_vars)
    vars_ = lv
    rows, out_single = [], True

    def arg(v):
        return v[0] if single else v

    while len(rows) < max_iterations and _truth(cond_fn(arg(vars_))):
        out, new_vars = func(arg(vars_))
        out_single = not isinstance(out, (list, tuple))
        rows.append(_as_list(out))
        vars_ = _as_list(new_vars)
    if rows:
        likes = rows[0]
    else:  # probe once for the outputs' shapes
        with autograd.pause():
            out, _ = func(arg(vars_))
        out_single = not isinstance(out, (list, tuple))
        likes = _as_list(out)
    bufs = []
    for i, like in enumerate(likes):
        pad = zeros((max_iterations - len(rows),) + like.shape,
                    ctx=like.context, dtype=like.dtype)
        if not rows:
            bufs.append(pad)
            continue
        steps = stack(*[r[i] for r in rows], axis=0)
        bufs.append(concat(steps, pad, dim=0)
                    if len(rows) < max_iterations else steps)
    out = bufs[0] if out_single or len(bufs) == 1 else bufs
    return out, arg(vars_)


def cond(pred_fn_or_val, then_func: Callable, else_func: Callable,
         inputs=None):
    """``then_func(inputs)`` if the predicate holds, else
    ``else_func(inputs)``; the predicate is a callable over the inputs or
    a boolean NDArray/scalar."""
    single = not isinstance(inputs, (list, tuple)) and inputs is not None
    ins = [] if inputs is None else _as_list(inputs)
    arg = (ins[0] if single else ins) if ins else None
    p = pred_fn_or_val(arg) if callable(pred_fn_or_val) else pred_fn_or_val
    r = _as_list(then_func(arg) if _truth(p) else else_func(arg))
    return r[0] if len(r) == 1 else tuple(r)
