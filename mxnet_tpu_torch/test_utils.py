"""Test utilities — the central numeric fixture (counterpart of
``mxnet_tpu/test_utils.py``): ``assert_almost_equal`` with per-dtype
tolerances, ``check_numeric_gradient`` (finite differences against
autograd), ``check_consistency`` and ``check_grad_consistency``
(cross-context comparison: the CPU against the card, and bf16), and
``default_context``.

``list_gpus`` lists the CUDA cards torch sees; ``list_tpus`` returns ``[]``
(the port runs on no TPU), where the reference's lists its TPU devices.
"""
from __future__ import annotations

import numpy as np

from .context import Context, cpu, current_context
from .ndarray import NDArray, array
from .base import get_env

__all__ = ["list_gpus", "list_tpus",
           "default_context", "assert_almost_equal", "almost_equal", "same",
           "rand_ndarray", "rand_shape_nd", "check_numeric_gradient",
           "check_consistency", "check_grad_consistency", "max_rel_err"]

_DTOL = {
    np.dtype(np.float16): (1e-2, 1e-2),
    np.dtype(np.float32): (1e-4, 1e-5),
    np.dtype(np.float64): (1e-6, 1e-8),
}


def default_context() -> Context:
    """Env-switchable default test context (MXNET_TEST_DEFAULT_CTX=cpu|gpu,
    with an optional ``:index``)."""
    name = get_env("MXNET_TEST_DEFAULT_CTX", None)
    if name:
        dev, _, idx = name.partition(":")
        return Context(dev, int(idx or 0))
    return current_context()


def _np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return np.asarray(x)


def same(a, b) -> bool:
    return np.array_equal(_np(a), _np(b))


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False) -> bool:
    a, b = _np(a), _np(b)
    rt, at = _tols(a, b, rtol, atol)
    return np.allclose(a, b, rtol=rt, atol=at, equal_nan=equal_nan)


def _tols(a, b, rtol, atol):
    dt = np.promote_types(a.dtype, b.dtype) if a.dtype.kind == "f" else np.dtype(np.float32)
    drt, dat = _DTOL.get(np.dtype(dt), (1e-4, 1e-5))
    return rtol if rtol is not None else drt, atol if atol is not None else dat


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"), equal_nan=False):
    a_, b_ = _np(a), _np(b)
    rt, at = _tols(a_, b_, rtol, atol)
    if a_.shape != b_.shape:
        raise AssertionError(f"shape mismatch: {names[0]}{a_.shape} vs {names[1]}{b_.shape}")
    if not np.allclose(a_, b_, rtol=rt, atol=at, equal_nan=equal_nan):
        err = np.abs(a_.astype(np.float64) - b_.astype(np.float64))
        rel = err / (np.abs(b_.astype(np.float64)) + at)
        idx = np.unravel_index(np.argmax(rel), rel.shape)
        raise AssertionError(
            f"{names[0]} != {names[1]} (rtol={rt}, atol={at}): max abs err "
            f"{err.max():.3e}, max rel err {rel.max():.3e} at {idx}: "
            f"{a_[idx]!r} vs {b_[idx]!r}")


def rand_shape_nd(ndim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=ndim))


def rand_ndarray(shape, stype="default", density=None, dtype=None, ctx=None,
                 scale=1.0) -> NDArray:
    arr = (np.random.uniform(-scale, scale, size=shape)).astype(dtype or np.float32)
    return array(arr, ctx=ctx or default_context())


def check_numeric_gradient(fn, inputs, eps=1e-3, rtol=1e-2, atol=1e-3):
    """Finite-difference check of autograd gradients.

    ``fn(*ndarrays) -> NDArray scalar-or-any`` is run under autograd.record;
    its sum is backprop'd and each input's .grad is compared against central
    differences. (Reference check_numeric_gradient semantics, adapted to a
    functional callable instead of a Symbol.)
    """
    from . import autograd

    inputs = [x if isinstance(x, NDArray) else array(x) for x in inputs]
    for x in inputs:
        x.attach_grad()
    with autograd.record():
        out = fn(*inputs)
        loss = out.sum()
    loss.backward()
    analytic = [x.grad.asnumpy().copy() for x in inputs]

    for i, x in enumerate(inputs):
        base = x.asnumpy().astype(np.float64)
        num = np.zeros_like(base)
        flat = base.reshape(-1)
        gflat = num.reshape(-1)
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            fp = float(fn(*[array(base.reshape(x.shape).astype(x.dtype)) if k == i else inputs[k]
                            for k in range(len(inputs))]).sum().asscalar())
            flat[j] = orig - eps
            fm = float(fn(*[array(base.reshape(x.shape).astype(x.dtype)) if k == i else inputs[k]
                            for k in range(len(inputs))]).sum().asscalar())
            flat[j] = orig
            gflat[j] = (fp - fm) / (2 * eps)
        assert_almost_equal(analytic[i], num.astype(np.float32), rtol=rtol, atol=atol,
                            names=(f"autograd_grad[{i}]", f"numeric_grad[{i}]"))


def max_rel_err(a, b, atol=1e-8):
    """max |a-b| / (|b| + atol) — the error actually recorded by the
    consistency artifacts (a bare ok-boolean hides how close a pass was)."""
    a = _np(a).astype(np.float64)
    b = _np(b).astype(np.float64)
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b) / (np.abs(b) + atol)))


def check_consistency(fn, inputs, ctx_list=None, dtypes=("float32",), rtol=None, atol=None):
    """Run ``fn`` across contexts/dtypes and cross-compare (the reference's
    ``check_consistency``). Returns the worst observed max_rel_err across
    comparisons."""
    ctx_list = ctx_list or [cpu(), default_context()]
    ref = None
    worst = 0.0
    for ctx in ctx_list:
        for dt in dtypes:
            args = [array(_np(x), ctx=ctx, dtype=dt) for x in inputs]
            out = _np(fn(*args))
            if ref is None:
                ref = out
            else:
                rt = rtol if rtol is not None else (1e-2 if dt in ("float16", "bfloat16") else 1e-4)
                at = atol if atol is not None else (1e-2 if dt in ("float16", "bfloat16") else 1e-5)
                assert_almost_equal(out.astype(np.float32), ref.astype(np.float32),
                                    rtol=rt, atol=at, names=(f"{ctx}/{dt}", "ref"))
                worst = max(worst, max_rel_err(out, ref, atol=at))
    return worst


def check_grad_consistency(fn, inputs, ctx_list=None, dtype="float32",
                           rtol=None, atol=None, wrt=None):
    """Forward AND backward cross-context check (the reference's
    ``check_consistency`` runs both directions).

    ``fn(*ndarrays) -> NDArray`` runs under autograd.record on each context;
    a fixed linspace cotangent weights the output (catches permutation /
    sign bugs a plain sum() would mask), then every input gradient is
    cross-compared. ``wrt``: indices of differentiable inputs (default all).
    Returns worst max_rel_err over forward output + all gradients.
    """
    from . import autograd

    ctx_list = ctx_list or [cpu(), default_context()]
    rt = rtol if rtol is not None else (1e-2 if dtype in ("float16", "bfloat16") else 1e-3)
    at = atol if atol is not None else (1e-2 if dtype in ("float16", "bfloat16") else 1e-4)
    recs = []
    for ctx in ctx_list:
        args = [array(_np(x), ctx=ctx, dtype=dtype) for x in inputs]
        grad_idx = list(wrt) if wrt is not None else list(range(len(args)))
        for i in grad_idx:
            args[i].attach_grad()
        with autograd.record():
            out = fn(*args)
            if isinstance(out, (list, tuple)):
                out = out[0]
            cot = np.linspace(0.5, 1.5, int(np.prod(out.shape or (1,)))) \
                .reshape(out.shape).astype(np.float32)
            loss = (out.astype("float32") * array(cot, ctx=ctx)).sum()
        loss.backward()
        recs.append((_np(out),
                     [_np(args[i].grad) if args[i].grad is not None else None
                      for i in grad_idx]))
    ref_out, ref_grads = recs[0]
    worst = 0.0
    for j, (out, grads) in enumerate(recs[1:], start=1):
        assert_almost_equal(out.astype(np.float32), ref_out.astype(np.float32),
                            rtol=rt, atol=at,
                            names=(f"{ctx_list[j]}/fwd", "ref/fwd"))
        worst = max(worst, max_rel_err(out, ref_out, atol=at))
        for gi, (g, rg) in enumerate(zip(grads, ref_grads)):
            if (g is None) != (rg is None):
                raise AssertionError(
                    f"grad[{gi}] is {'None' if g is None else 'set'} on "
                    f"{ctx_list[j]} but {'None' if rg is None else 'set'} on "
                    f"{ctx_list[0]}")
            if g is None:
                continue
            assert_almost_equal(g.astype(np.float32), rg.astype(np.float32),
                                rtol=rt, atol=at,
                                names=(f"{ctx_list[j]}/grad[{gi}]",
                                       f"ref/grad[{gi}]"))
            worst = max(worst, max_rel_err(g, rg, atol=at))
    return worst


def list_gpus():
    """The CUDA cards torch sees, by ordinal."""
    import torch

    return list(range(torch.cuda.device_count()))


def list_tpus():
    """Always ``[]``: the port runs on CUDA cards, not TPUs."""
    return []
