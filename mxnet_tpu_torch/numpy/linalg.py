"""``mx.np.linalg`` — numpy-frontend linear algebra (counterpart of
``mxnet_tpu/numpy/linalg.py``).

Thin wrappers over ``torch.linalg`` with numpy's signatures and return
conventions, recorded on the autograd tape; integer inputs compute in
float32 (no result is 64-bit). ``eig``/``eigvals`` return complex arrays,
as the reference's.
"""
from __future__ import annotations

import torch

from ..ndarray import NDArray
from ..ndarray.ndarray import invoke_fn
from ._ops import _fix, _nd, _to_float

__all__ = ["norm", "svd", "cholesky", "inv", "det", "slogdet", "eig",
           "eigh", "eigvals", "eigvalsh", "qr", "solve", "lstsq",
           "matrix_rank", "matrix_power", "pinv", "multi_dot",
           "tensorinv", "tensorsolve"]


def _call(fn, arrays, **kwargs):
    like = next((a for a in arrays if isinstance(a, NDArray)), None)
    return invoke_fn(lambda *ts: _fix(fn(*[_to_float(t) for t in ts],
                                        **kwargs)),
                     [_nd(a, like) for a in arrays])


def _norm(x, ord=None, axis=None, keepdims=False):
    if axis is None and ord is None:
        return torch.linalg.vector_norm(x.reshape(-1), 2).reshape(
            (1,) * x.dim() if keepdims else ())
    dim = (axis,) if isinstance(axis, int) else axis
    if (dim is not None and len(dim) == 1) or (dim is None and x.dim() == 1):
        o = 2 if ord is None else ord
        if isinstance(o, str):
            raise ValueError(f"Invalid order '{o}' for vector norm.")
        return torch.linalg.vector_norm(x, o, dim=dim or 0, keepdim=keepdims)
    return torch.linalg.matrix_norm(x, "fro" if ord is None else ord,
                                    dim=dim or (-2, -1), keepdim=keepdims)


def norm(x, ord=None, axis=None, keepdims=False):
    return _call(_norm, [x], ord=ord, axis=axis, keepdims=keepdims)


def svd(a, full_matrices=True, compute_uv=True, hermitian=False):
    if not compute_uv:
        return _call(torch.linalg.svdvals, [a])
    return _call(lambda t: tuple(torch.linalg.svd(
        t, full_matrices=full_matrices)), [a])


def cholesky(a):
    return _call(torch.linalg.cholesky, [a])


def inv(a):
    return _call(torch.linalg.inv, [a])


def det(a):
    return _call(torch.linalg.det, [a])


def slogdet(a):
    return _call(lambda t: tuple(torch.linalg.slogdet(t)), [a])


def eig(a):
    return _call(lambda t: tuple(torch.linalg.eig(t)), [a])


def eigh(a, UPLO="L"):
    return _call(lambda t: tuple(torch.linalg.eigh(t, UPLO=UPLO)), [a])


def eigvals(a):
    return _call(torch.linalg.eigvals, [a])


def eigvalsh(a, UPLO="L"):
    return _call(lambda t: torch.linalg.eigvalsh(t, UPLO=UPLO), [a])


def qr(a, mode="reduced"):
    if mode == "r":
        return _call(lambda t: torch.linalg.qr(t, mode="r")[1], [a])
    return _call(lambda t: tuple(torch.linalg.qr(t, mode=mode)), [a])


def _solve(a, b):
    """The reference's shapes (``jnp.linalg.solve`` since JAX 0.5): a 1-D
    ``b`` is one vector, any other ``b`` a stack of matrices broadcast
    against ``a``; a ``b`` that would read as a batch of vectors raises."""
    if a.dim() < 2:
        raise ValueError("left hand array must be at least two dimensional; "
                         f"got a.shape={tuple(a.shape)}")
    if (b.dim() > 1 and a.dim() == b.dim() + 1 and a.shape[-1] == b.shape[-1]
            and a.shape[-1] != b.shape[-2]):
        raise ValueError(
            f"Invalid shapes for solve: {tuple(a.shape)}, {tuple(b.shape)}: "
            "a batched 1-dimensional solve; use solve(a, b[..., None])"
            ".squeeze(-1)")
    if b.dim() == 1:
        return torch.linalg.solve(a, b.unsqueeze(-1)).squeeze(-1)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    return torch.linalg.solve(a.expand(batch + a.shape[-2:]),
                              b.expand(batch + b.shape[-2:]))


def solve(a, b):
    return _call(_solve, [a, b])


def _lstsq(a, b, rcond=None):
    """``jnp.linalg.lstsq``'s ``(x, residuals, rank, s)`` through the SVD:
    singular values below ``rcond`` times the largest are dropped, and the
    residuals (shape ``(K,)``, ``(1,)`` for a 1-D ``b``) are always
    returned, where numpy leaves them empty unless m > n at full rank."""
    m, n = a.shape[-2], a.shape[-1]
    b2 = b.unsqueeze(-1) if b.dim() == 1 else b
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    eps = torch.finfo(a.dtype).eps
    rc = eps * max(m, n) if rcond is None else (eps if rcond < 0 else rcond)
    mask = (s > 0) & (s >= rc * s[0])
    s_inv = torch.where(mask, 1 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s)).unsqueeze(-1)
    x = vh.mH @ (s_inv * (u.mH @ b2))
    r = b2 - a @ x
    res = torch.sum(r * r, dim=0)
    return (x.reshape(-1) if b.dim() == 1 else x), res, \
        mask.sum().to(torch.int32), s


def lstsq(a, b, rcond="warn"):
    rc = None if rcond in ("warn", None) else rcond
    return _call(_lstsq, [a, b], rcond=rc)


def matrix_rank(a, tol=None, hermitian=False):
    if hermitian:
        raise NotImplementedError(
            "np.linalg.matrix_rank(hermitian=True) is not supported")

    def rank(t):
        if t.dim() < 2:  # a vector has rank 1 unless it is all zeros
            return torch.any(t != 0).to(torch.int32)
        s = torch.linalg.svdvals(t)
        cut = (s.max(-1, keepdim=True).values * max(t.shape[-2:])
               * torch.finfo(t.dtype).eps) if tol is None else tol
        return torch.sum(s > cut, dim=-1).to(torch.int32)
    return _call(rank, [a])


def _int_matmul(x, y):
    """An integer product in the operands' dtype (wrapping as XLA's does;
    cuBLAS has no integer product)."""
    return (x.unsqueeze(-1) * y.unsqueeze(-3)).sum(-2, dtype=x.dtype)


def _matrix_power(t, n):
    if t.is_floating_point() or t.is_complex() or t.dtype == torch.bool \
            or n < 0:
        return torch.linalg.matrix_power(_to_float(t), n)
    out = torch.eye(t.shape[-1], dtype=t.dtype, device=t.device).expand(
        t.shape).clone()
    base = t
    while n:  # repeated squaring, as jnp.linalg.matrix_power
        if n & 1:
            out = _int_matmul(out, base)
        n >>= 1
        if n:
            base = _int_matmul(base, base)
    return out


def matrix_power(a, n):
    """Integer matrices stay integer (the power-0 identity too)."""
    return invoke_fn(lambda t: _fix(_matrix_power(t, n)), [_nd(a, None)])


def pinv(a, rcond=None, hermitian=False):
    if rcond is None:
        return _call(lambda t: torch.linalg.pinv(t, hermitian=hermitian),
                     [a])
    return _call(lambda t: torch.linalg.pinv(t, rtol=rcond,
                                             hermitian=hermitian), [a])


def multi_dot(arrays):
    return _call(lambda *ts: torch.linalg.multi_dot(list(ts)), list(arrays))


def tensorinv(a, ind=2):
    return _call(lambda t: torch.linalg.tensorinv(t, ind=ind), [a])


def tensorsolve(a, b, axes=None):
    return _call(lambda x, y: torch.linalg.tensorsolve(x, y, dims=axes),
                 [a, b])
