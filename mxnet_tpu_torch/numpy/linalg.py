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
    if dim is not None and len(dim) == 1:
        o = 2 if ord is None else ord
        return torch.linalg.vector_norm(x, o, dim=dim, keepdim=keepdims)
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
    if b.dim() == 1:
        return torch.linalg.solve(a, b.unsqueeze(-1)).squeeze(-1)
    return torch.linalg.solve(a, b)


def solve(a, b):
    return _call(_solve, [a, b])


def _lstsq(a, b, rcond=None):
    """numpy's ``(x, residuals, rank, s)`` through the pseudo-inverse (the
    card's ``torch.linalg.lstsq`` driver reports neither rank nor s)."""
    s = torch.linalg.svdvals(a)
    m, n = a.shape[-2], a.shape[-1]
    cutoff = (torch.finfo(a.dtype).eps * max(m, n) if rcond is None
              else rcond) * s.max()
    rank = torch.sum(s > cutoff)
    x = torch.linalg.pinv(a, atol=cutoff) @ b
    if int(rank) == n and m > n:
        r = b - a @ x
        res = torch.sum(r * r, dim=0).reshape(-1)
    else:
        res = torch.zeros((0,), dtype=a.dtype, device=a.device)
    return x, res, rank.to(torch.int32), s


def lstsq(a, b, rcond="warn"):
    rc = None if rcond in ("warn", None) else rcond
    return _call(_lstsq, [a, b], rcond=rc)


def matrix_rank(a, tol=None, hermitian=False):
    if hermitian:
        raise NotImplementedError(
            "np.linalg.matrix_rank(hermitian=True) is not supported")

    def rank(t):
        s = torch.linalg.svdvals(t)
        cut = (s.max(-1, keepdim=True).values * max(t.shape[-2:])
               * torch.finfo(t.dtype).eps) if tol is None else tol
        return torch.sum(s > cut, dim=-1).to(torch.int32)
    return _call(rank, [a])


def matrix_power(a, n):
    return _call(lambda t: torch.linalg.matrix_power(t, n), [a])


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
