"""``mx.np.random`` — numpy-frontend random sampling (counterpart of
``mxnet_tpu/numpy/random.py``).

Draws come from the framework's torch generator (``random.generator``, the
stream ``mx.random.seed`` governs, as the random ops draw), on the device
of the current context (or ``ctx=``). Shapes and dtypes are the
reference's — the default float is float32, integers are int32 — and the
values match it in distribution only (JAX's streams differ from torch's).
"""
from __future__ import annotations

import numpy as _onp
import torch

from ..ndarray import NDArray
from ..ops.random_ops import _device, _exponential, _gamma, _gen, _normal, \
    _uniform
from ..random import seed  # noqa: F401  (re-export seed)

__all__ = ["seed", "uniform", "normal", "randint", "rand", "randn",
           "choice", "shuffle", "permutation", "exponential", "gamma",
           "beta", "chisquare", "gumbel", "laplace", "logistic",
           "lognormal", "pareto", "power", "rayleigh", "weibull",
           "multinomial", "multivariate_normal"]


def _pshape(p):
    if isinstance(p, NDArray):
        return tuple(p.shape)
    return _onp.shape(p)


def _size(size, *params):
    """Draw shape: explicit ``size`` wins (and must be broadcast-compatible
    with the parameter shapes, as in numpy); otherwise the broadcast of the
    parameters' shapes, one independent draw per element."""
    pshapes = [_pshape(p) for p in params]
    if size is None:
        return tuple(_onp.broadcast_shapes(*pshapes)) if pshapes else ()
    shape = (size,) if isinstance(size, int) else tuple(size)
    if pshapes and tuple(_onp.broadcast_shapes(shape, *pshapes)) != shape:
        raise ValueError(
            f"size {shape} is not broadcast-compatible with parameter "
            f"shapes {pshapes} (numpy raises here too)")
    return shape


def _f(x, dev):
    if isinstance(x, NDArray):
        x = x._data
    return torch.as_tensor(x, dtype=torch.float32, device=dev) \
        if not isinstance(x, torch.Tensor) else x.to(dev, torch.float32)


def _wrap(x, dtype=None, out=None):
    if dtype is not None:
        from ..base import dtype_torch

        x = x.to(dtype_torch(dtype))
    if out is not None:
        if not isinstance(out, NDArray):
            raise TypeError("out= must be an mx.np.ndarray")
        out._set_data(x.to(out._data.dtype))
        return out
    return NDArray(x)


def _no_out(name, out):
    if out is not None:
        raise NotImplementedError(
            f"np.random.{name}: out= is not supported; assign the result")


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None, out=None):
    dev = _device(ctx)
    u = _uniform(_size(size, low, high), dev)
    return _wrap(_f(low, dev) + u * (_f(high, dev) - _f(low, dev)), dtype,
                 out)


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None, out=None):
    dev = _device(ctx)
    z = _normal(_size(size, loc, scale), dev)
    return _wrap(_f(loc, dev) + _f(scale, dev) * z, dtype, out)


def randint(low, high=None, size=None, dtype=None, ctx=None, out=None):
    if high is None:
        low, high = 0, low
    dev = _device(ctx)
    r = torch.randint(int(low), int(high), _size(size), generator=_gen(dev),
                      device=dev, dtype=torch.int32)
    return _wrap(r, dtype, out)


def rand(*size):
    return uniform(size=size or None)


def randn(*size):
    return normal(size=size or None)


def choice(a, size=None, replace=True, p=None, ctx=None, out=None):
    _no_out("choice", out)
    dev = _device(ctx)
    if isinstance(a, int):
        arr = torch.arange(a, dtype=torch.int32, device=dev)
    elif isinstance(a, NDArray):
        arr = a._data
    else:
        arr = NDArray(_onp.asarray(a))._data.to(dev)
    shape = _size(size)
    n = int(_onp.prod(shape)) if shape else 1
    g = _gen(arr.device)
    if p is not None:
        pp = _f(p, arr.device)
        idx = torch.multinomial(pp, n, replacement=replace, generator=g)
    elif replace:
        idx = torch.randint(0, arr.shape[0], (n,), generator=g,
                            device=arr.device)
    else:
        idx = torch.randperm(arr.shape[0], generator=g,
                             device=arr.device)[:n]
    return _wrap(arr[idx].reshape(shape + tuple(arr.shape[1:])))


def permutation(x):
    dev = _device(None) if not isinstance(x, NDArray) else x._data.device
    if isinstance(x, int):
        return _wrap(torch.randperm(x, generator=_gen(dev), device=dev)
                     .to(torch.int32))
    arr = x._data if isinstance(x, NDArray) else \
        NDArray(_onp.asarray(x))._data.to(dev)
    return _wrap(arr[torch.randperm(arr.shape[0], generator=_gen(dev),
                                    device=dev)])


def shuffle(x):
    """In place along axis 0 (mutates ``x``, as the reference)."""
    if not isinstance(x, NDArray):
        raise TypeError("np.random.shuffle needs an mx.np.ndarray")
    dev = x._data.device
    x._set_data(x._data[torch.randperm(x.shape[0], generator=_gen(dev),
                                       device=dev)])


def exponential(scale=1.0, size=None, ctx=None, out=None):
    _no_out("exponential", out)
    dev = _device(ctx)
    return _wrap(_f(scale, dev) * _exponential(_size(size, scale), dev))


def gamma(shape, scale=1.0, size=None, ctx=None, out=None):
    _no_out("gamma", out)
    dev = _device(ctx)
    s = _size(size, shape, scale)
    return _wrap(_f(scale, dev) * _gamma(_f(shape, dev), s, dev))


def beta(a, b, size=None, ctx=None, out=None):
    _no_out("beta", out)
    dev = _device(ctx)
    s = _size(size, a, b)
    x = _gamma(_f(a, dev), s, dev)
    y = _gamma(_f(b, dev), s, dev)
    return _wrap(x / (x + y))


def chisquare(df, size=None, ctx=None, out=None):
    _no_out("chisquare", out)
    dev = _device(ctx)
    return _wrap(2.0 * _gamma(_f(df, dev) / 2.0, _size(size, df), dev))


def gumbel(loc=0.0, scale=1.0, size=None, ctx=None, out=None):
    _no_out("gumbel", out)
    dev = _device(ctx)
    u = _uniform(_size(size, loc, scale), dev).clamp(min=1e-12)
    return _wrap(_f(loc, dev) - _f(scale, dev) * torch.log(-torch.log(u)))


def laplace(loc=0.0, scale=1.0, size=None, ctx=None, out=None):
    _no_out("laplace", out)
    dev = _device(ctx)
    u = _uniform(_size(size, loc, scale), dev) - 0.5
    return _wrap(_f(loc, dev) - _f(scale, dev) * torch.sign(u)
                 * torch.log1p(-2.0 * torch.abs(u)))


def logistic(loc=0.0, scale=1.0, size=None, ctx=None, out=None):
    _no_out("logistic", out)
    dev = _device(ctx)
    u = _uniform(_size(size, loc, scale), dev).clamp(1e-12, 1 - 1e-7)
    return _wrap(_f(loc, dev) + _f(scale, dev) * torch.log(u / (1 - u)))


def lognormal(mean=0.0, sigma=1.0, size=None, ctx=None, out=None):
    _no_out("lognormal", out)
    dev = _device(ctx)
    z = _normal(_size(size, mean, sigma), dev)
    return _wrap(torch.exp(_f(mean, dev) + _f(sigma, dev) * z))


def pareto(a, size=None, ctx=None, out=None):
    _no_out("pareto", out)
    dev = _device(ctx)
    e = _exponential(_size(size, a), dev)
    return _wrap(torch.exp(e / _f(a, dev)) - 1.0)


def power(a, size=None, ctx=None, out=None):
    _no_out("power", out)
    dev = _device(ctx)
    u = _uniform(_size(size, a), dev)
    return _wrap(u ** (1.0 / _f(a, dev)))


def rayleigh(scale=1.0, size=None, ctx=None, out=None):
    _no_out("rayleigh", out)
    dev = _device(ctx)
    u = _uniform(_size(size, scale), dev).clamp(min=1e-12)
    return _wrap(_f(scale, dev) * torch.sqrt(-2.0 * torch.log(u)))


def weibull(a, size=None, ctx=None, out=None):
    _no_out("weibull", out)
    dev = _device(ctx)
    e = _exponential(_size(size, a), dev)
    return _wrap(e ** (1.0 / _f(a, dev)))


def multinomial(n, pvals, size=None):
    dev = _device(None)
    shape = _size(size)
    pv = _f(pvals, dev)
    k = pv.shape[-1]
    rows = int(_onp.prod(shape)) if shape else 1
    draws = torch.multinomial(pv.expand(rows, k), int(n), replacement=True,
                              generator=_gen(dev))
    counts = torch.zeros(rows, k, dtype=torch.int32, device=dev)
    counts.scatter_add_(1, draws, torch.ones_like(draws, dtype=torch.int32))
    return _wrap(counts.reshape(shape + (k,)))


def multivariate_normal(mean, cov, size=None, check_valid="warn", tol=1e-8):
    dev = _device(None)
    m = _f(mean, dev)
    c = _f(cov, dev)
    shape = _size(size)
    z = _normal(shape + (m.shape[-1],), dev)
    # numpy factors the covariance by SVD: cov = U S V^T, x = m + z sqrt(S) V
    _u, s, vh = torch.linalg.svd(c)
    return _wrap(m + (z * torch.sqrt(s)) @ vh)
