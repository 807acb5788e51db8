"""Random sampling operators (counterpart of
``mxnet_tpu/ops/random_ops.py``): the ``_random_*`` draws with scalar
parameters, the ``_sample_*`` draws with one distribution per element of
their tensor parameters (output shape ``param.shape + shape``),
``_sample_multinomial``, ``_shuffle``, and the ``_random_pdf_*``
densities.

Every draw comes from the framework's generator on the output's device
(``mxnet_tpu_torch.random.generator``), which ``mx.random.seed`` seeds.
Torch's generators do not give ``jax.random``'s bits, so draws match the
reference in shape, dtype and distribution, not in value. The densities
are deterministic and differentiable, and match the reference's values
and gradients.
"""
from __future__ import annotations

import math

import torch

from ..base import dtype_torch
from .registry import register

__all__ = []


def _gen(device):
    from ..random import generator

    return generator(device)


def _device(ctx):
    from ..context import as_device, current_context

    return as_device(current_context() if ctx is None else ctx)


def _dt(dtype):
    if dtype in (None, "None"):
        return torch.float32
    return dtype_torch(dtype)


def _float_dt(dtype, op):
    """``dtype`` of a draw that must be floating, as ``jax.random``
    requires."""
    dt = _dt(dtype)
    if not dt.is_floating_point:
        raise ValueError(f"dtype argument to {op} must be a float dtype, "
                         f"got {dtype}")
    return dt


def _shp(shape):
    if shape is None or shape == "None":
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _uniform(shape, device):
    return torch.rand(shape, generator=_gen(device), device=device)


def _normal(shape, device):
    return torch.randn(shape, generator=_gen(device), device=device)


def _gamma(alpha, shape, device):
    """Gamma(alpha, 1) of ``shape``; ``alpha`` a number or a tensor that
    broadcasts to it."""
    a = torch.as_tensor(alpha, dtype=torch.float32,
                        device=device).expand(shape).contiguous()
    return torch._standard_gamma(a, generator=_gen(device))


def _exponential(shape, device):
    return torch.empty(shape, device=device).exponential_(
        1.0, generator=_gen(device))


def _poisson(lam, shape, device):
    rate = torch.as_tensor(lam, dtype=torch.float32,
                           device=device).expand(shape).contiguous()
    return torch.poisson(rate, generator=_gen(device))


# ---------------------------------------------------------------------------
# _random_*: scalar-parameter draws
# ---------------------------------------------------------------------------

@register("_random_uniform", aliases=["random_uniform"],
          differentiable=False, ndarray_inputs=[])
def _random_uniform(low=0.0, high=1.0, shape=None, dtype="float32",
                    ctx=None):
    dev = _device(ctx)
    dt = _float_dt(dtype, "uniform")
    return (low + (high - low) * _uniform(_shp(shape), dev)).to(dt)


@register("_random_normal", aliases=["random_normal"], differentiable=False,
          ndarray_inputs=[])
def _random_normal(loc=0.0, scale=1.0, shape=None, dtype="float32",
                   ctx=None):
    dev = _device(ctx)
    dt = _float_dt(dtype, "normal")
    return (loc + scale * _normal(_shp(shape), dev)).to(dt)


@register("_random_gamma", aliases=["random_gamma"], differentiable=False,
          ndarray_inputs=[])
def _random_gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32",
                  ctx=None):
    dev = _device(ctx)
    dt = _float_dt(dtype, "gamma")
    return (beta * _gamma(alpha, _shp(shape), dev)).to(dt)


@register("_random_exponential", aliases=["random_exponential"],
          differentiable=False, ndarray_inputs=[])
def _random_exponential(lam=1.0, shape=None, dtype="float32", ctx=None):
    dev = _device(ctx)
    dt = _float_dt(dtype, "exponential")
    return (_exponential(_shp(shape), dev) / lam).to(dt)


@register("_random_poisson", aliases=["random_poisson"],
          differentiable=False, ndarray_inputs=[])
def _random_poisson(lam=1.0, shape=None, dtype="float32", ctx=None):
    dev = _device(ctx)
    return _poisson(lam, _shp(shape), dev).to(_dt(dtype))


@register("_random_randint", aliases=["random_randint"],
          differentiable=False, ndarray_inputs=[])
def _random_randint(low=0, high=1, shape=None, dtype="int32", ctx=None):
    dev = _device(ctx)
    dt = _dt(dtype)
    if dt.is_floating_point:
        raise TypeError(f"randint only accepts integer dtypes, got {dtype}")
    return torch.randint(int(low), int(high), _shp(shape),
                         generator=_gen(dev), device=dev).to(dt)


@register("_random_negative_binomial", aliases=["random_negative_binomial"],
          differentiable=False, ndarray_inputs=[])
def _random_negative_binomial(k=1, p=1.0, shape=None, dtype="float32",
                              ctx=None):
    # NB(k, p) = Poisson(lam) with lam ~ Gamma(k, (1-p)/p)
    dev = _device(ctx)
    lam = _gamma(float(k), _shp(shape), dev) * ((1 - p) / p)
    return _poisson(lam, _shp(shape), dev).to(_dt(dtype))


@register("_random_generalized_negative_binomial",
          aliases=["random_generalized_negative_binomial"],
          differentiable=False, ndarray_inputs=[])
def _random_gen_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", ctx=None):
    dev = _device(ctx)
    if alpha == 0.0:
        return _poisson(mu, _shp(shape), dev).to(_dt(dtype))
    k = 1.0 / alpha
    p = k / (k + mu)
    lam = _gamma(k, _shp(shape), dev) * ((1 - p) / p)
    return _poisson(lam, _shp(shape), dev).to(_dt(dtype))


# ---------------------------------------------------------------------------
# _sample_*: tensor-parameter draws; output shape = param.shape + shape
# ---------------------------------------------------------------------------

def _tensor_draw(draw, params, shape, dtype):
    shape = _shp(shape)
    out_shape = tuple(params[0].shape) + shape
    wide = [p.to(torch.float32).reshape(tuple(p.shape) + (1,) * len(shape))
            .expand(out_shape) for p in params]
    return draw(out_shape, params[0].device, *wide).to(_dt(dtype))


@register("_sample_uniform", aliases=["sample_uniform"],
          differentiable=False, ndarray_inputs=["low", "high"])
def _sample_uniform(low, high, shape=None, dtype="float32"):
    return _tensor_draw(
        lambda s, dev, lo, hi: lo + (hi - lo) * _uniform(s, dev),
        [low, high], shape, dtype)


@register("_sample_normal", aliases=["sample_normal"], differentiable=False,
          ndarray_inputs=["mu", "sigma"])
def _sample_normal(mu, sigma, shape=None, dtype="float32"):
    return _tensor_draw(lambda s, dev, m, sd: m + sd * _normal(s, dev),
                        [mu, sigma], shape, dtype)


@register("_sample_gamma", aliases=["sample_gamma"], differentiable=False,
          ndarray_inputs=["alpha", "beta"])
def _sample_gamma(alpha, beta, shape=None, dtype="float32"):
    return _tensor_draw(lambda s, dev, a, b: b * _gamma(a, s, dev),
                        [alpha, beta], shape, dtype)


@register("_sample_exponential", aliases=["sample_exponential"],
          differentiable=False, ndarray_inputs=["lam"])
def _sample_exponential(lam, shape=None, dtype="float32"):
    return _tensor_draw(lambda s, dev, l: _exponential(s, dev) / l,
                        [lam], shape, dtype)


@register("_sample_poisson", aliases=["sample_poisson"],
          differentiable=False, ndarray_inputs=["lam"])
def _sample_poisson(lam, shape=None, dtype="float32"):
    return _tensor_draw(lambda s, dev, l: _poisson(l, s, dev), [lam], shape,
                        dtype)


@register("_sample_negative_binomial", aliases=["sample_negative_binomial"],
          differentiable=False, ndarray_inputs=["k", "p"])
def _sample_negative_binomial(k, p, shape=None, dtype="float32"):
    def draw(s, dev, kk, pp):
        return _poisson(_gamma(kk, s, dev) * ((1 - pp) / pp), s, dev)

    return _tensor_draw(draw, [k, p], shape, dtype)


@register("_sample_generalized_negative_binomial",
          aliases=["sample_generalized_negative_binomial"],
          differentiable=False, ndarray_inputs=["mu", "alpha"])
def _sample_gen_negative_binomial(mu, alpha, shape=None, dtype="float32"):
    def draw(s, dev, m, a):
        k = 1.0 / a.clamp_min(1e-12)
        p = k / (k + m)
        pois = _poisson(m, s, dev)
        nb = _poisson(_gamma(k, s, dev) * ((1 - p) / p), s, dev)
        return torch.where(a <= 0, pois, nb)

    return _tensor_draw(draw, [mu, alpha], shape, dtype)


@register("_sample_multinomial", aliases=["sample_multinomial"],
          differentiable=False, ndarray_inputs=["data"])
def _sample_multinomial(data, shape=None, get_prob=False, dtype="int32"):
    """data (..., K) probabilities -> draws of shape data.shape[:-1] +
    shape; with ``get_prob`` also the log-probability of each draw."""
    shape = _shp(shape)
    batch = tuple(data.shape[:-1])
    k = data.shape[-1]
    probs = data.to(torch.float32).clamp_min(1e-30).reshape(-1, k)
    n = max(math.prod(shape), 1)
    draws = torch.multinomial(probs, n, replacement=True,
                              generator=_gen(data.device))
    out = draws.reshape(batch + shape).to(_dt(dtype))
    if get_prob:
        logp = torch.gather(torch.log_softmax(torch.log(probs), dim=-1), 1,
                            draws)
        return out, logp.reshape(out.shape)
    return out


@register("_shuffle", aliases=["shuffle"], differentiable=False,
          ndarray_inputs=["data"])
def _shuffle_op(data):
    """Shuffle along the first axis."""
    perm = torch.randperm(data.shape[0], generator=_gen(data.device),
                          device=data.device)
    return data[perm]


# ---------------------------------------------------------------------------
# _random_pdf_*: densities, differentiable in the sample and the parameters
# ---------------------------------------------------------------------------

def _out(logp, is_log):
    return logp if is_log else torch.exp(logp)


@register("_random_pdf_uniform", aliases=["random_pdf_uniform"],
          ndarray_inputs=["sample", "low", "high"])
def _pdf_uniform(sample, low, high, is_log=False):
    low, high = low[..., None], high[..., None]
    inside = (sample >= low) & (sample <= high)
    pdf = torch.where(inside, 1.0 / (high - low), torch.zeros_like(sample))
    return torch.log(pdf.clamp_min(1e-30)) if is_log else pdf


@register("_random_pdf_normal", aliases=["random_pdf_normal"],
          ndarray_inputs=["sample", "mu", "sigma"])
def _pdf_normal(sample, mu, sigma, is_log=False):
    mu, sigma = mu[..., None], sigma[..., None]
    logp = (-0.5 * torch.square((sample - mu) / sigma)
            - torch.log(sigma * math.sqrt(2 * math.pi)))
    return _out(logp, is_log)


@register("_random_pdf_gamma", aliases=["random_pdf_gamma"],
          ndarray_inputs=["sample", "alpha", "beta"])
def _pdf_gamma(sample, alpha, beta, is_log=False):
    a = alpha[..., None]
    b = 1.0 / beta[..., None]  # beta is a scale parameter
    logp = (a * torch.log(b) + (a - 1) * torch.log(sample) - b * sample
            - torch.lgamma(a))
    return _out(logp, is_log)


@register("_random_pdf_exponential", aliases=["random_pdf_exponential"],
          ndarray_inputs=["sample", "lam"])
def _pdf_exponential(sample, lam, is_log=False):
    lam = lam[..., None]
    return _out(torch.log(lam) - lam * sample, is_log)


@register("_random_pdf_poisson", aliases=["random_pdf_poisson"],
          ndarray_inputs=["sample", "lam"])
def _pdf_poisson(sample, lam, is_log=False):
    lam = lam[..., None]
    logp = (sample * torch.log(lam.clamp_min(1e-30)) - lam
            - torch.lgamma(sample + 1))
    return _out(logp, is_log)


def _nb_logp(sample, k, p):
    binln = (torch.lgamma(sample + k) - torch.lgamma(sample + 1)
             - torch.lgamma(k))
    return binln + k * torch.log(p) + sample * torch.log1p(-p)


@register("_random_pdf_negative_binomial",
          aliases=["random_pdf_negative_binomial"],
          ndarray_inputs=["sample", "k", "p"])
def _pdf_negative_binomial(sample, k, p, is_log=False):
    return _out(_nb_logp(sample, k[..., None], p[..., None]), is_log)


@register("_random_pdf_generalized_negative_binomial",
          aliases=["random_pdf_generalized_negative_binomial"],
          ndarray_inputs=["sample", "mu", "alpha"])
def _pdf_gen_negative_binomial(sample, mu, alpha, is_log=False):
    mu, alpha = mu[..., None], alpha[..., None]
    k = 1.0 / alpha
    return _out(_nb_logp(sample, k, k / (k + mu)), is_log)


@register("_random_pdf_dirichlet", aliases=["random_pdf_dirichlet"],
          ndarray_inputs=["sample", "alpha"])
def _pdf_dirichlet(sample, alpha, is_log=False):
    a = alpha[..., None, :] if alpha.ndim == sample.ndim - 1 else alpha
    logp = (torch.sum((a - 1) * torch.log(sample), dim=-1)
            + torch.lgamma(torch.sum(a, dim=-1))
            - torch.sum(torch.lgamma(a), dim=-1))
    return _out(logp, is_log)
