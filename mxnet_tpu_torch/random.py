"""The framework's random stream: ``seed()``, the per-device
``torch.Generator`` that ``Dropout``, the initializers and the sampling
ops draw from, the seeded host generator ``np_rng()``, and the sampling
front-ends ``mx.random.*`` / ``mx.nd.random.*`` (``uniform``, ``normal``,
``randn``, ``randint``, ``bernoulli``, ``gamma``, ``exponential``,
``poisson``, ``negative_binomial``, ``generalized_negative_binomial``,
``multinomial``, ``shuffle``) over the registered ops of
``ops/random_ops.py`` (counterpart of ``mxnet_tpu/random.py``). Torch's
generators do not give ``jax.random``'s bits: draws match the reference
in distribution only. ``get_state_data``/``set_state_data`` capture and
restore every device generator's state for a checkpoint, where the
reference keeps its JAX key.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .base import get_env

__all__ = ["seed", "generator", "np_rng", "get_state_data",
           "set_state_data", "uniform", "normal", "randint", "randn",
           "bernoulli", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle"]


class _State:
    def __init__(self):
        self.seed = None
        self.generators = {}
        self.np_rng = None
        self.lock = threading.Lock()


_STATE = _State()


def seed(seed_state: int, ctx="all") -> None:
    """Seed the stream of every device (reference ``mx.random.seed``); the
    next draw on each device starts from this seed."""
    with _STATE.lock:
        _STATE.seed = int(seed_state)
        _STATE.generators.clear()
        _STATE.np_rng = np.random.default_rng(int(seed_state))


def generator(device) -> torch.Generator:
    """The stream's generator on ``device``: seeded from :func:`seed`, or
    nondeterministically when nothing was seeded."""
    device = torch.device(device)
    key = (device.type, device.index)
    with _STATE.lock:
        gen = _STATE.generators.get(key)
        if gen is None:
            gen = torch.Generator(device=device)
            if _STATE.seed is None:
                gen.seed()
            else:
                gen.manual_seed(_STATE.seed)
            _STATE.generators[key] = gen
        return gen


def np_rng() -> np.random.Generator:
    """Host numpy generator tied to the framework seed (``MXNET_SEED`` or
    :func:`seed`), as the reference's."""
    if _STATE.np_rng is None:
        _STATE.np_rng = np.random.default_rng(get_env("MXNET_SEED", None,
                                                      int))
    return _STATE.np_rng


def get_state_data():
    """{"type:index": uint8 state array} of every device generator made so
    far, or None when none was: a resumed process then seeds its
    generators as a fresh one would."""
    with _STATE.lock:
        if not _STATE.generators:
            return None
        return {f"{t}:{-1 if i is None else i}": g.get_state().numpy().copy()
                for (t, i), g in _STATE.generators.items()}


def set_state_data(data) -> None:
    """Restore what :func:`get_state_data` captured: later draws on those
    devices repeat the captured run's bit for bit."""
    for key, state in data.items():
        typ, idx = key.split(":")
        dev = torch.device(typ) if idx == "-1" else torch.device(typ,
                                                                 int(idx))
        generator(dev).set_state(torch.from_numpy(
            np.asarray(state, np.uint8).copy()))


# ---------------------------------------------------------------------------
# Sampling front-ends (mx.random.* / mx.nd.random.*): NDArrays, on ``ctx``
# (the current context by default), or written into ``out``
# ---------------------------------------------------------------------------

def _draw(op, ctx, out, **kwargs):
    from .ndarray.ndarray import invoke

    kwargs = {"ctx": ctx, **kwargs}
    if out is not None:
        kwargs["out"] = out
    return invoke(op, [], kwargs)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None, **kw):
    return _draw("_random_uniform", ctx, out, low=low, high=high,
                 shape=shape, dtype=dtype)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None, **kw):
    return _draw("_random_normal", ctx, out, loc=loc, scale=scale,
                 shape=shape, dtype=dtype)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None, **kw):
    return normal(loc, scale, shape, dtype, ctx)


def randint(low, high=None, shape=None, dtype="int32", ctx=None, out=None,
            **kw):
    if high is None:
        low, high = 0, low
    return _draw("_random_randint", ctx, out, low=low, high=high,
                 shape=shape, dtype=dtype)


def bernoulli(prob=0.5, shape=None, dtype="float32", ctx=None, out=None,
              **kw):
    u = uniform(shape=shape, ctx=ctx)
    r = (u < prob).astype(dtype)
    if out is not None:
        out._set_data(r._data)
        return out
    return r


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None, **kw):
    return _draw("_random_gamma", ctx, out, alpha=alpha, beta=beta,
                 shape=shape, dtype=dtype)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None,
                **kw):
    return _draw("_random_exponential", ctx, out, lam=1.0 / scale,
                 shape=shape, dtype=dtype)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None, **kw):
    return _draw("_random_poisson", ctx, out, lam=lam, shape=shape,
                 dtype=dtype)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None,
                      out=None, **kw):
    return _draw("_random_negative_binomial", ctx, out, k=k, p=p,
                 shape=shape, dtype=dtype)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", ctx=None, out=None, **kw):
    return _draw("_random_generalized_negative_binomial", ctx, out, mu=mu,
                 alpha=alpha, shape=shape, dtype=dtype)


def multinomial(data, shape=1, get_prob=False, dtype="int32", **kw):
    """Class indices drawn from the probability rows of ``data``; with
    ``get_prob`` also the log-probability of each draw. ``shape=1`` draws
    one per row, with no trailing axis."""
    from .ndarray.ndarray import invoke

    return invoke("_sample_multinomial", [data],
                  {"shape": None if shape == 1 else shape,
                   "get_prob": get_prob, "dtype": dtype})


def shuffle(data, **kw):
    from .ndarray.ndarray import invoke

    return invoke("_shuffle", [data], {})
