"""Gluon basic layers (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``): the containers, ``Dense``,
the activations, ``Dropout``, ``Flatten``, ``Lambda``/``HybridLambda``,
``Embedding`` and the norms (``BatchNorm``, ``LayerNorm``,
``InstanceNorm``, ``GroupNorm``), each over the registered op the
reference's layer calls.
"""
from __future__ import annotations

import numpy as np

from ... import autograd
from ...ndarray import NDArray
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "Dropout", "BatchNorm", "LayerNorm", "InstanceNorm", "GroupNorm",
           "Embedding", "Flatten", "Lambda", "HybridLambda", "ELU", "SELU",
           "PReLU", "GELU", "Swish", "SiLU", "LeakyReLU"]


class Sequential(Block):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def forward(self, x, *args):
        for b in self._children.values():
            x = b(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __iter__(self):
        return iter(self._children.values())


class HybridSequential(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def infer_shape(self, *args):
        x = args[0]
        for b in self._children.values():
            x = b(x)

    def hybrid_forward(self, F, x):
        for b in self._children.values():
            x = b(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __iter__(self):
        return iter(self._children.values())


class Dense(HybridBlock):
    """Fully-connected layer over ``FullyConnected``; ``in_units`` 0
    defers the weight's shape to the first input."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._act = activation
        self.weight = self.params.get("weight", shape=(units, in_units),
                                      dtype=dtype, init=weight_initializer,
                                      allow_deferred_init=True)
        self.bias = self.params.get("bias", shape=(units,), dtype=dtype,
                                    init=bias_initializer) \
            if use_bias else None

    def infer_shape(self, x, *args):
        in_units = int(np.prod(x.shape[1:])) if self._flatten \
            else x.shape[-1]
        self.weight.shape_inferred((self._units, in_units))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, *([bias] if bias is not None
                                            else []),
                               num_hidden=self._units, no_bias=bias is None,
                               flatten=self._flatten)
        if self._act:
            out = F.Activation(out, act_type=self._act)
        return out


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act = activation

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act)


class LeakyReLU(HybridBlock):
    def __init__(self, alpha=0.01, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    def __init__(self, approximation="erf", **kwargs):
        super().__init__(**kwargs)
        self._approx = approximation

    def hybrid_forward(self, F, x):
        return F.gelu(x, approximation=self._approx)


class Swish(HybridBlock):
    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class SiLU(Swish):
    """beta=1 Swish under its 2.x name."""

    def __init__(self, **kwargs):
        super().__init__(beta=1.0, **kwargs)


class PReLU(HybridBlock):
    def __init__(self, alpha_initializer="constant", in_channels=1,
                 **kwargs):
        super().__init__(**kwargs)
        from ... import initializer as init_mod

        self.alpha = self.params.get("alpha", shape=(in_channels,),
                                     init=init_mod.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class Dropout(HybridBlock):
    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate <= 0:
            return x
        return F.Dropout(x, p=self._rate, axes=self._axes)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class Lambda(Block):
    def __init__(self, function, **kwargs):
        super().__init__(**kwargs)
        self._fn = function

    def forward(self, *args):
        from ... import ndarray as nd_mod

        if isinstance(self._fn, str):
            return getattr(nd_mod, self._fn)(*args)
        return self._fn(*args)


class HybridLambda(HybridBlock):
    def __init__(self, function, **kwargs):
        super().__init__(**kwargs)
        self._fn = function

    def hybrid_forward(self, F, *args):
        if isinstance(self._fn, str):
            return getattr(F, self._fn)(*args)
        return self._fn(F, *args)


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = self.params.get("weight", shape=(input_dim, output_dim),
                                      dtype=dtype, init=weight_initializer)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class BatchNorm(HybridBlock):
    """Batch normalization with moving-average running statistics. In
    training the op returns the batch mean and variance
    (``output_mean_var``) and the layer folds them into the running
    statistics by rebinding them (a hybridized or functionalized forward
    returns the rebound values as aux outputs); ``in_channels`` 0 defers
    the shapes to the first input."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        sh = (in_channels,)
        self.gamma = self.params.get("gamma", shape=sh,
                                     init=gamma_initializer,
                                     allow_deferred_init=True,
                                     differentiable=scale)
        self.beta = self.params.get("beta", shape=sh, init=beta_initializer,
                                    allow_deferred_init=True,
                                    differentiable=center)
        self.running_mean = self.params.get(
            "running_mean", shape=sh, init=running_mean_initializer,
            allow_deferred_init=True, differentiable=False)
        self.running_var = self.params.get(
            "running_var", shape=sh, init=running_variance_initializer,
            allow_deferred_init=True, differentiable=False)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p.shape_inferred((c,))

    def _bn_op(self, F):
        """Overridable hook: (op, extra kwargs). ``SyncBatchNorm`` swaps in
        its op and keeps the statistics folding below."""
        return F.BatchNorm, {}

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        op, extra = self._bn_op(F)
        kw = dict(eps=self._eps, momentum=self._momentum,
                  fix_gamma=not self._scale, axis=self._axis, **extra)
        if not isinstance(x, NDArray):  # a Symbol
            # traced: the running statistics are the node's auxiliary
            # states, folded by a bound Executor in training
            return op(x, gamma, beta, running_mean, running_var,
                      use_global_stats=self._use_global_stats,
                      output_mean_var=False, **kw)
        if autograd.is_training() and not self._use_global_stats:
            out, mean, var = op(x, gamma, beta, running_mean, running_var,
                                use_global_stats=False, output_mean_var=True,
                                **kw)
            m = self._momentum
            with autograd.pause():
                self.running_mean.data()._set_data(
                    (m * running_mean + (1 - m) * mean.detach())._data)
                self.running_var.data()._set_data(
                    (m * running_var + (1 - m) * var.detach())._data)
            return out
        return op(x, gamma, beta, running_mean, running_var,
                  use_global_stats=True, output_mean_var=False, **kw)


class LayerNorm(HybridBlock):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._eps = epsilon
        self.gamma = self.params.get("gamma", shape=(in_channels,),
                                     init=gamma_initializer,
                                     allow_deferred_init=True)
        self.beta = self.params.get("beta", shape=(in_channels,),
                                    init=beta_initializer,
                                    allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape_inferred((c,))
        self.beta.shape_inferred((c,))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._eps)


class InstanceNorm(HybridBlock):
    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._eps = epsilon
        self.gamma = self.params.get("gamma", shape=(in_channels,),
                                     init=gamma_initializer,
                                     allow_deferred_init=True)
        self.beta = self.params.get("beta", shape=(in_channels,),
                                    init=beta_initializer,
                                    allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[1]
        self.gamma.shape_inferred((c,))
        self.beta.shape_inferred((c,))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._eps)


class GroupNorm(HybridBlock):
    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._ngroups = num_groups
        self._eps = epsilon
        self.gamma = self.params.get("gamma", shape=(in_channels,),
                                     init=gamma_initializer,
                                     allow_deferred_init=True)
        self.beta = self.params.get("beta", shape=(in_channels,),
                                    init=beta_initializer,
                                    allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[1]
        self.gamma.shape_inferred((c,))
        self.beta.shape_inferred((c,))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._ngroups,
                           eps=self._eps)
