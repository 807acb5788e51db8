"""Module — symbolic training over a bound Executor (counterpart of
``mxnet_tpu/module/module.py``).

One Executor on one device: ``context`` (default: the current context,
the card unless a ``with mx.cpu():`` scope is open). A context list takes
its first device: data parallelism across devices runs one process per
device, as the ranks of a job (``kvstore="dist_sync"``, or
``parallel.ShardedTrainer`` over a mesh).
``init_optimizer`` rescales gradients by 1/batch unless told otherwise,
and ``update`` applies the whole parameter set in one multi-tensor pass
(``Updater.update_batch``, ``optimizer/fused.py``).
"""
from __future__ import annotations

from .. import initializer as init_mod
from ..context import current_context
from ..executor import _tensor
from ..optimizer import create as opt_create
from ..optimizer.optimizer import Updater
from .base_module import BaseModule

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=None, context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None, group2ctxs=None,
                 compression_params=None):
        import logging

        super().__init__(logger or logging)
        self.symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        ctx = context if context is not None else current_context()
        self._context = ctx[0] if isinstance(ctx, (list, tuple)) else ctx
        self._fixed_param_names = set(fixed_param_names or [])
        arg_names = symbol.list_arguments()
        self._param_names = [n for n in arg_names
                             if n not in self._data_names
                             and n not in self._label_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        self._optimizer = None
        self._updater = None
        self._data_shapes = None
        self._label_shapes = None

    # ------------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self.symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return [(n, o.shape) for n, o in zip(self.output_names,
                                             self._exec.outputs)]

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write", lint=None):
        """``lint="warn"|"error"|"off"`` runs the static analyzer over the
        graph (with these shapes) before anything is allocated; "error"
        raises a node-attributed GraphAnalysisError on error-severity
        findings. Default: the MXNET_GRAPH_LINT env var ("off")."""
        if self.binded and not force_rebind:
            return
        self._data_shapes = _as_descs(data_shapes)
        self._label_shapes = _as_descs(label_shapes) if label_shapes else []
        shapes = {n: s for n, s, *_ in
                  [(d[0], d[1]) for d in self._data_shapes + self._label_shapes]}
        self.for_training = for_training
        self._exec = self.symbol.simple_bind(
            ctx=self._context, grad_req=grad_req if for_training else "null",
            lint=lint, **shapes)
        if shared_module is not None and shared_module._exec is not None:
            for n, v in shared_module._exec.arg_dict.items():
                if n in self._exec.arg_dict and n in self._param_names:
                    self._exec.arg_dict[n] = v
        self.binded = True

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        initializer = initializer or init_mod.Uniform(0.01)
        if isinstance(initializer, str):
            initializer = init_mod.create(initializer)
        dev = self._exec._device
        for name in self._param_names:
            arr = self._exec.arg_dict[name]
            if arg_params and name in arg_params:
                arr._set_data(_tensor(arg_params[name], dev).clone())
            else:
                initializer(name, arr)
        for name in self._aux_names:
            if aux_params and name in aux_params:
                self._exec.aux_dict[name]._set_data(
                    _tensor(aux_params[name], dev).clone())
        self.params_initialized = True

    def get_params(self):
        arg = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux = {n: v.copy() for n, v in self._exec.aux_dict.items()}
        return arg, aux

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        assert self.binded and self.params_initialized
        optimizer_params = dict(optimizer_params or {})
        if isinstance(optimizer, str):
            # reference Module scales grads by 1/batch_size unless overridden
            if "rescale_grad" not in optimizer_params and self._data_shapes:
                optimizer_params["rescale_grad"] = 1.0 / self._data_shapes[0][1][0]
            self._optimizer = opt_create(optimizer, **optimizer_params)
        else:
            self._optimizer = optimizer
        self._updater = Updater(self._optimizer)
        self.optimizer_initialized = True

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        feed = {}
        for name, arr in zip(self._data_names, data_batch.data):
            feed[name] = arr
        for name, arr in zip(self._label_names, data_batch.label or []):
            feed[name] = arr
        self._exec.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def update(self):
        assert self.optimizer_initialized
        idxs, grads, weights = [], [], []
        for i, name in enumerate(self._param_names):
            if name in self._fixed_param_names:
                continue
            w = self._exec.arg_dict[name]
            g = self._exec.grad_dict.get(name)
            if g is None:
                continue
            idxs.append(i)
            grads.append(g)
            weights.append(w)
        if idxs:
            # one multi-tensor pass per step (optimizer/fused.py);
            # MXNET_FUSED_UPDATE=0 restores the per-param eager loop
            self._updater.update_batch(idxs, grads, weights)

    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self.get_outputs())

    # ------------------------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        from ..model import save_checkpoint

        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self.symbol, arg, aux)
        if save_optimizer_states and self._updater is not None:
            from ..checkpoint.atomic import atomic_write_bytes

            # atomic: a crash mid-save must not leave truncated .states
            atomic_write_bytes(f"{prefix}-{epoch:04d}.states",
                               self._updater.get_states())

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        from ..model import load_checkpoint

        sym, arg, aux = load_checkpoint(prefix, epoch,
                                        ctx=kwargs.get("context"))
        mod = Module(sym, **kwargs)
        mod._preloaded = (arg, aux)
        mod._init_from_preloaded = True

        orig_init = mod.init_params

        def init_params(initializer=None, arg_params=None, aux_params=None,
                        **kw):
            orig_init(initializer=initializer, arg_params=arg_params or arg,
                      aux_params=aux_params or aux, **kw)

        mod.init_params = init_params
        return mod


def _as_descs(shapes):
    out = []
    for s in shapes:
        if hasattr(s, "name"):
            out.append((s.name, tuple(s.shape)))
        else:
            name, shape = s[0], tuple(s[1])
            out.append((name, shape))
    return out
