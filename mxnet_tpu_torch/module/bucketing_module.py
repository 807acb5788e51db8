"""BucketingModule — variable-length training via per-bucket executors
(counterpart of ``mxnet_tpu/module/bucketing_module.py``): one Module per
bucket key, the parameter NDArrays and the updater shared between them.
"""
from __future__ import annotations

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=None,
                 context=None, fixed_param_names=None, state_names=None,
                 compression_params=None):
        import logging

        super().__init__(logger or logging)
        assert default_bucket_key is not None
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._init_args = None
        self._opt_args = None

    @property
    def symbol(self):
        return self._curr_module.symbol if self._curr_module else None

    @symbol.setter
    def symbol(self, v):
        pass

    def _get_module(self, bucket_key, data_shapes, label_shapes):
        if bucket_key not in self._buckets:
            sym, data_names, label_names = self._sym_gen(bucket_key)
            mod = Module(sym, data_names=data_names, label_names=label_names,
                         context=self._context,
                         fixed_param_names=self._fixed_param_names)
            mod.bind(data_shapes, label_shapes, for_training=self.for_training)
            master = self._buckets.get(self._default_bucket_key)
            if master is not None and master.params_initialized:
                # share parameter storage with the master bucket
                for n in mod._param_names:
                    if n in master._exec.arg_dict:
                        mod._exec.arg_dict[n] = master._exec.arg_dict[n]
                for n, v in master._exec.aux_dict.items():
                    if n in mod._exec.aux_dict:
                        mod._exec.aux_dict[n] = v
                mod.params_initialized = True
            elif self._init_args is not None:
                mod.init_params(**self._init_args)
            self._buckets[bucket_key] = mod
        return self._buckets[bucket_key]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        self.for_training = for_training
        sym, data_names, label_names = self._sym_gen(self._default_bucket_key)
        mod = Module(sym, data_names=data_names, label_names=label_names,
                     context=self._context,
                     fixed_param_names=self._fixed_param_names)
        mod.bind(data_shapes, label_shapes, for_training=for_training,
                 grad_req=grad_req)
        self._buckets[self._default_bucket_key] = mod
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def init_params(self, **kwargs):
        self._init_args = kwargs
        self._curr_module.init_params(**kwargs)
        self.params_initialized = True

    def get_params(self):
        return self._buckets[self._default_bucket_key].get_params()

    def init_optimizer(self, **kwargs):
        # one shared updater: optimizer state is keyed by param index, and all
        # buckets share parameter storage, so share the updater too
        master = self._buckets[self._default_bucket_key]
        master.init_optimizer(**kwargs)
        self._opt_args = kwargs
        for key, mod in self._buckets.items():
            if mod is not master:
                mod._optimizer = master._optimizer
                mod._updater = master._updater
                mod.optimizer_initialized = True
        self.optimizer_initialized = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        mod = self._get_module(bucket_key, data_shapes, label_shapes)
        if self.optimizer_initialized and not mod.optimizer_initialized:
            master = self._buckets[self._default_bucket_key]
            mod._optimizer = master._optimizer
            mod._updater = master._updater
            mod.optimizer_initialized = True
        self._curr_module = mod
        self._curr_bucket_key = bucket_key

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", None)
        if key is None:
            key = self._default_bucket_key
        self.switch_bucket(key,
                           data_batch.provide_data or
                           [(n, a.shape) for n, a in
                            zip(self._curr_module._data_names, data_batch.data)],
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels)
