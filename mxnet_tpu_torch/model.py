"""Checkpoint save/load (counterpart of ``mxnet_tpu/model.py``).

Naming convention matches the reference: ``prefix-symbol.json`` +
``prefix-%04d.params`` with ``arg:name`` / ``aux:name`` keyed NDArrays; the
params container is the reference binary NDArray format (see
``ndarray.save``).
"""
from __future__ import annotations

from typing import Dict, Tuple

from .ndarray import NDArray, load as nd_load, save as nd_save

__all__ = ["save_checkpoint", "load_checkpoint", "load_params", "FeedForward"]


def save_checkpoint(prefix, epoch, symbol, arg_params: Dict[str, NDArray],
                    aux_params: Dict[str, NDArray], remove_amp_cast=True):
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in (arg_params or {}).items()}
    save_dict.update({f"aux:{k}": v for k, v in (aux_params or {}).items()})
    nd_save(f"{prefix}-{epoch:04d}.params", save_dict)


def load_params(prefix, epoch, ctx=None
                ) -> Tuple[Dict[str, NDArray], Dict[str, NDArray]]:
    """(arg_params, aux_params) of ``prefix-epoch.params``, on ``ctx``
    (default: the current context)."""
    loaded = nd_load(f"{prefix}-{epoch:04d}.params", ctx=ctx)
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch, ctx=None):
    from . import symbol as sym_mod

    symbol = sym_mod.load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(prefix, epoch, ctx=ctx)
    # Normalize arg/aux placement to the RELOADED graph's view: a
    # checkpoint saved from a traced-gluon Module stores BatchNorm moving
    # stats under ``arg:`` (the trace makes them plain variables), while
    # load_json re-derives them as auxiliary states from the op registry —
    # without this re-split such stats would be silently dropped on bind.
    aux_names = set(symbol.list_auxiliary_states())
    merged = {**arg_params, **aux_params}
    arg_params = {k: v for k, v in merged.items() if k not in aux_names}
    aux_params = {k: v for k, v in merged.items() if k in aux_names}
    return symbol, arg_params, aux_params


class FeedForward:
    """Legacy pre-Module training API (reference mx.model.FeedForward,
    deprecated upstream in favor of Module; a thin adapter over Module).
    Training through it inherits Module's fused update
    (``optimizer/fused.py``; ``MXNET_FUSED_UPDATE=0`` restores the
    per-parameter loop)."""

    def __init__(self, symbol, ctx=None, num_epoch=None, optimizer="sgd",
                 initializer=None, arg_params=None, aux_params=None,
                 learning_rate=0.01, **kwargs):
        from .module import Module

        self.symbol = symbol
        self._ctx = ctx
        self._num_epoch = num_epoch
        self._optimizer = optimizer
        self._opt_kwargs = dict(kwargs)
        self._opt_kwargs["learning_rate"] = learning_rate
        self._initializer = initializer
        self.arg_params = arg_params
        self.aux_params = aux_params
        self._module = Module(symbol, context=ctx)
        self._fitted = False

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            batch_end_callback=None, epoch_end_callback=None, logger=None,
            checkpoint=None, resume="auto", **kwargs):
        """``checkpoint=`` (a directory or CheckpointManager) and the
        default ``resume="auto"`` give the legacy API Module.fit's
        crash-safe checkpointing; other keywords go to Module.fit."""
        from .io import NDArrayIter

        del logger  # accepted for signature parity; Module logs via logging
        train = X if hasattr(X, "provide_data") else NDArrayIter(X, y, batch_size=128)
        self._module.fit(
            train, eval_data=eval_data, eval_metric=eval_metric,
            optimizer=self._optimizer, optimizer_params=self._opt_kwargs,
            initializer=self._initializer,
            arg_params=self.arg_params, aux_params=self.aux_params,
            num_epoch=self._num_epoch or 1,
            batch_end_callback=batch_end_callback,
            epoch_end_callback=epoch_end_callback,
            checkpoint=checkpoint, resume=resume, **kwargs)
        self.arg_params, self.aux_params = self._module.get_params()
        self._fitted = True
        return self

    def predict(self, X, num_batch=None):
        from .io import NDArrayIter

        it = X if hasattr(X, "provide_data") else NDArrayIter(X, batch_size=128)
        outs = self._module.predict(it, num_batch=num_batch)
        return outs.asnumpy() if hasattr(outs, "asnumpy") else outs

    def score(self, X, y=None, eval_metric="acc", num_batch=None):
        from .io import NDArrayIter

        it = X if hasattr(X, "provide_data") else NDArrayIter(X, y, batch_size=128)
        return self._module.score(it, eval_metric, num_batch=num_batch)

    def save(self, prefix, epoch=None):
        save_checkpoint(prefix, epoch if epoch is not None else 0,
                        self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        sym, arg, aux = load_checkpoint(prefix, epoch)
        return FeedForward(sym, ctx=ctx, arg_params=arg, aux_params=aux,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=1, **kwargs):
        m = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch, **kwargs)
        return m.fit(X, y)
