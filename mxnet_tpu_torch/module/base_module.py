"""BaseModule with the high-level ``fit`` loop (counterpart of
``mxnet_tpu/module/base_module.py``).

The reference's hooks into planes the port lacks are refused loudly:
``health=`` (the training-health plane, queue item A15) and an elastic or
distributed ``kvstore`` (A14). Its fleet-accounting spans and obs
counters (A15) are left out. ``monitor=`` is accepted and never read, as
in the reference's ``fit``.
"""
from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from ..base import MXNetError
from ..callback import BatchEndParam

__all__ = ["BaseModule"]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.symbol = None

    # -- lifecycle hooks implemented by subclasses -----------------------
    def bind(self, *a, **kw):
        raise NotImplementedError

    def init_params(self, *a, **kw):
        raise NotImplementedError

    def init_optimizer(self, *a, **kw):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def get_outputs(self):
        raise NotImplementedError

    # -- composite helpers ------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None, reset=True, epoch=0,
              batch_end_callback=None):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback:
                bp = BatchEndParam(epoch, nbatch, eval_metric, locals())
                for cb in _as_list(batch_end_callback):
                    cb(bp)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, reset=True):
        from ..ndarray import concat

        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        outputs = []
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            outs = self.get_outputs()
            if batch.pad:
                outs = [o[:o.shape[0] - batch.pad] for o in outs]
            outputs.append([o.copy() for o in outs])
        if not outputs:
            return []
        n_out = len(outputs[0])
        merged = [concat(*[b[i] for b in outputs], dim=0) for i in range(n_out)]
        return merged[0] if n_out == 1 else merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=None,
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None, monitor=None,
            checkpoint=None, resume="auto", checkpoint_period=1,
            checkpoint_batch_period=None, handle_preemption=True,
            health=None):
        """The classic training loop (reference BaseModule.fit).

        Crash-safe checkpointing: pass ``checkpoint=`` a directory or
        :class:`~mxnet_tpu_torch.checkpoint.CheckpointManager` to snapshot
        full training state (params, optimizer slots and counters, RNG
        streams, iterator cursor) every ``checkpoint_period`` epochs and,
        when the iterator can be positioned, every
        ``checkpoint_batch_period`` batches. ``resume="auto"`` restores the
        newest *valid* checkpoint (corrupt ones are skipped through their
        CRCs) and continues mid-epoch, so the finished run is bitwise
        identical to an uninterrupted one on the CPU; ``resume=<int>`` pins
        a step; ``resume="never"`` ignores existing checkpoints. With
        ``handle_preemption`` a SIGTERM/SIGINT flushes a final checkpoint
        after the in-flight batch and returns cleanly.
        """
        assert num_epoch is not None, "num_epoch is required for fit"
        if health is not None:
            raise MXNetError("fit(health=...): the training-health plane "
                             "(queue item A15) is not ported yet")
        if not isinstance(kvstore, str) or kvstore not in ("local",
                                                           "device"):
            raise MXNetError(f"fit(kvstore={kvstore!r}): distributed and "
                             "elastic stores (queue item A14) are not "
                             "ported yet; use 'local' or 'device'")
        optimizer_params = optimizer_params or {"learning_rate": 0.01}

        from ..checkpoint import CheckpointManager, as_manager

        # a manager built from a bare directory is ours to close at the
        # end; a caller-supplied manager outlives the fit (only flushed)
        owns_manager = not isinstance(checkpoint, CheckpointManager)
        manager = as_manager(checkpoint)

        if isinstance(resume, bool):  # bool is an int: keep True out of the
            resume = "auto" if resume else "never"  # pinned-step branch
        resume_state = None
        if manager is not None and resume not in (None, "never"):
            resume_state = (manager.load(resume) if isinstance(resume, int)
                            else manager.load_latest())
        mid_epoch = False
        if resume_state is not None:
            from ..checkpoint.state import restore_iterator

            arg_params = resume_state.arg_params()
            aux_params = resume_state.aux_params()
            force_init = True
            # put the iterator back exactly as captured — the shuffle order
            # matters even across epochs, because reshuffling permutes it
            # IN PLACE (same RNG state + different starting arrangement =
            # different epoch order)
            restored = restore_iterator(train_data, resume_state)
            mid_epoch = resume_state.nbatch is not None
            if mid_epoch and not restored:
                self.logger.warning(
                    "checkpoint was taken mid-epoch (batch %d) but the "
                    "iterator cannot be positioned; skipping the remainder "
                    "of epoch %d rather than double-applying its batches",
                    resume_state.nbatch, resume_state.epoch)
                mid_epoch = False
            begin_epoch = resume_state.epoch + (0 if mid_epoch else 1)
            self.logger.info(
                "resuming from checkpoint step %d (epoch %d%s)",
                resume_state.global_step, begin_epoch,
                f", batch {resume_state.nbatch}" if mid_epoch else "")
        if manager is not None and handle_preemption:
            manager.install_signal_handlers()

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        global_step = 0
        if resume_state is not None:
            self._restore_training_state(resume_state)
            global_step = resume_state.global_step
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        validation_metric = validation_metric or eval_metric
        # mid-epoch saves need a positionable iterator; otherwise the resume
        # point must stay at the epoch boundary or replay would double-apply
        can_position = (train_data.get_checkpoint_state() is not None
                        if hasattr(train_data, "get_checkpoint_state")
                        else False)

        # pending_batch set => enter the epoch mid-stream WITHOUT
        # reset/reshuffle (the cursor is already positioned)
        pending_batch = resume_state.nbatch if mid_epoch else None
        epoch = begin_epoch
        try:
            while epoch < num_epoch:
                tic = time.time()
                eval_metric.reset()
                if pending_batch is not None:
                    nbatch = pending_batch
                    pending_batch = None
                else:
                    train_data.reset()
                    nbatch = -1
                for data_batch in train_data:
                    nbatch += 1
                    self.forward_backward(data_batch)
                    self.update()
                    global_step += 1
                    self.update_metric(eval_metric, data_batch.label)
                    if batch_end_callback:
                        bp = BatchEndParam(epoch, nbatch, eval_metric,
                                           locals())
                        for cb in _as_list(batch_end_callback):
                            cb(bp)
                    if (manager is not None and checkpoint_batch_period
                            and can_position
                            and global_step % checkpoint_batch_period == 0):
                        manager.save(self._capture_training_state(
                            epoch, nbatch, global_step, train_data),
                            global_step)
                    if manager is not None and manager.preempted.is_set():
                        # flush a final snapshot after the in-flight batch;
                        # with a non-positionable iterator no mid-epoch point
                        # can be resumed exactly, so fall back to the last
                        # epoch-end checkpoint (cost: at most one interval)
                        if can_position:
                            manager.save(self._capture_training_state(
                                epoch, nbatch, global_step, train_data),
                                global_step, block=True)
                        manager.flush()
                        self.logger.info(
                            "preempted at epoch %d batch %d — final "
                            "checkpoint flushed at step %d",
                            epoch, nbatch, global_step)
                        import signal as _signal

                        if manager.preempt_signum == _signal.SIGINT:
                            # Ctrl-C keeps its meaning: flush first, then
                            # raise so the caller can't mistake an
                            # interrupted fit for a completed one
                            raise KeyboardInterrupt
                        return  # SIGTERM: the VM is going away — exit clean
                for name, val in eval_metric.get_name_value():
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
                self.logger.info("Epoch[%d] Time cost=%.3f",
                                 epoch, time.time() - tic)
                if epoch_end_callback:
                    arg_p, aux_p = self.get_params()
                    for cb in _as_list(epoch_end_callback):
                        cb(epoch, self.symbol, arg_p, aux_p)
                if (manager is not None and checkpoint_period
                        and (epoch + 1) % checkpoint_period == 0
                        and not (checkpoint_batch_period and can_position
                                 and global_step % checkpoint_batch_period
                                 == 0)):
                    # train_data rides along so resume can restore the
                    # shuffle order before the next epoch's in-place
                    # reshuffle. Skipped when the batch-period save above
                    # already committed this exact step
                    manager.save(self._capture_training_state(
                        epoch, None, global_step, train_data), global_step)
                if eval_data is not None:
                    res = self.score(eval_data, validation_metric,
                                     epoch=epoch,
                                     batch_end_callback=eval_batch_end_callback)
                    for name, val in res:
                        self.logger.info("Epoch[%d] Validation-%s=%f",
                                         epoch, name, val)
                epoch += 1
        finally:
            # runs on normal completion, the preemption return, AND
            # exceptions: signal handlers must never outlive the fit
            if manager is not None:
                import sys

                unwinding = sys.exc_info()[0] is not None
                try:
                    if owns_manager:
                        manager.close()  # drain writer, restore handlers
                    else:
                        manager.flush()
                        manager.restore_signal_handlers()
                except BaseException:
                    if not unwinding:
                        raise  # clean run: a lost write must surface
                    # don't mask the in-flight training exception
                    self.logger.warning("checkpoint cleanup failed",
                                        exc_info=True)

    # -- parameter files (upstream BaseModule.save_params/load_params) -----
    def save_params(self, fname):
        """Write the parameters to ``fname`` as a ``.params`` file keyed
        ``arg:NAME`` / ``aux:NAME`` (the reference's bytes)."""
        from ..ndarray import save as nd_save

        arg_params, aux_params = self.get_params()
        save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
        save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
        nd_save(fname, save_dict)

    def load_params(self, fname):
        """Set the parameters from a file :meth:`save_params` wrote; the
        module must be bound."""
        from ..ndarray import load as nd_load

        arg_params, aux_params = {}, {}
        for k, v in nd_load(fname, ctx=getattr(self, "_context",
                                                None)).items():
            kind, _, name = k.partition(":")
            if kind == "arg":
                arg_params[name] = v
            elif kind == "aux":
                aux_params[name] = v
            else:
                raise ValueError(f"invalid param file {fname}: key {k!r}")
        self.set_params(arg_params, aux_params)

    # -- checkpoint plumbing ----------------------------------------------
    def _capture_training_state(self, epoch, nbatch, global_step,
                                train_data=None, loss_scaler=None):
        """Snapshot everything a bitwise resume needs (host-side copies —
        safe to hand to the async writer while training continues)."""
        from ..checkpoint.state import capture_training_state

        arg, aux = self.get_params()
        return capture_training_state(
            arg_params=arg, aux_params=aux,
            updater=getattr(self, "_updater", None),
            optimizer=getattr(self, "_optimizer", None),
            epoch=epoch, nbatch=nbatch, global_step=global_step,
            train_data=train_data, loss_scaler=loss_scaler)

    def _restore_training_state(self, state):
        """Restore optimizer slots/counters and RNG streams (params went in
        through init_params; the iterator is restored inside fit's epoch
        loop so reset() can't clobber it)."""
        from ..checkpoint.state import restore_optimizer, restore_rng

        restore_optimizer(getattr(self, "_updater", None),
                          getattr(self, "_optimizer", None), state,
                          ctx=getattr(self, "_context", None))
        restore_rng(state)

def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]
