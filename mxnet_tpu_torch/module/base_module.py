"""BaseModule with the high-level ``fit`` loop (counterpart of
``mxnet_tpu/module/base_module.py``).

``fit(kvstore=)`` takes any store name or a ``KVStore`` object, as the
reference's; an elastic ``DistKVStore`` (``MXNET_ELASTIC=1``) drives the
elastic loop: join (quarantined after training started, activated at the
next epoch boundary), the shard recut, the cold co-start broadcast of the
lead rank's parameters, the mean of every step's gradients over the live
fleet, the committed-clock tick and the epoch rendezvous.

``fit(health=)`` attaches the training-health plane (``obs/health.py``),
as the reference's: each update asks for the stats only on the steps the
monitor samples, the monitor judges them after the update, a breach that
warrants it runs the blame pass under a ``health.blame`` span, and a
rollback restores the newest CRC-valid, finite checkpoint of the
``checkpoint=`` manager (parameters, optimizer state, RNG streams and the
iterator cursor, the poisoned occurrence already consumed) and replays
from there; with no manager it warns and carries on. Each batch samples
the device plane's live memory (``obs.device.sample``).

The training-fleet plane's phases (``obs/fleetstats.py``) wrap the loop as
the reference's do: ``data_wait`` (the iterator's ``next``), ``forward``,
``backward``, ``elastic.sync_grads``, ``update``, ``metric`` and
``checkpoint``, with ``step_complete`` after each step and ``flush`` at
the end of the fit. On a card, while the plane records, ``backward`` ends
with a synchronize of the executor's device: the launches return once
queued, and their device time would otherwise land in the next host read
(the elastic gradient sync), booked as reduce-wait.

A quarantined rejoiner warms its fused update step while it waits
(``_prewarm_update_programs``, as the reference's): with a program cache
armed it resolves the step for the parameter set of the newest shared
checkpoint (``Updater.prewarm_batch``: a hit, or a run on copies that
fills the cache), never touching a weight, a state or a counter; any
failure there is logged and ignored.
``monitor=`` is accepted and never read, as in the reference's ``fit``.
"""
from __future__ import annotations

import logging
import time

import numpy as np

from .. import metric as metric_mod
from .. import obs
from ..base import MXNetError
from ..callback import BatchEndParam
from ..obs import fleetstats as _fleetstats
from ..obs import health as health_mod

_STOP = object()  # the end of an epoch's batches

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
        # fleetstats.phase: the ordinary obs span, plus the step
        # accounting and the MXNET_CHAOS_SLOW injection point
        with _fleetstats.phase("forward"):
            self.forward(data_batch, is_train=True)
        with _fleetstats.phase("backward"):
            self.backward()
            if _fleetstats.enabled():
                self._sync_device()

    def _sync_device(self):
        """Wait for the executor's card, if it has one, so that the
        accounting books the queued device work as the phase's compute."""
        dev = getattr(getattr(self, "_exec", None), "_device", None)
        if dev is not None and getattr(dev, "type", None) == "cuda":
            import torch

            # only while the fleet plane records: the phase's time must include
            # its queued device work
            torch.cuda.synchronize(dev)  # lint: disable=host-sync-on-hot-path

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
        optimizer_params = optimizer_params or {"learning_rate": 0.01}

        from ..checkpoint import CheckpointManager, as_manager

        # a manager built from a bare directory is ours to close at the
        # end; a caller-supplied manager outlives the fit (only flushed)
        owns_manager = not isinstance(checkpoint, CheckpointManager)
        manager = as_manager(checkpoint)

        # elastic training: membership is resolved before the checkpoint
        # resume below. A restarted worker lands quarantined, blocks here
        # until the live fleet's next epoch boundary activates it, then
        # resumes from the newest shared checkpoint, which the survivors
        # flushed before that boundary's rendezvous
        elastic = getattr(kvstore, "elastic", None) \
            if not isinstance(kvstore, str) else None
        elastic_info = None
        if elastic is not None:
            elastic_info = elastic.ensure_joined()
            if not elastic_info.active:
                self.logger.info(
                    "elastic: quarantined (generation %d, fleet at epoch "
                    "%d) — waiting for the next epoch boundary",
                    elastic_info.generation, elastic_info.epoch)
                # resolve the fused update step now, overlapping the wait,
                # so activation never stalls the fleet's first reduce
                self._prewarm_update_programs(manager, optimizer,
                                              optimizer_params, train_data)
                elastic_info = elastic.await_activation()
                self.logger.info(
                    "elastic: activated at epoch %d generation %d, shard "
                    "%d/%d", elastic_info.epoch, elastic_info.generation,
                    elastic_info.part_index, elastic_info.num_parts)
            self._set_partition(train_data, elastic_info)

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
            # different epoch order). An elastic rejoin happens at epoch
            # boundaries only, and the shard from the activation is
            # authoritative: the checkpoint's cursor is another rank's
            restored = elastic is None and restore_iterator(train_data,
                                                            resume_state)
            mid_epoch = elastic is None and resume_state.nbatch is not None
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
        if elastic_info is not None and elastic_info.epoch > begin_epoch:
            # the fleet is ahead of this worker's newest checkpoint: the
            # per-step sync averages gradients, never weights, so stale
            # parameters would silently train another model from here on
            from ..base import get_env

            if elastic_info.active_count > 1 and not get_env(
                    "MXNET_ELASTIC_ALLOW_STALE_REJOIN", False, bool):
                raise MXNetError(
                    f"elastic: the fleet is at epoch {elastic_info.epoch} "
                    f"but this worker's newest shared checkpoint resumes "
                    f"at epoch {begin_epoch} — rejoining with stale "
                    f"parameters would silently desync the ranks (gradient "
                    f"sync never re-syncs weights). Share one checkpoint "
                    f"directory with checkpoint_period=1, or set "
                    f"MXNET_ELASTIC_ALLOW_STALE_REJOIN=1 to proceed "
                    f"anyway.")
            self.logger.warning(
                "elastic: fleet is at epoch %d but resume found epoch %d — "
                "fast-forwarding", elastic_info.epoch, begin_epoch)
            begin_epoch = elastic_info.epoch
            mid_epoch = False
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
        if (elastic is not None and resume_state is None
                and elastic_info.active and elastic_info.epoch == 0):
            # cold co-start: the lead rank's initial parameters, once, for
            # every co-starting active (gradient sync never re-syncs
            # weights; a straggler's broadcast is answered from the
            # released round with the root's values)
            self._elastic_broadcast_params(
                kvstore, root=elastic_info.part_index == 0)
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        validation_metric = validation_metric or eval_metric
        # mid-epoch saves need a positionable iterator; otherwise the resume
        # point must stay at the epoch boundary or replay would double-apply
        can_position = (train_data.get_checkpoint_state() is not None
                        if hasattr(train_data, "get_checkpoint_state")
                        else False)
        health_monitor = health_mod.as_monitor(health)
        if health_monitor is not None:
            # an attached monitor turns the stats on even with the wider
            # obs layer off
            health_mod.activate()
            if health_monitor.param_names is None and \
                    getattr(self, "_param_names", None):
                health_monitor.attach_names(list(self._param_names))

        # pending_batch set => enter the epoch mid-stream WITHOUT
        # reset/reshuffle (the cursor is already positioned): entry resume
        # and health rollback share this path
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
                batches = iter(train_data)
                rolled_back = False
                while True:
                    # data_wait: the time the loop blocks on the iterator
                    with _fleetstats.phase("data_wait"):
                        data_batch = next(batches, _STOP)
                    if data_batch is _STOP:
                        break
                    nbatch += 1
                    self.forward_backward(data_batch)
                    if elastic is not None:
                        # the mean over the LIVE fleet: a worker killed
                        # mid-epoch shrinks the round after K missed
                        # heartbeats and this returns over the survivors
                        with _fleetstats.phase("elastic.sync_grads"):
                            self._elastic_sync_grads(kvstore)
                    if health_monitor is not None:
                        # the stats only on steps the sentinel will sample:
                        # their cost amortizes 1/K
                        health_mod.request_stats(health_monitor.will_sample())
                    with _fleetstats.phase("update"):
                        self.update()
                    global_step += 1
                    # live device memory, once per batch: the counter
                    # track and the steady-state leak detector (one flag
                    # check when telemetry is off)
                    obs.device.sample(step=global_step)
                    with _fleetstats.phase("metric"):
                        self.update_metric(eval_metric, data_batch.label)
                    if health_monitor is not None:
                        # sampled every K steps, before this step's
                        # checkpoint, so a detected blowup never commits
                        # poisoned parameters as the newest snapshot
                        health_monitor.record_metric(eval_metric)
                        rep = health_monitor.step(
                            global_step,
                            engine=getattr(getattr(self, "_updater", None),
                                           "_engine", None),
                            optimizer=getattr(self, "_optimizer", None))
                        if rep is not None and rep["breaches"]:
                            if health_monitor.should_blame(rep) and \
                                    getattr(self, "_exec", None) is not None:
                                with obs.trace.span("health.blame"):
                                    health_mod.blame_nonfinite(self._exec)
                            if rep["action"] == "rollback":
                                if elastic is not None:
                                    # a rollback is rank-local but elastic
                                    # sync is lockstep: one rank replaying
                                    # batches would issue reduce rounds its
                                    # peers never join
                                    self.logger.warning(
                                        "health: rollback requested but "
                                        "elastic lockstep sync is active — "
                                        "continuing without rollback")
                                elif manager is None:
                                    self.logger.warning(
                                        "health: rollback requested but fit "
                                        "has no checkpoint= manager — "
                                        "continuing (warn only)")
                                else:
                                    res = self._apply_health_rollback(
                                        manager, health_monitor, train_data)
                                    if res is not None:
                                        state, positioned = res
                                        global_step = state.global_step
                                        if (state.nbatch is not None
                                                and positioned):
                                            epoch = state.epoch
                                            pending_batch = state.nbatch
                                        else:
                                            epoch = state.epoch + 1
                                            pending_batch = None
                                        rolled_back = True
                                        break
                    if batch_end_callback:
                        bp = BatchEndParam(epoch, nbatch, eval_metric,
                                           locals())
                        for cb in _as_list(batch_end_callback):
                            cb(bp)
                    if (manager is not None and checkpoint_batch_period
                            and can_position
                            and global_step % checkpoint_batch_period == 0):
                        with _fleetstats.phase("checkpoint",
                                               step=global_step):
                            manager.save(self._capture_training_state(
                                epoch, nbatch, global_step, train_data),
                                global_step)
                    # close the step's fleet accounting: its phases fold
                    # into this rank's window; sealed windows ride the
                    # next heartbeat to the PS server
                    _fleetstats.step_complete(global_step)
                    # bounded-staleness async: commit this rank's finished
                    # step (a no-op in other modes; kvstore may be a name)
                    tick = getattr(kvstore, "step_complete", None)
                    if callable(tick):
                        tick(global_step)
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
                if rolled_back:
                    # re-enter the (possibly earlier) epoch at the restored
                    # cursor; eval_metric resets at the loop top, so the
                    # poisoned running averages die with the bad segment
                    continue
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
                if elastic is not None:
                    if manager is not None:
                        # the boundary snapshot is durable before the
                        # rendezvous: a worker activated there resumes
                        # from it
                        manager.flush()
                    info = elastic.epoch_end(epoch)
                    if info.changed:
                        self.logger.info(
                            "elastic: membership changed at epoch %d "
                            "boundary (generation %d) — shard recut to "
                            "%d/%d", epoch, info.generation,
                            info.part_index, info.num_parts)
                        self._set_partition(train_data, info)
                if eval_data is not None:
                    res = self.score(eval_data, validation_metric,
                                     epoch=epoch,
                                     batch_end_callback=eval_batch_end_callback)
                    for name, val in res:
                        self.logger.info("Epoch[%d] Validation-%s=%f",
                                         epoch, name, val)
                epoch += 1
        finally:
            # seal the partial window, so a short fit's attribution still
            # ships on the closing heartbeats
            _fleetstats.flush()
            if health_monitor is not None:
                health_mod.request_stats(None)
                health_mod.deactivate()
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

    # -- elastic plumbing -------------------------------------------------
    def _prewarm_update_programs(self, manager, optimizer, optimizer_params,
                                 train_data) -> bool:
        """Best-effort elastic-rejoin warm: resolve the fused update step
        for the parameter set of the newest shared checkpoint from the
        program cache (or fill the cache from a run on copies), without
        touching the optimizer's counters or any weight. A key that
        differs from the live fit's only means the first real step misses;
        never a wrong program. Returns whether a step was resolved."""
        from .. import progcache

        if not progcache.active() or manager is None:
            return False
        try:
            state = manager.load_latest()
            if state is None:
                return False
            arg_params = state.arg_params()
            fixed = getattr(self, "_fixed_param_names", set())
            all_names = list(getattr(self, "_param_names", []))
            names = [n for n in all_names if n not in fixed]
            if not names or any(n not in arg_params for n in names):
                return False
            from ..ndarray import array as nd_array
            from ..optimizer import create as opt_create
            from ..optimizer.optimizer import Optimizer, Updater

            if isinstance(optimizer, Optimizer):
                opt = optimizer
            else:
                # Module.init_optimizer's construction (the 1/batch rescale
                # included), so that the statics match the live engine's
                params = dict(optimizer_params or {})
                provide = getattr(train_data, "provide_data", None)
                if "rescale_grad" not in params and provide:
                    params["rescale_grad"] = 1.0 / provide[0][1][0]
                opt = opt_create(optimizer, **params)
            ctx = getattr(self, "_context", None)
            indices = [i for i, n in enumerate(all_names) if n not in fixed]
            weights = [nd_array(np.asarray(arg_params[n]), ctx=ctx)
                       for n in names]
            warmed = Updater(opt).prewarm_batch(indices, weights)
            if warmed:
                self.logger.info("elastic: fused update step warmed from "
                                 "the program cache while quarantined")
            return warmed
        except Exception as e:  # noqa: BLE001 — the warm is optional
            self.logger.debug("program-cache prewarm skipped: %s", e)
            return False

    @staticmethod
    def _set_partition(train_data, info):
        """Recut the iterator to the fleet's shard assignment (an iterator
        that cannot be recut keeps its construction-time shard)."""
        if hasattr(train_data, "set_partition"):
            try:
                train_data.set_partition(info.part_index, info.num_parts)
            except NotImplementedError:
                pass

    def _elastic_broadcast_params(self, kv, root: bool):
        """One fused broadcast of the lead rank's parameters and aux
        states into every rank's bound executor (cold co-start only)."""
        exec_ = getattr(self, "_exec", None)
        if exec_ is None or not hasattr(kv, "broadcast_arrays"):
            return
        names = [n for n in getattr(self, "_param_names", [])
                 if n in exec_.arg_dict]
        targets = [exec_.arg_dict[n] for n in names] \
            + [exec_.aux_dict[n] for n in getattr(self, "_aux_names", [])
               if n in exec_.aux_dict]
        if not targets:
            return
        # the elastic broadcast rides the host-side PS wire
        vals = kv.broadcast_arrays([t.asnumpy() for t in targets], root)  # lint: disable=host-sync-on-hot-path
        if not root:
            for t, v in zip(targets, vals):
                t._set_data(_host_tensor(v, t))

    def _elastic_sync_grads(self, kv):
        """The mean of this step's gradients over the live fleet (one
        fused reduction, ``DistKVStore.allreduce_mean``), written back
        into the executor's gradient arrays, so every surviving rank
        applies the same update; the divisor is the count that
        contributed."""
        exec_ = getattr(self, "_exec", None)
        if exec_ is None or not hasattr(kv, "allreduce_mean"):
            return
        fixed = getattr(self, "_fixed_param_names", set())
        names = [n for n in getattr(self, "_param_names", [])
                 if n not in fixed and exec_.grad_dict.get(n) is not None]
        if not names:
            return
        grads = [exec_.grad_dict[n] for n in names]
        # the elastic reduce is host-mediated: gradients cross the PS wire
        means, _n = kv.allreduce_mean([g.asnumpy() for g in grads])  # lint: disable=host-sync-on-hot-path
        for g, m in zip(grads, means):
            g._set_data(_host_tensor(m, g))

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

    def _apply_health_rollback(self, manager, monitor, train_data):
        """The sentinel's rollback: restore the newest checkpoint whose
        arrays are all finite (a CRC-valid snapshot written after the
        blowup is poisoned, not valid): parameters, optimizer slots and
        counters, RNG streams and the iterator cursor, the resume path, so
        the retried segment replays bitwise. Returns ``(state,
        iterator_positioned)`` or None when nothing usable exists."""
        from ..checkpoint.state import restore_iterator

        manager.flush()  # queued async saves must be on disk to be judged
        state = health_mod.find_rollback_target(manager)
        if state is None:
            self.logger.warning(
                "health: rollback requested but no valid finite checkpoint "
                "exists — continuing without rollback")
            return None
        self.init_params(arg_params=state.arg_params(),
                         aux_params=state.aux_params(), force_init=True)
        self._restore_training_state(state)
        positioned = restore_iterator(train_data, state)
        monitor.note_rollback(state.global_step)
        obs.event("health.rollback", step=state.global_step,
                  epoch=state.epoch, nbatch=state.nbatch)
        self.logger.warning(
            "health: rolled back to checkpoint step %d (epoch %s%s)",
            state.global_step, state.epoch,
            f", batch {state.nbatch}" if state.nbatch is not None
            and positioned else "")
        return state, positioned


def _host_tensor(values, like):
    """numpy ``values`` as a tensor of ``like``'s dtype on its device."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(values)).to(
        device=like._data.device, dtype=like._data.dtype)


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]
