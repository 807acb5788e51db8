"""Dynamic micro-batching scheduler — the concurrency half of
``mxnet_tpu_torch.serve`` (counterpart of ``mxnet_tpu/serve/batcher.py``).

- **Bounded queue + load shedding**: beyond ``max_queue`` queued requests
  the submitter gets an immediate :class:`RequestRejected`.
- **Deadline propagation**: expired requests are shed — at submit, while
  queued, and at batch assembly — never executed late.
- **Priority lanes**: lane 0 is the tight-SLO lane; assembly starts from
  the highest non-empty lane and never waits on lower-lane stragglers.
- **Linger**: after the first request is picked, assembly tops the batch
  up with shape-compatible requests for at most ``max_linger_ms``, capped
  by the earliest member deadline.

The worker thread is the only one that runs the engine, so the device's
work is issued from one thread; submitters touch host numpy only.

Every phase is telemetered, as the reference's: per-request
``serve.queue_wait`` spans (recorded with the real enqueue time, under
the request's own trace context, captured at submit),
``serve.batch_assembly`` spans under the batch's lead context, shed
counters by cause, the queue-depth and occupancy gauges, and the
end-to-end ``serve.latency_seconds`` histogram.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np

from .. import obs
from ..obs import context as obs_context

from .engine import DeadlineExceeded, Draining, RequestRejected, ServeError

__all__ = ["DynamicBatcher", "Future"]


class Future:
    """Completion handle for a submitted request."""

    __slots__ = ("_event", "_result", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def _set_result(self, result) -> None:
        self._result = result
        self._event.set()

    def _set_error(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def result(self, timeout: Optional[float] = None):
        """Block for ``(outputs, param_version)``; raises the request's
        error (DeadlineExceeded on wait timeout)."""
        if not self._event.wait(timeout):
            raise DeadlineExceeded("timed out waiting for inference result")
        if self._error is not None:
            raise self._error
        return self._result


class _Request:
    __slots__ = ("data", "n", "feat", "deadline", "priority", "t_enqueue",
                 "future", "ctx")

    def __init__(self, data: List[np.ndarray], deadline: Optional[float],
                 priority: int):
        self.data = data
        self.n = int(data[0].shape[0])
        # batchable iff per-row feature shapes and dtypes agree
        self.feat = tuple((a.shape[1:], str(a.dtype)) for a in data)
        self.deadline = deadline
        self.priority = priority
        self.t_enqueue = time.monotonic()
        self.future = Future()
        # the submitter's trace context crosses to the worker with the
        # request: spans recorded there hang off the serve.rpc span
        self.ctx = obs_context.current()


class DynamicBatcher:
    """Assemble concurrent requests into engine-sized batches.

    Parameters
    ----------
    engine : InferenceEngine
        The compiled executor batches are dispatched to.
    max_batch_size : int, optional
        Rows per assembled batch (default: the engine's top bucket).
    max_linger_ms : float
        How long assembly may wait to top up a non-full batch. 0 disables
        lingering (every request dispatches immediately).
    max_queue : int
        Queued-request watermark; submissions beyond it are shed with
        :class:`RequestRejected`.
    lanes : int
        Priority lanes; 0 is served first. Default 2 (interactive / bulk).
    """

    def __init__(self, engine, *, max_batch_size: Optional[int] = None,
                 max_linger_ms: float = 2.0, max_queue: int = 256,
                 lanes: int = 2):
        if lanes < 1:
            raise ValueError("need at least one priority lane")
        self.engine = engine
        self.max_batch_size = int(max_batch_size or engine.max_batch_size)
        self.max_linger = max(float(max_linger_ms), 0.0) / 1e3
        self.max_queue = int(max_queue)
        self._lanes: List[List[_Request]] = [[] for _ in range(lanes)]
        self._qsize = 0
        self._cv = threading.Condition()
        self._running = True
        self._draining = False
        self._inflight = 0
        self.submitted = 0
        self.completed = 0
        self.shed = 0
        # batch-occupancy accounting (unconditional, like the counters
        # above — the autoscaler reads it through STATS with obs off):
        # rows-per-dispatched-batch over max_batch_size, EWMA'd so stats()
        # reports RECENT pressure, not a lifetime average that a quiet
        # hour would freeze high
        self.exec_batches = 0
        self.exec_rows = 0
        self._occ_ewma = 0.0
        # sheds counted by cause (queue_full / deadline / draining):
        # "the endpoint shed 40 requests" is an alert, "38 deadline-expired
        # vs 2 queue-overflow" is a diagnosis — and the fleet STATS endpoint
        # surfaces this per replica
        self.shed_by_reason = {"queue_full": 0, "deadline": 0, "draining": 0}
        # None until close(); then True iff the worker thread exited within
        # the join budget (a leaked batcher thread pins the engine and its
        # device buffers — the fleet's stop accounting reads this)
        self.stopped_clean: Optional[bool] = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mxnet-tpu-serve-batcher")
        self._thread.start()

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, inputs, deadline_ms: Optional[float] = None,
               priority: int = 1) -> Future:
        """Enqueue one request (``inputs``: one array per engine data
        input). ``deadline_ms`` is a relative latency budget from now;
        ``priority`` 0 is the tight-SLO lane. Raises immediately when the
        request cannot be served (queue full / draining / dead on
        arrival) — fail fast, don't queue doomed work."""
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        arrays = [np.ascontiguousarray(np.asarray(x)) for x in inputs]
        if not arrays or arrays[0].ndim < 1:
            raise ServeError("request inputs must have a batch dimension")
        now = time.monotonic()
        deadline = now + deadline_ms / 1e3 if deadline_ms else None
        lane = min(max(int(priority), 0), len(self._lanes) - 1)
        req = _Request(arrays, deadline, lane)
        with self._cv:
            if not self._running:
                raise ServeError("batcher is closed")
            if self._draining:
                self.shed += 1  # the aggregate must equal sum(by_reason)
                self.shed_by_reason["draining"] += 1
                obs.inc("serve.shed_draining")
                raise Draining("endpoint is draining; request refused")
            if self._qsize >= self.max_queue:
                self.shed += 1
                self.shed_by_reason["queue_full"] += 1
                obs.inc("serve.shed_queue_full")
                raise RequestRejected(
                    f"queue over watermark ({self.max_queue} requests); "
                    "back off and retry")
            # fresh clock read: ``deadline`` was built from ``now``, so
            # comparing against ``now`` itself can never fire — a
            # sub-resolution budget must still be dead on arrival
            if deadline is not None and deadline <= time.monotonic():
                self.shed += 1
                self.shed_by_reason["deadline"] += 1
                obs.inc("serve.shed_deadline")
                raise DeadlineExceeded("deadline expired before enqueue")
            self._lanes[lane].append(req)
            self._qsize += 1
            self.submitted += 1
            depth = self._qsize
            self._cv.notify_all()
        obs.set_gauge("serve.queue_depth", depth)
        return req.future

    # ------------------------------------------------------------------
    # worker
    # ------------------------------------------------------------------
    def _shed_locked(self, req: _Request, why: str) -> None:
        self.shed += 1
        self.shed_by_reason[why] = self.shed_by_reason.get(why, 0) + 1
        obs.inc(f"serve.shed_{why}")
        req.future._set_error(DeadlineExceeded(
            f"deadline expired while queued ({why}); request shed, "
            "not executed"))

    def _pop_next_locked(self) -> Optional[_Request]:
        """First request of the highest-priority non-empty lane, shedding
        anything already past its deadline on the way."""
        now = time.monotonic()
        for lane in self._lanes:
            while lane:
                req = lane.pop(0)
                self._qsize -= 1
                if req.deadline is not None and req.deadline <= now:
                    self._shed_locked(req, "deadline")
                    continue
                return req
        return None

    def _top_up_locked(self, batch: List[_Request], rows: int) -> int:
        """Pull shape-compatible requests (priority order, FIFO in lane)
        into ``batch`` until the row budget is exhausted. Non-matching
        requests keep their queue position."""
        feat = batch[0].feat
        now = time.monotonic()
        for lane in self._lanes:
            i = 0
            while i < len(lane) and rows < self.max_batch_size:
                req = lane[i]
                if req.deadline is not None and req.deadline <= now:
                    lane.pop(i)
                    self._qsize -= 1
                    self._shed_locked(req, "deadline")
                    continue
                if req.feat == feat and rows + req.n <= self.max_batch_size:
                    lane.pop(i)
                    self._qsize -= 1
                    batch.append(req)
                    rows += req.n
                    continue
                i += 1
        return rows

    @staticmethod
    def _linger_end(batch: List[_Request], cap: float) -> float:
        """Lingering must not blow ANY member's SLO — recomputed after
        every top-up, since a tight-deadline request may join mid-linger."""
        for r in batch:
            if r.deadline is not None:
                cap = min(cap, r.deadline)
        return cap

    def _assemble(self) -> Optional[List[_Request]]:
        """Block for work, then gather one batch (linger included)."""
        with self._cv:
            while self._running and self._qsize == 0:
                # submit()/close() notify; the timeout is only a lost-wakeup
                # safety net, not a poll interval
                self._cv.wait(timeout=0.5)
            if not self._running and self._qsize == 0:
                return None
            first = self._pop_next_locked()
            if first is None:
                return None
            batch = [first]
            rows = self._top_up_locked(batch, first.n)
            if self.max_linger > 0 and rows < self.max_batch_size:
                cap = time.monotonic() + self.max_linger
                while rows < self.max_batch_size:
                    remaining = self._linger_end(batch, cap) - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                    rows = self._top_up_locked(batch, rows)
                    if not self._running:
                        break
            # shed members whose deadline expired while the batch lingered
            # (the NEVER-executed-late contract; a member that joined with
            # a tight deadline may have run out of budget waiting)
            now = time.monotonic()
            live = []
            for r in batch:
                if r.deadline is not None and r.deadline <= now:
                    self._shed_locked(r, "deadline")
                else:
                    live.append(r)
            batch = live
            if batch:
                self._inflight += 1
            depth = self._qsize
        obs.set_gauge("serve.queue_depth", depth)
        return batch or None

    def _execute(self, batch: List[_Request]) -> None:
        t_exec = time.monotonic()
        rows = sum(r.n for r in batch)
        occ = rows / float(self.max_batch_size)
        self.exec_batches += 1
        self.exec_rows += rows
        self._occ_ewma = occ if self.exec_batches == 1 \
            else 0.7 * self._occ_ewma + 0.3 * occ
        obs.set_gauge("serve.batch_occupancy", occ)
        rec = obs.enabled()
        # batch-level spans pin to the first SAMPLED member's trace: a
        # sampled request must never lose its execute/assembly spans to
        # an unsampled lead
        lead_ctx = batch[0].ctx
        for r in batch:
            if r.ctx is not None and r.ctx.sampled:
                lead_ctx = r.ctx
                break
        if rec:
            for r in batch:
                # retroactive span, pinned to the request's own context
                obs.trace.complete("serve.queue_wait", r.t_enqueue,
                                   t_exec - r.t_enqueue, ctx=r.ctx,
                                   priority=r.priority, rows=r.n)
            obs.trace.complete("serve.batch_assembly", batch[0].t_enqueue,
                               t_exec - batch[0].t_enqueue,
                               ctx=lead_ctx,
                               requests=len(batch), rows=rows)
            obs.observe("serve.batch_rows", rows)
            obs.observe("serve.batch_requests", len(batch))
        try:
            if len(batch) == 1:
                inputs = batch[0].data
            else:
                inputs = [np.concatenate([r.data[i] for r in batch], axis=0)
                          for i in range(len(batch[0].data))]
            with obs_context.use(lead_ctx):
                outs, version = self.engine.infer(inputs, n_valid=rows)
            lo = 0
            done_t = time.monotonic()
            for r in batch:
                r.future._set_result(
                    ([o[lo:lo + r.n] for o in outs], version))
                lo += r.n
                if rec:
                    obs.observe("serve.latency_seconds",
                                done_t - r.t_enqueue)
            self.completed += len(batch)
        except BaseException as e:  # noqa: BLE001 — forwarded to waiters
            obs.inc("serve.execute_errors")
            err = e if isinstance(e, ServeError) else ServeError(
                f"inference execution failed: {type(e).__name__}: {e}")
            for r in batch:
                r.future._set_error(err)
        finally:
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()

    def _loop(self) -> None:
        while True:
            batch = self._assemble()
            if batch is None:
                if not self._running:
                    return
                continue
            self._execute(batch)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def queue_depth(self) -> int:
        return self._qsize

    def stats(self) -> dict:
        return {"submitted": self.submitted, "completed": self.completed,
                "shed": self.shed, "shed_by_reason": dict(self.shed_by_reason),
                "stopped_clean": self.stopped_clean,
                "queue_depth": self._qsize,
                "occupancy": round(self._occ_ewma, 4),
                "batches_executed": self.exec_batches,
                "rows_executed": self.exec_rows,
                "inflight": self._inflight, "lanes": len(self._lanes),
                "max_batch_size": self.max_batch_size,
                "max_linger_ms": self.max_linger * 1e3,
                "max_queue": self.max_queue}

    def drain(self, timeout: float = 30.0) -> bool:
        """Refuse new work, then wait for queued + in-flight requests to
        finish. True when fully drained."""
        deadline = time.monotonic() + timeout
        with self._cv:
            self._draining = True
            self._cv.notify_all()
            while self._qsize > 0 or self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(timeout=remaining)
        return True

    def close(self, timeout: float = 30.0) -> None:
        self.drain(timeout)
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._thread.join(timeout=5)
        # a timed-out join leaks the worker: flag it instead of
        # pretending the shutdown was clean
        self.stopped_clean = not self._thread.is_alive()
        if not self.stopped_clean:
            obs.inc("serve.batcher_thread_leaked")
            obs.event("serve.batcher_thread_leaked", join_timeout_s=5,
                      inflight=self._inflight, queue_depth=self._qsize)
