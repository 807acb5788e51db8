"""Elastic training plane: worker membership, generations and survivable
sync (counterpart of ``mxnet_tpu/kvstore/elastic.py``).

- **Membership** (:class:`ElasticState`, server side): workers announce
  themselves (``OP_JOIN``) and heartbeat (``OP_HB``) on the PS wire. A
  liveness monitor declares a worker dead after K missed heartbeats and
  bumps a monotonic **generation**; every barrier, reduce round and epoch
  rendezvous is scoped to the live membership, so a dead rank releases
  collective waits over the survivors instead of timing them out.
- **Generation-scoped reduce** (``OP_REDUCE``): the allreduce of elastic
  ``dist_sync``. A round completes when every live member contributed;
  contributions are deduped by client id and released rounds cached, so a
  retried frame whose ack was lost is answered idempotently.
- **Epoch rendezvous** (``OP_EPOCH``): the barrier at epoch boundaries
  where membership changes apply: quarantined joiners are activated, the
  data shards (``part_index`` / ``num_parts``) recut and reduce rounds
  renumbered. A worker that restarts mid-epoch is quarantined until the
  next boundary and restores from the shared checkpoint meanwhile.
- **Worker session** (:class:`ElasticWorkerSession`): join, activation,
  allreduce, epoch_end, and a background :class:`Heartbeater` on its own
  socket.

The server's durable state (:func:`capture_server_state`,
:func:`install_server_state`) and the push write-ahead log
(:class:`PushWAL`, the reference's record framing, so a log the reference
wrote replays here) live here too.

The training-fleet plane rides this one: a :class:`Heartbeater` with a
``part_provider`` carries the worker's telemetry part (``obs/fleetstats.py``
``wire_part``) after the beat's 16-byte identity, and the membership,
reduce and epoch paths emit the reference's ``elastic.*`` events and
spans; the server records each reduce contributor's wait by rank. Its
locks are the sanitizer's (``tsan.py``: ``elastic.state.cv``,
``elastic.wal``, ``ps.key``), and the server's ``ps:post_apply`` kill
point makes a warm restart from snapshot and WAL testable. Env
knobs:
``MXNET_ELASTIC``, ``MXNET_ELASTIC_HEARTBEAT_S``, ``MXNET_ELASTIC_MISS_K``,
``MXNET_ELASTIC_JOIN_TIMEOUT_S``, ``MXNET_ELASTIC_REDUCE_TIMEOUT_S``,
``MXNET_PS_WAL_FSYNC``.
"""
from __future__ import annotations

import os
import struct
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from .. import obs, tsan
from ..base import MXNetError, get_env
from ..wire import PS_WIRE

__all__ = ["ElasticState", "ElasticWorkerSession", "Heartbeater", "JoinInfo",
           "ElasticError", "StaleMemberError", "PushWAL", "elastic_enabled",
           "heartbeat_interval", "miss_threshold", "capture_server_state",
           "install_server_state", "ELASTIC_OP_NAMES"]

# opcodes 16-26 of the PS wire (0-9 the kvstore, 32-47 the serve plane)
(OP_HB, OP_JOIN, OP_REDUCE, OP_EPOCH, OP_LEAVE, OP_CLOCK, OP_CLOCK_PULL,
 OP_PULL_STALE, OP_REDUCE_SCOPED) = PS_WIRE.codes(
    "heartbeat", "join", "reduce", "epoch", "leave", "clock", "clock_pull",
    "pull_stale", "reduce_scoped")

ELASTIC_OP_NAMES = {code: name for code, name in PS_WIRE.names().items()
                    if code in (OP_HB, OP_JOIN, OP_REDUCE, OP_EPOCH,
                                OP_LEAVE, OP_CLOCK, OP_CLOCK_PULL,
                                OP_PULL_STALE, OP_REDUCE_SCOPED)}

# an OP_EPOCH payload carrying this epoch means "block until my
# quarantined membership is activated" (the rejoin wait)
WAIT_ACTIVATION = (1 << 64) - 1

# member status codes on the wire
ST_OK, ST_ERROR, ST_QUARANTINED, ST_STALE = 0, 1, 2, 3


class ElasticError(MXNetError):
    """An elastic-plane RPC failed structurally (timeout, protocol)."""


class StaleMemberError(ElasticError):
    """The server no longer counts this worker as a live member (declared
    dead after missed heartbeats, or never activated); it must rejoin at
    the next epoch boundary."""


def elastic_enabled() -> bool:
    return bool(get_env("MXNET_ELASTIC", False, bool))


def heartbeat_interval() -> float:
    return float(get_env("MXNET_ELASTIC_HEARTBEAT_S", 0.5, float))


def miss_threshold() -> int:
    return int(get_env("MXNET_ELASTIC_MISS_K", 4, int))


def _join_timeout() -> float:
    return float(get_env("MXNET_ELASTIC_JOIN_TIMEOUT_S", 600.0, float))


def _reduce_timeout() -> float:
    return float(get_env("MXNET_ELASTIC_REDUCE_TIMEOUT_S", 120.0, float))


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------

class _Member:
    __slots__ = ("cid", "rank", "state", "last_hb", "joined_gen")

    def __init__(self, cid: int, rank: int, state: str, gen: int):
        self.cid = cid
        self.rank = rank
        self.state = state  # active | quarantined | dead
        self.last_hb = time.monotonic()
        self.joined_gen = gen


class _Round:
    __slots__ = ("contribs", "stamps", "expected")

    def __init__(self):
        self.contribs: Dict[int, np.ndarray] = {}
        # cid -> arrival (monotonic): the reduce wait by rank, read at
        # the round's release
        self.stamps: Dict[int, float] = {}
        # a scoped round completes at this contributor count instead of
        # the full live membership; 0 = membership-scoped
        self.expected = 0


class ElasticState:
    """Server-side membership and generation-scoped collectives.

    One Condition guards everything; collective waits re-evaluate their
    completion on every wake, so a membership change (death, activation)
    releases them over the surviving set instead of leaving them to time
    out.
    """

    def __init__(self, hb_interval: Optional[float] = None,
                 miss_k: Optional[int] = None, on_change=None,
                 on_prune=None):
        self.cv = tsan.condition("elastic.state.cv")
        self.members: Dict[int, _Member] = {}
        self.generation = 0
        self.epoch = 0  # the epoch in progress fleet-wide
        self.started = False  # any reduce/epoch seen: later joins quarantine
        self.hb_interval = (heartbeat_interval() if hb_interval is None
                            else float(hb_interval))
        self.miss_k = miss_threshold() if miss_k is None else int(miss_k)
        self._rounds: Dict = {}        # (key, round) -> _Round
        self._completed: "OrderedDict" = OrderedDict()  # retried rounds
        self._epoch_arrived: set = set()
        # each request_recut() rotates the part indices over the rank
        # order at the next epoch boundary
        self.shard_salt = 0
        # called (outside cv) after any membership change, and with each
        # pruned cid
        self._on_change = list(on_change or [])
        self._on_prune = list(on_prune or [])
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None

    # -- views (call with cv held unless noted) -------------------------
    def has_members(self) -> bool:
        return bool(self.members)

    def active_members(self):
        return [m for m in self.members.values() if m.state == "active"]

    def active_count(self) -> int:
        return len(self.active_members())

    def assignment(self, cid: int):
        """(part_index, num_parts) over the actives ordered by (rank, cid),
        rotated by the recut salt."""
        order = sorted(self.active_members(), key=lambda m: (m.rank, m.cid))
        n = len(order)
        for i, m in enumerate(order):
            if m.cid == cid:
                return (i + self.shard_salt) % n, n
        return 0, max(1, n)

    def request_recut(self) -> int:
        """Rotate the shard assignment at the next epoch boundary; returns
        the new salt."""
        with self.cv:
            self.shard_salt += 1
            salt = self.shard_salt
        obs.inc("elastic.shard_recuts")
        obs.event("elastic.shard_recut_requested", salt=salt)
        return salt

    def liveness_table(self):
        """[(rank, cid, state, heartbeat_age_s)] (takes cv)."""
        now = time.monotonic()
        with self.cv:
            return [(m.rank, m.cid, m.state, round(now - m.last_hb, 3))
                    for m in self.members.values()]

    # -- membership -----------------------------------------------------
    def join(self, cid: int, rank: int):
        with self.cv:
            m = self.members.get(cid)
            if m is None:
                state = "quarantined" if self.started else "active"
                m = _Member(cid, rank, state, self.generation)
                self.members[cid] = m
                if state == "active":
                    self._bump_generation("join", cid=cid, rank=rank)
                obs.inc("elastic.joins")
                obs.event("elastic.member_joined", cid=cid, rank=rank,
                          state=state, generation=self.generation)
            elif m.state != "dead":
                # a declared-dead cid's retries must not refresh last_hb,
                # or the corpse would outlive the prune forever
                m.last_hb = time.monotonic()
            part, nparts = self.assignment(cid)
            reply = (m.state, self.generation, self.epoch, part, nparts,
                     self.active_count())
        self._ensure_monitor()
        self._notify_change()
        return reply

    def heartbeat(self, cid: int):
        with self.cv:
            m = self.members.get(cid)
            if m is None:
                return ST_ERROR, self.generation, self.active_count()
            if m.state != "dead":
                now = time.monotonic()
                # the liveness window's margin: a live gap near
                # hb_interval * miss_k is a false death in waiting
                obs.observe("elastic.heartbeat_gap_s", now - m.last_hb)
                m.last_hb = now
            st = ST_OK if m.state == "active" else (
                ST_QUARANTINED if m.state == "quarantined" else ST_STALE)
            return st, self.generation, self.active_count()

    def leave(self, cid: int):
        with self.cv:
            m = self.members.pop(cid, None)
            if m is not None and m.state == "active":
                self._bump_generation("leave", cid=cid, rank=m.rank)
                if not self.active_members():
                    # fleet takeover: quarantined joiners behind a fleet
                    # that left would wait for a boundary nobody reaches
                    self._takeover_locked()
                self._reevaluate_locked()
        if m is not None:
            self._forget_member(cid, pruned=False)
        self._notify_change()

    def _bump_generation(self, reason: str, **attrs):
        """Caller holds cv."""
        self.generation += 1
        obs.set_gauge("elastic.generation", self.generation)
        obs.set_gauge("elastic.active_workers", self.active_count())
        obs.event("elastic.generation_bump", reason=reason,
                  generation=self.generation, **attrs)

    # -- liveness monitor ------------------------------------------------
    def _ensure_monitor(self):
        if self._monitor is None or not self._monitor.is_alive():
            self._monitor = threading.Thread(
                target=self._liveness_loop, daemon=True,
                name="mxt-elastic-liveness")
            self._monitor.start()

    def close(self):
        self._stop.set()
        with self.cv:
            self.cv.notify_all()
        if self._monitor is not None:
            self._monitor.join(timeout=2)
            if self._monitor.is_alive():
                obs.inc("elastic.monitor_thread_leaked")

    def _liveness_loop(self):
        window = self.hb_interval * self.miss_k
        # a restarted worker draws a fresh cid, so corpses only pile up
        # with churn: they are pruned once they can no longer matter
        prune_after = max(30.0, window * 10)
        while not self._stop.wait(self.hb_interval):
            now = time.monotonic()
            changed = False
            pruned = []
            with self.cv:
                for m in list(self.members.values()):
                    if m.state in ("active", "quarantined") \
                            and now - m.last_hb > window:
                        m.state = "dead"
                        changed = True
                        obs.inc("elastic.deaths")
                        obs.event("elastic.member_dead", cid=m.cid,
                                  rank=m.rank,
                                  heartbeat_age_s=round(now - m.last_hb, 3))
                    elif m.state == "dead" \
                            and now - m.last_hb > prune_after:
                        del self.members[m.cid]
                        pruned.append(m.cid)
                if obs.enabled():
                    for m in self.members.values():
                        obs.set_gauge(
                            f"kvstore.member{m.cid}.last_hb_age_s",
                            round(now - m.last_hb, 3))
                    obs.set_gauge("kvstore.generation", self.generation)
                    obs.set_gauge("kvstore.live_workers",
                                  self.active_count())
                if changed:
                    self._bump_generation("death")
                    # every active died while joiners wait quarantined:
                    # activate them, or they wait for a boundary forever
                    if not self.active_members():
                        self._takeover_locked()
                    self._reevaluate_locked()
            for cid in pruned:
                self._forget_member(cid)
            if changed:
                self._notify_change()

    def _notify_change(self):
        for cb in self._on_change:
            try:
                cb()
            except Exception:  # noqa: BLE001 — an observer must not kill
                obs.inc("elastic.callback_errors")  # the liveness loop

    def _forget_member(self, cid: int, pruned: bool = True) -> None:
        """A member left the table for good: drop its gauge; a prune also
        tells the prune observers."""
        obs.metrics.remove(f"kvstore.member{cid}.last_hb_age_s")
        if not pruned:
            return
        for cb in self._on_prune:
            try:
                cb(cid)
            except Exception:  # noqa: BLE001 — as _notify_change
                obs.inc("elastic.callback_errors")

    def _reevaluate_locked(self):
        """Membership shrank: any collective wait may now be complete."""
        for ck in list(self._rounds):
            self._try_complete_round_locked(ck)
        self._try_release_boundary_locked()
        self.cv.notify_all()

    # -- generation-scoped reduce ---------------------------------------
    def reduce(self, cid: int, key: str, round_id: int, arr: np.ndarray,
               timeout: float, expected: int = 0):
        """Blocking sum-allreduce contribution. Returns ``(status,
        generation, contributors, result)``. ``expected > 0`` makes it a
        scoped round that completes at that many distinct contributors
        (capped at the live fleet's size)."""
        with self.cv:
            self.started = True
            m = self.members.get(cid)
            if m is None or m.state != "active":
                obs.inc("elastic.stale_rejected")
                return ST_STALE, self.generation, 0, None
            ck = (key, int(round_id))
            done = self._completed.get(ck)
            if done is not None:  # idempotent retry of a released round
                return ST_OK, self.generation, done[0], done[1]
            r = self._rounds.setdefault(ck, _Round())
            if expected:
                r.expected = max(r.expected, int(expected))
            if cid not in r.contribs:
                r.stamps[cid] = time.monotonic()
            r.contribs.setdefault(cid, arr)  # dedup a duplicated frame
            self._try_complete_round_locked(ck)
            deadline = time.monotonic() + timeout
            while ck not in self._completed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return ST_ERROR, self.generation, 0, None
                self.cv.wait(timeout=min(remaining, self.hb_interval))
                self._try_complete_round_locked(ck)
            done = self._completed[ck]
            return ST_OK, self.generation, done[0], done[1]

    def _try_complete_round_locked(self, ck):
        r = self._rounds.get(ck)
        if r is None:
            return
        required = {m.cid for m in self.active_members()}
        if r.expected:
            need = min(r.expected, len(required)) if required \
                else r.expected
            if len(r.contribs) < max(1, need):
                return
        elif not required or not required.issubset(r.contribs):
            return
        contribs = list(r.contribs.values())
        result = contribs[0].copy()
        for c in contribs[1:]:
            result += c
        n = len(contribs)  # a since-dead member's contribution counts
        self._completed[ck] = (n, result)
        # clients advance one round past their own success, so per key
        # only the last two rounds can be retried
        key = ck[0]
        for stale in [c for c in self._completed
                      if c[0] == key and c[1] < ck[1] - 1]:
            del self._completed[stale]
        while len(self._completed) > 64:
            self._completed.popitem(last=False)
        del self._rounds[ck]
        obs.inc("elastic.reduce_rounds")
        if obs.enabled() and r.stamps:
            # the reduce wait by rank: release minus arrival; the rank
            # that arrived last is what the fleet stood waiting on
            now = time.monotonic()
            last_cid = max(r.stamps, key=lambda c: r.stamps[c])
            for cid_, t0 in r.stamps.items():
                m = self.members.get(cid_)
                if m is not None:
                    obs.observe(
                        f"kvstore.reduce_wait.rank{m.rank}_seconds",
                        now - t0)
            m = self.members.get(last_cid)
            if m is not None:
                obs.inc(f"kvstore.reduce_last_arriver.rank{m.rank}")
        if not r.expected and set(r.contribs) != required:
            obs.inc("elastic.reduce_partial")  # a member died mid-round
        self.cv.notify_all()

    # -- epoch rendezvous ------------------------------------------------
    def epoch_end(self, cid: int, epoch: int, timeout: float):
        """Generation-scoped boundary barrier. Returns ``(status,
        generation, next_epoch, part, nparts, active_count)``.
        ``epoch == WAIT_ACTIVATION`` blocks until this quarantined member
        is activated at a boundary."""
        deadline = time.monotonic() + timeout
        with self.cv:
            m = self.members.get(cid)
            if m is None or m.state == "dead":
                return (ST_STALE, self.generation, self.epoch, 0, 1,
                        self.active_count())
            if epoch == WAIT_ACTIVATION:
                while m.state == "quarantined":
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return (ST_ERROR, self.generation, self.epoch, 0, 1,
                                self.active_count())
                    self.cv.wait(timeout=min(remaining, self.hb_interval))
                    m = self.members.get(cid)
                    if m is None or m.state == "dead":
                        return (ST_STALE, self.generation, self.epoch, 0, 1,
                                self.active_count())
                return self._release_reply_locked(cid)
            self.started = True
            if m.state != "active":
                return (ST_STALE, self.generation, self.epoch, 0, 1,
                        self.active_count())
            if epoch > self.epoch:
                # the server is behind the fleet (restarted without a
                # fresh snapshot): the fleet's epoch wins, and the jump
                # clears the collective tables as a release does
                self.epoch = int(epoch)
                self._epoch_arrived.clear()
                self._rounds.clear()
                self._completed.clear()
                self.cv.notify_all()
            if epoch < self.epoch:  # retry of a released boundary
                return self._release_reply_locked(cid)
            self._epoch_arrived.add(cid)
            self._try_release_boundary_locked()
            while self.epoch <= epoch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._epoch_arrived.discard(cid)
                    return (ST_ERROR, self.generation, self.epoch, 0, 1,
                            self.active_count())
                self.cv.wait(timeout=min(remaining, self.hb_interval))
                if cid not in self.members \
                        or self.members[cid].state == "dead":
                    return (ST_STALE, self.generation, self.epoch, 0, 1,
                            self.active_count())
                self._try_release_boundary_locked()
            return self._release_reply_locked(cid)

    def _try_release_boundary_locked(self):
        required = {m.cid for m in self.active_members()}
        if not required or not required.issubset(self._epoch_arrived):
            return
        activated = self._activate_quarantined_locked()
        self._epoch_arrived.clear()
        # reduce rounds are scoped to the epoch: clearing the tables lets
        # numbering restart at 0, which is how a rejoiner syncs its count
        self._rounds.clear()
        self._completed.clear()
        self.epoch += 1
        obs.event("elastic.epoch_released", epoch=self.epoch,
                  generation=self.generation, activated=activated,
                  active=self.active_count())
        self.cv.notify_all()

    def _takeover_locked(self) -> int:
        """Every active member died or left: the quarantined joiners
        become the fleet, with the round tables cleared as at a boundary
        (they restart numbering at 0)."""
        activated = self._activate_quarantined_locked()
        if activated:
            self._rounds.clear()
            self._completed.clear()
            self._epoch_arrived.clear()
        return activated

    def _activate_quarantined_locked(self) -> int:
        joiners = [m for m in self.members.values()
                   if m.state == "quarantined"]
        for m in joiners:
            m.state = "active"
            obs.inc("elastic.rejoins")
            obs.event("elastic.member_activated", cid=m.cid, rank=m.rank)
        if joiners:
            self._bump_generation("activate",
                                  ranks=[m.rank for m in joiners])
        return len(joiners)

    def _release_reply_locked(self, cid):
        part, nparts = self.assignment(cid)
        return (ST_OK, self.generation, self.epoch, part, nparts,
                self.active_count())


# ---------------------------------------------------------------------------
# PS state durability (weights + optimizer + seq-dedup + generation)
# ---------------------------------------------------------------------------

def capture_server_state(server):
    """A consistent snapshot of a PSServer. Each key's weight, optimizer
    slot and seq-dedup entries are copied under that key's lock, the lock
    its seq pushes apply under, so no key's snapshot holds an update
    without its seq."""
    from ..checkpoint.state import (TrainingState, _flatten_opt_state,
                                    capture_optimizer)

    arrays: Dict[str, np.ndarray] = {}
    seq_entries = []
    opt_tree = []
    updater = server._updater
    with server._global_lock:
        keys = list(server._weights)
    for key in keys:
        with server._locks.get(key, server._global_lock):
            w = server._weights.get(key)
            if w is None:
                continue
            arrays[f"w:{key}"] = np.ascontiguousarray(w)
            with server._seq_lock:
                for cid, seq in server._seq_by_key.get(key, {}).items():
                    seq_entries.append([str(cid), key, int(seq)])
            if updater is not None and key in updater.states:
                desc = _flatten_opt_state(updater.states[key], key, arrays)
                opt_tree.append(["s", key, desc])
    meta = {
        "kind": "ps_server",
        "opt_spec": server._opt_spec,
        "optimizer": {"state_tree": opt_tree},
        "seq": seq_entries,
        "num_workers": server._num_workers,
    }
    with server._clock_cv:
        if server._clock:
            meta["clock"] = [[int(r), int(c)]
                             for r, c in server._clock.items()]
            meta["clock_cids"] = [[str(cid), int(r)]
                                  for cid, r in server._clock_rank.items()]
    if server._optimizer is not None:
        scal = capture_optimizer(None, server._optimizer, arrays)
        meta["optimizer"].update(
            {k: v for k, v in scal.items() if k != "state_tree"})
    el = server._elastic
    if el is not None:
        with el.cv:
            meta["generation"] = el.generation
            meta["epoch"] = el.epoch
            meta["started"] = el.started
            # the membership rides the snapshot, so an elastic fleet
            # survives a PS warm restart: restored members go on
            # heartbeating and in-flight reduces retry
            meta["members"] = [
                [str(m.cid), int(m.rank), m.state]
                for m in el.members.values() if m.state != "dead"]
    return TrainingState(arrays, meta)


def install_server_state(server, state) -> None:
    """Warm-restart a PSServer from :func:`capture_server_state`: weights,
    the optimizer (spec re-parsed, slots and counters restored), the
    seq-dedup table (so replayed pushes still dedupe), the clocks and the
    membership generation."""
    from ..checkpoint.state import _unflatten_opt_state, restore_optimizer
    from ..context import cpu

    for name, arr in state.arrays.items():
        if name.startswith("w:"):
            key = name[2:]
            server._weights[key] = np.array(arr)
            server._locks[key] = tsan.lock("ps.key")
    with server._seq_lock:
        for cid, key, seq in state.meta.get("seq", []):
            server._record_seq(int(cid), key, int(seq))
    with server._clock_cv:
        for rank, clock in state.meta.get("clock", []):
            cur = server._clock.get(int(rank), 0)
            server._clock[int(rank)] = max(cur, int(clock))
        for cid, rank in state.meta.get("clock_cids", []):
            server._clock_rank[int(cid)] = int(rank)
        server._clock_cv.notify_all()
    spec = state.meta.get("opt_spec")
    if spec:
        server._set_optimizer_bytes(spec.encode("ascii"))
        meta = state.meta.get("optimizer", {})
        server._updater.states = {
            key: _unflatten_opt_state(desc, state.arrays, cpu())
            for _tag, key, desc in meta.get("state_tree", [])}
        restore_optimizer(None, server._optimizer, state)
    if server._elastic is not None and "generation" in state.meta:
        el = server._elastic
        with el.cv:
            el.generation = int(state.meta["generation"])
            el.epoch = int(state.meta.get("epoch", 0))
            el.started = bool(state.meta.get("started", False))
            for cid, rank, mstate in state.meta.get("members", []):
                # a fresh last_hb: a grace window for the restored member
                el.members[int(cid)] = _Member(int(cid), int(rank), mstate,
                                               el.generation)
        el._ensure_monitor()  # a stale restored member is still reaped
    obs.event("elastic.ps_warm_restart",
              keys=len([k for k in state.arrays if k.startswith("w:")]),
              seq_entries=len(state.meta.get("seq", [])),
              generation=state.meta.get("generation"))


class PushWAL:
    """Write-ahead log of seq-tagged pushes: the durability half of
    exactly-once across a server SIGKILL.

    Every applied seq push appends a CRC-framed record and is fsynced
    before the ack leaves; a warm restart replays the records through the
    seq-dedup path (what the snapshot holds skips itself).

    Record framing, byte-identical with the reference's:
    ``u32 len | u32 crc32(body) | body`` with
    ``body = u8 kind | u64 cid | u64 seq | u16 klen | key | payload``
    (kind 0 dense push, 1 sparse push, 2 key birth, 3 optimizer spec,
    4 committed-clock advance: key the decimal rank, seq the step).
    A torn tail record (SIGKILL mid-append) fails its CRC; replay stops
    there and truncates the file, since ``rotate`` may reopen it for
    appending. Files (``wal-<next snapshot step>.bin``) rotate at each
    snapshot commit and older ones are collected.
    ``MXNET_PS_WAL_FSYNC=0`` drops the fsync per push.
    """

    def __init__(self, directory: str):
        self._dir = directory
        self._lock = tsan.lock("elastic.wal")
        self._file = None
        self._fsync = bool(get_env("MXNET_PS_WAL_FSYNC", True, bool))

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"wal-{step:08d}.bin")

    def rotate(self, next_step: int) -> None:
        """Open a fresh log for the interval after snapshot
        ``next_step - 1`` and collect logs older than that snapshot."""
        with self._lock:
            if self._file is not None:
                self._file.close()
            self._file = open(self._path(next_step), "ab")
            for name in os.listdir(self._dir):
                if name.startswith("wal-") and name.endswith(".bin"):
                    try:
                        step = int(name[4:-4])
                    except ValueError:
                        continue
                    if step < next_step - 1:
                        try:
                            os.remove(os.path.join(self._dir, name))
                        except OSError:
                            pass

    def append(self, kind: int, cid: int, seq: int, key: str,
               payload: bytes) -> None:
        from ..checkpoint.atomic import crc32_bytes

        kb = key.encode()
        body = (struct.pack("<BQQH", kind, cid, seq, len(kb)) + kb
                + bytes(payload))
        rec = struct.pack("<II", len(body), crc32_bytes(body)) + body
        with self._lock:
            if self._file is None:
                self._file = open(self._path(0), "ab")
            f = self._file
            f.write(rec)
            f.flush()
        if self._fsync:
            # outside the lock: one fsync covers every record written to
            # the fd so far, and concurrent fsyncs coalesce in the kernel
            try:
                os.fsync(f.fileno())
            except (OSError, ValueError):
                pass  # rotate/close raced us after flushing the record

    def replay(self, apply_fn) -> int:
        """Feed every intact record to ``apply_fn(kind, cid, seq, key,
        payload)`` in file order; a torn record stops its file and
        truncates it there. Returns the number of records offered."""
        from ..checkpoint.atomic import crc32_bytes

        files = sorted(n for n in os.listdir(self._dir)
                       if n.startswith("wal-") and n.endswith(".bin"))
        count = 0
        for name in files:
            path = os.path.join(self._dir, name)
            try:
                with open(path, "rb") as f:
                    blob = f.read()
            except OSError:
                continue
            off = 0
            while off + 8 <= len(blob):
                ln, crc = struct.unpack_from("<II", blob, off)
                body = blob[off + 8:off + 8 + ln]
                if len(body) < ln or crc32_bytes(body) != crc:
                    break  # torn tail: that push was never acked
                kind, cid, seq, klen = struct.unpack_from("<BQQH", body, 0)
                key = body[19:19 + klen].decode()
                apply_fn(kind, cid, seq, key, body[19 + klen:])
                count += 1
                off += 8 + ln
            if off < len(blob):
                try:
                    with open(path, "r+b") as f:
                        f.truncate(off)
                except OSError:
                    pass
        return count

    def close(self):
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------

class JoinInfo:
    """A worker's place in the fleet after a join, an activation or an
    epoch rendezvous."""

    __slots__ = ("active", "generation", "epoch", "part_index", "num_parts",
                 "active_count", "changed")

    def __init__(self, active, generation, epoch, part_index, num_parts,
                 active_count, changed=False):
        self.active = active
        self.generation = generation
        self.epoch = epoch
        self.part_index = part_index
        self.num_parts = num_parts
        self.active_count = active_count
        self.changed = changed

    def __repr__(self):
        return (f"JoinInfo(active={self.active}, gen={self.generation}, "
                f"epoch={self.epoch}, shard={self.part_index}/"
                f"{self.num_parts})")


class Heartbeater:
    """Background heartbeats on their own socket (a blocking reduce on the
    main client's connection must never delay one). Connection failures
    back off and never raise: a missing server looks like missed
    heartbeats, which is what the liveness monitor is for.

    ``part_provider``: a callable whose bytes (the training-fleet plane's
    ``wire_part``) ride the beat after its 16-byte identity; None or an
    empty return sends the bare beat."""

    def __init__(self, host: str, port: int, cid: int, rank: int,
                 interval: Optional[float] = None, part_provider=None):
        self._addr = (host, port)
        self._cid = cid
        self._rank = rank
        self._part_provider = part_provider
        self.interval = (heartbeat_interval() if interval is None
                         else float(interval))
        self._sock = None
        self._stop = threading.Event()
        self.last_status = ST_OK
        self.generation = 0
        self.active_count = 0
        self._failures = 0
        self._final = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mxt-elastic-heartbeat")
        self._thread.start()

    def _loop(self):
        import socket as _socket

        from ..base import capped_backoff, configure_socket_keepalive
        from .ps_server import _recv_msg, _send_msg

        payload = struct.pack("<QQ", self._cid, self._rank)
        # a drained part is destructive state: a send that failed keeps
        # the blob for the next beat instead of losing the rank's windows
        pending = b""
        while not self._stop.is_set():
            try:
                if self._sock is None:
                    self._sock = _socket.create_connection(
                        self._addr, timeout=max(2.0, self.interval * 4))
                    configure_socket_keepalive(self._sock)
                if not pending and self._part_provider is not None:
                    try:
                        pending = self._part_provider() or b""
                    except Exception:  # noqa: BLE001 — telemetry must
                        pending = b""  # never break the heartbeat
                _send_msg(self._sock, OP_HB, "", payload + pending)
                # cleared once sent, not at the ack: a lost reply would
                # otherwise ship the part twice (windows are keyed by
                # index, spans are not)
                pending = b""
                _, _, reply = _recv_msg(self._sock)
                self._failures = 0
                if len(reply) >= 13:
                    st, gen, count = struct.unpack_from("<BQI", reply, 0)
                    self.last_status = st
                    self.generation = gen
                    self.active_count = count
                obs.inc("elastic.heartbeats")
            except (ConnectionError, OSError):
                if self._sock is not None:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None
                self._failures += 1
                obs.inc("elastic.heartbeat_failures")
                self._stop.wait(capped_backoff(self._failures, self.interval,
                                               self.interval * 4))
                continue
            self._stop.wait(self.interval)
        if self._final and self._part_provider is not None:
            self._last_beat(payload, pending)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    def _last_beat(self, payload, pending):
        """One beat more on a clean stop, carrying what the provider holds
        (the fit's last sealed windows): nothing is left unshipped when
        the session leaves."""
        import socket as _socket

        from .ps_server import _recv_msg, _send_msg

        try:
            if not pending:
                pending = self._part_provider() or b""
            if not pending:
                return
            if self._sock is None:
                self._sock = _socket.create_connection(
                    self._addr, timeout=max(2.0, self.interval * 4))
            _send_msg(self._sock, OP_HB, "", payload + pending)
            _recv_msg(self._sock)
            obs.inc("elastic.heartbeats")
        except Exception:  # noqa: BLE001 — the server may be gone already
            obs.inc("elastic.heartbeat_failures")

    def stop(self, final: bool = False):
        """End the beats; ``final``: a clean leave's one last beat with
        the part not yet shipped (a silenced member, as the liveness tests
        make one, sends nothing more)."""
        self._final = final
        self._stop.set()
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            obs.inc("elastic.heartbeat_thread_leaked")


class ElasticWorkerSession:
    """A worker's handle on the elastic plane (owned by the elastic
    ``DistKVStore``): join, heartbeat, generation-scoped allreduce, epoch
    rendezvous, checkpointed rejoin."""

    def __init__(self, host: str, port: int, rank: int = 0,
                 expected: Optional[int] = None,
                 hb_interval: Optional[float] = None,
                 reduce_timeout: Optional[float] = None,
                 part_provider="auto"):
        from .ps_client import PSClient

        self._cli = PSClient(host, port, timeout=30.0, retries=8,
                             retry_interval=0.2)
        # an elastic server speaks the ping opcode: ping a connection
        # that idled past 30 s before reusing it, unless configured off
        if self._cli._idle_ping_s is None:
            self._cli._idle_ping_s = 30.0
        self.cid = self._cli._client_id
        self.rank = int(rank)
        self._expected = expected
        self._reduce_timeout = (_reduce_timeout() if reduce_timeout is None
                                else float(reduce_timeout))
        self._hb_interval = hb_interval
        # "auto": this process's step accounting (obs/fleetstats.py) rides
        # the heartbeats; in-process fleets pass each rank's wire_part,
        # None sends bare beats
        if part_provider == "auto":
            from ..obs import fleetstats as _fleetstats

            part_provider = _fleetstats.wire_part
        self._part_provider = part_provider
        self._hb: Optional[Heartbeater] = None
        self._round = 0
        self._joined: Optional[JoinInfo] = None
        self.generation = 0

    # -- membership -----------------------------------------------------
    def ensure_joined(self, wait_for_expected: bool = True,
                      timeout: float = 30.0) -> JoinInfo:
        """Register with the fleet (idempotent). A cold-start fleet admits
        joiners as active; once training started, joins are quarantined
        until the next epoch boundary. With ``expected`` set, an active
        cold-start join waits briefly for the full fleet, so the first
        shard cut is over all ranks."""
        if self._joined is not None:
            return self._joined
        info = self._join_rpc()
        if self._hb is None:
            self._hb = Heartbeater(self._cli._addr[0], self._cli._addr[1],
                                   self.cid, self.rank,
                                   interval=self._hb_interval,
                                   part_provider=self._part_provider)
        if (info.active and wait_for_expected and self._expected
                and info.active_count < self._expected):
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                info = self._join_rpc()
                if info.active_count >= self._expected:
                    break
                time.sleep(0.05)
        self._joined = info
        self.generation = info.generation
        return info

    def _join_rpc(self) -> JoinInfo:
        payload = struct.pack("<QQ", self.cid, self.rank)
        _, _, reply = self._cli._rpc(OP_JOIN, "", payload)
        st, gen, epoch, part, nparts, count = struct.unpack_from(
            "<BQQIII", reply, 0)
        if st == ST_STALE:
            raise StaleMemberError(
                "this worker was declared dead by the fleet; restart the "
                "process to rejoin with a fresh identity")
        return JoinInfo(st == ST_OK, gen, epoch, part, nparts, count)

    def await_activation(self, timeout: Optional[float] = None) -> JoinInfo:
        """Block (server-side) until the next epoch boundary activates this
        quarantined worker; returns the assignment after activation."""
        timeout = _join_timeout() if timeout is None else float(timeout)
        obs.inc("elastic.quarantine_waits")
        with obs.trace.span("elastic.await_activation"):
            info = self._epoch_rpc(WAIT_ACTIVATION, timeout)
        self._round = 0
        self._joined = info
        obs.event("elastic.activated", epoch=info.epoch,
                  generation=info.generation, part=info.part_index,
                  nparts=info.num_parts)
        return info

    # -- collectives ----------------------------------------------------
    def allreduce(self, key: str, arr: np.ndarray,
                  timeout: Optional[float] = None):
        """Generation-scoped sum over the live fleet: ``(summed,
        contributors)``. Retries are idempotent."""
        from .ps_server import _array_parts, _unpack_array

        timeout = self._reduce_timeout if timeout is None else float(timeout)
        # the wait bound rides in the request, so the server answers
        # before the client's socket gives up; the array goes as a view
        payload = ([struct.pack("<QQd", self.cid, self._round, timeout)]
                   + _array_parts(np.ascontiguousarray(arr)))
        with obs.trace.span("elastic.allreduce", key=key,
                            round=self._round):
            _, _, reply = self._cli._rpc(OP_REDUCE, key, payload,
                                         timeout=timeout + 10.0)
        st, gen, contributors = struct.unpack_from("<BQI", reply, 0)
        if st == ST_STALE:
            raise StaleMemberError(
                f"reduce for key {key!r} rejected: this worker is not a "
                f"live member of generation {gen}")
        if st != ST_OK:
            raise ElasticError(
                f"elastic reduce timed out for key {key!r} round "
                f"{self._round} (generation {gen})")
        if gen != self.generation:
            obs.event("elastic.generation_observed", generation=gen,
                      contributors=contributors)
            self.generation = gen
        self._round += 1
        return _unpack_array(reply[13:], copy=False), contributors

    def allreduce_scoped(self, key: str, arr: np.ndarray, expected: int,
                         round_id: int, timeout: Optional[float] = None,
                         payload: Optional[bytes] = None):
        """Scoped sum: the round completes at ``expected`` distinct
        contributors (the hierarchical reduction's transport).
        ``round_id`` is explicit; ``payload`` may carry pre-packed array
        bytes (the 2-bit framing)."""
        from .ps_server import _pack_array, _unpack_array

        timeout = self._reduce_timeout if timeout is None else float(timeout)
        body = (_pack_array(np.ascontiguousarray(arr))
                if payload is None else payload)
        req = (struct.pack("<QQdI", self.cid, int(round_id), timeout,
                           int(expected)) + body)
        with obs.trace.span("elastic.allreduce_scoped", key=key,
                            round=int(round_id), expected=int(expected)):
            _, _, reply = self._cli._rpc(OP_REDUCE_SCOPED, key, req,
                                         timeout=timeout + 10.0)
        st, gen, contributors = struct.unpack_from("<BQI", reply, 0)
        if st == ST_STALE:
            raise StaleMemberError(
                f"scoped reduce for key {key!r} rejected: this worker is "
                f"not a live member of generation {gen}")
        if st != ST_OK:
            raise ElasticError(
                f"scoped reduce timed out for key {key!r} round "
                f"{round_id} (expected {expected} contributors)")
        return _unpack_array(reply[13:]), contributors

    def epoch_end(self, epoch: int, timeout: Optional[float] = None
                  ) -> JoinInfo:
        """Epoch-boundary rendezvous: blocks until every live member
        arrives, activates quarantined rejoiners and returns the possibly
        recut shard assignment. Resets the reduce-round numbering."""
        timeout = _join_timeout() if timeout is None else float(timeout)
        with obs.trace.span("elastic.epoch_end", epoch=epoch):
            info = self._epoch_rpc(int(epoch), timeout)
        prev = self._joined
        info.changed = (prev is None
                        or prev.part_index != info.part_index
                        or prev.num_parts != info.num_parts)
        self._round = 0
        self._joined = info
        return info

    def _epoch_rpc(self, epoch: int, timeout: float) -> JoinInfo:
        payload = struct.pack("<QQd", self.cid, epoch, timeout)
        _, _, reply = self._cli._rpc(OP_EPOCH, "", payload,
                                     timeout=timeout + 10.0)
        st, gen, nxt, part, nparts, count = struct.unpack_from(
            "<BQQIII", reply, 0)
        if st == ST_STALE:
            raise StaleMemberError(
                "epoch rendezvous rejected: this worker was declared dead")
        if st != ST_OK:
            raise ElasticError(
                f"epoch rendezvous timed out (epoch {epoch})")
        self.generation = gen
        return JoinInfo(True, gen, nxt, part, nparts, count)

    def barrier(self, timeout: float = 90.0):
        """Generation-scoped barrier (the server counts live members once
        anyone joined)."""
        self._cli.barrier(timeout=timeout)

    # -- teardown -------------------------------------------------------
    def leave(self):
        try:
            self._cli._rpc(OP_LEAVE, "", struct.pack("<Q", self.cid),
                           retries=1)
        except MXNetError:
            pass  # the server may be gone already; liveness cleans up

    def close(self):
        if self._hb is not None:
            self._hb.stop(final=True)
            self._hb = None
        self.leave()
        self._cli.close()
