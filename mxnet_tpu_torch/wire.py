"""Declarative wire-opcode registry of the parameter-server (training)
and serve planes (counterpart of ``mxnet_tpu/wire.py``, same opcodes and
names).

Both planes share one length-prefixed binary framing
(``kvstore/ps_server.py``). Every opcode is an :class:`OpSpec` row (name,
code, plane, direction, mutating?, dedup discipline, WAL coverage,
traced?), and the registries raise at import on any duplicate code or
name, so two planes cannot claim one opcode. ``serve/server.py`` derives
its ``OP_*`` constants from :data:`SERVE_WIRE`, the parameter server
(``kvstore/ps_server.py``, ``kvstore/elastic.py``) from :data:`PS_WIRE`.

Standard library only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence, Tuple

__all__ = ["OpSpec", "WireRegistry", "PS_WIRE", "SERVE_WIRE",
           "check_disjoint", "DEDUP_KINDS"]

# Exactly-once disciplines a mutating op may declare:
#   "seq"        (client_id, seq) dedup table + (usually) WAL coverage
#   "token"      commit-token LRU (retried frame re-acks, never re-applies)
#   "idempotent" re-applying the frame is harmless by construction
#   "legacy"     documented at-least-once (plain PUSH; superseded by _seq)
DEDUP_KINDS = ("seq", "token", "idempotent", "legacy")


@dataclass(frozen=True)
class OpSpec:
    """One wire opcode, declaratively.

    ``direction`` is ``"request"`` for every current op (the reply rides
    the same opcode — request/reply pairing is checked by the protocol
    linter against the handler's reply sends). ``mutating`` means the op
    changes served/durable state; every mutating op must name its
    exactly-once discipline in ``dedup``. ``wal`` marks ops whose applied
    effect must survive a server SIGKILL (fsynced WAL record before the
    ack). ``traced`` means the handler loop is expected to extract and
    activate wire trace context for this op (true plane-wide).
    """

    name: str
    code: int
    plane: str
    direction: str = "request"
    mutating: bool = False
    dedup: Optional[str] = None
    wal: bool = False
    traced: bool = True
    const: Optional[str] = None  # python constant name, default OP_<NAME>

    @property
    def const_name(self) -> str:
        return self.const or ("OP_" + self.name.upper())


class WireRegistry:
    """An immutable opcode table for one handler loop.

    ``handler`` is ``(relpath, loop_fn, dispatch_fn)`` — where the plane's
    framed receive loop and its per-opcode dispatch live, for the protocol
    linter. Raises ``ValueError`` on any duplicate code, name, or
    constant name at construction time.
    """

    def __init__(self, plane: str, handler: Tuple[str, str, str],
                 ops: Sequence[OpSpec]):
        self.plane = plane
        self.handler_path, self.loop_fn, self.dispatch_fn = handler
        self._by_code: Dict[int, OpSpec] = {}
        self._by_name: Dict[str, OpSpec] = {}
        self._by_const: Dict[str, OpSpec] = {}
        for op in ops:
            if op.code in self._by_code:
                raise ValueError(
                    f"{plane}: opcode collision: {op.name!r} and "
                    f"{self._by_code[op.code].name!r} both claim code "
                    f"{op.code}")
            if op.name in self._by_name:
                raise ValueError(
                    f"{plane}: duplicate op name {op.name!r}")
            if op.const_name in self._by_const:
                raise ValueError(
                    f"{plane}: duplicate constant {op.const_name!r}")
            self._by_code[op.code] = op
            self._by_name[op.name] = op
            self._by_const[op.const_name] = op

    def __iter__(self) -> Iterator[OpSpec]:
        return iter(sorted(self._by_code.values(), key=lambda o: o.code))

    def __len__(self) -> int:
        return len(self._by_code)

    def code(self, name: str) -> int:
        return self._by_name[name].code

    def spec(self, name: str) -> OpSpec:
        return self._by_name[name]

    def codes(self, *names: str) -> Tuple[int, ...]:
        return tuple(self._by_name[n].code for n in names)

    def names(self) -> Dict[int, str]:
        """``{code: name}`` — the telemetry/chaos label table."""
        return {c: o.name for c, o in self._by_code.items()}

    def by_const(self) -> Dict[str, OpSpec]:
        return dict(self._by_const)


def check_disjoint(*registries: WireRegistry) -> None:
    """Raise ``ValueError`` if any two registries share an opcode."""
    seen: Dict[int, str] = {}
    for reg in registries:
        for op in reg:
            if op.code in seen:
                raise ValueError(
                    f"cross-plane opcode collision: code {op.code} claimed "
                    f"by {seen[op.code]} and {reg.plane}:{op.name}")
            seen[op.code] = f"{reg.plane}:{op.name}"


# ---------------------------------------------------------------------------
# the PS (training) plane: kvstore ops 0-9 + the elastic range 16-26,
# all dispatched by kvstore/ps_server.py
# ---------------------------------------------------------------------------

PS_WIRE = WireRegistry(
    "kvstore", ("mxnet_tpu_torch/kvstore/ps_server.py", "_handle_loop",
                "_handle_one"),
    [
        # key birth is idempotent (first-wins) but must survive a restart,
        # so it rides the WAL as a kind-2 record
        OpSpec("init", 0, "kvstore", mutating=True, dedup="idempotent",
               wal=True),
        # plain push is the documented at-least-once legacy path; the
        # retry-safe transport is push_seq
        OpSpec("push", 1, "kvstore", mutating=True, dedup="legacy"),
        OpSpec("pull", 2, "kvstore"),
        OpSpec("set_opt", 3, "kvstore", mutating=True, dedup="idempotent",
               wal=True),
        OpSpec("barrier", 4, "kvstore"),
        OpSpec("shutdown", 5, "kvstore"),
        OpSpec("push_sparse", 6, "kvstore", mutating=True, dedup="legacy"),
        OpSpec("pull_sparse", 7, "kvstore"),
        OpSpec("push_seq", 8, "kvstore", mutating=True, dedup="seq",
               wal=True),
        OpSpec("push_sparse_seq", 9, "kvstore", mutating=True, dedup="seq",
               wal=True),
        # elastic membership plane (kvstore/elastic.py state machine;
        # contributions deduped by cid, completed rounds LRU-cached)
        OpSpec("heartbeat", 16, "elastic", const="OP_HB"),
        OpSpec("join", 17, "elastic", mutating=True, dedup="idempotent"),
        OpSpec("reduce", 18, "elastic", mutating=True, dedup="idempotent"),
        OpSpec("epoch", 19, "elastic", mutating=True, dedup="idempotent"),
        OpSpec("leave", 20, "elastic", mutating=True, dedup="idempotent"),
        # training-fleet telemetry pull (obs/fleetstats.py): draining the
        # server's span ring + cached per-worker parts is destructive, so
        # retried collections re-serve the cached reply from the token LRU
        # (the serve-plane OP_TELEMETRY=42 idiom on the PS wire)
        OpSpec("telemetry", 21, "elastic", mutating=True, dedup="token"),
        # server stats snapshot (membership liveness, straggler verdicts,
        # hot keys, metrics under "metrics") — read-only, retries harmless
        OpSpec("stats", 22, "elastic"),
        # bounded-staleness async training (docs/ROBUSTNESS.md
        # "Asynchronous training"). clock: a worker commits "rank r
        # finished step t" — max-merge, so a retried frame is harmless
        # (idempotent), and the table must survive a server SIGKILL
        # mid-async-storm (kind-4 WAL record before the ack)
        OpSpec("clock", 23, "elastic", mutating=True, dedup="idempotent",
               wal=True),
        # read-only committed-clock table dump (floor + per-rank clocks):
        # tests and operators assert exactly-once clock recovery with it
        OpSpec("clock_pull", 24, "elastic"),
        # staleness-gated pull: blocks (wait bound rides IN the request —
        # the OP_REDUCE discipline) while the puller would run more than
        # `s` steps ahead of the fleet's committed clock floor
        OpSpec("pull_stale", 25, "elastic"),
        # scoped reduce: like "reduce" but the round completes at an
        # explicit contributor count instead of the full live membership —
        # the transport under hierarchical (group-tree) reduction
        OpSpec("reduce_scoped", 26, "elastic", mutating=True,
               dedup="idempotent"),
    ])


# ---------------------------------------------------------------------------
# the serve plane: opcodes 32-42, dispatched by serve/server.py
# ---------------------------------------------------------------------------

SERVE_WIRE = WireRegistry(
    "serve", ("mxnet_tpu_torch/serve/server.py", "_handle_loop", "_handle_one"),
    [
        OpSpec("infer", 32, "serve"),
        OpSpec("health", 33, "serve"),
        OpSpec("ready", 34, "serve"),
        # single-replica hot reload; the fleet path is prepare+commit
        OpSpec("reload", 35, "serve", mutating=True, dedup="legacy"),
        OpSpec("stats", 36, "serve"),
        OpSpec("drain", 37, "serve", mutating=True, dedup="idempotent"),
        OpSpec("serve_shutdown", 38, "serve", const="OP_SHUTDOWN"),
        OpSpec("prepare_reload", 39, "serve", mutating=True,
               dedup="idempotent"),
        OpSpec("commit_reload", 40, "serve", mutating=True, dedup="token"),
        OpSpec("abort_reload", 41, "serve", mutating=True,
               dedup="idempotent"),
        # draining the span ring is destructive: retried collections
        # re-serve the cached reply from the token LRU
        OpSpec("telemetry", 42, "serve", mutating=True, dedup="token"),
        # flight-recorder snapshot (obs/blackbox.py): read-only — the
        # bundle is built from the always-on ring without draining
        # anything, so retries are harmless by construction
        OpSpec("dump", 43, "serve"),
        # autoregressive streaming lane (serve/decode.py): one
        # infer_stream request fans into a chunked token/end/error reply
        # sequence on the same connection. Generation mutates no served
        # state (KV pages are scoped to the stream and reclaimed on any
        # exit), so the request op stays non-mutating; a duplicated
        # request (chaos dup) just streams the same tokens twice and the
        # client drains the echo.
        OpSpec("infer_stream", 44, "serve"),
        # chunk frames: direction="reply" — many frames answer ONE
        # infer_stream request, so the protocol linter's one-handler-
        # branch-per-request rule must not expect dispatch branches for
        # them. Chaos drop/dup address them by these names.
        OpSpec("stream_token", 45, "serve", direction="reply"),
        OpSpec("stream_end", 46, "serve", direction="reply"),
        OpSpec("stream_error", 47, "serve", direction="reply"),
    ])


check_disjoint(PS_WIRE, SERVE_WIRE)
