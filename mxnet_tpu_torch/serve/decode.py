"""Autoregressive decode engine: paged KV cache + continuous batching.

Counterpart of ``mxnet_tpu/serve/decode.py``. Two halves:

:class:`DecodeEngine` — the device half. Two kinds of call serve every
generation:

- a **bucketed prefill** (one shape per prompt bucket; buckets are powers
  of two in positions, always multiples of the page size): full causal
  forward over one padded prompt, per-layer K/V written into the page pool
  at the sequence's page ids, first token sampled on the device;
- a **single decode-step shape**: one new position for every slot of the
  fixed continuous batch — embed, per-layer paged-KV write + paged
  attention (``ops/flash_attention.decode_attention``, the CUDA kernel on
  the card), LM head, on-device greedy/temperature sampling.

Growing a sequence never changes a shape: the KV pool is one fixed tensor
``(pages, layers, 2, page_size, heads, head_dim)`` updated IN PLACE (the
reference donates the buffer to each program instead), and growth is a
host-side page-table edit (``serve/kvcache.py``). PyTorch runs eagerly, so
``compile_log`` records each distinct shape signature the first time it
runs: ``warmup()`` records ``len(buckets) + 1`` and no traffic mix adds
another. With a program cache (``progcache_dir=`` or the process-global
one) a signature's first run looks up its ``progcache.program_key``
(site ``decode``, label the prefill bucket or ``step``; statics the
model's config, slots, pages, buckets, parameter avals and device type),
as ``serve/engine.py``'s engine does: a hit is a ``cache_hit`` entry that
adopts the stored cost and loads the paged and flash kernels from their
entries; a miss writes its record. ``warmup()`` returns the signatures
that missed (0 on a warm start).

:class:`DecodeScheduler` — the host half, ported one to one: requests join
and leave the running decode batch at step boundaries; priority lanes and
the shed discipline (queue watermark → RequestRejected, dead-on-arrival
and mid-generation deadline → DeadlineExceeded, draining → Draining, page
exhaustion sheds the newest running stream) carry over, and every exit
funnels through ``_retire``.

Telemetry (``obs``), as the reference's: ``decode.execute`` spans around
each call, ``decode.queue_wait``/``decode.token``/``decode.generate``
completes pinned to each request's trace context (captured at submit),
``decode.step`` per step, the ``decode.*`` counters, gauges and
histograms, tail notes on sheds. Two additions: a prefill runs under its
request's context, so its ``decode.execute`` span joins that trace (the
step serves many traces and stays on none); and every ``decode.execute``
span carries its call's ``flops``, ``bytes_accessed`` and ``roofline``
class. With the device plane active a signature's first run is counted by
``obs.device.capture`` into its ``compile_log`` entry and the
``("decode", label)`` record; a step's paged-kernel share depends on the
rows' lengths, which the host holds, so each step's attrs take the
record's other work plus ``paged_decode_cost`` of its own lengths
(``paged_flops``/``paged_bytes``, over ``attended`` positions in
``pages`` pages). The span closes after the sampled tokens' host read,
the call's one wait on the device; later runs add the MFU over that wall.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import copytrack, obs, tsan
from .. import progcache as _progcache
from .._env import env_float, env_int
from ..context import as_device, current_context
from ..obs import context as obs_context
from .engine import DeadlineExceeded, Draining, RequestRejected, ServeError
from .kvcache import SCRATCH_PAGE, PagePool, PagesExhausted, pages_for

__all__ = ["DecodeEngine", "DecodeScheduler", "StreamHandle",
           "default_decode_buckets"]


def default_decode_buckets(max_prompt: int, page_size: int) -> List[int]:
    """Power-of-two prompt buckets, every one a multiple of the page size
    (so a bucketed prefill always fills whole pages): page 16, max 100 →
    [16, 32, 64, 112]."""
    max_prompt = int(max_prompt)
    page_size = int(page_size)
    if max_prompt < 1:
        raise ValueError("max_prompt must be >= 1")
    cap = pages_for(max_prompt, page_size) * page_size
    out = []
    b = page_size
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return out


def _device_scope(device: Optional[torch.device]):
    """Make ``device`` current in the calling thread (CUDA only; None, an
    engine that names no device, enters nothing)."""
    if device is not None and device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class DecodeEngine:
    """Paged-KV generation engine around a TransformerLM.

    Parameters
    ----------
    lm : TransformerLM or dict
        The port's LM, an initialized Gluon block (config/params taken
        via ``decode_config`` / ``decode_params``), or the config dict
        itself when ``params`` is given.
    params : dict, optional
        Parameter dict when ``lm`` is a config: numpy arrays (the JAX
        package's ``decode_params``) or tensors, same layout.
    slots : int
        Width of the continuous decode batch. Default
        ``MXNET_DECODE_SLOTS`` (8).
    page_size : int
        KV positions per page. Default ``MXNET_DECODE_PAGE_SIZE`` (16).
    num_pages : int
        Pool size (page 0 is reserved scratch). Default
        ``MXNET_DECODE_PAGES`` (64).
    prompt_buckets : list of int, optional
        Prefill pad targets; defaults to ``default_decode_buckets`` over
        the model's max_length (capped at the pool's capacity).
    device : str or torch.device, optional
        Where the parameters and the KV pool live. Default the enclosing
        context (``with mx.cpu():``), else ``cuda:0``; with neither a
        scope nor a card it raises. Pass ``"cpu"`` to run on the CPU.
    progcache_dir : str, optional
        Explicit persistent program cache; default the process-wide
        ``progcache.cache()`` (``MXNET_PROGCACHE_DIR``).
    """

    def __init__(self, lm, params=None, *, slots: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prompt_buckets: Optional[List[int]] = None,
                 device=None, progcache_dir: Optional[str] = None):
        from ..models.transformer import decode_config, decode_params

        self.device = (as_device(device) if device is not None
                       else current_context().torch_device())
        if params is None:
            self.cfg = decode_config(lm)
            params = decode_params(lm)
        else:
            self.cfg = dict(lm)
        self.slots = int(slots if slots is not None
                         else env_int("MXNET_DECODE_SLOTS", 8))
        self.page_size = int(page_size if page_size is not None
                             else env_int("MXNET_DECODE_PAGE_SIZE", 16))
        self.num_pages = int(num_pages if num_pages is not None
                             else env_int("MXNET_DECODE_PAGES", 64))
        self.max_length = int(self.cfg["max_length"])
        # page-table width of the step: enough for a full-context
        # sequence, but never more than the pool could back
        self.max_pages = min(pages_for(self.max_length, self.page_size),
                             self.num_pages - 1)
        max_prompt = min(self.max_length,
                         (self.num_pages - 1) * self.page_size)
        if prompt_buckets is None:
            prompt_buckets = default_decode_buckets(max_prompt,
                                                    self.page_size)
        buckets = sorted({int(b) for b in prompt_buckets})
        for b in buckets:
            if b % self.page_size or b < 1 or b > max_prompt:
                raise ValueError(
                    f"prompt bucket {b} must be a positive multiple of "
                    f"page_size={self.page_size} and <= {max_prompt}")
        self.buckets = buckets
        self.pool = PagePool(self.num_pages, self.page_size)

        def dev(a):
            if not isinstance(a, torch.Tensor):  # host arrays: own a copy
                a = torch.from_numpy(np.array(a, np.float32))
            return a.to(device=self.device, dtype=torch.float32)

        self._params = {k: dev(v) for k, v in params.items()
                        if k != "layers"}
        self._params["layers"] = [{k: dev(v) for k, v in lp.items()}
                                  for lp in params["layers"]]
        cfg = self.cfg
        self.kv = torch.zeros(
            (self.num_pages, cfg["layers"], 2, self.page_size,
             cfg["heads"], cfg["head_dim"]), dtype=torch.float32,
            device=self.device)

        # shape-signature accounting: one record per distinct signature
        self._programs: Dict[tuple, int] = {}
        self.compile_log: List[dict] = []
        self._sig_cost: Dict[tuple, dict] = {}  # device-plane records
        self.cache_hits = 0
        self.exec_count = 0
        self._stat_lock = tsan.lock("serve.decode.stats")

        self._progcache = (_progcache.ProgramCache(progcache_dir)
                           if progcache_dir else _progcache.cache())
        self._sig_key: Dict[tuple, object] = {}
        avals = [(k, tuple(v.shape), str(v.dtype))
                 for k, v in sorted(self._params.items()) if k != "layers"]
        avals += [(i, k, tuple(v.shape), str(v.dtype))
                  for i, lp in enumerate(self._params["layers"])
                  for k, v in sorted(lp.items())]
        self._key_statics = (
            tuple(sorted(self.cfg.items())), self.slots, self.page_size,
            self.num_pages, self.max_pages, tuple(self.buckets),
            tuple(avals), self.device.type)

    # -- device work ---------------------------------------------------

    def _generator(self, seed) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return gen

    @torch.no_grad()
    def _prefill_fn(self, tokens, length, page_ids, seed, temp):
        """One padded prompt (1, S) → KV pages written, first token.
        S is the bucket (multiple of page_size); ``page_ids``
        (S // page_size,) are the sequence's pages in position order. Pad
        positions write garbage K/V — masked by ``length`` until each slot
        is overwritten by a decode step."""
        from ..models.transformer import lm_prefill, sample_token

        cfg = self.cfg
        logits, k, v = lm_prefill(cfg, self._params, tokens)
        n = tokens.shape[1] // self.page_size

        def blocks(x):  # (L, 1, S, H, D) → (n, L, page, H, D)
            return x.squeeze(1).reshape(
                cfg["layers"], n, self.page_size, cfg["heads"],
                cfg["head_dim"]).transpose(0, 1)

        self.kv[page_ids, :, 0] = blocks(k)
        self.kv[page_ids, :, 1] = blocks(v)
        last = logits[0, int(length) - 1]
        return sample_token(last[None], self._generator(seed), temp)[0]

    @torch.no_grad()
    def _step_fn(self, tokens, positions, page_tables, lengths, seed, temps):
        """One token for every slot. tokens/positions/lengths (B,),
        page_tables (B, max_pages). Inactive slots carry length 0 and a
        scratch page table — their writes land on the scratch page and
        their outputs are garbage the host discards."""
        from ..models.transformer import (_dense, _ln, decode_layer,
                                          embed_ids, sample_token)
        from ..ops.flash_attention import decode_attention

        cfg, params, kv = self.cfg, self._params, self.kv
        rows = torch.arange(self.slots, device=self.device)
        pos = positions.long()
        pids = page_tables[rows, pos // self.page_size].long()
        offs = pos % self.page_size
        x = (params["embed"][embed_ids(tokens, cfg["vocab"])]
             + params["pos"][pos])
        for i, lp in enumerate(params["layers"]):
            def attend(q, k_new, v_new, _i=i):
                kv[pids, _i, 0, offs] = k_new
                kv[pids, _i, 1, offs] = v_new
                return decode_attention(q, kv[:, _i, 0], kv[:, _i, 1],
                                        page_tables, lengths)

            x, _, _ = decode_layer(cfg, lp, x, attend)
        x = _ln(x, params["final_g"], params["final_b"])
        logits = _dense(x, params["dec_w"], params["dec_b"])
        return sample_token(logits, self._generator(seed), temps)

    def _program_key(self, sig, label: str):
        pk = self._sig_key.get(sig)
        if pk is None:
            pk = _progcache.program_key("decode", label,
                                        (self._key_statics, sig))
            self._sig_key[sig] = pk
        return pk

    def _lookup(self, entry, sig, label: str):
        """A first run's cache lookup: on a hit the entry becomes a
        ``cache_hit`` with the stored cost, and the program's kernels load
        from their entries. Returns (key, hit Program); (None, None)
        without a cache."""
        if self._progcache is None:
            return None, None
        pk = self._program_key(sig, label)
        entry["program_key"] = pk.digest
        hit = _progcache.load_program(self._progcache, pk, self.device)
        if hit is None:
            return pk, None
        entry["cache_hit"] = True
        cost = obs.device.adopt_cached_cost(pk, hit.cost)
        if cost:
            entry.update(cost)
            self._sig_cost[sig] = cost
        with self._stat_lock:
            self.cache_hits += 1
        return pk, hit

    def _execute(self, kind: str, label: str, fn, args):
        """Run one call with shape accounting: a ``compile_log`` entry the
        first time a signature runs (counted by the device plane when it
        is active). Host arrays go to the device before any of the call's
        work is queued; the sampled token(s) come back — the call's one
        wait on device work."""
        sig = (kind,) + tuple(
            (tuple(np.shape(a)), str(np.asarray(a).dtype)) for a in args)
        rec = obs.enabled()
        t0 = time.monotonic()
        entry = None
        with self._stat_lock:
            if sig not in self._programs:
                self._programs[sig] = 0
                entry = {"sig": sig, "kind": kind, "label": label,
                         "cache_hit": False}
                self.compile_log.append(entry)
        pk = hit = None
        if entry is not None:
            pk, hit = self._lookup(entry, sig, label)
        fresh = entry is not None and hit is None
        with obs.trace.span("decode.execute", kind=kind, label=label,
                            compile=entry is not None,
                            cache_hit=hit is not None) as sp:
            dev = tuple(torch.from_numpy(np.ascontiguousarray(a))
                        .to(self.device)
                        if isinstance(a, np.ndarray) else a for a in args)
            if fresh:
                toks = self._fresh_run(entry, sig, label, fn, dev, pk)
            else:
                toks = fn(*dev)
            # the step's tokens are the wire payload: this read is the one
            # accounted sync of the decode hot path
            if toks.is_cuda:
                copytrack.TRACKER.host_sync("serve.decode.tokens")
            host = toks.cpu().numpy()
            cost = self._sig_cost.get(sig) if rec else None
            if cost:  # after the host read: the span covers the work
                self._annotate(sp, kind, args, cost,
                               None if entry is not None
                               else time.monotonic() - t0)
        if rec:
            dt = time.monotonic() - t0
            if fresh:
                obs.inc("decode.compile")
                obs.observe("decode.compile_seconds", dt)
            elif hit is not None:
                obs.inc("decode.cache_hit")
                obs.observe("decode.deserialize_seconds", dt)
            else:
                obs.observe("decode.execute_seconds", dt)
            obs.device.sample()  # the live-memory counter lane, per call
        with self._stat_lock:
            self._programs[sig] += 1
            self.exec_count += 1
        return host

    def _fresh_run(self, entry, sig, label, fn, dev, pk):
        """A signature's first run without a cache hit: counted by the
        device plane when it is active and, with a cache, written with
        the kernels it launched."""
        from ..ops import _kernels

        cost = None
        with _kernels.recording() as launched:
            if obs.device.active():
                toks, cost = obs.device.capture(
                    fn, dev, site="decode", label=label, device=self.device,
                    arg_tensors=(self._params, self.kv, dev), key=pk)
                entry.update(cost)
                self._sig_cost[sig] = cost
            else:
                toks = fn(*dev)
        if pk is not None:
            _progcache.store_program(self._progcache, pk, cost, launched,
                                     self.device, meta={"kind": sig[0]})
        return toks

    def _annotate(self, sp, kind, args, cost, seconds) -> None:
        """Fold this call's cost into its span: the record's, and for a
        step the paged kernel's share recomputed from this step's lengths
        (the host's copy: no device read)."""
        if not isinstance(sp, obs.trace._Span):
            return
        from ..ops.flash_attention import paged_decode_cost

        attrs = {"flops": cost.get("flops", 0),
                 "bytes_accessed": cost.get("bytes_accessed", 0)}
        share = (cost.get("kernels") or {}).get("paged_decode_attention")
        if kind == "step" and share is not None:
            lengths = [int(n) for n in np.asarray(args[3]).reshape(-1)]
            cfg = self.cfg
            f1, b1 = paged_decode_cost(lengths, self.page_size, cfg["heads"],
                                       cfg["head_dim"],
                                       self.kv.element_size())
            calls = share["calls"]
            attrs.update(
                flops=attrs["flops"] - share["flops"] + calls * f1,
                bytes_accessed=(attrs["bytes_accessed"]
                                - share["bytes_accessed"] + calls * b1),
                paged_flops=calls * f1, paged_bytes=calls * b1,
                attended=sum(lengths),
                pages=sum(-(-n // self.page_size) for n in lengths))
        step_cost = dict(cost, flops=attrs["flops"],
                         bytes_accessed=attrs["bytes_accessed"])
        rl = obs.device.roofline_class(step_cost)
        if rl:
            attrs["roofline"] = rl["bound"]
        sp.attrs = dict(sp.attrs or {}, **attrs)
        if seconds is not None:
            obs.device.annotate_span(sp, "decode.execute", seconds,
                                     step_cost)

    # -- host-facing calls ---------------------------------------------

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if b >= prompt_len:
                return b
        raise RequestRejected(
            f"prompt length {prompt_len} exceeds max bucket "
            f"{self.buckets[-1]}")

    def prefill(self, tokens: np.ndarray, page_ids: List[int], *,
                temperature: float = 0.0, seed: int = 0) -> int:
        """Prefill one prompt into its pages; returns the first sampled
        token. ``tokens`` is the unpadded 1-D prompt; ``page_ids`` must
        cover its bucket (``bucket_for(len) // page_size`` pages)."""
        tokens = np.asarray(tokens, np.uint32).astype(np.int32)
        n = int(tokens.shape[0])
        bucket = self.bucket_for(n)
        if len(page_ids) != bucket // self.page_size:
            raise ServeError(
                f"prefill needs {bucket // self.page_size} pages for "
                f"bucket {bucket}, got {len(page_ids)}")
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = tokens
        out = self._execute(
            "prefill", f"prefill{bucket}", self._prefill_fn,
            (padded, np.int32(n), np.asarray(page_ids, np.int64),
             np.uint32(seed), np.float32(temperature)))
        return int(out)

    def step(self, tokens, positions, page_tables, lengths, temps, *,
             seed: int = 0) -> np.ndarray:
        """One continuous-batch decode step; returns (slots,) int32
        sampled tokens (garbage at inactive rows, i.e. lengths == 0)."""
        return self._execute(
            "step", "step", self._step_fn,
            (np.asarray(tokens, np.int32), np.asarray(positions, np.int32),
             np.asarray(page_tables, np.int32),
             np.asarray(lengths, np.int32), np.uint32(seed),
             np.asarray(temps, np.float32)))

    def warmup(self) -> int:
        """Run every prefill bucket plus the step shape once before
        traffic (writing only the reserved scratch page). Returns the
        number of signatures seen for the first time."""
        before = sum(1 for e in self.compile_log if not e["cache_hit"])
        scratch_tables = np.full((self.slots, self.max_pages), SCRATCH_PAGE,
                                 np.int32)
        for b in self.buckets:
            self.prefill(np.zeros((b,), np.int32),
                         [SCRATCH_PAGE] * (b // self.page_size))
        self.step(np.zeros((self.slots,), np.int32),
                  np.zeros((self.slots,), np.int32), scratch_tables,
                  np.zeros((self.slots,), np.int32),
                  np.zeros((self.slots,), np.float32))
        return sum(1 for e in self.compile_log if not e["cache_hit"]) - before

    def stats(self) -> dict:
        with self._stat_lock:
            out = {
                "slots": self.slots,
                "page_size": self.page_size,
                "buckets": list(self.buckets),
                "num_programs": len(self._programs),
                "executions": self.exec_count,
                "compiles": len(self.compile_log),
                "cache_hits": self.cache_hits,
                "programs": {repr(k): v for k, v in self._programs.items()},
            }
        out["pool"] = self.pool.stats()
        if self._progcache is not None:
            out["progcache"] = dict(self._progcache.stats,
                                    dir=self._progcache.root)
        return out


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------


class StreamHandle:
    """Client half of one generation: a bounded event queue the scheduler
    feeds and ``generate`` drains. Events: ("token", tok, index),
    ("end", reason, n_tokens), ("error", exc). The queue is sized so the
    scheduler can always emit a full generation without blocking —
    backpressure past that cancels the stream instead of stalling the
    shared decode batch."""

    def __init__(self, capacity: int):
        self._q: "queue.Queue" = queue.Queue(maxsize=capacity)
        self._cancelled = threading.Event()

    def cancel(self) -> None:
        """Ask the scheduler to retire this generation at the next step
        boundary (its pages are reclaimed there)."""
        self._cancelled.set()

    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def _emit(self, ev) -> bool:
        try:
            self._q.put_nowait(ev)
            return True
        except queue.Full:
            return False

    def get(self, timeout: float):
        return self._q.get(timeout=timeout)


class _Gen:
    """One generation's scheduler-side state."""

    __slots__ = ("seq", "tokens", "prompt_len", "max_new", "deadline",
                 "priority", "temperature", "ctx", "handle", "produced",
                 "last_token", "t_submit", "t_admit", "seed")

    def __init__(self, seq, tokens, max_new, deadline, priority,
                 temperature, handle, seed):
        self.seq = seq
        self.tokens = tokens
        self.prompt_len = int(tokens.shape[0])
        self.max_new = max_new
        self.deadline = deadline
        self.priority = priority
        self.temperature = temperature
        self.ctx = obs_context.current()
        self.handle = handle
        self.produced = 0
        self.last_token = -1
        self.t_submit = time.monotonic()
        self.t_admit = 0.0
        self.seed = seed


class DecodeScheduler:
    """Token-level continuous batching over a :class:`DecodeEngine`.

    A single scheduler thread owns the engine (and makes the engine's
    device current in that thread): each loop iteration is one ``step()``
    — admit queued requests into free slots (prefill at the step
    boundary), run ONE decode step over every active slot, distribute the
    sampled tokens, retire finished/cancelled/expired generations and free
    their pages.
    """

    def __init__(self, engine: DecodeEngine, *, max_queue: int = 64,
                 lanes: int = 2, default_timeout: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 max_new_tokens: Optional[int] = None):
        self.engine = engine
        self.max_queue = int(max_queue)
        self.default_timeout = float(
            default_timeout if default_timeout is not None
            else env_float("MXNET_DECODE_TIMEOUT", 30.0))
        self.eos_id = eos_id
        self.max_new_tokens = int(
            max_new_tokens if max_new_tokens is not None
            else env_int("MXNET_DECODE_MAX_NEW", 64))
        self._cv = tsan.condition("serve.decode.cv")
        self._lanes: List[List[_Gen]] = [[] for _ in range(int(lanes))]
        self._slots: List[Optional[_Gen]] = [None] * engine.slots
        self._running = True
        self._draining = False
        self._seq = 0
        # shed discipline: self.shed == sum(shed_by_reason.values())
        self.shed = 0
        self.shed_by_reason = {"queue_full": 0, "deadline": 0,
                               "draining": 0, "pages": 0,
                               "backpressure": 0}
        self.submitted = 0
        self.completed = 0
        self.cancelled = 0
        self.steps = 0
        self.tokens_out = 0
        self._occupancy = 0.0
        self.stopped_clean = True
        self._died: Optional[BaseException] = None  # why the loop ended
        self._thread = threading.Thread(target=self._loop,
                                        name="mxnet-decode-sched",
                                        daemon=True)
        self._thread.start()

    # -- admission ------------------------------------------------------

    def _qsize(self) -> int:
        return sum(len(l) for l in self._lanes)

    def _active(self) -> int:
        return sum(1 for g in self._slots if g is not None)

    def _shed(self, why: str, exc: ServeError):
        self.shed += 1
        self.shed_by_reason[why] += 1
        obs.inc(f"decode.shed_{why}")
        obs.tail.note(shed=why)
        raise exc

    def submit(self, tokens, *, max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None, priority: int = 1,
               temperature: float = 0.0,
               seed: int = 0) -> StreamHandle:
        """Queue one generation; returns its :class:`StreamHandle`.
        Sheds synchronously when the queue is over watermark, the
        scheduler drains, or the deadline is already dead on arrival."""
        arr = np.ascontiguousarray(np.asarray(tokens, np.int64)
                                   .astype(np.int32)).reshape(-1)
        if arr.shape[0] < 1:
            raise RequestRejected("empty prompt")
        self.engine.bucket_for(arr.shape[0])  # rejects over-long prompts
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.max_new_tokens)
        max_new = max(1, min(max_new, self.engine.max_length
                             - arr.shape[0]))
        deadline = (time.monotonic() + deadline_ms / 1000.0
                    if deadline_ms is not None else None)
        lane = max(0, min(int(priority), len(self._lanes) - 1))
        handle = StreamHandle(capacity=max_new + 2)
        with self._cv:
            if self._died is not None:
                raise ServeError(f"decode scheduler died: {self._died!r}") \
                    from self._died
            if not self._running or self._draining:
                self._shed("draining", Draining("decode scheduler draining"))
            if self._qsize() >= self.max_queue:
                self._shed("queue_full", RequestRejected(
                    f"decode queue over watermark ({self.max_queue})"))
            if deadline is not None and time.monotonic() >= deadline:
                self._shed("deadline", DeadlineExceeded(
                    "deadline expired before admission"))
            self._seq += 1
            g = _Gen(self._seq, arr, max_new, deadline, lane, temperature,
                     handle, seed)
            self._lanes[lane].append(g)
            self.submitted += 1
            depth = self._qsize()
            self._cv.notify_all()
        obs.set_gauge("decode.queue_depth", depth)
        return handle

    def generate(self, tokens, *, max_new_tokens: Optional[int] = None,
                 deadline_ms: Optional[float] = None, priority: int = 1,
                 temperature: float = 0.0, seed: int = 0):
        """Yield tokens as the scheduler produces them. Closing the
        generator mid-stream cancels the generation — its KV pages are
        reclaimed at the next step boundary. Raises the typed errors
        (RequestRejected / DeadlineExceeded / Draining) — possibly
        mid-stream."""
        h = self.submit(tokens, max_new_tokens=max_new_tokens,
                        deadline_ms=deadline_ms, priority=priority,
                        temperature=temperature, seed=seed)
        budget = (deadline_ms / 1000.0 + 5.0 if deadline_ms is not None
                  else self.default_timeout)
        t_end = time.monotonic() + budget
        try:
            while True:
                try:
                    ev = h.get(timeout=max(0.01, t_end - time.monotonic()))
                except queue.Empty:
                    raise ServeError(
                        "decode stream stalled (scheduler wedged?)")
                if ev[0] == "token":
                    yield ev[1]
                elif ev[0] == "end":
                    return
                else:
                    raise ev[1]
        finally:
            h.cancel()
            with self._cv:
                self._cv.notify_all()

    # -- the scheduler loop --------------------------------------------

    def _loop(self):
        try:
            # the engine contract names no device: a duck-typed engine
            # without one runs in no device scope
            with _device_scope(getattr(self.engine, "device", None)):
                while True:
                    with self._cv:
                        while (self._running and self._qsize() == 0
                               and self._active() == 0):
                            self._cv.wait(1.0)
                        if not self._running:
                            return
                    self.step()
        except BaseException as e:
            # a dead loop refuses later submissions, naming why
            with self._cv:
                self._died = e
                self._running = False
            raise
        finally:
            # whatever ends this thread, nothing may keep pages: retire
            # every resident generation and flush the queue
            self._abort_all(ServeError(
                "decode scheduler stopped" if self._died is None
                else f"decode scheduler died: {self._died!r}"))

    def step(self) -> int:
        """One continuous-batch step: admit → decode → distribute →
        retire. Returns the number of tokens produced."""
        now = time.monotonic()
        joined = self._admit(now)
        active = [(i, g) for i, g in enumerate(self._slots)
                  if g is not None]
        if not active:
            return 0
        eng = self.engine
        tokens = np.zeros((eng.slots,), np.int32)
        positions = np.zeros((eng.slots,), np.int32)
        lengths = np.zeros((eng.slots,), np.int32)
        temps = np.zeros((eng.slots,), np.float32)
        tables = np.full((eng.slots, eng.max_pages), SCRATCH_PAGE,
                         np.int32)
        stepping = []
        for i, g in active:
            pos = g.prompt_len + g.produced - 1
            try:
                table = self._ensure_pages(g, pos)
            except PagesExhausted as e:
                # shedding a RUNNING stream, not a queued one: freeing its
                # pages is what lets the rest of the batch keep stepping
                self.shed += 1
                self.shed_by_reason["pages"] += 1
                obs.inc("decode.shed_pages")
                self._retire(i, g, "pages", error=e)
                continue
            tokens[i] = g.last_token
            positions[i] = pos
            lengths[i] = pos + 1
            temps[i] = g.temperature
            tables[i, :len(table)] = table
            stepping.append((i, g))
        if not stepping:
            return 0
        t0 = time.monotonic()
        out = eng.step(tokens, positions, tables, lengths, temps,
                       seed=self._step_seed())
        dt = time.monotonic() - t0
        left = 0
        now = time.monotonic()
        for i, g in stepping:
            tok = int(out[i])
            g.last_token = tok
            g.produced += 1
            self.tokens_out += 1
            obs.observe("decode.token_seconds", dt)
            if g.ctx is not None and g.ctx.sampled:
                obs.trace.complete("decode.token", t0, dt, ctx=g.ctx,
                                   index=g.produced, slot=i)
            if not g.handle._emit(("token", tok, g.produced)):
                self._retire(i, g, "backpressure", error=RequestRejected(
                    "stream consumer too slow (token buffer full)"))
                left += 1
                continue
            if self._done(g, tok, now):
                left += 1
        self.steps += 1
        occ = len(stepping) / eng.slots
        self._occupancy = (occ if self.steps == 1
                           else 0.7 * self._occupancy + 0.3 * occ)
        obs.set_gauge("decode.occupancy", self._occupancy)
        obs.trace.complete("decode.step", t0, dt, active=len(stepping),
                           joined=joined, left=left)
        return len(stepping)

    def _step_seed(self) -> int:
        # deterministic per step-count: replays reproduce token-for-token
        return (self.steps * 1000003 + 12345) & 0x7FFFFFFF

    def _admit(self, now: float) -> int:
        """Move queued generations into free slots (prefill at the step
        boundary). Page exhaustion leaves the request queued."""
        admitted = []
        with self._cv:
            free = [i for i, g in enumerate(self._slots) if g is None]
            for lane in self._lanes:
                while lane and free:
                    g = lane[0]
                    if g.handle.cancelled():
                        lane.pop(0)
                        self.cancelled += 1
                        g.handle._emit(("end", "cancelled", 0))
                        continue
                    if g.deadline is not None and now >= g.deadline:
                        lane.pop(0)
                        self.shed += 1
                        self.shed_by_reason["deadline"] += 1
                        obs.inc("decode.shed_deadline")
                        g.handle._emit(("error", DeadlineExceeded(
                            "deadline expired in decode queue")))
                        continue
                    bucket = self.engine.bucket_for(g.prompt_len)
                    try:
                        self.engine.pool.alloc(
                            g.seq, bucket // self.engine.page_size)
                    except PagesExhausted:
                        # stays queued: pages free as running streams end
                        free = []
                        break
                    lane.pop(0)
                    slot = free.pop(0)
                    self._slots[slot] = g
                    admitted.append(g)
        for g in admitted:
            g.t_admit = time.monotonic()
            obs.trace.complete("decode.queue_wait", g.t_submit,
                               g.t_admit - g.t_submit, ctx=g.ctx,
                               priority=g.priority)
            with obs_context.use(g.ctx):  # the prefill joins the trace
                tok = self.engine.prefill(
                    g.tokens, self.engine.pool.table(g.seq),
                    temperature=g.temperature, seed=g.seed)
            g.last_token = tok
            g.produced = 1
            self.tokens_out += 1
            if not g.handle._emit(("token", tok, 1)):
                idx = self._slots.index(g)
                self._retire(idx, g, "backpressure",
                             error=RequestRejected(
                                 "stream consumer too slow"))
                continue
            self._done(g, tok, time.monotonic())
        return len(admitted)

    def _ensure_pages(self, g: _Gen, pos: int) -> List[int]:
        """Grow ``g``'s page table to cover position ``pos`` (at most one
        page per step — step granularity by construction)."""
        pool = self.engine.pool
        table = pool.table(g.seq)
        while len(table) * pool.page_size <= pos:
            pool.alloc(g.seq, 1)
            table = pool.table(g.seq)
        return table

    def _done(self, g: _Gen, tok: int, now: float) -> bool:
        """Post-token retirement checks, in precedence order."""
        idx = self._slots.index(g)
        if self.eos_id is not None and tok == self.eos_id:
            self._retire(idx, g, "eos")
            return True
        if g.produced >= g.max_new:
            self._retire(idx, g, "length")
            return True
        if g.prompt_len + g.produced >= self.engine.max_length:
            self._retire(idx, g, "overflow")
            return True
        if g.deadline is not None and now >= g.deadline:
            self.shed_by_reason["deadline"] += 1
            self.shed += 1
            obs.inc("decode.shed_deadline")
            self._retire(idx, g, "deadline", error=DeadlineExceeded(
                f"deadline expired after {g.produced} tokens"))
            return True
        if g.handle.cancelled():
            self._retire(idx, g, "cancelled")
            return True
        return False

    def _retire(self, slot: int, g: _Gen, reason: str,
                error: Optional[ServeError] = None):
        """Leave the batch: free pages, emit the terminal event. EVERY
        exit path funnels here — the page-leak guarantee lives in this one
        place."""
        self._slots[slot] = None
        self.engine.pool.free(g.seq)
        if reason == "cancelled":
            self.cancelled += 1
        else:
            self.completed += 1
        if error is not None:
            g.handle._emit(("error", error))
        else:
            g.handle._emit(("end", reason, g.produced))
        obs.inc("decode.finished")
        obs.trace.complete(
            "decode.generate", g.t_admit or g.t_submit,
            time.monotonic() - (g.t_admit or g.t_submit), ctx=g.ctx,
            tokens=g.produced, outcome=reason)
        with self._cv:
            self._cv.notify_all()

    def _abort_all(self, exc: ServeError):
        with self._cv:
            queued = [g for lane in self._lanes for g in lane]
            for lane in self._lanes:
                del lane[:]
        for i, g in enumerate(list(self._slots)):
            if g is not None:
                self._retire(i, g, "aborted", error=exc)
        for g in queued:
            g.handle._emit(("error", exc))

    # -- lifecycle ------------------------------------------------------

    def drain(self, timeout: float = 30.0) -> bool:
        """Refuse new work, let running generations finish. True when
        queue and batch emptied within ``timeout``."""
        deadline = time.monotonic() + timeout
        with self._cv:
            self._draining = True
            self._cv.notify_all()
            while self._qsize() or self._active():
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return False
                self._cv.wait(min(rem, 0.1))
        return True

    def close(self, timeout: float = 5.0):
        """Stop the scheduler thread; resident generations get a
        structured abort and their pages are reclaimed."""
        with self._cv:
            if not self._running:
                return
            self._running = False
            self._draining = True
            self._cv.notify_all()
        self._thread.join(timeout)
        if self._thread.is_alive():
            self.stopped_clean = False
            obs.inc("decode.scheduler_thread_leaked")

    def ready(self) -> bool:
        return self._running and not self._draining

    @property
    def version(self) -> int:
        return 0

    def stats(self) -> dict:
        with self._cv:
            out = {
                "submitted": self.submitted,
                "completed": self.completed,
                "cancelled": self.cancelled,
                "shed": self.shed,
                "shed_by_reason": dict(self.shed_by_reason),
                "steps": self.steps,
                "tokens_out": self.tokens_out,
                "queued": self._qsize(),
                "active": self._active(),
                "occupancy": self._occupancy,
                "draining": self._draining,
            }
        out["engine"] = self.engine.stats()
        return out
