"""Paged KV-cache accounting — the host half of the decode engine.

Counterpart of ``mxnet_tpu/serve/kvcache.py``, ported one to one: this is
host-only code. The device KV pool is ONE fixed tensor
``(pages, layers, 2, page_size, heads, head_dim)`` allocated by
``serve/decode.py``; growth is a page-table edit here, never a new shape.

- every page is owned by exactly one sequence or the free list — a double
  free or a free of a foreign page raises :class:`PageLeakError`;
- ``used()`` returning to its baseline after every finish/cancel/deadline
  is the no-leak proof (``assert_baseline``);
- page 0 is reserved scratch: inactive decode slots point their page
  tables at it, so the decode step always has a legal write target and a
  masked-out read target. It is never handed out.

A pool of ``P`` pages of ``page_size`` positions serves at most
``(P - 1) * page_size`` live KV positions across all generations.
"""
from __future__ import annotations

from typing import Dict, List

from .. import obs, tsan
from .engine import RequestRejected, ServeError

__all__ = ["PagePool", "PageLeakError", "PagesExhausted", "pages_for",
           "SCRATCH_PAGE"]

# page 0: the decode step's write/read target for inactive slots
SCRATCH_PAGE = 0


class PageLeakError(ServeError):
    """Page accounting corruption: double free, foreign free, or pages
    still owned at a point the caller asserted must be baseline."""


class PagesExhausted(RequestRejected):
    """The fixed page pool has no free page — shed semantics (429): the
    caller backs off or the scheduler sheds the newest generation."""


def pages_for(n_positions: int, page_size: int) -> int:
    """Pages needed to hold ``n_positions`` KV entries (ceil division)."""
    if n_positions <= 0:
        return 0
    return -(-int(n_positions) // int(page_size))


class PagePool:
    """Fixed pool of KV pages with per-sequence page tables.

    Allocation is at step granularity: a generation takes the pages its
    padded prompt needs at admission, then one page at a time as its
    position crosses a page boundary.
    """

    def __init__(self, num_pages: int, page_size: int):
        num_pages = int(num_pages)
        page_size = int(page_size)
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved scratch)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        self._lock = tsan.lock("serve.kvcache.pool")
        # LIFO free list (page 0 excluded): reusing the most recently freed
        # page keeps the device pool's working set compact
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._tables: Dict[object, List[int]] = {}
        self.alloc_count = 0
        self.free_count = 0
        self.exhausted = 0
        self._peak = 0

    def capacity(self) -> int:
        """Allocatable pages (scratch excluded)."""
        return self.num_pages - 1

    def used(self) -> int:
        with self._lock:
            return self.capacity() - len(self._free)

    def available(self) -> int:
        with self._lock:
            return len(self._free)

    def table(self, seq) -> List[int]:
        """A copy of ``seq``'s page table, in position order."""
        with self._lock:
            t = self._tables.get(seq)
            if t is None:
                raise PageLeakError(f"unknown sequence {seq!r}")
            return list(t)

    def sequences(self) -> int:
        with self._lock:
            return len(self._tables)

    def alloc(self, seq, n: int = 1) -> List[int]:
        """Append ``n`` pages to ``seq``'s table (created on first alloc).
        All-or-nothing: raises :class:`PagesExhausted` without taking any
        page when fewer than ``n`` are free."""
        n = int(n)
        if n < 0:
            raise ValueError("n must be >= 0")
        with self._lock:
            if len(self._free) < n:
                self.exhausted += 1
                obs.inc("decode.pages_exhausted")
                raise PagesExhausted(
                    f"kv page pool exhausted ({len(self._free)} free, "
                    f"{n} requested of {self.capacity()})")
            pages = [self._free.pop() for _ in range(n)]
            self._tables.setdefault(seq, []).extend(pages)
            self.alloc_count += n
            used = self.capacity() - len(self._free)
            self._peak = max(self._peak, used)
        obs.set_gauge("decode.kv_pages_used", used)
        return pages

    def free(self, seq) -> int:
        """Return ALL of ``seq``'s pages to the free list (finish, cancel,
        deadline and abort all funnel here). Returns the page count; raises
        :class:`PageLeakError` for an unknown sequence (a double free is
        accounting corruption, not a no-op)."""
        with self._lock:
            pages = self._tables.pop(seq, None)
            if pages is None:
                raise PageLeakError(
                    f"free of unknown sequence {seq!r} (double free?)")
            for p in pages:
                if p == SCRATCH_PAGE or p >= self.num_pages:
                    raise PageLeakError(
                        f"sequence {seq!r} table held illegal page {p}")
            self._free.extend(reversed(pages))
            self.free_count += len(pages)
            used = self.capacity() - len(self._free)
        obs.set_gauge("decode.kv_pages_used", used)
        return len(pages)

    def assert_baseline(self, baseline: int = 0) -> None:
        """Raise :class:`PageLeakError` unless ``used() == baseline``."""
        used = self.used()
        if used != baseline:
            with self._lock:
                owners = {repr(k): len(v) for k, v in self._tables.items()}
            raise PageLeakError(
                f"kv page leak: {used} pages still owned "
                f"(baseline {baseline}); owners: {owners}")

    def stats(self) -> dict:
        with self._lock:
            return {"num_pages": self.num_pages,
                    "page_size": self.page_size,
                    "used": self.capacity() - len(self._free),
                    "free": len(self._free),
                    "peak_used": self._peak,
                    "sequences": len(self._tables),
                    "allocs": self.alloc_count,
                    "frees": self.free_count,
                    "exhausted": self.exhausted}
