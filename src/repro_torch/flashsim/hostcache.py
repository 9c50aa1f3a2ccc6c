"""Host-side write-back cache for the closed-loop frontend.

:class:`WriteCache` models the controller DRAM write buffer a real host
sees in front of the flash array: incoming writes that fit are *absorbed*
(the request completes at DRAM speed), their page programs are parked in
an eviction-ordered dirty list, and a watermark policy later *flushes*
them to the device, where they enter the ordinary scheduler/GC machinery
as low-priority programs.  Reads that hit a dirty (or still-flushing)
line are served from the cache without touching flash.

Flush (eviction) order is a policy knob
(:attr:`~repro_torch.flashsim.config.HostCacheConfig.eviction`): ``"fifo"``
pops entries in absorption order; ``"lru"`` pops the least-recently-used
entry — read hits (:meth:`WriteCache.touch`) refresh the dirty entries
holding the line, so hot write-then-read lines stay cached longer.  The
policy only permutes *when* each program is issued, never how many:
flush traffic, occupancy accounting, and WA are identical under both.

The class is engine-agnostic and fully synchronous — the event loop in
:mod:`repro_torch.flashsim.engine` drives it and decides *when* pops/completions
happen; this module only owns the bookkeeping contract:

* **Occupancy** counts every absorbed page program from ``absorb()``
  until ``page_durable()`` — dirty *and* in-flight-flush pages both hold
  capacity, so backpressure is honest.
* **Read-after-write**: ``version(lpn)`` always returns the newest
  version in stream order (cached if any copy is resident, else the
  durable one).  Per-page version counters make the durable map
  *landing-order independent* — ``page_durable()`` only advances a line
  to a newer version — so LRU's recency-permuted flush order (which can
  land two programs of one LPN out of stream order) still drains to the
  same durable state as a synchronous replay of the write stream.
* **No coalescing**: re-writing a cached LPN appends a new entry (a new
  program will be issued) rather than merging — each absorbed page-op
  occupies its own slot until it lands, which keeps flush traffic equal
  to absorbed traffic and the capacity accounting trivially auditable.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.flashsim.config import HostCacheConfig

__all__ = ["CacheEntry", "WriteCache"]


@dataclasses.dataclass(frozen=True)
class CacheEntry:
    """One absorbed write: its page LPNs, their versions, and an opaque
    payload the engine uses to find the deferred device ops."""

    lpns: Tuple[int, ...]
    versions: Tuple[int, ...]
    payload: Any = None


class WriteCache:
    """Page-granular write-back cache with a configurable flush order
    (``fifo`` / ``lru``) and high/low watermarks (see
    :class:`~repro_torch.flashsim.config.HostCacheConfig`)."""

    def __init__(self, cfg: HostCacheConfig):
        self.cfg = cfg
        self.capacity = cfg.capacity_pages
        self.high_mark = cfg.flush_high * cfg.capacity_pages
        self.low_mark = cfg.flush_low * cfg.capacity_pages
        self.lru = cfg.eviction == "lru"
        #: absorbed-but-not-issued page programs
        self.dirty_pages = 0
        #: issued-but-not-durable page programs
        self.flushing_pages = 0
        # Dirty entries in eviction order (head = next to flush).  With
        # no touches this is exactly absorption order, so one structure
        # serves both policies; touch() re-ranks under lru only.
        self._dirty: "OrderedDict[int, CacheEntry]" = OrderedDict()
        self._next_eid = 0
        #: lpn -> ids of dirty entries holding a copy (touch/pop upkeep)
        self._dirty_eids: Dict[int, List[int]] = {}
        #: lpn -> number of resident (dirty or flushing) copies
        self._resident: Dict[int, int] = {}
        #: lpn -> newest absorbed version (monotone per lpn)
        self._latest: Dict[int, int] = {}
        #: lpn -> newest version that has landed on flash
        self.durable: Dict[int, int] = {}
        self._next_version = 1
        # counters (engine copies these into SimStats)
        self.absorbed_writes = 0
        self.absorbed_pages = 0
        self.hit_pages = 0
        self.flush_pages = 0

    # -- occupancy ---------------------------------------------------------

    @property
    def pending_pages(self) -> int:
        """Pages currently holding capacity (dirty + flushing)."""
        return self.dirty_pages + self.flushing_pages

    def fits(self, n_pages: int) -> bool:
        """Could a write of ``n_pages`` EVER be absorbed?  False means the
        caller must fall back to write-through."""
        return n_pages <= self.capacity

    def can_absorb(self, n_pages: int) -> bool:
        return self.pending_pages + n_pages <= self.capacity

    # -- write path --------------------------------------------------------

    def absorb(self, lpns: Sequence[int], payload: Any = None) -> CacheEntry:
        """Absorb one write (its pages become dirty).  Caller must have
        checked :meth:`can_absorb`."""
        if not self.can_absorb(len(lpns)):
            raise RuntimeError("absorb() without capacity — caller bug")
        versions = []
        for lpn in lpns:
            v = self._next_version
            self._next_version += 1
            self._latest[lpn] = v
            self._resident[lpn] = self._resident.get(lpn, 0) + 1
            versions.append(v)
        entry = CacheEntry(tuple(lpns), tuple(versions), payload)
        eid = self._next_eid
        self._next_eid += 1
        self._dirty[eid] = entry            # appended at the MRU end
        for lpn in set(lpns):
            self._dirty_eids.setdefault(lpn, []).append(eid)
        self.dirty_pages += len(lpns)
        self.absorbed_writes += 1
        self.absorbed_pages += len(lpns)
        return entry

    # -- read path ---------------------------------------------------------

    def contains(self, lpn: int) -> bool:
        """Read hit: a dirty or flushing copy of ``lpn`` is resident."""
        return lpn in self._resident

    def version(self, lpn: int) -> Optional[int]:
        """Version a read admitted *now* observes: the newest resident
        copy if cached, else the durable copy (None if never written)."""
        if lpn in self._resident:
            return self._latest[lpn]
        return self.durable.get(lpn)

    def note_hit(self, n_pages: int = 1) -> None:
        self.hit_pages += n_pages

    def touch(self, lpn: int) -> None:
        """Record a read hit's recency: under ``lru``, every dirty entry
        holding ``lpn`` moves to the MRU end (kept in their relative
        order, so per-LPN flush order is preserved); a no-op under
        ``fifo`` and for lines that are flushing-only or absent."""
        if not self.lru:
            return
        for eid in self._dirty_eids.get(lpn, ()):
            self._dirty.move_to_end(eid)

    # -- flush policy ------------------------------------------------------

    def need_flush(self) -> bool:
        """High watermark crossed — start issuing flush entries."""
        return self.dirty_pages > self.high_mark

    def flushed_enough(self) -> bool:
        """Low watermark reached — stop issuing."""
        return self.dirty_pages <= self.low_mark

    def pop_entry(self) -> Optional[CacheEntry]:
        """Next dirty entry in eviction order (absorption order under
        ``fifo``, least-recently-used under ``lru``), moved
        dirty -> flushing; None when clean."""
        if not self._dirty:
            return None
        eid, entry = self._dirty.popitem(last=False)
        for lpn in set(entry.lpns):
            eids = self._dirty_eids[lpn]
            eids.remove(eid)
            if not eids:
                del self._dirty_eids[lpn]
        n = len(entry.lpns)
        self.dirty_pages -= n
        self.flushing_pages += n
        self.flush_pages += n
        return entry

    def drain(self) -> Iterator[CacheEntry]:
        """Pop every remaining dirty entry (end-of-trace drain)."""
        while self._dirty:
            yield self.pop_entry()

    def page_durable(self, lpn: int, version: int) -> None:
        """One flushed page program completed on the die: free its slot,
        update the durable map, evict the line if no newer copy exists."""
        self.flushing_pages -= 1
        if self.flushing_pages < 0:
            raise RuntimeError("page_durable() without a flush in flight")
        if version >= self.durable.get(lpn, -1):
            self.durable[lpn] = version
        rc = self._resident[lpn] - 1
        if rc:
            self._resident[lpn] = rc
        else:
            del self._resident[lpn]
            del self._latest[lpn]
