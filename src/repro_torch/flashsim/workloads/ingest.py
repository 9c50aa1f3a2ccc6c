"""Real-trace ingestion: MSR-Cambridge CSVs and blktrace text dumps.

Both loaders produce the standard :class:`RequestTrace` arrays at the
simulator's page granularity (``page_kib``, default 16 KiB — matching
``SSDConfig.page_kib``): byte offsets/sizes become the covered page
interval ``[offset // page, ceil((offset + size) / page))``, timestamps
become microseconds relative to the first record, and the file's record
order is preserved (the page-op expansion stable-sorts unsorted arrivals
itself).

**MSR-Cambridge** (`load_msr_csv`): the SNIA block-trace format —
7 CSV columns ``Timestamp,Hostname,DiskNumber,Type,Offset,Size,
ResponseTime`` with Windows FILETIME timestamps (100 ns ticks since
1601).  Values that are clearly not FILETIME (< 1e14) are read as
seconds, so pre-normalized excerpts load too.  Gzip is detected by
magic bytes, not filename.

**blktrace** (`load_blktrace_txt`): default ``blkparse`` text output —
``dev cpu seq time pid action rwbs sector + nsectors [proc]`` — keeping
one event class per request (``action="Q"``, the issue queue, by
default) and 512-byte sectors.

Raw ingested traces are *sparse*: a few hundred MB of touched pages
scattered across the volume's full LBA span.  Run them through
:class:`~repro_torch.flashsim.workloads.transforms.DenseRemap` (the registry
does this by default) before FTL-enabled simulation so auto-OP sizing
sees the footprint, not the span.
"""

from __future__ import annotations

import dataclasses
import gzip
import hashlib
import io
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.flashsim.workloads.base import RequestTrace, TraceSource

#: FILETIME tick values are ~1.2e17 for the MSR collection era; anything
#: this large cannot be seconds or microseconds since any epoch in use.
_FILETIME_THRESHOLD = 1e14

_SECTOR_BYTES = 512


def open_trace_file(path) -> io.TextIOBase:
    """Open a trace file for text reading, transparently ungzipping.

    Detection is by the gzip magic bytes (``1f 8b``), not the suffix, so
    both ``web_0.csv`` and ``web_0.csv.gz`` work under either name.
    """
    path = os.fspath(path)
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8")
    return open(path, "r", encoding="utf-8")


def _looks_numeric(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


def _pages_of(offset_bytes: int, size_bytes: int,
              page_bytes: int) -> Tuple[int, int]:
    """Byte extent -> (start_page, n_pages >= 1) covered page interval."""
    start = offset_bytes // page_bytes
    end = -((offset_bytes + max(size_bytes, 1)) // -page_bytes)  # ceil-div
    return start, max(end - start, 1)


def _finalize(arrival_us, rows_r: List[bool], rows_s: List[int],
              rows_n: List[int], what: str, path) -> RequestTrace:
    if len(arrival_us) == 0:
        raise ValueError(f"no parsable {what} records in {os.fspath(path)!r}")
    t = np.asarray(arrival_us, np.float64)
    t = t - float(t.min())
    return RequestTrace(
        arrival_us=t,
        is_read=np.asarray(rows_r, bool),
        n_pages=np.asarray(rows_n, np.int64),
        start_page=np.asarray(rows_s, np.int64),
    )


def load_msr_csv(path, page_kib: int = 16) -> RequestTrace:
    """Parse an MSR-Cambridge CSV (optionally gzipped) into a trace.

    Malformed rows (wrong field count, non-numeric offset/size, unknown
    Type) raise with the offending line number — a half-garbled file
    should fail loudly, not simulate quietly.  A single leading header
    line is tolerated and skipped.
    """
    page_bytes = page_kib * 1024
    rows_r: List[bool] = []
    rows_s: List[int] = []
    rows_n: List[int] = []
    raw_ts: List = []   # int (FILETIME ticks) or float (seconds)
    with open_trace_file(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            if len(parts) != 7:
                raise ValueError(
                    f"{os.fspath(path)!r}:{lineno}: expected 7 CSV fields "
                    f"(MSR-Cambridge format), got {len(parts)}"
                )
            ts_s, _host, _disk, typ, off_s, size_s, _resp = parts
            typ = typ.strip().lower()
            if typ in ("read", "r"):
                is_read = True
            elif typ in ("write", "w"):
                is_read = False
            elif lineno == 1 and not _looks_numeric(off_s):
                continue  # a real header line ("...,Offset,Size,...")
            else:
                # A malformed FIRST record must fail like any other —
                # only a genuinely non-numeric line 1 reads as a header.
                raise ValueError(
                    f"{os.fspath(path)!r}:{lineno}: unknown Type {typ!r} "
                    f"(expected Read/Write)"
                )
            try:
                # Timestamps parse as int when possible: FILETIME ticks
                # (~1.28e17) exceed float64's 2^53 exact-integer range
                # (ulp = 16 ticks = 1.6 us), so the rebase below must
                # happen in integer arithmetic to keep gaps exact.
                try:
                    ts = int(ts_s)
                except ValueError:
                    ts = float(ts_s)
                off = int(off_s)
                size = int(size_s)
            except ValueError as e:
                raise ValueError(
                    f"{os.fspath(path)!r}:{lineno}: non-numeric "
                    f"timestamp/offset/size: {e}"
                ) from None
            if off < 0 or size < 0:
                raise ValueError(
                    f"{os.fspath(path)!r}:{lineno}: negative offset/size"
                )
            start, n = _pages_of(off, size, page_bytes)
            raw_ts.append(ts)
            rows_r.append(is_read)
            rows_s.append(start)
            rows_n.append(n)
    if not raw_ts:
        raise ValueError(
            f"no parsable MSR records in {os.fspath(path)!r}"
        )
    if max(raw_ts) > _FILETIME_THRESHOLD:
        # FILETIME ticks -> us, rebased exactly while still integer
        t0 = min(raw_ts)
        arrival = np.array([t - t0 for t in raw_ts], np.float64) / 10.0
    else:
        arrival = np.asarray(raw_ts, np.float64) * 1e6   # seconds -> us
    return _finalize(arrival, rows_r, rows_s, rows_n, "MSR", path)


def load_blktrace_txt(path, page_kib: int = 16,
                      action: str = "Q") -> RequestTrace:
    """Parse default ``blkparse`` text output into a trace.

    Keeps lines whose action field equals ``action`` (default ``"Q"``,
    the request-queue event — one per host request) and whose RWBS field
    marks a data read or write; everything else (plugs, completions,
    non-matching events, the trailing summary) is skipped.  Sector
    arithmetic assumes 512-byte sectors.
    """
    page_bytes = page_kib * 1024
    rows_t: List[float] = []
    rows_r: List[bool] = []
    rows_s: List[int] = []
    rows_n: List[int] = []
    with open_trace_file(path) as f:
        for line in f:
            parts = line.split()
            # dev cpu seq time pid action rwbs sector + nsectors [proc]
            if len(parts) < 10 or parts[5] != action or parts[8] != "+":
                continue
            rwbs = parts[6]
            if "R" in rwbs and "W" not in rwbs:
                is_read = True
            elif "W" in rwbs:
                is_read = False
            else:
                continue  # barrier/discard/etc.
            try:
                t_us = float(parts[3]) * 1e6
                sector = int(parts[7])
                nsect = int(parts[9])
            except ValueError:
                continue  # summary/garbage line
            start, n = _pages_of(sector * _SECTOR_BYTES,
                                 nsect * _SECTOR_BYTES, page_bytes)
            rows_t.append(t_us)
            rows_r.append(is_read)
            rows_s.append(start)
            rows_n.append(n)
    return _finalize(rows_t, rows_r, rows_s, rows_n,
                     f"blktrace {action!r}", path)


_LOADERS = {"msr": load_msr_csv, "blktrace": load_blktrace_txt}

#: (path, size, mtime_ns) -> content sha256; avoids re-hashing the same
#: file for every cache_key probe while still catching edits.
_CONTENT_HASHES: Dict[Tuple[str, int, int], str] = {}


def file_content_hash(path) -> str:
    """SHA-256 of the file bytes (memoized per (path, size, mtime))."""
    p = os.fspath(path)
    st = os.stat(p)
    key = (p, st.st_size, st.st_mtime_ns)
    h = _CONTENT_HASHES.get(key)
    if h is None:
        digest = hashlib.sha256()
        with open(p, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                digest.update(chunk)
        h = digest.hexdigest()
        _CONTENT_HASHES[key] = h
    return h


@dataclasses.dataclass(frozen=True)
class FileSource(TraceSource):
    """A :class:`TraceSource` over one on-disk trace file.

    ``fmt`` selects the loader (``"msr"`` or ``"blktrace"``).  The cache
    key embeds the file's *content hash* (not its path), so a re-pointed
    symlink or edited excerpt can never serve a stale cached trace, and
    identical files under different paths share one build.
    """

    path: str
    fmt: str = "msr"
    page_kib: int = 16
    blktrace_action: str = "Q"
    transforms: Tuple = ()
    label: Optional[str] = None

    def __post_init__(self):
        if self.fmt not in _LOADERS:
            raise ValueError(
                f"unknown trace format {self.fmt!r} "
                f"(choose from {tuple(_LOADERS)})"
            )

    @property
    def name(self) -> str:
        return self.label or f"{self.fmt}:{Path(self.path).stem}"

    def _build(self, seed: int) -> RequestTrace:
        if self.fmt == "blktrace":
            return load_blktrace_txt(self.path, page_kib=self.page_kib,
                                     action=self.blktrace_action)
        return load_msr_csv(self.path, page_kib=self.page_kib)

    def cache_key(self, seed: int) -> tuple:
        # The seed only matters when a transform actually consumes RNG
        # (``seeded`` — e.g. Subsample); deterministic chains (the
        # default DenseRemap) build once and serve every seed, so a
        # multi-seed sweep never re-parses the file.  Unknown/custom
        # transforms conservatively count as seeded.
        seeded = any(getattr(t, "seeded", True) for t in self.transforms)
        return ("file", self.fmt, file_content_hash(self.path),
                self.page_kib, self.blktrace_action,
                tuple(t.key for t in self.transforms),
                seed if seeded else 0)
