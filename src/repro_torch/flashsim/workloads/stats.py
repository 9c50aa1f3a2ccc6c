"""Measured trace statistics — the bridge between real and synthetic.

:func:`trace_stats` measures, from the flat arrays alone, the same six
axes the synthetic generator is parameterized by: intensity (IOPS), read
ratio, request size, burstiness, footprint, and span.  Two uses:

  * **generator validation** — for every synthetic profile the measured
    stats must land within documented tolerance of the ``Workload`` spec
    (regression-tested in ``tests/test_workloads.py``), so the MMPP
    stand-ins provably have the shapes they claim;
  * **ingest sanity** — a freshly parsed MSR/blktrace file gets a
    one-line summary (``TraceStats.as_row``) whose IOPS/read-ratio can be
    checked against the trace's published characteristics.

Burstiness is recovered from the squared coefficient of variation (SCV)
of inter-arrival gaps.  For the repo's MMPP (half the requests in burst
phases at rate ``b * iops``, idle rate chosen to keep the long-run mean)
the marginal gap SCV is ``2/b² - 4/b + 3``, which inverts to

    ``b = 1 / (1 - sqrt((scv - 1) / 2))``

— exact at 1 for plain Poisson and monotone in ``b``; the estimator is
moment-based, so it needs no knowledge of phase boundaries and applies
unchanged to real traces (reported as ``mmpp_burstiness``, i.e. "the
MMPP b that would produce this dispersion").
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.flashsim.workloads.base import RequestTrace, touched_pages


@dataclasses.dataclass(frozen=True)
class TraceStats:
    """Measured statistics of one :class:`RequestTrace`."""

    n_requests: int        # requests in the trace
    duration_s: float      # arrival span (first to last, seconds)
    iops: float            # n_requests / duration (requests/s)
    read_ratio: float      # fraction of read requests [0, 1]
    mean_pages: float      # mean request length (16 KiB pages)
    total_pages: int       # total page-ops the trace expands to
    footprint_pages: int   # distinct logical pages touched
    span_pages: int        # max touched page + 1 (raw address span)
    gap_scv: float         # squared coeff. of variation of arrival gaps
    mmpp_burstiness: float # MMPP b recovered from gap_scv (>= 1)

    @property
    def sparsity(self) -> float:
        """span / footprint — 1.0 for dense traces, large for raw LBAs."""
        return self.span_pages / max(self.footprint_pages, 1)

    def as_row(self) -> str:
        return (
            f"n={self.n_requests} dur={self.duration_s:7.3f}s "
            f"iops={self.iops:9.0f} rd={self.read_ratio:.2f} "
            f"pages={self.mean_pages:4.2f} burst={self.mmpp_burstiness:4.2f} "
            f"footprint={self.footprint_pages} span={self.span_pages}"
        )


def burstiness_from_scv(scv: float) -> float:
    """Invert the MMPP gap-SCV relation ``scv = 2/b² - 4/b + 3``.

    Clipped to ``b >= 1`` (sub-Poisson dispersion reads as 1) and capped
    where the closed form blows up (``scv -> 3`` is the ``b -> inf``
    limit of this MMPP family; beyond it the dispersion exceeds what the
    family can express and the cap keeps the estimate finite).
    """
    excess = max(scv - 1.0, 0.0)
    root = math.sqrt(excess / 2.0)
    if root >= 0.999:
        root = 0.999
    return 1.0 / (1.0 - root)


def trace_stats(trace: RequestTrace) -> TraceStats:
    """Measure a trace's statistical axes (see module docstring)."""
    arrival = np.sort(np.asarray(trace.arrival_us, np.float64))
    n = arrival.size
    duration_s = float(arrival[-1] - arrival[0]) / 1e6
    iops = n / duration_s if duration_s > 0 else float("inf")

    gaps = np.diff(arrival)
    if gaps.size >= 2 and float(gaps.mean()) > 0:
        m = float(gaps.mean())
        scv = float(gaps.var()) / (m * m)
    else:
        scv = 0.0

    touched = touched_pages(trace)
    return TraceStats(
        n_requests=n,
        duration_s=duration_s,
        iops=iops,
        read_ratio=float(np.asarray(trace.is_read).mean()),
        mean_pages=float(np.asarray(trace.n_pages).mean()),
        total_pages=int(np.asarray(trace.n_pages).sum()),
        footprint_pages=int(touched.size),
        span_pages=int(touched[-1]) + 1,
        gap_scv=scv,
        mmpp_burstiness=burstiness_from_scv(scv),
    )
