"""Latency composition for regular, PR²-pipelined, and AR²-scaled read-retry.

A flash read with k retry steps executes k+1 *read attempts* (the initial
read plus k retries).  Each attempt is a three-stage operation:

    sense (tR, die-local)  ->  transfer (tDMA, channel)  ->  decode (tECC)

Regular read-retry serializes attempts: the controller only issues retry
i+1 after decode i fails.  PR² exploits the NAND CACHE READ command: the
die has a page register *and* a cache register, so sensing of attempt i+1
proceeds while attempt i's data streams out of the cache register and
decodes.  The steady-state per-attempt cost collapses from
(tR + tDMA + tECC) to max(tR, tDMA + tECC) = tR for realistic timings —
the paper's 28.5% per-step reduction.

AR² scales tR itself by the characterized safe factor for the block's
operating condition (s = 0.75 worst-case), on *every* attempt: early
attempts fail regardless, and the final attempt's ECC margin absorbs the
extra sensing noise.

These closed forms are used by unit tests and napkin math; the SSD
simulator (repro_torch.flashsim) re-derives the same schedules event-by-event
with channel/die/ECC-engine contention on top.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import constants as C


@dataclasses.dataclass(frozen=True)
class TimingParams:
    tr_us: dict = dataclasses.field(default_factory=lambda: dict(C.TR_US))
    tdma_us: float = C.TDMA_US
    tecc_us: float = C.TECC_US
    tprog_us: float = C.TPROG_US

    def tr(self, page_type: str, tr_scale: float = 1.0) -> float:
        return self.tr_us[page_type] * tr_scale

    @property
    def transfer_decode_us(self) -> float:
        return self.tdma_us + self.tecc_us


DEFAULT_TIMING = TimingParams()


def sequential_read_latency(
    n_attempts: int | np.ndarray,
    page_type: str = "csb",
    tr_scale: float = 1.0,
    timing: TimingParams = DEFAULT_TIMING,
) -> np.ndarray:
    """Regular read-retry: attempts fully serialized."""
    n = np.asarray(n_attempts, np.float64)
    per = timing.tr(page_type, tr_scale) + timing.transfer_decode_us
    return n * per


def pipelined_read_latency(
    n_attempts: int | np.ndarray,
    page_type: str = "csb",
    tr_scale: float = 1.0,
    timing: TimingParams = DEFAULT_TIMING,
) -> np.ndarray:
    """PR²: CACHE READ overlaps sense i+1 with transfer+decode of attempt i.

    latency = tR_0 + sum_{i=1..n-1} max(tR_i, tDMA+tECC) + tDMA + tECC.
    """
    n = np.asarray(n_attempts, np.float64)
    tr = timing.tr(page_type, tr_scale)
    steady = max(tr, timing.transfer_decode_us)
    return tr + np.maximum(n - 1, 0) * steady + timing.transfer_decode_us


def read_latency(
    n_attempts: int | np.ndarray,
    mechanism: str,
    page_type: str = "csb",
    tr_scale: float = 0.75,
    timing: TimingParams = DEFAULT_TIMING,
) -> np.ndarray:
    """Closed-form read latency for each mechanism.

    ``tr_scale`` is only applied by the AR² variants; pass the
    characterization-table value for the block's operating condition.
    """
    if mechanism in ("baseline", "sota"):
        return sequential_read_latency(n_attempts, page_type, 1.0, timing)
    if mechanism == "pr2":
        return pipelined_read_latency(n_attempts, page_type, 1.0, timing)
    if mechanism == "ar2":
        return sequential_read_latency(n_attempts, page_type, tr_scale, timing)
    if mechanism in ("pr2ar2", "pr2+ar2", "sota+pr2ar2"):
        return pipelined_read_latency(n_attempts, page_type, tr_scale, timing)
    raise ValueError(f"unknown mechanism: {mechanism}")


def per_step_reduction_pr2(timing: TimingParams = DEFAULT_TIMING) -> float:
    """Steady-state per-retry-step latency reduction from PR² alone.

    With the calibrated timings this is the paper's 28.5%: transfer+decode
    leave the critical path, so a step costs tR instead of tR+tDMA+tECC.
    """
    tr_avg = float(np.mean(list(timing.tr_us.values())))
    full = tr_avg + timing.transfer_decode_us
    return timing.transfer_decode_us / full


def die_busy_us(
    n_attempts: int,
    mechanism: str,
    page_type: str = "csb",
    tr_scale: float = 0.75,
    timing: TimingParams = DEFAULT_TIMING,
) -> float:
    """Time the die itself is occupied (for simulator contention modeling).

    Under PR² the die frees once the final sense lands in the cache
    register; transfer/decode of the last attempt proceed off-die.  One
    speculative extra sense may be in flight when decode succeeds — the
    simulator charges it to die occupancy (not to the read's response time).
    """
    s = tr_scale if mechanism in ("ar2", "pr2ar2", "pr2+ar2", "sota+pr2ar2") else 1.0
    tr = timing.tr(page_type, s)
    if mechanism in ("baseline", "sota", "ar2"):
        return n_attempts * tr  # transfer happens from cache register
    # PR² variants: senses are back-to-back, plus one speculative sense.
    return (n_attempts + 1) * tr
