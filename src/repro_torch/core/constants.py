"""Physical and architectural constants for the PR²/AR² reproduction.

Voltage units are normalized (the paper never discloses absolute volts; all
published 3D-TLC characterization work — Cai+ DATE'13, Luo+ SIGMETRICS'18 —
is presented in normalized units as well).  Timing constants are chosen to
match the paper's quoted figures exactly:

  * PR² removes transfer+decode from the retry critical path and the paper
    reports a 28.5% per-step latency reduction, i.e.
    (tDMA + tECC) / (tR_avg + tDMA + tECC) = 0.285.
    With the 3D-TLC page-type sensing times below (tR_avg = 62.43 us) this
    pins tDMA + tECC = 24.9 us, which matches a 16 KiB page + LDPC parity at
    1.2 GB/s NV-DDR3 (15.4 us) plus a ~9.5 us LDPC decode.
  * AR² reduces tR by 25% worst-case (1-year retention, 1.5K P/E cycles),
    so the sensing-noise coefficient is calibrated such that scale 0.75 is
    safe at the worst prescribed operating condition and 0.65 is not.

TPU roofline constants (v5e-class, per task spec) also live here so the
roofline tooling has a single source of truth.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# --------------------------------------------------------------------------
# TLC threshold-voltage model (8 levels, Gray-coded 2-3-2 page mapping).
# --------------------------------------------------------------------------

#: Mean V_TH per level at programming time (t = 0, fresh block).  The
#: erased state sits deep below P1 (negative V_TH), as in real 3D TLC.
LEVEL_MU0: Tuple[float, ...] = (-1.20, 1.10, 1.70, 2.30, 2.90, 3.50, 4.10, 4.70)

#: V_TH standard deviation per level at programming time.  The erased state
#: is much wider than programmed states (no program-and-verify loop).
LEVEL_SIGMA0: Tuple[float, ...] = (0.30, 0.085, 0.08, 0.08, 0.08, 0.08, 0.08, 0.085)

#: Boundary -> page-type mapping for TLC 2-3-2 Gray coding.  Read level R_j
#: (j in 1..7) separates level j-1 from level j.
PAGE_BOUNDARIES = {
    "lsb": (1, 5),
    "csb": (2, 4, 6),
    "msb": (3, 7),
}
PAGE_TYPES = ("lsb", "csb", "msb")

# --------------------------------------------------------------------------
# Degradation model — calibrated against the paper's three observations.
# See core/calibrate.py for the calibration sweep that produced these.
# --------------------------------------------------------------------------

#: Retention charge-loss coefficient (V per unit charge-fraction per ln-day).
ALPHA_RETENTION = 0.094
#: Distribution widening with retention (same units).
SIGMA_RETENTION = 0.0020
#: P/E-cycle knee and exponent: degradation scales with (1 + pec/K)^beta.
PEC_KNEE = 2000.0
PEC_BETA = 1.1
#: Wear-induced widening coefficient, scales with (pec/1000)^0.7.
SIGMA_WEAR = 0.014
#: Sensing-noise coefficient: sigma_sense = SENSE_ETA * (1 - tr_scale).
#: Calibrated so a 25% tR reduction is safe at (1 yr, 1.5K P/E) and a 35%
#: reduction is not (benchmarks/tr_reduction.py reproduces the table).
SENSE_ETA = 0.11
#: log-time constant (days).
RETENTION_T0_DAYS = 1.0

#: Process variation (lognormal sigma of the per-chip / per-block / per-page
#: multiplicative factor on the degradation rate).
CHIP_VAR_SIGMA = 0.06
BLOCK_VAR_SIGMA = 0.04
#: Additive per-page, per-boundary V_REF jitter (V).
PAGE_JITTER_SIGMA = 0.010

#: Number of chips in the characterization population (paper: 160 real chips).
N_CHIPS = 160

# --------------------------------------------------------------------------
# Read-retry table.
# --------------------------------------------------------------------------

#: Per-step V_REF decrement applied to each boundary, scaled by the
#: boundary's charge fraction (retention loss is proportional to stored
#: charge, so manufacturer retry tables step high boundaries further).
RETRY_STEP_V = 0.06
#: Maximum retry entries in the table (real tables: ~30-50 entries).
MAX_RETRY_STEPS = 40

# --------------------------------------------------------------------------
# ECC (per the paper's reference: 72 bits correctable per 1 KiB codeword).
# --------------------------------------------------------------------------

ECC_T = 72                    # correctable bits per codeword
ECC_K_BITS = 8192             # data bits per codeword (1 KiB)
ECC_PARITY_BITS = 1280        # LDPC parity (code rate ~0.865)
ECC_N_BITS = ECC_K_BITS + ECC_PARITY_BITS
CODEWORDS_PER_PAGE = 16       # 16 KiB page

#: Deterministic ECC capability expressed as an RBER threshold.
ECC_RBER_CAP = ECC_T / float(ECC_N_BITS)   # ~7.6e-3

# --------------------------------------------------------------------------
# NAND / SSD timing (microseconds) — see module docstring for calibration.
# --------------------------------------------------------------------------

TR_US = {"lsb": 48.0, "csb": 61.3, "msb": 78.0}
TR_AVG_US = sum(TR_US.values()) / 3.0           # 62.43
TDMA_US = 15.4                                   # 16 KiB + parity @ 1.2 GB/s
TECC_US = 9.5                                    # LDPC decode
TPROG_US = 660.0                                 # TLC program
TERASE_US = 3500.0
PAGE_KIB = 16

#: Worst-case operating condition prescribed by manufacturers (paper §3):
#: 1-year retention [13] at 1.5K P/E cycles [24].
WORST_RETENTION_DAYS = 365.0
WORST_PEC = 1500.0

# --------------------------------------------------------------------------
# TPU v5e-class roofline constants (per task spec).
# --------------------------------------------------------------------------

TPU_PEAK_FLOPS = 197e12        # bf16 FLOP/s per chip
TPU_HBM_BW = 819e9             # bytes/s per chip
TPU_ICI_BW = 50e9              # bytes/s per link
TPU_HBM_GIB = 16.0             # v5e HBM capacity


@dataclasses.dataclass(frozen=True)
class NandParams:
    """Bundle of the physics constants (overridable for sensitivity tests)."""

    mu0: Tuple[float, ...] = LEVEL_MU0
    sigma0: Tuple[float, ...] = LEVEL_SIGMA0
    alpha_r: float = ALPHA_RETENTION
    sigma_r: float = SIGMA_RETENTION
    pec_knee: float = PEC_KNEE
    pec_beta: float = PEC_BETA
    sigma_w: float = SIGMA_WEAR
    sense_eta: float = SENSE_ETA
    t0_days: float = RETENTION_T0_DAYS
    retry_step_v: float = RETRY_STEP_V
    max_retry_steps: int = MAX_RETRY_STEPS


DEFAULT_NAND = NandParams()
