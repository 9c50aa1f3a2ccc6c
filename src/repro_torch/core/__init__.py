"""Paper core in torch: PR²/AR² read-retry characterization.

  constants    — calibrated physics/timing/ECC constants (shared values)
  prng         — threefry-2x32 draws, key for key the reference's
  voltage      — TLC V_TH model, RBER, read levels (float32)
  ecc          — capability and margin
  timing       — closed-form latency for each mechanism
  retry        — retry mechanisms + RetryPolicy
  characterize — 160-chip characterization on a torch device
"""

from repro_torch.core.constants import DEFAULT_NAND, NandParams
from repro_torch.core.retry import MECHANISMS, RetryPolicy
from repro_torch.core.timing import DEFAULT_TIMING, TimingParams, read_latency

__all__ = [
    "DEFAULT_NAND",
    "NandParams",
    "MECHANISMS",
    "RetryPolicy",
    "DEFAULT_TIMING",
    "TimingParams",
    "read_latency",
]
