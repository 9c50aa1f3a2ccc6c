"""PyTorch/CUDA port of the PR²/AR² read-retry reproduction.

A second package beside the JAX reference (``repro``), with the same
layout and names.  It imports torch and numpy, never JAX and never the
reference package.  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``; without CUDA, ``device=None`` raises.

  core      — NAND characterization (threefry draws, V_TH model, ECC,
              retry mechanisms, the 160-chip characterization)
  flashsim  — the SSD simulator and its run APIs
  configs   — the architecture registry (pure data)
  models    — the decoder LM of the serving path
  serving   — the serving engine and the retry-aware quantized KV store
  kernels   — hand-written Hopper kernels beside their plain versions
"""

from repro_torch.core.characterize import (
    attempt_cdf,
    attempt_histogram,
    characterize_condition,
    load_tables,
)
from repro_torch.flashsim import (
    OperatingCondition,
    SSDConfig,
    SSDSim,
    SimStats,
    compare_mechanisms,
    simulate,
    simulate_batch,
)
from repro_torch.configs import get_config
from repro_torch.kernels.fcfs_core import fcfs_core, fused_core
from repro_torch.models import build_model
from repro_torch.serving import QuantizedKVStore, ServeEngine

__all__ = [
    "attempt_cdf",
    "attempt_histogram",
    "characterize_condition",
    "load_tables",
    "OperatingCondition",
    "SSDConfig",
    "SSDSim",
    "SimStats",
    "compare_mechanisms",
    "simulate",
    "simulate_batch",
    "fcfs_core",
    "fused_core",
    "get_config",
    "build_model",
    "QuantizedKVStore",
    "ServeEngine",
]
