"""Read-retry mechanisms: BASELINE, SOTA[25], PR², AR², PR²+AR².

The retry table is charge-proportional: entry k lowers boundary b by
k * RETRY_STEP_V * q_b (see :func:`voltage.retry_read_levels`).
Mechanisms differ along two independent axes:

  * where the search starts: entry 0, or the SOTA history predictor
    landing 70% of the way to the success entry (plus one entry of
    noise);
  * how each step executes: pipelined or not (PR², CACHE READ), full or
    scaled tR (AR², characterized safe scale).

Step execution changes latency only; where the search starts changes
the number of attempts.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import constants as C
from repro_torch.core import prng
from repro_torch.core import voltage as V
from repro_torch.core.constants import NandParams, DEFAULT_NAND

MECHANISMS = ("baseline", "sota", "pr2", "ar2", "pr2ar2", "sota+pr2ar2")

#: Fraction of retry steps removed by the SOTA predictor (paper: "about 70%").
SOTA_STEP_REDUCTION = 0.70


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Mechanism knob threaded through the simulator."""

    mechanism: str = "pr2ar2"
    #: "auto" looks up the characterized safe scale for the operating
    #: condition; a float forces a specific scale (tests/ablations).
    tr_scale: float | str = "auto"

    def __post_init__(self):
        if self.mechanism not in MECHANISMS:
            raise ValueError(f"unknown mechanism {self.mechanism!r}")

    @property
    def pipelined(self) -> bool:
        return self.mechanism in ("pr2", "pr2ar2", "sota+pr2ar2")

    @property
    def adaptive_tr(self) -> bool:
        return self.mechanism in ("ar2", "pr2ar2", "sota+pr2ar2")

    @property
    def sota_start(self) -> bool:
        return self.mechanism in ("sota", "sota+pr2ar2")


def rber_per_retry_step(mu: torch.Tensor, sigma: torch.Tensor,
                        page_type: str, tr_scale=1.0,
                        level_jitter=None,
                        params: NandParams = DEFAULT_NAND) -> torch.Tensor:
    """RBER of a page at every retry-table entry, ``(..., MAX + 1)``.

    ``level_jitter``: optional (..., 7) per-page boundary jitter.
    """
    steps = torch.arange(params.max_retry_steps + 1, dtype=torch.float32,
                         device=mu.device)
    levels = V.retry_read_levels(steps, params)            # (S, 7)
    if level_jitter is not None:
        levels = levels + level_jitter[..., None, :]       # (..., S, 7)
    return V.rber_from_distributions(
        mu[..., None, :], sigma[..., None, :], levels, page_type, tr_scale,
        params)


def first_success_step(rber_steps: torch.Tensor, start_step=0,
                       cap: float = C.ECC_RBER_CAP,
                       max_steps: int = C.MAX_RETRY_STEPS) -> torch.Tensor:
    """First retry-table entry >= start_step whose RBER is correctable;
    ``max_steps`` where none is (int64)."""
    dev = rber_steps.device
    steps = torch.arange(rber_steps.shape[-1], device=dev)
    start = torch.as_tensor(start_step, device=dev)
    capt = torch.tensor(cap, dtype=rber_steps.dtype, device=dev)
    ok = (rber_steps <= capt) & (steps >= start[..., None])
    any_ok = ok.any(dim=-1)
    idx = ok.to(torch.int32).argmax(dim=-1)
    return torch.where(any_ok, idx, max_steps)


def sota_start_step(success_step: torch.Tensor,
                    key: torch.Tensor | None = None) -> torch.Tensor:
    """History-based predictor start entry (models Shim+ [25]): 70% of
    the way to the success entry, with one entry of prediction noise."""
    pred = torch.floor(SOTA_STEP_REDUCTION * success_step.to(torch.float32))
    if key is not None:
        noise = prng.randint(key, tuple(success_step.shape), -1, 1)  # {-1, 0}
        pred = pred + noise
    return torch.clamp(pred, min=0).to(torch.int32)


def attempts_for_population(key: torch.Tensor, retention_days: float,
                            pec: float, page_type: str,
                            n_chips: int = C.N_CHIPS, n_blocks: int = 8,
                            n_pages: int = 32, sota: bool = False,
                            tr_scale: float = 1.0,
                            params: NandParams = DEFAULT_NAND
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Retry attempts (initial read + retries) across a chip population,
    on the device of ``key``.

    Returns ``attempts`` (n_chips, n_blocks, n_pages) int32 =
    k_success - start + 1, and the RBER at the success entry.
    """
    k_var, k_jit, k_sota = prng.split(key, 3)
    rate = V.sample_process_variation(k_var, n_chips, n_blocks, params)
    mu, sigma = V.degraded_distributions(retention_days, pec, rate, params)
    jitter = C.PAGE_JITTER_SIGMA * prng.normal(
        k_jit, (n_chips, n_blocks, n_pages, 7))
    rber = rber_per_retry_step(mu[..., None, :], sigma[..., None, :],
                               page_type, tr_scale, level_jitter=jitter,
                               params=params)
    k_default = first_success_step(rber)
    start = sota_start_step(k_default, k_sota) if sota else \
        torch.zeros_like(k_default)
    k = first_success_step(rber, start)
    rber_final = torch.take_along_dim(rber, k[..., None], dim=-1)[..., 0]
    attempts = (k - start + 1).to(torch.int32)
    return attempts, rber_final


def mean_retry_steps(key: torch.Tensor, retention_days: float, pec: float,
                     sota: bool = False,
                     params: NandParams = DEFAULT_NAND) -> float:
    """Population-mean number of *retry steps* (attempts - 1), page-type
    mix, on the device of ``key``: each page type's float32 mean over
    :func:`attempts_for_population` (key folded with its index), then
    the float32 mean of the three, as ``jnp.mean`` gives them on XLA's
    CPU backend (exact sums times the float32 reciprocal of the count)."""
    import numpy as np

    from repro_torch.core.characterize import mean32

    lsb, csb, msb = (np.float32(mean32(attempts_for_population(
        prng.fold_in(key, i), retention_days, pec, pt, sota=sota,
        params=params)[0] - 1)) for i, pt in enumerate(C.PAGE_TYPES))
    return float((lsb + csb + msb) * (np.float32(1.0) / np.float32(3.0)))
