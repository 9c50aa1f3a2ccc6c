"""Threshold-voltage (V_TH) model for 3D TLC NAND flash, in torch float32.

The same analytical device model as the reference:

  * each of the 8 TLC levels is a Gaussian N(mu_i, sigma_i);
  * retention loss shifts programmed levels down proportionally to their
    stored charge and to log(time), amplified by P/E cycling;
  * wear widens the distributions;
  * reading with a shortened sensing time tR adds sensing noise
    sigma_sense = eta * (1 - tr_scale) — the AR² trade-off;
  * a page's RBER for a given set of read voltages is the sum of Gaussian
    tail overlaps at the boundaries that page type senses (2-3-2 Gray code).

Every function is float32 and broadcasts over leading batch dims, so the
160-chip characterization runs as one batched call on whatever device
its inputs live on.  Python constants enter the arithmetic as float32
scalars, as JAX's weakly typed constants do.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import constants as C
from repro_torch.core import prng
from repro_torch.core.constants import NandParams, DEFAULT_NAND

_F32 = torch.float32


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(_F32)
    return torch.as_tensor(x, dtype=_F32, device=device)


def qfunc(x: torch.Tensor) -> torch.Tensor:
    """Gaussian tail probability Q(x) = P[N(0,1) > x]."""
    return 0.5 * torch.special.erfc(x / _f32(math.sqrt(2.0), x.device))


def charge_fraction(params: NandParams = DEFAULT_NAND,
                    device=None) -> torch.Tensor:
    """Charge stored in each level, as a fraction of the top level."""
    mu0 = _f32(params.mu0, device)
    return torch.clamp(mu0, min=0.0) / mu0[-1]


def degradation_scale(retention_days, pec,
                      params: NandParams = DEFAULT_NAND,
                      device=None) -> torch.Tensor:
    """Dimensionless degradation magnitude g(t, c) = ln(1+t/t0)*(1+c/K)^beta."""
    t = _f32(retention_days, device)
    c = _f32(pec, device)
    return torch.log1p(t / params.t0_days) * \
        (1.0 + c / params.pec_knee) ** params.pec_beta


def degraded_distributions(retention_days, pec, rate_factor=1.0,
                           params: NandParams = DEFAULT_NAND, device=None):
    """Level means/sigmas after (retention, P/E) stress.

    Returns ``(mu, sigma)`` of shape broadcast(...) + (8,).
    """
    if isinstance(rate_factor, torch.Tensor):
        device = rate_factor.device
    mu0 = _f32(params.mu0, device)
    sigma0 = _f32(params.sigma0, device)
    q = charge_fraction(params, device)
    g = degradation_scale(retention_days, pec, params, device) * \
        _f32(rate_factor, device)
    g = g[..., None]
    mu = mu0 - params.alpha_r * q * g
    c = _f32(pec, device)[..., None]
    sig_ret = params.sigma_r * q * g
    sig_wear = params.sigma_w * torch.where(q > 0, 1.0, 0.0) * \
        (c / 1000.0) ** 0.7
    sigma = torch.sqrt(sigma0 ** 2 + sig_ret ** 2 + sig_wear ** 2)
    return mu, sigma


def optimal_boundaries(mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Closed-form optimal read voltages (adjacent-Gaussian intersections),
    ``(..., 8)`` levels to ``(..., 7)`` boundaries; midpoint when the
    two sigmas are equal."""
    m1, m2 = mu[..., :-1], mu[..., 1:]
    s1, s2 = sigma[..., :-1], sigma[..., 1:]
    a = s2 ** 2 - s1 ** 2
    b = 2.0 * (s1 ** 2 * m2 - s2 ** 2 * m1)
    c = s2 ** 2 * m1 ** 2 - s1 ** 2 * m2 ** 2 - \
        2.0 * (s1 * s2) ** 2 * torch.log(s2 / s1)
    midpoint = 0.5 * (m1 + m2)
    disc = torch.clamp(b ** 2 - 4.0 * a * c, min=0.0)
    flat = torch.abs(a) < 1e-9
    safe_a = torch.where(flat, 1.0, a)
    r1 = (-b + torch.sqrt(disc)) / (2.0 * safe_a)
    r2 = (-b - torch.sqrt(disc)) / (2.0 * safe_a)
    root = torch.where((r1 > m1) & (r1 < m2), r1, r2)
    return torch.where(flat, midpoint, root)


def default_read_levels(params: NandParams = DEFAULT_NAND,
                        device=None) -> torch.Tensor:
    """Factory-default read levels: optimal for a fresh (t=0, c=0) block."""
    return optimal_boundaries(_f32(params.mu0, device),
                              _f32(params.sigma0, device))


def boundary_charge_fraction(params: NandParams = DEFAULT_NAND,
                             device=None) -> torch.Tensor:
    """Charge fraction at each boundary (average of the adjacent levels)."""
    q = charge_fraction(params, device)
    return 0.5 * (q[:-1] + q[1:])


def retry_read_levels(step, params: NandParams = DEFAULT_NAND,
                      base_levels=None, device=None) -> torch.Tensor:
    """Read levels for retry-table entry ``step`` (0 = default read):
    ``base - k * RETRY_STEP_V * q_b`` (charge-proportional decrement)."""
    if isinstance(step, torch.Tensor):
        device = step.device
    if base_levels is None:
        base_levels = default_read_levels(params, device)
    qb = boundary_charge_fraction(params, device)
    k = _f32(step, device)[..., None]
    return base_levels - k * params.retry_step_v * qb


def sensing_sigma(sigma: torch.Tensor, tr_scale=1.0,
                  params: NandParams = DEFAULT_NAND) -> torch.Tensor:
    """Effective sigma when sensing with reduced tR (AR² trade-off)."""
    s = _f32(tr_scale, sigma.device)
    extra = params.sense_eta * torch.clamp(1.0 - s, min=0.0)
    return torch.sqrt(sigma ** 2 + extra[..., None] ** 2)


def boundary_error_rates(mu, sigma, read_levels, tr_scale=1.0,
                         params: NandParams = DEFAULT_NAND) -> torch.Tensor:
    """Per-boundary raw bit error contribution (uniform random data),
    ``(..., 7)``: a page's RBER sums the boundaries its type senses."""
    sig = sensing_sigma(sigma, tr_scale, params)
    m_lo, m_hi = mu[..., :-1], mu[..., 1:]
    s_lo, s_hi = sig[..., :-1], sig[..., 1:]
    up = qfunc((read_levels - m_lo) / s_lo)     # lower level read as upper
    dn = qfunc((m_hi - read_levels) / s_hi)     # upper level read as lower
    return (up + dn) / 8.0


_PAGE_MASKS = {
    pt: tuple(1.0 if (b + 1) in C.PAGE_BOUNDARIES[pt] else 0.0
              for b in range(7))
    for pt in C.PAGE_TYPES
}


def page_mask(page_type: str, device=None) -> torch.Tensor:
    """0/1 mask over the 7 boundaries selecting a page type's read levels."""
    return _f32(_PAGE_MASKS[page_type], device)


def rber_from_distributions(mu, sigma, read_levels, page_type: str,
                            tr_scale=1.0,
                            params: NandParams = DEFAULT_NAND) -> torch.Tensor:
    """RBER of one page type under the given distributions and read levels."""
    per_boundary = boundary_error_rates(mu, sigma, read_levels, tr_scale,
                                        params)
    return torch.sum(per_boundary * page_mask(page_type, mu.device), dim=-1)


def sample_process_variation(key: torch.Tensor, n_chips: int, n_blocks: int,
                             params: NandParams = DEFAULT_NAND) -> torch.Tensor:
    """Lognormal per-chip x per-block degradation-rate factors,
    ``(n_chips, n_blocks)`` around 1.0."""
    k1, k2 = prng.split(key)
    chip = torch.exp(C.CHIP_VAR_SIGMA * prng.normal(k1, (n_chips, 1)))
    block = torch.exp(C.BLOCK_VAR_SIGMA * prng.normal(k2, (n_chips, n_blocks)))
    return chip * block
