"""ECC model: per-codeword correction capability and the capability margin.

The paper's reference ECC corrects t = 72 bits per 1 KiB codeword, 16
codewords per 16 KiB page.  Two evaluation modes:

  * expectation mode (deterministic): a page is correctable iff its RBER
    is at or below t/n.  The characterization runs in it, and the margin
    left at the final retry step is what AR² spends on a shorter sensing
    time;
  * sampling mode: per-codeword error counts drawn Binomial(n, rber)
    through a Gaussian approximation, and the analytic page-failure
    probability the fault model (:mod:`repro_torch.flashsim.faults`)
    derives its uncorrectable and misprediction rates from.

Its float32 ``erfc`` and ``sqrt`` are XLA's
(:mod:`repro_torch.core.xla_math`; ``erfc32`` stays importable here).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import constants as C
from repro_torch.core import prng
from repro_torch.core.xla_math import div32, erfc32, sqrt32


@dataclasses.dataclass(frozen=True)
class ECCConfig:
    t: int = C.ECC_T
    n_bits: int = C.ECC_N_BITS
    codewords_per_page: int = C.CODEWORDS_PER_PAGE

    @property
    def rber_cap(self) -> float:
        """Deterministic capability expressed as an RBER threshold."""
        return self.t / float(self.n_bits)


DEFAULT_ECC = ECCConfig()


def correctable(rber: torch.Tensor, ecc: ECCConfig = DEFAULT_ECC) -> torch.Tensor:
    """Expectation-mode correctability: RBER within capability."""
    return rber <= torch.tensor(ecc.rber_cap, dtype=rber.dtype,
                                device=rber.device)


def capability_margin(rber: torch.Tensor,
                      ecc: ECCConfig = DEFAULT_ECC) -> torch.Tensor:
    """Fraction of the ECC capability left unused at the given RBER:
    ``(t - E[errors per codeword]) / t``."""
    expected_errors = rber * ecc.n_bits
    return div32(ecc.t - expected_errors, float(ecc.t))


def sample_codeword_errors(key: torch.Tensor, rber: torch.Tensor,
                           ecc: ECCConfig = DEFAULT_ECC) -> torch.Tensor:
    """Per-codeword error counts ~ Binomial(n, rber), Gaussian
    approximation, drawn with :func:`repro_torch.core.prng.normal` under
    ``key`` (on ``key``'s device).  Returns int32 counts of shape
    ``rber.shape + (codewords_per_page,)``."""
    rber = rber.to(key.device)
    mean = rber[..., None] * ecc.n_bits
    var = torch.clamp(mean * (1.0 - rber[..., None]), min=1e-9)
    noise = prng.normal(key, tuple(rber.shape) + (ecc.codewords_per_page,))
    return torch.clamp(torch.round(mean + sqrt32(var) * noise),
                       min=0.0).to(torch.int32)


def page_read_fails(key: torch.Tensor, rber: torch.Tensor,
                    ecc: ECCConfig = DEFAULT_ECC) -> torch.Tensor:
    """Sampling-mode page failure: any codeword exceeds t errors."""
    return (sample_codeword_errors(key, rber, ecc) > ecc.t).any(dim=-1)


def _integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x ** n`` for an integer ``n >= 1`` by binary powering, each
    product rounded once: the multiplication order of XLA's
    ``integer_pow`` (``torch.pow`` rounds once, from ``powf``)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def page_fail_probability(rber, ecc: ECCConfig = DEFAULT_ECC) -> torch.Tensor:
    """Analytic page-failure probability (Gaussian codeword
    approximation), in float32:

    P[page fails] = 1 - P[codeword ok]^16 with
    P[codeword ok] = Phi((t - n*rber) / sqrt(n*rber*(1-rber))).

    ``rber`` is a Python float or a tensor.  A float takes the
    reference's path, where the host does the scalar arithmetic in
    float64 and each array op runs in float32: the mean, the variance
    and ``t - mean`` round to float32 once, then the square root, the
    division, ``erfc`` (:func:`erfc32`) and the power (binary powering)
    run in float32 on the CPU.  A tensor runs in float32 on its own
    device.
    """
    if isinstance(rber, torch.Tensor):
        rber = rber.float()
        mean = rber * ecc.n_bits
        var, num = mean * (1.0 - rber), ecc.t - mean
    else:
        mean = float(rber) * ecc.n_bits
        var, num = (torch.tensor(v, dtype=torch.float32)
                    for v in (mean * (1.0 - float(rber)), ecc.t - mean))
    std = sqrt32(torch.clamp(var, min=1e-12))
    sqrt2 = sqrt32(torch.tensor(2.0, dtype=torch.float32, device=std.device))
    z = num / std
    p_cw_ok = 0.5 * erfc32(-z / sqrt2)
    return 1.0 - _integer_pow(p_cw_ok, ecc.codewords_per_page)
