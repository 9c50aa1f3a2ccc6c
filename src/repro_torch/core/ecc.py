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
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import constants as C
from repro_torch.core import prng


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
    return (ecc.t - expected_errors) / ecc.t


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
    return torch.clamp(torch.round(mean + _sqrt32(var) * noise),
                       min=0.0).to(torch.int32)


def page_read_fails(key: torch.Tensor, rber: torch.Tensor,
                    ecc: ECCConfig = DEFAULT_ECC) -> torch.Tensor:
    """Sampling-mode page failure: any codeword exceeds t errors."""
    return (sample_codeword_errors(key, rber, ecc) > ecc.t).any(dim=-1)


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64."""
    return (a.double() * torch.as_tensor(b, dtype=torch.float64,
                                         device=a.device)
            + torch.as_tensor(c, dtype=torch.float64,
                              device=a.device)).float()


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, through float64 (one
    rounding of an exact-enough root).  ``torch.sqrt`` on the CPU's
    AVX-512 path rounds the other way on about 0.6% of float32 inputs."""
    return torch.sqrt(x.double()).float()


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _exp32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp``, XLA's CPU expansion (Cephes): ``n = floor(x
    log2(e) + 1/2)`` clamped to [-127, 127], the reduced argument by two
    fused subtractions, a degree-5 polynomial of fused Horner steps,
    times ``2^n`` built in the exponent bits.  ``torch.exp`` rounds
    differently on about one float32 in ten."""
    dev = x.device
    x = torch.clamp(x, -87.8, 88.8)
    n = torch.clamp(torch.floor(_fma32(x, _f32(1.44269504088896341, dev),
                                       _f32(0.5, dev))), -127.0, 127.0)
    a = _fma32(n, -_f32(0.693359375, dev), x)
    a = _fma32(n, -_f32(-2.12194440e-4, dev), a)
    z = _fma32(_horner32(a, _EXP_P), a * a, a)
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return (1.0 + z) * pow2


def _horner32(x: torch.Tensor, coeffs) -> torch.Tensor:
    """float32 polynomial in ``x``, highest power first, each Horner
    step a fused multiply-add."""
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma32(p, x, _f32(c, x.device))
    return p


#: Cephes coefficients of XLA's float32 ``exp`` and ``erfc`` expansions.
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_ERFC_P = (+2.326819970068386e-2, -1.387039388740657e-1,
           +3.687424674597105e-1, -5.824733027278666e-1,
           +6.210004621745983e-1, -4.944515323274145e-1,
           +3.404879937665872e-1, -2.741127028184656e-1,
           +5.638259427386472e-1)
_ERFC_R = (-1.047766399936249e+1, +1.297719955372516e+1,
           -7.495518717768503e+0, +2.921019019210786e+0,
           -1.015265279202700e+0, +4.218463358204948e-1,
           -2.820767439740514e-1, +5.641895067754075e-1)
_ERF_T = (+7.853861353153693e-5, -8.010193625184903e-4,
          +5.188327685732524e-3, -2.685381193529856e-2,
          +1.128358514861418e-1, -3.761262582423300e-1,
          +1.128379165726710e+0)


def erfc32(x: torch.Tensor) -> torch.Tensor:
    """float32 complementary error function, the expansion XLA's CPU
    backend compiles ``jax.scipy.special.erfc`` to: ``1 - x T(x^2)`` for
    |x| < 1; else ``exp(-x^2) / |x| * P(1/x^2)`` (|x| < 2) or ``R(1/x^2)``,
    reflected as ``2 - erfc(-x)`` below 0.  Horner steps and ``1 - x T``
    round once, as XLA's fused multiply-adds do, and ``exp`` is
    :func:`_exp32`: bit for bit XLA's CPU result.
    ``torch.special.erfc`` differs from it by one ulp on about 6% of
    float32 inputs, which the page-failure probability's 16th power and
    ``1 - p`` amplify to hundreds of ulps."""
    x = x.float()
    one = torch.ones((), dtype=torch.float32, device=x.device)
    xsq = x * x
    ax = x.abs()
    r = one / xsq
    e = (_exp32(-xsq) * (one / ax)) * torch.where(
        ax < 2.0, _horner32(r, _ERFC_P), _horner32(r, _ERFC_R))
    e = torch.where(-xsq < -88.72283905206835, torch.zeros_like(x), e)
    ge1 = torch.where(x < 0.0, 2.0 - e, e)
    lt1 = _fma32(-x, _horner32(xsq, _ERF_T), one)
    return torch.where(ax < 1.0, lt1, ge1)


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
    std = _sqrt32(torch.clamp(var, min=1e-12))
    sqrt2 = _sqrt32(_f32(2.0, std.device))
    z = num / std
    p_cw_ok = 0.5 * erfc32(-z / sqrt2)
    return 1.0 - _integer_pow(p_cw_ok, ecc.codewords_per_page)
