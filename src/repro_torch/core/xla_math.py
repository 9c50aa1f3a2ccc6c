"""float32 transcendentals as XLA's CPU backend computes them, in torch.

The reference characterizes on XLA's CPU backend, whose float32 ``exp``,
``log``, ``log1p`` and ``erfc`` are polynomial expansions of its own
(Cephes-derived), compiled with the multiply-adds of a step fused into
one rounding, and run with denormals flushed to zero (FTZ and DAZ).
Torch's ``exp``, ``log``, ``log1p``, ``erfc`` and ``sqrt`` are other
approximations, and not the same on the CPU and the card, so results
that depend on float32 ulps (the margins, the page-failure probability,
the AR² acceptance ratios) would differ from the reference's and
between devices.

This module restates those expansions step for step:

  * a fused multiply-add ``a * b + c`` is :func:`fma32`: the product of
    two float32 values is exact in float64, the sum is rounded in
    float64 and then to float32;
  * an unfused step is a plain float32 torch op (IEEE-rounded on every
    device);
  * denormal results are flushed to signed zero where the expansion can
    produce them (:func:`ftz`), and denormal inputs count as zero.

There is no device branch: the card runs the same arithmetic as the CPU
and gives the same bits.  Every function takes and returns float32
tensors.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
import struct

import torch

_F32 = torch.float32
_F64 = torch.float64

#: Smallest normal float32, 2^-126.
FLT_MIN = 2.0 ** -126


def _c(v: float, like: torch.Tensor, dtype=_F32) -> torch.Tensor:
    """A constant on ``like``'s device (a device tensor, never a CPU
    scalar: CUDA turns division by a CPU scalar into a multiplication by
    its reciprocal, which rounds differently)."""
    return torch.tensor(v, dtype=dtype, device=like.device)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush float32 denormals to zero, keeping the sign."""
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """float32 ``a * b`` with a denormal product flushed to zero."""
    return ftz(a * b)


def _f32v(v: float) -> float:
    """A Python number as the float32 value it rounds to (exact in the
    float64 arithmetic of a scalar operand)."""
    return struct.unpack("f", struct.pack("f", v))[0]


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add
    (``b``, ``c`` float32 tensors or Python numbers, taken as float32)."""
    r = a.to(_F64)
    r.mul_(b if isinstance(b, torch.Tensor) else _f32v(b))
    r.add_(c if isinstance(c, torch.Tensor) else _f32v(c))
    return r.to(_F32)


def div32(x: torch.Tensor, d) -> torch.Tensor:
    """float32 ``x / d`` as a true division on every device (``d`` a
    Python number or a tensor)."""
    return x / (d if isinstance(d, torch.Tensor) else _c(d, x))


def horner32(x: torch.Tensor, coeffs) -> torch.Tensor:
    """float32 polynomial in ``x``, highest power first, each Horner
    step a fused multiply-add.  ``coeffs`` are Python numbers, or
    per-element float32 tensors shaped as ``x``; the steps reuse two
    buffers."""
    x64 = x.to(_F64)
    acc = torch.empty_like(x64)
    first = coeffs[0]
    p = first.clone() if isinstance(first, torch.Tensor) \
        else torch.full_like(x, _f32v(first))
    for c in coeffs[1:]:
        if not isinstance(c, torch.Tensor):
            c = torch.tensor(_f32v(c), dtype=_F64, device=x.device)
        torch.addcmul(c, p, x64, out=acc)     # exact product, one rounding
        p.copy_(acc)
    return p


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (as the CPU's ``sqrtps``),
    through float64: one rounding of a root exact to 53 bits.  Torch's
    float32 ``sqrt`` on the CPU's AVX-512 path rounds the other way on
    about 0.6% of inputs."""
    return torch.sqrt(ftz(x).to(_F64)).to(_F32)


#: Cephes coefficients of XLA's float32 ``exp``.
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp``, XLA's CPU expansion (Cephes): ``n = floor(x
    log2(e) + 1/2)`` clamped to [-127, 127], the reduced argument by two
    fused subtractions, a degree-5 polynomial of fused Horner steps,
    times ``2^n`` built in the exponent bits (0 for ``n = -127``)."""
    x = torch.clamp(ftz(x.to(_F32)), -87.8, 88.8)
    n = torch.clamp(torch.floor(fma32(x, 1.44269504088896341, 0.5)),
                    -127.0, 127.0)
    a = fma32(n, -0.693359375, x)
    a = fma32(n, 2.12194440e-4, a)
    z = fma32(horner32(a, _EXP_P), a * a, a)
    pow2 = ((n.to(torch.int32) + 127) << 23).view(_F32)
    return mul32(1.0 + z, pow2)


#: Cephes coefficients of XLA's float32 ``log``, in three interleaved
#: chains (``p[0::3]``, ``p[1::3]``, ``p[2::3]``, each highest first).
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def log32(x: torch.Tensor) -> torch.Tensor:
    """float32 natural ``log``, XLA's CPU expansion (Cephes ``logf``).

    ``x = m 2^e`` with ``m`` in [1/2, 1), folded to [sqrt(1/2), sqrt(2))
    around 1 (``r = m - 1``, or ``2m - 1`` as ``(m - 1) + m``); the
    degree-8 polynomial in ``r`` runs as three fused Horner chains in
    ``r`` joined in ``r^3``; ``log x = r - r^2/2 + r^3 P(r) +
    e ln 2``, with ``ln 2`` split in two and every join fused.  0 (or a
    denormal) gives -inf, a negative value NaN, +inf +inf.
    """
    x = ftz(x.to(_F32))
    xc = torch.where(x > FLT_MIN, x, torch.full_like(x, FLT_MIN))
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).to(_F32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(_F32)
    small = m < 0.707106781186547524
    zero = torch.zeros_like(m)
    r = (m - 1.0) + torch.where(small, m, zero)
    e = (e + 1.0) - torch.where(small, torch.ones_like(m), zero)
    r2 = r * r
    r3 = r2 * r
    p = _LOG_P
    a = fma32(fma32(r, p[0], p[1]), r, p[2])
    b = fma32(fma32(r, p[3], p[4]), r, p[5])
    c = fma32(fma32(r, p[6], p[7]), r, p[8])
    poly = fma32(fma32(a, r3, b), r3, c)
    y = fma32(poly, r3, e * -2.12194440e-4)
    out = fma32(e, 0.693359375, fma32(r2, -0.5, r) + y)
    out = torch.where(x < 0.0, torch.full_like(out, math.nan), out)
    out = torch.where(x == 0.0, torch.full_like(out, -math.inf), out)
    return torch.where((x == math.inf) | torch.isnan(x), x, out)


#: Cephes rational approximation of XLA's ``log1p`` for |x| < sqrt(2) - 1.
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def log1p32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log(1 + x)``, XLA's CPU expansion: for |x| < sqrt(2) - 1
    ``x + (-x^2/2 + x^3 N(x)/D(x))`` (Cephes, fused Horner steps, the
    ``-x^2/2`` folded into the last add), else :func:`log32` of ``1 + x``."""
    x = ftz(x.to(_F32))
    big = log32(x + 1.0)
    x2 = x * x
    ratio = horner32(x, _LOG1P_NUM) / horner32(x, _LOG1P_DEN)
    small = x + fma32(x2, -0.5, (x * x2) * ratio)
    return torch.where(x.abs() < 0.41421356237309504880, small, big)


#: Cephes coefficients of XLA's float32 ``erfc`` and ``erf`` expansions.
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


#: Elements an ``erfc32`` block on the CPU: its float64 temporaries then
#: stay in cache (3-4x faster on the characterization's 5.9M-element
#: arguments).  Blocking changes no bit; the card takes one block.
_CPU_BLOCK = 1 << 18


def erfc32(x: torch.Tensor) -> torch.Tensor:
    """float32 complementary error function (:func:`_erfc32`), in blocks
    of :data:`_CPU_BLOCK` elements on the CPU."""
    x = x.to(_F32)
    if x.device.type != "cpu" or x.numel() <= _CPU_BLOCK:
        return _erfc32(x)
    return torch.cat([_erfc32(b) for b in x.reshape(-1).split(_CPU_BLOCK)]
                     ).reshape(x.shape)


def _erfc32(x: torch.Tensor) -> torch.Tensor:
    """float32 complementary error function, the expansion XLA's CPU
    backend compiles ``jax.scipy.special.erfc`` to: ``1 - x T(x^2)`` for
    |x| < 1; else ``exp(-x^2) / |x| * P(1/x^2)`` (|x| < 2) or ``R(1/x^2)``,
    reflected as ``2 - erfc(-x)`` below 0.  Horner steps and ``1 - x T``
    round once, as XLA's fused multiply-adds do, and ``exp`` is
    :func:`exp32`.

    The three polynomials run as one Horner chain whose variable and
    coefficients each element selects (T and R padded with leading
    zeros, exact steps of ``0 * v + 0``), a third of the work of three
    chains."""
    x = ftz(x.to(_F32))
    one = torch.ones((), dtype=_F32, device=x.device)
    xsq = mul32(x, x)
    ax = x.abs()
    r = one / xsq
    lt1 = ax < 1.0
    sel = (ax >= 1.0).to(torch.int64) + (ax >= 2.0).to(torch.int64)
    table = _erfc_table(x.device)
    poly = horner32(torch.where(lt1, xsq, r),
                    [torch.take(row, sel) for row in table])
    e = mul32(mul32(exp32(-xsq), one / ax), poly)
    e = torch.where(-xsq < -88.72283905206835, torch.zeros_like(x), e)
    ge1 = torch.where(x < 0.0, 2.0 - e, e)
    return torch.where(lt1, fma32(-x, poly, one), ge1)


def _erfc_table(device) -> torch.Tensor:
    """(9, 3) float32 coefficients of T, P and R, highest power first
    (row i holds the three polynomials' i-th coefficients)."""
    pad = lambda c: (0.0,) * (9 - len(c)) + tuple(c)   # noqa: E731
    return torch.tensor([pad(_ERF_T), pad(_ERFC_P), pad(_ERFC_R)],
                        dtype=_F32, device=device).T.contiguous()


@functools.lru_cache(maxsize=None)
def _libm_powf():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    fn = lib.powf
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def powf(x: float, y: float) -> float:
    """float32 ``x ** y`` of two host scalars: the C library's ``powf``,
    which XLA's CPU backend calls for float32 ``power``.  The
    characterization raises only its (scalar) operating condition to a
    power, so this runs on the host for every device."""
    return float(_libm_powf()(float(x), float(y)))
