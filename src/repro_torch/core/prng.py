"""Threefry-2x32 counter-based PRNG in torch, draw-compatible with JAX.

The characterization's goldens were pinned with ``jax.random`` in its
*non-partitionable* threefry mode (``jax_threefry_partitionable=False``):
``split`` hashes ``iota(2n)`` under the parent key and ``random_bits``
hashes ``iota(n)`` split into two halves.  This module restates exactly
those schemes so the port draws the same process variation, page jitter
and SOTA predictor noise as the reference, key for key, on any device.

Keys are int64 tensors of shape ``(2,)`` holding two uint32 words.
Torch's ``uint32`` support is partial (no shifts on CUDA in every
version), so every lane is an int64 masked to 32 bits: adds are masked,
rotations are ``(x << r) & M | x >> (32 - r)`` on non-negative values,
which is bit-exact on CPU and CUDA alike.

Covered draws (what the characterization path makes):
``PRNGKey``, ``split``, ``fold_in``, ``random_bits`` (32-bit),
``uniform`` and ``normal`` (float32) and ``randint`` (int32).
``uniform`` and the raw bits are bitwise equal to ``jax.random``.
``normal`` is ``sqrt(2) * erfinv(u)`` with XLA's float32 ``erf_inv``
polynomial (Giles' single-precision approximation) restated below, its
Horner steps rounded once each as XLA's fused multiply-adds are, and its
``log1p`` and ``sqrt`` from :mod:`repro_torch.core.xla_math`: normals are
bitwise equal to ``jax.random.normal`` on every device.
(``torch.erfinv`` is a different, more exact approximation and differs
from ``jax.random.normal`` by up to ~90 ulps.)
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from repro_torch.core.xla_math import fma32, log1p32, sqrt32

_M32 = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """Raw key of an integer seed: ``[seed >> 32, seed & 0xFFFFFFFF]``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32],
                        dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _threefry2x32(k1, k2, x0, x1):
    """The 20-round threefry-2x32 block function on int64 lanes."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in (_ROT0 if i % 2 == 0 else _ROT1):
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def threefry_2x32(key: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Hash a flat uint32 count array under ``key`` (jax's layout: the
    counts are split into two halves, odd sizes padded with one 0)."""
    flat = count.reshape(-1)
    n = flat.numel()
    if n % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    half = flat.numel() // 2
    y0, y1 = _threefry2x32(key[0], key[1], flat[:half], flat[half:])
    return torch.cat([y0, y1])[:n].reshape(count.shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``(num, 2)`` subkeys: hash of ``iota(2 * num)`` (original mode)."""
    counts = torch.arange(2 * num, dtype=torch.int64, device=key.device)
    return threefry_2x32(key, counts).reshape(num, 2)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """Key derived from ``key`` and a 32-bit integer."""
    d = int(data) & _M32
    return threefry_2x32(
        key, torch.tensor([0, d], dtype=torch.int64, device=key.device))


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32-bit random words of ``shape`` (int64 holding uint32 values)."""
    shape = _shape(shape)
    size = math.prod(shape)
    if size >= _M32:
        raise NotImplementedError("random_bits beyond 2**32 - 1 words")
    counts = torch.arange(size, dtype=torch.int64, device=key.device)
    return threefry_2x32(key, counts).reshape(shape)


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in ``[minval, maxval)``: 23 random mantissa bits
    under exponent 0, minus one, scaled and shifted in float32."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


#: float32 ``nextafter(-1, 0)``: the lower end of ``normal``'s uniforms.
_NORMAL_LO = -0.99999994039535522

#: XLA's ``ErfInv32`` coefficients, for w < 5 and w >= 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, XLA's polynomial.

    Each Horner step ``c + p * w`` is a fused multiply-add (one
    rounding), ``log1p`` and ``sqrt`` are XLA's.
    """
    w = -log1p32(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt32(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], device=x.device),
                           torch.tensor(_ERFINV_GE5[i], device=x.device)
                           ).float()

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = fma32(p, w, coef(i))
    out = p * x
    edge = x.abs() == 1.0
    return torch.where(edge, x * torch.finfo(torch.float32).max, out)


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """float32 standard normals ``sqrt(2) * erfinv(u)``, u in (-1, 1)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32, device=key.device)
    return sqrt2 * erfinv32(u)


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """int32 integers in ``[minval, maxval)`` by jax's two-word modulus."""
    shape = _shape(shape)
    span = maxval - minval if maxval > minval else 1
    if span >= 1 << 31:
        raise NotImplementedError("randint spans of 2**31 or more")
    k1, k2 = split(key)
    higher = random_bits(k1, shape)
    lower = random_bits(k2, shape)
    mult = ((1 << 16) % span) ** 2 % span
    off = ((higher % span) * mult + (lower % span)) % span
    return (minval + off).to(torch.int32)
