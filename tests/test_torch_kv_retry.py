"""Port's KV retry read (kernel B3) and page quantizer against the JAX
reference.

``quantize_pages`` is held bitwise.  The plain torch read (what the CPU
runs, and what the CUDA kernel is held against on the card) is held
against the reference's Pallas kernel in interpret mode and against
``kv_retry_ref``: margins within rtol 1e-6 (the rms sums in another
order), relative to the larger of the margin and the ratio ``r`` it is
computed from (margin = 1 - r, so near 0 its rounding is r's), outputs
bitwise wherever the fast/retry decision agrees, and the flipped
decisions counted — 0 on these inputs.  Inputs are made with
numpy from a seed.  The CUDA kernel itself runs only on the card:
``tests/test_torch_cuda_kernels.py``; its vector kernel's summation
order (lane partials of 16, then a butterfly over E/16 lanes) is
restated by ``kernels/kv_retry/emulate.py`` and held here by the same
rule, at E 64, 128 and 256, on a page count no block size divides, and
on pages built so that every margin lies within 1e-6 of 0 (sums exact
in any order, so every decision must agree).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kv_retry.kernel import kv_retry_pallas
from repro.kernels.kv_retry.ops import quantize_pages as ref_quantize
from repro.kernels.kv_retry.ref import kv_retry_ref
from repro_torch.kernels.kv_retry import ops as KV
from repro_torch.kernels.kv_retry.emulate import (
    kv_retry_emulate, lanes_per_page, pages_near_zero, sum_of_squares)
from repro_torch.kernels.kv_retry.plain import kv_retry_plain, quantize_pages

MARGIN_RTOL = 1e-6


def assert_margins_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = MARGIN_RTOL * np.maximum(np.abs(want), np.abs(1.0 - want))
    gap = np.abs(got - want)
    assert (gap <= tol).all(), float((gap / tol).max())


SHAPES = [(64, 64), (100, 128), (7, 32), (512, 128)]
TAUS = [0.01, 0.05, 0.2]


def _pages(P, E, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((P, E)).astype(np.float32)
    # Spiky pages: one large element sets the scale, so the page's rms
    # is small against it and the margin turns negative (a retry).
    spikes = rng.random(P) < 0.3
    x[spikes, rng.integers(0, E, spikes.sum())] *= 40.0
    return x


def _backing(x, dtype):
    t = torch.from_numpy(x)
    return t if dtype == "float32" else t.to(torch.bfloat16)


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("P,E", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_pages_bitwise(P, E, dtype):
    b = _backing(_pages(P, E, seed=P + E), dtype)
    q, s = quantize_pages(b)
    qr, sr = ref_quantize(_jnp(b))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(qr))
    assert np.array_equal(s.numpy(), np.asarray(sr))


def _hold_against_reference(q, s, b, tau, out, margin):
    """Margins within the rule, 0 flipped decisions and outputs bitwise
    against the Pallas kernel in interpret mode and ``kv_retry_ref``;
    returns the fast-page mask."""
    P = q.shape[0]
    assert out.dtype == b.dtype and margin.shape == (P, 1)
    jq, js, jb = jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), _jnp(b)
    fast = margin.numpy()[:, 0] >= 0
    for name, (want_out, want_m) in (
            ("pallas", kv_retry_pallas(jq, js, jb, tau=tau, bp=32,
                                       interpret=True)),
            ("ref", kv_retry_ref(jq, js, jb, tau=tau))):
        want_m = np.asarray(want_m)
        want_out = np.asarray(want_out.astype(jnp.float32))
        assert_margins_close(margin.numpy(), want_m)
        flips = fast != (want_m[:, 0] >= 0)
        print(f"{name}: {fast.sum()} of {P} pages fast, {flips.sum()} flips")
        assert flips.sum() == 0
        agree = ~flips
        assert np.array_equal(out.float().numpy()[agree], want_out[agree])
    return fast


@pytest.mark.parametrize("P,E", SHAPES)
@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference(P, E, tau, dtype):
    b = _backing(_pages(P, E, seed=3 * P + E), dtype)
    q, s = quantize_pages(b)
    out, margin = KV.kv_retry_fwd(q, s, b, tau=tau)
    _hold_against_reference(q, s, b, tau, out, margin)


# A page count that no block of the vector kernel divides (its blocks
# take 256 / G x 4 pages a step).
RAGGED_P = 1037


@pytest.mark.parametrize("E", [64, 128, 256])
@pytest.mark.parametrize("tau", [0.01, 0.02])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vector_emulation_matches_reference(E, tau, dtype):
    b = _backing(_pages(RAGGED_P, E, seed=5 * E + 1), dtype)
    q, s = quantize_pages(b)
    out, margin = kv_retry_emulate(q, s, b, tau=tau)
    fast = _hold_against_reference(q, s, b, tau, out, margin)
    assert fast.any() and (~fast).any()


@pytest.mark.parametrize("E", [64, 128, 256])
@pytest.mark.parametrize("impl", ["emulate", "plain"])
def test_margins_near_zero_decide_alike(E, impl):
    q, s, tau = pages_near_zero(300, E, seed=E)
    b = torch.from_numpy(np.random.default_rng(E).standard_normal(
        (300, E)).astype(np.float32))
    fn = kv_retry_emulate if impl == "emulate" else kv_retry_plain
    out, margin = fn(q, s, b, tau=tau)
    assert float(margin.abs().max()) < 1e-6
    fast = _hold_against_reference(q, s, b, tau, out, margin)
    assert fast.any() and (~fast).any()


@pytest.mark.parametrize("E,G", [(16, 1), (48, 4), (64, 4), (128, 8),
                                 (256, 16), (512, 32)])
def test_vector_lanes_and_butterfly_order(E, G):
    assert lanes_per_page(E) == G and KV.uses_vector(E)
    assert not KV.uses_vector(E + 4) and not KV.uses_vector(E + 512)
    deq = torch.from_numpy(np.random.default_rng(E).standard_normal(
        (5, E)).astype(np.float32))
    sq = (deq * deq).double().numpy()
    part = np.zeros((5, G), np.float32)
    for lane in range(G):
        for j in range(16):
            if lane * 16 + j < E:
                part[:, lane] = np.float32(part[:, lane]
                                           + np.float32(sq[:, lane * 16 + j]))
    while part.shape[1] > 1:           # lane i adds lane i + half's sum
        half = part.shape[1] // 2
        part = (part[:, :half] + part[:, half:]).astype(np.float32)
    assert np.array_equal(sum_of_squares(deq).numpy(), part[:, 0])


def test_retried_pages_get_exact_backing():
    b = torch.from_numpy(_pages(64, 32, seed=4) * 1e4)
    q, s = quantize_pages(b)
    out, margin = KV.kv_retry_fwd(q, s, b, tau=0.02)
    retried = margin[:, 0] < 0
    assert retried.any() and (~retried).any()
    assert torch.equal(out[retried], b[retried])
    assert torch.equal(out[~retried], (q.float() * s)[~retried])


def test_read_with_retry_places_on_the_named_device():
    b = torch.from_numpy(_pages(16, 32, seed=5))
    q, s = quantize_pages(b)
    before = KV.launches
    out, margin = KV.kv_read_with_retry(q, s, b, tau=0.05, device="cpu")
    assert out.device.type == "cpu" and KV.launches == before
    want = kv_retry_plain(q, s, b, tau=0.05)
    assert torch.equal(out, want[0]) and torch.equal(margin, want[1])


@pytest.mark.parametrize("bad", ["qdtype", "scale", "backing"])
def test_wrapper_rejects_bad_inputs(bad):
    b = torch.zeros(8, 16)
    q = torch.zeros(8, 16, dtype=torch.int8)
    s = torch.ones(8, 1)
    if bad == "qdtype":
        q = q.to(torch.int32)
    elif bad == "scale":
        s = torch.ones(8)
    else:
        b = b.double()
    with pytest.raises(ValueError):
        KV.kv_retry_fwd(q, s, b)

