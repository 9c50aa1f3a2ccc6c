"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA
card: a CUDA kernel has no CPU mode.  The file imports torch and numpy
only (no JAX), so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

Tolerances: flash attention within 1e-5 in float32 and, in bfloat16,
element by element within one bfloat16 ulp of the plain value plus 2^-8
of the row's rms (``bf16_err_ratio``; both sum in float32, in other
orders); the KV retry read's margins within rtol 1e-6 of the
larger of the margin and its ratio term, equal decisions, and outputs
bit for bit.  ``chip_smoke.py`` holds both kernels at the serving path's
full-width shapes.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.flash_attention.plain import (
    bf16_err_ratio, flash_attention_plain)
from repro_torch.kernels.kv_retry import ops as KV
from repro_torch.kernels.kv_retry.plain import kv_retry_plain, quantize_pages

pytestmark = pytest.mark.gpu

F32_TOL = 1e-5
MARGIN_RTOL = 1e-6


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=48, softcap=50.0),
                                dict(causal=False, kv_valid=150),
                                dict(causal=False, window=40)],
                         ids=["causal", "window-softcap", "kv_valid",
                              "window-noncausal"])
def test_flash_attention_matches_plain(hd, dtype, kw):
    BK, G, T, S = 2, 3, 200, 230
    rng = np.random.default_rng(hd)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to("cuda", tdt)
               for s in ((BK * G, T, hd), (BK, S, hd), (BK, S, hd)))
    before = FA.launches
    got = FA.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.launches == before + 1
    assert got.dtype == tdt and got.shape == (BK * G, T, hd)
    want = flash_attention_plain(q, k, v, **kw)
    if dtype == "float32":
        assert float((got - want).abs().max()) <= F32_TOL
    else:
        assert bf16_err_ratio(got, want) <= 1.0


def test_flash_attention_rejects_head_dim():
    q = torch.zeros(2, 8, 32, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        FA.flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tau", [0.01, 0.02])
def test_kv_retry_matches_plain(dtype, tau):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4099, 128)).astype(np.float32)
    spikes = rng.random(4099) < 0.3
    x[spikes, rng.integers(0, 128, spikes.sum())] *= 40.0
    b = torch.from_numpy(x).to("cuda", getattr(torch, dtype))
    q, s = quantize_pages(b)
    before = KV.launches
    out, margin = KV.kv_retry_fwd(q, s, b, tau=tau)
    torch.cuda.synchronize()
    assert KV.launches == before + 1
    want_out, want_m = kv_retry_plain(q, s, b, tau=tau)
    m, w = margin.double(), want_m.double()
    assert bool(((m - w).abs() <= MARGIN_RTOL
                 * torch.maximum(w.abs(), (1 - w).abs())).all())
    fast = margin[:, 0] >= 0
    assert torch.equal(fast, want_m[:, 0] >= 0)
    assert bool(fast.any()) and bool((~fast).any())
    assert torch.equal(out, want_out)
