"""Port's flash attention (kernel B4) against the JAX reference.

The plain torch version (what the CPU runs, and what the CUDA kernel is
held against on the card) is held against the reference's Pallas kernel
run in interpret mode, as ``tests/test_kernels.py`` runs it, over
causal and non-causal masks, windows, softcaps, ``kv_valid``, GQA with
G in {1, 3}, T != S and ragged tails.  Inputs are made with numpy from a
seed.  Tolerances: float32 within 1e-5 (the two sum in other orders);
bfloat16 element by element within one bfloat16 ulp of the reference's
value there, plus 2^-8 of the row's rms near zero (``bf16_err_ratio``:
both compute in float32 and round once).  Two faulty variants a kernel
could have, p rounded to bfloat16 before P·V and a dropped key tile,
must fail that rule.  The bfloat16 CUDA kernel's P·V arithmetic (p
split into two bfloat16 parts, each product summed in float32) is
emulated here and held to the same rule against the plain version.  The
CUDA kernels themselves run only on the card:
``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd as ref_fwd
from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.flash_attention.plain import (
    bf16_err_ratio, faulty_attention_plain, flash_attention_plain)

F32_TOL = 1e-5

# (BK, G, T, S, hd, causal, window, softcap, kv_valid)
CASES = [
    (2, 1, 64, 64, 16, True, None, None, None),
    (2, 3, 64, 64, 16, True, None, None, None),
    (1, 3, 100, 100, 32, True, None, None, None),       # ragged tails
    (2, 1, 64, 192, 16, False, None, None, None),       # T != S
    (2, 3, 48, 80, 16, True, None, None, None),         # causal, T != S
    (2, 1, 128, 128, 16, True, 32, None, None),         # sliding window
    (1, 3, 96, 96, 32, False, 24, None, None),          # window, non-causal
    (2, 1, 64, 64, 16, True, None, 20.0, None),         # softcap
    (1, 3, 70, 70, 16, True, 16, 50.0, None),           # window + softcap
    (2, 1, 64, 100, 16, False, None, None, 77),         # kv_valid
    (1, 3, 64, 64, 16, True, None, None, 40),           # causal + kv_valid
]
IDS = [f"bk{c[0]}-g{c[1]}-t{c[2]}-s{c[3]}-hd{c[4]}-{'c' if c[5] else 'nc'}"
       f"-w{c[6]}-cap{c[7]}-kv{c[8]}" for c in CASES]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(BK, G, T, S, hd, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    q = scale * rng.standard_normal((BK * G, T, hd)).astype(np.float32)
    k = scale * rng.standard_normal((BK, S, hd)).astype(np.float32)
    v = rng.standard_normal((BK, S, hd)).astype(np.float32)
    return q, k, v


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(case, dtype):
    BK, G, T, S, hd, causal, window, cap, kv_valid = case
    q, k, v = _inputs(BK, G, T, S, hd, seed=T * 7 + S,
                      scale=3.0 if cap else 1.0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(ref_fwd(
        _to_jax(q, jdt), _to_jax(k, jdt), _to_jax(v, jdt), causal=causal,
        window=window, softcap=cap, kv_valid=kv_valid, bq=32, bk=32,
        interpret=True).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = FA.flash_attention_fwd(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), causal=causal, window=window,
        softcap=cap, kv_valid=kv_valid)
    assert got.dtype == tdt and got.shape == (BK * G, T, hd)
    if dtype == "float32":
        err = float(np.abs(got.numpy() - want).max())
        print(f"float32 max abs err {err:.3g} (tol {F32_TOL})")
        assert err <= F32_TOL
    else:
        ratio = bf16_err_ratio(got, torch.from_numpy(want))
        print(f"bfloat16 worst |err| / tolerance {ratio:.3g}")
        assert ratio <= 1.0


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("window,cap", [(None, None), (24, 30.0)])
def test_model_layout_matches_reference_wrapper(G, window, cap):
    B, T, K, hd = 2, 72, 2, 16
    rng = np.random.default_rng(11 + G)
    q = rng.standard_normal((B, T, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                softcap=cap, interpret=True))
    got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True, window=window,
                             softcap=cap, device="cpu")
    assert got.shape == (B, T, K, G, hd)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)


def test_row_without_visible_key_outputs_zero():
    """kv_valid = 0 masks every key: p = 0 and out = acc / 1e-30 = 0, as
    in the reference kernel."""
    q, k, v = _inputs(1, 1, 8, 8, 16, seed=1)
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=False,
                                kv_valid=0)
    want = np.asarray(ref_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=False, kv_valid=0, interpret=True))
    assert np.array_equal(got.numpy(), want)
    assert not got.any()


@pytest.mark.parametrize("bad", ["dtype", "group", "shape"])
def test_wrapper_rejects_bad_inputs(bad):
    q = torch.zeros(4, 8, 16)
    k = torch.zeros(2, 8, 16)
    v = torch.zeros(2, 8, 16)
    if bad == "dtype":
        k = k.double()
    elif bad == "group":
        k, v = torch.zeros(3, 8, 16), torch.zeros(3, 8, 16)
    else:
        v = torch.zeros(2, 9, 16)
    with pytest.raises(ValueError):
        FA.flash_attention_fwd(q, k, v)


def test_cpu_path_does_not_count_launches():
    before = FA.launches
    q, k, v = _inputs(1, 1, 8, 8, 16, seed=2)
    FA.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v))
    assert FA.launches == before


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_routing_rule(hd, dtype):
    """``HEAD_DIMS`` is the one list of what the card takes; bfloat16 at
    hd 64 and wider takes the tensor-core kernel, the rest the SIMT
    kernel (bfloat16 at hd 16 and 32 its own entry point)."""
    assert hd in FA.HEAD_DIMS and len(FA.HEAD_DIMS) == 5
    tc = FA.uses_tensor_cores(dtype, hd)
    assert tc == (dtype == torch.bfloat16 and hd >= 64)
    entry = FA._entry(dtype, hd)
    assert entry == ("fa_fwd_tc_launch" if tc else "fa_fwd_f32_launch"
                     if dtype == torch.float32 else "fa_fwd_simt_bf16_launch")
    csrc = FA._SOURCE.read_text()
    assert f'extern "C" int {entry}(' in csrc


@pytest.mark.parametrize("fault", ["p-bf16", "drop-tile"])
def test_bf16_rule_rejects_faulty_attention(fault):
    """Against the reference's Pallas kernel (interpret mode) on a causal
    bfloat16 case, the plain version passes the element-wise rule and a
    faulty variant fails it."""
    BK, G, T, hd = 2, 3, 256, 64
    q, k, v = _inputs(BK, G, T, T, hd, seed=3)
    want = torch.from_numpy(np.asarray(ref_fwd(
        *(_to_jax(a, jnp.bfloat16) for a in (q, k, v)), causal=True,
        bq=128, bk=128, interpret=True).astype(jnp.float32)))
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    good = bf16_err_ratio(flash_attention_plain(qb, kb, vb, causal=True),
                          want)
    bad = bf16_err_ratio(faulty_attention_plain(qb, kb, vb, fault),
                         want)
    print(f"worst |err| / tolerance: plain {good:.3g}, {fault} {bad:.3g}")
    assert good <= 1.0 < bad


@pytest.mark.parametrize("causal,window,kv_valid,want", [
    (False, None, None, 64 * 80), (False, None, 50, 64 * 50),
    (True, None, None, 64 * 65 // 2), (True, 8, None, 8 * 9 // 2 + 56 * 8)])
def test_attention_mask_counts_visible_pairs(causal, window, kv_valid, want):
    from repro_torch.kernels.flash_attention.plain import attention_mask

    T, S = 64, 80 if not causal else 64
    mask = attention_mask(T, S, causal, window, kv_valid, "cpu")
    assert mask.shape == (T, S) and int(mask.sum()) == want


def _tiled_pv_emulation(q, k, v, pv, bkv=128):
    """Causal online-softmax attention over key tiles of ``bkv``, as the
    bfloat16 tensor-core kernel runs it: scores and softmax in float32,
    ``l`` summed from the float32 p, and P·V through ``pv(p, v_tile)``."""
    BH, T, hd = q.shape
    G = BH // k.shape[0]
    kf = k.float().repeat_interleave(G, dim=0)
    vf = v.float().repeat_interleave(G, dim=0)
    qf = q.float()
    m = torch.full((BH, T, 1), -1e30)
    l = torch.zeros(BH, T, 1)
    acc = torch.zeros(BH, T, hd)
    qpos = torch.arange(T)[:, None]
    for k0 in range(0, T, bkv):
        kt, vt = kf[:, k0:k0 + bkv], vf[:, k0:k0 + bkv]
        ok = torch.arange(k0, k0 + kt.shape[1])[None, :] <= qpos
        s = torch.where(ok, torch.matmul(qf, kt.transpose(1, 2))
                        * (hd ** -0.5), -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(ok, torch.exp(s - m_new), 0.0)
        c = torch.exp(m - m_new)
        l = l * c + p.sum(dim=-1, keepdim=True)
        acc = acc * c + pv(p, vt)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _pv_split(p, v):
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    return torch.matmul(hi, v) + torch.matmul(lo, v)


def _pv_bf16(p, v):
    return torch.matmul(p.to(torch.bfloat16).float(), v)


def test_split_bf16_pv_design_stays_inside_the_rule():
    """The tensor-core kernel's P·V (p = hi + lo in two bfloat16 parts,
    two float32-accumulated products) passes the element-wise bfloat16
    rule against the plain version on causal GQA inputs; p rounded to
    bfloat16 alone fails it, so the rule still tells the two apart."""
    BK, G, T, hd = 2, 3, 512, 128
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(BK, G, T, T, hd, seed=0))
    want = flash_attention_plain(q, k, v, causal=True)
    split = bf16_err_ratio(_tiled_pv_emulation(q, k, v, _pv_split), want)
    single = bf16_err_ratio(_tiled_pv_emulation(q, k, v, _pv_bf16), want)
    print(f"worst |err| / tolerance: split P {split:.3g}, bf16 P "
          f"{single:.3g}")
    assert split <= 1.0 < single
