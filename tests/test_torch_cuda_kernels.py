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
bit for bit, at E 16-512 (the vector kernel, ``vec_launches``) and E
20 and 36 (the warp-per-page kernel), and bit for bit on pages whose
margins lie within 1e-6 of 0 with sums exact in any order, and on int8
backing (the in-model int8 cache's: both kernels, outputs bit for bit,
margins too on pages whose dequant is integral, ``int8_launches``); the SSD
scan's y within 1e-5 of its largest |y| in float32 and by the same element-wise bfloat16 rule, and H within 1e-5 of its
largest |H| (the plain version takes the kernel's cumulative-sum order,
so only product orders differ), and within 1e-4 of the sequential
oracle; its bfloat16 launches at hd 64 on the tensor-core path
(``tc_launches``), bit for bit equal from one launch to the next, and
its refusal of inputs that require grad (training runs the plain scan);
the RBER table within rtol 1e-6 of the plain version (both call
CUDA's erfcf), on the characterization's shape, a ragged page count and
long retry tables.  bfloat16 flash attention runs on the tensor-core
kernel and float32 on the SIMT kernel, as do head dims 16 and 32 in
both dtypes (``small_hd_launches``, in the causal, local, bidirectional
and cross kinds); the cases cover lengths below,
at and past a tile, GQA groups of 1, 3 and 8, an all-masked
``kv_valid = 0``, the wrapper's refusal of a misaligned view, and
``tc_launches`` counting bfloat16 launches only.  The shard core
(``fcfs_core``) is held bit for bit against its plain version on the
card: its shared-memory and global-memory variants under the FIFO and
priority lowerings, serial and pipelined, lanes of both kinds in one
launch, more lanes than the card holds at once, and ``smem_launches``
counting shared-memory launches only.  A sweep through spawned workers
(``run_cells`` at workers 2, a CUDA context each) gives workers 1's
bytes with every cell fused on the card.  A prepass-GC compare on the
card launches the shard core once with erases and low-priority GC reads
in its op table, equal to the array interpreter and, launch for launch,
to the plain version.  Online GC and faults characterize on the card
and run on the host interpreter, equal to the same runs characterized
on the CPU, and the batched engine refuses both.  ``chip_smoke.py``
holds every kernel at its main path's full-width shapes.  B4 and B5 are
custom ops (``repro_torch::flash_attention``, ``repro_torch::ssd_scan``):
called as ops on the card they launch their kernels, agree with the
plain versions by the rules above, and their fake implementations give
the launches' output shapes, dtypes and strides.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.fcfs_core import ops as FC
from repro_torch.kernels.fcfs_core.plain import fcfs_core_plain
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.flash_attention.plain import (
    bf16_err_ratio, flash_attention_plain)
from repro_torch.kernels.kv_retry import ops as KV
from repro_torch.kernels.kv_retry.emulate import pages_near_zero
from repro_torch.kernels.kv_retry.plain import kv_retry_plain, quantize_pages
from repro_torch.kernels.rber import ops as RB
from repro_torch.kernels.rber.plain import rber_plain
from repro_torch.kernels.ssd_scan import ops as SSD
from repro_torch.kernels.ssd_scan.plain import ssd_scan_plain
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

pytestmark = pytest.mark.gpu

F32_TOL = 1e-5
MARGIN_RTOL = 1e-6
SSD_TOL = 1e-5
SSD_ORDER_TOL = 1e-4
RBER_RTOL, RBER_ATOL = 1e-6, 1e-30


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
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


@pytest.mark.parametrize("hd,dtype", [(16, "float32"), (128, "float32"),
                                      (64, "bfloat16"), (128, "bfloat16"),
                                      (256, "bfloat16")])
@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=48, softcap=50.0)],
                         ids=["causal", "window-softcap"])
def test_flash_attention_query_shards(hd, dtype, kw):
    """Context-parallel queries (ROADMAP D15c-2b): four query shards,
    each launched against every key at its ``q_offset`` (offsets not a
    multiple of a tile among them), each held against the plain version
    at that offset, and the four concatenated equal to the unsplit
    launch bit for bit."""
    T, n = 320, 80
    q, k, v = _fa_inputs(2, 3, T, T, hd, getattr(torch, dtype), seed=hd)
    whole = FA.flash_attention_fwd(q, k, v, **kw)
    outs = []
    for i in range(T // n):
        qs = q[:, i * n:(i + 1) * n].contiguous()
        got = FA.flash_attention_fwd(qs, k, v, q_offset=i * n, **kw)
        want = flash_attention_plain(qs, k, v, q_offset=i * n, **kw)
        if dtype == "float32":
            assert float((got - want).abs().max()) <= F32_TOL
        else:
            assert bf16_err_ratio(got, want) <= 1.0
        outs.append(got)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(outs, dim=1), whole)


def _fa_inputs(BK, G, T, S, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to("cuda", dtype)
                 for s in ((BK * G, T, hd), (BK, S, hd), (BK, S, hd)))


@pytest.mark.parametrize("T", [1, 11, 65, 1500])
@pytest.mark.parametrize("G", [1, 3, 8])
def test_flash_attention_tc_lengths_and_groups(T, G):
    """bfloat16 causal GQA at lengths below, at and past a tile, and long
    enough to fill the ring many times over."""
    q, k, v = _fa_inputs(2, G, T, T, 128, torch.bfloat16, seed=T + G)
    got = FA.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=True)
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    assert bf16_err_ratio(got, want) <= 1.0


@pytest.mark.parametrize("BK,G,T,S,causal", [
    (40, 1, 1500, 1500, False), (40, 1, 11, 1500, False),
    (4, 7, 267, 267, True)], ids=["encoder", "cross", "vlm-g7"])
def test_flash_attention_tc_encoder_decoder_and_vlm_shapes(BK, G, T, S,
                                                           causal):
    """The serving shapes of whisper-large-v3 and internvl2-1b at hd 64
    on the tensor-core kernel: the encoder's bidirectional attention at
    T = S = 1500 (no multiple of a key tile: the last tile of every kv
    row, the last row's too, is ragged), the decoder's cross attention
    of 11 query rows (a query tile mostly padding) over 1500 keys, and
    internvl's causal attention of 14 query heads over 2 KV heads (G 7)."""
    q, k, v = _fa_inputs(BK, G, T, S, 64, torch.bfloat16, seed=T + G)
    before = FA.tc_launches
    got = FA.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.tc_launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    assert bf16_err_ratio(got, want) <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kv_valid_zero_outputs_zero(dtype):
    """kv_valid = 0 hides every key: every row is 0, as in the reference."""
    q, k, v = _fa_inputs(2, 3, 100, 100, 128, getattr(torch, dtype))
    got = FA.flash_attention_fwd(q, k, v, causal=False, kv_valid=0)
    torch.cuda.synchronize()
    assert not bool(got.any())


def test_flash_attention_tc_window_softcap_hd256():
    kw = dict(causal=True, window=200, softcap=30.0)
    q, k, v = _fa_inputs(2, 2, 600, 600, 256, torch.bfloat16, seed=7)
    q, k = 3 * q, 3 * k
    got = FA.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert bf16_err_ratio(got, flash_attention_plain(q, k, v, **kw)) <= 1.0


def test_flash_attention_tc_rejects_misaligned_view():
    """TMA needs 16-byte aligned bases: a view 2 bytes into its storage
    raises rather than launching or falling back."""
    BK, G, T, hd = 1, 2, 64, 64
    flat = torch.zeros(BK * G * T * hd + 1, device="cuda",
                       dtype=torch.bfloat16)
    q = flat[1:].view(BK * G, T, hd)
    k = torch.zeros(BK, T, hd, device="cuda", dtype=torch.bfloat16)
    before = FA.launches
    with pytest.raises(ValueError, match="aligned"):
        FA.flash_attention_fwd(q, k, k)
    assert FA.launches == before


def test_flash_attention_tc_launches_count_bf16_only():
    counts = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _fa_inputs(1, 2, 64, 64, 64, dtype)
        launches, tc = FA.launches, FA.tc_launches
        FA.flash_attention_fwd(q, k, v)
        counts.append((FA.launches - launches, FA.tc_launches - tc))
    torch.cuda.synchronize()
    assert counts == [(1, 1), (1, 0)]


def test_flash_attention_rejects_head_dim():
    q = torch.zeros(2, 8, 48, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        FA.flash_attention_fwd(q, q, q)


# The four attention kinds at the reduced configs' narrow heads: causal,
# local (a window with a softcap, gemma2's), bidirectional (T = S) and
# cross (11 queries over 40 keys, no mask).
SMALL_HD_KINDS = {"causal": (70, 70, dict(causal=True)),
                  "local": (70, 70, dict(causal=True, window=32,
                                         softcap=50.0)),
                  "bidir": (70, 70, dict(causal=False)),
                  "cross": (11, 40, dict(causal=False))}


@pytest.mark.parametrize("kind", sorted(SMALL_HD_KINDS))
@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_small_head_dims(kind, hd, dtype):
    """Head dims 16 and 32 run the SIMT kernel in both dtypes, counted by
    ``small_hd_launches`` and not by ``tc_launches``: float32 within
    1e-5 of the plain version, bfloat16 by the element-wise rule."""
    T, S, kw = SMALL_HD_KINDS[kind]
    q, k, v = _fa_inputs(2, 2, T, S, hd, getattr(torch, dtype), seed=hd)
    counts = FA.launches, FA.tc_launches, FA.small_hd_launches
    got = FA.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (FA.launches - counts[0], FA.tc_launches - counts[1],
            FA.small_hd_launches - counts[2]) == (1, 0, 1)
    assert not FA.uses_tensor_cores(q.dtype, hd)
    want = flash_attention_plain(q, k, v, **kw)
    if dtype == "float32":
        assert float((got - want).abs().max()) <= F32_TOL
    else:
        assert bf16_err_ratio(got, want) <= 1.0


def _kv_pages(P, E, dtype, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((P, E)).astype(np.float32)
    spikes = rng.random(P) < 0.3
    x[spikes, rng.integers(0, E, spikes.sum())] *= 40.0
    b = torch.from_numpy(x).to("cuda", getattr(torch, dtype))
    return (*quantize_pages(b), b)


def _kv_hold(q, s, b, tau, out, margin):
    """Margins within the rule, equal decisions, outputs bit for bit;
    returns the fast-page mask."""
    want_out, want_m = kv_retry_plain(q, s, b, tau=tau)
    m, w = margin.double(), want_m.double()
    assert bool(((m - w).abs() <= MARGIN_RTOL
                 * torch.maximum(w.abs(), (1 - w).abs())).all())
    fast = margin[:, 0] >= 0
    assert torch.equal(fast, want_m[:, 0] >= 0)
    assert torch.equal(out, want_out)
    return fast


# Page widths and taus at which the pages of _kv_pages both retry and
# read fast (a page retries only where tau < sqrt(E) / 254); E 20 takes
# the warp-per-page kernel, the others the vector kernel.
KV_CASES = [(64, 0.01), (64, 0.02), (128, 0.01), (128, 0.02), (256, 0.01),
            (256, 0.02), (20, 0.01), (20, 0.015)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,tau", KV_CASES)
@pytest.mark.parametrize("P", [4099, 37])
def test_kv_retry_matches_plain(dtype, E, tau, P):
    q, s, b = _kv_pages(P, E, dtype)
    before = KV.launches
    out, margin = KV.kv_retry_fwd(q, s, b, tau=tau)
    torch.cuda.synchronize()
    assert KV.launches == before + 1
    fast = _kv_hold(q, s, b, tau, out, margin)
    if P > 1000:
        assert bool(fast.any()) and bool((~fast).any())


@pytest.mark.parametrize("E", [16, 48, 64, 128, 256, 512, 20, 36])
def test_kv_retry_vec_launches_count_multiples_of_16(E):
    q, s, b = _kv_pages(300, E, "bfloat16")
    launches, vec = KV.launches, KV.vec_launches
    out, margin = KV.kv_retry_fwd(q, s, b, tau=0.01)
    torch.cuda.synchronize()
    assert KV.launches == launches + 1
    assert KV.vec_launches == vec + (E % 16 == 0)
    _kv_hold(q, s, b, 0.01, out, margin)


def test_kv_retry_rejects_width_not_multiple_of_4():
    q, s, b = _kv_pages(64, 18, "float32")
    with pytest.raises(ValueError, match="multiples of 4"):
        KV.kv_retry_fwd(q, s, b)


def test_kv_retry_vector_rejects_misaligned_view():
    q, s, b = _kv_pages(64, 64, "bfloat16")
    shifted = torch.empty(q.numel() + 8, dtype=torch.int8, device="cuda")
    view = shifted[8:].view(q.shape)
    view.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        KV.kv_retry_fwd(view, s, b)


@pytest.mark.parametrize("E", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_retry_margins_near_zero_decide_alike(E, dtype):
    q, s, tau = pages_near_zero(4099, E, seed=E)
    q, s = q.cuda(), s.cuda()
    b = torch.randn(q.shape, device="cuda").to(getattr(torch, dtype))
    out, margin = KV.kv_retry_fwd(q, s, b, tau=tau)
    torch.cuda.synchronize()
    assert float(margin.abs().max()) < 1e-6
    fast = _kv_hold(q, s, b, tau, out, margin)
    assert bool(fast.any()) and bool((~fast).any())
    assert torch.equal(margin, kv_retry_plain(q, s, b, tau=tau)[1])


@pytest.mark.parametrize("E", [64, 128, 256])
def test_kv_retry_warp_kernel_matches_plain_on_vector_widths(E):
    q, s, b = _kv_pages(4099, E, "bfloat16")
    launches, vec = KV.launches, KV.vec_launches
    out, margin = KV._launch_cuda(q, s, b, 0.01, vector=False)
    torch.cuda.synchronize()
    assert (KV.launches, KV.vec_launches) == (launches + 1, vec)
    _kv_hold(q, s, b, 0.01, out, margin)


def _int8_kv_pages(P, E, seed=9):
    """int8 backing pages as the in-model cache holds them (amax 127, or
    all zero; spiky ones retry at tau 0.01) and general ones (amax below
    127, whose fast reads truncate), with their fast tier; and a mask of
    the pages whose dequant is integral (sums exact in any order)."""
    rng = np.random.default_rng(seed)
    b = rng.integers(-100, 101, (P, E)).astype(np.int8)
    kind = rng.integers(0, 4, P)
    b[kind == 1, 0] = 127
    b[kind == 2] = 0
    spiky = np.flatnonzero(kind == 3)
    b[spiky] = rng.integers(-3, 4, (spiky.size, E))
    b[spiky, rng.integers(0, E, spiky.size)] = -127
    b = torch.from_numpy(b).cuda()
    return (*quantize_pages(b), b,
            torch.from_numpy(kind != 0).cuda())


@pytest.mark.parametrize("vector", [True, False])
@pytest.mark.parametrize("E", [16, 64, 128, 256, 20])
@pytest.mark.parametrize("tau", [0.05, 0.01])
def test_kv_retry_int8_backing_bitwise(vector, E, tau):
    """The int8-backing variant of both kernels against the plain version:
    outputs bit for bit (fast pages truncated toward zero), equal
    decisions, margins bit for bit on integral pages at power-of-two
    widths and within the rule elsewhere; ``int8_launches`` counts the
    launch."""
    if vector and E % 16:
        pytest.skip("the vector kernel takes multiples of 16")
    q, s, b, exact = _int8_kv_pages(4099, E, seed=E)
    counts = KV.launches, KV.vec_launches, KV.int8_launches
    out, margin = KV._launch_cuda(q, s, b, tau, vector=vector)
    torch.cuda.synchronize()
    assert (KV.launches - counts[0], KV.vec_launches - counts[1],
            KV.int8_launches - counts[2]) == (1, int(vector), 1)
    assert out.dtype == torch.int8
    fast = _kv_hold(q, s, b, tau, out, margin)
    if E & (E - 1) == 0:
        # The plain version's mean multiplies by 1/E on the card: equal to
        # the kernel's division where E is a power of two (every head dim).
        want_m = kv_retry_plain(q, s, b, tau=tau)[1]
        assert torch.equal(margin[exact], want_m[exact])
    trunc = fast & ~exact
    assert bool(trunc.any())
    assert bool((out[trunc] != b[trunc]).any())
    if tau < 0.02:
        assert bool((~fast).any())


def test_kv_retry_wrapper_takes_int8_backing():
    q, s, b, _ = _int8_kv_pages(300, 64)
    before = KV.int8_launches
    out, margin = KV.kv_retry_fwd(q, s, b, tau=0.01)
    torch.cuda.synchronize()
    assert KV.int8_launches == before + 1
    _kv_hold(q, s, b, 0.01, out, margin)


def _ssd_inputs(BG, G, T, hd, ds, dtype, seed=0):
    """x (BG*G, T, hd), shared B and C (BG, T, ds), dt = softplus(N(0, 1)),
    A = -exp(N(0, 1)) per head, dA = dt * A."""
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)

    def card(a, t=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            "cuda", t)

    x = card(rng.standard_normal((BG * G, T, hd)), tdt)
    Bm = card(0.5 * rng.standard_normal((BG, T, ds)), tdt)
    Cm = card(0.5 * rng.standard_normal((BG, T, ds)), tdt)
    dt = card(np.logaddexp(rng.standard_normal((BG * G, T)), 0))
    A = card(-np.exp(rng.standard_normal(G)))
    return x, Bm, Cm, dt, dt * A.repeat(BG)[:, None]


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.parametrize("hd,ds", [(16, 16), (32, 64), (64, 128), (128, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,chunk", [(200, 64), (11, 256), (300, 128)],
                         ids=["pad", "T<chunk", "pad-3chunks"])
def test_ssd_scan_matches_plain(hd, ds, dtype, T, chunk):
    args = _ssd_inputs(2, 3, T, hd, ds, dtype, seed=hd + ds)
    before = SSD.launches
    y, H = SSD.ssd_scan_fwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert SSD.launches == before + 1
    assert y.dtype == args[0].dtype and y.shape == args[0].shape
    assert H.dtype == torch.float32 and H.shape == (6, ds, hd)
    want_y, want_H = ssd_scan_plain(*args, chunk=chunk)
    if dtype == "float32":
        assert _rel(y, want_y) <= SSD_TOL
    else:
        assert bf16_err_ratio(y, want_y) <= 1.0
    assert _rel(H, want_H) <= SSD_TOL


def test_ssd_scan_matches_sequential_oracle():
    x, Bm, Cm, dt, dA = _ssd_inputs(2, 3, 300, 64, 128, "float32")
    y, H = SSD.ssd_scan_fwd(x, Bm, Cm, dt, dA, chunk=128)
    want_y, want_H = ssd_scan_ref(x, Bm.repeat_interleave(3, 0),
                                  Cm.repeat_interleave(3, 0), dt, dA)
    assert _rel(y, want_y) <= SSD_ORDER_TOL
    assert _rel(H, want_H) <= SSD_ORDER_TOL


@pytest.mark.parametrize("G", [1, 24])
@pytest.mark.parametrize("T", [4, 11, 300, 1500, 2048])
def test_ssd_scan_tc_matches_plain(T, G):
    """The tensor-core path at mamba2-130m's widths (hd 64, ds 128, chunk
    256, four batch rows): a short prompt's single ragged chunk (T 4,
    11), a ragged last chunk (300, 1500) and the long prefill (2048, 24
    heads: the main path's shape); two launches give equal bits."""
    args = _ssd_inputs(4, G, T, 64, 128, "bfloat16", seed=T + G)
    launches, tc = SSD.launches, SSD.tc_launches
    y, H = SSD.ssd_scan_fwd(*args)
    y2, H2 = SSD.ssd_scan_fwd(*args)
    torch.cuda.synchronize()
    assert SSD.launches - launches == SSD.tc_launches - tc == 2
    assert torch.equal(y, y2) and torch.equal(H, H2)
    want_y, want_H = ssd_scan_plain(*args)
    assert bf16_err_ratio(y, want_y) <= 1.0
    assert _rel(H, want_H) <= SSD_TOL


@pytest.mark.parametrize("dtype,hd,tc", [("bfloat16", 64, 1),
                                         ("float32", 64, 0),
                                         ("bfloat16", 32, 0)])
def test_ssd_scan_tc_launches_count_tensor_core_path_only(dtype, hd, tc):
    """bfloat16 at hd 64 takes the tensor-core path; float32, and
    bfloat16 at a head dim outside its rule, the SIMT kernel."""
    args = _ssd_inputs(2, 3, 300, hd, 128, dtype)
    launches, tcl = SSD.launches, SSD.tc_launches
    SSD.ssd_scan_fwd(*args)
    torch.cuda.synchronize()
    assert (SSD.launches - launches, SSD.tc_launches - tcl) == (1, tc)
    assert SSD.uses_tensor_cores(args[0].dtype, hd, 128, 300, 256) == bool(tc)


def test_ssd_scan_raises_on_inputs_requiring_grad():
    """The kernel is launched on raw pointers and has no backward: with
    grad enabled and an input that requires it, the CUDA path raises
    rather than return outputs detached from the parameters; the
    training mode runs the plain scan and keeps the graph."""
    args = _ssd_inputs(2, 3, 40, 16, 16, "float32")
    x = args[0].clone().requires_grad_(True)
    before = SSD.launches
    with pytest.raises(RuntimeError, match="no backward"):
        SSD.ssd_scan_fwd(x, *args[1:])
    assert SSD.launches == before
    with torch.no_grad():
        y, _ = SSD.ssd_scan_fwd(x, *args[1:])
    torch.cuda.synchronize()
    assert SSD.launches == before + 1
    B, nh = 2, 3
    xm = x.detach().view(B, nh, 40, 16).permute(0, 2, 1, 3).clone()
    xm.requires_grad_(True)
    dt = args[3].view(B, nh, 40).permute(0, 2, 1)
    A = -torch.arange(1, nh + 1, dtype=torch.float32, device="cuda")
    yt, _ = SSD.ssd_scan(xm, args[1], args[2], dt, A, chunk=16,
                         training=True)
    yt.sum().backward()
    assert SSD.launches == before + 1 and xm.grad is not None


def test_ssd_scan_rejects_head_dim():
    x, Bm, Cm, dt, dA = _ssd_inputs(1, 2, 16, 16, 16, "float32")
    with pytest.raises(ValueError, match="head dims"):
        SSD.ssd_scan_fwd(x[..., :8].contiguous(), Bm, Cm, dt, dA)


# The characterization's shape (20 480 x 41), a page count whose last
# block is ragged, and long retry tables.
@pytest.mark.parametrize("n_pages,n_steps", [(32, 8), (300, 41), (20480, 41),
                                             (20487, 41), (100, 600),
                                             (37, 1228)])
def test_rber_matches_plain(n_pages, n_steps):
    rng = np.random.default_rng(n_pages)
    mu = torch.from_numpy((rng.standard_normal((n_pages, 8)) * 0.05
                           + np.arange(8.0)).astype(np.float32)).cuda()
    sigma = torch.from_numpy((0.1 + 0.01 * rng.random((n_pages, 8))).astype(
        np.float32)).cuda()
    levels = torch.from_numpy((np.linspace(0.3, 6.5, 7)[None, :] - 0.01
                               * np.arange(n_steps)[:, None]).astype(
        np.float32)).cuda()
    before = RB.launches
    got = RB.rber_fwd(mu, sigma, levels)
    torch.cuda.synchronize()
    assert RB.launches == before + 1
    want = rber_plain(mu, sigma, levels)
    assert got.shape == (3, n_pages, n_steps)
    assert torch.allclose(got, want, rtol=RBER_RTOL, atol=RBER_ATOL)


def _fc_table(seed, sizes, n_dies=3, maxp=None, grid=False):
    """A padded shard-core table of random lanes (reads, writes and
    erases; half the reads host reads).  ``grid`` puts arrivals and
    durations on whole microseconds, so events of different dies tie in
    time and the choice's tie-breaks decide."""
    rng = np.random.default_rng(seed)
    lanes = []
    for n in sizes:
        kind = rng.choice([0.0, 0.0, 1.0, 2.0], size=n)
        if grid:
            arr = np.sort(rng.integers(0, 40, n)).astype(np.float64)
            dur = rng.choice([10.0, 20.0], size=n)
            tr = np.full(n, 5.0)
        else:
            arr = np.sort(rng.uniform(0.0, 400.0, n))
            dur = rng.uniform(10.0, 60.0, n)
            tr = rng.uniform(5.0, 25.0, n)
        lanes.append(np.stack([
            arr, kind, rng.integers(0, n_dies, n).astype(np.float64), dur,
            rng.integers(1, 6, n).astype(np.float64), tr,
            np.where((kind == 0.0) & (rng.random(n) < 0.5), 1.0, 0.0)],
            axis=1))
    return FC.pad_ops(lanes, maxp=maxp)


def _fc_hold(ops_np, pip, bound, n_dies=3):
    """One kernel launch against the plain version on the same card
    tensors, bit for bit; returns the launch's placement counts."""
    L = ops_np.shape[0]
    pip = np.broadcast_to(np.asarray(pip, bool), (L,))
    prio = bound is not None
    capq, capw = FC.ring_caps(ops_np, n_dies)
    ops = torch.as_tensor(FC.augment_ops(ops_np, pip), device="cuda")
    timing = torch.as_tensor(np.stack(
        [np.full(L, 3.0), np.full(L, 5.0), np.full(L, bound if prio else 0.0),
         pip.astype(np.float64)], axis=1), device="cuda")
    kw = dict(n_dies=n_dies, capq=capq, capw=capw, prio=prio)
    steps = FC.count_steps(ops_np)
    before = FC.launches, FC.smem_launches
    got = FC.fcfs_core_fwd(ops, timing, steps, **kw)
    counts = FC.launches - before[0], FC.smem_launches - before[1]
    want = fcfs_core_plain(ops, timing, steps, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool((got[2][:, 2] > 0).any())
    return counts


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("bound", [None, 0.0, float("inf")],
                         ids=["fifo", "prio-0", "prio-inf"])
@pytest.mark.parametrize("variant", ["smem", "global"])
def test_fcfs_core_matches_plain(variant, bound, pipelined, monkeypatch):
    if variant == "global":
        monkeypatch.setattr(FC, "smem_budget", lambda device, n_dies: 0)
    counts = _fc_hold(_fc_table(1, [40, 0, 1, 40, 23]), pipelined, bound)
    assert counts == ((1, 1) if variant == "smem" else (1, 0))


_LANES = {"serial": [False] * 3, "pipelined": [True] * 3,
          "mixed": [False, True, True]}


@pytest.mark.parametrize("lanes", sorted(_LANES))
@pytest.mark.parametrize("variant", ["smem", "global"])
@pytest.mark.parametrize("n_dies", [9, 16, 17, 32, 64, 100])
@pytest.mark.parametrize("bound", [None, 2.0], ids=["fifo", "prio-2"])
def test_fcfs_core_sixteen_die_slots(n_dies, bound, variant, lanes,
                                     monkeypatch):
    """Past 8 dies the event choice compares 16 slots in registers; past
    16, 32 or 64 slots across warp 0; past 64 the generic instance's
    n_dies, its die state beside the rings (shared or global memory)."""
    if variant == "global":
        monkeypatch.setattr(FC, "smem_budget", lambda device, n_dies: 0)
    n = max(60, 4 * n_dies)
    ops_np = _fc_table(5, [n, 3 * n // 4, n], n_dies=n_dies)
    assert _fc_hold(ops_np, _LANES[lanes], bound, n_dies) == \
        ((1, 1) if variant == "smem" else (1, 0))


@pytest.mark.parametrize("n_dies", [3, 8, 16, 32, 64, 100])
@pytest.mark.parametrize("bound", [None, 2.0], ids=["fifo", "prio-2"])
def test_fcfs_core_ties_across_die_slots(n_dies, bound):
    """Arrivals and durations on whole microseconds: events of different
    dies tie in time, and every instance's choice must break the ties as
    the plain version does (least seq, then the lower slot)."""
    n = max(80, 6 * n_dies)
    ops_np = _fc_table(6, [n, n, n // 2], n_dies=n_dies, grid=True)
    assert _fc_hold(ops_np, [False, True, False], bound, n_dies) == (1, 1)


@pytest.mark.parametrize("bound", [None, 8.0], ids=["fifo", "prio-8"])
def test_fcfs_core_mixed_pipelined_lanes(bound):
    pip = np.arange(12) % 3 == 0
    assert _fc_hold(_fc_table(2, [30] * 12), pip, bound) == (1, 1)


def test_fcfs_core_lanes_past_one_wave():
    """300 lanes of a table padded to 8192 rows (164 KB of shared memory
    a block): more lanes than the card holds at once."""
    ops_np = _fc_table(3, [20] * 300, maxp=8192)
    capq, capw = FC.ring_caps(ops_np, 3)
    assert FC.resident_lanes(8192, 3, capq, capw, False, "cuda") < 300
    assert _fc_hold(ops_np, True, None) == (1, 1)


def test_fcfs_core_smem_layout_matches_source():
    import ctypes

    lib = FC._lib()
    for shape in [(4096, 8, 1024, 64, 0), (4096, 8, 1024, 64, 1),
                  (16, 3, 4, 4, 1), (16384, 16, 2048, 128, 0),
                  (4096, 32, 512, 64, 0), (4096, 64, 256, 64, 1),
                  (1024, 100, 64, 32, 1), (256, 1000, 8, 16, 0)]:
        assert lib.fcfs_core_smem_bytes(*shape, FC.SMEM) == \
            FC.smem_bytes(*shape)
        assert lib.fcfs_core_smem_bytes(*shape, FC.GLOBAL) == 0
    assert FC.smem_budget("cuda", 8) >= \
        FC.smem_bytes(4096, 8, 1024, 64, True)
    # each instance: its static die state, its budget, and lanes resident
    # the generic instance keeps no static die state: its budget is the
    # card's opt-in limit (227 KB on an H100)
    optin = FC.smem_budget("cuda", 1000)
    assert optin >= 232448
    for n_dies in (1, 8, 9, 16, 17, 32, 33, 64, 65, 100, 1000):
        out = ctypes.c_longlong()
        assert lib.fcfs_core_static_smem(n_dies, ctypes.byref(out)) == 0
        assert out.value == FC.static_smem_bytes(n_dies)
        assert FC.smem_budget("cuda", n_dies) == optin - out.value
        for maxp in (256, 4096):
            capq = 64
            want = FC.SMEM if FC.smem_bytes(maxp, n_dies, capq, 64, True) \
                <= optin - out.value else FC.GLOBAL
            assert FC.placement(maxp, n_dies, capq, 64, True,
                                FC.smem_budget("cuda", n_dies)) == want
            assert FC.resident_lanes(maxp, n_dies, capq, 64, True,
                                     "cuda") >= 1


def test_fcfs_core_rejects_bad_rows_and_caps():
    ops_np = _fc_table(4, [10, 10])
    aug = FC.augment_ops(ops_np, False)
    aug[0, 2, 4] = 2.5
    timing = torch.zeros((2, 4), dtype=torch.float64, device="cuda")
    before = FC.launches
    with pytest.raises(ValueError, match="attempts"):
        FC.fcfs_core_fwd(torch.as_tensor(aug, device="cuda"), timing, 50,
                         n_dies=3, capq=4, capw=4, prio=False)
    with pytest.raises(ValueError, match="power-of-two"):
        FC.fcfs_core_fwd(torch.as_tensor(FC.augment_ops(ops_np, False),
                                         device="cuda"), timing, 50,
                         n_dies=3, capq=6, capw=4, prio=False)
    assert FC.launches == before


def test_sweep_spawned_workers_launch_on_the_card(monkeypatch, tmp_path):
    """``run_sweep`` on the card at workers 2 (spawned workers, each with
    its own CUDA context) gives workers 1's bytes, every cell fused on
    the shard core; launches in the workers are read off ``fused_cells``
    (12 cells of a seed group share one launch on the card)."""
    from repro_torch.flashsim import OperatingCondition, runtime as RT

    monkeypatch.setenv("REPRO_TORCH_CHAR_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("REPRO_SWEEP_START_METHOD", raising=False)
    conds = (OperatingCondition(365.0, 1000.0), OperatingCondition(30.0, 0.0))
    mechs = ("baseline", "sota", "pr2", "ar2", "pr2ar2", "sota+pr2ar2")
    cells = [RT.Cell("batch", "websearch", conds, mechs, s, n_requests=2000,
                     engine="batched") for s in (0, 1, 2)]
    assert RT._mp_context(cells).get_start_method() == "spawn"
    blobs = {}
    for w in (1, 2):
        groups = RT.run_cells(cells, workers=w)
        stats = [st for g in groups for st in g.values()]
        assert all(st.fused_cells == 12 for st in stats)
        blobs[w] = RT.sweep_to_json({k: v for g in groups
                                     for k, v in g.items()})
    assert blobs[1] == blobs[2]


def test_prepass_gc_compare_on_the_card(monkeypatch, tmp_path):
    """A prepass-GC ``compare_mechanisms`` on the card: the shard core's
    launch holds erases (kind 2) and low-priority GC reads beside the
    host ops, every cell equals the array interpreter's, and the launch
    equals the plain version bit for bit."""
    import dataclasses

    from repro_torch.flashsim import (GCConfig, OperatingCondition,
                                      SSDConfig, compare_mechanisms,
                                      make_workloads)

    monkeypatch.setenv("REPRO_TORCH_CHAR_CACHE_DIR", str(tmp_path))
    w = dataclasses.replace(make_workloads()["prn"], span_pages=512,
                            n_requests=600)
    cfg = SSDConfig(gc=GCConfig(enabled=True, pages_per_block=8))
    cond = OperatingCondition(365.0, 1000.0)
    mechs = ("baseline", "pr2ar2")
    launched = []
    fwd = FC.fcfs_core_fwd

    def recording(ops, timing, steps, **kw):
        out = fwd(ops, timing, steps, **kw)
        launched.append((ops, timing, steps, kw, out))
        return out

    monkeypatch.setattr(FC, "fcfs_core_fwd", recording)
    for scheduler in ("fcfs", "host_prio_aged:4"):
        launched.clear()
        before = FC.launches
        got = compare_mechanisms(w, cond, mechs, seed=1, cfg=cfg,
                                 gc="prepass", engine="batched",
                                 scheduler=scheduler)
        want = compare_mechanisms(w, cond, mechs, seed=1, cfg=cfg,
                                  gc="prepass", engine="array",
                                  scheduler=scheduler, device="cuda")
        assert FC.launches - before == len(launched) == 1
        for m in mechs:
            assert got[m] == want[m]
            assert got[m].gc_invocations == got[m].blocks_erased > 0
        ops, timing, steps, kw, out = launched[0]
        kind, hp = ops[:, :, 1], ops[:, :, 6]
        assert bool((kind == 2.0).any())
        assert bool(((kind == 0.0) & (hp == 0.0)).any())
        plain = fcfs_core_plain(ops, timing, steps, **kw)
        assert all(torch.equal(a, b) for a, b in zip(out, plain))


def test_online_gc_and_faults_on_the_card(monkeypatch, tmp_path):
    """Online GC and faults on the card: the characterization (worn bins
    and the fault model's condition records) runs on the card, the runs
    themselves on the host interpreter, and every cell equals the same
    run characterized on the CPU.  ``engine="auto"`` records why and
    launches nothing; ``engine="batched"`` refuses both knobs."""
    import dataclasses

    from repro_torch.core import characterize as TC
    from repro_torch.flashsim import (BatchedUnsupported, FaultConfig,
                                      GCConfig, OperatingCondition,
                                      SSDConfig, compare_mechanisms,
                                      make_workloads, simulate)

    w = dataclasses.replace(make_workloads()["prn"], span_pages=512,
                            n_requests=200)
    cfg = SSDConfig(dies_per_channel=1,
                    gc=GCConfig(enabled=True, pages_per_block=8))
    cond = OperatingCondition(365.0, 1000.0)
    fc = FaultConfig(uncorrectable_prob=0.6, escalation_attempts=1,
                     mispredict_scale=4.0)
    runs = {}
    try:
        for dev in ("cuda", "cpu"):
            monkeypatch.setenv("REPRO_TORCH_CHAR_CACHE_DIR",
                               str(tmp_path / dev))
            TC.clear_tables()
            before = FC.launches
            runs[dev] = [compare_mechanisms(
                w, cond, ("baseline", "pr2ar2"), seed=1, cfg=cfg, gc=gc,
                faults=faults, engine="auto", device=dev)
                for gc, faults in (("online", None), ("online", fc),
                                   ("prepass", fc))]
            assert FC.launches == before
    finally:
        TC.clear_tables()
    assert runs["cuda"] == runs["cpu"]
    online, online_fc, prepass_fc = runs["cuda"]
    for s in online.values():
        assert s.gc_invocations > 0 and s.write_stalls > 0
        assert s.engine_selected == "array"
        assert "online GC" in s.engine_fallback_reason
    for s in (*online_fc.values(), *prepass_fc.values()):
        assert s.parity_rebuilds > 0
    for knobs in (dict(gc="online"), dict(gc="prepass", faults=fc)):
        with pytest.raises(BatchedUnsupported):
            simulate(w, cond, "pr2ar2", cfg=cfg, engine="batched", **knobs)


def test_sharded_step_on_a_one_rank_nccl_mesh(tmp_path):
    """The sharded train step on a (1, 1) mesh over one NCCL rank equals
    the same step on a (1, 1) gloo mesh on the CPU (reduced llama3.2-3b,
    float32 activations, the same seeded parameters and batches): three
    steps' losses and grad norms within 1e-5 (the later losses carry the
    updates; parameters are not compared element by element, since
    AdamW's first steps move an element with a near-zero gradient by
    about +-lr whichever way its sign rounds), every leaf a DTensor on
    the card."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed import steps as ST
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import tree_leaves

    cfg = dataclasses.replace(reduced_config(get_config("llama3.2-3b")),
                              activation_dtype="float32")
    params = build_model(cfg, "cpu").init()
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
        batches.append({"tokens": toks, "labels": np.roll(toks, -1, 1)})
    torch.cuda.set_device(0)
    dist.init_process_group("cpu:gloo,cuda:nccl", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        runs = {}
        for dev in ("cuda", "cpu"):
            mesh = init_device_mesh(dev, (1, 1),
                                    mesh_dim_names=("data", "model"))
            step, place = ST.make_train_step(cfg, mesh)
            state = ST.init_train_state(
                cfg, mesh, place,
                params={k: v for k, v in params.items()})
            assert all(isinstance(x, DTensor) and x.device.type == dev
                       for x in tree_leaves(state["params"]))
            metrics = [step(state, b)[1] for b in batches]
            runs[dev] = [(float(m["loss"]), float(m["grad_norm"]))
                         for m in metrics]
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=1e-5)


def _fake_meta(op, args):
    """The custom op's fake outputs (shape, dtype, strides) on fake copies
    of ``args`` (tensors; the rest passed as they are)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        out = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                   for a in args))
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [(tuple(t.shape), t.dtype, tuple(t.stride())) for t in outs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [dict(causal=True, window=None, softcap=None,
                                     kv_valid=None),
                                dict(causal=True, window=48, softcap=50.0,
                                     kv_valid=None),
                                dict(causal=False, window=None, softcap=None,
                                     kv_valid=150)],
                         ids=["causal", "window-softcap", "kv_valid"])
def test_flash_attention_custom_op_on_the_card(dtype, kw):
    """``repro_torch::flash_attention`` on CUDA tensors launches the
    kernel (one launch, counted), its output equals the plain version's
    by the rule of ``test_flash_attention_matches_plain``, and its fake
    implementation gives the launch's shape, dtype and strides."""
    q, k, v = _fa_inputs(2, 3, 200, 230, 128, getattr(torch, dtype))
    op = torch.ops.repro_torch.flash_attention
    args = (q, k, v, kw["causal"], kw["window"], kw["softcap"],
            kw["kv_valid"])
    before = FA.launches
    got = op(*args)
    torch.cuda.synchronize()
    assert FA.launches == before + 1
    want = flash_attention_plain(q, k, v, **kw)
    if dtype == "float32":
        assert float((got - want).abs().max()) <= F32_TOL
    else:
        assert bf16_err_ratio(got, want) <= 1.0
    assert _fake_meta(op, args) == [(tuple(got.shape), got.dtype,
                                     tuple(got.stride()))]


@pytest.mark.parametrize("dtype,hd,T,chunk", [("bfloat16", 64, 2048, 256),
                                              ("bfloat16", 64, 300, 256),
                                              ("float32", 32, 200, 64)],
                         ids=["tc-long", "tc-pad", "simt"])
def test_ssd_scan_custom_op_on_the_card(dtype, hd, T, chunk):
    """``repro_torch::ssd_scan`` on CUDA tensors launches the kernel (the
    tensor-core path or the SIMT kernel, one launch counted), its y and H
    equal the plain version's by the rules of
    ``test_ssd_scan_matches_plain``, and its fake implementation gives
    the launch's shapes, dtypes and strides."""
    args = _ssd_inputs(2, 3, T, hd, 128 if hd == 64 else 64, dtype)
    op = torch.ops.repro_torch.ssd_scan
    before = SSD.launches
    y, H = op(*args, chunk)
    torch.cuda.synchronize()
    assert SSD.launches == before + 1
    want_y, want_H = ssd_scan_plain(*args, chunk=chunk)
    if dtype == "float32":
        assert _rel(y, want_y) <= SSD_TOL
    else:
        assert bf16_err_ratio(y, want_y) <= 1.0
    assert _rel(H, want_H) <= SSD_TOL
    assert _fake_meta(op, args + (chunk,)) == [
        (tuple(t.shape), t.dtype, tuple(t.stride())) for t in (y, H)]
