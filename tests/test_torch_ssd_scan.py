"""Port's SSD scan (kernel B5's plain version and its model-layout
adapter) against the JAX reference.

Inputs are made with numpy from a seed and fed to both packages: the
three shapes of ``tests/test_kernels.py::TestSSDScan``, a T < chunk case
(one short chunk, as the serving path's short prompts give) and a
bfloat16 case.  On the CPU the port's ``ssd_scan`` runs the plain
version, which follows the Pallas kernel's evaluation order.

Tolerances, as a share of the largest |y| (or |H|):

  * against ``ssd_scan(..., interpret=True)`` (the Pallas kernel run in
    interpret mode): 2e-5.  Both evaluate the same order; what is left
    is the order of the cumulative sum of dA (XLA's CPU scan and the
    CUDA kernel's, which the plain version restates, round |cum| ~ 300
    at other places, ulp 3e-5), which the single-chunk case carries into
    y at 9.5e-6;
  * against the sequential ``ssd_scan_ref`` and the model's
    ``ssd_chunked``: 1e-4 (other evaluation orders);
  * bfloat16 y: element by element within one bfloat16 ulp of the
    reference's value plus 2^-8 of the row's rms (``bf16_err_ratio``),
    H within 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as ref_ssd_scan
from repro.kernels.ssd_scan import ssd_scan_ref as ref_sequential
from repro.models.ssm import ssd_chunked
from repro_torch.kernels.flash_attention.plain import bf16_err_ratio
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_fwd, ssd_scan_ref
from repro_torch.kernels.ssd_scan.emulate import tensor_core_emulation
from repro_torch.kernels.ssd_scan.plain import faulty_ssd_plain, ssd_scan_plain

INTERPRET_TOL = 2e-5
ORDER_TOL = 1e-4

# (T, chunk, hd, ds, dtype)
CASES = [(64, 16, 16, 32, "float32"),
         (100, 32, 16, 32, "float32"),      # padding path
         (128, 128, 32, 64, "float32"),     # single chunk
         (11, 256, 16, 32, "float32"),      # T < chunk: L = T
         (100, 32, 16, 32, "bfloat16")]
IDS = ["T64-c16", "T100-c32-pad", "T128-c128", "T11-c256", "T100-bf16"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(T, hd, ds, seed=0, B=2, nh=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, nh, hd)).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((B, T, ds))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((B, T, ds))).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, T, nh)), 0).astype(np.float32)
    A = (-np.exp(rng.standard_normal(nh))).astype(np.float32)
    return x, Bm, Cm, dt, A


def _cast(dtype, x, Bm, Cm):
    """x, B, C rounded to ``dtype`` (as float32 numpy, exactly
    representable in it)."""
    if dtype == "float32":
        return x, Bm, Cm
    return tuple(torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                 for a in (x, Bm, Cm))


def _port(dtype, x, Bm, Cm, dt, A, chunk):
    tdt = getattr(torch, dtype)
    y, H = ssd_scan(torch.from_numpy(x).to(tdt), torch.from_numpy(Bm).to(tdt),
                    torch.from_numpy(Cm).to(tdt), torch.from_numpy(dt),
                    torch.from_numpy(A), chunk=chunk, device="cpu")
    assert y.dtype == tdt and H.dtype == torch.float32
    return y, H.numpy()


def _ref(dtype, fn, x, Bm, Cm, dt, A):
    jdt = getattr(jnp, dtype)
    return fn(jnp.asarray(x, jdt), jnp.asarray(Bm, jdt), jnp.asarray(Cm, jdt),
              jnp.asarray(dt), jnp.asarray(A))


def _check(y, H, want_y, want_H, tol, dtype):
    want_y, want_H = np.array(want_y, np.float32), np.asarray(want_H)
    assert y.shape == want_y.shape and H.shape == want_H.shape
    if dtype == "bfloat16":
        assert bf16_err_ratio(y, torch.from_numpy(want_y)) <= 1.0
    else:
        err = np.abs(y.numpy() - want_y).max() / np.abs(want_y).max()
        assert err <= tol, err
    assert np.abs(H - want_H).max() <= tol * np.abs(want_H).max()


@pytest.mark.parametrize("T,chunk,hd,ds,dtype", CASES, ids=IDS)
def test_plain_matches_pallas_interpret(T, chunk, hd, ds, dtype):
    x, Bm, Cm, dt, A = _inputs(T, hd, ds)
    x, Bm, Cm = _cast(dtype, x, Bm, Cm)
    y, H = _port(dtype, x, Bm, Cm, dt, A, chunk)
    want = _ref(dtype, lambda *a: ref_ssd_scan(*a, chunk=chunk,
                                               interpret=True),
                x, Bm, Cm, dt, A)
    _check(y, H, want[0].astype(jnp.float32), want[1], INTERPRET_TOL, dtype)


@pytest.mark.parametrize("T,chunk,hd,ds,dtype", CASES, ids=IDS)
def test_plain_matches_model_chunked_path(T, chunk, hd, ds, dtype):
    x, Bm, Cm, dt, A = _inputs(T, hd, ds, seed=1)
    x, Bm, Cm = _cast(dtype, x, Bm, Cm)
    y, H = _port(dtype, x, Bm, Cm, dt, A, chunk)
    want = _ref(dtype, lambda *a: ssd_chunked(*a, chunk), x, Bm, Cm, dt, A)
    _check(y, H, want[0].astype(jnp.float32), want[1], ORDER_TOL, dtype)


def _kernel_layout(x, Bm, Cm, dt, A):
    """The reference's adapter: (B*nh)-row tensors, B and C broadcast."""
    B, T, nh, hd = x.shape
    ds = Bm.shape[-1]
    xh = x.transpose(0, 2, 1, 3).reshape(B * nh, T, hd)
    dth = dt.transpose(0, 2, 1).reshape(B * nh, T)
    dAh = (dth * np.tile(A, B)[:, None]).astype(np.float32)
    Bh = np.broadcast_to(Bm[:, None], (B, nh, T, ds)).reshape(B * nh, T, ds)
    Ch = np.broadcast_to(Cm[:, None], (B, nh, T, ds)).reshape(B * nh, T, ds)
    return xh, Bh, Ch, dth, dAh


@pytest.mark.parametrize("T,chunk,hd,ds,dtype", CASES, ids=IDS)
def test_plain_matches_sequential_ref(T, chunk, hd, ds, dtype):
    x, Bm, Cm, dt, A = _inputs(T, hd, ds, seed=2)
    x, Bm, Cm = _cast(dtype, x, Bm, Cm)
    xh, Bh, Ch, dth, dAh = _kernel_layout(x, Bm, Cm, dt, A)
    tdt = getattr(torch, dtype)
    # Shared B and C (one row per batch row) against the reference's
    # per-head broadcast.
    y, H = ssd_scan_fwd(torch.from_numpy(xh).to(tdt),
                        torch.from_numpy(Bm).to(tdt),
                        torch.from_numpy(Cm).to(tdt), torch.from_numpy(dth),
                        torch.from_numpy(dAh), chunk=chunk)
    want = _ref(dtype, ref_sequential, xh, Bh, Ch, dth, dAh)
    _check(y, H.numpy(), want[0].astype(jnp.float32), want[1], ORDER_TOL,
           dtype)
    # The port's own restatement of the oracle (for tests on the card).
    mine = ssd_scan_ref(*(torch.from_numpy(np.ascontiguousarray(a)).to(tdt)
                          for a in (xh, Bh, Ch)),
                        torch.from_numpy(dth), torch.from_numpy(dAh))
    _check(mine[0], mine[1].numpy(), want[0].astype(jnp.float32), want[1],
           ORDER_TOL, dtype)


def test_bf16_rule_rejects_faulty_scans():
    """On a bfloat16 case of eight chunks, the plain version meets the
    element-wise rule against the Pallas interpret run; w rounded to
    bfloat16, and a state carried without its decay, do not."""
    T, chunk, hd, ds = 512, 64, 16, 32
    x, Bm, Cm, dt, A = _inputs(T, hd, ds, seed=3, B=1, nh=4)
    x, Bm, Cm = _cast("bfloat16", x, Bm, Cm)
    want = _ref("bfloat16", lambda *a: ref_ssd_scan(*a, chunk=chunk,
                                                    interpret=True),
                x, Bm, Cm, dt, A)[0]
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    want = want.permute(0, 2, 1, 3).reshape(4, T, hd)
    xh, _, _, dth, dAh = _kernel_layout(x, Bm, Cm, dt, A)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
            for a in (xh, Bm, Cm)] + [torch.from_numpy(dth),
                                      torch.from_numpy(dAh)]
    assert bf16_err_ratio(ssd_scan_plain(*args, chunk)[0], want) <= 1.0
    for fault in ("w-bf16", "no-decay"):
        ratio = bf16_err_ratio(faulty_ssd_plain(*args, chunk, fault)[0], want)
        print(f"control {fault}: worst |err| / tolerance {ratio:.3g}")
        assert ratio > 1.0, fault


def test_entry_moves_inputs_and_checks_shapes():
    x, Bm, Cm, dt, A = (torch.from_numpy(a) for a in _inputs(20, 16, 8))
    y, H = ssd_scan(x, Bm, Cm, dt, A, chunk=8, device="cpu")
    assert y.shape == (2, 20, 3, 16) and H.shape == (2, 3, 16, 8)
    with pytest.raises(ValueError, match="group"):
        ssd_scan_fwd(torch.zeros(5, 8, 16), torch.zeros(2, 8, 4),
                     torch.zeros(2, 8, 4), torch.zeros(5, 8),
                     torch.zeros(5, 8))
    with pytest.raises(ValueError, match="float32"):
        ssd_scan_fwd(torch.zeros(4, 8, 16), torch.zeros(2, 8, 4),
                     torch.zeros(2, 8, 4), torch.zeros(4, 8).double(),
                     torch.zeros(4, 8))


def test_tensor_core_design_stays_inside_the_rule():
    """The tensor-core path's numerics on the CPU, at B 1, 3 heads, T 600
    (the last chunk ragged), hd 64, ds 128, chunk 256, against the plain
    version: y within the element-wise bfloat16 rule (one bfloat16 ulp
    plus 2^-8 of the row's rms: ratio <= 1), H within 1e-5 of its
    largest value.  w' in one bfloat16 part fails the y rule, so it goes
    in as two."""
    T, chunk, hd, ds, nh = 600, 256, 64, 128, 3
    x, Bm, Cm, dt, A = _inputs(T, hd, ds, seed=5, B=1, nh=nh)
    xh = torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 2, 1, 3).reshape(nh, T, hd))).to(torch.bfloat16)
    Bb, Cb = (torch.from_numpy(a).to(torch.bfloat16) for a in (Bm, Cm))
    dth = torch.from_numpy(np.ascontiguousarray(dt[0].T))
    dAh = dth * torch.from_numpy(A)[:, None]
    args = (xh, Bb, Cb, dth, dAh)
    want_y, want_H = ssd_scan_plain(*args, chunk)

    def ratios(**kw):
        y, H = tensor_core_emulation(*args, chunk, **kw)
        return (bf16_err_ratio(y, want_y),
                float((H - want_H).abs().max() / (1e-5 * want_H.abs().max())))

    ry, rh = ratios()
    ry_w1, _ = ratios(w_parts=1)
    print(f"worst |err| / tolerance: y {ry:.3g}, H {rh:.3g}; one-part w' "
          f"y {ry_w1:.3g}")
    assert ry <= 1.0 and rh <= 1.0
    assert ry_w1 > 1.0


def test_state_path_keeps_the_plain_order_on_padded_rows():
    """A left-padded prompt repeats one token: with C nearly orthogonal to
    B there, C . H_{c-1} cancels to a small part of its summands, y is
    small, and the element-wise bfloat16 rule's tolerance with it.  The
    kernel's float32 state path (S and C . H in the plain version's
    order) stays within the rule (ratio <= 1); S on the tensor cores
    (B * dt * seg in three bfloat16 parts, exact products), or H in two
    bfloat16 parts for C . H, does not — the case mamba2-130m's padded
    rows showed on the card.  B 1, 3 heads, T 600, hd 64, ds 128, chunk
    256, dt 0.0012, A -16, -4, -1."""
    T, nh, hd, ds = 600, 3, 64, 128
    rng = np.random.default_rng(4)
    b0 = (0.5 * rng.standard_normal(ds)).astype(np.float32)
    r = (0.5 * rng.standard_normal(ds)).astype(np.float32)
    c0 = r - (r @ b0) / (b0 @ b0) * b0
    x0 = rng.standard_normal((nh, hd)).astype(np.float32)

    def bf(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)

    args = (bf(np.broadcast_to(x0[:, None], (nh, T, hd))),
            bf(np.broadcast_to(b0, (1, T, ds))),
            bf(np.broadcast_to(c0, (1, T, ds))),
            torch.full((nh, T), 0.0012),
            torch.full((nh, T), 0.0012)
            * torch.tensor([-16.0, -4.0, -1.0])[:, None])
    want = ssd_scan_plain(*args, 256)[0]

    def ratio(**kw):
        return bf16_err_ratio(tensor_core_emulation(*args, 256, **kw)[0],
                              want)

    kernel, tc_s, parts_h = ratio(), ratio(s_parts=3), ratio(h_parts=2)
    print(f"worst |err| / tolerance: kernel {kernel:.3g}, tensor-core S "
          f"{tc_s:.3g}, two-part H {parts_h:.3g}")
    assert kernel <= 1.0 < tc_s
    assert parts_h > 1.0


def test_wgmma_sum_truncates_its_accumulator():
    """The emulation of wgmma's float32 accumulation: each 16-deep
    product exact, each addition rounded toward zero.  One step is the
    exact product truncated: no larger in magnitude, less than an ulp
    off.  Two steps stay within an ulp of each partial sum, and differ
    from the round-to-nearest sum where a truncation moved it (of 4096
    random sums, some must)."""
    from repro_torch.kernels.ssd_scan.emulate import wgmma_sum

    def ulp(v):
        v = v.abs()
        return (torch.nextafter(v, torch.full_like(v, float("inf")))
                - v).double()

    g = torch.Generator().manual_seed(7)
    a = torch.randn((64, 32), generator=g).to(torch.bfloat16).float()
    b = torch.randn((32, 64), generator=g).to(torch.bfloat16).float()
    exact1 = a[:, :16].double() @ b[:16].double()
    one = wgmma_sum(a[:, :16], b[:16])
    assert torch.all(one.double().abs() <= exact1.abs())
    assert torch.all((one.double() - exact1).abs() < ulp(one))
    exact = a.double() @ b.double()
    two = wgmma_sum(a, b)
    assert torch.all((two.double() - exact).abs() <= ulp(one) + ulp(two))
    assert torch.any(two != exact.float())


@pytest.mark.parametrize("dtype,hd,ds,T,chunk,tc", [
    ("bfloat16", 64, 128, 2048, 256, True),    # mamba2-130m's long prefill
    ("bfloat16", 64, 128, 11, 256, True),      # a short prompt: one chunk
    ("bfloat16", 64, 64, 300, 128, True),
    ("bfloat16", 64, 128, 300, 100, False),    # chunks not 64-aligned
    ("bfloat16", 64, 128, 600, 512, False),    # chunk past 256
    ("bfloat16", 32, 128, 2048, 256, False),   # head dim
    ("bfloat16", 64, 32, 2048, 256, False),    # state dim
    ("float32", 64, 128, 2048, 256, False),    # float32: SIMT
])
def test_tensor_core_path_rule(dtype, hd, ds, T, chunk, tc):
    """Which CUDA launches take the tensor-core path: a rule of dtype and
    shape alone, never a retry after a failure."""
    from repro_torch.kernels.ssd_scan import ops

    assert ops.uses_tensor_cores(getattr(torch, dtype), hd, ds, T,
                                 chunk) is tc


def test_head_groups_fill_the_card():
    """The chunk scan splits a row's heads into the fewest groups that
    give a block per SM: 2 at the long prefill (128 blocks), every head
    its own block for a short prompt (4 blocks), never more than G."""
    from repro_torch.kernels.ssd_scan import ops

    assert ops.head_groups(4, 24, 2048, 256) == 2
    assert ops.head_groups(4, 24, 11, 11) == 24
    assert ops.head_groups(1, 3, 11, 11) == 3
    assert ops.head_groups(64, 24, 4096, 256) == 1
