"""Dispatch wrapper for the Mamba-2 SSD chunked scan.

:func:`ssd_scan_fwd` takes the kernel layout — x (BH, T, hd), B and C
(BG, T, ds) shared by the BH / BG heads of a batch row, dt and dA = dt·A
(BH, T) float32 — and picks the implementation by the tensors' device:

  * CUDA tensors launch a hand-written kernel of ``csrc/ssd_scan.cu``
    (built with nvcc at first use) — or raise; there is no fallback.
    The path is chosen by dtype and shape, never by retrying after a
    failure (:func:`uses_tensor_cores`): bfloat16 at hd 64, ds 64 or
    128, with chunks of at most 256 tokens that are a multiple of 64
    long (or a single chunk, L = T) runs the tensor-core path (four
    kernels: the chunk states, the state passing and the scores in
    float32 SIMT, then the chunk scan, its w' . x by ``wgmma`` on
    TMA-loaded x); float32, and bfloat16 at any other width the
    kernel takes (hd 16, 32 or 128, ds a multiple of 4, other chunk
    lengths), runs the SIMT kernel;
  * CPU tensors run the plain torch version
    (:func:`repro_torch.kernels.ssd_scan.plain.ssd_scan_plain`).

:func:`ssd_scan` is the model-layout adapter of the reference's
``ops.ssd_scan``: x (B, T, nh, hd) becomes ``bh = b*nh + h`` rows, dA is
formed outside the kernel as the reference forms it, and B and C stay
(B, T, ds).  With ``training=True`` it runs the reference's training
mode on every device: the plain scan, differentiated by autograd (the
reference trains through its non-kernel ``ssd_chunked``; the TPU kernel
has no backward, and neither has B5).  The kernel is launched through
ctypes on raw pointers, so its outputs carry no ``grad_fn``: on the
card ``ssd_scan_fwd`` raises where grad is enabled and an input
requires it, rather than detach every parameter upstream of the scan.
``launches`` counts the calls of :func:`ssd_scan_fwd` that
launched on CUDA (one per call, whichever path), and nothing else;
``tc_launches`` counts those that took the tensor-core path.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.device import require_local, resolve_device
from repro_torch.kernels.ssd_scan.plain import ssd_scan_plain

#: CUDA launches of the SSD scan kernel in this process.
launches = 0
#: Of those, the launches of the bfloat16 tensor-core path.
tc_launches = 0

_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
#: Head dims the kernel is instantiated for.
HEAD_DIMS = (16, 32, 64, 128)
#: Shared memory a block may use on Hopper, in bytes.
MAX_SMEM = 232448
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The tensor-core path's widths and longest chunk.
TC_HEAD_DIM = 64
TC_STATE_DIMS = (64, 128)
TC_MAX_CHUNK = 256
#: Blocks the chunk scan aims to fill: the H100's SMs, one block each.
SMS = 132


def uses_tensor_cores(dtype: torch.dtype, hd: int, ds: int, T: int,
                      chunk: int) -> bool:
    """Whether a CUDA launch at these widths takes the tensor-core path:
    bfloat16, hd 64, ds 64 or 128, and chunks L = min(chunk, T) of at
    most 256 tokens that are a multiple of 64 long unless one chunk
    holds all of T (its key tiles then never reach into a next chunk)."""
    L = min(chunk, T)
    return (dtype == torch.bfloat16 and hd == TC_HEAD_DIM
            and ds in TC_STATE_DIMS and L <= TC_MAX_CHUNK
            and (L % 64 == 0 or L == T))


def head_groups(BG: int, G: int, T: int, L: int) -> int:
    """Groups the chunk scan splits a batch row's G heads into, one block
    each: the fewest that give at least one block per SM, so a short
    prompt's few (row, chunk, query tile) blocks still fill the card.  At
    mamba2-130m's long prefill (128 blocks) that is 2, the fastest of 1,
    2, 3, 4 and 6 on the H100 (``tools/ssd_ablation.py``)."""
    blocks = BG * (-(-T // L)) * (-(-L // 64))
    return max(1, min(G, -(-SMS // blocks)))


def _lib():
    from repro_torch.kernels import build

    return build.load(_SOURCE)


def _kernel_fn():
    """The C entry point of the built kernel library, typed for ctypes."""
    fn = _lib().ssd_scan_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
    fn.restype = ci
    return fn


def _smem_bytes(hd: int, ds: int, L: int) -> int:
    fn = _lib().ssd_scan_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(hd, ds, L))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, starting on a 16-byte boundary (the kernel's vector
    loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


_TC_FN = None


def _tc_fn():
    """The tensor-core path's C entry point, typed for ctypes (once)."""
    global _TC_FN
    if _TC_FN is None:
        fn = _lib().ssd_scan_tc_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 11 + [ci] * 8 + [vp]
        fn.restype = ci
        _TC_FN = fn
    return _TC_FN


def _tc_launcher(x, Bm, Cm, dt, dA, chunk, n_hg):
    """Outputs ``(y, H)`` of the tensor-core path, and a callable that
    launches the kernels of a stage mask (1 the chunk states, 2 the state
    passing, 4 the scores, 8 the chunk scan) on them, on the current
    stream; it raises if a launch fails.  The scratch — the chunk states
    S (BH, nc, ds, hd), the scores (BG, nc, n_pairs, 64 * 64) of the
    chunks' (query tile, key tile <= it) pairs, cum (BH, nc * L) and the
    chunks' incoming states (BH, nc - 1, ds, hd), all float32 — is one
    allocation cut at offsets (multiples of 16 bytes), since every tensor
    op costs the host microseconds on a call that short prompts make 24
    times a prefill."""
    BH, T, hd = x.shape
    BG, _, ds = Bm.shape
    G, L = BH // BG, min(chunk, T)
    nc = -(-T // L)
    n_qt = -(-L // 64)
    dev = x.device
    y = torch.empty(x.shape, dtype=x.dtype, device=dev)
    H = torch.empty((BH, ds, hd), dtype=torch.float32, device=dev)
    n_s = BH * nc * ds * hd if nc > 1 else 0        # one chunk: S is H
    n_strip = BG * nc * (n_qt * (n_qt + 1) // 2) * 64 * 64
    n_cum = -(-BH * nc * L // 4) * 4
    scratch = torch.empty(n_s + n_strip + n_cum + BH * (nc - 1) * ds * hd,
                          dtype=torch.float32, device=dev)
    S = scratch.data_ptr()
    strip = S + 4 * n_s
    cum = strip + 4 * n_strip
    Hp = cum + 4 * n_cum
    n_hg = head_groups(BG, G, T, L) if n_hg is None else n_hg
    fn = _tc_fn()
    ptrs = [t.data_ptr() for t in (x, Bm, Cm, dt, dA, y, H)] + [S, Hp, cum,
                                                                 strip]

    def run(mask):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ptrs, BH, T, hd, ds, G, L, n_hg, mask, stream)
        if err != 0:
            raise RuntimeError(f"ssd_scan tensor-core kernels failed: CUDA "
                               f"error {err}")

    run.scratch = scratch        # kept alive as long as the callable
    return run, (y, H)


def tc_stage_launchers(x, Bm, Cm, dt, dA, chunk: int = 256,
                       n_hg: Optional[int] = None):
    """The tensor-core path's four kernels (the chunk states, the state
    passing, the scores, the chunk scan) as callables on one set of
    outputs and scratch, each launching its kernel alone — in this order
    they compute :func:`ssd_scan_fwd` — and the outputs ``(y, H)``: for
    timing each kernel, and the head-group split ``n_hg``.  Inputs as
    :func:`ssd_scan_fwd` takes them on CUDA; they do not count as
    launches."""
    BH, T, hd = x.shape
    ds = Bm.shape[-1]
    if not uses_tensor_cores(x.dtype, hd, ds, T, chunk):
        raise ValueError(f"no tensor-core path at {x.dtype}, hd {hd}, ds "
                         f"{ds}, T {T}, chunk {chunk}")
    run, out = _tc_launcher(*(_aligned(t) for t in (x, Bm, Cm, dt, dA)),
                            chunk, n_hg)
    return [lambda m=m: run(m) for m in (1, 2, 4, 8)], out


def _launch_cuda(x, Bm, Cm, dt, dA, chunk):
    """Launch the CUDA kernel on the current stream (no synchronize)."""
    global launches, tc_launches
    BH, T, hd = x.shape
    BG, _, ds = Bm.shape
    L = min(chunk, T)
    if uses_tensor_cores(x.dtype, hd, ds, T, chunk):
        run, out = _tc_launcher(x, Bm, Cm, dt, dA, chunk, None)
        run(15)
        launches += 1
        tc_launches += 1
        return out
    if hd not in HEAD_DIMS or ds % 4:
        raise ValueError(f"ssd_scan kernel takes head dims {HEAD_DIMS} and "
                         f"state dims that are multiples of 4, got hd {hd}, "
                         f"ds {ds}")
    smem = _smem_bytes(hd, ds, L)
    if smem > MAX_SMEM:
        raise ValueError(f"ssd_scan kernel needs {smem} bytes of shared "
                         f"memory at hd {hd}, ds {ds}, chunk {L}; a block "
                         f"has {MAX_SMEM}")
    fn = _kernel_fn()
    y = torch.empty_like(x)
    H = torch.empty((BH, ds, hd), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
             dA.data_ptr(), y.data_ptr(), H.data_ptr(), BH, T, hd, ds,
             BH // BG, L, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, H


def ssd_scan_fwd(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 dt: torch.Tensor, dA: torch.Tensor, chunk: int = 256):
    """The SSD scan in the kernel layout.

    x (BH, T, hd); Bm, Cm (BG, T, ds) with BH a multiple of BG (row
    ``bh`` reads row ``bh // (BH // BG)``); dt, dA (BH, T) float32; x,
    Bm and Cm share float32 or bfloat16, all on one device.  Returns
    (y (BH, T, hd) in x's dtype, H (BH, ds, hd) float32).
    """
    require_local("ssd_scan_fwd", x, Bm, Cm, dt, dA)
    if x.dim() != 3 or Bm.dim() != 3 or Cm.shape != Bm.shape:
        raise ValueError(f"x must be (BH, T, hd) and Bm, Cm (BG, T, ds), "
                         f"got {tuple(x.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    BH, T, hd = x.shape
    BG, T_b, _ = Bm.shape
    if T == 0 or T_b != T or BG == 0 or BH % BG:
        raise ValueError(f"x {tuple(x.shape)} does not group over Bm "
                         f"{tuple(Bm.shape)}")
    if dt.shape != (BH, T) or dA.shape != (BH, T) or \
            dt.dtype != torch.float32 or dA.dtype != torch.float32:
        raise ValueError(f"dt and dA must be ({BH}, {T}) float32, got "
                         f"{tuple(dt.shape)} {dt.dtype}, {tuple(dA.shape)} "
                         f"{dA.dtype}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"x, Bm, Cm must share float32 or bfloat16, got "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if not x.device == Bm.device == Cm.device == dt.device == dA.device:
        raise ValueError("x, Bm, Cm, dt and dA must share a device")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, Bm, Cm, dt, dA)):
            raise RuntimeError("ssd_scan's kernel has no backward; training "
                               "runs ssd_scan(..., training=True)")
        return _launch_cuda(*(_aligned(t) for t in (x, Bm, Cm, dt, dA)),
                            chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, Bm, Cm, dt, dA, chunk)
    raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")


def ssd_scan(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor, chunk: int = 256,
             device=None, training: bool = False):
    """The SSD scan in the model layout, on ``device`` (``None``: the
    CUDA card; inputs elsewhere are moved there).

    x (B, T, nh, hd); Bm, Cm (B, T, ds), shared across heads; dt (B, T,
    nh) post-softplus; A (nh,) negative.  Returns (y (B, T, nh, hd), H
    (B, nh, hd, ds) float32) — the interface of the reference's
    ``models/ssm.ssd_chunked``.  ``training``: the plain scan on every
    device, differentiable by autograd (the reference's training mode).
    """
    dev = resolve_device(device)
    x, Bm, Cm, dt, A = (t.to(dev) for t in (x, Bm, Cm, dt, A))
    B, T, nh, hd = x.shape
    ds = Bm.shape[-1]
    xh = x.permute(0, 2, 1, 3).reshape(B * nh, T, hd)
    dth = dt.permute(0, 2, 1).reshape(B * nh, T)
    dAh = dth * A.to(dth.dtype).repeat(B)[:, None]
    scan = ssd_scan_plain if training else ssd_scan_fwd
    y, H = scan(xh, Bm, Cm, dth, dAh, chunk=chunk)
    y = y.reshape(B, nh, T, hd).permute(0, 2, 1, 3)
    H = H.reshape(B, nh, ds, hd).permute(0, 1, 3, 2)
    return y, H
