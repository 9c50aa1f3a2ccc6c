"""Dispatch wrapper for the Mamba-2 SSD chunked scan.

:func:`ssd_scan_fwd` takes the kernel layout — x (BH, T, hd), B and C
(BG, T, ds) shared by the BH / BG heads of a batch row, dt and dA = dt·A
(BH, T) float32 — and picks the implementation by the tensors' device:

  * CUDA tensors launch the hand-written kernel (``csrc/ssd_scan.cu``,
    built with nvcc at first use) — or raise; there is no fallback;
  * CPU tensors run the plain torch version
    (:func:`repro_torch.kernels.ssd_scan.plain.ssd_scan_plain`).

:func:`ssd_scan` is the model-layout adapter of the reference's
``ops.ssd_scan``: x (B, T, nh, hd) becomes ``bh = b*nh + h`` rows, dA is
formed outside the kernel as the reference forms it, and B and C stay
(B, T, ds).  ``launches`` counts the CUDA kernel launches of this
process, and nothing else.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ssd_scan.plain import ssd_scan_plain

#: CUDA launches of the SSD scan kernel in this process.
launches = 0

_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
#: Head dims the kernel is instantiated for.
HEAD_DIMS = (16, 32, 64, 128)
#: Shared memory a block may use on Hopper, in bytes.
MAX_SMEM = 232448
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _launch_cuda(x, Bm, Cm, dt, dA, chunk):
    """Launch the CUDA kernel on the current stream (no synchronize)."""
    global launches
    BH, T, hd = x.shape
    BG, _, ds = Bm.shape
    L = min(chunk, T)
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
        return _launch_cuda(*(_aligned(t) for t in (x, Bm, Cm, dt, dA)),
                            chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, Bm, Cm, dt, dA, chunk)
    raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")


def ssd_scan(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor, chunk: int = 256,
             device=None):
    """The SSD scan in the model layout, on ``device`` (``None``: the
    CUDA card; inputs elsewhere are moved there).

    x (B, T, nh, hd); Bm, Cm (B, T, ds), shared across heads; dt (B, T,
    nh) post-softplus; A (nh,) negative.  Returns (y (B, T, nh, hd), H
    (B, nh, hd, ds) float32) — the interface of the reference's
    ``models/ssm.ssd_chunked``.
    """
    dev = resolve_device(device)
    x, Bm, Cm, dt, A = (t.to(dev) for t in (x, Bm, Cm, dt, A))
    B, T, nh, hd = x.shape
    ds = Bm.shape[-1]
    xh = x.permute(0, 2, 1, 3).reshape(B * nh, T, hd)
    dth = dt.permute(0, 2, 1).reshape(B * nh, T)
    dAh = dth * A.to(dth.dtype).repeat(B)[:, None]
    y, H = ssd_scan_fwd(xh, Bm, Cm, dth, dAh, chunk=chunk)
    y = y.reshape(B, nh, T, hd).permute(0, 2, 1, 3)
    H = H.reshape(B, nh, ds, hd).permute(0, 1, 3, 2)
    return y, H
