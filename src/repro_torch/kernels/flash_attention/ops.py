"""Dispatch wrapper for the flash-attention forward kernel.

:func:`flash_attention_fwd` takes the kernel layout — q (BH, T, hd),
k and v (BK, S, hd) — and picks the implementation by the tensors'
device:

  * CUDA tensors launch a hand-written kernel of
    ``csrc/flash_attention.cu`` (built with nvcc at first use), by a
    fixed rule on dtype and head dim: bfloat16 at hd 64, 128 or 256 the
    tensor-core kernel (``wgmma`` and TMA), bfloat16 at hd 16 or 32 and
    float32 at every hd of ``HEAD_DIMS`` the SIMT kernel; every tensor's
    base 16-byte aligned, else it raises.  Other head dims raise; no
    kernel falls back to another, nor to the plain version;
  * CPU tensors run the plain torch version
    (:func:`repro_torch.kernels.flash_attention.plain.flash_attention_plain`).

:func:`flash_attention` is the model-layout adapter of the reference's
``ops.flash_attention``: q (B, T, K, G, hd) and k, v (B, S, K, hd) are
flattened to ``bh = (b*K + k)*G + g`` query rows over ``b*K + k`` kv
rows.  ``launches`` counts the CUDA kernel launches of this process, and
nothing else; ``tc_launches`` counts those of the tensor-core kernel,
``small_hd_launches`` those at a head dim below 64 (the reduced
configs' 16: the SIMT kernel in either dtype).

:func:`flash_attention_fwd` checks its inputs and calls the custom op
``torch.ops.repro_torch.flash_attention``: its CUDA implementation is
the kernel's launch, its CPU implementation the plain version, its fake
implementation (:func:`_fake`) the launch's output (shape, dtype,
strides) without a device, and its FLOP formula (:func:`_flops`) the
reference dry-run's analytic count, so ``FlopCounterMode`` and fake
tensors trace a prefill through the kernel (``launch.cost``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.device import require_local, resolve_device
from repro_torch.kernels.flash_attention.plain import flash_attention_plain

#: CUDA launches of the flash-attention kernels in this process.
launches = 0
#: Of those, the launches of the bfloat16 tensor-core kernel.
tc_launches = 0
#: Of those, the launches at a head dim below ``TC_MIN_HEAD_DIM``.
small_hd_launches = 0

_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
#: Head dims the kernels take (the single list of what the card runs).
HEAD_DIMS = (16, 32, 64, 128, 256)
#: bfloat16 heads at least this wide take the tensor-core kernel.
TC_MIN_HEAD_DIM = 64
_DTYPES = (torch.float32, torch.bfloat16)


def uses_tensor_cores(dtype: torch.dtype, hd: int) -> bool:
    """Whether a CUDA launch takes the tensor-core kernel: bfloat16 at a
    head dim of at least 64; the rest of ``HEAD_DIMS`` runs the SIMT
    kernel."""
    return dtype == torch.bfloat16 and hd >= TC_MIN_HEAD_DIM


def _entry(dtype: torch.dtype, hd: int) -> str:
    """The C entry point of the kernel for ``dtype`` and ``hd``."""
    if uses_tensor_cores(dtype, hd):
        return "fa_fwd_tc_launch"
    return "fa_fwd_f32_launch" if dtype == torch.float32 else \
        "fa_fwd_simt_bf16_launch"


def _kernel_fn(entry):
    """The C entry point ``entry`` of the built kernel library, typed for
    ctypes."""
    from repro_torch.kernels import build

    fn = getattr(build.load(_SOURCE), entry)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci,
                   ctypes.c_float, ci, ctypes.c_float, ci, vp]
    fn.restype = ci
    return fn


def _launch_cuda(q, k, v, causal, window, softcap, kv_valid, q_offset=0):
    """Launch the CUDA kernel of q's dtype on the current stream (no
    synchronize); query row t at position ``q_offset + t``."""
    global launches, tc_launches, small_hd_launches
    BH, T, hd = q.shape
    BK, S, _ = k.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {hd}")
    out = torch.empty_like(q)
    tc = uses_tensor_cores(q.dtype, hd)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("the flash_attention kernels load by TMA or in "
                         "vectors and need 16-byte aligned q, k, v")
    fn = _kernel_fn(_entry(q.dtype, hd))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             BH, T, S, BK, hd, int(causal),
             int(window is not None), 0 if window is None else int(window),
             kv_valid, hd ** -0.5, int(softcap is not None),
             0.0 if softcap is None else float(softcap), int(q_offset),
             stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    tc_launches += int(tc)
    small_hd_launches += int(hd < TC_MIN_HEAD_DIM)
    return out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        kv_valid: Optional[int] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Forward attention in the kernel layout.

    q (BH, T, hd), k and v (BK, S, hd), one dtype (float32 or bfloat16)
    on one device, BH a multiple of BK.  Keys at or past ``kv_valid``
    are padding.  Query row t sits at position ``q_offset + t`` (a
    context-parallel shard's rows of a longer sequence; the causal and
    window masks take it).  Returns (BH, T, hd) in q's dtype.
    """
    require_local("flash_attention_fwd", q, k, v)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"q must be (BH, T, hd) and k, v (BK, S, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, T, hd = q.shape
    BK, S, hd_k = k.shape
    if hd_k != hd or BK == 0 or BH % BK:
        raise ValueError(f"q {tuple(q.shape)} does not group over k "
                         f"{tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must share a device")
    if q.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"flash_attention runs on cuda or cpu (meta: "
                         f"shapes only), not {q.device}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    return torch.ops.repro_torch.flash_attention(
        q, k, v, causal, window, None if softcap is None else float(softcap),
        None if kv_valid is None else int(kv_valid), int(q_offset))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: Optional[int],
                        softcap: Optional[float],
                        kv_valid: Optional[int],
                        q_offset: int = 0) -> torch.Tensor:
    """The custom op on CUDA tensors: the kernel's launch."""
    S = k.shape[1]
    kv = S if kv_valid is None else max(0, min(kv_valid, S))
    return _launch_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=causal, window=window, softcap=softcap,
                        kv_valid=kv, q_offset=q_offset)


@_flash_attention_op.register_kernel("cpu")
def _(q, k, v, causal, window, softcap, kv_valid, q_offset=0):
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 softcap=softcap, kv_valid=kv_valid,
                                 q_offset=q_offset)


@_flash_attention_op.register_fake
def _fake(q, k, v, causal, window, softcap, kv_valid, q_offset=0):
    """The launch's output: (BH, T, hd) in q's dtype, contiguous."""
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, causal, window, softcap, kv_valid,
           *args, **kwargs) -> int:
    """The reference dry-run's count (``launch/hlo_cost.py``'s
    ``_opaque_kernel_cost``): ``4 BH T hd S_eff frac`` (BH = B K G), with
    ``S_eff = min(window, S)`` and ``frac`` 1 for a window, else S and ½
    causal, 1 not.  ``kv_valid`` and ``q_offset`` do not enter it, as
    the reference's stand-in has neither: a context-parallel shard is
    counted on its own shapes, as the stand-in is inside its
    ``shard_map``."""
    BH, T, hd = q_shape
    S = k_shape[1]
    if window is not None:
        return 4 * BH * T * hd * min(window, S)
    return 4 * BH * T * hd * S // (2 if causal else 1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    kv_valid: Optional[int] = None,
                    device=None, q_offset: int = 0) -> torch.Tensor:
    """Attention in the model layout, on ``device`` (``None``: the CUDA
    card; inputs elsewhere are moved there).

    q (B, T, K, G, hd), k and v (B, S, K, hd); query t at position
    ``q_offset + t``.  Returns (B, T, K, G, hd) on ``device``.
    """
    dev = resolve_device(device)
    q, k, v = (t.to(dev) for t in (q, k, v))
    B, T, K, G, hd = q.shape
    S = k.shape[1]
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * K * G, T, hd)
    kf = k.permute(0, 2, 1, 3).reshape(B * K, S, hd)
    vf = v.permute(0, 2, 1, 3).reshape(B * K, S, hd)
    of = flash_attention_fwd(qf, kf, vf, causal=causal, window=window,
                             softcap=softcap, kv_valid=kv_valid,
                             q_offset=q_offset)
    return of.reshape(B, K, G, T, hd).permute(0, 3, 1, 2, 4)
