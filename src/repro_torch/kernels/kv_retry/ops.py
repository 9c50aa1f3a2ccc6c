"""Dispatch wrapper for the margin-aware KV retry read.

:func:`kv_retry_fwd` picks the implementation by the tensors' device:

  * CUDA tensors launch the hand-written kernel (``csrc/kv_retry.cu``,
    built with nvcc at first use) — or raise; there is no fallback;
  * CPU tensors run the plain torch version
    (:func:`repro_torch.kernels.kv_retry.plain.kv_retry_plain`).

Page widths that are a multiple of 16, up to 512, take the vector kernel
(``kv_retry_vec_kernel``: 16-byte loads, several pages in flight a
thread); any other multiple of 4 takes the warp-per-page kernel
(``kv_retry_kernel``).  Backing (and out) may be float32, bfloat16 or
int8: the in-model int8 KV cache (``REPRO_KV_INT8=1``) stores its k and
v leaves as int8, and the store reads them through this read as the
reference does.  On int8 backing a fast page is written as
``trunc(q * s)``, truncated toward zero as XLA's float-to-int8 convert
and torch's ``.to(torch.int8)`` do (not rounded); q * s must lie in
int8's range, as it does for pages that ``quantize_pages`` made of an
int8 leaf.  ``launches`` counts the CUDA kernel launches of this
process, and nothing else; ``vec_launches`` counts those of the vector
kernel among them, and ``int8_launches`` those on int8 backing.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.device import require_local, resolve_device
from repro_torch.kernels.kv_retry.plain import kv_retry_plain, quantize_pages

__all__ = ["kv_read_with_retry", "kv_retry_fwd", "quantize_pages"]

#: CUDA launches of the KV retry kernels in this process.
launches = 0
#: Of those, launches of the vector kernel.
vec_launches = 0
#: Of those, launches on int8 backing.
int8_launches = 0

#: The widest page the vector kernel takes.
MAX_VEC_WIDTH = 512

_SOURCE = Path(__file__).resolve().parent / "csrc" / "kv_retry.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def uses_vector(E: int) -> bool:
    """Whether a page width takes the vector kernel on the card."""
    return E % 16 == 0 and 0 < E <= MAX_VEC_WIDTH


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point of the built kernel library, typed for ctypes
    once."""
    from repro_torch.kernels import build

    fn = build.load(_SOURCE).kv_retry_launch
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    return fn


def _launch_cuda(data_q, scale, backing, tau, vector):
    """Launch the vector kernel (``vector``) or the warp-per-page kernel on the
    current stream (no synchronize)."""
    global launches, vec_launches, int8_launches
    P, E = backing.shape
    if vector and (data_q.data_ptr() % 16 or backing.data_ptr() % 16):
        raise ValueError("kv_retry's vector kernel takes int8 pages and "
                         "backing at 16-byte aligned addresses")
    out = torch.empty_like(backing)
    margin = torch.empty((P, 1), dtype=torch.float32, device=backing.device)
    stream = torch.cuda.current_stream(backing.device).cuda_stream
    err = _kernel_fn()(data_q.data_ptr(), scale.data_ptr(),
                       backing.data_ptr(), out.data_ptr(), margin.data_ptr(),
                       P, E, float(tau), _DTYPES[backing.dtype],
                       int(vector), stream)
    if err != 0:
        raise RuntimeError(f"kv_retry kernel launch failed: CUDA error {err}")
    launches += 1
    vec_launches += bool(vector)
    int8_launches += backing.dtype == torch.int8
    return out, margin


def kv_retry_fwd(data_q: torch.Tensor, scale: torch.Tensor,
                 backing: torch.Tensor, tau: float = 0.02):
    """Fast read with retry on device tensors.

    data_q (P, E) int8, scale (P, 1) float32, backing (P, E) float32,
    bfloat16 or int8, on one device; on the card E must be a multiple of
    4, and a multiple of 16 up to 512 takes the vector kernel.
    Returns (out (P, E) in backing's dtype, margin (P, 1) float32).
    """
    require_local("kv_retry_fwd", data_q, scale, backing)
    if data_q.dim() != 2 or data_q.dtype != torch.int8:
        raise ValueError(f"data_q must be (P, E) int8, got "
                         f"{tuple(data_q.shape)} {data_q.dtype}")
    P, E = data_q.shape
    if backing.shape != (P, E) or backing.dtype not in _DTYPES:
        raise ValueError(f"backing must be ({P}, {E}) float32, bfloat16 or "
                         f"int8, got {tuple(backing.shape)} {backing.dtype}")
    if scale.shape != (P, 1) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be ({P}, 1) float32, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if not data_q.device == scale.device == backing.device:
        raise ValueError("data_q, scale and backing must share a device")
    if backing.device.type == "cuda":
        if E % 4:
            raise ValueError(f"kv_retry kernel takes page widths that are "
                             f"multiples of 4, got {E}")
        return _launch_cuda(data_q.contiguous(), scale.contiguous(),
                            backing.contiguous(), tau,
                            uses_vector(E))
    if backing.device.type == "cpu":
        return kv_retry_plain(data_q, scale, backing, tau)
    raise ValueError(f"kv_retry runs on cuda or cpu, not {backing.device}")


def kv_read_with_retry(data_q, scale, backing, tau: float = 0.02,
                       device=None):
    """Margin-aware fast read with retry, on ``device`` (``None``: the
    CUDA card; inputs elsewhere are moved there)."""
    dev = resolve_device(device)
    return kv_retry_fwd(data_q.to(dev), scale.to(dev), backing.to(dev),
                        tau=tau)
