"""Dispatch wrapper for the RBER table.

:func:`rber_fwd` picks the implementation by the tensors' device:

  * CUDA tensors launch the hand-written kernel (``csrc/rber.cu``, built
    with nvcc at first use) — or raise; there is no fallback;
  * CPU tensors run the plain torch version
    (:func:`repro_torch.kernels.rber.plain.rber_plain`).

:func:`rber_table` is the entry of the reference's
``kernels/rber/ops.py::rber_table``.  ``launches`` counts the CUDA kernel
launches of this process, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.rber.plain import rber_plain

#: CUDA launches of the RBER kernel in this process.
launches = 0

_SOURCE = Path(__file__).resolve().parent / "csrc" / "rber.cu"


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point of the built kernel library, typed for ctypes
    once."""
    from repro_torch.kernels import build

    fn = build.load(_SOURCE).rber_launch
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    return fn


def _launch_cuda(mu, sigma, levels):
    """Launch the CUDA kernel on the current stream (no synchronize)."""
    global launches
    N, S = mu.shape[0], levels.shape[0]
    out = torch.empty((3, N, S), dtype=torch.float32, device=mu.device)
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    err = _kernel_fn()(mu.data_ptr(), sigma.data_ptr(), levels.data_ptr(),
             out.data_ptr(), N, S, stream)
    if err != 0:
        raise RuntimeError(f"rber kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def rber_fwd(mu: torch.Tensor, sigma: torch.Tensor,
             levels: torch.Tensor) -> torch.Tensor:
    """mu, sigma (N, 8) and levels (S, 7), float32 on one device ->
    (3, N, S) float32 (lsb, csb, msb)."""
    if mu.dim() != 2 or mu.shape[1] != 8 or sigma.shape != mu.shape:
        raise ValueError(f"mu and sigma must be (N, 8), got "
                         f"{tuple(mu.shape)}, {tuple(sigma.shape)}")
    if levels.dim() != 2 or levels.shape[1] != 7:
        raise ValueError(f"levels must be (S, 7), got {tuple(levels.shape)}")
    if not mu.dtype == sigma.dtype == levels.dtype == torch.float32:
        raise ValueError(f"mu, sigma, levels must be float32, got "
                         f"{mu.dtype}, {sigma.dtype}, {levels.dtype}")
    if not mu.device == sigma.device == levels.device:
        raise ValueError("mu, sigma and levels must share a device")
    if mu.device.type == "cuda":
        return _launch_cuda(mu.contiguous(), sigma.contiguous(),
                            levels.contiguous())
    if mu.device.type == "cpu":
        return rber_plain(mu, sigma, levels)
    raise ValueError(f"rber runs on cuda or cpu, not {mu.device}")


def rber_table(mu, sigma, levels, device=None) -> torch.Tensor:
    """(N, 8), (N, 8), (S, 7) -> (3, N, S) float32 RBER, on ``device``
    (``None``: the CUDA card; inputs elsewhere are moved there)."""
    dev = resolve_device(device)
    return rber_fwd(*(torch.as_tensor(t, dtype=torch.float32).to(dev)
                      for t in (mu, sigma, levels)))
