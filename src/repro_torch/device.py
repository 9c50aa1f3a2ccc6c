"""Device resolution shared by every entry point of the port.

Entry points run on the CUDA card unless the caller names another
device.  ``device=None`` on a host without CUDA raises: the port never
falls back to the CPU silently, so a result always names the device it
ran on.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the CUDA card by default and found "
                "none; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def require_local(name: str, *tensors) -> None:
    """Kernel wrappers take plain local tensors, never a DTensor (a
    sharded step gathers weights and keeps activations local)."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name} takes local tensors, not DTensors")
