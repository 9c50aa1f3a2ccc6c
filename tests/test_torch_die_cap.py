"""The shard-core kernel's die cap, on the CUDA launch path only.

The CUDA shard-core kernel holds at most ``MAX_DIES`` (16) dies a lane;
the plain core on the CPU, like the reference, has no cap (the
32-dies-per-channel cell runs batched on the CPU and matches the
reference in ``tests/test_torch_flashsim.py``).  On a CUDA device
``engine="auto"`` resolves to the array engine and records why, and
``engine="batched"`` raises ``BatchedUnsupported`` naming the cap.  No
card is needed: resolution reads only the device's type.
"""

import dataclasses

import pytest
import torch

import repro_torch.flashsim as TF
from repro_torch.flashsim.engine_batched import check_batched_config
from repro_torch.kernels.fcfs_core import ops as fcfs_ops

WIDE = dataclasses.replace(TF.DEFAULT_SSD, dies_per_channel=32)


def test_cuda_device_records_the_cap_instead_of_raising():
    cuda = torch.device("cuda")
    engine, reason = TF.resolve_engine(WIDE, device=cuda)
    assert engine == "array"
    assert f"at most {fcfs_ops.MAX_DIES} dies per channel" in reason
    assert "got 32" in reason and "engine='array'" in reason
    with pytest.raises(TF.BatchedUnsupported, match="die slots"):
        check_batched_config(WIDE, cuda)
    # The cap is the card's alone, and the default 8 dies fit it.
    assert TF.resolve_engine(WIDE, device="cpu") == ("batched", "")
    assert TF.resolve_engine(TF.DEFAULT_SSD, device=cuda) == ("batched", "")


def test_no_device_means_the_card(monkeypatch):
    """``device=None`` resolves as every entry point resolves it: the
    CUDA card, which holds the cap; without a card it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TF.resolve_engine(WIDE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    engine, reason = TF.resolve_engine(WIDE)
    assert engine == "array" and "die slots" in reason
    assert TF.resolve_engine(TF.DEFAULT_SSD) == ("batched", "")


def test_kernel_launch_keeps_its_cap():
    """The cap is checked on the CUDA launch path, before anything
    touches the card."""
    ops = torch.zeros((1, 4, 10), dtype=torch.float64)
    timing = torch.zeros((1, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="at most 16 dies"):
        fcfs_ops._launch_cuda(ops, timing, 1, n_dies=32, capq=4, capw=4,
                              prio=False)
