"""The batched engine at any die count a channel, on the card as on the CPU.

The CUDA shard-core kernel runs a lane of any number of dies: 8, 16, 32
and 64 slots are instances with their die state in static shared
memory, wider lanes take the generic instance with its die state beside
the rings.  So ``resolve_engine`` picks the batched engine for every
ring-lowerable config on a CUDA device, as the reference does, and no
refusal names a die count.  The launch refuses only a lane of no dies
and ring capacities that are not powers of two.  No card is needed:
resolution reads only the device's type, and the launch's checks come
before anything touches a device.
"""

import dataclasses

import pytest
import torch

import repro_torch.flashsim as TF
from repro_torch.flashsim.engine_batched import check_batched_config
from repro_torch.kernels.fcfs_core import ops as fcfs_ops

WIDE = dataclasses.replace(TF.DEFAULT_SSD, dies_per_channel=32)


@pytest.mark.parametrize("dies", [17, 24, 32, 64, 256])
def test_cuda_device_takes_any_die_count(dies):
    cfg = dataclasses.replace(TF.DEFAULT_SSD, dies_per_channel=dies)
    cuda = torch.device("cuda")
    assert TF.resolve_engine(cfg, device=cuda) == ("batched", "")
    assert TF.resolve_engine(cfg, device="cpu") == ("batched", "")
    check_batched_config(cfg, cuda)
    # what still falls back names its own reason, never the die count
    engine, reason = TF.resolve_engine(
        dataclasses.replace(cfg, scheduler="tokens"), device=cuda)
    assert engine == "array" and "scheduler" in reason
    assert "dies" not in reason and str(dies) not in reason


def test_no_device_means_the_card(monkeypatch):
    """``device=None`` resolves as every entry point resolves it: the
    CUDA card; without a card it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TF.resolve_engine(WIDE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert TF.resolve_engine(WIDE) == ("batched", "")
    assert TF.resolve_engine(TF.DEFAULT_SSD) == ("batched", "")


@pytest.mark.parametrize("n_dies,capq,capw,match", [
    (0, 4, 4, "at least one die"), (-3, 4, 4, "at least one die"),
    (32, 6, 4, "power-of-two"), (100, 4, 12, "power-of-two")])
def test_kernel_launch_refuses_only_bad_arguments(n_dies, capq, capw, match):
    """The launch path refuses a lane of no dies and ring capacities
    that are not powers of two, before anything touches the card; any
    die count is taken."""
    ops = torch.zeros((1, 4, 10), dtype=torch.float64)
    timing = torch.zeros((1, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match=match):
        fcfs_ops._launch_cuda(ops, timing, 1, n_dies=n_dies, capq=capq,
                              capw=capw, prio=False)
