"""Meshes over the ranks of the default process group (functions, so
importing touches no device and no process group).

The reference's production meshes are 16 x 16 chips, or 2 x 16 x 16
with a "pod" axis that extends data parallelism; here a mesh axis is a
dimension of a ``DeviceMesh`` over ``torch.distributed`` ranks, one
device each.  On the card the mesh is ``"cuda"`` over NCCL; on the CPU
(``device="cpu"``) ``"cpu"`` over gloo.  Neither falls back to the
other.
"""

from __future__ import annotations

import math
import os
import tempfile
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device

#: Backend of the process group on each device type.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def mesh_device_type(device=None) -> str:
    """``"cuda"`` (the default: the card) or ``"cpu"``."""
    kind = resolve_device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"meshes run on cuda or cpu, not {kind}")
    return kind


def init_process_group(device=None, store_path: Optional[str] = None
                       ) -> Tuple[int, int]:
    """Join (or open) the default process group on ``device``'s backend:
    ``torchrun``'s ``RANK``/``WORLD_SIZE`` and its rendezvous when they
    are set, else one rank over a ``FileStore`` at ``store_path`` (a new
    temporary file by default).  Returns (rank, world size)."""
    kind = mesh_device_type(device)
    if dist.is_initialized():
        if dist.get_backend() != BACKENDS[kind]:
            raise RuntimeError(f"the process group runs "
                               f"{dist.get_backend()}, not {BACKENDS[kind]}")
        return dist.get_rank(), dist.get_world_size()
    if kind == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(BACKENDS[kind])
    else:
        if store_path is None:
            fd, store_path = tempfile.mkstemp(prefix="repro_torch_store_")
            os.close(fd)
            os.unlink(store_path)
        store = dist.FileStore(store_path, 1)
        dist.init_process_group(BACKENDS[kind], store=store, rank=0,
                                world_size=1)
    return dist.get_rank(), dist.get_world_size()


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "launch.mesh.init_process_group first")
    return dist.get_world_size()


def make_host_mesh(model_parallel: int = 1, device=None):
    """A ("data", "model") mesh over every rank of the default group,
    ``model_parallel`` ranks along "model"."""
    n = _world()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model-parallel "
                         f"groups of {model_parallel}")
    return make_mesh((n // model_parallel, model_parallel), device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single-pod 16 x 16 (256 ranks) or 2-pod 2 x 16 x 16 (512 ranks).
    The "pod" axis extends data parallelism."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return make_mesh((16, 16), ("data", "model"), device)


def make_mesh(shape, axis_names=("data", "model"), device=None):
    """A mesh of ``shape`` over every rank of the default group (one
    device a rank)."""
    kind = mesh_device_type(device)
    need, n = math.prod(shape), _world()
    if n != need:
        raise RuntimeError(
            f"the {'x'.join(map(str, shape))} mesh ({', '.join(axis_names)}) "
            f"needs {need} ranks, one device each; the process group has {n}")
    return init_device_mesh(kind, tuple(shape),
                            mesh_dim_names=tuple(axis_names))
