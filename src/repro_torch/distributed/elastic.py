"""Elastic re-mesh: resume a checkpoint on a degraded (or grown) fleet.

The reference's ``repro.distributed.elastic`` over ``torch.distributed``.
Placements are logical (:mod:`repro_torch.distributed.sharding` derives
them from axis rules and a mesh), so elasticity is a plan, not a
migration: given the new rank count, pick the (data, model)
factorization, rebuild the placements from the same rules, and place the
host-restored checkpoint (checkpoints restore to host tensors precisely
so the target mesh can differ from the source mesh).

Constraints honoured by :func:`plan_mesh`:
  * the ``model`` axis is kept where the new world size allows it
    (changing the TP degree re-partitions every weight);
  * ``data`` takes the remaining factor; where the global batch does not
    divide it, the plan reports the gradient-accumulation factor.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    tp_preserved: bool
    grad_accum_factor: int
    note: str

    def describe(self) -> str:
        return (
            f"{'x'.join(map(str, self.old_shape))} -> "
            f"{'x'.join(map(str, self.new_shape))} ({'.'.join(self.axis_names)}); "
            f"tp_preserved={self.tp_preserved} "
            f"grad_accum x{self.grad_accum_factor}; {self.note}"
        )


def _largest_divisor_leq(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def plan_mesh(
    n_devices: int,
    old_mesh_shape: Tuple[int, ...] = (16, 16),
    axis_names: Tuple[str, ...] = ("data", "model"),
    global_batch: int = 256,
) -> ElasticPlan:
    """Choose (data, model) for the new world size."""
    old_model = old_mesh_shape[-1]
    if n_devices % old_model == 0:
        model = old_model
        tp_preserved = True
        note = "model axis kept; only data-parallel width changed"
    else:
        model = _largest_divisor_leq(n_devices, old_model)
        tp_preserved = False
        note = "model axis re-factored (full weight reshard on restore)"
    data = n_devices // model
    accum = 1
    if global_batch % data != 0:
        # per-replica batch must be integral: accumulate
        per = max(global_batch // data, 1)
        accum = -(-global_batch // (per * data))
        note += f"; batch {global_batch} !% data {data}"
    return ElasticPlan(
        old_shape=tuple(old_mesh_shape),
        new_shape=(data, model),
        axis_names=tuple(axis_names[-2:]),
        tp_preserved=tp_preserved,
        grad_accum_factor=accum,
        note=note,
    )


def build_mesh_from_plan(plan: ElasticPlan, device=None):
    """The plan's mesh over the ranks of the default process group."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(plan.new_shape, plan.axis_names, device=device)


def reshard_state(state, mesh, placements):
    """Place a host-restored state (numpy arrays or tensors, the same on
    every rank) on ``mesh``: each leaf becomes a DTensor on its
    placements, each rank keeping its own shard (no communication; never
    sharing memory with ``state``); a leaf whose placements are ``None``
    (the step count) stays a plain tensor on the mesh's device."""
    from repro_torch.distributed.sharding import map_with_path

    flat = {}
    map_with_path(lambda path, pl: flat.__setitem__(path, pl), placements)

    def put(path, x):
        t = x.detach() if isinstance(x, torch.Tensor) else \
            torch.as_tensor(np.asarray(x))
        if flat[path] is None:
            return t.to(mesh.device_type, copy=True)
        d = distribute_tensor(t.to(mesh.device_type), mesh, flat[path],
                              src_data_rank=None)
        if d.to_local().data_ptr() == t.data_ptr():   # replicated: a view
            d = d.clone()
        return d

    return map_with_path(put, state)
