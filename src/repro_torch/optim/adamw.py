"""AdamW with dtype-configurable moments and global-norm clipping.

The reference's optimizer (``repro.optim.adamw``) on nested dicts (and
lists) of tensors, under ``torch.no_grad``.  The update of a leaf rounds
where XLA's CPU fusion of the reference's ``upd`` rounds:

  m' = fma(m, b1, g (1 - b1))          v' = fma(v, b2, g^2 (1 - b2))
  p' = fma(-lr, fma(p, wd, m' / (c1 (sqrt(v' / c2) + eps))), p)

with ``c = 1 - b ** step`` by the C library's ``powf`` and ``sqrt`` and
the fused steps from :mod:`repro_torch.core.xla_math`.  The global norm
sums in torch's order, so it (and the clip scale) can differ from the
reference's by an ulp.

Unlike the reference, :func:`adamw_update` updates ``params`` and the
moments in place (a 3B-parameter state would not fit twice on one
card), in blocks of :data:`BLOCK` elements, and returns them.

Sharded trees (DTensor leaves, ``repro_torch.distributed``): the update
is elementwise, so it runs on each rank's local shards; the global norm
sums every element's square once across the mesh (one all-reduce over
each mesh dim of the local sums, a leaf replicated over a mesh dim
counted on that dim's first rank only).  Plain tensors keep their path
and their bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core.xla_math import fma32, powf, sqrt32

#: Elements a block of the in-place update (bounds its float64 temporaries).
BLOCK = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over equal nested dicts / lists of tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *parts) for parts in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> list:
    """Leaves in the reference's (jax's) order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def init_opt_state(params, cfg: AdamWConfig):
    dt = getattr(torch, cfg.moment_dtype)
    leaf = tree_leaves(params)[0]
    # A DTensor parameter's moments share its placements.
    return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _square_sum(g) -> torch.Tensor:
    """A leaf's local sum of squares; 0 on a rank that is not the first
    along a mesh dim the leaf is replicated over."""
    s = torch.sum(torch.square(_local(g).float()))
    if isinstance(g, DTensor):
        coord = g.device_mesh.get_coordinate()
        if any(c and not p.is_shard() for c, p in zip(coord, g.placements)):
            return torch.zeros_like(s)
    return s


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """float32 ``sqrt(sum of squares)`` over every leaf; over the whole
    mesh for DTensor leaves."""
    leaves = tree_leaves(tree)
    total = torch.sum(torch.stack([_square_sum(g) for g in leaves]))
    mesh = next((g.device_mesh for g in leaves if isinstance(g, DTensor)),
                None)
    if mesh is not None:
        for i in range(mesh.ndim):
            dist.all_reduce(total, group=mesh.get_group(i))
    return sqrt32(total)


def _f32(v, like) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig,
                 lr_scale=1.0) -> Tuple[Any, Any, dict]:
    """-> (params, opt_state, {"grad_norm"}), ``params`` and the moments
    updated in place.  ``lr_scale`` is a float or a float32 tensor (a
    :func:`cosine_schedule` value)."""
    step = opt_state["step"] + 1
    leaf = tree_leaves(params)[0]
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(_f32(cfg.clip_norm, leaf)
                            / torch.clamp(gnorm, min=1e-9), max=1.0)
    n = int(step)
    c1 = _f32(1.0 - powf(cfg.b1, float(n)), leaf)
    c2 = _f32(1.0 - powf(cfg.b2, float(n)), leaf)
    if isinstance(lr_scale, torch.Tensor):
        lr = _f32(cfg.lr, leaf) * lr_scale.to(leaf.device, torch.float32)
    else:
        lr = _f32(cfg.lr * lr_scale, leaf)
    one_b1, one_b2 = _f32(1.0 - cfg.b1, leaf), _f32(1.0 - cfg.b2, leaf)
    b1, b2 = _f32(cfg.b1, leaf), _f32(cfg.b2, leaf)
    eps, wd = _f32(cfg.eps, leaf), _f32(cfg.weight_decay, leaf)

    def upd(p, g, m, v):
        for pb, gb, mb, vb in zip(*(t.view(-1).split(BLOCK)
                                    for t in (p, g, m, v))):
            g32 = gb.float()
            if scale is not None:
                g32 = g32 * scale
            m32 = fma32(mb.float(), b1, g32 * one_b1)
            v32 = fma32(vb.float(), b2, torch.square(g32) * one_b2)
            denom = c1 * (sqrt32(v32 / c2) + eps)
            delta = fma32(pb.float(), wd, m32 / denom)
            pb.copy_(fma32(delta, -lr, pb.float()))
            mb.copy_(m32)
            vb.copy_(v32)

    tree_map(lambda *ts: upd(*map(_local, ts)), params, grads,
             opt_state["m"], opt_state["v"])
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm}


def cosine_schedule(step, total_steps: int, warmup: int = 100,
                    floor: float = 0.1) -> torch.Tensor:
    """float32 learning-rate scale: linear warmup, then a cosine from 1
    down to ``floor`` at ``total_steps``."""
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return warm * cos
