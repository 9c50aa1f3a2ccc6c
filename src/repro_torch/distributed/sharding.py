"""Logical-axis sharding: rules, activation constraints, parameter
placements, over ``torch.distributed``'s ``DeviceMesh`` and DTensor.

The reference's ``repro.distributed.sharding`` restated.  Model code
annotates activations with logical axes through :func:`constrain` (a
no-op outside :func:`use_mesh` and on plain tensors).  Parameter and
optimizer-state placements come from the parameter-tree paths by
:func:`param_specs`: 2-D FSDP x TP, tensor-parallel over ``model`` along
heads/ff/vocab/expert dims and fully sharded over ``data`` along a
complementary dim, so the AdamW moments are sharded over the whole mesh
by construction.  The ``pod`` axis (the multi-pod mesh) extends data
parallelism: the batch and the FSDP dims shard over ("pod", "data"),
pod-major.

A spec is what the reference's ``PartitionSpec`` holds: a tuple with,
per tensor dim, ``None`` or a tuple of mesh axis names.
:func:`spec_to_placements` turns it into DTensor placements (one per
mesh dim): a tensor dim over mesh axes becomes ``Shard(dim)`` on each of
them, in mesh-dim order, which is pod-major for ("pod", "data").

Computation runs on plain local tensors: :func:`gather_tree` turns a
DTensor weight into a local tensor just where it is used, with its
gradient summed over the batch axes (``Partial``), so the backward pass
leaves each gradient on its parameter's placements.  A weight whose
products are divided over "model" (:data:`TP_LEAVES`) is gathered to
this rank's "model" shard (:func:`gather_tp`; the products are
``distributed.tensor_parallel``'s); a leaf of :data:`KEPT_LEAVES` (the
MoE's experts) stays a DTensor for its layer to take its shards; any
other is gathered whole (:func:`gather`), its gradient replicated over
"model".  A serve step's cache leaf is a DTensor on
:func:`cache_leaf_spec`'s placements.
"""

from __future__ import annotations

import contextlib
import re
import threading
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_state = threading.local()

#: logical axis name -> mesh axes (single-pod).  The multi-pod mesh
#: extends the "data"-mapped axes with the "pod" axis.
DEFAULT_RULES = {
    "batch": ("data",),
    "seq": None,
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "fsdp": ("data",),       # weight dim sharded over the data axis
    "kv_seq": ("model",),    # KV-cache seq dim when heads cannot shard
    #: inter-unit activation carry: sequence sharded over the model axis
    #: (Megatron sequence-parallel style).
    "act_seq": ("model",),
}


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of any object with
    the reference mesh's ``shape`` mapping and ``axis_names``)."""
    if isinstance(getattr(mesh, "shape", None), dict):
        return dict(mesh.shape)
    return dict(zip(_axis_names(mesh), mesh.mesh.shape))


def rules_for_mesh(mesh) -> dict:
    rules = dict(DEFAULT_RULES)
    if "pod" in _axis_names(mesh):
        rules["batch"] = ("pod", "data")
        rules["fsdp"] = ("pod", "data")
    return rules


def current_mesh():
    return getattr(_state, "mesh", None)


def current_rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


def current_batch_axes() -> Tuple[str, ...]:
    """The mesh axes the running step split its batch over (``()``: the
    batch is whole on every rank)."""
    return getattr(_state, "batch_axes", ())


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None,
             batch_axes: Tuple[str, ...] = ()):
    """Activate the mesh for model code: constraints, the expert-parallel
    MoE, and (``batch_axes``) the axes the local batch is a shard of."""
    prev = (current_rules(), current_mesh(), current_batch_axes())
    _state.rules = rules or (rules_for_mesh(mesh) if mesh is not None
                             else None)
    _state.mesh = mesh
    _state.batch_axes = tuple(batch_axes) if mesh is not None else ()
    try:
        yield
    finally:
        _state.rules, _state.mesh, _state.batch_axes = prev


def snapshot() -> tuple:
    """The active mesh context, for code that runs later or on another
    thread (the backward pass's recomputation)."""
    return current_mesh(), current_rules(), current_batch_axes()


@contextlib.contextmanager
def restored(snap: tuple):
    """Re-enter a :func:`snapshot`."""
    mesh, rules, axes = snap
    with use_mesh(mesh, rules, axes):
        yield


def logical_to_spec(axes: Tuple[Optional[str], ...], rules=None) -> tuple:
    rules = rules or current_rules() or DEFAULT_RULES
    return tuple((rules.get(a) if a else None) or None for a in axes)


def _guarded(shape, parts, sizes) -> tuple:
    """Drop an axis group whose size does not divide its dim, or that
    reuses a mesh axis an earlier dim took."""
    out, used = [], set()
    for dim, m in enumerate(parts):
        if m:
            m_t = m if isinstance(m, tuple) else (m,)
            size = 1
            for ax in m_t:
                size *= sizes[ax]
            if shape[dim] % size == 0 and not (used & set(m_t)):
                out.append(tuple(m_t))
                used.update(m_t)
                continue
        out.append(None)
    return tuple(out)


def spec_to_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of a spec."""
    place = [Replicate()] * len(_axis_names(mesh))
    index = {n: i for i, n in enumerate(_axis_names(mesh))}
    for dim, m in enumerate(spec):
        for ax in m or ():
            place[index[ax]] = Shard(dim)
    return tuple(place)


def constrain(x, axes: Tuple[Optional[str], ...]):
    """Redistribute a DTensor to its logical axes' placements inside
    :func:`use_mesh`; ``x`` unchanged otherwise (plain tensors, no
    mesh)."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None or not isinstance(x, DTensor):
        return x
    parts = [(rules.get(a) if a else None) for a in axes]
    spec = _guarded(x.shape, parts, mesh_shape(mesh))
    return x.redistribute(mesh, spec_to_placements(spec, mesh))


# ---------------------------------------------------------------------------
# Parameter placements by tree path.
# ---------------------------------------------------------------------------

#: (path regex, logical axes per dim, in the parameter's dim order).
#: Leading stacked-unit dims are handled separately.
_PARAM_RULES = (
    # attention projections
    (r"\bwq$", ("fsdp", "heads", None)),          # (d, H, hd)
    (r"\bwk$", ("fsdp", "kv_heads", None)),
    (r"\bwv$", ("fsdp", "kv_heads", None)),
    (r"\bwo$", ("heads", None, "fsdp")),          # (H, hd, d)
    # dense mlp
    (r"\bwi$", ("fsdp", "ff")),                   # (d, ff)
    (r"\bwg$", ("fsdp", "ff")),
    (r"\bwd$", ("ff", "fsdp")),                   # (ff, d)
    # moe
    (r"\brouter$", ("fsdp", None)),               # (d, E)
    (r"\bmoe_wi$", ("experts", "fsdp", None)),    # (E, d, ff)
    (r"\bmoe_wg$", ("experts", "fsdp", None)),
    (r"\bmoe_wd$", ("experts", None, "fsdp")),    # (E, ff, d)
    # embeddings / head
    (r"\bembed$", ("vocab", "fsdp")),             # (V, d)
    (r"\bunembed$", ("fsdp", "vocab")),           # (d, V)
    (r"\bpos_embed$", (None, "fsdp")),
    # ssm
    (r"\bin_proj$", ("fsdp", "ff")),              # (d, inner+...)
    (r"\bout_proj$", ("ff", "fsdp")),
    (r"\bconv_w$", (None, "ff")),                 # (d_conv, channels)
    # rglru
    (r"\bw_gate$", ("fsdp", "ff")),
    (r"\bw_rec$", ("fsdp", "ff")),
    (r"\bw_out$", ("ff", "fsdp")),
    (r"\ba_gate$", ("ff",)),
    (r"\bx_gate$", ("ff",)),
)


def _spec_for_path(path: str, ndim: int, n_stacked: int, rules) -> tuple:
    for pat, axes in _PARAM_RULES:
        if re.search(pat, path):
            if len(axes) + n_stacked != ndim:
                break  # fall through to replicated
            return (None,) * n_stacked + tuple(
                (rules.get(a) if a else None) or None for a in axes)
    return (None,) * ndim


def map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over nested dicts and lists (a tuple is a leaf:
    specs and placements are tuples); a path is the keys and list
    indices (as strings) from the root."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(params, mesh):
    """A spec per parameter leaf (stacked units keep a leading None);
    ``mesh`` needs only the axis names and sizes."""
    rules = rules_for_mesh(mesh)
    sizes = mesh_shape(mesh)

    def spec(path, leaf):
        n_stacked = 1 if "units" in path else 0
        s = _spec_for_path("/".join(path), leaf.ndim, n_stacked, rules)
        return _guarded(leaf.shape, s, sizes)

    return map_with_path(spec, params)


def param_placements(params, mesh):
    """DTensor placements per parameter leaf (the reference's
    ``named_shardings``)."""
    return map_with_path(
        lambda _, s: spec_to_placements(s, mesh),
        param_specs(params, mesh))


def batch_size_of(mesh, axes) -> int:
    sizes = mesh_shape(mesh)
    n = 1
    for ax in axes:
        n *= sizes[ax]
    return n


def cache_leaf_spec(shape, n_lead: int, mesh) -> tuple:
    """The reference's rule for a decode-cache leaf of global ``shape``
    (``cache_shardings``, ``repro/distributed/steps.py:58-86``): the
    batch dim (``n_lead``, after a stacked unit dim) over the batch axes
    where they divide it, and the largest later dim that "model" divides
    over "model" (of equal ones the last).  The serve steps place the
    cache by it and the layers read and write their cache leaves by it
    (``distributed.tensor_parallel.cache_part``)."""
    b_axes = rules_for_mesh(mesh)["batch"]
    model = mesh_shape(mesh)["model"]
    parts = [None] * len(shape)
    if len(shape) > n_lead and shape[n_lead] % batch_size_of(mesh,
                                                             b_axes) == 0:
        parts[n_lead] = tuple(b_axes)
    cand = [(shape[i], i) for i in range(n_lead + 1, len(shape))
            if shape[i] % model == 0 and shape[i] >= model]
    if cand:
        parts[max(cand)[1]] = ("model",)
    return tuple(parts)


def grad_placements(mesh, model=None) -> list:
    """Placements of a gathered weight's gradient: summed over the batch
    axes, ``model`` (default replicated) over "model"."""
    batch = rules_for_mesh(mesh)["batch"]
    return [Partial() if n in batch else
            (model or Replicate()) if n == "model" else Replicate()
            for n in _axis_names(mesh)]


def gather(x):
    """A DTensor weight as the full local tensor; its gradient lands on
    the DTensor's placements summed over the batch axes.  Plain tensors
    pass through."""
    if not isinstance(x, DTensor):
        return x
    return x.full_tensor(grad_placements=grad_placements(x.device_mesh))


def model_share(n: int, model: int) -> int:
    """The rows of a dim of ``n`` that each rank of a "model" axis of
    ``model`` ranks holds where the products over that dim are divided:
    ``n / model`` where ``model`` divides ``n``, else ``n`` (whole on
    every rank, as ``_guarded`` drops an axis that does not divide).
    The one rule of ROADMAP D15c-1: :func:`gather_tp` divides the
    weights by it, and the layers and the serve steps read it through
    ``distributed.tensor_parallel.local``."""
    return n // model if n % model == 0 else n


def gather_tp(x, dim: int):
    """A weight gathered over every mesh axis but "model", as this
    rank's local tensor: divided over "model" along ``dim`` where
    :func:`model_share` divides it, else whole.  A DTensor's gradient is
    summed over the batch axes and stays divided along ``dim`` (a weight
    that ``param_specs`` leaves replicated over "model" gets it back
    whole, all-gathered).  Plain tensors pass through: a weight gathered
    once is already this rank's (the dense MoE gathers its unit's
    weights again)."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    size = mesh_shape(mesh).get("model")
    split = (size is not None
             and model_share(x.shape[dim], size) * size == x.shape[dim])
    model = Shard(dim) if split else Replicate()
    want = tuple(model if n == "model" else Replicate()
                 for n in _axis_names(mesh))
    return x.redistribute(mesh, want).to_local(
        grad_placements=grad_placements(mesh, model=model))


#: The leaves whose products are divided over "model", each with the
#: dim it is divided along: attention's projections over the heads, the
#: dense MLP's over ff (in every layer that has one and in the MoE's
#: shared expert), the embedding and the head over the vocab (ROADMAP
#: D15c-1); Mamba-2's in_proj over its packed columns (z | xBC | dt),
#: its out_proj over the rows of d_inner, RG-LRU's w_gate and w_rec over
#: the width and w_out over its rows, and the depthwise conv_w of both
#: blocks, (K, channels), over the channels (D15c-3).  Each is divided
#: where "model" divides that dim, as the reference's partitioner
#: divides it: ``param_specs`` shards the same dim over "model" where it
#: divides (``_guarded``), and where it leaves a weight replicated (the
#: whisper units' paths match no rule), the consumer's ``constrain``
#: hint ("kv_heads", "ff", "vocab") divides the product.
#: :func:`gather_tree` gathers them with :func:`gather_tp`, the leaves of
#: :data:`KEPT_LEAVES` not at all, every other leaf whole: the router,
#: the norms' scales and biases, and the leaves ``param_specs``
#: replicates (Mamba-2's conv_b, dt_bias, a_log, d_skip and norm_scale;
#: RG-LRU's a_gate and x_gate, whose rule has one axis for two dims, and
#: its biases and lambda_p), which a layer slices where the dims they
#: serve are divided (``tensor_parallel.copy_to_model`` first).
TP_LEAVES = {"wq": 1, "wk": 1, "wv": 1, "wo": 0,     # (d, H, hd), (H, hd, d)
             "wi": 1, "wg": 1, "wd": 0,              # (d, ff), (ff, d)
             "embed": 0, "unembed": 1,               # (V, d), (d, V)
             "in_proj": 1, "out_proj": 0,            # (d, n), (di, d)
             "w_gate": 1, "w_rec": 1, "w_out": 0,    # (d, w), (w, d)
             "conv_w": 1}                            # (K, channels)

#: The leaves whose layer takes its own shards (ROADMAP D15c-2a): the
#: MoE's experts (E, d, ff) and (E, ff, d), divided over "model" along
#: the experts and over the batch axes along d (``param_specs``).
#: :func:`gather_tree` leaves them as they are; ``models.moe`` gathers
#: what its dispatch needs (the expert-parallel body and the dense
#: dispatch's prefill: d whole; the dense decode: nothing).
KEPT_LEAVES = ("moe_wi", "moe_wg", "moe_wd")


def gather_tree(tree, name: str = ""):
    """The weights of nested dicts / lists gathered: a leaf named in
    :data:`TP_LEAVES` by :func:`gather_tp` along its dim, one in
    :data:`KEPT_LEAVES` not at all, any other whole (:func:`gather`)."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_tree(v, name) for v in tree]
    if name in KEPT_LEAVES:
        return tree
    if name in TP_LEAVES:
        return gather_tp(tree, TP_LEAVES[name])
    return gather(tree)


def as_dtensor(local_t, mesh, placements, shape) -> DTensor:
    """This rank's ``local_t`` as the shard of a DTensor of global
    ``shape`` on ``placements`` (no collective, and no tensor of the
    global shape: the cost counter would count a meta one's bytes)."""
    stride, n = [], 1
    for d in reversed(tuple(shape)):
        stride.append(n)
        n *= d
    return DTensor.from_local(local_t.contiguous(), mesh, tuple(placements),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def unit_of(x, u: int):
    """Unit ``u`` of a stacked leaf (its dim 0, never divided): a
    DTensor's taken from its local shard and wrapped again, its
    placements moved down a dim (no DTensor op: their sharding
    propagation runs the op on the global shape), else ``x[u]``."""
    if not isinstance(x, DTensor):
        return x[u]
    place = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                  for p in x.placements)
    return as_dtensor(x.to_local()[u], x.device_mesh, place, x.shape[1:])


def stack_units(xs):
    """Equal leaves stacked along a new dim 0: DTensors by their local
    shards (:func:`unit_of`'s inverse), else ``torch.stack``."""
    if not isinstance(xs[0], DTensor):
        return torch.stack(xs)
    place = tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
                  for p in xs[0].placements)
    return as_dtensor(torch.stack([x.to_local() for x in xs]),
                      xs[0].device_mesh, place,
                      (len(xs),) + tuple(xs[0].shape))


def place(t: torch.Tensor, mesh, placements) -> DTensor:
    """A tensor whole on every rank as a DTensor on ``placements``: each
    rank keeps its slice (no collective)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(
        t.shape, mesh, tuple(placements))
    part = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    return as_dtensor(part, mesh, placements, t.shape)


def local(x) -> torch.Tensor:
    """The local shard of a DTensor; a plain tensor itself."""
    return x.to_local() if isinstance(x, DTensor) else x


def batch_index(mesh, axes) -> int:
    """This rank's index along the batch axes (pod-major)."""
    sizes, idx = mesh_shape(mesh), 0
    for ax in axes:
        idx = idx * sizes[ax] + mesh.get_local_rank(ax)
    return idx


def gather_batch(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """``x`` divided over ``axes`` along ``dim`` (pod-major) made whole:
    the global batch of a local batch shard; the gradient is summed back
    over ``axes`` (a reduce-scatter)."""
    names = _axis_names(mesh)
    shard = [Shard(dim) if n in axes else Replicate() for n in names]
    grad = [Partial() if n in axes else Replicate() for n in names]
    return DTensor.from_local(x, mesh, shard, run_check=False).full_tensor(
        grad_placements=grad)


class _AllReduceBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        x = x.contiguous().clone()
        for g in groups:
            dist.all_reduce(x, group=g)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g, None


def all_reduce_batch(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum over the ranks of ``axes`` of each rank's ``x``, whole on
    each: one all-reduce an axis forward and, its own adjoint, backward
    (each rank's loss is its rows', the gradient their sum)."""
    if not axes:
        return x
    return _AllReduceBatch.apply(x, tuple(mesh.get_group(a) for a in axes))


def local_rows(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """This rank's rows of a global batch split over ``axes``."""
    n = batch_size_of(mesh, axes)
    rows = x.shape[0] // n
    i = batch_index(mesh, axes)
    return x[i * rows:(i + 1) * rows]
