"""Tensor parallelism over the mesh's "model" axis: the communication
that XLA's SPMD partitioner inserts around the reference's products
divided over "model", written out (ROADMAP D15c-1).  No module of the
reference holds it: there the partitioner derives it from the weights'
placements and the ``constrain`` hints.

Megatron's pieces, each over the active mesh's "model" group
(:func:`model_group`):

  * :func:`copy_to_model`: activations replicated over "model" going
    into a column-parallel product: identity forward, the ranks' partial
    gradients summed (one all-reduce, packed) backward;
  * :func:`reduce_from_model`: the partial sums of a row-parallel
    product: all-reduce forward, identity backward;
  * :func:`gather_from_model`: a tensor divided along one dim made whole
    (all-gather forward, this rank's slice of the gradient backward);
  * :func:`embed_lookup`: a vocab-parallel embedding lookup (the rows
    this rank does not hold masked to 0, then summed over "model");
  * :func:`cross_entropy`: a vocab-parallel cross-entropy, in the form of
    ``models.common.cross_entropy``;
  * the decode cache divided over "model" (ROADMAP D15c-2a), each leaf
    along the dim ``sharding.cache_leaf_spec`` picks: :func:`cache_part`
    reads a leaf, :func:`relayout` moves it between dims (a local slice,
    an all-gather or an all-to-all), :func:`to_cache` and
    :func:`cache_like` make a layer's new leaf the serve steps' DTensor;
    :func:`softmax_over_model` is decode attention's softmax over slots
    divided over "model" (an all-reduce of the max and one of the sum;
    :func:`reduce_from_model` adds the partial p.v), and
    :func:`from_next` moves a window cache's slot across shards (a
    collective-permute).

Where there is no mesh, or its "model" axis has one rank, every piece
is the identity (and the two vocab-parallel pieces the plain lookup and
loss) and issues no collective.  Which products are divided follows one
rule, ``sharding.model_share``: a dim of heads, ff or vocab is divided
where the "model" axis divides it.  ``sharding.gather_tp`` cuts the
weights of :data:`~repro_torch.distributed.sharding.TP_LEAVES` by it,
and the layers and the serve steps ask :func:`local` and
:func:`divided`, so a layer's weights and its activations, caches and
logits always agree.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.distributed import sharding as SH


class ModelGroup(NamedTuple):
    """The active mesh's "model" process group, its size and this rank's
    index in it."""
    group: object
    size: int
    rank: int


def model_group() -> Optional[ModelGroup]:
    """The "model" group of the active mesh, or None where there is no
    mesh or its "model" axis has one rank."""
    mesh = SH.current_mesh()
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if "model" not in names:
        return None
    size = mesh.size(names.index("model"))
    if size == 1:
        return None
    return ModelGroup(mesh.get_group("model"), size,
                      mesh.get_local_rank("model"))


def local(n: int) -> int:
    """This rank's share of a dim of ``n`` under the active mesh:
    ``n / model`` where the "model" axis (more than one rank) divides
    it, else ``n`` (``sharding.model_share``)."""
    mg = model_group()
    return n if mg is None else SH.model_share(n, mg.size)


def divided(n: int) -> bool:
    """Whether the products over a dim of ``n`` are divided over
    "model" under the active mesh."""
    return local(n) != n


def shard_range(n_local: int) -> tuple:
    """[start, stop) of this rank's rows of a dim divided over "model"
    in ``n_local`` rows a rank."""
    mg = model_group()
    start = 0 if mg is None else mg.rank * n_local
    return start, start + n_local


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        # One all-reduce of the gradients packed in the first one's dtype.
        flat = torch.cat([g.reshape(-1).to(gs[0].dtype) for g in gs])
        dist.all_reduce(flat, group=ctx.group)
        out = flat.split([g.numel() for g in gs])
        return (None,) + tuple(o.view_as(g).to(g.dtype)
                               for o, g in zip(out, gs))


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mg):
        ctx.dim, ctx.mg = dim, mg
        parts = [torch.empty_like(x.contiguous()) for _ in range(mg.size)]
        dist.all_gather(parts, x.contiguous(), group=mg.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.mg.size
        return g.narrow(ctx.dim, ctx.mg.rank * n, n), None, None


def copy_to_model(*xs):
    """Tensors replicated over "model" into column-parallel products (or
    another computation each rank does its part of): identity forward,
    their gradients summed over "model" backward, in one all-reduce.
    Returns the tensor, or the tensors where several are given."""
    mg = model_group()
    out = xs if mg is None else _CopyToModel.apply(mg.group, *xs)
    return out[0] if len(xs) == 1 else tuple(out)


def reduce_from_model(x):
    """The sum over "model" of the ranks' partial ``x`` (a row-parallel
    product's): all-reduce forward, identity backward."""
    mg = model_group()
    return x if mg is None else _ReduceFromModel.apply(x, mg.group)


def gather_from_model(x, dim: int):
    """``x`` divided over "model" along ``dim`` made whole (rank order);
    the gradient's slice of this rank backward."""
    mg = model_group()
    return x if mg is None else _GatherFromModel.apply(x, dim % x.dim(), mg)


def embed_lookup(table, tokens, dtype, vocab: int):
    """Rows ``tokens`` of the embedding ``table`` in ``dtype``.  Where the
    ``vocab`` rows are divided over "model" (the table this rank's), the
    tokens another rank holds read 0 and the ranks' lookups are summed
    (one nonzero term a token, so the sum is exact)."""
    if not divided(vocab):
        return table[tokens].to(dtype)
    start, stop = shard_range(local(vocab))
    inside = (tokens >= start) & (tokens < stop)
    rows = torch.where(inside, tokens - start, 0)
    x = torch.where(inside[..., None], table[rows], 0.0).to(dtype)
    return reduce_from_model(x)


def cross_entropy(logits, labels, vocab: Optional[int] = None):
    """Per-position cross-entropy (float32, no reduction) of ``logits``
    against ``labels``: ``log sum exp(logits - m) + m - gold`` with the
    max ``m`` held constant and the gold logit picked by a select and a
    sum.  Where ``vocab`` (the head's width; None: the logits are whole)
    is divided over "model", the logits are this rank's columns, and one
    all-reduce takes the max and one the sum of exponentials and the
    gold logit."""
    logits = logits.float()
    split = vocab is not None and divided(vocab)
    m = logits.amax(dim=-1, keepdim=True).detach()
    if split:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=model_group().group)
    start, _ = shard_range(logits.shape[-1]) if split else (0, 0)
    sumexp = torch.exp(logits - m).sum(dim=-1)
    cols = start + torch.arange(logits.shape[-1], device=logits.device)
    onehot = labels[..., None].long() == cols
    gold = torch.where(onehot, logits, 0.0).sum(dim=-1)
    if split:
        sumexp, gold = reduce_from_model(torch.stack([sumexp, gold])
                                         ).unbind(0)
    return torch.log(sumexp) + m[..., 0] - gold


# -- the decode cache divided over "model" --------------------------------------


class CachePart(NamedTuple):
    """A cache leaf as a layer reads it: this rank's ``local`` tensor, the
    dim divided over "model" (None: whole over "model") and the leaf's
    global shape."""
    local: torch.Tensor
    dim: Optional[int]
    shape: tuple


def cache_part(t) -> CachePart:
    """A cache leaf: a DTensor (the serve steps') read by its placement
    on "model", a plain tensor whole."""
    if not isinstance(t, DTensor):
        return CachePart(t, None, tuple(t.shape))
    names = t.device_mesh.mesh_dim_names
    i = names.index("model")
    place = t.placements[i]
    dim = place.dim if (isinstance(place, Shard)
                        and t.device_mesh.size(i) > 1) else None
    return CachePart(t.to_local(), dim, tuple(t.shape))


def relayout(t, have: Optional[int], want: Optional[int]):
    """``t``, divided over "model" along ``have`` (None: whole), divided
    along ``want`` instead: this rank's slice of a whole tensor (no
    collective), the whole of a divided one (an all-gather), or another
    dim's slice (an all-to-all).  The identity at "model" 1."""
    mg = model_group()
    if mg is None or have == want:
        return t
    if have is None:
        n = t.shape[want] // mg.size
        return t.narrow(want, mg.rank * n, n)
    if want is None:
        return gather_from_model(t, have)
    chunks = torch.stack(t.chunk(mg.size, dim=want))
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=mg.group)
    return torch.cat(out.unbind(0), dim=have)


def _cache_dim(spec) -> Optional[int]:
    return next((i for i, a in enumerate(spec) if a == ("model",)), None)


def to_cache(t, have: Optional[int] = None):
    """A layer's new cache leaf ``t`` (this rank's batch rows; divided
    over "model" along ``have``, or whole) as the serve steps hold it:
    under a mesh a DTensor of this rank's shard on
    ``sharding.cache_leaf_spec``'s placements for the leaf's global
    shape, cut or moved from ``t`` (never gathered whole first); ``t``
    itself without a mesh."""
    mesh = SH.current_mesh()
    if mesh is None:
        return t
    mg = model_group()
    shape = list(t.shape)
    shape[0] *= SH.batch_size_of(mesh, SH.current_batch_axes())
    if have is not None and mg is not None:
        shape[have] *= mg.size
    spec = SH.cache_leaf_spec(shape, 0, mesh)
    want = _cache_dim(spec) if mg is not None else None
    return SH.as_dtensor(relayout(t, have, want), mesh,
                         SH.spec_to_placements(spec, mesh), shape)


def cache_like(orig, t, have: Optional[int] = None):
    """``t`` (divided over "model" along ``have``, or whole) in the layout
    of the cache leaf ``orig`` it replaces: a DTensor of ``orig``'s
    placements where ``orig`` is one, else ``t``."""
    if not isinstance(orig, DTensor):
        return t
    return SH.as_dtensor(relayout(t, have, cache_part(orig).dim),
                         orig.device_mesh, orig.placements, orig.shape)


def softmax_over_model(s):
    """The softmax of ``s`` along its last dim, that dim divided over
    "model": the max and the sum of the exponentials each all-reduced
    (``torch.softmax`` at "model" 1)."""
    mg = model_group()
    if mg is None:
        return torch.softmax(s, dim=-1)
    m = s.amax(dim=-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mg.group)
    e = torch.exp(s - m)
    total = e.sum(dim=-1, keepdim=True)
    dist.all_reduce(total, group=mg.group)
    return e / total


def from_next(t):
    """Each "model" rank's ``t`` from the next rank (the last rank's from
    the first): one send and one receive a rank, a collective-permute.
    ``t`` itself at "model" 1."""
    mg = model_group()
    if mg is None:
        return t
    t = t.contiguous()
    out = torch.empty_like(t)
    rank = lambda i: dist.get_global_rank(mg.group, i % mg.size)  # noqa
    ops = [dist.P2POp(dist.isend, t, rank(mg.rank - 1), mg.group),
           dist.P2POp(dist.irecv, out, rank(mg.rank + 1), mg.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out
