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
    collective-permute);
  * the columns of a packed product moved between layouts (ROADMAP
    D15c-3): :func:`cols`, :func:`each` and :func:`join` say which
    columns of a last dim each rank holds (a :class:`Cols`), and
    :func:`regroup` moves a tensor from one layout to others (a local
    slice, an all-gather or one all-to-all), as the partitioner moves
    Mamba-2's ``in_proj`` columns (z | xBC | dt) to its conv channels
    and scan heads; :func:`gather_own` makes a divided tensor whole on
    every rank for its own product (all-gather forward, reduce-scatter
    backward), as RG-LRU's gates take their input.  Each layout's plan
    is made once and kept (``functools.lru_cache``);
  * the sequence pieces of the reference's sequence-parallel stream
    (ROADMAP D15c-2b), each along the sequence dim over "model":
    :func:`seq_divided` says whether "model" divides a sequence of T
    (else the stream stays whole, as ``sharding._guarded`` drops the
    axis), :func:`scatter_seq` takes this rank's rows (forward a slice,
    backward an all-gather), :func:`gather_own` along it makes the rows
    whole for each rank's own use (all-gather forward, reduce-scatter
    backward: a column-parallel product's input, attention's K/V) and
    :func:`reduce_scatter_seq` sums a row-parallel product's partial
    sums into this rank's rows (reduce-scatter forward, all-gather
    backward) in place of :func:`reduce_from_model`;
    :func:`gathered_product` a product over the gathered rows whose
    gradients are taken on this rank's rows; :func:`gather_from_model` is the gather for a computation every rank
    does alike (its gradient this rank's slice).

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

import functools
import itertools
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
    if mesh is None:
        return None
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


def _all_gather(x, dim: int, mg: ModelGroup):
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    parts = [torch.empty_like(x.contiguous()) for _ in range(mg.size)]
    dist.all_gather(parts, x.contiguous(), group=mg.group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x, dim: int, mg: ModelGroup):
    """The sum of the ranks' ``x``, this rank's part of it along ``dim``."""
    chunks = [c.contiguous() for c in x.chunk(mg.size, dim=dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=mg.group)
    return out


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mg):
        ctx.dim, ctx.mg = dim, mg
        return _all_gather(x, dim, mg)

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


# -- columns of a packed product over "model" -----------------------------------


class Cols(NamedTuple):
    """The columns of a tensor's last dim on each "model" rank:
    ``ranks[r]`` the global column indices rank r holds, in order, as a
    tuple of ranges.  ``alike``: every rank holds the same columns and
    uses them alike (a replicated tensor, its gradient whole on every
    rank); else each rank's columns are its own use (where the ranks'
    columns overlap, their gradients are summed)."""
    ranks: tuple
    alike: bool


def model_size() -> int:
    """The number of ranks of the active mesh's "model" group (1 where
    there is none)."""
    mg = model_group()
    return 1 if mg is None else mg.size


def cols(n: int, start: int = 0) -> Cols:
    """The columns [start, start + n) divided over "model" where it
    divides n (:func:`local`): each rank its contiguous share; else whole
    and alike on every rank."""
    return _layout("cols", n, start, model_size())


def whole(n: int, start: int = 0) -> Cols:
    """The columns [start, start + n) whole and alike on every rank."""
    return _layout("whole", n, start, model_size())


def each(n: int, start: int = 0) -> Cols:
    """The columns [start, start + n) on every rank, each rank's own use
    (alike where there is no "model" group)."""
    return _layout("each", n, start, model_size())


@functools.lru_cache(maxsize=None)
def _layout(kind: str, n: int, start: int, size: int) -> Cols:
    n_l = SH.model_share(n, size) if kind == "cols" and size > 1 else n
    if n_l != n:
        return Cols(tuple((range(start + r * n_l, start + (r + 1) * n_l),)
                          for r in range(size)), False)
    return Cols(((range(start, start + n),),) * size,
                kind != "each" or size == 1)


def _cat(*segs) -> tuple:
    """Ranges of columns one after another, adjacent ones merged."""
    out = []
    for s in (s for ss in segs for s in ss):
        if out and out[-1].stop == s.start:
            out[-1] = range(out[-1].start, s.stop)
        elif len(s):
            out.append(s)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def join(*parts: Cols) -> Cols:
    """The layouts ``parts`` one after another on each rank."""
    return Cols(tuple(_cat(*(p.ranks[r] for p in parts))
                      for r in range(len(parts[0].ranks))),
                all(p.alike for p in parts))


@functools.lru_cache(maxsize=None)
def _where(have: tuple, want: tuple):
    """The positions of the columns ``want`` among ``have``'s (each a
    tuple of ranges): a slice where they are contiguous, else a tuple."""
    at = {c: i for i, c in enumerate(itertools.chain(*have))}
    idx = [at[c] for c in itertools.chain(*want)]
    first = idx[0] if idx else 0
    if idx == list(range(first, first + len(idx))):
        return slice(first, first + len(idx))
    return tuple(idx)


def _pick(t, where):
    """The columns of ``t`` at ``where`` (:func:`_where`)."""
    if isinstance(where, slice):
        return t[..., where]
    return t.index_select(-1, torch.tensor(where, device=t.device))


def _a2a(x, n_send, n_recv, group):
    """``x``'s columns, n_send[j] of them to rank j in rank order, to
    their ranks, and the n_recv[i] from each rank i back, in rank order:
    one all-to-all along the last dim."""
    x = x.movedim(-1, 0).contiguous()
    out = x.new_empty((sum(n_recv),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, list(n_recv), list(n_send), group=group)
    return out.movedim(0, -1)


class _Regroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, plan, group):
        send, n_send, n_recv, perm = plan
        ctx.plan, ctx.group, ctx.n = plan, group, t.shape[-1]
        dev = t.device
        out = _a2a(t.index_select(-1, torch.tensor(send, device=dev)),
                   n_send, n_recv, group)
        return out.index_select(-1, torch.tensor(perm, device=dev))

    @staticmethod
    def backward(ctx, g):
        send, n_send, n_recv, perm = ctx.plan
        dev, lead = g.device, tuple(g.shape[:-1])
        back = g.new_zeros(lead + (sum(n_recv),)).index_add_(
            -1, torch.tensor(perm, device=dev), g)
        back = _a2a(back, n_recv, n_send, ctx.group)
        grad = g.new_zeros(lead + (ctx.n,)).index_add_(
            -1, torch.tensor(send, device=dev), back)
        return grad, None, None


@functools.lru_cache(maxsize=None)
def _plan(have: Cols, want: Cols, rank: int) -> tuple:
    """What this rank sends each rank (positions in its own columns, in
    the receiver's order), the counts each way, and the order that puts
    what it receives (by sender) into its ``want`` columns."""
    mine = {c: i for i, c in enumerate(itertools.chain(*have.ranks[rank]))}
    send, n_send = [], []
    for w in want.ranks:
        part = [mine[c] for c in itertools.chain(*w) if c in mine]
        send += part
        n_send.append(len(part))
    recv, n_recv = [], []
    for h in have.ranks:
        held = set(itertools.chain(*h))
        part = [k for k, c in enumerate(itertools.chain(*want.ranks[rank]))
                if c in held]
        recv += part
        n_recv.append(len(part))
    perm = [0] * len(recv)
    for i, k in enumerate(recv):
        perm[k] = i
    return tuple(send), tuple(n_send), tuple(n_recv), tuple(perm)


class _Own(torch.autograd.Function):
    """Each rank's own layouts of a tensor alike on every rank: a slice
    each forward (a view where its columns are contiguous); backward
    their gradients, one after another, all-gathered from every rank and
    added at its columns."""
    @staticmethod
    def forward(ctx, t, mine, every, mg):
        ctx.every, ctx.mg, ctx.n = every, mg, t.shape[-1]
        return tuple(_pick(t, w) for w in mine)

    @staticmethod
    def backward(ctx, *gs):
        mg = ctx.mg
        g = torch.cat(gs, -1)
        parts = [torch.empty_like(g) for _ in range(mg.size)]
        dist.all_gather(parts, g, group=mg.group)
        grad = g.new_zeros(tuple(g.shape[:-1]) + (ctx.n,)).index_add_(
            -1, torch.tensor(ctx.every, device=g.device), torch.cat(parts, -1))
        return grad, None, None, None


@functools.lru_cache(maxsize=None)
def _every(have: tuple, want: Cols) -> tuple:
    """The positions among ``have``'s columns of every rank's ``want``
    columns, rank after rank (the ranks hold as many columns each)."""
    per = [_where(have, w) for w in want.ranks]
    per = [tuple(range(p.start, p.stop)) if isinstance(p, slice) else p
           for p in per]
    assert len({len(p) for p in per}) == 1, "ranks' columns must be as many"
    return sum(per, ())


class _GatherOwn(_GatherFromModel):
    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.mg), None, None


def gather_own(x, dim: int):
    """``x`` divided over "model" along ``dim`` made whole on every rank
    for that rank's own use: all-gather forward; backward the ranks'
    gradients summed and this rank's slice kept (a reduce-scatter)."""
    mg = model_group()
    return x if mg is None else _GatherOwn.apply(x, dim % x.dim(), mg)


def regroup(t, have: Cols, *wants: Cols):
    """``t``, which holds the columns ``have``, in each of the layouts
    ``wants``: a local slice (``have`` alike: whole on every rank; a
    layout of each rank's own use gets its gradient back by one
    all-gather), the whole gathered (``have`` divided, in rank order,
    into an alike layout), or one all-to-all for all the layouts of each
    rank's own use, whose gradient goes back to the ranks holding the
    columns and is summed; ``t`` itself where a layout is ``have``.
    Returns a tensor, or a tuple where several are wanted."""
    mg = model_group()
    if mg is None:                    # one layout, whole: slices of t
        out = [t if w == have else _pick(t, _where(have.ranks[0],
                                                   w.ranks[0]))
               for w in wants]
        return out[0] if len(wants) == 1 else tuple(out)
    rank = mg.rank
    out = [t if w == have else None for w in wants]
    own = [i for i, w in enumerate(wants) if not w.alike and out[i] is None]
    alike = [i for i, w in enumerate(wants) if w.alike and out[i] is None]
    have_t = have.ranks[0] if have.alike else _cat(*have.ranks)
    if own:
        joined = join(*(wants[i] for i in own))
        if have.alike:
            res = _Own.apply(t, tuple(_where(have_t, wants[i].ranks[rank])
                                      for i in own),
                             _every(have_t, joined), mg)
        else:
            n = [sum(map(len, wants[i].ranks[rank])) for i in own]
            res = _Regroup.apply(t, _plan(have, joined, rank),
                                 mg.group).split(n, dim=-1)
        for i, part in zip(own, res):
            out[i] = part
    if alike and not have.alike:
        t = gather_from_model(t, -1)
    for i in alike:
        out[i] = _pick(t, _where(have_t, wants[i].ranks[rank]))
    return out[0] if len(wants) == 1 else tuple(out)


# -- the sequence-parallel stream over "model" ----------------------------------


def seq_divided(T: int) -> bool:
    """Whether the active mesh divides a sequence of ``T`` positions over
    "model" (more than one rank, dividing ``T``): the stream then holds
    this rank's T / model rows; else it stays whole (the guard of
    ``sharding._guarded``)."""
    mg = model_group()
    return mg is not None and T % mg.size == 0


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mg):
        ctx.dim, ctx.mg = dim, mg
        n = x.shape[dim] // mg.size
        return x.narrow(dim, mg.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.mg), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mg):
        ctx.dim, ctx.mg = dim, mg
        return _reduce_scatter(x, dim, mg)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.mg), None, None


def scatter_seq(x, dim: int = 1):
    """This rank's rows of ``x``, whole on every rank, along ``dim``
    divided over "model": a slice forward; backward the ranks' gradients
    all-gathered.  ``x`` itself where ``seq_divided`` is false."""
    mg = model_group()
    if mg is None or x.shape[dim] % mg.size:
        return x
    return _ScatterSeq.apply(x, dim % x.dim(), mg)


def reduce_scatter_seq(x, dim: int = 1):
    """The sum over "model" of the ranks' partial ``x`` (a row-parallel
    product's, whole along ``dim``), this rank's rows of it kept: a
    reduce-scatter forward; backward the gradient all-gathered."""
    mg = model_group()
    return x if mg is None else _ReduceScatterSeq.apply(x, dim % x.dim(), mg)


class _GatheredProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mg):
        ctx.mg = mg
        ctx.save_for_backward(x, w)
        return _all_gather(x, 1, mg) @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = _reduce_scatter(g, 1, ctx.mg)
        dw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return g @ w.T, dw, None


def gathered_product(x, w):
    """``gather_own(x, 1) @ w`` for x (B, T_l, d) this rank's rows and w (d,
    n) whole, as the reference's partitioner computes it: forward on the
    rows gathered over "model"; backward the output's gradient
    reduce-scattered to this rank's rows first, both gradient products
    on them (the gradient of w each rank's partial sum)."""
    mg = model_group()
    return x @ w if mg is None else _GatheredProduct.apply(x, w, mg)


def column_input(x, seq: bool = False):
    """A column-parallel product's input from the stream: replicated over
    "model" (:func:`copy_to_model`), or, with ``seq``, this rank's rows
    of a sequence-divided stream made whole (:func:`gather_own`)."""
    return gather_own(x, 1) if seq else copy_to_model(x)


def row_output(y, seq: bool = False):
    """A row-parallel product's partial sums into the stream: summed
    over "model" (:func:`reduce_from_model`), or, with ``seq``, summed
    and cut to this rank's rows (:func:`reduce_scatter_seq`)."""
    return reduce_scatter_seq(y) if seq else reduce_from_model(y)
