"""The port's sharded steps on gloo meshes of CPU ranks, for
``tests/test_torch_sharded_step.py``: one ``torch.multiprocessing``
spawn a world size, the ranks meeting through a ``FileStore`` (no fixed
port).  Imports no JAX.

``run(world, work_dir)`` reads ``work_dir/cases.json`` and the
reference's initial parameters (``work_dir/params.pkl``: nested numpy
trees by arch, and the MoE case's layer and input), runs the cases of
that world size (train, MoE, dense MoE, recurrent-layer and serve
cases; at world size 2 also the
collectives a step issues on each mesh axis's group,
:func:`_group_collectives`; at world size 4 the saved unit carries,
:func:`_saved_carries`, and context-parallel attention layers,
:func:`_cp_attention`) and writes ``work_dir/port_<world>.json`` from
rank 0.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import pickle
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

B, T = 4, 16
#: Greedy decode steps after a serve case's prefill.
SERVE_STEPS = 3
#: Depths other than the reduced config's (recurrentgemma with a tail).
OVERRIDES = {"recurrentgemma-2b": dict(n_layers=8)}


def config(arch):
    from repro_torch.configs import get_config, reduced_config

    return dataclasses.replace(reduced_config(get_config(arch)),
                               activation_dtype="float32",
                               **OVERRIDES.get(arch, {}))


def batches(cfg, steps, seed=0, T=T):
    """The reference driver's batches (``tests/sharded_reference.py``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
        b = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
        if cfg.family == "encdec":
            b["audio_embed"] = rng.standard_normal(
                (B, cfg.enc_positions, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            b["patches"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _local_bytes(state):
    from repro_torch.distributed.sharding import local
    from repro_torch.optim.adamw import tree_leaves

    return sum(local(x).numel() * local(x).element_size()
               for x in tree_leaves(state))


def _train(arch, shape, ep, steps, ref_params, bs=None, state=None,
           variant=""):
    """Sharded steps on a mesh of ``shape`` under the switches of
    ``variant`` (:data:`VARIANTS`): (metrics, state, this rank's state
    bytes)."""
    from repro_torch.distributed import steps as ST
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import params_from_jax

    os.environ["REPRO_MOE_EP"] = str(ep)
    os.environ.update(VARIANTS[variant])
    cfg = config(arch)
    mesh = make_mesh(shape, device="cpu")
    step, place = ST.make_train_step(cfg, mesh)
    if state is None:
        state = ST.init_train_state(
            cfg, mesh, place,
            params=params_from_jax(ref_params[arch], device="cpu"))
    nbytes = _local_bytes(state)
    metrics = []
    for b in bs or batches(cfg, steps):
        state, m = step(state, b)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    os.environ["REPRO_MOE_EP"] = "0"
    for k in VARIANTS[variant]:
        os.environ.pop(k)
    return metrics, state, nbytes


def _moe(shape, ref):
    """The expert-parallel layer on this rank's rows: (y, rank 0's aux)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.models.convert import params_from_jax

    os.environ["REPRO_MOE_EP"] = "1"
    cfg = config("olmoe-1b-7b")
    mesh = make_mesh(shape, device="cpu")
    p = params_from_jax(ref["moe_p"], device="cpu")
    x = torch.from_numpy(ref["moe_x"])
    axes = ("data",) if shape[0] > 1 else ()
    with SH.use_mesh(mesh, batch_axes=axes):
        y, aux = MOE.moe_apply_ep(cfg, cfg.moe, p,
                                  SH.local_rows(x, mesh, axes) if axes else x,
                                  with_aux=True)
    if axes:
        parts = [torch.empty_like(y) for _ in range(shape[0])]
        dist.all_gather(parts, y.contiguous(), group=mesh.get_group("data"))
        y = torch.cat(parts)
    os.environ["REPRO_MOE_EP"] = "0"
    return y.numpy().tolist(), float(aux)


#: A case's variant: its switches, and a serve case's prompt length
#: where it is not T (``sharded_reference.VARIANTS``, ``PROMPT``).
VARIANTS = {"": {}, "kvint8": {"REPRO_KV_INT8": "1"}, "slots": {},
            "flash": {"REPRO_ATTN_IMPL": "flash"}}
PROMPT = {"slots": 64, "flash": 64}


def _dense_moe(shape, ref, T_moe):
    """The dense MoE layer divided over the mesh (``models.moe.
    _dense_divided``) on this rank's rows of the MoE case's input cut to
    ``T_moe`` positions (1: a capacity below d, the decode's division; 8:
    the prefill's and training's), against the whole layer on the whole
    input: the largest differences of y, the aux loss, and the gradients
    of the input, the router and the experts of the loss sum(y * w) +
    aux (w seeded), each relative to the whole's largest."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.adamw import tree_map

    cfg = config("olmoe-1b-7b")
    mesh = make_mesh(shape, device="cpu")
    p = tree_map(lambda t: t.requires_grad_(True),
                 params_from_jax(ref["moe_p"], device="cpu"))
    x = torch.from_numpy(ref["moe_x"][:, :T_moe].copy()).requires_grad_(True)
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        x.shape).astype(np.float32))
    y, aux = MOE.moe_apply(cfg, cfg.moe, p, x, with_aux=True)
    ((y * w).sum() + aux).backward()
    want = {"y": y.detach(), "aux": aux.detach(), "x": x.grad,
            **{k: v.grad for k, v in p.items()}}

    axes = ("data",) if shape[0] > 1 else ()
    pd = tree_map(lambda t: t.detach().requires_grad_(True),
                  reshard_state(tree_map(lambda t: t.detach(), p), mesh,
                                SH.param_placements(p, mesh)))
    xl = (SH.local_rows(x.detach(), mesh, axes) if axes
          else x.detach()).requires_grad_(True)
    with SH.use_mesh(mesh, batch_axes=axes):
        y, aux = MOE.moe_apply(cfg, cfg.moe, pd, xl, with_aux=True)
    n_b = shape[0]
    wl = SH.local_rows(w, mesh, axes) if axes else w
    ((y * wl).sum() + aux / n_b).backward()
    got = {"y": y.detach(), "aux": aux.detach(), "x": xl.grad,
           **{k: v.grad.full_tensor() for k, v in pd.items()}}
    if axes:
        for k in ("y", "x"):
            parts = [torch.empty_like(got[k]) for _ in range(n_b)]
            dist.all_gather(parts, got[k].contiguous(),
                            group=mesh.get_group("data"))
            got[k] = torch.cat(parts)
    return {k: float((got[k] - want[k]).abs().max()
                     / want[k].abs().max()) for k in want}


#: A recurrent case's widths other than the reduced config's: at "model"
#: 4, "mixed" leaves in_proj (230 columns) and the 6 heads whole and
#: divides the 128 conv channels and the 96 rows of d_inner, as "model"
#: 16 divides mamba2-130m at full width.
RECURRENT_WIDTHS = {"": {}, "mixed": dict(d_model=48)}


def _recurrent_divided(shape, arch, widths=""):
    """A Mamba-2 (``models.ssm``) or RG-LRU (``models.rglru``) layer
    divided over the mesh (its weights' "model" shards, ROADMAP D15c-3)
    on this rank's rows of a seeded input, against the whole layer on the
    whole input: the largest differences of the training output y and of
    the gradients of the input and of every weight of the loss sum(y *
    w) (w seeded), of the prefill's output and its cache (the new
    state), and of one decode step's output and state, each relative to
    the whole's largest."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import rglru as RG
    from repro_torch.models import ssm as SSMM
    from repro_torch.optim.adamw import tree_map

    cfg = dataclasses.replace(config(arch), **RECURRENT_WIDTHS[widths])
    init, full, dec = {
        "mamba2-130m": (SSMM.ssm_init, SSMM.ssm_fullseq, SSMM.ssm_decode),
        "recurrentgemma-2b": (RG.rglru_init, RG.rglru_fullseq,
                              RG.rglru_decode)}[arch]
    mesh = make_mesh(shape, device="cpu")
    p = tree_map(lambda t: t.requires_grad_(True),
                 init(torch.Generator().manual_seed(5), cfg))
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)).requires_grad_(True)
    x1 = torch.from_numpy(rng.standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))

    def run(params, xs, x1s, ws):
        y, _ = full(cfg, params(), xs, return_cache=False)
        (y * ws).sum().backward()
        with torch.no_grad():
            yp, cache = full(cfg, params(), xs.detach())
            yd, state = dec(cfg, params(), x1s, cache)
        return {"y": y.detach(), "prefill": yp, "decode": yd,
                **{f"cache/{k}": v for k, v in cache.items()},
                **{f"state/{k}": v for k, v in state.items()}}

    want = run(lambda: p, x, x1, w)
    want.update({"x": x.grad, **{k: v.grad for k, v in p.items()}})

    axes = ("data",) if shape[0] > 1 else ()
    pd = tree_map(lambda t: t.detach().requires_grad_(True),
                  reshard_state(tree_map(lambda t: t.detach(), p), mesh,
                                SH.param_placements(p, mesh)))
    rows = (lambda t: SH.local_rows(t, mesh, axes)) if axes else (
        lambda t: t)
    xl = rows(x.detach()).requires_grad_(True)
    with SH.use_mesh(mesh, batch_axes=axes):
        got = run(lambda: SH.gather_tree(pd), xl, rows(x1), rows(w))
    got.update({"x": xl.grad,
                **{k: v.grad.full_tensor() for k, v in pd.items()}})
    for k in list(got):
        if isinstance(got[k], SH.DTensor):
            got[k] = got[k].full_tensor()
        elif axes and k in ("y", "prefill", "decode", "x"):
            parts = [torch.empty_like(got[k]) for _ in range(shape[0])]
            dist.all_gather(parts, got[k].contiguous(),
                            group=mesh.get_group("data"))
            got[k] = torch.cat(parts)
    return {k: float((got[k] - want[k]).abs().max()
                     / want[k].abs().max()) for k in want}


def _serve(arch, shape, ref_params, variant="", steps=SERVE_STEPS):
    """``make_prefill_step`` and ``steps`` greedy ``make_decode_step``
    steps on a mesh of ``shape`` (``sharded_reference.serve_case``),
    handed the prompt whole (each rank keeps its shard) and then the
    steps' own DTensors: each step's last-position logits and greedy
    tokens (gathered), and each rank's bytes of the last cache."""
    from repro_torch.distributed import steps as ST
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.adamw import tree_leaves

    os.environ.update(VARIANTS[variant])
    cfg = config(arch)
    mesh = make_mesh(shape, device="cpu")
    prefill, place = ST.make_prefill_step(cfg, mesh)
    decode, _ = ST.make_decode_step(cfg, mesh)
    params = reshard_state(params_from_jax(ref_params[arch], device="cpu"),
                           mesh, place)
    T_p = PROMPT.get(variant, T)
    batch = {k: v for k, v in batches(cfg, 1, T=T_p)[0].items()
             if k != "labels"}
    logits, cache = prefill(params, batch)
    pos = T_p + (cfg.n_patches if cfg.family == "vlm" else 0)
    all_logits, tokens = [], []
    for i in range(steps + 1):
        last = logits.full_tensor()[:, -1]
        all_logits.append(last.tolist())
        tokens.append(last.argmax(-1).tolist())
        if i == steps:
            break
        tok = torch.tensor(tokens[-1], dtype=torch.int32)[:, None]
        logits, cache = decode(params, {"token": tok, "pos": pos + i,
                                        "cache": cache})
    nbytes = [None] * dist.get_world_size()
    dist.all_gather_object(nbytes, sum(
        x.to_local().numel() * x.element_size() for x in tree_leaves(cache)))
    for k in VARIANTS[variant]:
        os.environ.pop(k)
    return all_logits, tokens, nbytes


def _group_collectives(ref_params):
    """On meshes (2, 1) and (1, 2) of the two ranks: the collectives one
    train step, one prefill and one decode step of reduced llama3.2-3b
    issue on the "model" group and on the "data" group
    (``launch.cost.trace``'s ``group_calls``: one-rank groups too)."""
    from repro_torch.distributed import steps as ST
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.launch import cost as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import params_from_jax
    from torch.distributed.tensor import DTensor

    arch = "llama3.2-3b"
    cfg = config(arch)
    out = {}
    for shape in ((2, 1), (1, 2)):
        mesh = make_mesh(shape, device="cpu")
        step, place = ST.make_train_step(cfg, mesh)
        state = ST.init_train_state(
            cfg, mesh, place,
            params=params_from_jax(ref_params[arch], device="cpu"))
        prefill, p_place = ST.make_prefill_step(cfg, mesh)
        decode, _ = ST.make_decode_step(cfg, mesh)
        params = reshard_state(params_from_jax(ref_params[arch],
                                               device="cpu"), mesh, p_place)
        b = batches(cfg, 1)[0]

        def steps():
            step(state, b)
            logits, cache = prefill(params, {"tokens": b["tokens"]})
            tok = logits.to_local()[:, -1].argmax(-1)[:, None].int()
            tok = DTensor.from_local(tok, mesh, logits.placements,
                                     run_check=False)
            decode(params, {"token": tok, "pos": T, "cache": cache})

        calls = C.trace(steps).group_calls
        out[f"{shape[0]}x{shape[1]}"] = {
            ax: calls.get(mesh.get_group(ax).group_name, 0)
            for ax in ("data", "model")}
    return out


def _saved_carries(ref_params, variant):
    """One train loss and its backward of reduced llama3.2-3b on the (1,
    4) mesh under ``variant``'s switches, the tensors autograd saves
    recorded (``torch.autograd.graph.saved_tensors_hooks``; the remat
    unit's input is saved outside its region) and each unit's carry,
    the input ``models.lm._unit_train`` takes: [each carry's shape and
    whether it is among the saved tensors], and the whole stream's
    (B, T, d)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import steps as ST
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm as LM
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.adamw import tree_map

    os.environ.update(VARIANTS[variant])
    cfg = config("llama3.2-3b")
    mesh = make_mesh((1, 4), device="cpu")
    _, place = ST.make_train_step(cfg, mesh)
    params = reshard_state(params_from_jax(ref_params["llama3.2-3b"],
                                           device="cpu"), mesh,
                           place["params"])
    params = tree_map(lambda t: t.detach().requires_grad_(True), params)
    b = {k: torch.from_numpy(v) for k, v in batches(cfg, 1)[0].items()}
    saved, carries = [], []
    unit = LM._unit_train

    def record(cfg_, snap, unit_p, x, *args):
        carries.append(x)
        return unit(cfg_, snap, unit_p, x, *args)

    LM._unit_train = record
    try:
        with SH.use_mesh(mesh), \
                torch.autograd.graph.saved_tensors_hooks(
                    lambda t: saved.append(t) or t, lambda t: t):
            loss = LM.train_loss(cfg, params, b)
        loss.backward()
    finally:
        LM._unit_train = unit
        for k in VARIANTS[variant]:
            os.environ.pop(k)
    first = carries[:cfg.unit_count()]      # the forward's, not the remat's
    return ([[list(x.shape), any(t is x for t in saved)] for x in first],
            [B, T, cfg.d_model])


#: The context-parallel layer's length: the window (32) cuts its keys.
CP_T = 64


def _cp_attention(kind):
    """A reduced gemma2-2b attention layer (``kind`` "causal" or "local":
    a window of 32 with softcap) trained on a (1, 4) mesh under
    ``REPRO_ATTN_IMPL=flash`` (context-parallel: each rank's 16 rows of
    the 64) against the whole layer on the whole input: the largest
    differences of y, of the gradients of x and of every leaf (the loss
    sum(y * w), w seeded), and of the prefill's output (B4's plain
    version at the rows' offset) and cache, each relative to the
    whole's largest."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention as A
    from repro_torch.optim.adamw import tree_map

    cfg = config("gemma2-2b")
    p = tree_map(lambda t: t.requires_grad_(True),
                 A.attn_init(torch.Generator().manual_seed(7), cfg))
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal(
        (B, CP_T, cfg.d_model)).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    pos = torch.arange(CP_T, dtype=torch.int32)
    y = A.attention_train(cfg, p, x, pos, kind)
    (y * w).sum().backward()
    with torch.no_grad():
        yp, cache = A.attention_fullseq(cfg, p, x.detach(), pos, kind)
    want = {"y": y.detach(), "x": x.grad, "prefill": yp,
            **{f"cache/{k}": v for k, v in cache.items()},
            **{k: v.grad for k, v in p.items()}}

    mesh = make_mesh((1, 4), device="cpu")
    pd = tree_map(lambda t: t.detach().requires_grad_(True),
                  reshard_state(tree_map(lambda t: t.detach(), p), mesh,
                                SH.param_placements(p, mesh)))
    os.environ["REPRO_ATTN_IMPL"] = "flash"
    try:
        with SH.use_mesh(mesh):
            xl = TP.scatter_seq(x.detach()).requires_grad_(True)
            y = A.attention_train(cfg, SH.gather_tree(pd), xl, pos, kind,
                                  seq=True)
            (y * TP.scatter_seq(w)).sum().backward()
            with torch.no_grad():
                yp, cache = A.attention_fullseq(cfg, SH.gather_tree(pd),
                                                xl.detach(), pos, kind,
                                                seq=True)
            got = {"y": TP.gather_from_model(y.detach(), 1),
                   "x": TP.gather_from_model(xl.grad, 1),
                   "prefill": TP.gather_from_model(yp, 1),
                   **{f"cache/{k}": v.full_tensor()
                      for k, v in cache.items()},
                   **{k: v.grad.full_tensor() for k, v in pd.items()}}
    finally:
        os.environ.pop("REPRO_ATTN_IMPL")
    return {k: float((got[k] - want[k]).abs().max()
                     / want[k].abs().max()) for k in want}


def _unsharded_vs_mesh(ref_params):
    """``launch.train.train`` on one device and on a (1, 1) mesh."""
    from repro_torch.core import characterize as TC
    from repro_torch.launch import train as TL
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import params_from_jax

    stats = TC.ConditionStats(365.0, 1000.0, 2.0, 5.0, 0.7, 0.4, 0.1, 0.8)
    hist = np.array([0.0, 0.5, 0.3, 0.2])
    TC.load_tables({(365.0, 1000.0): stats},
                   {(365.0, 1000.0, pt, False, s): hist
                    for pt in ("lsb", "csb", "msb") for s in (1.0, 0.8)})
    cfg = config("llama3.2-3b")
    kw = dict(steps=4, batch=B, seq=T, log=lambda *_: None)
    plain = TL.train(cfg, device="cpu",
                     params=params_from_jax(ref_params["llama3.2-3b"],
                                            device="cpu"), **kw)
    mesh = make_mesh((1, 1), device="cpu")
    sharded = TL.train(cfg, mesh=mesh,
                       params=params_from_jax(ref_params["llama3.2-3b"],
                                              device="cpu"), **kw)
    return ([plain.losses[i] for i in sorted(plain.losses)],
            [sharded.losses[i] for i in sorted(sharded.losses)])


def _sharded_compress(ref_params):
    """``compress_grads`` (two steps, error feedback) and ``global_norm``
    on a seeded gradient tree as DTensors on the (2, 2) mesh's parameter
    placements, against the same tree whole: (outputs and feedback
    gathered equal bit for bit, the two norms)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.compress import compress_grads
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import global_norm, tree_leaves, tree_map

    mesh = make_mesh((2, 2), device="cpu")
    params = ref_params["llama3.2-3b"]
    rng = np.random.default_rng(11)
    grads = [tree_map(lambda p: torch.from_numpy(
        (rng.standard_normal(p.shape) * 10.0 ** -k).astype(np.float32)),
        params) for k in range(2)]
    place = SH.param_placements(params, mesh)
    plain_ef = sharded_ef = None
    equal = True
    for g in grads:
        want, plain_ef = compress_grads(g, plain_ef)
        got, sharded_ef = compress_grads(reshard_state(g, mesh, place),
                                         sharded_ef)
        for a, b in zip(tree_leaves(got) + tree_leaves(sharded_ef),
                        tree_leaves(want) + tree_leaves(plain_ef)):
            equal &= torch.equal(a.full_tensor(), b)
    norms = [float(global_norm(reshard_state(grads[0], mesh, place))),
             float(global_norm(grads[0]))]
    return bool(equal), norms


def _worker(rank, world, work_dir):
    from repro_torch.checkpoint import restore, save
    from repro_torch.distributed import steps as ST
    from repro_torch.distributed.elastic import build_mesh_from_plan, plan_mesh
    from repro_torch.optim.adamw import tree_leaves

    torch.set_num_threads(1)
    work = Path(work_dir)
    store = dist.FileStore(str(work / f"store_{world}"), world)
    # A stuck collective raises (and fails the spawn) instead of hanging.
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        cases = json.loads((work / "cases.json").read_text())
        ref = pickle.loads((work / "params.pkl").read_bytes())
        out = {"train": {}, "bytes": {}, "moe": {}, "serve": {},
               "dense_moe": {}, "recurrent": {}}
        for arch, shape, ep, steps, *variant in cases["train"]:
            if shape[0] * shape[1] != world:
                continue
            tag = "/".join([arch, f"{shape[0]}x{shape[1]}", f"ep{ep}"]
                           + variant)
            metrics, _, nbytes = _train(arch, shape, ep, steps,
                                        ref["params"], variant=
                                        variant[0] if variant else "")
            got = [None] * world
            dist.all_gather_object(got, nbytes)
            out["train"][tag], out["bytes"][tag] = metrics, got
        for shape in cases["moe"]:
            if shape[0] * shape[1] == world:
                out["moe"][f"{shape[0]}x{shape[1]}"] = _moe(shape, ref)
        for shape, T_moe in cases.get("dense_moe", []):
            if shape[0] * shape[1] == world:
                out["dense_moe"][f"{shape[0]}x{shape[1]}/T{T_moe}"] = \
                    _dense_moe(shape, ref, T_moe)
        for arch, shape, *widths in cases.get("recurrent", []):
            if shape[0] * shape[1] == world:
                tag = "/".join([arch, f"{shape[0]}x{shape[1]}"] + widths)
                out["recurrent"][tag] = _recurrent_divided(shape, arch,
                                                           *widths)
        for arch, shape, *variant in cases.get("serve", []):
            if shape[0] * shape[1] == world:
                tag = "/".join([arch, f"{shape[0]}x{shape[1]}"] + variant)
                out["serve"][tag] = _serve(arch, shape, ref["params"],
                                           *variant)
        arch = "llama3.2-3b"
        bs = batches(config(arch), 4, seed=1)
        ckpt = work / "elastic_ckpt"
        if world == 1:
            out["plain_vs_mesh"] = _unsharded_vs_mesh(ref["params"])
        if world == 4:
            out["saved"] = {v: _saved_carries(ref["params"], v)
                            for v in ("", "flash")}
            out["cp_attention"] = {k: _cp_attention(k)
                                   for k in ("causal", "local")}
            # Two steps at (2, 2), then the state to host numpy and disk.
            metrics, state, _ = _train(arch, (2, 2), 0, 2, ref["params"],
                                       bs=bs[:2])
            host = ST.host_state(state)
            if rank == 0:
                save(ckpt, host)
            out["elastic_saved"] = metrics
            out["compress"] = _sharded_compress(ref["params"])
        if world == 2:
            out["groups"] = _group_collectives(ref["params"])
            plan = plan_mesh(2, (2, 2), global_batch=B)
            cfg = config(arch)
            mesh = build_mesh_from_plan(plan, device="cpu")
            _, place = ST.make_train_step(cfg, mesh)
            host, _ = restore(ckpt, ST.make_train_state_specs(cfg, mesh)[0])
            state = ST.place_train_state(host, mesh, place)
            # every local shard is the saved host array's slice, bitwise
            back = ST.host_state(state)
            exact = all(np.array_equal(np.asarray(a), np.asarray(b))
                        for a, b in zip(tree_leaves(back),
                                        tree_leaves(host)))
            resumed, _, _ = _train(arch, plan.new_shape, 0, 2, None,
                                   bs=bs[2:], state=state)
            unbroken, _, _ = _train(arch, plan.new_shape, 0, 4,
                                    ref["params"], bs=bs)
            out["elastic"] = dict(plan=list(plan.new_shape), exact=exact,
                                  resumed=resumed, unbroken=unbroken[2:])
        if rank == 0:
            (work / f"port_{world}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def run(world: int, work_dir) -> dict:
    mp.spawn(_worker, args=(world, str(work_dir)), nprocs=world)
    return json.loads((Path(work_dir) / f"port_{world}.json").read_text())


def _cost_worker(rank, world, work_dir):
    """Each case of ``work_dir/cost_cases.json`` (``[arch, kind, [data,
    model], variant, [shape name, seq_len, global batch]]``, reduced
    configs) built by ``build_cell`` on a gloo mesh and run once for
    real under ``launch.cost.trace``, on seeded parameters (bfloat16 for
    serving) and a seeded batch (a decode's cache whole, each rank
    keeping its shard); rank 0 writes each case's collectives
    to ``work_dir/cost_<world>.json``."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import steps as ST
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.launch import cost as C
    from repro_torch.launch.dryrun import collective_bytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import tree_map

    torch.set_num_threads(1)
    work = Path(work_dir)
    store = dist.FileStore(str(work / f"cost_store_{world}"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        out = {}
        for arch, kind, mesh_shape, variant, shp in json.loads(
                (work / "cost_cases.json").read_text()):
            cfg = reduced_config(get_config(arch))
            shape = ShapeConfig(shp[0], shp[1], shp[2], kind)
            mesh = make_mesh(tuple(mesh_shape), device="cpu")
            # The flash variant's stand-ins have no real implementation:
            # the real run takes the scans they stand for, which issue
            # the same collectives (none of their own).
            os.environ.update({"REPRO_ATTN_IMPL": "flash"}
                              if "flash" in variant.split("+") else {})
            step, (_, specs), (place, _) = ST.build_cell(cfg, shape, mesh)
            if kind == "train":
                arg0 = ST.init_train_state(cfg, mesh, place, seed=0)
            else:
                gen = torch.Generator().manual_seed(0)
                params = tree_map(lambda p: p.to(torch.bfloat16),
                                  build_model(cfg, "cpu", gen).init())
                arg0 = reshard_state(params, mesh, place)
            gen = torch.Generator().manual_seed(1)

            def leaf(v):
                if not v.is_floating_point():
                    return torch.randint(0, cfg.vocab, v.shape, generator=gen,
                                         dtype=v.dtype)
                return torch.randn(v.shape, generator=gen).to(v.dtype)

            # A decode's cache (nested) is drawn whole: the step keeps
            # each rank's shard; its pos is the dry-run's, seq_len.
            batch = {k: shape.seq_len if k == "pos" else tree_map(leaf, v)
                     for k, v in specs.items()}
            tr = C.trace(step, arg0, batch)
            os.environ.pop("REPRO_ATTN_IMPL", None)
            out[f"{arch}/{kind}/{mesh_shape[0]}x{mesh_shape[1]}/{variant}"] = \
                collective_bytes(tr.cost)
        if rank == 0:
            (work / f"cost_{world}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def run_costs(world: int, work_dir) -> dict:
    """:func:`_cost_worker` on ``world`` gloo ranks; rank 0's results."""
    mp.spawn(_cost_worker, args=(world, str(work_dir)), nprocs=world)
    return json.loads((Path(work_dir) / f"cost_{world}.json").read_text())
