"""The port's sharded steps on gloo meshes of CPU ranks, for
``tests/test_torch_sharded_step.py``: one ``torch.multiprocessing``
spawn a world size, the ranks meeting through a ``FileStore`` (no fixed
port).  Imports no JAX.

``run(world, work_dir)`` reads ``work_dir/cases.json`` and the
reference's initial parameters (``work_dir/params.pkl``: nested numpy
trees by arch, and the MoE case's layer and input), runs the cases of
that world size and writes ``work_dir/port_<world>.json`` from rank 0.
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
#: Depths other than the reduced config's (recurrentgemma with a tail).
OVERRIDES = {"recurrentgemma-2b": dict(n_layers=8)}


def config(arch):
    from repro_torch.configs import get_config, reduced_config

    return dataclasses.replace(reduced_config(get_config(arch)),
                               activation_dtype="float32",
                               **OVERRIDES.get(arch, {}))


def batches(cfg, steps, seed=0):
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


def _train(arch, shape, ep, steps, ref_params, bs=None, state=None):
    """Sharded steps on a mesh of ``shape``: (metrics, state, this
    rank's state bytes)."""
    from repro_torch.distributed import steps as ST
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import params_from_jax

    os.environ["REPRO_MOE_EP"] = str(ep)
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
        out = {"train": {}, "bytes": {}, "moe": {}}
        for arch, shape, ep, steps in cases["train"]:
            if shape[0] * shape[1] != world:
                continue
            tag = f"{arch}/{shape[0]}x{shape[1]}/ep{ep}"
            metrics, _, nbytes = _train(arch, shape, ep, steps,
                                        ref["params"])
            got = [None] * world
            dist.all_gather_object(got, nbytes)
            out["train"][tag], out["bytes"][tag] = metrics, got
        for shape in cases["moe"]:
            if shape[0] * shape[1] == world:
                out["moe"][f"{shape[0]}x{shape[1]}"] = _moe(shape, ref)
        arch = "llama3.2-3b"
        bs = batches(config(arch), 4, seed=1)
        ckpt = work / "elastic_ckpt"
        if world == 1:
            out["plain_vs_mesh"] = _unsharded_vs_mesh(ref["params"])
        if world == 4:
            # Two steps at (2, 2), then the state to host numpy and disk.
            metrics, state, _ = _train(arch, (2, 2), 0, 2, ref["params"],
                                       bs=bs[:2])
            host = ST.host_state(state)
            if rank == 0:
                save(ckpt, host)
            out["elastic_saved"] = metrics
            out["compress"] = _sharded_compress(ref["params"])
        if world == 2:
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
    serving) and a seeded batch; rank 0 writes each case's collectives
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
            step, (_, specs), (place, _) = ST.build_cell(cfg, shape, mesh)
            if kind == "train":
                arg0 = ST.init_train_state(cfg, mesh, place, seed=0)
            else:
                gen = torch.Generator().manual_seed(0)
                params = tree_map(lambda p: p.to(torch.bfloat16),
                                  build_model(cfg, "cpu", gen).init())
                arg0 = reshard_state(params, mesh, place)
            gen = torch.Generator().manual_seed(1)
            batch = {k: (torch.randint(0, cfg.vocab, v.shape, generator=gen,
                                       dtype=v.dtype)
                         if not v.is_floating_point() else
                         torch.randn(v.shape, generator=gen).to(v.dtype))
                     for k, v in specs.items()}
            tr = C.trace(step, arg0, batch)
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
