"""Training from the command line: the reference's ``repro.launch.train``
over ``torch.distributed``.

  mesh (every rank of the process group) -> sharded train state
  -> corpus -> FlashTierReader (simulated SSD reads under a retry policy)
  -> PrefetchPipeline (pinned host memory, copy on a side stream)
  -> sharded train step (loss, backward through rematerialized units,
     global-norm clip, AdamW with a cosine schedule)
  -> CheckpointManager (CRC shards + XOR parity) every N steps: every
     rank gathers the state to host numpy and rank 0 writes; a restore
     is re-placed on the current mesh (``distributed.elastic``), so a
     run saved on one mesh resumes on another
  -> heartbeat monitor, and on a failed step the restart policy: retry,
     abort, or shrink (the elastic plan is printed and the launcher
     exits with 3 for the orchestrator to restart on it).

Usage (the card is the default device; ``torchrun`` gives the ranks,
one device each, and one rank runs alone without it):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --smoke --device cpu

``--shape`` takes a production shape (``train_4k``) on the production
mesh (16 x 16 ranks) and raises on any other world size.  ``--dry-run``
is the dry-run's and raises (ROADMAP D15b).  :func:`train` without a
mesh is the single-device loop; with a (1, 1) mesh its losses are the
same bit for bit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, reduced_config
from repro_torch.core.retry import RetryPolicy
from repro_torch.data import (CorpusConfig, FlashTierReader,
                              PrefetchPipeline, SyntheticCorpus)
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import steps as ST
from repro_torch.distributed.elastic import ElasticPlan, plan_mesh
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     RestartPolicy)
from repro_torch.flashsim.config import OperatingCondition
from repro_torch.launch import mesh as M
from repro_torch.models import build_model
from repro_torch.models.api import frontend_zeros
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     cosine_schedule, init_opt_state,
                                     tree_leaves, tree_map)

#: Linear warmup steps of the cosine schedule.
WARMUP = 2


@dataclasses.dataclass
class TrainRun:
    """What :func:`train` did: losses by step (1-based), where it
    started, and the timings and statistics of its layers."""

    losses: dict
    start_step: int
    step_s: list
    reader: FlashTierReader
    pipeline: PrefetchPipeline
    restore_stats: object = None
    save_s: list = dataclasses.field(default_factory=list)
    state: dict = None
    grad_norms: dict = dataclasses.field(default_factory=dict)


class ShrinkRequired(RuntimeError):
    """A failed step the restart policy answers with a smaller mesh."""

    def __init__(self, plan: ElasticPlan):
        super().__init__(plan.describe())
        self.plan = plan


def make_state(cfg: ModelConfig, device, params=None, seed: int = 0,
               opt: Optional[AdamWConfig] = None) -> dict:
    """``{"params", "opt"}``: parameters (drawn from ``seed`` unless
    given) as leaves that require grad, and zero AdamW moments."""
    dev = resolve_device(device)
    if params is None:
        model = build_model(cfg, dev, torch.Generator(dev).manual_seed(seed))
        params = model.init()
    params = tree_map(lambda p: p.to(dev).detach().requires_grad_(True),
                      params)
    opt = opt or AdamWConfig(moment_dtype=cfg.moment_dtype)
    return {"params": params, "opt": init_opt_state(params, opt)}


def train_step(loss_fn: Callable, state: dict, batch: dict,
               opt: AdamWConfig, lr_scale=1.0) -> torch.Tensor:
    """One step in place: the loss's gradients, then AdamW.  Returns the
    (detached) loss."""
    params = state["params"]
    loss = loss_fn(params, batch)
    loss.backward()
    grads = tree_map(lambda p: p.grad, params)
    adamw_update(grads, state["opt"], params, opt, lr_scale)
    for p in tree_leaves(params):
        p.grad = None
    return loss.detach()


def load_into(state: dict, restored: dict) -> None:
    """Copy a restored state into ``state``'s tensors, in place."""
    with torch.no_grad():
        tree_map(lambda dst, src: dst.copy_(src), state["params"],
                 restored["params"])
        tree_map(lambda dst, src: dst.copy_(src), state["opt"]["m"],
                 restored["opt"]["m"])
        tree_map(lambda dst, src: dst.copy_(src), state["opt"]["v"],
                 restored["opt"]["v"])
        state["opt"]["step"] = restored["opt"]["step"].to(
            state["opt"]["step"].device)


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          device=None, ckpt_dir=None, save_every: int = 10,
          mechanism: str = "pr2ar2",
          condition: OperatingCondition = OperatingCondition(365.0, 1000.0),
          params=None, seed: int = 0, opt: Optional[AdamWConfig] = None,
          stop_after: Optional[int] = None, log=print, mesh=None
          ) -> TrainRun:
    """Run (or resume) a training run of ``steps`` steps on ``device``,
    or with ``mesh`` (a ``DeviceMesh``) sharded over its ranks.

    With ``ckpt_dir`` a checkpoint is saved every ``save_every`` steps
    and the run resumes from the newest one that verifies.
    ``stop_after`` ends the run after that step (a simulated
    interruption); the schedule still spans ``steps``.
    """
    if mesh is not None:
        return _train_sharded(cfg, mesh, steps=steps, batch=batch, seq=seq,
                              ckpt_dir=ckpt_dir, save_every=save_every,
                              mechanism=mechanism, condition=condition,
                              params=params, seed=seed, opt=opt,
                              stop_after=stop_after, log=log)
    dev = resolve_device(device)
    opt = opt or AdamWConfig(moment_dtype=cfg.moment_dtype)
    model = build_model(cfg, dev)
    state = make_state(cfg, dev, params=params, seed=seed, opt=opt)
    mgr = CheckpointManager(ckpt_dir, keep=2, save_every=save_every) \
        if ckpt_dir is not None else None
    start, rstats = 0, None
    if mgr is not None:
        step0, restored, rstats = mgr.restore_latest(state)
        if step0 is not None:
            load_into(state, restored)
            start = step0
            log(f"resumed from step {step0} (restore "
                f"{rstats.wall_s * 1e3:.0f} ms, {rstats.n_reconstructed} "
                f"shard(s) reconstructed)")
    reader, read = _data(cfg, batch, seq, mechanism, condition, dev)
    end = steps if stop_after is None else min(steps, stop_after)
    pipe = PrefetchPipeline(read, n_batches=max(end - start, 0),
                            start_index=start, device=dev)
    run = TrainRun(losses={}, start_step=start, step_s=[], reader=reader,
                   pipeline=pipe, restore_stats=rstats, state=state)
    for i, b in pipe:
        t0 = time.perf_counter()
        lr_scale = cosine_schedule(i + 1, steps, WARMUP)
        loss = train_step(model.train_loss, state, b, opt, lr_scale)
        loss_v = float(loss)          # synchronizes the step
        run.step_s.append(time.perf_counter() - t0)
        run.losses[i + 1] = loss_v
        log(f"step {i + 1:4d} loss {loss_v:7.4f} {run.step_s[-1]:6.3f}s/step")
        if mgr is not None and mgr.should_save(i + 1):
            mgr.save(i + 1, state)
            run.save_s.append(mgr.last_save_s)
            log(f"  checkpoint @ {i + 1} ({mgr.last_save_s:.2f}s)")
    return run


def _data(cfg: ModelConfig, batch: int, seq: int, mechanism: str,
          condition: OperatingCondition, dev):
    """The flash-tier reader and its batch function: the corpus's batch
    ``i`` with the stub frontends' zero inputs (VLM patches, encoder
    frames) as the reference's launcher adds them: float32 zeros, which
    the model casts to the activation dtype."""
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seq_len=seq,
                                          batch=batch))
    reader = FlashTierReader(corpus, RetryPolicy(mechanism), condition,
                             device=dev)
    zeros = {k: v.numpy() for k, v in frontend_zeros(
        cfg, batch, "cpu", torch.float32).items()}
    return reader, lambda i: {**reader.read(i), **zeros}


def _beat_all(monitor: HeartbeatMonitor, step: int, step_s: float, dev,
              world: int) -> None:
    """Every rank's heartbeat for ``step`` into this rank's monitor: the
    ranks' step times, all-gathered."""
    times = torch.empty(world, dtype=torch.float64, device=dev)
    dist.all_gather_into_tensor(
        times, torch.tensor([step_s], dtype=torch.float64, device=dev))
    for worker, t in enumerate(times.tolist()):
        monitor.beat(worker, step, t)


def _train_sharded(cfg: ModelConfig, mesh, *, steps, batch, seq, ckpt_dir,
                   save_every, mechanism, condition, params, seed, opt,
                   stop_after, log) -> TrainRun:
    """:func:`train` on a mesh: the sharded step, rank 0's checkpoints,
    the heartbeat monitor and the restart policy."""
    dev = torch.device(mesh.device_type)
    rank, world = dist.get_rank(), mesh.size()
    opt = opt or AdamWConfig(moment_dtype=cfg.moment_dtype)
    step_fn, place = ST.make_train_step(cfg, mesh, opt)
    state = ST.init_train_state(cfg, mesh, place, params=params, seed=seed,
                                opt=opt)
    mgr = CheckpointManager(ckpt_dir, keep=2, save_every=save_every) \
        if ckpt_dir is not None else None
    start, rstats = 0, None
    if mgr is not None:
        step0, restored, rstats = mgr.restore_latest(
            ST.make_train_state_specs(cfg, mesh)[0])
        if step0 is not None:
            state = ST.place_train_state(restored, mesh, place)
            start = step0
            log(f"resumed from step {step0} on mesh "
                f"{SH.mesh_shape(mesh)} (restore {rstats.wall_s * 1e3:.0f} "
                f"ms, {rstats.n_reconstructed} shard(s) reconstructed)")
    reader, read = _data(cfg, batch, seq, mechanism, condition, dev)
    end = steps if stop_after is None else min(steps, stop_after)
    pipe = PrefetchPipeline(read, n_batches=max(end - start, 0),
                            start_index=start, device=dev)
    run = TrainRun(losses={}, start_step=start, step_s=[], reader=reader,
                   pipeline=pipe, restore_stats=rstats, state=state)
    monitor = HeartbeatMonitor(n_workers=world)
    restart = RestartPolicy()
    for i, b in pipe:
        t0 = time.perf_counter()
        try:
            state, metrics = step_fn(state, b,
                                     cosine_schedule(i + 1, steps, WARMUP))
            loss_v = float(metrics["loss"])    # synchronizes the step
        except Exception as e:   # a failed collective, a lost device
            decision = restart.on_failure(monitor, transient=True)
            log(f"step {i + 1} failed ({e}); decision: {decision.action}")
            if decision.action == "abort":
                raise
            if decision.action == "shrink":
                raise ShrinkRequired(plan_mesh(
                    world - len(decision.dead_workers),
                    tuple(SH.mesh_shape(mesh).values()),
                    tuple(mesh.mesh_dim_names), batch)) from e
            continue
        run.step_s.append(time.perf_counter() - t0)
        _beat_all(monitor, i + 1, run.step_s[-1], dev, world)
        run.losses[i + 1] = loss_v
        run.grad_norms[i + 1] = float(metrics["grad_norm"])
        log(f"step {i + 1:4d} loss {loss_v:7.4f} {run.step_s[-1]:6.3f}s/step")
        if mgr is not None and mgr.should_save(i + 1):
            host = ST.host_state(state)      # every rank gathers
            if rank == 0:
                mgr.save(i + 1, host)
                run.save_s.append(mgr.last_save_s)
                log(f"  checkpoint @ {i + 1} ({mgr.last_save_s:.2f}s)")
            dist.barrier()
    run.state = state
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, batch 4 x 64 tokens")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_ckpt"))
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--retry-mechanism", default="pr2ar2")
    ap.add_argument("--shape", default=None, choices=sorted(
        k for k, v in SHAPES.items() if v.kind == "train"),
                    help="a production shape, on the 16 x 16 production "
                         "mesh (256 ranks)")
    ap.add_argument("--dry-run", action="store_true",
                    help="lower and count on the production mesh "
                         "(ROADMAP D15b)")
    args = ap.parse_args(argv)

    if args.dry_run:
        raise NotImplementedError("--dry-run is the dry-run's: "
                                  "ROADMAP D15b, the rest of item 13")
    cfg = get_config(args.arch)
    batch = args.batch or (4 if args.smoke else 2)
    seq = args.seq or (64 if args.smoke else 1024)
    if args.smoke:
        cfg = reduced_config(cfg)
    M.init_process_group(args.device)
    try:
        if args.shape is not None:
            mesh = M.make_production_mesh(device=args.device)
            shape = SHAPES[args.shape]
            batch, seq = shape.global_batch, shape.seq_len
        else:
            mesh = M.make_host_mesh(device=args.device)
        rank = dist.get_rank()
        log = print if rank == 0 else (lambda *_: None)
        log(f"mesh {SH.mesh_shape(mesh)} on {mesh.device_type} | arch "
            f"{cfg.name} | {cfg.n_layers} layers | batch {batch} x {seq}")
        try:
            run = train(cfg, steps=args.steps, batch=batch, seq=seq,
                        ckpt_dir=args.ckpt_dir, save_every=args.save_every,
                        mechanism=args.retry_mechanism, mesh=mesh, log=log)
        except ShrinkRequired as e:
            log(f"elastic plan: {e.plan.describe()}")
            raise SystemExit(3) from e
        st = run.reader.stats
        log(f"flash tier: {st.batches} batches, {st.pages} pages, "
            f"{st.attempts} attempts, {st.mean_batch_us:.1f} us/batch | "
            f"input stall {run.pipeline.stall_s:.3f}s")
        log("training run complete")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
