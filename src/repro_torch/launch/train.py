"""Training from the command line, on one device: the reference's
``repro.launch.train`` loop without its mesh.

  corpus -> FlashTierReader (simulated SSD reads under a retry policy)
  -> PrefetchPipeline (pinned host memory, copy on a side stream)
  -> train step (loss, backward through rematerialized units,
     global-norm clip, AdamW with a cosine schedule)
  -> CheckpointManager (CRC shards + XOR parity) every N steps,
     resuming from the newest checkpoint that verifies.

Usage (the card is the default device):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

Meshes, sharded steps, elastic restart plans, the heartbeat monitor,
``--shape`` (the reference's production-mesh shapes) and ``--dry-run``
are the distributed half of the reference's launcher and raise
``NotImplementedError`` (ROADMAP D15, item 13).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, reduced_config
from repro_torch.core.retry import RetryPolicy
from repro_torch.data import (CorpusConfig, FlashTierReader,
                              PrefetchPipeline, SyntheticCorpus)
from repro_torch.device import resolve_device
from repro_torch.flashsim.config import OperatingCondition
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
          stop_after: Optional[int] = None, log=print) -> TrainRun:
    """Run (or resume) a training run of ``steps`` steps on ``device``.

    With ``ckpt_dir`` a checkpoint is saved every ``save_every`` steps
    and the run resumes from the newest one that verifies.
    ``stop_after`` ends the run after that step (a simulated
    interruption); the schedule still spans ``steps``.
    """
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
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seq_len=seq,
                                          batch=batch))
    reader = FlashTierReader(corpus, RetryPolicy(mechanism), condition,
                             device=dev)
    # The stub frontends' zero inputs (VLM patches, encoder frames), as
    # the reference's launcher adds them: float32 zeros, which the model
    # casts to the activation dtype.
    zeros = {k: v.numpy() for k, v in frontend_zeros(
        cfg, batch, "cpu", torch.float32).items()}

    def read(i):
        return {**reader.read(i), **zeros}

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
    ap.add_argument("--shape", default=None,
                    help="a production-mesh shape (not ported: one device)")
    ap.add_argument("--dry-run", action="store_true",
                    help="lower+compile on the production mesh (not ported)")
    args = ap.parse_args(argv)

    if args.dry_run:
        raise NotImplementedError("--dry-run is TPU dry-run tooling: "
                                  "ROADMAP item 13")
    if args.shape is not None:
        raise NotImplementedError("production-mesh shapes, sharded train "
                                  "steps, elastic restart plans and the "
                                  "heartbeat monitor are not ported: "
                                  "ROADMAP D15")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    batch = args.batch or (4 if args.smoke else 2)
    seq = args.seq or (64 if args.smoke else 1024)
    print(f"device {resolve_device(args.device)} | arch {cfg.name} | "
          f"{cfg.n_layers} layers | batch {batch} x {seq}")
    run = train(cfg, steps=args.steps, batch=batch, seq=seq,
                device=args.device, ckpt_dir=args.ckpt_dir,
                save_every=args.save_every, mechanism=args.retry_mechanism)
    st = run.reader.stats
    print(f"flash tier: {st.batches} batches, {st.pages} pages, "
          f"{st.attempts} attempts, {st.mean_batch_us:.1f} us/batch | "
          f"input stall {run.pipeline.stall_s:.3f}s")
    print("training run complete")


if __name__ == "__main__":
    main()
