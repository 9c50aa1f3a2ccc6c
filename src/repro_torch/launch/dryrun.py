"""Multi-pod dry-run: trace and count every (arch x shape x mesh) cell.

The proof that the distribution config holds together at production
scale without the hardware, in torch's terms: each cell's step runs once
on fake tensors (``FakeTensorMode``) on device ``"cuda"`` over a fake
process group (torch's ``fake`` backend) of the mesh's world size, 256
ranks (16 x 16) or 512 (2 x 16 x 16), rank 0 traced.  No tensor holds
data and no collective moves any: the trace is the card's program, with
B4 and B5 reached through their custom ops' fake implementations.  Its
counts (``launch.cost``) give each rank's share:

  * memory: the arguments' and outputs' bytes on the cell's placements
    (the reference's ``memory_analysis``), what the port's step takes and
    returns on the rank (its serve steps take and return global
    batches), and the peak of the live storages the step makes; whether
    that total fits the card (:data:`CARD_MEMORY_BYTES`);
  * FLOPs (products as ``dot``, the custom ops as ``kernel``), eager
    bytes, transcendentals;
  * collectives by kind: count, output bytes and ring traffic.

These are counts of the program, not times.  Records go to
``results/dryrun_torch/<arch>__<shape>__<mesh>[__<variant>].json`` (the
reference's keys; its ``lower_s`` and ``compile_s`` become ``trace_s``).
Each cell runs in a process of its own, since one fake group has one
world size; on a host whose torch has no CUDA that process loads the
stand-ins of ``launch.fake_cuda`` first.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --jobs 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"

#: The card a rank's total is held against: ``torch.cuda.
#: get_device_properties(0).total_memory`` as ``chip_smoke.py``'s phase
#: 20 reads it on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit.
CARD_MEMORY_BYTES = 85017493504
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"

#: Variants and the switches they set (``REPRO_KV_INT8``,
#: ``REPRO_MOE_EP``); ``flash`` and ``ssdk`` are the reference's kernel
#: stand-ins (``kernels/opaque.py``), ROADMAP D15b-2.
VARIANT_ENV = {"kvint8": "REPRO_KV_INT8", "ep": "REPRO_MOE_EP"}
LATER = ("flash", "ssdk")
VARIANT_NOTE = ("the port's prefill always runs B4 (repro_torch::"
                "flash_attention) and B5 (repro_torch::ssd_scan) as custom "
                "ops; its training and decode steps run neither")
SKIP_REASON = ("full-attention decode over 524k ctx is quadratic; skipped "
               "per task rule (DESIGN.md §6)")
#: A cell's limit, in seconds, under ``--all``.
CELL_TIMEOUT_S = 900


def variant_flags(variant: str) -> set:
    """The flags of ``base`` or a ``+`` join of ``kvint8`` and ``ep``."""
    flags = set() if variant == "base" else set(variant.split("+"))
    later = flags & set(LATER)
    if later:
        raise NotImplementedError(
            f"variant {'+'.join(sorted(later))}: the reference's kernel "
            f"stand-ins are ROADMAP D15b-2")
    unknown = flags - set(VARIANT_ENV)
    if unknown:
        raise ValueError(f"unknown variant flags {sorted(unknown)}; known: "
                         f"base, {', '.join(VARIANT_ENV)}, {', '.join(LATER)}")
    return flags


def mesh_dims(mesh_kind: str):
    """(shape, axis names) of ``single`` (16 x 16), ``multi`` (2 x 16 x
    16) or ``DxM`` (a ("data", "model") mesh)."""
    if mesh_kind == "single":
        return (16, 16), ("data", "model")
    if mesh_kind == "multi":
        return (2, 16, 16), ("pod", "data", "model")
    d, m = (int(x) for x in mesh_kind.split("x"))
    return (d, m), ("data", "model")


def _is_placements(t) -> bool:
    from torch.distributed.tensor.placement_types import Placement

    return isinstance(t, tuple) and len(t) > 0 and all(
        isinstance(p, Placement) for p in t)


def _tree_items(tree, path=()):
    """(path, leaf) over nested dicts, lists and tuples; a tuple of
    placements is a leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_items(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)) and not _is_placements(tree):
        for i, v in enumerate(tree):
            yield from _tree_items(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _place_items(place, spec):
    """Each leaf of ``spec`` with its placements (``None``: replicated;
    a missing placement tree replicates its whole subtree)."""
    places = dict(_tree_items(place)) if place is not None else {}
    for path, leaf in _tree_items(spec):
        p = places.get(path)
        yield path, leaf, p if _is_placements(p) else None


def _local_shape(shape, mesh, place):
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    if place is None:
        return tuple(shape)
    with unset_fake_temporarily():
        return tuple(compute_local_shape_and_global_offset(
            shape, mesh, place)[0])


def leaf_bytes(spec, place, mesh) -> dict:
    """{leaf path: its bytes on rank 0} of a tree of shapes (tensors or
    meta tensors) on its placements."""
    out = {}
    for path, leaf, p in _place_items(place, spec):
        if not hasattr(leaf, "shape"):
            continue
        n = 1
        for d in _local_shape(leaf.shape, mesh, p):
            n *= d
        out[path] = n * leaf.element_size()
    return out


def held_bytes(tree) -> int:
    """Bytes a tree of tensors holds on this rank (a DTensor: its local
    shard)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for _, t in _tree_items(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if hasattr(t, "untyped_storage"):
            total += t.numel() * t.element_size()
    return total


def _fake(leaf, place, mesh):
    """A fake CUDA tensor for a meta ``leaf``: a DTensor of its local
    shard where it has placements, the whole tensor where not."""
    import torch
    from torch.distributed.tensor import DTensor

    local = torch.empty(_local_shape(leaf.shape, mesh, place),
                        dtype=leaf.dtype, device="cuda")
    if place is None:
        return local
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=leaf.shape,
                              stride=torch.empty(leaf.shape,
                                                 device="meta").stride())


def _fake_tree(spec, place, mesh):
    from repro_torch.distributed.sharding import map_with_path

    places = dict(_tree_items(place)) if place is not None else {}

    def one(path, t):
        p = places.get("/".join(path))
        return _fake(t, p if _is_placements(p) else None, mesh)

    return map_with_path(one, spec)


def step_arguments(cfg, shape, mesh, specs, places):
    """The step's arguments as fake tensors (inside a ``FakeTensorMode``):
    the train state as DTensors on its placements (parameters requiring
    grad; AdamW's ``step`` a host scalar, which the update reads on the
    host), or the serve parameters as DTensors; the batch whole (the
    port's steps split it); a decode's ``pos`` the position after the
    cache, ``seq_len``."""
    import torch

    from repro_torch.optim.adamw import tree_map

    first, batch = specs
    first_place, _ = places
    if shape.kind == "train":
        state = {"params": _fake_tree(first["params"],
                                      first_place["params"], mesh),
                 "opt": {k: _fake_tree(first["opt"][k],
                                       first_place["params"], mesh)
                         for k in ("m", "v")}}
        tree_map(lambda p: p.requires_grad_(True), state["params"])
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        with unset_fake_temporarily():
            state["opt"]["step"] = torch.zeros((), dtype=torch.int32)
        arg0 = state
    else:
        arg0 = _fake_tree(first, first_place, mesh)
    b = {k: (shape.seq_len if k == "pos" else _fake_tree(v, None, mesh))
         for k, v in batch.items()}
    return arg0, b


def _record_path(out_dir: Path, arch, shape_name, mesh_kind, variant):
    tag = "" if variant == "base" else f"__{variant}"
    return out_dir / f"{arch}__{shape_name}__{mesh_kind}{tag}.json"


def _write(out_dir: Path, rec: dict, variant: str) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    path = _record_path(out_dir, rec["arch"], rec["shape"], rec["mesh"],
                        variant)
    path.write_text(json.dumps(rec, indent=2))
    return path


def collective_bytes(cost) -> dict:
    """Collectives of a :class:`~repro_torch.launch.cost.Cost` by kind:
    output bytes on this rank, ring traffic (the reference's
    multipliers, :data:`repro_torch.launch.cost.RING`) and counts."""
    return {"bytes": dict(cost.coll_bytes),
            "traffic": dict(cost.coll_traffic),
            "counts": {k: int(v) for k, v in cost.coll_counts.items()}}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: Optional[Path] = None, variant: str = "base", *,
             reduced: bool = False, cfg=None, shape=None) -> dict:
    """Trace one cell on a fake process group and write its record.

    ``mesh_kind``: ``single``, ``multi`` or ``DxM``; ``variant``:
    ``base`` or a ``+`` join of ``kvint8`` and ``ep`` (``flash`` and
    ``ssdk`` raise: ROADMAP D15b-2); ``reduced`` takes the arch's reduced
    config; ``cfg`` and ``shape`` replace the arch's config and the
    named shape.  Opens a fake group of the mesh's world size (rank 0)
    unless a process group is open, and closes what it opened.  Needs a
    process where fake CUDA tensors trace (``launch.fake_cuda.ready``).
    """
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import SHAPES, get_config, reduced_config
    from repro_torch.distributed import steps as ST
    from repro_torch.launch import cost as C
    from repro_torch.launch import fake_cuda
    from repro_torch.launch import mesh as M

    flags = variant_flags(variant)
    out_dir = RESULTS_DIR if out_dir is None else Path(out_dir)
    if cfg is None:
        cfg = get_config(arch)
        if reduced:
            cfg = reduced_config(cfg)
    shape = SHAPES[shape_name] if shape is None else shape
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "variant": variant}
    if shape_name == "long_500k" and not cfg.supports_long_context:
        rec = dict(base, status="skipped", reason=SKIP_REASON)
        _write(out_dir, rec, variant)
        return rec
    if not fake_cuda.ready():
        raise RuntimeError("fake CUDA tensors do not trace in this process "
                           "(torch without CUDA): run the cell through "
                           "launch.fake_cuda.python_cmd")

    dims, names = mesh_dims(mesh_kind)
    world = 1
    for d in dims:
        world *= d
    opened = not dist.is_initialized()
    if opened:
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    saved = {v: os.environ.get(v) for v in VARIANT_ENV.values()}
    try:
        for flag, var in VARIANT_ENV.items():
            os.environ[var] = "1" if flag in flags else "0"
        mesh = M.make_mesh(dims, names, device="cuda")
        t0 = time.perf_counter()
        step, specs, places = ST.build_cell(cfg, shape, mesh)
        arg_leaves = {}
        for i, (s, p) in enumerate(zip(specs, places)):
            for k, v in leaf_bytes(s, p, mesh).items():
                arg_leaves[f"{i}/{k}"] = v
        with FakeTensorMode(allow_non_fake_inputs=True):
            args = step_arguments(cfg, shape, mesh, specs, places)
            step_arg_bytes = held_bytes(args)
            tr = C.trace(step, *args)
            out_place = ST.cell_output_placements(cfg, shape, mesh, tr.out)
            out_bytes = sum(leaf_bytes(tr.out, out_place, mesh).values())
            step_out_bytes = held_bytes(tr.out)
        trace_s = time.perf_counter() - t0
    finally:
        for var, v in saved.items():
            if v is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = v
        if opened:
            dist.destroy_process_group()

    cost, split = tr.cost, tr.breakdown()
    total = step_arg_bytes + tr.peak_bytes
    coll = collective_bytes(cost)
    rec = dict(
        base, status="ok", n_devices=world, device="cuda",
        reduced=cfg != get_config(arch), trace_s=round(trace_s, 2),
        flops_per_device=cost.flops, flops_breakdown=split,
        bytes_accessed_per_device=cost.bytes,
        transcendentals=cost.transcendentals,
        xla_cost_analysis={
            "flops": cost.flops, "bytes_accessed": cost.bytes,
            "transcendentals": cost.transcendentals,
            "note": "no XLA in the port: the eager trace's counts above, "
                    "every loop trip run"},
        memory={
            "argument_bytes": sum(arg_leaves.values()),
            "output_bytes": out_bytes,
            "temp_bytes": tr.peak_bytes,
            "alias_bytes": None,
            "generated_code_bytes": None,
            "step_argument_bytes": step_arg_bytes,
            "step_output_bytes": step_out_bytes,
            "total_bytes": total,
            "card_bytes": CARD_MEMORY_BYTES,
            "card": CARD,
            "fits": total <= CARD_MEMORY_BYTES,
            "note": "argument/output bytes: the local shards on the "
                    "cell's placements (the reference's); step_*: what "
                    "the port's step holds on the rank (serve steps take "
                    "and return global batches); temp: the eager peak of "
                    "the live storages the step made; total = "
                    "step_argument + temp.  alias and generated code: "
                    "null, as eager torch donates no buffer and "
                    "generates no code."},
        fits=total <= CARD_MEMORY_BYTES,
        collectives=coll,
        collectives_loop_body_once=coll,
        kernel_calls={
            "flash_attention": tr.calls.get("repro_torch.flash_attention",
                                            0),
            "ssd_scan": tr.calls.get("repro_torch.ssd_scan", 0)},
        variant_note=VARIANT_NOTE,
        model={"n_params": cfg.n_params(),
               "n_active_params": cfg.n_active_params()},
        shape_cfg=dataclasses.asdict(shape),
    )
    path = _write(out_dir, rec, variant)
    print(f"[{arch} x {shape_name} x {mesh_kind}] flops/device "
          f"{cost.flops:.4e} ({split}) bytes {cost.bytes:.4e} memory "
          f"{rec['memory']['argument_bytes']}/{out_bytes}/"
          f"{tr.peak_bytes} fits {rec['fits']} collectives "
          f"{coll['counts']} trace {trace_s:.2f} s", flush=True)
    print(f"wrote {path}", flush=True)
    return rec


def _cell_args(arch, shape_name, mesh_kind, variant, out_dir, reduced):
    args = ["--arch", arch, "--shape", shape_name, "--mesh", mesh_kind,
            "--variant", variant, "--out-dir", str(out_dir)]
    return args + (["--smoke"] if reduced else [])


def run_cells(cells, out_dir: Optional[Path] = None, variant: str = "base",
              jobs: int = 1, reduced: bool = False,
              timeout: float = CELL_TIMEOUT_S) -> list:
    """Run each (arch, shape, mesh) cell in a process of its own,
    ``jobs`` at a time, each within ``timeout`` seconds.  A cell that
    fails or runs out of time gets a record with its status and the end
    of its log.  Returns [(cell, status)]."""
    from repro_torch.launch import fake_cuda

    variant_flags(variant)
    out_dir = RESULTS_DIR if out_dir is None else Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    todo, running, done = list(cells), [], []

    def finish(cell, log, t0, status):
        arch, shape_name, mesh_kind = cell
        if status != "ok":
            tail = log.read_text()[-2000:] if log.exists() else ""
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                   "variant": variant, "status": status,
                   "seconds": round(time.time() - t0, 1), "log_tail": tail}
            _write(out_dir, rec, variant)
        done.append((cell, status))
        print(f"  [{len(done)}/{len(cells)}] {'x'.join(cell)}: {status}",
              flush=True)

    while todo or running:
        while todo and len(running) < max(jobs, 1):
            cell = todo.pop(0)
            log = _record_path(out_dir, *cell, variant).with_suffix(".log")
            cmd = fake_cuda.python_cmd(
                "repro_torch.launch.dryrun",
                _cell_args(*cell, variant, out_dir, reduced))
            proc = subprocess.Popen(cmd, stdout=log.open("w"),
                                    stderr=subprocess.STDOUT, env=env)
            running.append((cell, proc, log, time.time()))
        time.sleep(0.2)
        for item in list(running):
            cell, proc, log, t0 = item
            if proc.poll() is not None:
                running.remove(item)
                finish(cell, log, t0, "ok" if proc.returncode == 0
                       else f"error({proc.returncode})")
            elif time.time() - t0 > timeout:
                proc.kill()
                proc.wait()
                running.remove(item)
                finish(cell, log, t0, f"timeout({timeout:.0f}s)")
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    help="single, multi, both, or DxM")
    ap.add_argument("--variant", default="base",
                    help="base, or kvint8 / ep joined by +")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once under --all")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config")
    ap.add_argument("--out-dir", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    variant_flags(args.variant)
    out_dir = Path(args.out_dir)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        from repro_torch.launch import fake_cuda

        if not fake_cuda.ready():
            # This process imported torch without the stand-ins.
            done = run_cells([(args.arch, args.shape, m) for m in meshes],
                             out_dir, args.variant, reduced=args.smoke,
                             timeout=float("inf"))
            return 0 if all(s == "ok" for _, s in done) else 1
        for m in meshes:
            rec = run_cell(args.arch, args.shape, m, out_dir, args.variant,
                           reduced=args.smoke)
            print(json.dumps(rec.get("memory", rec), indent=2))
        return 0

    from repro_torch.configs import ARCHS, SHAPES

    cells = [(a, s, m) for a in sorted(ARCHS) for s in SHAPES for m in meshes]
    if args.skip_existing:
        cells = [c for c in cells if not _record_path(
            out_dir, *c, args.variant).exists()]
    print(f"{len(cells)} cells to run", flush=True)
    done = run_cells(cells, out_dir, args.variant, args.jobs, args.smoke)
    failures = [c for c, s in done if s != "ok"]
    print(f"\ndone: {len(done) - len(failures)} ok, {len(failures)} "
          f"failed")
    for c, s in done:
        if s != "ok":
            print(f"  FAILED: {'x'.join(c)}: {s}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
