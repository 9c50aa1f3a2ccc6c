"""The port's dry-run cells at reduced configs, for
``tests/test_torch_dryrun.py``: one process a mesh, started through
``repro_torch.launch.fake_cuda.python_cmd`` (so fake CUDA tensors trace
on a torch without CUDA).  Imports no JAX.

    python -m dryrun_port WORK_DIR NAME

``WORK_DIR/NAME.json`` lists cells ``[arch, kind, [data, model],
variant, [shape name, seq_len, global batch]]`` of one mesh shape, as
``dryrun_reference.py`` takes them (a sixth entry replacing fields of
the reduced config; named by ``dryrun_reference.cell_key``); this
process opens a fake process
group of that world size, traces each cell with
``launch.dryrun.run_cell`` at its reduced config and shape and writes
``WORK_DIR/NAME.out.json``: each record, with each argument leaf's bytes
on its placements (from ``build_cell`` under the variant's switches).
"""

import json
import sys
from pathlib import Path

import torch.distributed as dist


def cell_key(arch, kind, mesh_shape, variant, shape, widths=None) -> str:
    """``dryrun_reference.cell_key`` (that module imports JAX)."""
    key = f"{arch}/{kind}/{mesh_shape[0]}x{mesh_shape[1]}/{variant}"
    if widths:
        key += "/" + ",".join(f"{k}={v}" for k, v in sorted(widths.items()))
    return key


def cell(arch, kind, mesh_shape, variant, shape, widths, out_dir):
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import steps as ST
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as M

    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              **(widths or {}))
    shape = ShapeConfig(shape[0], shape[1], shape[2], kind)
    mesh = M.make_mesh(tuple(mesh_shape), device="cuda")
    with DR.variant_switches(DR.variant_flags(variant)):   # kvint8's cache
        _, specs, places = ST.build_cell(cfg, shape, mesh)
    leaves = {}
    for i, (s, p) in enumerate(zip(specs, places)):
        for k, v in DR.leaf_bytes(s, p, mesh).items():
            leaves[f"{i}/{k}"] = v
    rec = DR.run_cell(arch, shape.name, "x".join(map(str, mesh_shape)),
                      out_dir, variant, cfg=cfg, shape=shape)
    rec["leaves"] = leaves
    return rec


def main(work_dir, name):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    work = Path(work_dir)
    cells = json.loads((work / f"{name}.json").read_text())
    d, m = cells[0][2]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=d * m)
    try:
        out = {cell_key(*c): cell(*c[:5], c[5] if len(c) > 5 else None,
                                  work / "records") for c in cells}
    finally:
        dist.destroy_process_group()
    tmp = work / f"{name}.out.json.tmp"
    tmp.write_text(json.dumps(out))
    tmp.rename(work / f"{name}.out.json")


if __name__ == "__main__":
    main(*sys.argv[1:])
