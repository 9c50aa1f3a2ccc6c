"""The reference's dry-run cells at reduced configs on a host mesh of 4
CPU devices, for ``tests/test_torch_dryrun.py`` (run as a script, which
sets ``XLA_FLAGS`` before JAX starts):

    python tests/dryrun_reference.py WORK_DIR NAME

``WORK_DIR/NAME.json`` lists cells ``[arch, kind, [data, model],
variant, [shape name, seq_len, global batch]]``; the variant is
``base``, or ``opaque`` (``REPRO_ATTN_IMPL=flash
REPRO_OPAQUE_KERNELS=1 REPRO_PALLAS_SSD=opaque``, the kernels as the
reference's stand-ins).  Each is ``build_cell`` at its reduced config
and shape, lowered and compiled; ``WORK_DIR/NAME.out.json`` gets its
per-device argument and output bytes (``memory_analysis``), each
argument leaf's bytes on its sharding, the output leaves' count and
bytes on their shardings, and ``hlo_cost.breakdown``'s
``dot`` and ``custom-call(kernel)`` FLOPs.  NAME ``specs`` instead
writes ``input_specs`` of every published config x shape
(``jax.eval_shape``; nothing is compiled), also under
``REPRO_KV_INT8=1``: each leaf's path, shape and dtype, or the error.
"""

import json
import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import ARCHS, SHAPES as FULL_SHAPES, get_config  # noqa: E402
from repro.configs.base import ShapeConfig, reduced_config  # noqa: E402

OPAQUE_ENV = {"REPRO_ATTN_IMPL": "flash", "REPRO_OPAQUE_KERNELS": "1",
              "REPRO_PALLAS_SSD": "opaque"}


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def specs_out():
    from repro.models.api import input_specs

    out = {}
    for int8 in ("0", "1"):
        os.environ["REPRO_KV_INT8"] = int8
        for a in sorted(ARCHS):
            for s in FULL_SHAPES:
                key = f"{a}/{s}/kv_int8={int8}"
                try:
                    sp = input_specs(ARCHS[a], FULL_SHAPES[s])
                    out[key] = {
                        _path(p): [list(x.shape), str(x.dtype)]
                        for p, x in jax.tree_util.tree_flatten_with_path(
                            sp)[0]}
                except Exception as e:  # noqa: BLE001 (the error is data)
                    out[key] = f"{type(e).__name__}: {e}"[:300]
    return out


def cell(arch, kind, mesh_shape, variant, shape):
    from repro.distributed.steps import build_cell
    from repro.launch import hlo_cost as HC

    for k in OPAQUE_ENV:
        os.environ.pop(k, None)
    if variant == "opaque":
        os.environ.update(OPAQUE_ENV)
    cfg = reduced_config(get_config(arch))
    mesh = jax.make_mesh(tuple(mesh_shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:mesh_shape[0]
                                               * mesh_shape[1]])
    name, seq, batch = shape
    jitted, arg_specs, shards = build_cell(
        cfg, ShapeConfig(name, seq, batch, kind), mesh)
    compiled = jitted.lower(*arg_specs).compile()
    mem = compiled.memory_analysis()
    _, flops = HC.breakdown(compiled.as_text())
    flops = dict(flops)
    leaves = {}
    for i, (spec, shard) in enumerate(zip(arg_specs, shards)):
        flat = jax.tree_util.tree_flatten_with_path(spec)[0]
        for (p, x), s in zip(flat, jax.tree.leaves(shard)):
            n = x.dtype.itemsize
            for d in s.shard_shape(x.shape):
                n *= d
            leaves[f"{i}/{_path(p)}"] = n
    outs = jax.tree.leaves(jax.eval_shape(jitted, *arg_specs))
    out_data = 0
    for x, s in zip(outs, jax.tree.leaves(compiled.output_shardings)):
        n = x.dtype.itemsize
        for d in s.shard_shape(x.shape):
            n *= d
        out_data += n
    return {"argument_bytes": mem.argument_size_in_bytes,
            "output_bytes": mem.output_size_in_bytes,
            "output_leaves": len(outs), "output_data_bytes": out_data,
            "leaves": leaves,
            "dot": flops.get("dot", 0.0),
            "kernel": flops.get("custom-call(kernel)", 0.0)}


def main(work_dir, name):
    work = Path(work_dir)
    if name == "specs":
        out = specs_out()
    else:
        cells = json.loads((work / f"{name}.json").read_text())
        out = {"/".join(map(str, c[:2])) + f"/{c[2][0]}x{c[2][1]}/{c[3]}":
               cell(*c) for c in cells}
    tmp = work / f"{name}.out.json.tmp"
    tmp.write_text(json.dumps(out))
    tmp.rename(work / f"{name}.out.json")


if __name__ == "__main__":
    main(*sys.argv[1:])
