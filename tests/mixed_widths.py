"""Mamba-2 at widths where "model" does not divide in_proj's columns or
the heads, the reference's compiled program against the port's trace,
on this host's CPU:

    python tests/mixed_widths.py [--d-model 48] [--kind prefill train]

The reduced mamba2-130m with ``d_model`` replaced (48: in_proj 230
columns and 6 heads, neither divided by "model" 4, while the 128 conv
channels and the 96 rows of d_inner are, as "model" 16 divides the full
width) at mesh (1, 4) and ``tests/test_torch_dryrun.py``'s ``SHAPES``.
The reference is lowered and compiled on 4 host devices (a subprocess
of this script, which sets ``XLA_FLAGS`` before JAX starts); the port is
traced by ``launch.dryrun.run_cell`` on a fake process group (a
subprocess through ``launch.fake_cuda.python_cmd``).  Prints one JSON
line a kind: each side's ``dot`` FLOPs a device, the reference's
in_proj product, conv and scan shapes as its HLO holds them, and each
side's collective traffic a device by kind.  The reference's traffic is
read from the HLO's collective shapes (all-gather (k-1)/k of the output,
all-reduce 2(k-1)/k, an all-to-all (k-1)/k, a collective-permute the
pairs' share of the devices; an op inside a while body counted once a
layer), so it estimates what the port's ``launch.cost`` counts.
"""

import argparse
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
ARCH, MESH = "mamba2-130m", (1, 4)
FACTOR = {"all-gather": lambda k: (k - 1) / k,
          "all-reduce": lambda k: 2 * (k - 1) / k,
          "all-to-all": lambda k: (k - 1) / k,
          "reduce-scatter": lambda k: k - 1}
ITEM = {"f32": 4, "s32": 4, "bf16": 2, "f16": 2}


def _shape(kind):
    from test_torch_dryrun import SHAPES
    return SHAPES[kind]


def hlo_traffic(text: str, n_layers: int, k: int) -> dict:
    """Bytes a device each collective kind of the HLO ``text`` moves."""
    out = {}
    for line in text.splitlines():
        m = re.search(r"= \(?([^=]*?)\)? (all-gather|all-reduce|all-to-all|"
                      r"collective-permute|reduce-scatter)(-start)?\(", line)
        if not m:
            continue
        kind = m.group(2)
        n = sum(ITEM[t] * math.prod(int(x) for x in d.split(",") if x)
                for t, d in re.findall(r"(f32|s32|bf16|f16)\[([0-9,]*)\]",
                                       m.group(1)))
        if kind == "collective-permute":
            pairs = re.search(r"source_target_pairs=\{(.*?)\}\}", line)
            f = (pairs.group(1).count("{") + 1) / k
        else:
            g = re.search(r"replica_groups=\[(\d+),(\d+)\]", line)
            f = FACTOR[kind](int(g.group(2)) if g else k)
        rep = n_layers if "while/body" in line else 1
        out[kind] = out.get(kind, 0.0) + n * f * rep
    return out


def reference(d_model: int, kind: str) -> dict:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import dataclasses

    import jax
    from jax.sharding import AxisType

    from repro.configs import get_config
    from repro.configs.base import ShapeConfig, reduced_config
    from repro.distributed.steps import build_cell
    from repro.launch import hlo_cost as HC

    cfg = dataclasses.replace(reduced_config(get_config(ARCH)),
                              d_model=d_model)
    mesh = jax.make_mesh(MESH, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    name, seq, batch = _shape(kind)
    jitted, specs, _ = build_cell(cfg, ShapeConfig(name, seq, batch, kind),
                                  mesh)
    text = jitted.lower(*specs).compile().as_text()
    _, flops = HC.breakdown(text, top=None)
    dots = sorted({m for m in re.findall(r"= (f32\[[0-9,]+\])\S* dot\(",
                                         text)})
    return {"dot": dict(flops).get("dot", 0.0), "dot_shapes": dots,
            "traffic": hlo_traffic(text, cfg.n_layers, MESH[1])}


def port(d_model: int, kind: str) -> dict:
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DR

    cfg = dataclasses.replace(reduced_config(get_config(ARCH)),
                              d_model=d_model)
    name, seq, batch = _shape(kind)
    with tempfile.TemporaryDirectory() as out:
        rec = DR.run_cell(ARCH, name, "x".join(map(str, MESH)), out,
                          cfg=cfg, shape=ShapeConfig(name, seq, batch, kind))
    return {"dot": rec["flops_breakdown"].get("dot", 0.0),
            "kernel": rec["flops_breakdown"].get("kernel", 0.0),
            "traffic": {k: v for k, v in rec["collectives"]["traffic"].items()
                        if v}}


def _run(cmd) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=900, check=True)
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=48)
    ap.add_argument("--kind", nargs="+", default=["prefill", "train"])
    ap.add_argument("--side", choices=("reference", "port"))
    args = ap.parse_args()
    if args.side:                       # a subprocess: one side, one kind
        fn = reference if args.side == "reference" else port
        print(json.dumps(fn(args.d_model, args.kind[0])))
        return
    from repro_torch.launch import fake_cuda

    for kind in args.kind:
        common = ["--d-model", str(args.d_model), "--kind", kind, "--side"]
        ref = _run([sys.executable, __file__, *common, "reference"])
        got = _run(fake_cuda.python_cmd("mixed_widths", [*common, "port"]))
        print(json.dumps({"arch": ARCH, "kind": kind, "mesh": MESH,
                          "d_model": args.d_model, "reference": ref,
                          "port": got}))


if __name__ == "__main__":
    main()
