"""The reference's sharded steps on a host mesh of 4 CPU devices, for
``tests/test_torch_sharded_step.py`` (run as a script, which sets
``XLA_FLAGS`` before JAX starts):

    python tests/sharded_reference.py WORK_DIR PART N_PARTS

``WORK_DIR/cases.json`` lists ``[arch, [data, model], ep, steps]`` train
cases (a fifth entry names a variant of :data:`VARIANTS`), ``[data,
model]`` MoE cases and ``[arch, [data, model]]`` serve cases (a third
entry names a variant); this process
runs every ``N_PARTS``-th of them from ``PART`` on.  Part 0 first writes
``WORK_DIR/params.pkl``: the initial parameters of every arch (seed 0)
and the MoE case's layer and input, as nested numpy trees.  Each part
writes ``WORK_DIR/ref_<PART>.npz``: each train case's per-step loss and
grad_norm on the batches of :func:`batches` and the bytes of one
device's share of the state, each MoE case's expert-parallel ``y``
and aux, and each serve case's logits, greedy tokens and one device's
bytes of its last cache on ``cache_shardings`` (:func:`serve_case`).
"""

import dataclasses
import json
import os
import pickle
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import reduced_config  # noqa: E402
from repro.distributed import sharding as SH  # noqa: E402
from repro.distributed import steps as ST  # noqa: E402
from repro.models import moe as MOE  # noqa: E402
from repro.models.api import build_model  # noqa: E402
from repro.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402

B, T = 4, 16
#: Greedy decode steps after a serve case's prefill.
SERVE_STEPS = 3
#: A case's variant: its switches (``flash``: the reference's flash mode,
#: its sequence-parallel stream; on the CPU its attention is the
#: blockwise and windowed scans).
VARIANTS = {"": {}, "kvint8": {"REPRO_KV_INT8": "1"}, "slots": {},
            "flash": {"REPRO_ATTN_IMPL": "flash"}}
#: A variant's prompt length (else T): at 64 the cache's slots are its
#: largest dim, so "model" divides them, and a window of 32 cuts the
#: local layers' keys.
PROMPT = {"slots": 64, "flash": 64}
#: Depths other than the reduced config's (recurrentgemma with a tail).
OVERRIDES = {"recurrentgemma-2b": dict(n_layers=8)}


def config(arch):
    return dataclasses.replace(reduced_config(get_config(arch)),
                               activation_dtype="float32",
                               **OVERRIDES.get(arch, {}))


def mesh(shape):
    return jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])


def batches(cfg, steps, seed=0, T=T):
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


def init_params(arch):
    return jax.tree.map(np.asarray,
                        build_model(config(arch)).init(jax.random.PRNGKey(0)))


def moe_inputs():
    cfg = config("olmoe-1b-7b")
    p = jax.tree.map(np.asarray,
                     MOE.moe_init(jax.random.PRNGKey(1), cfg, cfg.moe))
    x = np.random.default_rng(2).standard_normal(
        (B, 8, cfg.d_model)).astype(np.float32)
    return p, x


def train_case(arch, shape, ep, steps, params, out, variant=""):
    os.environ["REPRO_MOE_EP"] = str(ep)
    os.environ.update(VARIANTS[variant])
    cfg = config(arch)
    m = mesh(shape)
    step, shard = ST.make_train_step(cfg, m)
    state = {"params": jax.tree.map(np.array, params),
             "opt": init_opt_state(params,
                                   AdamWConfig(moment_dtype=cfg.moment_dtype))}
    state = jax.tree.map(jax.device_put, state, shard)
    nbytes = sum(
        int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
        for x, s in zip(jax.tree.leaves(state), jax.tree.leaves(shard)))
    metrics = []
    for b in batches(cfg, steps):
        state, mt = step(state, b)
        metrics.append((float(mt["loss"]), float(mt["grad_norm"])))
    tag = f"{arch}/{shape[0]}x{shape[1]}/ep{ep}" + (f"/{variant}" if variant
                                                     else "")
    out[f"train/{tag}"] = np.array(metrics, np.float64)
    out[f"bytes/{tag}"] = np.array(nbytes)
    for k in VARIANTS[variant]:
        os.environ.pop(k)


def moe_case(shape, p, x, out):
    os.environ["REPRO_MOE_EP"] = "1"
    cfg = config("olmoe-1b-7b")
    with SH.use_mesh(mesh(shape)):
        y, aux = jax.jit(lambda p, x: MOE.moe_apply_ep(
            cfg, cfg.moe, p, x, with_aux=True))(p, x)
    tag = f"{shape[0]}x{shape[1]}"
    out[f"moe/y/{tag}"] = np.asarray(y)
    out[f"moe/aux/{tag}"] = np.asarray(aux)


def serve_batch(cfg, T_p=T):
    """The serve cases' prompt batch: the first train batch's tokens
    (and frontend input), of ``T_p`` positions."""
    return {k: v for k, v in batches(cfg, 1, T=T_p)[0].items()
            if k != "labels"}


def serve_case(arch, shape, params, out, variant="", steps=SERVE_STEPS):
    """``make_prefill_step`` on :func:`serve_batch`, then ``steps``
    greedy ``make_decode_step`` steps from the prefill's cache: each
    step's last-position logits (B, V), the greedy tokens (B,), and the
    bytes one device holds of the last cache on ``cache_shardings``."""
    for k in ("REPRO_KV_INT8",):
        os.environ.pop(k, None)
    os.environ.update(VARIANTS[variant])
    cfg = config(arch)
    m = mesh(shape)
    prefill, p_shard = ST.make_prefill_step(cfg, m)
    decode, _ = ST.make_decode_step(cfg, m)
    p = jax.device_put(jax.tree.map(np.array, params), p_shard)
    batch = serve_batch(cfg, PROMPT.get(variant, T))
    logits, cache = jax.jit(prefill)(p, batch)
    pos = batch["tokens"].shape[1] + (cfg.n_patches if cfg.family == "vlm"
                                      else 0)
    decode = jax.jit(decode)
    all_logits, tokens = [], []
    for i in range(steps + 1):
        last = np.asarray(logits)[:, -1]
        all_logits.append(last)
        tokens.append(last.argmax(-1).astype(np.int32))
        if i == steps:
            break
        logits, cache = decode(p, {"token": tokens[-1][:, None],
                                   "pos": pos + i, "cache": cache})
    nbytes = sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
                 for x, s in zip(jax.tree.leaves(cache), jax.tree.leaves(
                     ST.cache_shardings(cfg, m, cache))))
    tag = "/".join([arch, f"{shape[0]}x{shape[1]}"] + ([variant] if variant
                                                      else []))
    out[f"serve/logits/{tag}"] = np.stack(all_logits)
    out[f"serve/tokens/{tag}"] = np.stack(tokens)
    out[f"serve/cache_bytes/{tag}"] = np.array(nbytes)
    for k in VARIANTS[variant]:
        os.environ.pop(k)


def main(work_dir, part, n_parts):
    work, part, n_parts = Path(work_dir), int(part), int(n_parts)
    cases = json.loads((work / "cases.json").read_text())
    serve = cases.get("serve", [])
    mine = (cases["train"] + cases["moe"] + serve)[part::n_parts]
    archs = {c[0] for c in (cases["train"] + serve if part == 0 else mine)
             if isinstance(c[0], str)}
    params = {a: init_params(a) for a in sorted(archs)}
    moe_p, moe_x = moe_inputs()
    if part == 0:
        tmp = work / "params.pkl.tmp"
        tmp.write_bytes(pickle.dumps({"params": params, "moe_p": moe_p,
                                      "moe_x": moe_x}))
        tmp.rename(work / "params.pkl")
    out = {}
    for case in mine:
        if len(case) >= 4 and isinstance(case[2], int):
            train_case(*case[:4], params[case[0]], out, *case[4:])
        elif isinstance(case[0], str):
            serve_case(case[0], case[1], params[case[0]], out, *case[2:])
        else:
            moe_case(case, moe_p, moe_x, out)
    np.savez(work / f"ref_{part}.npz", **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
