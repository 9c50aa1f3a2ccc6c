"""The port's distribution layer (``repro_torch.distributed``,
``repro_torch.launch.mesh``) against the reference's, in process.

  * ``param_specs`` per leaf of every published config's parameter tree
    equal to the reference's on meshes (16, 16), (2, 16, 16), (2, 2),
    (4, 1) and (1, 4): the reference's tree from ``jax.eval_shape`` and
    an ``AbstractMesh``, the port's as meta tensors;
  * ``cache_specs`` equal to the reference's ``cache_shardings`` on a
    prefill cache of each family, ``batch_specs`` on its batch, and
    ``constrain``'s guards (a dim the axes do not divide, a mesh axis an
    earlier dim took) equal to the reference's specs, on DTensors over a
    (2, 2) mesh of a fake process group;
  * ``quantize_int8``, ``dequantize_int8`` and ``compress_grads`` bit
    for bit (values at x.5 of a step included), the reference's
    compression properties, and 25 steps with compression lowering the
    loss;
  * ``plan_mesh`` equal for every world size 1-600 from (16, 16),
    (16, 8) and (8, 4), and the reference's elastic cases;
  * seeded clock traces through both packages' ``HeartbeatMonitor``,
    ``StragglerMitigator`` and ``RestartPolicy``, equal decisions, and
    the reference's fault-tolerance cases;
  * the meshes' builders: the host mesh's shape, the production mesh's
    error naming the ranks it needs;
  * the launcher's restart policy on a failed step (retry, then abort;
    shrink raises the elastic plan, and the command line exits with 3);
  * ``torchrun --standalone --nproc-per-node 2 -m
    repro_torch.launch.train --smoke --device cpu`` trains over gloo,
    saves from rank 0, and a second run resumes.
"""

import dataclasses
import os
import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced_config as ref_reduced_config
from repro.distributed import compress as RC
from repro.distributed import elastic as RE
from repro.distributed import fault_tolerance as RF
from repro.distributed import sharding as RS
from repro.distributed import steps as RST
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import CorpusConfig, SyntheticCorpus
from repro_torch.distributed import compress as TC
from repro_torch.distributed import elastic as TE
from repro_torch.distributed import fault_tolerance as TF
from repro_torch.distributed import sharding as TS
from repro_torch.distributed import steps as TST
from repro_torch.launch import mesh as TM
from repro_torch.models import build_model
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     init_opt_state, tree_map)

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")),
          ((4, 1), ("data", "model")),
          ((1, 4), ("data", "model"))]


def _norm(spec):
    """A reference ``PartitionSpec`` as the port's spec tuple."""
    return tuple(None if m is None else (m,) if isinstance(m, str)
                 else tuple(m) for m in spec)


def _ref_flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", "")))
                       for p in path)
        out[key] = leaf
    return out


def _port_flat(tree):
    out = {}
    TS.map_with_path(lambda p, x: out.__setitem__("/".join(p), x), tree)
    return out


@pytest.fixture(scope="module")
def trees():
    """Every published arch's parameter tree: (reference's abstract,
    port's meta)."""
    out = {}
    for arch in sorted(REF_ARCHS):
        ref = jax.eval_shape(ref_build_model(ref_get_config(arch)).init,
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
        out[arch] = ref, TST.param_shapes(get_config(arch))
    return out


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["16x16", "2x16x16", "2x2", "4x1", "1x4"])
def test_param_specs_match_reference(trees, shape, axes):
    mesh = AbstractMesh(shape, axes)
    for arch, (ref, port) in trees.items():
        want = {k: _norm(v) for k, v in
                _ref_flat(RS.param_specs(ref, mesh)).items()}
        got = _port_flat(TS.param_specs(port, mesh))
        assert got == want, arch
        shapes = {k: tuple(v.shape) for k, v in _ref_flat(ref).items()}
        assert {k: tuple(v.shape) for k, v in _port_flat(port).items()} \
            == shapes, arch


def test_placements_follow_specs():
    mesh = AbstractMesh((2, 4, 2), ("pod", "data", "model"))

    class M:   # the placements need only the axis names
        mesh_dim_names = mesh.axis_names
    pl = TS.spec_to_placements((("pod", "data"), None, ("model",)), M)
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert TS.spec_to_placements((None, None), M) == (Replicate(),) * 3


@pytest.fixture
def fake_mesh():
    """A (2, 2) ("data", "model") mesh over a fake 4-rank process group
    (placements are computed; no collective moves data)."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield TM.make_host_mesh(2, device="cpu")
    finally:
        dist.destroy_process_group()


def _ref_constrain_spec(shape, axes, mesh, monkeypatch):
    monkeypatch.setattr(RS.jax.lax, "with_sharding_constraint",
                        lambda x, s: s)
    with RS.use_mesh(mesh):
        return _norm(RS.constrain(jax.ShapeDtypeStruct(shape, jnp.float32),
                                  axes).spec)


@pytest.mark.parametrize("shape,axes", [
    ((4, 6, 8), ("batch", None, "heads")),       # all divide
    ((4, 6, 8), ("batch", "heads", "ff")),       # "model" taken by dim 1
    ((3, 5), ("batch", "heads")),                # neither divides
    ((4, 3, 2, 16), ("batch", "kv_heads", None, None)),
    ((2, 8, 4, 2, 16), ("batch", "act_seq", "kv_heads", None, None)),
    ((6, 10), ("experts", "fsdp")),
])
def test_constrain_guards_match_reference(fake_mesh, monkeypatch, shape,
                                          axes):
    want = _ref_constrain_spec(shape, axes,
                               AbstractMesh((2, 2), ("data", "model")),
                               monkeypatch)
    x = DTensor.from_local(torch.zeros(shape), fake_mesh,
                           [Replicate(), Replicate()], run_check=False)
    with TS.use_mesh(fake_mesh):
        got = TS.constrain(x, axes)
    assert got.placements == TS.spec_to_placements(want, fake_mesh)
    # plain tensors, and any tensor outside a mesh, pass through
    plain = torch.zeros(shape)
    with TS.use_mesh(fake_mesh):
        assert TS.constrain(plain, axes) is plain
    assert TS.constrain(x, axes) is x


def test_mesh_builders(fake_mesh):
    assert TS.mesh_shape(fake_mesh) == {"data": 2, "model": 2}
    assert TS.mesh_shape(TM.make_host_mesh(device="cpu")) == {"data": 4,
                                                              "model": 1}
    with pytest.raises(ValueError, match="model-parallel groups of 3"):
        TM.make_host_mesh(3, device="cpu")
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        TM.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        TM.make_production_mesh(multi_pod=True, device="cpu")


def test_gather_tree_divides_tp_leaves_once(fake_mesh):
    """Under the (2, 2) mesh a leaf of ``TP_LEAVES`` arrives as this
    rank's "model" shard where "model" divides its dim, whole where it
    does not (``wq``'s 3 heads), any other leaf whole; ``tensor_parallel
    .local`` reads the same rule; and gathering the gathered tree again
    changes nothing (the dense MoE gathers its unit's weights twice)."""
    from repro_torch.distributed import tensor_parallel as TP

    def weight(*shape):
        return DTensor.from_local(torch.zeros(shape), fake_mesh,
                                  [Replicate(), Replicate()],
                                  run_check=False)

    tree = {"wi": weight(6, 8), "wd": weight(8, 6), "wq": weight(6, 3, 4),
            "router": weight(6, 8)}
    with TS.use_mesh(fake_mesh):
        once = TS.gather_tree(tree)
        twice = TS.gather_tree(once)
        shares = TP.local(8), TP.local(3)
    assert {k: tuple(v.shape) for k, v in once.items()} == {
        "wi": (6, 4), "wd": (4, 6), "wq": (6, 3, 4), "router": (6, 8)}
    assert shares == (4, 3)
    assert all(twice[k] is once[k] for k in once)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma2-2b", "mamba2-130m",
                                  "recurrentgemma-2b", "whisper-large-v3",
                                  "internvl2-1b", "olmoe-1b-7b"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)],
                         ids=["2x2", "4x1", "1x4"])
def test_cache_and_batch_specs_match_reference(arch, shape):
    mesh = AbstractMesh(shape, ("data", "model"))
    kw = dict(n_layers=8) if arch == "recurrentgemma-2b" else {}
    rcfg = dataclasses.replace(ref_reduced_config(ref_get_config(arch)), **kw)
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **kw)
    B = 4
    batch = {"tokens": np.zeros((B, 8), np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = np.zeros((B, cfg.n_patches, cfg.d_model),
                                    np.float32)
    if cfg.family == "encdec":
        batch["audio_embed"] = np.zeros((B, cfg.enc_positions, cfg.d_model),
                                        np.float32)
    model = ref_build_model(rcfg)
    params = jax.eval_shape(model.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    _, cache = jax.eval_shape(model.prefill, params, batch)
    want_cache = {k: _norm(v.spec) for k, v in _ref_flat(
        RST.cache_shardings(rcfg, mesh, cache)).items()}
    tparams = build_model(cfg, device="cpu").init()
    with torch.no_grad():
        _, tcache = build_model(cfg, device="cpu").prefill(
            tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert _port_flat(TST.cache_specs(cfg, mesh, tcache)) == want_cache
    decode = {"token": np.zeros((B, 1), np.int32), "pos": 8, **batch}
    want = {k: _norm(v.spec) for k, v in RST.batch_shardings(
        rcfg, mesh, {k: v for k, v in decode.items() if k != "pos"}).items()}
    got = TST.batch_specs(cfg, mesh, decode)
    assert got.pop("pos") == ()
    assert got == want


# -- compression ---------------------------------------------------------------


def _half_steps(rng, n=4096):
    """Values many of which sit at x.5 of a quantization step: amax 127
    makes the scale exactly 1."""
    x = rng.integers(-250, 251, n).astype(np.float32) / 2
    x[0] = 127.0
    return x


@pytest.mark.parametrize("kind", ["gaussian", "half_steps", "zeros", "tiny"])
def test_quantize_bitwise(kind):
    rng = np.random.default_rng(7)
    x = {"gaussian": rng.normal(scale=3.0, size=5000).astype(np.float32),
         "half_steps": _half_steps(rng),
         "zeros": np.zeros(64, np.float32),
         "tiny": (rng.normal(size=300) * 1e-30).astype(np.float32)}[kind]
    rq, rs = RC.quantize_int8(jnp.asarray(x))
    q, s = TC.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    np.testing.assert_array_equal(
        TC.dequantize_int8(q, s).numpy(),
        np.asarray(RC.dequantize_int8(rq, rs)))
    if kind == "half_steps":   # round half to even
        assert (q.numpy() % 2 == 0)[np.abs(x) % 1 == 0.5].all()


def test_compress_grads_bitwise_with_error_feedback():
    rng = np.random.default_rng(3)
    shapes = {"a": (17, 9), "b": [(64,), (3, 4, 5)], "c": {"d": (200,)}}

    def draw(scale):
        def one(s):
            return (rng.normal(size=s) * scale).astype(np.float32)
        return {"a": one(shapes["a"]), "b": [one(s) for s in shapes["b"]],
                "c": {"d": _half_steps(rng, 200)}}

    ref_ef, ef = None, None
    for step in range(5):
        g = draw(10.0 ** -step)
        rout, ref_ef = RC.compress_grads(jax.tree.map(jnp.asarray, g), ref_ef)
        tg = tree_map(torch.from_numpy, g)
        out, ef = TC.compress_grads(tg, ef)
        for w, o in zip(jax.tree.leaves(rout), _leaves(out)):
            np.testing.assert_array_equal(o.numpy(), np.asarray(w))
        for w, o in zip(jax.tree.leaves(ref_ef), _leaves(ef)):
            np.testing.assert_array_equal(o.numpy(), np.asarray(w))
    assert TC.compressed_wire_bytes(tg) == RC.compressed_wire_bytes(g)
    assert TC.uncompressed_wire_bytes(tg) == RC.uncompressed_wire_bytes(g)


def _leaves(tree):
    from repro_torch.optim.adamw import tree_leaves
    return tree_leaves(tree)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**32 - 1), st.floats(0.3, 3.0))
def test_int8_quantization_error_bound(seed, scale_mag):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(scale=scale_mag, size=(256,))
                         .astype(np.float32))
    q, s = TC.quantize_int8(x)
    err = (TC.dequantize_int8(q, s) - x).abs().numpy()
    assert err.max() <= float(s) * 0.5 + 1e-6


def test_error_feedback_unbiased_accumulation():
    g = {"w": torch.from_numpy(np.random.default_rng(1).normal(size=(500,))
                               .astype(np.float32) * 1e-3)}
    ef = TC.init_error_feedback(g)
    acc_t, acc_c = np.zeros(500), np.zeros(500)
    for step in range(40):
        gs = {"w": g["w"] * (1.0 + 0.2 * np.sin(step))}
        comp, ef = TC.compress_grads(gs, ef)
        acc_t += gs["w"].numpy()
        acc_c += comp["w"].numpy()
    assert np.abs(acc_c - acc_t).max() / np.abs(acc_t).max() < 0.01


def test_gradient_compression_trains():
    """Loss still decreases when the int8 + error-feedback wire format
    replaces the exact gradients (25 steps, reduced llama3.2-3b)."""
    torch.manual_seed(0)
    cfg = reduced_config(get_config("llama3.2-3b"))
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(1))
    params = tree_map(lambda p: p.requires_grad_(True), model.init())
    opt_cfg = AdamWConfig(lr=1e-3)
    opt = init_opt_state(params, opt_cfg)
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seq_len=32,
                                          batch=2, seed=0))
    ef, losses = None, []
    for i in range(25):
        batch = {k: torch.from_numpy(v) for k, v in corpus.batch(i).items()}
        loss = model.train_loss(params, batch)
        loss.backward()
        grads, ef = TC.compress_grads(tree_map(lambda p: p.grad, params), ef)
        adamw_update(grads, opt, params, opt_cfg)
        tree_map(lambda p: setattr(p, "grad", None), params)
        losses.append(float(loss.detach()))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


# -- elasticity ------------------------------------------------------------------


@pytest.mark.parametrize("old", [(16, 16), (16, 8), (8, 4)],
                         ids=["16x16", "16x8", "8x4"])
def test_plan_mesh_matches_reference(old):
    for n in range(1, 601):
        assert dataclasses.asdict(TE.plan_mesh(n, old)) == \
            dataclasses.asdict(RE.plan_mesh(n, old)), n
    for batch in (1, 7, 256):
        assert TE.plan_mesh(48, old, global_batch=batch).describe() == \
            RE.plan_mesh(48, old, global_batch=batch).describe()


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 512), st.integers(1, 64))
def test_elastic_plan_always_valid(n_devices, old_model):
    p = TE.plan_mesh(n_devices, (16, old_model), global_batch=256)
    assert p.new_shape[0] * p.new_shape[1] == n_devices
    assert p.grad_accum_factor >= 1


def test_elastic_reference_cases():
    p = TE.plan_mesh(512, (16, 16), global_batch=256)
    assert p.new_shape == (32, 16) and p.tp_preserved
    assert p.grad_accum_factor == 1
    p = TE.plan_mesh(448, (16, 16), global_batch=256)
    assert p.new_shape == (28, 16) and p.tp_preserved
    assert p.grad_accum_factor >= 2
    p = TE.plan_mesh(18, (16, 16), global_batch=256)
    assert p.new_shape[0] * p.new_shape[1] == 18 and not p.tp_preserved


# -- fault tolerance ---------------------------------------------------------------


def _trace(seed):
    """A seeded sequence of control-plane events on 8 workers."""
    rng = random.Random(seed)
    events = []
    for _ in range(120):
        r = rng.random()
        if r < 0.6:
            w = rng.randrange(8)
            events.append(("beat", w, rng.randrange(100),
                           rng.choice([0.5, 1.0, 1.0, 1.2, 3.0, 9.0])))
        elif r < 0.75:
            events.append(("advance", rng.choice([0.5, 2.0, 11.0, 70.0])))
        elif r < 0.85:
            events.append(("plan", rng.randrange(100)))
        else:
            events.append(("failure", rng.random() < 0.5))
    return events


def _replay(pkg, events):
    t = [0.0]
    mon = pkg.HeartbeatMonitor(8, dead_after_s=10.0, straggler_factor=2.0,
                               clock=lambda: t[0])
    mit = pkg.StragglerMitigator(mon)
    pol = pkg.RestartPolicy(max_failures_per_hour=6)
    out = []
    for ev in events:
        if ev[0] == "beat":
            mon.beat(*ev[1:])
        elif ev[0] == "advance":
            t[0] += ev[1]
        elif ev[0] == "plan":
            out.append(("plan", mit.plan(ev[1], {s: s % 8
                                                 for s in range(16)})))
        else:
            d = pol.on_failure(mon, transient=ev[1], now=t[0])
            out.append(("failure", d.action, d.dead_workers, d.reason))
        out.append((tuple(mon.dead_workers()), tuple(mon.stragglers())))
    out.append((mit.n_duplicates, dict(mit.duplicated)))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_fault_tolerance_decisions_match_reference(seed):
    events = _trace(seed)
    assert _replay(TF, events) == _replay(RF, events)


def test_straggler_detection_and_redispatch():
    t = [0.0]
    mon = TF.HeartbeatMonitor(8, dead_after_s=10.0, clock=lambda: t[0])
    for w in range(8):
        mon.beat(w, 1, 5.0 if w == 3 else 1.0)
    assert mon.stragglers() == [3]
    plan = TF.StragglerMitigator(mon).plan(1, {s: s % 8 for s in range(16)})
    assert set(plan) == {3, 11}
    assert all(b != 3 for b in plan.values())


def test_dead_worker_and_restart_decision():
    t = [100.0]
    mon = TF.HeartbeatMonitor(4, dead_after_s=10.0, clock=lambda: t[0])
    for step, now in ((5, 100.0), (6, 115.0)):
        t[0] = now
        for w in (0, 1, 3):
            mon.beat(w, step, 1.0)
    assert mon.dead_workers() == [2]
    d = TF.RestartPolicy().on_failure(mon, transient=False, now=200.0)
    assert d.action == "shrink" and d.dead_workers == (2,)


def test_failure_budget_aborts():
    mon = TF.HeartbeatMonitor(2)
    pol = TF.RestartPolicy(max_failures_per_hour=3)
    actions = [pol.on_failure(mon, True, now=float(i)).action
               for i in range(5)]
    assert actions[-1] == "abort"


# -- the launcher over torchrun -------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]


def test_torchrun_trains_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           "--smoke", "--device", "cpu", "--save-every", "2",
           "--ckpt-dir", str(tmp_path / "ck"), "--batch", "4", "--seq", "16"]
    first = subprocess.run(cmd + ["--steps", "2"], env=env, timeout=300,
                           capture_output=True, text=True)
    assert first.returncode == 0, first.stderr[-4000:]
    assert "mesh {'data': 2, 'model': 1}" in first.stdout
    assert "checkpoint @ 2" in first.stdout
    second = subprocess.run(cmd + ["--steps", "4"], env=env, timeout=300,
                            capture_output=True, text=True)
    assert second.returncode == 0, second.stderr[-4000:]
    assert "resumed from step 2" in second.stdout
    assert "step    4 loss" in second.stdout
    assert "training run complete" in second.stdout


# -- the launcher's restart policy on a failed step ------------------------------


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo process group and its (1, 1) mesh, with cheap
    flash-tier tables at the loop's condition."""
    from repro_torch.core import characterize as CH

    stats = CH.ConditionStats(365.0, 1000.0, 2.0, 5.0, 0.7, 0.4, 0.1, 0.8)
    hist = np.array([0.0, 0.5, 0.3, 0.2])
    CH.clear_tables()
    CH.load_tables({(365.0, 1000.0): stats},
                   {(365.0, 1000.0, pt, False, s): hist
                    for pt in ("lsb", "csb", "msb") for s in (1.0, 0.8)})
    TM.init_process_group("cpu", store_path=str(tmp_path / "store"))
    try:
        yield TM.make_host_mesh(device="cpu")
    finally:
        if dist.is_initialized():     # the command line destroys its own
            dist.destroy_process_group()
        CH.clear_tables()


def _failing_step(monkeypatch):
    from repro_torch.launch import train as TL

    real = TST.make_train_step

    def make(cfg, mesh, opt=None, batch_shard=None):
        _, place = real(cfg, mesh, opt)

        def step(state, batch, lr_scale=1.0):
            raise RuntimeError("collective timed out")
        return step, place

    monkeypatch.setattr(TL.ST, "make_train_step", make)
    return TL


def test_failed_steps_retry_then_abort(one_rank, monkeypatch):
    """Transient failures with every worker alive are retried (the batch
    skipped) until the hour's budget of 8 is spent; the ninth aborts."""
    TL = _failing_step(monkeypatch)
    seen = []
    cfg = reduced_config(get_config("llama3.2-3b"))
    with pytest.raises(RuntimeError, match="collective timed out"):
        TL.train(cfg, steps=12, batch=2, seq=8, mesh=one_rank,
                 log=seen.append)
    decisions = [m.rsplit(" ", 1)[1] for m in seen if "decision" in m]
    assert decisions == ["retry"] * 8 + ["abort"]


def test_shrink_decision_raises_the_elastic_plan(one_rank, monkeypatch):
    """A "shrink" decision ends the run with ``ShrinkRequired`` carrying
    ``plan_mesh``'s plan for the ranks left."""
    TL = _failing_step(monkeypatch)

    class Shrink:
        def on_failure(self, monitor, transient, now=None):
            return TF.RestartDecision("shrink", dead_workers=())

    monkeypatch.setattr(TL, "RestartPolicy", Shrink)
    cfg = reduced_config(get_config("llama3.2-3b"))
    with pytest.raises(TL.ShrinkRequired) as e:
        TL.train(cfg, steps=2, batch=4, seq=8, mesh=one_rank,
                 log=lambda *_: None)
    assert dataclasses.asdict(e.value.plan) == dataclasses.asdict(
        RE.plan_mesh(1, (1, 1), global_batch=4))


def test_command_line_exits_3_with_the_plan(one_rank, monkeypatch, capsys):
    from repro_torch.launch import train as TL

    plan = TE.plan_mesh(448, (16, 16))

    def shrink(*a, **kw):
        raise TL.ShrinkRequired(plan)

    monkeypatch.setattr(TL, "train", shrink)
    with pytest.raises(SystemExit) as e:
        TL.main(["--smoke", "--device", "cpu"])
    assert e.value.code == 3
    assert f"elastic plan: {plan.describe()}" in capsys.readouterr().out
