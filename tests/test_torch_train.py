"""The port's single-device training path against the reference's.

Reduced ``llama3.2-3b`` (and ``gemma2-2b`` for the windowed attention,
``recurrentgemma-2b`` at 8 layers for the RG-LRU scan and the pattern
tail, ``olmoe-1b-7b`` for the MoE dispatch and its load-balance aux
loss, ``mamba2-130m`` for the SSD blocks, trained through the plain
scan by autograd as the reference trains through ``ssd_chunked``) in
float32, with the reference's initial parameters carried
across by ``params_from_jax``:

  * ``train_loss`` and every gradient against ``jax.value_and_grad`` of
    the reference's: the loss within rtol 1e-5, each gradient leaf
    within rtol 1e-5 plus 1e-5 of the leaf's largest magnitude (the two
    frameworks sum matmuls in other orders);
  * three ``adamw_update`` steps on the same gradients against the
    reference's jitted update: parameters and moments bitwise (the fused
    roundings of XLA's update are restated), unclipped and clipped by a
    norm both packages sum exactly; the global norm of other gradients
    within 1 float32 ulp (XLA sums in a tree of windows, torch in its
    own order);
  * ten steps of the loop (corpus, flash tier, prefetch, loss, clip,
    AdamW, cosine schedule) against the reference's functions driven the
    same way: losses within 1e-4;
  * the command line runs its steps, saves, and resumes: the resumed
    losses equal the uninterrupted run's bit for bit on the CPU; it
    trains the RG-LRU, MoE, encoder-decoder, VLM and Mamba-2 families
    too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced_config as ref_reduced_config
from repro.data import CorpusConfig as RCorpusConfig
from repro.data import SyntheticCorpus as RCorpus
from repro.models import build_model as ref_build_model
from repro.optim import adamw as RA
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import characterize as TC
from repro_torch.launch import train as TL
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw as TA
from repro_torch.optim.adamw import tree_leaves, tree_map

B, T = 2, 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


#: Depths other than the reduced config's: recurrentgemma with a tail.
_OVERRIDES = {"recurrentgemma-2b": dict(n_layers=8)}


def _cfgs(arch):
    kw = dict(activation_dtype="float32", **_OVERRIDES.get(arch, {}))
    return (dataclasses.replace(ref_reduced_config(ref_get_config(arch)), **kw),
            dataclasses.replace(reduced_config(get_config(arch)), **kw))


def _ref_params(rcfg, seed=0):
    return jax.tree.map(np.asarray,
                        ref_build_model(rcfg).init(jax.random.PRNGKey(seed)))


def _batch(vocab, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _ref_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.fixture
def synthetic_tables():
    """Cheap flash-tier tables at the loop's condition (365 d, 1000 P/E)."""
    stats = TC.ConditionStats(365.0, 1000.0, 2.0, 5.0, 0.7, 0.4, 0.1, 0.8)
    hist = np.array([0.0, 0.5, 0.3, 0.2])
    TC.clear_tables()
    TC.load_tables({(365.0, 1000.0): stats},
                   {(365.0, 1000.0, pt, False, s): hist
                    for pt in ("lsb", "csb", "msb") for s in (1.0, 0.8)})
    yield
    TC.clear_tables()


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma2-2b",
                                  "recurrentgemma-2b", "olmoe-1b-7b",
                                  "mamba2-130m"])
def test_train_loss_and_gradients_match_reference(arch):
    rcfg, cfg = _cfgs(arch)
    params = _ref_params(rcfg)
    batch = _batch(cfg.vocab)
    loss, grads = jax.value_and_grad(ref_build_model(rcfg).train_loss)(
        params, batch)
    tp = tree_map(lambda p: p.requires_grad_(True),
                  params_from_jax(params, device="cpu"))
    tloss = build_model(cfg, device="cpu").train_loss(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    want, got = _ref_leaves(grads), [p.grad.numpy() for p in tree_leaves(tp)]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def _ulps(a, b):
    a = a.view(np.int32).astype(np.int64)
    b = b.view(np.int32).astype(np.int64)
    return np.abs(a - b).max()


@pytest.mark.parametrize("case", ["unclipped", "clipped"])
def test_three_adamw_steps_match_reference(case):
    """Three updates bitwise.  Unclipped: Gaussian gradients.  Clipped
    (norm > clip_norm at every step): gradients on a grid of 2^-8 whose
    squares sum exactly in any order, so both packages clip by the same
    norm (on other gradients the norm's summation order differs; see
    the next test)."""
    rcfg, _ = _cfgs("llama3.2-3b")
    params = _ref_params(rcfg)
    rng = np.random.default_rng(3)
    clip = None if case == "unclipped" else 1.0
    if clip is None:
        draw = lambda p: (rng.standard_normal(p.shape) * 0.05)  # noqa: E731
    else:
        draw = lambda p: rng.integers(-8, 9, p.shape) / 256.0   # noqa: E731
    grads = [jax.tree.map(lambda p: draw(p).astype(np.float32), params)
             for _ in range(3)]
    ocfg = RA.AdamWConfig(clip_norm=clip)
    tcfg = TA.AdamWConfig(clip_norm=clip)
    rstate = (params, RA.init_opt_state(params, ocfg))
    upd = jax.jit(lambda g, o, p: RA.adamw_update(g, o, p, ocfg))
    tparams = params_from_jax(params, device="cpu")
    topt = TA.init_opt_state(tparams, tcfg)
    for g in grads:
        rp, ro, rm = upd(g, rstate[1], rstate[0])
        rstate = (rp, ro)
        _, topt, tm = TA.adamw_update(params_from_jax(g, device="cpu"), topt,
                                      tparams, tcfg)
        gap = _ulps(np.float32(rm["grad_norm"]), tm["grad_norm"].numpy())
        assert gap == 0 if clip else gap <= 1
        assert clip is None or float(rm["grad_norm"]) > clip
    assert int(topt["step"]) == int(rstate[1]["step"]) == 3
    for name, want, got in (("params", rstate[0], tparams),
                            ("m", rstate[1]["m"], topt["m"]),
                            ("v", rstate[1]["v"], topt["v"])):
        for w, g in zip(_ref_leaves(want), tree_leaves(got)):
            assert _ulps(w, g.numpy()) == 0, name


def test_global_norm_within_one_ulp():
    """The global norm of Gaussian gradients: XLA sums in a tree of
    windows, torch in its own order; within 1 float32 ulp."""
    rcfg, _ = _cfgs("llama3.2-3b")
    params = _ref_params(rcfg)
    rng = np.random.default_rng(5)
    for _ in range(5):
        g = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.05)
                         .astype(np.float32), params)
        want = np.float32(jax.jit(RA.global_norm)(g))
        got = TA.global_norm(params_from_jax(g, device="cpu")).numpy()
        assert _ulps(want, got) <= 1


def test_cosine_schedule_matches_reference():
    for s in (0, 1, 2, 5, 9, 10, 11):
        want = float(RA.cosine_schedule(jnp.int32(s), 10, warmup=2))
        got = float(TA.cosine_schedule(s, 10, warmup=2))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1.0)


def test_ten_step_loop_matches_reference(synthetic_tables):
    rcfg, cfg = _cfgs("llama3.2-3b")
    params = _ref_params(rcfg)
    steps = 10
    corpus = RCorpus(RCorpusConfig(vocab=cfg.vocab, seq_len=T, batch=B))
    model = ref_build_model(rcfg)
    ocfg = RA.AdamWConfig()

    @jax.jit
    def step(p, o, batch, lr_scale):
        loss, g = jax.value_and_grad(model.train_loss)(p, batch)
        p, o, _ = RA.adamw_update(g, o, p, ocfg, lr_scale)
        return p, o, loss

    p, o, want = params, RA.init_opt_state(params, ocfg), []
    for i in range(steps):
        lr = RA.cosine_schedule(jnp.int32(i + 1), steps, TL.WARMUP)
        p, o, loss = step(p, o, corpus.batch(i), lr)
        want.append(float(loss))
    run = TL.train(cfg, steps=steps, batch=B, seq=T, device="cpu",
                   params=params_from_jax(params, "cpu"),
                   log=lambda *_: None)
    got = [run.losses[i + 1] for i in range(steps)]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert got[-1] < got[0]


def test_resume_reproduces_the_uninterrupted_run(tmp_path, synthetic_tables):
    _, cfg = _cfgs("llama3.2-3b")
    kw = dict(steps=6, batch=B, seq=T, device="cpu", log=lambda *_: None)
    whole = TL.train(cfg, **kw)
    first = TL.train(cfg, ckpt_dir=tmp_path, save_every=3, stop_after=4, **kw)
    assert sorted(first.losses) == [1, 2, 3, 4]
    resumed = TL.train(cfg, ckpt_dir=tmp_path, save_every=3, **kw)
    assert resumed.start_step == 3
    assert resumed.restore_stats.n_reconstructed == 0
    for i in range(1, 7):
        got = first.losses[i] if i <= 3 else resumed.losses[i]
        assert got == whole.losses[i], i


def test_command_line_smoke_saves_and_resumes(tmp_path, capsys,
                                              synthetic_tables):
    args = ["--smoke", "--device", "cpu", "--save-every", "3",
            "--ckpt-dir", str(tmp_path)]
    TL.main(args + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "checkpoint @ 3" in out and "training run complete" in out
    TL.main(args + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "step    6" in out


def test_command_line_smoke_trains_and_resumes_mamba2(tmp_path, capsys,
                                                      synthetic_tables):
    """``launch.train --arch mamba2-130m --smoke --device cpu`` trains
    (losses finite), saves and resumes."""
    args = ["--smoke", "--device", "cpu", "--arch", "mamba2-130m",
            "--save-every", "2", "--ckpt-dir", str(tmp_path)]
    TL.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "checkpoint @ 2" in out and "training run complete" in out
    assert "nan" not in out.lower()
    TL.main(args + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step    4" in out


def test_moe_tail_aux_is_dropped_as_in_the_reference():
    """olmoe cut to a pattern of two layers over three: one unit and an
    MoE tail layer.  The reference adds 0.01 x the units' aux losses and
    drops the tail's; the port mirrors it (loss within rtol 1e-5 of the
    reference's), and the tail's aux it drops is not 0."""
    from repro.configs.base import ATTN
    from repro_torch.models import blocks as TB

    kw = dict(block_pattern=(ATTN, ATTN), n_layers=3)
    rcfg, cfg = (dataclasses.replace(c, **kw) for c in _cfgs("olmoe-1b-7b"))
    params = _ref_params(rcfg)
    batch = _batch(cfg.vocab)
    want = ref_build_model(rcfg).train_loss(params, batch)
    tp = params_from_jax(params, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = build_model(cfg, device="cpu").train_loss(tp, tb)
        x = torch.randn(B, T, cfg.d_model, generator=torch.Generator()
                        .manual_seed(0))
        _, tail_aux = TB.block_train(cfg, ATTN, tp["tail"][0], x,
                                     torch.arange(T, dtype=torch.int32))
    assert len(tp["tail"]) == 1 and "moe" in tp["tail"][0]
    assert float(tail_aux) > 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "olmoe-1b-7b",
                                  "whisper-large-v3", "internvl2-1b",
                                  "mamba2-130m"])
def test_command_line_smoke_trains_the_new_families(arch, tmp_path, capsys,
                                                    synthetic_tables):
    TL.main(["--smoke", "--device", "cpu", "--arch", arch, "--steps", "2",
             "--save-every", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"arch {arch}-smoke" in out and "step    2" in out
    assert "checkpoint @ 2" in out and "training run complete" in out


def test_restore_reconstructs_a_corrupt_shard(tmp_path):
    from repro_torch.checkpoint import corrupt_shard, restore, save

    _, cfg = _cfgs("llama3.2-3b")
    state = TL.make_state(cfg, "cpu")
    d = save(tmp_path / "ck", state, shard_bytes=1 << 16)
    corrupt_shard(d, 1)
    out, st = restore(d, state)
    assert st.n_reconstructed == 1
    for a, b in zip(tree_leaves(out), tree_leaves(state)):
        assert torch.equal(a, b)


def test_mamba2_trains_through_the_plain_scan():
    """The SSD blocks train through the plain scan by autograd (the
    reference's training mode): every SSM parameter of the reduced
    mamba2-130m gets a nonzero gradient, ``ssd_scan(..., training=True)``
    computes what the kernel's entry computes on the CPU, and no kernel
    launches."""
    from repro_torch.kernels.ssd_scan import ops as SO

    _, cfg = _cfgs("mamba2-130m")
    model = build_model(cfg, device="cpu")
    params = tree_map(lambda p: p.requires_grad_(True), model.init())
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab).items()}
    before = SO.launches
    model.train_loss(params, batch).backward()
    assert SO.launches == before
    for name, g in params["units"]["b0"]["ssm"].items():
        assert g.grad is not None and bool(g.grad.abs().sum() > 0), name
    rng = np.random.default_rng(2)
    x, Bm, Cm = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((2, 37, 3, 16), (2, 37, 16), (2, 37, 16)))
    dt = torch.from_numpy(rng.random((2, 37, 3)).astype(np.float32) * 0.1)
    A = -torch.arange(1, 4, dtype=torch.float32)
    want = SO.ssd_scan(x, Bm, Cm, dt, A, chunk=8, device="cpu")
    x.requires_grad_(True)
    got = SO.ssd_scan(x, Bm, Cm, dt, A, chunk=8, device="cpu",
                      training=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].grad_fn is not None


@pytest.mark.parametrize("flag", [["--dry-run"], ["--shape", "train_4k"]])
def test_distributed_flags_raise(flag):
    """``--dry-run`` waits for ROADMAP D15b; ``--shape`` builds the
    16 x 16 production mesh, which one CPU rank cannot hold."""
    if flag == ["--dry-run"]:
        with pytest.raises(NotImplementedError, match="D15b"):
            TL.main(["--smoke", "--device", "cpu"] + flag)
    else:
        with pytest.raises(RuntimeError, match="needs 256 ranks"):
            TL.main(["--smoke", "--device", "cpu"] + flag)
