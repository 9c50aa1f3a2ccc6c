"""The port's fault model and recovery ladder against the JAX reference,
on the CPU.

* **The ECC model.**  ``page_fail_probability`` is the reference's
  float32 computation: the host's float64 scalar arithmetic, then
  float32 square root, division, ``erfc`` and power, each rounded as XLA
  rounds it (``erfc`` and its ``exp`` restated from XLA's CPU expansion,
  the square root correctly rounded).  Over a grid of RBER values that
  holds the golden condition's final-step margin and its shaved,
  reduced-tR value, the gap to ``jax`` is 0 float32 ulps (measured, and
  held at 0); ``sample_codeword_errors`` and ``page_read_fails`` draw on
  the port's ``prng.normal`` and follow the normals' own tolerance
  (``tests/test_torch_prng.py``: rtol and atol 1e-6, ROADMAP C5).
* **Fault parity.**  Both packages read the synthetic tables of
  ``tests/test_torch_flashsim.py`` (their worn bins included).  The
  fault model's probabilities (``p_unc``, ``p_mis``) are the reference's
  to 0 ulps, ``plan_faults``' ``FaultPlan`` columns and outcome counters
  are the reference's, and every compared ``SimStats`` field, fault
  counters included, is the reference's: in place, prepass and online,
  with the golden matrix's ``fc`` configuration and with the reference's
  ``TestOnlineRecovery`` configuration, where rebuilds retire blocks.
* **Semantics.**  The reference's ``tests/test_faults.py`` restated on
  the port: validation, the defaults-off guarantee, mispredictions,
  escalation and rebuilds, fail-slow dies, determinism across ``shard=``
  and ``workers=``, online recovery, the reference engine's refusal and
  FTL retirement.  Its self-healing pool and journal classes are left
  out here: ``tests/test_torch_runtime.py`` holds the port's killed
  worker, stalled pool and journal (with faults among its sweeps).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.flashsim as TF
from repro_torch.core import characterize as TC
from repro_torch.core import ecc as TE
from repro_torch.core import prng
from repro_torch.core.retry import RetryPolicy as TRetryPolicy
from test_torch_flashsim import AGED, MODEST, _ref_cond, _same  # noqa: F401
from test_torch_flashsim import one_thread, tables  # noqa: F401
from test_torch_ftl import _cfgs, _hot, own_cache, own_tables  # noqa: F401

COND = TF.OperatingCondition(*AGED)
N = 300

FAULT_FIELDS = (
    "mispredicted_reads", "rescued_reads", "parity_rebuilds",
    "rebuild_reads", "retired_blocks", "program_fails", "erase_fails",
    "unrecoverable",
)
#: The golden matrix's ``fc`` configuration, and the reference's
#: ``TestOnlineRecovery`` one (rebuilds and retirements happen there).
FC = dict(uncorrectable_prob=0.02, mispredict_scale=4.0,
          escalation_attempts=2)
RECOVERY = dict(uncorrectable_prob=0.6, escalation_attempts=1)


def _fault_cfgs(**kw):
    from repro.flashsim.config import FaultConfig

    return TF.FaultConfig(**kw), FaultConfig(**kw)


def fault_counters(stats):
    return {f: getattr(stats, f) for f in FAULT_FIELDS}


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# -- the ECC model ---------------------------------------------------------


def _rber_grid(margins, scales):
    cap = TE.DEFAULT_ECC.rber_cap
    full = [(1.0 - m) * cap for m in margins]
    return full + [cap - s * (cap - r) for r in full for s in scales]


def test_page_fail_probability_matches_jax(own_tables):
    """Python-float RBERs, as the fault model passes them: the golden
    condition's final-step margin (the port's own characterization of
    365 d / 1000 P/E) at full strength and shaved by its safe scale,
    between a dense sweep of margins and the scales of the AR² search."""
    from repro.core import ecc as RE

    st = TC.characterize_condition(*AGED, device="cpu")
    margins = list(np.linspace(-0.3, 0.99, 400)) + [st.mean_margin_final]
    grid = _rber_grid(margins, (0.7, 0.75, 0.8, 0.85, 0.9, 0.95,
                                st.safe_tr_scale))
    want = [float(RE.page_fail_probability(r)) for r in grid]
    got = [float(TE.page_fail_probability(r)) for r in grid]
    gap = _ulps(got, want)
    print(f"page_fail_probability: {len(grid)} RBERs, max gap "
          f"{gap.max()} float32 ulps, {int((np.asarray(want) > 0).sum())} "
          f"nonzero")
    assert gap.max() == 0
    assert sum(0.0 < w < 1.0 for w in want) > len(grid) // 4


def test_page_fail_probability_on_tensors_matches_jax():
    import jax.numpy as jnp

    from repro.core import ecc as RE

    x = np.linspace(1e-4, 2e-2, 4097).astype(np.float32)
    want = np.asarray(RE.page_fail_probability(jnp.asarray(x)))
    got = TE.page_fail_probability(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert _ulps(got, want).max() == 0


def test_erfc32_matches_jax_bitwise():
    """XLA's float32 ``erfc`` over [-9, 9], the branch points included;
    ``torch.special.erfc`` differs from it by an ulp on some inputs."""
    import jax

    x = np.concatenate([np.linspace(-9, 9, 200001),
                        np.array([-2.0, -1.0, 0.0, 1.0, 2.0])]
                       ).astype(np.float32)
    want = np.asarray(jax.scipy.special.erfc(x))
    got = TE.erfc32(torch.from_numpy(x)).numpy()
    assert _ulps(got, want).max() == 0
    assert _ulps(torch.special.erfc(torch.from_numpy(x)).numpy(),
                 want).max() > 0


@pytest.fixture
def threefry_original():
    import jax

    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


@pytest.mark.parametrize("seed", [0, 7])
def test_sampled_codeword_errors_match_jax(threefry_original, seed):
    """Counts equal wherever the Gaussian value lies farther than the
    normals' tolerance (rtol and atol 1e-6 of the noise, scaled by the
    codeword's standard deviation) from a rounding boundary."""
    import jax
    import jax.numpy as jnp

    from repro.core import ecc as RE

    cap = TE.DEFAULT_ECC.rber_cap
    rber = np.linspace(0.2 * cap, 1.3 * cap, 64).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    tkey = prng.fold_in(prng.PRNGKey(seed, device="cpu"), 5)
    want = np.asarray(RE.sample_codeword_errors(key, jnp.asarray(rber)))
    got = TE.sample_codeword_errors(tkey, torch.from_numpy(rber)).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (64, 16)
    noise = np.asarray(jax.random.normal(key, (64, 16)), np.float64)
    mean = rber[:, None].astype(np.float64) * TE.DEFAULT_ECC.n_bits
    std = np.sqrt(mean * (1.0 - rber[:, None]))
    value = mean + std * noise
    tol = std * (1e-6 + 1e-6 * np.abs(noise)) + 1e-4
    near = np.abs(value - np.floor(value) - 0.5) <= tol
    assert np.array_equal(got[~near], want[~near])
    assert near.mean() < 0.01
    fails_w = np.asarray(RE.page_read_fails(key, jnp.asarray(rber)))
    fails_g = TE.page_read_fails(tkey, torch.from_numpy(rber)).numpy()
    rows = ~near.any(axis=1)
    assert np.array_equal(fails_g[rows], fails_w[rows])
    assert fails_w.any() and not fails_w.all()


# -- the fault model against the reference ----------------------------------


def _models(fc_kw, mech="pr2ar2", cfgs=None):
    """A port and a reference ``FaultModel`` of one run on shared tables."""
    from repro.core.retry import RetryPolicy
    from repro.flashsim import ssd as RS
    from repro.flashsim.faults import FaultModel as RFaultModel

    cfg, rcfg = cfgs or (TF.DEFAULT_SSD, None)
    if rcfg is None:
        from repro.flashsim.config import DEFAULT_SSD as rcfg
    fc, rfc = _fault_cfgs(**fc_kw)
    sim = TF.SSDSim(cfg, COND, TRetryPolicy(mech), seed=9, device="cpu")
    rsim = RS.SSDSim(rcfg, _ref_cond(AGED), RetryPolicy(mech), seed=9)
    return (TF.FaultModel(fc, cfg, COND, sim.policy, 9, sim),
            RFaultModel(rfc, rcfg, _ref_cond(AGED), rsim.policy, 9, rsim))


@pytest.mark.parametrize("mech", ["baseline", "ar2", "sota+pr2ar2"])
def test_probabilities_match_reference(tables, mech):
    """Derived rates at the condition and at its worn bin: 0 ulps."""
    fm, rfm = _models({}, mech)
    for wear in (0.0, 1.0, 600.0):
        for f in ("p_unc", "p_mis"):
            g, w = getattr(fm, f)(wear), getattr(rfm, f)(wear)
            assert _ulps(g, w).max() == 0 and type(g) is type(w), (f, wear)
    if mech == "ar2":
        assert fm.p_mis(0.0) > 0.0
    fm2, rfm2 = _models(dict(uncorrectable_scale=3.0, mispredict_scale=2.5),
                        mech)
    assert (fm2.p_unc(1.0), fm2.p_mis(1.0)) == (rfm2.p_unc(1.0),
                                                rfm2.p_mis(1.0))


def _plan_inputs(pkg, prepass):
    """One admission stream, its attempts and sense times, in ``pkg``."""
    if pkg == "port":
        import repro_torch.flashsim as P
    else:
        import repro.flashsim as P
    cfg = _cfgs()[0 if pkg == "port" else 1]
    trace = P.ssd.resolve_trace(_hot()[0 if pkg == "port" else 1], seed=4)
    if prepass:
        s = P.ftl.build_ftl_schedule(trace, cfg)
        adm = s.admission_lists
        ptype, wear, lpn = s.ptype, s.wear_pec.tolist(), s.lpn.tolist()
    else:
        ex = P.ssd.expand_trace(trace, cfg)
        adm = ex.admission_lists + ([False] * ex.n_ops,
                                    [cfg.timing.tprog_us] * ex.n_ops)
        ptype, wear, lpn = ex.ptype, None, ex.page_id.tolist()
    rng = np.random.default_rng(11)
    n = len(adm[0])
    a = rng.integers(1, 9, n).tolist()
    tr = (rng.random(n) * 60 + 20).tolist()
    return cfg, adm, a, tr, ptype.tolist(), wear, lpn


@pytest.mark.parametrize("fc_kw", [FC, RECOVERY,
                                   dict(program_fail_prob=0.3,
                                        erase_fail_prob=0.4,
                                        failslow_dies=((2, 3.0),))],
                         ids=["fc", "recovery", "program-erase-failslow"])
@pytest.mark.parametrize("prepass", [False, True],
                         ids=["in-place", "prepass"])
def test_fault_plan_matches_reference(tables, prepass, fc_kw):
    from repro.flashsim.faults import plan_faults as rplan

    cfg, adm, a, tr, ptype, wear, lpn = _plan_inputs("port", prepass)
    rcfg, radm, ra, rtr, rptype, rwear, rlpn = _plan_inputs("ref", prepass)
    assert (adm, a, tr, ptype, wear, lpn) == (radm, ra, rtr, rptype, rwear,
                                              rlpn)
    fm, rfm = _models(fc_kw, cfgs=(cfg, rcfg))
    got = TF.plan_faults(fm, *adm, a, tr, ptype, wear, lpn=lpn)
    want = rplan(rfm, *radm, ra, rtr, rptype, rwear, lpn=rlpn)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(fm.outcome) == dataclasses.asdict(rfm.outcome)
    assert len(got.arrival) >= len(adm[0])
    if fc_kw is RECOVERY:
        assert fm.outcome.parity_rebuilds > 0
        assert fm.outcome.retired_blocks > 0
        assert len(got.arrival) > len(adm[0])


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("scheduler", ["fcfs", "host_prio_aged:4",
                                       "tokens:4,2", "preempt"])
@pytest.mark.parametrize("gc", ["off", "prepass", "online"])
@pytest.mark.parametrize("fc_kw", [FC, RECOVERY], ids=["fc", "recovery"])
def test_faults_simulate_matches_reference(tables, fc_kw, gc, scheduler,
                                           shard):
    """The hot-span ``prn`` cell: every field, fault counters included."""
    from repro.flashsim import ssd as RS

    cfg, rcfg = _cfgs()
    hot, rhot = _hot()
    fc, rfc = _fault_cfgs(**fc_kw)
    kw = dict(seed=1, gc=gc, scheduler=scheduler, shard=shard)
    ref = RS.simulate(rhot, _ref_cond(AGED), "pr2ar2", cfg=rcfg,
                      faults=rfc, **kw)
    got = TF.simulate(hot, COND, "pr2ar2", cfg=cfg, faults=fc,
                      device="cpu", **kw)
    _same(got, ref)
    assert got.mispredicted_reads + got.rescued_reads > 0
    assert got.recovery_p99_us > 0.0
    if fc_kw is RECOVERY:
        # One die a channel: a rebuild has no stripe peers to read.  The
        # online FTL refuses every retirement of this small pool (it
        # would wedge the die); the ``rsrch`` cell below retires online.
        assert got.parity_rebuilds > 0 and got.rebuild_reads == 0
        assert (got.retired_blocks > 0) == (gc != "online")
    if gc != "off":
        assert got.gc_invocations > 0


@pytest.mark.parametrize("gc", ["off", "prepass", "online"])
def test_recovery_cell_matches_reference(tables, gc):
    """The reference's ``TestOnlineRecovery`` cell (``rsrch``, 2 000
    requests) in every GC mode, and ``compare_mechanisms`` over it."""
    from repro.flashsim import ssd as RS

    fc, rfc = _fault_cfgs(**RECOVERY)
    kw = dict(mechanisms=("baseline", "pr2ar2"), seed=3, n_requests=2000,
              gc=gc)
    ref = RS.compare_mechanisms("rsrch", _ref_cond(AGED), faults=rfc, **kw)
    got = TF.compare_mechanisms("rsrch", COND, faults=fc, device="cpu",
                                **kw)
    for m in ref:
        _same(got[m], ref[m])
        assert got[m].parity_rebuilds > 0 and got[m].retired_blocks > 0


def test_faults_simulate_batch_matches_reference(tables):
    from repro.flashsim import ssd as RS

    fc, rfc = _fault_cfgs()
    kw = dict(mechanisms=("baseline", "ar2", "sota+pr2ar2"), seeds=(0, 1),
              n_requests=N, engine="auto")
    ref = RS.simulate_batch("websearch", [_ref_cond(AGED),
                                          _ref_cond(MODEST)],
                            faults=rfc, **kw)
    got = TF.simulate_batch("websearch", [COND,
                                          TF.OperatingCondition(*MODEST)],
                            faults=fc, device="cpu", **kw)
    assert len(got) == len(ref) == 12
    for gv, rv in zip(got.values(), ref.values()):
        _same(gv, rv)
        assert gv.engine_selected == "array"
        assert gv.engine_fallback_reason == rv.engine_fallback_reason
    assert any(s.mispredicted_reads for s in got.values())


def test_batched_engine_refuses_faults(tables):
    """The reference's words, from every run API; ``auto`` records them."""
    from repro.flashsim import ssd as RS
    from repro.flashsim.engine_batched import BatchedUnsupported as RBU

    fc, rfc = _fault_cfgs()
    kw = dict(n_requests=50, engine="batched")
    with pytest.raises(RBU) as want:
        RS.simulate("websearch", _ref_cond(AGED), "pr2ar2", faults=rfc, **kw)
    for call in (
        lambda: TF.simulate("websearch", COND, "pr2ar2", faults=fc,
                            device="cpu", **kw),
        lambda: TF.compare_mechanisms("websearch", COND, faults=fc,
                                      device="cpu", **kw),
        lambda: TF.simulate_batch("websearch", [COND], faults=fc,
                                  device="cpu", **kw),
    ):
        with pytest.raises(TF.BatchedUnsupported) as got:
            call()
        assert str(got.value) == str(want.value)
        assert "fault injection" in str(got.value)
    cfg = dataclasses.replace(TF.DEFAULT_SSD, faults=fc)
    assert TF.resolve_engine(cfg, device="cpu") == ("array", str(want.value))


# -- the reference's semantics tests (tests/test_faults.py) ------------------


def _sim(wl, mech="pr2ar2", **kw):
    kw.setdefault("seed", 7)
    kw.setdefault("n_requests", N)
    return TF.simulate(wl, COND, mech, device="cpu", **kw)


class TestFaultConfigValidation:
    def test_probabilities_bounded(self):
        with pytest.raises(ValueError, match="uncorrectable_prob"):
            TF.FaultConfig(uncorrectable_prob=1.5)
        with pytest.raises(ValueError, match="mispredict_prob"):
            TF.FaultConfig(mispredict_prob=-0.1)
        with pytest.raises(ValueError, match="program_fail_prob"):
            TF.FaultConfig(program_fail_prob=2.0)
        with pytest.raises(ValueError, match="erase_fail_prob"):
            TF.FaultConfig(erase_fail_prob=-1.0)

    def test_scales_and_escalation(self):
        with pytest.raises(ValueError, match="uncorrectable_scale"):
            TF.FaultConfig(uncorrectable_scale=-1.0)
        with pytest.raises(ValueError, match="escalation_attempts"):
            TF.FaultConfig(escalation_attempts=0)

    def test_failslow_is_slow(self):
        with pytest.raises(ValueError, match="fail-SLOW"):
            TF.FaultConfig(failslow_dies=((0, 0.5),))
        with pytest.raises(ValueError, match="die id"):
            TF.FaultConfig(failslow_dies=((-1, 2.0),))
        TF.FaultConfig(failslow_dies=((3, 2.5),))

    def test_defaults_valid(self):
        fc = TF.FaultConfig()
        assert fc.parity_rebuild and fc.retire_blocks
        assert fc.escalation_attempts >= 1


ZERO = TF.FaultConfig(uncorrectable_prob=0.0, mispredict_prob=0.0)


class TestDefaultsOff:
    """An all-zero FaultConfig is bit-identical to ``faults=None``: fault
    draws never perturb attempt sampling."""

    @pytest.mark.parametrize("shard", [False, True])
    def test_zero_fault_config_bit_identical(self, tables, shard):
        assert _sim("websearch", shard=shard) == \
            _sim("websearch", shard=shard, faults=ZERO)

    def test_zero_fault_counters_stay_zero(self, tables):
        s = _sim("websearch", faults=ZERO)
        assert all(v == 0 for v in fault_counters(s).values())
        assert s.recovery_p99_us == 0.0

    def test_gc_paths_unaffected_by_none(self, tables):
        for gc in ("prepass", "online"):
            a = _sim("rsrch", seed=3, gc=gc)
            b = _sim("rsrch", seed=3, gc=gc, faults=ZERO)
            assert a == b


class TestMisprediction:
    def test_derived_rate_positive_when_adaptive_and_aged(self, tables):
        s = _sim("websearch", "ar2", faults=TF.FaultConfig())
        assert s.mispredicted_reads > 0
        assert s.unrecoverable == 0

    @pytest.mark.parametrize("mech", ["baseline", "sota", "pr2"])
    def test_non_adaptive_policies_never_mispredict(self, tables, mech):
        s = _sim("websearch", mech,
                 faults=TF.FaultConfig(mispredict_prob=1.0))
        assert s.mispredicted_reads == 0

    def test_every_misprediction_pays_a_nominal_reread(self, tables):
        clean = _sim("websearch", "ar2")
        faulty = _sim("websearch", "ar2",
                      faults=TF.FaultConfig(mispredict_prob=1.0))
        assert faulty.mispredicted_reads > 0
        assert faulty.n_requests == clean.n_requests
        assert faulty.read_mean_us > clean.read_mean_us
        assert faulty.recovery_p99_us > 0.0

    def test_misprediction_rate_scales(self, tables):
        lo = _sim("websearch", "ar2",
                  faults=TF.FaultConfig(mispredict_scale=0.2))
        hi = _sim("websearch", "ar2",
                  faults=TF.FaultConfig(mispredict_scale=5.0))
        assert hi.mispredicted_reads > lo.mispredicted_reads


class TestUncorrectableAndRecovery:
    def test_escalation_rescues_at_default_capability(self, tables):
        s = _sim("websearch", faults=TF.FaultConfig(uncorrectable_prob=0.05))
        assert s.rescued_reads > 0
        assert s.unrecoverable == 0

    def test_derived_uncorrectable_rate_is_benign(self, tables):
        s = _sim("websearch", faults=TF.FaultConfig())
        assert s.unrecoverable == 0

    def test_recovery_latency_charged(self, tables):
        clean = _sim("websearch")
        faulty = _sim("websearch",
                      faults=TF.FaultConfig(uncorrectable_prob=0.2))
        assert faulty.read_mean_us > clean.read_mean_us
        assert faulty.recovery_p99_us > 0.0

    def test_no_parity_rebuild_counts_unrecoverable(self, tables):
        fc = TF.FaultConfig(uncorrectable_prob=0.9, escalation_attempts=1,
                            parity_rebuild=False)
        s = _sim("websearch", faults=fc)
        assert s.unrecoverable > 0
        assert s.parity_rebuilds == 0

    def test_parity_rebuild_issues_stripe_peer_reads(self, tables):
        fc = TF.FaultConfig(uncorrectable_prob=0.7, escalation_attempts=1,
                            retire_blocks=False)
        s = _sim("websearch", faults=fc)
        assert s.parity_rebuilds > 0
        peers = TF.DEFAULT_SSD.dies_per_channel - 1
        assert s.rebuild_reads == s.parity_rebuilds * peers


class TestFailSlowDies:
    def test_failslow_die_stretches_latency(self, tables):
        clean = _sim("websearch", faults=TF.FaultConfig())
        slow = _sim("websearch", faults=TF.FaultConfig(
            failslow_dies=((0, 4.0), (1, 4.0))))
        assert slow.read_mean_us > clean.read_mean_us


class TestDeterminism:
    @pytest.mark.parametrize("gc", [None, "prepass", "online"])
    def test_shard_equality_with_faults(self, tables, gc):
        fc = TF.FaultConfig(uncorrectable_prob=0.05, mispredict_scale=2.0)
        kw = dict(gc=gc, faults=fc)
        assert _sim("rsrch", shard=False, **kw) == \
            _sim("rsrch", shard=True, **kw)

    def test_repeat_run_identical(self, tables):
        fc = TF.FaultConfig(uncorrectable_prob=0.05)
        assert _sim("websearch", faults=fc) == _sim("websearch", faults=fc)

    def test_compare_mechanisms_with_faults(self, tables):
        fc = TF.FaultConfig(uncorrectable_prob=0.05)
        r = TF.compare_mechanisms("websearch", COND, seed=7, n_requests=N,
                                  faults=fc, device="cpu")
        assert r["ar2"].mispredicted_reads > 0
        assert r["baseline"].mispredicted_reads == 0
        for mech, stats in r.items():
            assert stats == _sim("websearch", mech, faults=fc)

    def test_workers_equality_with_faults(self, tables):
        kw = dict(conditions=[TF.OperatingCondition(*MODEST), COND],
                  mechanisms=["baseline", "pr2ar2"], seeds=[1, 2],
                  n_requests=N, faults=TF.FaultConfig(), device="cpu")
        r1 = TF.simulate_batch("websearch", workers=1, **kw)
        r2 = TF.simulate_batch("websearch", workers=2, **kw)
        assert TF.sweep_to_json(r1) == TF.sweep_to_json(r2)


class TestOnlineRecovery:
    FC = TF.FaultConfig(**RECOVERY)

    def _run(self, **kw):
        base = dict(seed=3, n_requests=2000, gc="online", faults=self.FC)
        base.update(kw)
        return _sim("rsrch", **base)

    def test_rebuild_and_retirement_exercised(self, tables):
        s = self._run()
        assert s.parity_rebuilds > 0
        assert s.rebuild_reads > 0
        assert s.retired_blocks > 0

    def test_online_shard_equality(self, tables):
        assert self._run(shard=False) == self._run(shard=True)

    def test_erase_failures_retire_blocks(self, tables):
        s = self._run(faults=TF.FaultConfig(erase_fail_prob=0.5))
        assert s.erase_fails > 0
        assert s.retired_blocks >= s.erase_fails
        assert s.n_requests == 2000

    def test_program_failures_counted_and_charged(self, tables):
        clean = _sim("rsrch", seed=3, n_requests=600, gc="online")
        s = _sim("rsrch", seed=3, n_requests=600, gc="online",
                 faults=TF.FaultConfig(program_fail_prob=0.3))
        assert s.program_fails > 0
        assert s.mean_us > clean.mean_us


class TestReferenceEngine:
    def test_reference_engine_rejects_faults(self, tables):
        with pytest.raises(NotImplementedError, match="fault"):
            _sim("websearch", n_requests=50, engine="reference",
                 faults=TF.FaultConfig())


def small_ftl(**gc_kw) -> TF.PageMapFTL:
    kw = dict(enabled=True, pages_per_block=4, blocks_per_die=8,
              gc_threshold_blocks=1)
    kw.update(gc_kw)
    cfg = TF.SSDConfig(n_channels=1, dies_per_channel=1,
                       gc=TF.GCConfig(**kw))
    return TF.PageMapFTL(cfg)


class TestRetireBlock:
    def test_retire_relocates_valid_pages(self):
        ftl = small_ftl()
        for lpn in range(5):
            ftl.host_write(lpn)
        ftl.drain_events()
        assert 0 in ftl.sealed[0]
        assert ftl.retire_block(0, 0)
        assert 0 in ftl.retired and ftl.blocks_retired == 1
        assert ftl.valid[0] == 0 and ftl.wp[0] == ftl.ppb
        assert 0 not in ftl.free[0]
        for lpn in range(4):
            ppn = ftl.l2p[lpn]
            assert ppn // ftl.ppb != 0
            assert ftl.p2l[ppn] == lpn
        assert len(ftl.drain_events()) == 8

    def test_retire_refuses_frontier_and_foreign_blocks(self):
        ftl = small_ftl()
        for lpn in range(5):
            ftl.host_write(lpn)
        assert not ftl.retire_block(0, ftl.active[0])
        assert not ftl.retire_block(0, 99)
        assert ftl.retire_block(0, 0)
        assert not ftl.retire_block(0, 0)

    def test_retire_refuses_when_it_would_wedge(self):
        ftl = small_ftl(blocks_per_die=4, gc_threshold_blocks=1)
        for lpn in range(12):
            ftl.host_write(lpn)
        ftl.drain_events()
        assert len(ftl.free[0]) == 1
        assert not ftl.retire_block(0, 0)
        assert 0 not in ftl.retired

    def test_retire_erase_failed_never_returns_to_pool(self):
        ftl = small_ftl()
        blk = ftl.free[0][-1]
        ftl.retire_erase_failed(0, blk)
        assert blk in ftl.retired
        assert ftl.wp[blk] == ftl.ppb
