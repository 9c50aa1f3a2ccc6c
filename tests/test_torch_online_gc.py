"""The port's online GC against the JAX reference, on the CPU.

Online GC advances the FTL inside the event core: pages map when the die
takes the program, a die whose projected free pool falls to the
watermark collects victims at that simulated instant, and an erased
block returns to the pool only when its erase completes; a write that
finds no free page stalls until then.  Attempt draws come from per-die
substreams, so ``shard=True`` equals the monolithic run.

Both packages read the synthetic tables of ``tests/test_torch_flashsim.py``
(with the worn P/E bins GC erases reach), and every compared
``SimStats`` field must be equal: on the hot-span ``prn`` cell of
``tests/test_torch_ftl.py`` (512 pages, 8 dies, 8 pages a block, where
GC collects and writes stall) under fcfs, host_prio, host_prio_aged:4,
tokens:4,2 and preempt, sharded and not, through ``simulate``,
``compare_mechanisms`` and ``simulate_batch``; and the FTL the controller
leaves behind (mapping, free pools, retired blocks) is the reference's.
The reference's own online-GC tests (``tests/test_ftl.py``,
``TestOnlineGC``) run here against the port.
"""

import dataclasses

import pytest

import repro_torch.flashsim as TF
from repro_torch.core.retry import RetryPolicy as TRetryPolicy
from test_torch_flashsim import AGED, MODEST, _ref_cond, _same  # noqa: F401
from test_torch_flashsim import one_thread, tables  # noqa: F401
from test_torch_ftl import _cfgs, _hot, _state

SCHEDULERS = ["fcfs", "host_prio", "host_prio_aged:4", "tokens:4,2",
              "preempt"]
COND = TF.OperatingCondition(*AGED)


def _online(cfg):
    return dataclasses.replace(cfg, gc=dataclasses.replace(
        cfg.gc, mode="online"))


def _online_cfgs(**gc_kw):
    """The hot-span churn configuration under online GC, in both
    packages: (port, reference)."""
    cfg, rcfg = _cfgs(**gc_kw)
    return _online(cfg), _online(rcfg)


# -- SimStats against the reference -----------------------------------------


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_online_simulate_matches_reference(tables, scheduler, shard):
    from repro.flashsim import ssd as RS

    cfg, rcfg = _online_cfgs()
    hot, rhot = _hot()
    # validate: the work-conservation checks accept writes parked off
    # the die queues (preempt included).
    kw = dict(seed=1, scheduler=scheduler, shard=shard, validate=True)
    ref = RS.simulate(rhot, _ref_cond(AGED), "pr2ar2", cfg=rcfg, **kw)
    got = TF.simulate(hot, COND, "pr2ar2", cfg=cfg, device="cpu", **kw)
    _same(got, ref)
    assert got.gc_invocations > 0 and got.write_stalls > 0
    assert got.engine_selected == "array" and got.fast_path_events == 0


@pytest.mark.parametrize("mech", ["baseline", "sota", "pr2", "ar2",
                                  "sota+pr2ar2"])
def test_online_mechanisms_match_reference(tables, mech):
    """Every mechanism, validated, on the default watermark."""
    from repro.flashsim import ssd as RS

    cfg, rcfg = _online_cfgs()
    hot, rhot = _hot()
    kw = dict(seed=2, validate=True)
    ref = RS.simulate(rhot, _ref_cond(AGED), mech, cfg=rcfg, **kw)
    got = TF.simulate(hot, COND, mech, cfg=cfg, device="cpu", **kw)
    _same(got, ref)
    assert got.gc_invocations > 0


def test_online_compare_matches_reference(tables):
    from repro.flashsim import ssd as RS

    cfg, rcfg = _online_cfgs()
    hot, rhot = _hot()
    kw = dict(mechanisms=("baseline", "pr2", "sota+pr2ar2"), seed=0,
              engine="auto")
    ref = RS.compare_mechanisms(rhot, _ref_cond(AGED), cfg=rcfg, **kw)
    got = TF.compare_mechanisms(hot, COND, cfg=cfg, device="cpu", **kw)
    assert list(got) == list(ref)
    for m in ref:
        _same(got[m], ref[m])
        assert got[m].engine_selected == "array"
        assert got[m].engine_fallback_reason == \
            ref[m].engine_fallback_reason != ""
        assert got[m].gc_invocations > 0


def test_online_simulate_batch_matches_reference(tables):
    """Two conditions at 300 P/E an erase: worn blocks resolve their bin
    at the simulated instant (365 d: 1500; 30 d: 500 to 1500)."""
    from repro.flashsim import ssd as RS

    cfg, rcfg = _online_cfgs(pec_per_erase=300.0)
    hot, rhot = _hot()
    kw = dict(mechanisms=("baseline", "sota+pr2ar2"), seeds=(2,),
              scheduler="host_prio_aged:4")
    ref = RS.simulate_batch(rhot, [_ref_cond(AGED), _ref_cond(MODEST)],
                            cfg=rcfg, **kw)
    got = TF.simulate_batch(hot, [COND, TF.OperatingCondition(*MODEST)],
                            cfg=cfg, device="cpu", **kw)
    assert len(got) == len(ref) == 4
    for gv, rv in zip(got.values(), ref.values()):
        _same(gv, rv)
        assert gv.gc_invocations > 0


def test_online_knob_on_the_default_geometry_matches_reference(tables):
    """``gc="online"`` on ``DEFAULT_SSD``, as the golden matrix runs it."""
    from repro.flashsim import ssd as RS

    kw = dict(seed=1, n_requests=1500, gc="online")
    ref = RS.simulate("rsrch", _ref_cond(AGED), "pr2ar2", **kw)
    got = TF.simulate("rsrch", COND, "pr2ar2", device="cpu", **kw)
    _same(got, ref)


def _run_exposed(pkg, cfg, trace, mech, seed):
    """Run one online cell through ``SSDSim._prepare`` and the event core
    by hand, so the controller (and its FTL) stays reachable afterwards."""
    if pkg == "port":
        sim = TF.SSDSim(cfg, COND, TRetryPolicy(mech), seed=seed,
                        device="cpu")
        core = TF.run_event_core
    else:
        from repro.core.retry import RetryPolicy
        from repro.flashsim import ssd as RS
        from repro.flashsim.engine import run_event_core as core

        sim = RS.SSDSim(cfg, _ref_cond(AGED), RetryPolicy(mech), seed=seed)
    prep = sim._prepare(trace)
    res = core(cfg, prep.pipelined, prep.sched_policy, prep.bufs,
               prep.n_requests, online=prep.online)
    return sim._finalize(prep, res), prep.online


@pytest.mark.parametrize("mech", ["baseline", "pr2ar2"])
def test_online_ftl_state_matches_reference(tables, mech):
    """After the run the controller's FTL holds the reference's mapping, free
    pools, frontiers and retired blocks, and the controller its counters."""
    from repro.flashsim import ssd as RS

    cfg, rcfg = _online_cfgs()
    hot, rhot = _hot()
    got, gon = _run_exposed("port", cfg, TF.resolve_trace(hot, seed=3),
                            mech, 5)
    ref, ron = _run_exposed("ref", rcfg, RS.resolve_trace(rhot, seed=3),
                            mech, 5)
    _same(got, ref)
    assert _state(gon.ftl) == _state(ron.ftl)
    assert (gon.write_stalls, gon.prefill_skips, gon.host_reads,
            gon.inflight_erases) == (ron.write_stalls, ron.prefill_skips,
                                     ron.host_reads, ron.inflight_erases)
    assert gon.ftl.gc_invocations > 0


# -- the batched gate ----------------------------------------------------------


def test_batched_engine_refuses_online_gc(tables):
    """The reference's words, from every run API; ``auto`` records them."""
    from repro.flashsim import ssd as RS
    from repro.flashsim.engine_batched import BatchedUnsupported as RBU

    kw = dict(n_requests=50, gc="online", engine="batched")
    with pytest.raises(RBU) as want:
        RS.simulate("prn", _ref_cond(AGED), "pr2ar2", **kw)
    for call in (
        lambda: TF.simulate("prn", COND, "pr2ar2", device="cpu", **kw),
        lambda: TF.compare_mechanisms("prn", COND, device="cpu", **kw),
        lambda: TF.simulate_batch("prn", [COND], device="cpu", **kw),
    ):
        with pytest.raises(TF.BatchedUnsupported) as got:
            call()
        assert str(got.value) == str(want.value)
        assert "online GC" in str(got.value)
    auto = TF.simulate("prn", COND, "pr2ar2", device="cpu",
                       **dict(kw, engine="auto"))
    assert auto.engine_selected == "array"
    assert auto.engine_fallback_reason == str(want.value)


def test_closed_loop_keeps_refusing_online_gc(tables):
    with pytest.raises(NotImplementedError, match="online GC"):
        TF.simulate("prn", COND, "pr2ar2", n_requests=100, gc="online",
                    ncq_depth=8, device="cpu")


def test_reference_engine_keeps_refusing_online_gc(tables):
    with pytest.raises(NotImplementedError, match="FTL"):
        TF.simulate("prn", COND, "baseline", n_requests=100, gc="online",
                    engine="reference", device="cpu")


# -- the reference's behaviour tests (tests/test_ftl.py, TestOnlineGC) -------


GC_SSD = TF.SSDConfig(gc=TF.GCConfig(enabled=True))


def _wl(name, n):
    return dataclasses.replace(TF.make_workloads()[name], n_requests=n)


class TestOnlineGC:
    """Completion-time-triggered GC (``GCConfig.mode="online"``)."""

    def test_online_gc_collects_and_amplifies(self, tables):
        s = TF.simulate(_wl("rsrch", 2500), COND, "baseline", seed=0,
                        gc="online", device="cpu")
        assert s.wa > 1.0
        assert s.gc_invocations > 0
        assert s.blocks_erased > 0
        assert s.gc_page_reads > 0

    def test_online_deterministic(self, tables):
        w = _wl("rsrch", 1500)
        a = TF.simulate(w, COND, "pr2ar2", seed=5, gc="online", device="cpu")
        b = TF.simulate(w, COND, "pr2ar2", seed=5, gc="online", device="cpu")
        assert a == b

    def test_online_wa_close_to_prepass(self, tables):
        """Same mapping state machine, different trigger instants: WA
        lands near the prepass figure."""
        w = _wl("rsrch", 2500)
        pre = TF.simulate(w, COND, "baseline", seed=0, cfg=GC_SSD,
                          device="cpu")
        onl = TF.simulate(w, COND, "baseline", seed=0, gc="online",
                          device="cpu")
        assert onl.wa == pytest.approx(pre.wa, rel=0.15)

    def test_online_wa_policy_invariant_within_tolerance(self, tables):
        w = _wl("prn", 2500)
        was = [TF.simulate(w, COND, "baseline", seed=0, gc="online",
                           scheduler=sched, device="cpu").wa
               for sched in ("fcfs", "host_prio", "preempt")]
        assert max(was) <= min(was) * 1.05
        assert min(was) > 1.0

    def test_reclaim_takes_simulated_time(self, tables):
        from repro_torch.flashsim.ssd import _with_knobs

        w = _wl("rsrch", 2500)
        trace = TF.cached_trace(w, seed=0)
        cfg = _with_knobs(TF.SSDConfig(), None, "online")
        sim = TF.SSDSim(cfg, COND, TRetryPolicy("baseline"), seed=7,
                        device="cpu")
        stats = sim.run(trace)
        assert (sim.last_req_done_us >= trace.arrival_us).all()
        assert stats.write_stalls >= 0    # populated (0 is legal)

    def test_watermark_knob_validated(self):
        with pytest.raises(ValueError, match="watermark_blocks"):
            TF.GCConfig(enabled=True, mode="online", watermark_blocks=0)
        with pytest.raises(ValueError, match="mode"):
            TF.GCConfig(enabled=True, mode="lazy")

    def test_higher_watermark_starts_gc_earlier(self, tables):
        w = _wl("rsrch", 2000)
        lo = TF.simulate(w, COND, "baseline", seed=0, gc="online",
                         device="cpu")
        hi = TF.simulate(w, COND, "baseline", seed=0, device="cpu",
                         cfg=TF.SSDConfig(gc=TF.GCConfig(
                             enabled=True, mode="online",
                             watermark_blocks=4)))
        assert hi.gc_invocations >= lo.gc_invocations
        assert hi.wa >= lo.wa > 1.0
