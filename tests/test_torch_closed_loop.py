"""The port's closed-loop frontend and host write-back cache against the
JAX reference, on the CPU.

Three parts:

* **The open-loop half of the contract.** ``tests/data/golden_closed_loop
  .json`` pins the open-loop output (``ncq_depth=None``) of ``prn`` at 600
  requests, 365 d / 1000 P/E.  All 32 cells (5 schedulers x gc off,
  prepass and online x no faults and the ``fc`` fault configuration, and
  2 extra mechanism cells) are held on the port's own CPU
  characterization: every pinned field equal, except ``die_util`` and
  ``channel_util``, held to 4 ulps (the reference's own output drifts
  from those pins by 1-2 ulps: ROADMAP C4).  The 8 fault-free cells with
  gc off or prepass whose scheduler has a ring lowering are held through
  ``engine="batched"`` and ``"auto"`` too; every other cell through
  ``"auto"``, which records why it ran the array interpreter, and the
  online and fault cells are refused by ``"batched"``.
* **Closed-loop parity.** With the synthetic tables of
  ``tests/test_torch_flashsim.py`` in both packages, closed-loop SimStats
  (and ``last_phases`` under ``trace_phases=True``) equal the
  reference's: ``websearch`` at QD 1/8/32, and ``prn`` through the FTL
  pre-pass at QD 4/8 under fcfs, host_prio, host_prio_aged:8 and
  tokens:4,2, with no cache, a fifo and an lru cache.
* **Semantics.** The reference's closed-loop behaviour tests
  (``tests/test_closed_loop.py``: validation, NCQ admission, the
  wait/device decomposition, the deep queue, determinism, ``shard=``
  ignored, the saturation ladder, the write cache's integration, faults
  under the closed loop) restated on the port, on its own
  characterization; and the batched engine's closed-loop gate.
"""

import dataclasses
import json
import math
from pathlib import Path

import pytest

import repro_torch.flashsim as TF
from test_torch_flashsim import (AGED, _ref_cond, _same,  # noqa: F401
                                 one_thread, tables)
from test_torch_ftl import _cfgs, _hot, own_cache, own_tables  # noqa: F401

GOLDEN = json.loads((Path(__file__).parent / "data"
                     / "golden_closed_loop.json").read_text())
COND = TF.OperatingCondition(*AGED)
N = GOLDEN["meta"]["n_requests"]

#: Every pinned cell: the port runs them all.
REACHABLE = sorted(GOLDEN["cells"])
#: The cells inside the batched matrix: a scheduler with a ring
#: lowering, gc off or prepass, no faults.
RING = [k for k in REACHABLE
        if k.split("|")[1] in ("fcfs", "host_prio", "host_prio_aged:8")
        and k.split("|")[2] != "online" and k.endswith("|none")]
#: The cells the batched engine refuses for online GC or faults.
HOST_ONLY = [k for k in REACHABLE
             if k.split("|")[2] == "online" or not k.endswith("|none")]

#: Fields that only the closed loop fills.
CLOSED_FIELDS = (
    "hostq_wait_mean_us", "hostq_wait_p99_us", "device_mean_us",
    "read_device_p99_us", "throughput_iops", "max_inflight",
    "cache_hit_reads", "cache_hit_pages", "cache_absorbed_writes",
    "cache_flush_pages", "cache_stalled_writes", "die_sense_util",
)

CACHES = {
    "none": None,
    "fifo": dict(capacity_pages=32, flush_high=0.5, flush_low=0.25),
    "lru": dict(capacity_pages=32, flush_high=0.5, flush_low=0.25,
                eviction="lru"),
}


def _cell_args(key):
    mech, sched, gc, fname = key.split("|")
    wl = GOLDEN["meta"]["extra_workload"] if mech in (
        "baseline", "sota+pr2ar2") else GOLDEN["meta"]["workload"]
    fc = GOLDEN["meta"]["fault_configs"][fname]
    return wl, mech, sched, gc, None if fc is None else TF.FaultConfig(**fc)


def _assert_pinned(stats, want, ctx):
    got = dataclasses.asdict(stats)
    for field, v in want.items():
        if field in ("die_util", "channel_util"):
            assert abs(got[field] - v) <= 4 * math.ulp(v), (ctx, field)
        else:
            assert got[field] == v, (ctx, field, got[field], v)


# -- the open-loop half: golden_closed_loop.json -----------------------------


def test_reachable_cells():
    """32 cells: 5 schedulers x gc off/prepass/online x faults none/fc,
    and the 2 extra mechanism cells; 8 of them inside the batched
    matrix, 20 refused by it for online GC or faults."""
    assert len(REACHABLE) == 32 and len(RING) == 8 and len(HOST_ONLY) == 20


@pytest.mark.parametrize("key", REACHABLE)
def test_golden_cell_on_the_ports_own_characterization(own_tables, key):
    wl, mech, sched, gc, fc = _cell_args(key)
    kw = dict(seed=GOLDEN["meta"]["seed"], n_requests=N, scheduler=sched,
              gc=gc, faults=fc, device="cpu")
    engines = ("array", "batched", "auto") if key in RING else ("array",
                                                                "auto")
    for engine in engines:
        stats = TF.simulate(wl, COND, mech, engine=engine, **kw)
        _assert_pinned(stats, GOLDEN["cells"][key], f"{key}[{engine}]")
        batched = key in RING and engine != "array"
        assert stats.engine_selected == ("batched" if batched else "array")
        assert (stats.fast_path_events > 0) == batched
        assert (stats.engine_fallback_reason != "") == (
            engine == "auto" and not batched)
        for f in CLOSED_FIELDS:
            assert getattr(stats, f) == 0, f
    if key in HOST_ONLY:
        with pytest.raises(TF.BatchedUnsupported) as refusal:
            TF.simulate(wl, COND, mech, engine="batched", **kw)
        assert str(refusal.value) == stats.engine_fallback_reason


# -- closed-loop parity on shared tables -------------------------------------


def _host_caches(name):
    """The cache configuration ``name`` in both packages: (port, ref)."""
    from repro.flashsim.config import HostCacheConfig

    kw = CACHES[name]
    if kw is None:
        return None, None
    return TF.HostCacheConfig(**kw), HostCacheConfig(**kw)


@pytest.mark.parametrize("qd", [1, 8, 32])
def test_websearch_closed_loop_matches_reference(tables, qd):
    """A serial, a pipelined and a SOTA-start mechanism over one trace."""
    from repro.flashsim import ssd as RS

    kw = dict(mechanisms=("baseline", "pr2ar2", "sota+pr2ar2"), seed=1,
              n_requests=300, ncq_depth=qd)
    ref = RS.compare_mechanisms("websearch", _ref_cond(AGED), **kw)
    got = TF.compare_mechanisms("websearch", COND, device="cpu", **kw)
    assert list(got) == list(ref)
    for m in ref:
        _same(got[m], ref[m])
        assert 1 <= got[m].max_inflight <= qd


@pytest.mark.parametrize("cache", sorted(CACHES))
@pytest.mark.parametrize("scheduler", ["fcfs", "host_prio",
                                       "host_prio_aged:8", "tokens:4,2"])
@pytest.mark.parametrize("qd", [4, 8])
def test_prepass_closed_loop_matches_reference(tables, qd, scheduler, cache):
    """``prn`` on its hot span through the FTL pre-pass (GC passes,
    worn-bin reads), two mechanisms over one schedule."""
    from repro.flashsim import ssd as RS

    cfg, rcfg = _cfgs()
    hot, rhot = _hot()
    hc, rhc = _host_caches(cache)
    kw = dict(mechanisms=("baseline", "pr2ar2"), seed=0, scheduler=scheduler,
              ncq_depth=qd)
    ref = RS.compare_mechanisms(rhot, _ref_cond(AGED), cfg=rcfg,
                                host_cache=rhc, **kw)
    got = TF.compare_mechanisms(hot, COND, cfg=cfg, host_cache=hc,
                                device="cpu", **kw)
    for m in ref:
        _same(got[m], ref[m])
        assert got[m].gc_invocations > 0 and got[m].max_inflight <= qd
        if cache != "none":
            assert got[m].cache_absorbed_writes > 0


@pytest.mark.parametrize("cache", sorted(CACHES))
@pytest.mark.parametrize("mech", ["baseline", "pr2ar2"])
def test_trace_phases_match_reference(tables, mech, cache):
    """``trace_phases=True``: every sense, transfer, program and erase
    interval, in the order the loop recorded them, is the reference's."""
    from repro.core.retry import RetryPolicy
    from repro.flashsim import ssd as RS
    from repro_torch.core.retry import RetryPolicy as TRetryPolicy

    cfg, rcfg = _cfgs()
    hot, rhot = _hot()
    hc, rhc = _host_caches(cache)
    cfg = dataclasses.replace(cfg, ncq_depth=4, host_cache=hc)
    rcfg = dataclasses.replace(rcfg, ncq_depth=4, host_cache=rhc)
    ref = RS.SSDSim(rcfg, _ref_cond(AGED), RetryPolicy(mech), seed=3)
    got = TF.SSDSim(cfg, COND, TRetryPolicy(mech), seed=3, device="cpu")
    rs = ref.run(RS.resolve_trace(rhot, seed=2), trace_phases=True)
    gs = got.run(TF.resolve_trace(hot, seed=2), trace_phases=True)
    _same(gs, rs)
    assert got.last_phases == ref.last_phases
    assert {p[1] for p in got.last_phases} == {"sense", "xfer", "prog",
                                               "erase"}
    assert got.events_processed == ref.events_processed
    got.run(TF.resolve_trace(hot, seed=2))
    assert got.last_phases is None


def test_simulate_batch_closed_loop_matches_reference(tables):
    from repro.flashsim import ssd as RS

    hc, rhc = _host_caches("lru")
    cfg, rcfg = _cfgs()
    hot, rhot = _hot()
    kw = dict(mechanisms=("baseline", "sota+pr2ar2"), seeds=(0, 1),
              ncq_depth=8, engine="auto")
    ref = RS.simulate_batch(rhot, [_ref_cond(AGED)], cfg=rcfg,
                            host_cache=rhc, **kw)
    got = TF.simulate_batch(hot, [COND], cfg=cfg, host_cache=hc,
                            device="cpu", **kw)
    assert len(got) == len(ref) == 4
    for gv, rv in zip(got.values(), ref.values()):
        _same(gv, rv)
        assert gv.engine_selected == "array"
        assert gv.engine_fallback_reason == rv.engine_fallback_reason


# -- the batched gate and the refusals ---------------------------------------


def test_batched_engine_refuses_the_closed_loop(tables):
    """The reference's words, from ``SSDSim`` and from every run API."""
    from repro.flashsim import ssd as RS
    from repro.flashsim.engine_batched import BatchedUnsupported as RBU

    kw = dict(n_requests=50, ncq_depth=8, engine="batched")
    with pytest.raises(RBU) as want:
        RS.simulate("websearch", _ref_cond(AGED), "pr2ar2", **kw)
    for call in (
        lambda: TF.simulate("websearch", COND, "pr2ar2", device="cpu", **kw),
        lambda: TF.compare_mechanisms("websearch", COND, device="cpu", **kw),
        lambda: TF.simulate_batch("websearch", [COND], device="cpu", **kw),
    ):
        with pytest.raises(TF.BatchedUnsupported) as got:
            call()
        assert str(got.value) == str(want.value)
        assert "open-loop only" in str(got.value)
    cfg = dataclasses.replace(TF.DEFAULT_SSD, ncq_depth=8)
    assert TF.resolve_engine(cfg, device="cpu") == ("array", str(want.value))


def test_auto_records_the_closed_loop_fallback(tables):
    from repro.flashsim import ssd as RS

    kw = dict(seed=2, n_requests=200, ncq_depth=8, engine="auto")
    ref = RS.simulate("websearch", _ref_cond(AGED), "pr2ar2", **kw)
    got = TF.simulate("websearch", COND, "pr2ar2", device="cpu", **kw)
    _same(got, ref)
    assert got.engine_selected == ref.engine_selected == "array"
    assert got.engine_fallback_reason == ref.engine_fallback_reason
    assert "open-loop only" in got.engine_fallback_reason
    assert got.fast_path_events == 0
    array = TF.simulate("websearch", COND, "pr2ar2", device="cpu",
                        **dict(kw, engine="array"))
    _same(got, array)


# -- the reference's semantics tests, on the port (tests/test_closed_loop.py)


def test_new_fields_zero_on_open_loop(own_tables):
    stats = TF.simulate("prn", COND, "pr2ar2", seed=0, n_requests=200,
                        gc="prepass", device="cpu")
    for f in CLOSED_FIELDS:
        assert getattr(stats, f) == 0, f"{f} must default to 0 open-loop"


class TestConfigValidation:
    def test_ncq_depth_must_be_positive(self):
        with pytest.raises(ValueError, match="ncq_depth"):
            dataclasses.replace(TF.DEFAULT_SSD, ncq_depth=0)

    def test_host_cache_requires_ncq(self):
        with pytest.raises(ValueError, match="host_cache"):
            dataclasses.replace(TF.DEFAULT_SSD,
                                host_cache=TF.HostCacheConfig())

    def test_watermark_ordering(self):
        with pytest.raises(ValueError):
            TF.HostCacheConfig(flush_high=0.3, flush_low=0.6)
        with pytest.raises(ValueError):
            TF.HostCacheConfig(capacity_pages=0)

    def test_unsupported_combinations_raise(self, tables):
        with pytest.raises(NotImplementedError, match="online"):
            TF.simulate("prn", COND, "pr2ar2", seed=0, n_requests=100,
                        gc="online", ncq_depth=8, device="cpu")
        with pytest.raises(NotImplementedError, match="preempt"):
            TF.simulate("prn", COND, "pr2ar2", seed=0, n_requests=100,
                        scheduler="preempt", gc="prepass", ncq_depth=8,
                        device="cpu")
        with pytest.raises(NotImplementedError, match="array engine"):
            TF.simulate("websearch", COND, "pr2ar2", seed=0, n_requests=50,
                        engine="reference", ncq_depth=8, device="cpu")


def _sim(wl, mech="pr2ar2", **kw):
    kw.setdefault("seed", 0)
    return TF.simulate(wl, COND, mech, device="cpu", **kw)


class TestNCQAdmission:
    def test_inflight_never_exceeds_depth(self, own_tables):
        for qd in (1, 3, 8):
            stats = _sim("prn", n_requests=300, gc="prepass", ncq_depth=qd,
                         validate=True)
            assert 1 <= stats.max_inflight <= qd

    def test_depth_one_serializes(self, own_tables):
        stats = _sim("websearch", n_requests=300, ncq_depth=1)
        assert stats.max_inflight == 1
        assert stats.hostq_wait_mean_us > 0.0
        per_req = 1e6 / stats.throughput_iops
        assert per_req >= stats.device_mean_us

    def test_wait_plus_device_decomposition(self, own_tables):
        stats = _sim("prn", n_requests=400, gc="prepass", ncq_depth=4)
        lhs = stats.hostq_wait_mean_us + stats.device_mean_us \
            + TF.DEFAULT_SSD.host_overhead_us
        assert lhs == pytest.approx(stats.mean_us, rel=1e-9)

    def test_deep_queue_converges_to_open_loop(self, own_tables):
        open_ = _sim("prn", n_requests=400, gc="prepass")
        closed = _sim("prn", n_requests=400, gc="prepass", ncq_depth=10_000)
        assert closed.mean_us == pytest.approx(open_.mean_us, rel=1e-12)
        assert closed.read_p99_us == pytest.approx(open_.read_p99_us,
                                                   rel=1e-12)
        assert closed.hostq_wait_mean_us == 0.0

    def test_closed_loop_deterministic(self, own_tables):
        kw = dict(seed=3, n_requests=300, gc="prepass", ncq_depth=8,
                  host_cache=TF.HostCacheConfig(capacity_pages=64))
        assert _sim("prn", **kw) == _sim("prn", **kw)

    def test_shard_flag_ignored_under_closed_loop(self, own_tables):
        kw = dict(n_requests=300, gc="prepass", ncq_depth=8)
        assert _sim("prn", shard=False, **kw) == _sim("prn", shard=True, **kw)


class TestSaturation:
    LADDER = (1, 2, 4, 8, 16, 32)

    def _ladder(self, wl, mech="pr2ar2", n=600, **kw):
        return [_sim(wl, mech, n_requests=n, gc="prepass", ncq_depth=qd,
                     **kw) for qd in self.LADDER]

    def test_throughput_monotone_with_knee(self, own_tables):
        iops = [s.throughput_iops for s in self._ladder("prn")]
        for lo, hi in zip(iops, iops[1:]):
            assert hi >= lo * (1 - 1e-9), f"throughput dropped: {iops}"
        assert iops[1] / iops[0] > 1.7
        assert iops[-1] / iops[-2] < 1.5

    @pytest.mark.parametrize("wl", ["prn", "src"])
    def test_read_p99_qd_bounded_on_gc_cliff(self, own_tables, wl):
        open_p99 = _sim(wl, n_requests=600, gc="prepass").read_p99_us
        for qd, s in zip(self.LADDER, self._ladder(wl)):
            if qd > 16:
                continue
            assert s.read_device_p99_us <= open_p99 * (1 + 1e-9), qd

    def test_pr2_overlap_win_closed_loop(self, own_tables):
        base = _sim("websearch", "baseline", n_requests=600, ncq_depth=8)
        pipe = _sim("websearch", "sota+pr2ar2", n_requests=600, ncq_depth=8)
        assert pipe.throughput_iops > base.throughput_iops * 1.2
        assert pipe.read_p99_us < base.read_p99_us
        assert pipe.die_sense_util > 0.0


class TestWriteCacheIntegration:
    HC = TF.HostCacheConfig(capacity_pages=256)

    def test_absorbed_writes_complete_at_host_speed(self, own_tables):
        kw = dict(n_requests=400, gc="prepass", ncq_depth=8)
        stats = _sim("prn", host_cache=self.HC, **kw)
        assert stats.cache_absorbed_writes > 0
        assert stats.cache_stalled_writes == 0
        assert stats.cache_flush_pages > 0
        assert stats.mean_us < _sim("prn", **kw).mean_us

    def test_read_hits_serve_from_dirty_lines(self, own_tables):
        stats = _sim("prn", n_requests=600, gc="prepass", ncq_depth=8,
                     host_cache=self.HC)
        assert stats.cache_hit_pages > 0

    def test_tiny_cache_backpressures(self, own_tables):
        tiny = TF.HostCacheConfig(capacity_pages=8, flush_high=0.5,
                                  flush_low=0.25)
        stats = _sim("prn", n_requests=400, gc="prepass", ncq_depth=8,
                     host_cache=tiny, validate=True)
        assert stats.cache_stalled_writes > 0
        assert stats.cache_flush_pages >= stats.cache_absorbed_writes

    @pytest.mark.parametrize("eviction", ["fifo", "lru"])
    def test_flush_traffic_preserves_wa_accounting(self, own_tables,
                                                   eviction):
        hc = TF.HostCacheConfig(capacity_pages=256, eviction=eviction)
        kw = dict(n_requests=400, gc="prepass", ncq_depth=8)
        with_ = _sim("prn", host_cache=hc, **kw)
        without = _sim("prn", **kw)
        assert with_.wa == without.wa
        assert with_.blocks_erased == without.blocks_erased

    def test_lru_end_to_end_drains_clean(self, own_tables):
        hc = TF.HostCacheConfig(capacity_pages=32, flush_high=0.5,
                                flush_low=0.25, eviction="lru")
        stats = _sim("prn", n_requests=400, gc="prepass", ncq_depth=8,
                     host_cache=hc, validate=True)
        assert stats.cache_absorbed_writes > 0
        assert stats.cache_flush_pages >= stats.cache_absorbed_writes


FAULT_FIELDS = (
    "mispredicted_reads", "rescued_reads", "parity_rebuilds",
    "rebuild_reads", "retired_blocks", "program_fails", "erase_fails",
    "unrecoverable",
)


class TestFaultsClosedLoop:
    FC = TF.FaultConfig(**GOLDEN["meta"]["fault_configs"]["fc"])

    def test_failure_set_is_queue_depth_invariant(self, own_tables):
        """The fault plan is drawn per (seed, die) in admission order:
        the NCQ changes when ops run, never which ones fail."""
        open_ = _sim("prn", n_requests=600, gc="prepass", faults=self.FC)
        assert open_.mispredicted_reads > 0
        for qd in (2, 16):
            closed = _sim("prn", n_requests=600, gc="prepass",
                          faults=self.FC, ncq_depth=qd)
            for f in FAULT_FIELDS:
                assert getattr(closed, f) == getattr(open_, f), f

    def test_faults_with_cache(self, own_tables):
        stats = _sim("prn", n_requests=400, gc="prepass", faults=self.FC,
                     ncq_depth=8,
                     host_cache=TF.HostCacheConfig(capacity_pages=64),
                     validate=True)
        assert stats.unrecoverable == 0
        assert stats.cache_absorbed_writes > 0


@pytest.mark.parametrize("cache", ["none", "lru"])
@pytest.mark.parametrize("gc", ["off", "prepass"])
def test_faults_closed_loop_match_reference(tables, gc, cache):
    """The fault plan's recovery tails run live in the closed loop: QD 8,
    the golden ``fc`` configuration and the recovery configuration of
    the reference's ``TestOnlineRecovery``, on the hot-span cell."""
    from repro.flashsim import config as RCFG
    from repro.flashsim import ssd as RS

    cfg, rcfg = _cfgs()
    hot, rhot = _hot()
    hc, rhc = _host_caches(cache)
    for fkw in (GOLDEN["meta"]["fault_configs"]["fc"],
                dict(uncorrectable_prob=0.6, escalation_attempts=1)):
        kw = dict(mechanisms=("baseline", "pr2ar2"), seed=0, gc=gc,
                  ncq_depth=8)
        ref = RS.compare_mechanisms(rhot, _ref_cond(AGED), cfg=rcfg,
                                    host_cache=rhc,
                                    faults=RCFG.FaultConfig(**fkw), **kw)
        got = TF.compare_mechanisms(hot, COND, cfg=cfg, host_cache=hc,
                                    faults=TF.FaultConfig(**fkw),
                                    device="cpu", **kw)
        for m in ref:
            _same(got[m], ref[m])
            assert got[m].max_inflight <= 8
            if fkw.get("uncorrectable_prob") == 0.6:
                assert got[m].parity_rebuilds > 0
        assert got["pr2ar2"].recovery_p99_us > 0.0


def test_compare_and_batch_take_the_knob(own_tables):
    grid = TF.compare_mechanisms("websearch", COND,
                                 mechanisms=("baseline", "pr2ar2"), seed=0,
                                 n_requests=200, ncq_depth=8, device="cpu")
    assert all(g.max_inflight >= 1 for g in grid.values())
    batch = TF.simulate_batch("websearch", (COND,), mechanisms=("pr2ar2",),
                              seeds=(0,), n_requests=200, ncq_depth=8,
                              device="cpu")
    assert next(iter(batch.values())).max_inflight >= 1
