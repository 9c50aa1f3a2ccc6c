"""The port's FTL and prepass GC against the JAX reference, on the CPU.

``PageMapFTL`` and ``build_ftl_schedule`` are host code with no RNG, so
the port's must equal the reference's exactly: the mapping state after
every drain of random churn (GC pressure, retirements, the deferred-free
mode online GC and faults use), and every column of the schedule.  ROADMAP
C3's example must raise the reference's error.

Prepass-GC ``SimStats`` are held as ``tests/test_torch_flashsim.py``
holds the in-place ones: both packages read its synthetic tables (with
the worn P/E bins GC erases reach), and every compared field must be
equal, on the array, batched and auto engines, sharded, fused and not,
under the fcfs, host_prio and host_prio_aged:4 schedulers.  Most cells
run ``prn`` over a hot span of 512 pages on 8 dies (one a channel) with
8 pages a block: within 200 requests blocks are collected, erased,
rewritten and read again, so GC and host reads sample the worn bins,
and the CPU's plain shard core stays cheap.

The reference's own behaviour tests (``tests/test_ftl.py``,
``TestEngineWithGC``) run here against the port, and the port's own
characterization reproduces the pinned ``compare_gc_prepass`` cell of
``tests/data/golden_workloads.json`` end to end.
"""

import contextlib
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest

import repro_torch.flashsim as TF
from repro_torch.core import characterize as TC
from repro_torch.flashsim import ftl as TFTL
from test_torch_flashsim import (AGED, ENGINES, MODEST, SCHEDULERS,  # noqa: F401
                                 _ref_cond, _same, _synthetic_tables,
                                 one_thread, tables)

GOLDEN = json.loads((Path(__file__).parent / "data"
                     / "golden_workloads.json").read_text())
#: ``prn`` over a hot span of 512 pages, 200 requests: on 8 dies with 8
#: pages a block, 44-54 GC passes a seed (0-2), and 60-93 reads of
#: blocks erased before.
HOT_SPAN = 512
N_GC = 200


def _cfgs(**gc_kw):
    """The churn configuration in both packages: (port, reference)."""
    from repro.flashsim import config as RCFG

    kw = dict(dict(enabled=True, pages_per_block=8), **gc_kw)
    return (TF.SSDConfig(dies_per_channel=1, gc=TF.GCConfig(**kw)),
            RCFG.SSDConfig(dies_per_channel=1, gc=RCFG.GCConfig(**kw)))


def _hot():
    """``prn`` on its hot span in both packages: (port, reference)."""
    from repro.flashsim.workloads import make_workloads

    return tuple(dataclasses.replace(mk()["prn"], span_pages=HOT_SPAN,
                                     n_requests=N_GC)
                 for mk in (TF.make_workloads, make_workloads))


# -- PageMapFTL ------------------------------------------------------------


def _ftls(n_channels=2, dies_per_channel=2, lpns=None, ftl_kw=None,
          **gc_kw):
    """A port and a reference ``PageMapFTL`` on one geometry."""
    from repro.flashsim import config as RCFG
    from repro.flashsim import ftl as RFTL

    kw = dict(enabled=True, pages_per_block=8, blocks_per_die=6)
    kw.update(gc_kw)
    port = TFTL.PageMapFTL(
        TF.SSDConfig(n_channels=n_channels, dies_per_channel=dies_per_channel,
                     gc=TF.GCConfig(**kw)), lpns=lpns, **(ftl_kw or {}))
    ref = RFTL.PageMapFTL(
        RCFG.SSDConfig(n_channels=n_channels,
                       dies_per_channel=dies_per_channel,
                       gc=RCFG.GCConfig(**kw)), lpns=lpns, **(ftl_kw or {}))
    return port, ref


def _state(ftl):
    """Everything a ``PageMapFTL`` holds, as plain values."""
    return dict(
        l2p=dict(ftl.l2p), p2l=ftl.p2l.tolist(), valid=ftl.valid.tolist(),
        wp=ftl.wp.tolist(), erases=ftl.erases.tolist(),
        free=[list(q) for q in ftl.free], active=list(ftl.active),
        gc_active=list(ftl.gc_active),
        sealed=[sorted(s) for s in ftl.sealed], retired=sorted(ftl.retired),
        gc_log=list(ftl.gc_log), stats=dataclasses.asdict(ftl.stats(7)),
        wa=ftl.write_amplification,
        can_alloc=[(ftl.can_alloc(d, False), ftl.can_alloc(d, True))
                   for d in range(ftl.n_dies)],
    )


def _lockstep(port, ref, step):
    """Apply ``step(ftl)`` to both FTLs; the reference's outcome (a
    return value or an error message) must be the port's, and so must
    the state and the drained events after it."""
    outs = []
    for ftl in (ref, port):
        try:
            outs.append(("ok", step(ftl)))
        except RuntimeError as e:
            outs.append(("raised", str(e)))
    assert outs[1] == outs[0]
    assert port.drain_events() == ref.drain_events()
    assert _state(port) == _state(ref)
    return outs[0]


def _churn(port, ref, seed, n_ops, span, retire=True, deferred=False):
    """Seeded writes, pre-filling reads and retirements in lockstep; in
    the deferred mode also explicit collections, and each erase either
    returned to its pool or retired as failed."""
    rng = np.random.default_rng(seed)
    for _ in range(n_ops):
        op = int(rng.integers(0, 6))
        lpn = int(rng.integers(0, span))
        die = int(rng.integers(0, ref.n_dies))
        if op <= 2:
            if ref.can_alloc(lpn % ref.n_dies):
                out = _lockstep(port, ref, lambda f: f.host_write(lpn))
            else:
                out = ("stalled", None)
        elif op == 3:
            out = _lockstep(port, ref, lambda f: f.host_read(lpn))
        elif op == 4 and retire and ref.sealed[die]:
            blk = sorted(ref.sealed[die])[int(rng.integers(
                0, len(ref.sealed[die])))]
            out = _lockstep(port, ref, lambda f: f.retire_block(die, blk))
        elif deferred:
            erased = []

            def collect(f):
                done = f._collect(die)
                erased.append([e for e in f._events if e[0] == TFTL.OP_ERASE])
                return done
            out = _lockstep(port, ref, collect)
            for kind, d, _, _, blk in erased[0]:
                if rng.random() < 0.2:
                    _lockstep(port, ref,
                              lambda f: f.retire_erase_failed(d, blk))
                else:
                    _lockstep(port, ref, lambda f: f.erase_complete(d, blk))
        else:
            continue
        if out[0] == "raised":
            return out[1]
    return None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ftl_matches_reference_under_gc_pressure(seed):
    port, ref = _ftls()
    assert _churn(port, ref, seed, n_ops=2500, span=4 * 32,
                  retire=False) is None
    assert ref.gc_invocations > 0


def test_ftl_matches_reference_without_gc_pressure():
    port, ref = _ftls(blocks_per_die=64)
    assert _churn(port, ref, 3, n_ops=1000, span=4 * 32,
                  retire=False) is None
    assert ref.gc_invocations == 0


@pytest.mark.parametrize("seed", [4, 5])
def test_ftl_matches_reference_deferred_free(seed):
    """The mode online GC and faults drive (ROADMAP D3, D2): no
    collection of its own, erased victims back in the pool only when
    told (``erase_complete``) or retired (``retire_erase_failed``)."""
    port, ref = _ftls(ftl_kw=dict(auto_gc=False, defer_free=True),
                      blocks_per_die=10)
    _churn(port, ref, seed, n_ops=2500, span=4 * 40, deferred=True)
    assert ref.gc_invocations > 0
    assert ref.blocks_retired > 0


@pytest.mark.parametrize("seed", [0, 2, 3])
def test_ftl_retirement_matches_reference(seed):
    """The geometry of ``test_properties.py``'s retirement property:
    4 pages a block, 8 blocks a die, GC at one free block.  Retired
    blocks never return, so a run may end out of free blocks (C3): the
    port then raises the reference's error at the same op."""
    port, ref = _ftls(lpns=np.arange(40), pages_per_block=4,
                      blocks_per_die=8, gc_threshold_blocks=1)
    _churn(port, ref, seed, n_ops=300, span=40)
    assert ref.blocks_retired > 0


def test_c3_raises_the_references_error():
    """ROADMAP C3: ``test_ftl_retirement_bijectivity_property``'s
    example (seed 1, 74 ops) runs the allocator dry; the port raises the
    reference's error at the same op."""
    port, ref = _ftls(lpns=np.arange(40), pages_per_block=4,
                      blocks_per_die=8, gc_threshold_blocks=1)
    rng = np.random.default_rng(1)
    raised = None
    for _ in range(74):
        op = rng.integers(0, 4)
        if op <= 1:
            lpn = int(rng.integers(0, 40))
            out = _lockstep(port, ref, lambda f: f.host_write(lpn))
        elif op == 2:
            lpn = int(rng.integers(0, 40))
            out = _lockstep(port, ref, lambda f: f.host_read(lpn))
        else:
            die = int(rng.integers(0, ref.n_dies))
            if not ref.sealed[die]:
                continue
            blk = sorted(ref.sealed[die])[
                int(rng.integers(0, len(ref.sealed[die])))]
            out = _lockstep(port, ref, lambda f: f.retire_block(die, blk))
        if out[0] == "raised":
            raised = out[1]
            break
    assert raised is not None and raised.startswith(
        "FTL die 3 out of free blocks")


def test_ftl_auto_sizing_and_out_of_space():
    with pytest.raises(ValueError, match="auto-size"):
        TFTL.PageMapFTL(TF.SSDConfig(gc=TF.GCConfig(enabled=True)))
    port, _ = _ftls(blocks_per_die=4, gc_threshold_blocks=1)
    with pytest.raises(RuntimeError, match="out of free blocks"):
        for lpn in range(4 * 10 * 8):
            port.host_write(lpn)
            port.drain_events()


# -- build_ftl_schedule ----------------------------------------------------


_COLUMNS = ("arrival_us", "rid", "die", "chan", "ptype", "kind", "dur_us",
            "wear_pec", "lpn")


@pytest.mark.parametrize("workload,n,gc_kw", [
    ("prn", 1200, {}),
    ("rsrch", 1000, {}),
    ("src", 600, {}),
    ("prn", 1500, dict(pec_per_erase=300.0)),
    ("prn", 800, dict(pages_per_block=8)),
])
def test_schedule_matches_reference(workload, n, gc_kw):
    from repro.flashsim import config as RCFG
    from repro.flashsim import ftl as RFTL
    from repro.flashsim import ssd as RS

    kw = dict(dict(enabled=True), **gc_kw)
    cfg = TF.SSDConfig(gc=TF.GCConfig(**kw))
    rcfg = RCFG.SSDConfig(gc=RCFG.GCConfig(**kw))
    trace = TF.resolve_trace(workload, seed=3, n_requests=n)
    rtrace = RS.resolve_trace(workload, seed=3, n_requests=n)
    got = TF.build_ftl_schedule(trace, cfg)
    want = RFTL.build_ftl_schedule(rtrace, rcfg)
    for col in _COLUMNS:
        g, w = getattr(got, col), getattr(want, col)
        assert g.dtype == w.dtype and np.array_equal(g, w), col
    assert got.n_requests == want.n_requests
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    for g, w in zip(got.admission_arrays, want.admission_arrays):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got.admission_lists == want.admission_lists
    # A shared expansion gives the same schedule.
    shared = TF.build_ftl_schedule(trace, cfg,
                                   expansion=TF.expand_trace(trace, cfg))
    assert np.array_equal(shared.kind, got.kind)
    if workload == "prn":
        assert got.stats.gc_invocations > 0
    if gc_kw.get("pec_per_erase") == 300.0:
        assert got.wear_pec.max() >= 300.0


# -- prepass-GC SimStats ----------------------------------------------------


@pytest.mark.parametrize("scheduler", SCHEDULERS)
@pytest.mark.parametrize("engine", ENGINES)
def test_prepass_simulate_matches_reference(tables, engine, scheduler):
    from repro.flashsim import ssd as RS

    cfg, rcfg = _cfgs()
    hot, rhot = _hot()
    kw = dict(seed=1, engine=engine, scheduler=scheduler)
    ref = RS.simulate(rhot, _ref_cond(AGED), "pr2ar2", cfg=rcfg, **kw)
    got = TF.simulate(hot, TF.OperatingCondition(*AGED), "pr2ar2",
                      cfg=cfg, device="cpu", **kw)
    _same(got, ref)
    assert got.gc_invocations == got.blocks_erased > 0 and got.wa > 1.0
    assert got.engine_selected == ref.engine_selected
    assert (got.fast_path_events > 0) == (engine != "array")


def test_prepass_knob_matches_reference_on_the_default_geometry(tables):
    """``gc="prepass"`` on ``DEFAULT_SSD`` (16 pages a block), the
    golden cell's workload, sharded and not: 36 GC passes."""
    from repro.flashsim import ssd as RS

    kw = dict(seed=1, n_requests=1200, gc="prepass")
    ref = RS.simulate("prn", _ref_cond(AGED), "baseline", **kw)
    got = TF.simulate("prn", TF.OperatingCondition(*AGED), "baseline",
                      device="cpu", **kw)
    sharded = TF.simulate("prn", TF.OperatingCondition(*AGED), "baseline",
                          shard=True, device="cpu", **kw)
    _same(got, ref)
    _same(sharded, ref)
    assert got.gc_invocations == 36


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("engine", ENGINES)
def test_prepass_compare_matches_reference(tables, engine, fuse):
    from repro.flashsim import ssd as RS

    cfg, rcfg = _cfgs()
    hot, rhot = _hot()
    kw = dict(mechanisms=("baseline", "pr2", "sota+pr2ar2"), seed=0,
              engine=engine, fuse=fuse)
    ref = RS.compare_mechanisms(rhot, _ref_cond(AGED), cfg=rcfg, **kw)
    got = TF.compare_mechanisms(hot, TF.OperatingCondition(*AGED),
                                cfg=cfg, device="cpu", **kw)
    assert list(got) == list(ref)
    for m in ref:
        _same(got[m], ref[m])
        assert got[m].fused_cells == ref[m].fused_cells
    gc = {(s.wa, s.gc_invocations, s.gc_page_reads, s.blocks_erased)
          for s in got.values()}
    assert len(gc) == 1 and gc.pop()[1] > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_prepass_simulate_batch_matches_reference(tables, engine):
    """Two conditions at 300 P/E an erase: worn blocks sample the bins
    above each condition (365 d: 1500; 30 d: 500 and 1000) at their own
    safe scales."""
    from repro.flashsim import ssd as RS

    cfg, rcfg = _cfgs(pec_per_erase=300.0)
    hot, rhot = _hot()
    mechs = ("baseline", "sota+pr2ar2")
    kw = dict(mechanisms=mechs, seeds=(2,), engine=engine,
              scheduler="host_prio_aged:4")
    ref = RS.simulate_batch(rhot, [_ref_cond(AGED), _ref_cond(MODEST)],
                            cfg=rcfg, **kw)
    got = TF.simulate_batch(hot, [TF.OperatingCondition(*AGED),
                                  TF.OperatingCondition(*MODEST)],
                            cfg=cfg, device="cpu", **kw)
    assert len(got) == len(ref) == 4
    for (gk, gv), (rk, rv) in zip(got.items(), ref.items()):
        assert (gk[0], gk[1].retention_days, gk[1].pec, gk[2]) == \
            (rk[0], rk[1].retention_days, rk[1].pec, rk[2])
        _same(gv, rv)
    assert all(s.gc_invocations > 0 for s in got.values())


# -- the reference's behaviour tests (tests/test_ftl.py) ---------------------


GC_SSD = TF.SSDConfig(gc=TF.GCConfig(enabled=True))


class TestEngineWithGC:
    def test_gc_raises_read_tail_latency(self, tables):
        w = dataclasses.replace(TF.make_workloads()["prn"], n_requests=1500)
        cond = TF.OperatingCondition(*AGED)
        off = TF.simulate(w, cond, "baseline", seed=0, device="cpu")
        on = TF.simulate(w, cond, "baseline", seed=0, cfg=GC_SSD,
                         device="cpu")
        assert off.wa == 1.0 and off.gc_invocations == 0
        assert on.wa > 1.0
        assert on.gc_invocations > 0
        assert on.read_p99_us > off.read_p99_us
        assert on.mean_us > off.mean_us

    def test_gc_stats_shared_across_mechanisms(self, tables):
        w = dataclasses.replace(TF.make_workloads()["rsrch"],
                                n_requests=2000)
        stats = TF.compare_mechanisms(
            w, TF.OperatingCondition(*AGED), mechanisms=("baseline", "pr2ar2"),
            seed=0, cfg=GC_SSD, device="cpu")
        assert stats["baseline"].wa == stats["pr2ar2"].wa > 1.0
        assert (stats["baseline"].gc_invocations
                == stats["pr2ar2"].gc_invocations > 0)

    def test_reference_engine_rejects_gc(self, tables):
        w = dataclasses.replace(TF.make_workloads()["prn"], n_requests=200)
        with pytest.raises(NotImplementedError, match="FTL"):
            TF.simulate(w, TF.OperatingCondition(*AGED), "baseline", seed=0,
                        cfg=GC_SSD, engine="reference", device="cpu")

    def test_gc_run_deterministic(self, tables):
        w = dataclasses.replace(TF.make_workloads()["rsrch"],
                                n_requests=1000)
        cond = TF.OperatingCondition(*AGED)
        a = TF.simulate(w, cond, "pr2ar2", seed=5, cfg=GC_SSD, device="cpu")
        b = TF.simulate(w, cond, "pr2ar2", seed=5, cfg=GC_SSD, device="cpu")
        assert a == b

    def test_wear_increases_attempts(self, own_tables):
        """Per-block wear feeds attempt sampling: at 300 P/E an erase the
        rewritten blocks of 365 d / 1000 P/E sample the 1500 P/E bin of
        the port's own characterization (22 host reads of 3000 requests
        land on such blocks), and host reads take more attempts than with
        no wear."""
        w = dataclasses.replace(TF.make_workloads()["prn"], n_requests=3000)
        unworn = TF.SSDConfig(gc=TF.GCConfig(enabled=True,
                                             pec_per_erase=0.0))
        worn = TF.SSDConfig(gc=TF.GCConfig(enabled=True,
                                           pec_per_erase=300.0))
        cond = TF.OperatingCondition(*AGED)
        a = TF.simulate(w, cond, "baseline", seed=1, cfg=unworn, device="cpu")
        b = TF.simulate(w, cond, "baseline", seed=1, cfg=worn, device="cpu")
        assert b.mean_read_attempts > a.mean_read_attempts


# -- the port's own characterization, end to end ----------------------------


@pytest.fixture(scope="module")
def own_cache(tmp_path_factory):
    return tmp_path_factory.mktemp("own_characterization")


@pytest.fixture
def own_tables(own_cache, monkeypatch):
    """The port's own CPU characterization (disk-cached for the module),
    in place of the synthetic tables until the test ends."""
    monkeypatch.setenv("REPRO_CHAR_CACHE", "1")
    monkeypatch.setenv("REPRO_TORCH_CHAR_CACHE_DIR", str(own_cache))
    TC.clear_tables()
    with contextlib.ExitStack() as stack:
        stack.callback(TC.load_tables, *_synthetic_tables())
        stack.callback(TC.clear_tables)
        yield


def test_pinned_gc_cell_with_the_ports_own_characterization(own_tables):
    """The reference's pinned ``compare_gc_prepass`` cell: ``prn`` at
    1200 requests through the FTL pre-pass, 36 GC passes, 15 of whose
    copy-back reads sample the 1500 P/E bin.  The port characterizes
    365 d at 1000 and 1500 P/E itself (no page of that bin flips its
    first success against the reference: ROADMAP C5), on both engines.
    Every pinned field is equal except ``die_util`` and
    ``channel_util``, held to 4 ulps: the reference's own output at this
    commit differs from its pin there by 1-2 ulps (ROADMAP C4), and the
    port equals the reference's output."""
    w = dataclasses.replace(TF.make_workloads()["prn"], n_requests=1200)
    for engine in ("array", "batched"):
        grid = TF.compare_mechanisms(
            w, TF.OperatingCondition(*AGED), mechanisms=("baseline", "pr2ar2"),
            seed=1, gc="prepass", engine=engine, device="cpu")
        for mech, want in GOLDEN["compare_gc_prepass"].items():
            got = dataclasses.asdict(grid[mech])
            for field, v in want.items():
                if field in ("die_util", "channel_util"):
                    assert abs(got[field] - v) <= 4 * math.ulp(v)
                else:
                    assert got[field] == v, (engine, mech, field)
