"""The port's sweep runtime against the JAX reference's, on the CPU.

Both packages read the synthetic tables of ``tests/test_torch_flashsim.py``
(its ``tables`` fixture, which also carries the reference's batched
engine past ROADMAP C1).  The bar is the reference's own:
``sweep_to_json`` byte-identical — between worker counts, between a
journaled and an uninterrupted run, and between the port and the
reference.  The reference side runs inline (its spawned batched workers
would not see the patched tables) and with its array engine: its
``sweep_to_json`` is engine-invariant by its own contract, and its
batched engine costs seconds a grid on the CPU.

Pools here fork (CPU cells in a parent that has not touched CUDA); one
test forces a spawn pool to show that spawned workers read the
parent's ``load_tables`` tables, and one shows that a forced fork with
cells on CUDA is refused.
"""

import dataclasses
import json
import multiprocessing
import os
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.flashsim as TF
from repro_torch.flashsim import runtime as RT
from repro_torch.flashsim.workloads import (RequestTrace, TraceSource,
                                            clear_trace_cache)
from test_torch_flashsim import AGED, MODEST, N, one_thread, tables  # noqa: F401
from test_torch_ftl import _cfgs as _gc_cfgs, _hot

MECHS = ("baseline", "sota", "pr2", "ar2", "pr2ar2", "sota+pr2ar2")
SEEDS = (0, 1, 2)
PORT_CONDS = (TF.OperatingCondition(*AGED), TF.OperatingCondition(*MODEST))


def _ref_conds():
    from repro.flashsim.config import OperatingCondition

    return (OperatingCondition(*AGED), OperatingCondition(*MODEST))


def _require_pool():
    if "fork" not in multiprocessing.get_all_start_methods():
        pytest.skip("fork start method unavailable")
    if os.environ.get("REPRO_SWEEP_INLINE") == "1":
        pytest.skip("pool execution disabled (REPRO_SWEEP_INLINE=1)")


def _port_sweep(workers=1, engine="array", scheduler=None, mechs=MECHS,
                seeds=SEEDS, **kw):
    return TF.run_sweep("websearch", PORT_CONDS, mechs, seeds,
                        n_requests=N, engine=engine, scheduler=scheduler,
                        workers=workers, device="cpu", **kw)


@pytest.fixture(scope="module")
def ref_json(tables):
    """The reference's inline sweep of the grid (array engine), once a
    scheduler."""
    from repro.flashsim import runtime as RR

    blobs = {}

    def get(scheduler):
        if scheduler not in blobs:
            blobs[scheduler] = RR.sweep_to_json(RR.run_sweep(
                "websearch", _ref_conds(), MECHS, SEEDS, n_requests=N,
                engine="array", scheduler=scheduler))
        return blobs[scheduler]
    return get


@pytest.mark.parametrize("engine,scheduler,workers", [
    ("array", "fcfs", 1),
    ("array", "fcfs", 2),
    ("array", "host_prio_aged:4", 1),
    ("array", "host_prio_aged:4", 2),
    ("batched", "fcfs", 2),
    ("auto", "host_prio_aged:4", 2),
])
def test_sweep_matches_reference(ref_json, engine, scheduler, workers):
    """2 conditions x 6 mechanisms x 3 seeds at N 300: the port gives
    the reference's bytes.  The batched and auto engines run in the
    pool only: inline, a seed group is ``simulate_batch``, which
    ``tests/test_torch_flashsim.py`` holds against the reference, and
    the CPU's plain shard core costs seconds a grid."""
    if workers > 1:
        _require_pool()
    got = _port_sweep(workers, engine, scheduler)
    assert RT.sweep_to_json(got) == ref_json(scheduler)
    want_keys = [(m, c, s) for s in SEEDS for c in PORT_CONDS for m in MECHS]
    assert list(got) == want_keys
    if engine != "array":
        assert all(s.engine_selected == "batched" and s.fused_cells > 0
                   for s in got.values())


@pytest.fixture(scope="module")
def small(tables):
    """2 conditions x 2 mechanisms x 3 seeds (array engine) at workers
    1, 2 and 4."""
    _require_pool()
    return {wk: _port_sweep(wk, mechs=("baseline", "pr2ar2"))
            for wk in (1, 2, 4)}


def test_workers_1_2_4_byte_identical(small):
    blobs = {wk: RT.sweep_to_json(res) for wk, res in small.items()}
    assert blobs[1] == blobs[2] == blobs[4]
    assert len(json.loads(blobs[1])) == 2 * 2 * 3


def test_key_order_is_canonical(small):
    """seed -> condition -> mechanism, the inline sweep's insertion
    order, for every worker count."""
    want = [(m, c, s) for s in SEEDS for c in PORT_CONDS
            for m in ("baseline", "pr2ar2")]
    assert all(list(res) == want for res in small.values())


def test_inline_env_forces_no_pool(small, monkeypatch):
    monkeypatch.setenv("REPRO_SWEEP_INLINE", "1")
    forced = _port_sweep(4, mechs=("baseline", "pr2ar2"))
    assert RT.sweep_to_json(forced) == RT.sweep_to_json(small[1])


def test_sweep_cell_key_full_float_precision():
    c1 = TF.OperatingCondition(365.00001, 0.0)
    c2 = TF.OperatingCondition(365.00002, 0.0)
    assert RT.sweep_cell_key("baseline", c1, 0) != \
        RT.sweep_cell_key("baseline", c2, 0)
    keys = {RT.sweep_cell_key(m, c, s) for m in ("baseline", "pr2ar2")
            for c in PORT_CONDS + (TF.OperatingCondition(365.0, 0.0),)
            for s in (0, 1)}
    assert len(keys) == 12


def _simulate_cells(seeds, mechs=("baseline",), n=200, **kw):
    return [TF.Cell("simulate", "websearch", (PORT_CONDS[0],), (m,), s,
                    n_requests=n, device="cpu", **kw)
            for s in seeds for m in mechs]


def test_results_in_input_order(tables):
    _require_pool()
    cells = _simulate_cells((3, 1, 2))
    par = RT.run_cells(cells, workers=3)
    inline = RT.run_cells(cells, workers=1)
    assert par == inline
    # Distinct seeds give distinct stats, so positional equality above
    # proves ordering, not just content.
    assert len({s.mean_us for s in inline}) == 3


def test_chunked_submission(tables):
    _require_pool()
    cells = _simulate_cells(range(5), ("baseline", "pr2ar2"), n=120)
    chunks = RT._chunk_pending(dict(enumerate(cells)), workers=2)
    assert len(chunks) < len(cells)
    assert [i for ch in chunks for i, _ in ch] == list(range(len(cells)))
    blobs = [json.dumps([dataclasses.asdict(r)
                         for r in RT.run_cells(cells, workers=wk)],
                        sort_keys=True) for wk in (1, 3)]
    assert blobs[0] == blobs[1]


def test_cell_validation():
    with pytest.raises(ValueError, match="kind"):
        TF.Cell("fanout", "websearch", (PORT_CONDS[0],), ("baseline",), 0)
    with pytest.raises(ValueError, match="one mechanism"):
        TF.Cell("simulate", "websearch", (PORT_CONDS[0],),
                ("baseline", "pr2"), 0)
    with pytest.raises(ValueError, match="one condition"):
        TF.Cell("compare", "websearch", PORT_CONDS, ("baseline",), 0)
    # The device is stored by name (picklable, part of the journal key).
    cell = TF.Cell("batch", "websearch", PORT_CONDS, ("baseline",), 0,
                   device=torch.device("cpu"))
    assert cell.device == "cpu"
    assert TF.Cell("batch", "websearch", PORT_CONDS, ("baseline",),
                   0).device is None


def test_cell_errors_propagate(tables):
    bad = TF.Cell("simulate", "websearch", (PORT_CONDS[0],),
                  ("no-such-mechanism",), 0, n_requests=50, device="cpu")
    with pytest.raises(ValueError):
        RT.run_cells([bad], workers=1)
    _require_pool()
    with pytest.raises(ValueError):
        RT.run_cells([bad, bad], workers=2, prewarm=False)


def test_cell_on_the_card_raises_without_cuda(monkeypatch):
    """A card cell never runs on the CPU: without CUDA it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell = TF.Cell("simulate", "websearch", (PORT_CONDS[0],), ("baseline",),
                   0, n_requests=50)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RT.run_cells([cell], workers=1)


def _trace(seed: int, n: int) -> RequestTrace:
    rng = np.random.default_rng(seed)
    return RequestTrace(
        arrival_us=np.cumsum(rng.exponential(30.0, n)),
        is_read=rng.random(n) < 0.7,
        n_pages=np.ones(n, np.int64),
        start_page=rng.integers(0, 4096, n),
    )


@dataclasses.dataclass(frozen=True)
class KillOnceSource(TraceSource):
    """A trace source that SIGKILLs the first *worker* that builds it.

    The marker file makes the kill once-only and observable; the
    parent's pid keeps inline runs alive.
    """

    marker: str = ""
    parent_pid: int = 0
    n: int = 300
    transforms: tuple = ()

    def cache_key(self, seed: int) -> tuple:
        return ("kill-once", self.n, seed,
                tuple(t.key for t in self.transforms))

    def _build(self, seed: int) -> RequestTrace:
        if (self.marker and not os.path.exists(self.marker)
                and os.getpid() != self.parent_pid):
            Path(self.marker).touch()
            os.kill(os.getpid(), signal.SIGKILL)
        return _trace(seed, self.n)


def test_killed_worker_keeps_completed_results(tables, tmp_path):
    """SIGKILL one worker mid-sweep: finished chunks are harvested, only
    the unfinished cells run again, and the bytes equal workers=1."""
    _require_pool()
    marker = tmp_path / "killed"
    src = KillOnceSource(marker=str(marker), parent_pid=os.getpid())
    kw = dict(conditions=(PORT_CONDS[0],), mechanisms=("baseline", "pr2ar2"),
              seeds=(0, 1, 2, 3), n_requests=200, device="cpu")
    clear_trace_cache()
    parallel = TF.run_sweep(src, workers=2, **kw)
    assert marker.exists(), "no worker was killed: the test is vacuous"
    inline = TF.run_sweep(src, workers=1, **kw)
    assert RT.sweep_to_json(parallel) == RT.sweep_to_json(inline)


def test_stalled_pool_is_finished_inline(tables, tmp_path):
    """``cell_timeout`` bounds the wait for progress: a pool that makes
    none is abandoned and the cells complete inline."""
    _require_pool()
    src = KillOnceSource(marker=str(tmp_path / "killed"),
                         parent_pid=os.getpid(), n=100)
    clear_trace_cache()
    cells = [TF.Cell("simulate", src, (PORT_CONDS[0],), ("baseline",), s,
                     n_requests=50, device="cpu") for s in range(2)]
    results = RT.run_cells(cells, workers=2, cell_timeout=60.0,
                           max_retries=1)
    assert [r.n_requests for r in results] == [50, 50]
    assert results == RT.run_cells(cells, workers=1)


class TestJournal:
    KW = dict(mechanisms=("baseline", "pr2ar2"), seeds=(1, 2, 3),
              n_requests=150, device="cpu")

    def _sweep(self, **kw):
        return TF.simulate_batch("websearch", PORT_CONDS, **dict(self.KW,
                                                                 **kw))

    def test_full_journal_resumes(self, tables, tmp_path):
        jpath = tmp_path / "sweep.jsonl"
        fresh = RT.sweep_to_json(self._sweep())
        assert RT.sweep_to_json(self._sweep(journal=jpath)) == fresh
        assert len(jpath.read_text().splitlines()) == 1 + 3
        assert RT.sweep_to_json(self._sweep(journal=jpath)) == fresh

    def test_partial_journal_resumes(self, tables, tmp_path, monkeypatch):
        """Header plus the first record: only the two missing seed
        groups run again."""
        jpath = tmp_path / "sweep.jsonl"
        fresh = RT.sweep_to_json(self._sweep(journal=jpath))
        lines = jpath.read_text().splitlines()
        jpath.write_text("\n".join(lines[:2]) + "\n")
        ran = []
        run_cell = RT._run_cell
        monkeypatch.setattr(RT, "_run_cell",
                            lambda c: ran.append(c.seed) or run_cell(c))
        assert RT.sweep_to_json(self._sweep(journal=jpath)) == fresh
        assert ran == [2, 3]

    def test_torn_tail_is_ignored(self, tables, tmp_path):
        jpath = tmp_path / "sweep.jsonl"
        fresh = RT.sweep_to_json(self._sweep(journal=jpath))
        with open(jpath, "a") as f:
            f.write('{"i": 99, "r": {"t": "cells", "v"')
        assert RT.sweep_to_json(self._sweep(journal=jpath)) == fresh

    def test_journal_is_keyed_to_its_cell_list(self, tables, tmp_path):
        jpath = tmp_path / "sweep.jsonl"
        self._sweep(journal=jpath)
        fresh = RT.sweep_to_json(self._sweep(seeds=(7, 8)))
        assert RT.sweep_to_json(self._sweep(seeds=(7, 8),
                                            journal=jpath)) == fresh
        assert len(jpath.read_text().splitlines()) == 1 + 2

    def test_journal_with_workers(self, tables, tmp_path):
        _require_pool()
        jpath = tmp_path / "sweep.jsonl"
        fresh = RT.sweep_to_json(self._sweep())
        assert RT.sweep_to_json(self._sweep(journal=jpath,
                                            workers=2)) == fresh
        assert len(jpath.read_text().splitlines()) == 1 + 3


def test_cross_cell_fusion_matches_reference(tables):
    """Simulate cells of one trace fuse across cells; on the CPU the
    chunking rule is the reference's, so ``fused_cells`` is too."""
    from repro.flashsim import runtime as RR

    mechs = ("pr2", "pr2ar2", "pr2ar2", "sota+pr2ar2")
    cells = _simulate_cells((5,), mechs, engine="batched")
    ref_cells = [RR.Cell("simulate", "websearch", (_ref_conds()[0],), (m,),
                         5, n_requests=200, engine="batched")
                 for m in mechs]
    got = RT.run_cells(cells, workers=1)
    want = RR.run_cells(ref_cells, workers=1)
    assert [RT._stats_payload(s) for s in got] == \
        [RR._stats_payload(s) for s in want]
    assert [s.fused_cells for s in got] == [s.fused_cells for s in want]
    assert max(s.fused_cells for s in got) > 1
    unfused = RT.run_cells([dataclasses.replace(c, fuse=False)
                            for c in cells], workers=1)
    assert unfused == got
    assert all(s.fused_cells == 0 for s in unfused)


def test_spawned_workers_read_the_parents_tables(tables, monkeypatch):
    """A spawned worker starts with empty memos: the pool's initializer
    hands it the parent's tables (here ``load_tables``' synthetic ones;
    a worker that characterized would give other stats)."""
    _require_pool()
    monkeypatch.setenv("REPRO_SWEEP_START_METHOD", "spawn")
    assert RT._mp_context().get_start_method() == "spawn"
    cells = _simulate_cells((0,), ("baseline", "pr2ar2"))
    assert RT.run_cells(cells, workers=2) == RT.run_cells(cells, workers=1)


def test_mp_context_picks_spawn_for_the_card(monkeypatch):
    cpu = _simulate_cells((0,))
    card = [dataclasses.replace(c, device="cuda") for c in cpu]
    monkeypatch.delenv("REPRO_SWEEP_START_METHOD", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    if "fork" in multiprocessing.get_all_start_methods():
        assert RT._mp_context(cpu).get_start_method() == "fork"
    assert RT._mp_context(card).get_start_method() == "spawn"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert RT._mp_context(cpu).get_start_method() == "spawn"
    monkeypatch.setenv("REPRO_SWEEP_START_METHOD", "fork")
    with pytest.raises(ValueError, match="forked worker cannot use CUDA"):
        RT._mp_context(card)


#: (kind, engine, scheduler, fuse) of each cell of a case.
SIG_CASES = {
    "auto-ineligible": [("batch", "auto", "tokens", None)],
    "array": [("batch", "array", None, None)],
    "batched": [("batch", "batched", None, None)],
    "batched-unfused": [("batch", "batched", None, False)],
    "aged": [("batch", "batched", "host_prio_aged:4", None)],
    "compare": [("compare", "auto", None, None)],
    "simulate-x3": [("simulate", "batched", None, None)] * 3,
}


@pytest.mark.parametrize("case", list(SIG_CASES))
def test_batched_sigs_match_reference(tables, case):
    """The signature count ``prewarm_batched`` reports is the
    reference's; CPU cells warm nothing."""
    from repro.flashsim import runtime as RR

    port, ref = [], []
    for kind, engine, scheduler, fuse in SIG_CASES[case]:
        n_conds = 2 if kind == "batch" else 1
        mechs = ("pr2ar2",) if kind == "simulate" else MECHS
        kw = dict(n_requests=200, engine=engine, scheduler=scheduler,
                  fuse=fuse)
        port.append(TF.Cell(kind, "websearch", PORT_CONDS[:n_conds], mechs,
                            0, device="cpu", **kw))
        ref.append(RR.Cell(kind, "websearch", _ref_conds()[:n_conds], mechs,
                           0, **kw))
    assert RT._batched_sigs(port) == RR._batched_sigs(ref)
    assert RT.prewarm_batched(port) == len(RR._batched_sigs(ref))


@pytest.mark.parametrize("engine", ["array", "batched"])
def test_compare_workers_match_inline_and_reference(tables, engine):
    """``compare_mechanisms(workers=2)`` forks one worker a mechanism
    (unfused, so the batched one runs in the workers too); the
    reference inline, on its array engine as above."""
    _require_pool()
    from repro.flashsim import ssd as RS

    kw = dict(mechanisms=("baseline", "pr2ar2"), seed=2, n_requests=N)
    inline = TF.compare_mechanisms("websearch", PORT_CONDS[0], engine=engine,
                                   fuse=False, device="cpu", **kw)
    pooled = TF.compare_mechanisms("websearch", PORT_CONDS[0], engine=engine,
                                   fuse=False, workers=2, device="cpu", **kw)
    ref = RS.compare_mechanisms("websearch", _ref_conds()[0], **kw)
    assert pooled == inline
    assert list(pooled) == list(ref)
    assert [RT._stats_payload(s) for s in pooled.values()] == \
        [RT._stats_payload(s) for s in ref.values()]


def test_reference_engine_workers_match_inline(tables):
    """Seed groups fan out for the reference engine too."""
    _require_pool()
    kw = dict(mechanisms=("baseline",), seeds=(0, 1), n_requests=150,
              engine="reference", device="cpu")
    a = TF.simulate_batch("websearch", PORT_CONDS[:1], **kw)
    b = TF.simulate_batch("websearch", PORT_CONDS[:1], workers=2, **kw)
    assert a == b
    assert list(a) == list(b)


def test_host_fingerprint_fields():
    fp = RT.host_fingerprint()
    assert set(fp) == {"cpu_model", "cpu_count", "platform", "python",
                       "numpy"}
    assert fp["cpu_count"] >= 1


# -- prepass GC through the runtime ------------------------------------------


@pytest.fixture(scope="module")
def gc_ref_json(tables):
    """The reference's inline prepass sweep: 2 conditions x 2 mechanisms
    x 2 seeds of ``prn`` on its hot span (array engine)."""
    from repro.flashsim import runtime as RR

    _, rcfg = _gc_cfgs()
    return RR.sweep_to_json(RR.run_sweep(
        _hot()[1], _ref_conds(), ("baseline", "pr2ar2"), (0, 1), cfg=rcfg,
        engine="array"))


@pytest.mark.parametrize("engine,workers", [("array", 1), ("batched", 2)])
def test_prepass_sweep_matches_reference(gc_ref_json, engine, workers):
    """Each seed group shares one FTL schedule across its cells; the
    bytes are the reference's at workers 1 and 2 (a fork pool, whose
    parent warms the worn bins above each condition first)."""
    if workers > 1:
        _require_pool()
    cfg, _ = _gc_cfgs()
    got = TF.run_sweep(_hot()[0], PORT_CONDS, ("baseline", "pr2ar2"), (0, 1),
                       cfg=cfg, engine=engine, workers=workers, device="cpu")
    assert RT.sweep_to_json(got) == gc_ref_json
    assert all(s.gc_invocations > 0 for s in got.values())
    if engine == "batched":
        assert all(s.fused_cells > 0 for s in got.values())


def test_prepass_cross_cell_fusion_matches_reference(tables):
    """Simulate cells of one trace share its FTL schedule and fuse across
    cells, with the reference's ``fused_cells``."""
    from repro.flashsim import runtime as RR

    cfg, rcfg = _gc_cfgs()
    hot, rhot = _hot()
    mechs = ("pr2", "pr2ar2", "sota+pr2ar2")
    cells = [TF.Cell("simulate", hot, (PORT_CONDS[0],), (m,), 5, cfg=cfg,
                     engine="batched", device="cpu") for m in mechs]
    ref_cells = [RR.Cell("simulate", rhot, (_ref_conds()[0],), (m,), 5,
                         cfg=rcfg, engine="batched") for m in mechs]
    got = RT.run_cells(cells, workers=1)
    want = RR.run_cells(ref_cells, workers=1)
    assert [RT._stats_payload(s) for s in got] == \
        [RR._stats_payload(s) for s in want]
    assert [s.fused_cells for s in got] == [s.fused_cells for s in want]
    assert max(s.fused_cells for s in got) > 1
    assert all(s.gc_invocations > 0 for s in got)


def test_prewarm_warms_the_worn_bins(tables):
    """A prepass cell warms, beside its condition's tables, exactly the
    bins its worn blocks' reads snap up to (read from the reference's
    FTL schedule of the same trace), at each mechanism's scale; the
    count is still the reference's (condition, mechanism) pairs."""
    from repro.core.characterize import snap_pec
    from repro.flashsim import ftl as RFTL
    from repro.flashsim import runtime as RR
    from repro.flashsim.ssd import resolve_trace
    from repro_torch.core import characterize as TC

    cfg, rcfg = _gc_cfgs(pec_per_erase=300.0)
    hot, rhot = _hot()
    mechs = ("baseline", "pr2ar2")
    cell = TF.Cell("batch", hot, PORT_CONDS, mechs, 0, cfg=cfg,
                   device="cpu")
    sched = RFTL.build_ftl_schedule(resolve_trace(rhot, seed=0), rcfg)
    wear = sched.wear_pec[(sched.kind <= RFTL.OP_GC_READ)
                          & (sched.wear_pec > 0.0)]
    want = {c: tuple(sorted({snap_pec(rc.with_wear(float(w)).pec)
                             for w in wear}))
            for c, rc in zip(PORT_CONDS, _ref_conds())}
    got = RT._worn_bins(cell)
    assert got == want
    assert got[PORT_CONDS[0]] == (1500.0,)
    assert len(got[PORT_CONDS[1]]) >= 2
    off = dataclasses.replace(cell, gc="off")
    assert RT._worn_bins(off) == {c: () for c in PORT_CONDS}
    TC._CDF_MEMO.clear()
    n = RT.prewarm_characterization([cell])
    assert n == RR.prewarm_characterization(
        [RR.Cell("batch", rhot, _ref_conds(), mechs, 0, cfg=rcfg)]) == 4
    warm = {(k[0], k[1], k[3], k[4]) for k in TC._CDF_MEMO}
    for cond, bins in got.items():
        for pec in (1000.0, 1500.0) if cond.pec == 1000.0 else \
                (500.0, 1000.0, 1500.0):
            safe = TC.characterize_condition(
                cond.retention_days, pec, device="cpu").safe_tr_scale
            for scale in (1.0, safe):                  # baseline, pr2ar2
                key = (cond.retention_days, pec, False, scale)
                assert (key in warm) == (pec in bins or pec == cond.pec)


def test_spawned_workers_read_the_worn_bins(tables, monkeypatch):
    """Spawned workers get the worn bins' ``load_tables`` tables too (a
    worker that characterized 365 d / 1500 P/E itself would give other
    stats)."""
    _require_pool()
    monkeypatch.setenv("REPRO_SWEEP_START_METHOD", "spawn")
    cfg, _ = _gc_cfgs(pec_per_erase=300.0)
    cells = [TF.Cell("simulate", _hot()[0], (PORT_CONDS[0],), (m,), 0,
                     cfg=cfg, device="cpu")
             for m in ("baseline", "pr2ar2")]
    inline = RT.run_cells(cells, workers=1)
    assert RT.run_cells(cells, workers=2) == inline
    assert all(s.gc_invocations > 0 for s in inline)


def test_prepass_compare_workers_match_inline_and_reference(tables):
    """``compare_mechanisms(workers=2)`` hands the forked workers the one
    FTL schedule it built (its list views materialized first)."""
    _require_pool()
    from repro.flashsim import ssd as RS

    cfg, rcfg = _gc_cfgs(pec_per_erase=300.0)
    hot, rhot = _hot()
    kw = dict(mechanisms=("baseline", "pr2ar2"), seed=1)
    inline = TF.compare_mechanisms(hot, PORT_CONDS[1], cfg=cfg, device="cpu",
                                   **kw)
    pooled = TF.compare_mechanisms(hot, PORT_CONDS[1], cfg=cfg, workers=2,
                                   device="cpu", **kw)
    ref = RS.compare_mechanisms(rhot, _ref_conds()[1], cfg=rcfg, **kw)
    assert pooled == inline
    assert [RT._stats_payload(s) for s in pooled.values()] == \
        [RT._stats_payload(s) for s in ref.values()]
    assert all(s.gc_invocations > 0 for s in pooled.values())


# -- the closed loop through the runtime -------------------------------------


#: The closed-loop fields of SimStats, zero on open-loop runs.
CLOSED_FIELDS = (
    "hostq_wait_mean_us", "hostq_wait_p99_us", "device_mean_us",
    "read_device_p99_us", "throughput_iops", "max_inflight",
    "cache_hit_reads", "cache_hit_pages", "cache_absorbed_writes",
    "cache_flush_pages", "cache_stalled_writes", "die_sense_util",
)
CL_CACHE = dict(capacity_pages=64)


def _closed_kw(port=True, **kw):
    """A closed-loop prepass sweep of ``prn`` on its hot span, with a
    64-page host cache, in the port or the reference."""
    cfg, rcfg = _gc_cfgs()
    hot, rhot = _hot()
    if port:
        return dict(workload=hot, conditions=PORT_CONDS, cfg=cfg,
                    mechanisms=("baseline", "pr2ar2"), seeds=(0, 1),
                    ncq_depth=8, host_cache=TF.HostCacheConfig(**CL_CACHE),
                    device="cpu", **kw)
    from repro.flashsim.config import HostCacheConfig

    return dict(workload=rhot, conditions=_ref_conds(), cfg=rcfg,
                mechanisms=("baseline", "pr2ar2"), seeds=(0, 1),
                ncq_depth=8, host_cache=HostCacheConfig(**CL_CACHE), **kw)


@pytest.fixture(scope="module")
def closed_ref_json(tables):
    from repro.flashsim import runtime as RR

    return RR.sweep_to_json(RR.run_sweep(**_closed_kw(port=False)))


@pytest.mark.parametrize("engine,workers", [("array", 1), ("array", 2),
                                            ("auto", 2)])
def test_closed_loop_sweep_matches_reference(closed_ref_json, engine,
                                             workers):
    """GC, the write cache and the NCQ through seed groups: the bytes
    are the reference's at workers 1 and 2, and ``auto`` never fuses a
    closed cell into a shard-core launch."""
    if workers > 1:
        _require_pool()
    got = TF.run_sweep(**_closed_kw(engine=engine, workers=workers))
    assert RT.sweep_to_json(got) == closed_ref_json
    for s in got.values():
        assert s.gc_invocations > 0 and s.cache_absorbed_writes > 0
        assert 1 <= s.max_inflight <= 8
        assert s.engine_selected == "array" and s.fused_cells == 0
        assert ("open-loop only" in s.engine_fallback_reason) == \
            (engine == "auto")


def test_closed_simulate_cells_are_never_fused(tables):
    """Fusable-looking ``simulate`` cells with ``ncq_depth`` run one by
    one on the array interpreter, as the reference runs them."""
    from repro.flashsim import runtime as RR

    mechs = ("pr2", "pr2ar2", "sota+pr2ar2")
    cells = [TF.Cell("simulate", "websearch", (PORT_CONDS[0],), (m,), 5,
                     n_requests=200, engine="auto", fuse=True, ncq_depth=16,
                     device="cpu") for m in mechs]
    ref_cells = [RR.Cell("simulate", "websearch", (_ref_conds()[0],), (m,),
                         5, n_requests=200, engine="auto", fuse=True,
                         ncq_depth=16) for m in mechs]
    got = RT.run_cells(cells, workers=1)
    want = RR.run_cells(ref_cells, workers=1)
    assert [RT._stats_payload(s) for s in got] == \
        [RR._stats_payload(s) for s in want]
    assert all(s.fused_cells == 0 and s.engine_selected == "array"
               and s.max_inflight >= 1 for s in got)


def test_prewarm_covers_closed_prepass_cells(tables):
    """A closed prepass cell reads the same worn bins as its open-loop
    twin (the closed loop runs the same FTL schedule), and the prewarm
    count is the reference's."""
    from repro.flashsim import runtime as RR

    cfg, rcfg = _gc_cfgs(pec_per_erase=300.0)
    hot, rhot = _hot()
    kw = dict(ncq_depth=4, host_cache=TF.HostCacheConfig(**CL_CACHE))
    closed = TF.Cell("batch", hot, PORT_CONDS, ("baseline", "pr2ar2"), 0,
                     cfg=cfg, device="cpu", **kw)
    open_ = dataclasses.replace(closed, ncq_depth=None, host_cache=None)
    bins = RT._worn_bins(closed)
    assert bins == RT._worn_bins(open_)
    assert bins[PORT_CONDS[0]] == (1500.0,)
    from repro.flashsim.config import HostCacheConfig

    ref = RR.Cell("batch", rhot, _ref_conds(), ("baseline", "pr2ar2"), 0,
                  cfg=rcfg, ncq_depth=4,
                  host_cache=HostCacheConfig(**CL_CACHE))
    assert RT.prewarm_characterization([closed]) == \
        RR.prewarm_characterization([ref]) == 4


def test_closed_loop_journal_resume_round_trips(tables, tmp_path):
    j = tmp_path / "sweep.jsonl"
    kw = _closed_kw(journal=j)
    first = TF.run_sweep(**kw)
    resumed = TF.run_sweep(**kw)            # replayed entirely
    assert RT.sweep_to_json(first) == RT.sweep_to_json(resumed)
    lines = j.read_text().splitlines()
    j.write_text("\n".join(lines[:2]) + "\n")   # header + first seed group
    partial = TF.run_sweep(**kw)
    assert RT.sweep_to_json(partial) == RT.sweep_to_json(first)
    assert all(s.cache_flush_pages > 0 for s in partial.values())


def test_journal_decode_tolerates_old_schema(tables):
    """A journal written before the closed-loop fields existed still
    decodes (missing keys take their zero defaults)."""
    full = dataclasses.asdict(TF.simulate(
        "websearch", PORT_CONDS[0], "pr2ar2", n_requests=100, ncq_depth=8,
        device="cpu"))
    assert full["max_inflight"] > 0
    old = {k: v for k, v in full.items() if k not in CLOSED_FIELDS}
    stats = RT._stats_from_journal(old)
    assert isinstance(stats, TF.SimStats)
    assert stats.max_inflight == 0 and stats.throughput_iops == 0.0
    assert stats.mean_us == full["mean_us"]
    assert RT._stats_from_journal(full) == TF.SimStats(**full)


def test_journal_decode_tolerates_future_schema(tables):
    """...and one written by a later build drops the keys it does not
    know."""
    full = dataclasses.asdict(TF.simulate(
        "websearch", PORT_CONDS[0], "pr2ar2", n_requests=100, device="cpu"))
    full["some_future_counter"] = 7
    stats = RT._stats_from_journal(full)
    assert stats.mean_us == full["mean_us"]
    assert not hasattr(stats, "some_future_counter")


# -- online GC and faults through the runtime --------------------------------


def _online_kw(port=True, **kw):
    """``prn`` on its hot span under online GC, with the golden matrix's
    ``fc`` faults: 2 conditions x 2 mechanisms x 2 seeds."""
    fkw = dict(uncorrectable_prob=0.02, mispredict_scale=4.0,
               escalation_attempts=2)
    cfg, rcfg = _gc_cfgs(pec_per_erase=300.0)
    hot, rhot = _hot()
    if port:
        return dict(workload=hot, conditions=PORT_CONDS, cfg=cfg,
                    mechanisms=("baseline", "pr2ar2"), seeds=(0, 1),
                    gc="online", faults=TF.FaultConfig(**fkw), device="cpu",
                    **kw)
    from repro.flashsim.config import FaultConfig

    return dict(workload=rhot, conditions=_ref_conds(), cfg=rcfg,
                mechanisms=("baseline", "pr2ar2"), seeds=(0, 1),
                gc="online", faults=FaultConfig(**fkw), **kw)


@pytest.fixture(scope="module")
def online_ref_json(tables):
    from repro.flashsim import runtime as RR

    return RR.sweep_to_json(RR.run_sweep(**_online_kw(port=False)))


@pytest.mark.parametrize("engine,workers", [("array", 1), ("array", 2),
                                            ("auto", 2)])
def test_online_fault_sweep_matches_reference(online_ref_json, engine,
                                              workers):
    """Online GC with faults through seed groups: the bytes are the
    reference's at workers 1 and 2 (the parent warms every bin above
    each condition, since online wear is known only at run time), and
    ``auto`` records why it never fuses such a cell."""
    if workers > 1:
        _require_pool()
    got = TF.run_sweep(**_online_kw(engine=engine, workers=workers))
    assert RT.sweep_to_json(got) == online_ref_json
    for s in got.values():
        assert s.gc_invocations > 0 and s.write_stalls > 0
        assert s.engine_selected == "array" and s.fused_cells == 0
        assert ("online GC" in s.engine_fallback_reason) == \
            (engine == "auto")
    assert any(s.mispredicted_reads > 0 for s in got.values())


def test_online_fault_sweep_in_spawned_workers(tables, monkeypatch):
    """Spawned workers read the parent's tables for every bin above the
    condition (a worker that characterized one itself would give other
    stats than the synthetic tables')."""
    _require_pool()
    monkeypatch.setenv("REPRO_SWEEP_START_METHOD", "spawn")
    kw = _online_kw(workers=1)
    inline = TF.run_sweep(**kw)
    spawned = TF.run_sweep(**dict(kw, workers=2))
    assert RT.sweep_to_json(spawned) == RT.sweep_to_json(inline)


def test_prewarm_warms_every_bin_above_an_online_condition(tables):
    """Online GC: every grid P/E count above the condition's, each at
    every mechanism's scale, and the fault model's condition records."""
    from repro_torch.core import characterize as TC

    cell = TF.Cell("batch", _hot()[0], PORT_CONDS, ("baseline", "pr2ar2"),
                   0, cfg=_gc_cfgs()[0], gc="online",
                   faults=TF.FaultConfig(), device="cpu")
    bins = RT._worn_bins(cell)
    assert bins == {PORT_CONDS[0]: (1500.0,),
                    PORT_CONDS[1]: (500.0, 1000.0, 1500.0)}
    TC._CDF_MEMO.clear()
    assert RT.prewarm_characterization([cell]) == 4
    warm = {(k[0], k[1], k[3], k[4]) for k in TC._CDF_MEMO}
    for cond, pecs in bins.items():
        for pec in pecs:
            safe = TC.characterize_condition(
                cond.retention_days, pec, device="cpu").safe_tr_scale
            assert {(cond.retention_days, pec, False, s)
                    for s in (1.0, safe)} <= warm
    assert RT._worn_bins(dataclasses.replace(
        cell, cfg=_gc_cfgs(pec_per_erase=0.0)[0])) == {
            c: () for c in PORT_CONDS}


def test_online_fault_journal_resume_round_trips(tables, tmp_path):
    j = tmp_path / "sweep.jsonl"
    kw = _online_kw(journal=j)
    first = TF.run_sweep(**kw)
    lines = j.read_text().splitlines()
    j.write_text("\n".join(lines[:2]) + "\n")   # header + first seed group
    partial = TF.run_sweep(**kw)
    assert RT.sweep_to_json(partial) == RT.sweep_to_json(first)
    assert all(s.write_stalls > 0 for s in partial.values())


def test_fault_sweep_matches_reference_in_place(ref_json, tables):
    """Faults on the in-place grid of this module (``websearch``, six
    mechanisms, two conditions, three seeds), at workers 2: AR²'s
    mispredictions move the bytes off the fault-free reference's, onto
    the faulty reference's."""
    _require_pool()
    from repro.flashsim import runtime as RR
    from repro.flashsim.config import FaultConfig

    got = _port_sweep(workers=2, faults=TF.FaultConfig())
    want = RR.sweep_to_json(RR.run_sweep(
        "websearch", _ref_conds(), MECHS, SEEDS, n_requests=N,
        engine="array", faults=FaultConfig()))
    assert RT.sweep_to_json(got) == want != ref_json("fcfs")
    assert all(s.mispredicted_reads == 0 for (m, _, _), s in got.items()
               if "ar2" not in m)
