"""Port's SSD simulator against the JAX reference, given the same tables.

Both simulators read one characterization: seeded synthetic attempt
histograms and AR² safe scales, handed to the port through
``repro_torch.core.characterize.load_tables`` and to the reference by
patching its ``characterize_condition`` / ``attempt_cdf`` for the
duration of this module.  With equal tables and equal traces, every
compared ``SimStats`` field must be equal — for ``simulate``,
``compare_mechanisms`` (fused and not) and a two-condition
``simulate_batch``, on the array, batched and auto engines, under the
fcfs, host_prio and host_prio_aged:4 schedulers.  The reference runs the
same engine as the port; its batched engine needs ``enable_x64`` in
``jax.experimental``, which the module fixture supplies and takes back.

The port's own characterization is held end to end by the pinned
``compare_mechanisms`` cell of ``tests/data/golden_workloads.json``.
"""

import dataclasses
import hashlib
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.flashsim as TF
from repro_torch.core import characterize as TC

DATA = Path(__file__).parent / "data"
GOLDEN = json.loads((DATA / "golden_workloads.json").read_text())
AGED = (365.0, 1000.0)
MODEST = (30.0, 0.0)
SAFE = {AGED: 0.75, MODEST: 0.8}
#: The P/E bins a GC-worn block of AGED or MODEST snaps up to, each at
#: its own safe scale and with a wider attempt span than its condition:
#: (365, 1500) and (30, 500) are what prepass GC reaches at one P/E a
#: erase; 300 a erase takes MODEST's blocks to (30, 1000) and (30, 1500).
WORN = {(365.0, 1500.0): (0.7, 22), (30.0, 500.0): (0.78, 7),
        (30.0, 1000.0): (0.76, 9), (30.0, 1500.0): (0.72, 12)}
N = 300
_REF_PREFIXES = ("repro.kernels.fcfs_core", "repro.flashsim.engine_batched")


def _synthetic_tables():
    """Seeded attempt histograms + safe scales for AGED and MODEST, and
    for the worn bins of :data:`WORN` (keyed as the simulators' worn-block
    lookups ask for them: the bin's P/E count, at scale 1 and at the
    bin's own safe scale)."""
    stats, hists = {}, {}
    conds = [(AGED, 18, SAFE[AGED], 2024), (MODEST, 5, SAFE[MODEST], None)]
    conds += [(c, span, safe, 2025 if i == 0 else None)
              for i, (c, (safe, span)) in enumerate(WORN.items())]
    for cond, span, safe, seed in conds:
        if seed is not None:
            rng = np.random.default_rng(seed)
        stats[cond] = dict(
            retention_days=cond[0], pec=cond[1], mean_retry_steps=1.0,
            p99_retry_steps=2.0, frac_reads_with_retry=0.5,
            mean_margin_final=0.4, p01_margin_final=0.1,
            safe_tr_scale=safe)
        for pt in ("lsb", "csb", "msb"):
            for sota in (False, True):
                for scale in (1.0, safe):
                    h = np.zeros(42)
                    lo = 1 if sota else 1 + span // 3
                    h[lo:lo + span] = rng.dirichlet(np.ones(span))
                    hists[(cond[0], cond[1], pt, sota, scale)] = h
    return stats, hists


@pytest.fixture(scope="module")
def tables():
    """Both packages read the synthetic tables; restored afterwards."""
    import jax
    import jax.experimental

    from repro.core import characterize as RC

    stats, hists = _synthetic_tables()

    def ref_condition(retention_days, pec, *args, **kw):
        return RC.ConditionStats(**stats[(float(retention_days),
                                          float(pec))])

    def ref_cdf(retention_days, pec, page_type="csb", sota=False,
                tr_scale=1.0, *args, **kw):
        cdf = np.cumsum(hists[(float(retention_days), float(pec),
                               page_type, bool(sota), float(tr_scale))])
        cdf.setflags(write=False)
        return cdf

    before = set(sys.modules)
    TC.clear_tables()
    TC.load_tables(stats, hists)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RC, "characterize_condition", ref_condition)
        mp.setattr(RC, "attempt_cdf", ref_cdf)
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                   raising=False)
        mp.setenv("REPRO_CHAR_CACHE", "0")
        yield
    TC.clear_tables()
    for name in set(sys.modules) - before:
        if name.startswith(_REF_PREFIXES):
            del sys.modules[name]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and a 160-chip characterization on every core of each would
    oversubscribe the host.  (No result depends on the thread count.)"""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _outcome(s):
    """The compared fields of a SimStats (either package's)."""
    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
            if f.compare}


def _same(port, ref):
    assert _outcome(port) == _outcome(ref)


def _ref_cond(cond):
    from repro.flashsim.config import OperatingCondition

    return OperatingCondition(*cond)


ENGINES = ["array", "batched", "auto"]
SCHEDULERS = ["fcfs", "host_prio", "host_prio_aged:4"]


@pytest.mark.parametrize("scheduler", SCHEDULERS)
@pytest.mark.parametrize("engine", ENGINES)
def test_simulate_matches_reference(tables, engine, scheduler):
    from repro.flashsim import ssd as RS

    kw = dict(seed=1, n_requests=N, engine=engine, scheduler=scheduler)
    ref = RS.simulate("websearch", _ref_cond(AGED), "pr2ar2", **kw)
    got = TF.simulate("websearch", TF.OperatingCondition(*AGED), "pr2ar2",
                      device="cpu", **kw)
    _same(got, ref)
    assert got.engine_selected == ref.engine_selected
    assert (got.fast_path_events > 0) == (engine != "array")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dies", [24, 32, 64])
def test_wide_channels_match_reference(tables, dies, engine):
    """Wide channels (ROADMAP C8's cells): 24 and 32 dies take the
    kernel's 32-slot instance, 64 its 64-slot one.  The batched and auto
    engines run each cell like the reference's, with no fallback, here
    on the plain core and on the card on the kernel."""
    from repro.flashsim import config as RCFG
    from repro.flashsim import ssd as RS

    kw = dict(n_requests=200, engine=engine)
    ref = RS.simulate("websearch", _ref_cond(AGED), "pr2ar2",
                      cfg=dataclasses.replace(RCFG.DEFAULT_SSD,
                                              dies_per_channel=dies), **kw)
    got = TF.simulate("websearch", TF.OperatingCondition(*AGED), "pr2ar2",
                      cfg=dataclasses.replace(TF.DEFAULT_SSD,
                                              dies_per_channel=dies),
                      device="cpu", **kw)
    _same(got, ref)
    assert got.engine_selected == ref.engine_selected
    assert got.engine_selected == ("array" if engine == "array"
                                   else "batched")
    assert got.engine_fallback_reason == ref.engine_fallback_reason == ""
    assert (got.fast_path_events > 0) == (engine != "array")


@pytest.mark.parametrize("scheduler", ["preempt", "tokens"])
@pytest.mark.parametrize("engine", ["array", "auto"])
def test_interpreter_only_schedulers_match_reference(tables, engine,
                                                      scheduler):
    """Schedulers without a ring lowering run on the array interpreter;
    ``auto`` falls back to it and records the same reason."""
    from repro.flashsim import ssd as RS

    kw = dict(seed=4, n_requests=N, engine=engine, scheduler=scheduler)
    ref = RS.simulate("websearch", _ref_cond(AGED), "pr2", **kw)
    got = TF.simulate("websearch", TF.OperatingCondition(*AGED), "pr2",
                      device="cpu", **kw)
    _same(got, ref)
    assert got.engine_selected == ref.engine_selected == "array"
    assert got.engine_fallback_reason == ref.engine_fallback_reason


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("engine", ENGINES)
def test_compare_mechanisms_matches_reference(tables, engine, fuse):
    from repro.flashsim import ssd as RS

    kw = dict(mechanisms=("baseline", "pr2", "sota+pr2ar2"), seed=2,
              n_requests=N, engine=engine, fuse=fuse)
    ref = RS.compare_mechanisms("websearch", _ref_cond(AGED), **kw)
    got = TF.compare_mechanisms("websearch", TF.OperatingCondition(*AGED),
                                device="cpu", **kw)
    assert list(got) == list(ref)
    for m in ref:
        _same(got[m], ref[m])
        assert got[m].fused_cells == ref[m].fused_cells


@pytest.mark.parametrize("engine", ENGINES)
def test_simulate_batch_matches_reference(tables, engine):
    from repro.flashsim import ssd as RS

    mechs = ("baseline", "sota+pr2ar2")
    kw = dict(mechanisms=mechs, seeds=(0,), n_requests=N, engine=engine,
              scheduler="host_prio_aged:4")
    ref = RS.simulate_batch("websearch",
                            [_ref_cond(AGED), _ref_cond(MODEST)], **kw)
    got = TF.simulate_batch("websearch", [TF.OperatingCondition(*AGED),
                                     TF.OperatingCondition(*MODEST)],
                            device="cpu", **kw)
    assert len(got) == len(ref) == 4
    for (gk, gv), (rk, rv) in zip(got.items(), ref.items()):
        assert (gk[0], gk[1].retention_days, gk[1].pec, gk[2]) == \
            (rk[0], rk[1].retention_days, rk[1].pec, rk[2])
        _same(gv, rv)


def _trace_sha(t) -> str:
    h = hashlib.sha256()
    for a in (t.arrival_us, t.is_read, t.n_pages, t.start_page):
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("w", TF.PROFILES + TF.GC_PROFILES,
                         ids=lambda w: w.name)
def test_trace_checksums_match_golden(w):
    for seed in range(5):
        got = _trace_sha(TF.generate_trace(w, seed=seed))
        assert got == GOLDEN["trace_sha"][f"{w.name}:{seed}"]


def test_pinned_cell_with_the_ports_own_characterization(monkeypatch,
                                                         tmp_path):
    """The slice end to end on the CPU: the port characterizes 365 d /
    1000 P/E itself (160 chips) and reproduces the reference's pinned
    ``compare_mechanisms`` cell on both engines.  Every pinned field is
    equal except ``die_util``, held to 4 ulps: the reference's own output
    at this commit differs from its pin there by the same ulps (a sum
    order changed after the pin; ROADMAP.md, C4), and the port equals
    the reference's output."""
    monkeypatch.setenv("REPRO_TORCH_CHAR_CACHE_DIR", str(tmp_path))
    TC.clear_tables()
    try:
        w = dataclasses.replace(TF.make_workloads()["websearch"],
                                n_requests=400)
        for engine in ("array", "batched"):
            grid = TF.compare_mechanisms(
                w, TF.OperatingCondition(*AGED),
                mechanisms=("baseline", "pr2ar2"), seed=3, engine=engine,
                device="cpu")
            for mech, want in GOLDEN["compare_plain"].items():
                got = dataclasses.asdict(grid[mech])
                for field, v in want.items():
                    if field == "die_util":
                        assert abs(got[field] - v) <= 4 * math.ulp(v)
                    else:
                        assert got[field] == v, (engine, mech, field)
    finally:
        TC.clear_tables()
        TC.load_tables(*_synthetic_tables())
