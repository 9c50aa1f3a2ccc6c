"""The port's seed closure engine (``engine="reference"``) against the
JAX package's, on the CPU.

Both read the synthetic tables of ``tests/test_torch_flashsim.py``
(its ``tables`` fixture).  Every ``SimStats`` field must be equal, and
every request must finish at the same microsecond, on a read-heavy
workload (``websearch``) and a write-heavy one (``prn``); the engine
raises where the reference's does (faults, the closed-loop frontend,
``shard=True``, schedulers other than fcfs).
"""

import dataclasses

import numpy as np
import pytest

import repro_torch.flashsim as TF
from repro_torch.core.retry import RetryPolicy
from repro_torch.flashsim.engine_ref import SSDSimRef
from test_torch_flashsim import AGED, MODEST, N, one_thread, tables  # noqa: F401

WORKLOADS = ["websearch", "prn"]


def _ref_cond(cond):
    from repro.flashsim.config import OperatingCondition

    return OperatingCondition(*cond)


@pytest.mark.parametrize("mechanism", ["baseline", "pr2ar2", "sota+pr2ar2"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_simulate_matches_reference(tables, workload, mechanism):
    from repro.flashsim import ssd as RS

    kw = dict(seed=3, n_requests=N, engine="reference")
    ref = RS.simulate(workload, _ref_cond(AGED), mechanism, **kw)
    got = TF.simulate(workload, TF.OperatingCondition(*AGED), mechanism,
                      device="cpu", **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_compare_mechanisms_matches_reference(tables, workload):
    from repro.flashsim import ssd as RS

    kw = dict(seed=1, n_requests=N, engine="reference")
    ref = RS.compare_mechanisms(workload, _ref_cond(MODEST), **kw)
    got = TF.compare_mechanisms(workload, TF.OperatingCondition(*MODEST),
                                device="cpu", **kw)
    assert list(got) == list(ref)
    for m in ref:
        assert dataclasses.asdict(got[m]) == dataclasses.asdict(ref[m])


def test_simulate_batch_matches_reference(tables):
    from repro.flashsim import ssd as RS

    kw = dict(mechanisms=("baseline", "pr2ar2"), seeds=(0, 1), n_requests=N,
              engine="reference")
    ref = RS.simulate_batch("websearch", [_ref_cond(AGED), _ref_cond(MODEST)],
                            **kw)
    got = TF.simulate_batch("websearch", [TF.OperatingCondition(*AGED),
                                          TF.OperatingCondition(*MODEST)],
                            device="cpu", **kw)
    assert len(got) == len(ref) == 8
    for (gk, gv), (rk, rv) in zip(got.items(), ref.items()):
        assert (gk[0], gk[1].retention_days, gk[1].pec, gk[2]) == \
            (rk[0], rk[1].retention_days, rk[1].pec, rk[2])
        assert dataclasses.asdict(gv) == dataclasses.asdict(rv)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_per_request_completion_times_match(tables, workload):
    from repro.core.retry import RetryPolicy as RPolicy
    from repro.flashsim import ssd as RS
    from repro.flashsim.engine_ref import SSDSimRef as RSimRef

    trace = TF.resolve_trace(workload, seed=2, n_requests=N)
    ref_trace = RS.resolve_trace(workload, seed=2, n_requests=N)
    for mech in ("baseline", "pr2ar2"):
        got = SSDSimRef(condition=TF.OperatingCondition(*AGED),
                        policy=RetryPolicy(mech), seed=7, device="cpu")
        ref = RSimRef(condition=_ref_cond(AGED), policy=RPolicy(mech), seed=7)
        got.run(trace)
        ref.run(ref_trace)
        np.testing.assert_array_equal(got.last_req_done_us,
                                      ref.last_req_done_us)
        assert got.events_processed == ref.events_processed


def _raising_calls(pkg, cond, config, **device):
    """The reference engine's refusals, as one package spells them."""
    sim = dict(n_requests=50, engine="reference", **device)
    return {
        "faults knob": lambda: pkg.simulate(
            "websearch", cond, "baseline", faults=config.FaultConfig(), **sim),
        "faults cfg": lambda: pkg.simulate(
            "websearch", cond, "baseline", cfg=dataclasses.replace(
                config.DEFAULT_SSD, faults=config.FaultConfig()), **sim),
        "ncq_depth knob": lambda: pkg.simulate(
            "websearch", cond, "baseline", ncq_depth=8, **sim),
        "ncq_depth cfg": lambda: pkg.simulate(
            "websearch", cond, "baseline", cfg=dataclasses.replace(
                config.DEFAULT_SSD, ncq_depth=8), **sim),
        "shard simulate": lambda: pkg.simulate(
            "websearch", cond, "baseline", shard=True, **sim),
        "shard simulate_batch": lambda: pkg.simulate_batch(
            "websearch", (cond,), mechanisms=("baseline",), shard=True,
            **sim),
        "scheduler": lambda: pkg.simulate(
            "websearch", cond, "baseline", scheduler="host_prio", **sim),
    }


@pytest.mark.parametrize("case,match", [
    ("faults knob", "array engine"),
    ("faults cfg", "array engine"),
    ("ncq_depth knob", "array engine"),
    ("ncq_depth cfg", "array engine"),
    ("shard simulate", "shard"),
    ("shard simulate_batch", "shard"),
    ("scheduler", "scheduler"),
])
def test_raises_as_the_reference_does(tables, case, match):
    """The same calls raise the same ``NotImplementedError`` in both
    packages: faults and the closed loop, by knob or by config, take the
    reference engine's own refusal."""
    from repro.flashsim import config as RCFG
    from repro.flashsim import ssd as RS

    port = _raising_calls(TF, TF.OperatingCondition(*AGED), TF,
                          device="cpu")
    ref = _raising_calls(RS, _ref_cond(AGED), RCFG)
    with pytest.raises(NotImplementedError, match=match) as want:
        ref[case]()
    with pytest.raises(NotImplementedError, match=match) as got:
        port[case]()
    assert str(got.value) == str(want.value)


def test_ssdsim_names_ssdsimref(tables):
    with pytest.raises(ValueError, match="SSDSimRef"):
        TF.SSDSim(condition=TF.OperatingCondition(*AGED), engine="reference",
                  device="cpu")
