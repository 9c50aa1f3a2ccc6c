"""The port's calibration fit against the reference's ``core/calibrate.py``.

``evaluate`` draws the same populations key for key and computes them
with XLA's float32 math (``repro_torch.core.xla_math``), so its nine
metrics and ``score`` equal the reference's exactly: for the shipped
constants and for sets of the fit's 108-set grid.  The reference runs in
JAX's non-partitionable threefry mode with its characterization cache
off.
"""

import dataclasses
import itertools

import jax
import pytest
import torch

from repro.core import calibrate as RCal
from repro.core import constants as RCC
from repro_torch.core import calibrate as TCal
from repro_torch.core import constants as TCC


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and a 160-chip characterization on every core of each would
    oversubscribe the host.  (No result depends on the thread count.)"""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def reference_mode(monkeypatch):
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    monkeypatch.setenv("REPRO_CHAR_CACHE", "0")
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _reference_params(p: TCC.NandParams) -> RCC.NandParams:
    return RCC.NandParams(**dataclasses.asdict(p))


def test_grid_is_the_references():
    """108 sets in the reference's ``main`` order."""
    grid = list(TCal.grid_params())
    assert len(grid) == 108
    axes = itertools.product((0.075, 0.082, 0.090, 0.098),
                             (0.0030, 0.0035, 0.0040), (0.16, 0.20, 0.24),
                             (0.045, 0.05, 0.055))
    for p, (alpha_r, sigma_r, eta, step) in zip(grid, axes):
        want = RCC.NandParams(sigma0=TCal.GRID_SIGMA0, alpha_r=alpha_r,
                              sigma_r=sigma_r, sense_eta=eta, sigma_w=0.014,
                              retry_step_v=step)
        assert dataclasses.asdict(p) == dataclasses.asdict(want)


@pytest.mark.parametrize("which", ["default", 0, 107])
def test_evaluate_and_score_equal_reference(which):
    """The nine metrics and the score, exactly.  Grid sets 0 and 107
    take the AR² attempt ratios through means whose float32 rounding
    differs between a division and XLA's reciprocal product."""
    port = TCC.DEFAULT_NAND if which == "default" \
        else list(TCal.grid_params())[which]
    want = RCal.evaluate(_reference_params(port))
    got = TCal.evaluate(port, device="cpu")
    assert list(got) == list(want)
    for name in want:
        assert float(got[name]) == float(want[name]), name
    assert TCal.score(got) == RCal.score(want)


def test_main_keeps_the_first_best(monkeypatch):
    """``main`` scores every set and keeps the first of equal bests."""
    seen = []

    def fake_evaluate(p, device=None):
        seen.append(p)
        steps = 4.5 if p.alpha_r == 0.082 else 6.0
        return {"t1_mean_steps_3mo": steps, "t2_worst_fail_frac": 0.0,
                "t2_margin_mean": 0.5, "t3_ratio_075": 1.0,
                "t3_ratio_070": 1.1, "t4_fresh_steps": 0.0,
                "t5_sota_aged_steps": 3.5}

    monkeypatch.setattr(TCal, "evaluate", fake_evaluate)
    score, best, metrics = TCal.main(device="cpu", verbose=False)
    assert len(seen) == 108
    assert score == 0.0 and best == seen[27]
    assert best.alpha_r == 0.082 and metrics["t1_mean_steps_3mo"] == 4.5


@pytest.mark.parametrize("which", ["default", 28])
def test_worst_margins_equal_reference(which):
    """The float32 margins that ``t2_margin_mean`` and ``t2_margin_p01``
    reduce, bit for bit against the reference's ``evaluate``'s, for the
    shipped constants and the grid's best set (index 28)."""
    import numpy as np

    from repro.core import ecc as RE
    from repro.core import retry as RR

    port = TCC.DEFAULT_NAND if which == "default" \
        else list(TCal.grid_params())[which]
    ref, key = _reference_params(port), jax.random.PRNGKey(0)
    want = np.concatenate([
        np.asarray(RE.capability_margin(RR.attempts_for_population(
            jax.random.fold_in(key, i), 365.0, 1500.0, pt, params=ref,
            n_blocks=4, n_pages=8)[1])).ravel()
        for i, pt in enumerate(RCC.PAGE_TYPES)])
    got = TCal.worst_margins(port, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
