"""Port's NAND characterization against the JAX reference.

Each voltage/ecc/retry function of the port is held allclose to the
reference on the same numpy inputs (float32, rtol 1e-5).  Functions with
integer outputs are held equal given equal inputs.  Where the port draws
its own population, per-page first-success entries are listed if they
flip, and at most 0.1% may.  (These bounds date from before the port's
float32 math was XLA's; ``test_torch_xla_math.py`` now holds the
population and the records bit for bit.)

The reference runs in JAX's non-partitionable threefry mode (the mode
its goldens were pinned with), with its on-disk cache off and its
in-process caches cleared before and after, so no value computed here
leaks into another test of the process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import characterize as RC
from repro.core import ecc as RE
from repro.core import retry as RR
from repro.core import voltage as RV
from repro_torch.core import characterize as TC
from repro_torch.core import ecc as TE
from repro_torch.core import prng
from repro_torch.core import retry as TR
from repro_torch.core import voltage as TV

RTOL = 1e-5
MAX_FLIP_FRACTION = 1e-3


def _clear_reference_caches():
    for fn in (RC.characterize_condition, RC.safe_tr_table,
               RC.attempt_histogram, RC.attempt_cdf):
        fn.cache_clear()


@pytest.fixture(autouse=True)
def reference_mode(monkeypatch, tmp_path):
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    monkeypatch.setenv("REPRO_CHAR_CACHE", "0")
    _clear_reference_caches()
    TC.clear_tables()
    yield
    _clear_reference_caches()
    TC.clear_tables()
    jax.config.update("jax_threefry_partitionable", prev)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and a 160-chip characterization on every core of each would
    oversubscribe the host.  (No result depends on the thread count.)"""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, rtol=RTOL, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.fixture
def dists():
    rng = np.random.default_rng(11)
    t = rng.uniform(0.0, 365.0, (6, 5)).astype(np.float32)
    c = rng.uniform(0.0, 1500.0, (6, 5)).astype(np.float32)
    rate = np.exp(0.05 * rng.standard_normal((6, 5))).astype(np.float32)
    return t, c, rate


def test_qfunc():
    x = np.random.default_rng(0).uniform(-6.0, 6.0, 4096).astype(np.float32)
    _close(TV.qfunc(_t(x)), RV.qfunc(jnp.asarray(x)))


def test_degradation_and_distributions(dists):
    t, c, rate = dists
    _close(TV.charge_fraction(), RV.charge_fraction())
    _close(TV.degradation_scale(_t(t), _t(c)),
           RV.degradation_scale(jnp.asarray(t), jnp.asarray(c)))
    mu, sg = TV.degraded_distributions(_t(t), _t(c), _t(rate))
    rmu, rsg = RV.degraded_distributions(jnp.asarray(t), jnp.asarray(c),
                                         jnp.asarray(rate))
    _close(mu, rmu, atol=1e-6)
    _close(sg, rsg)


def test_read_levels_and_sensing(dists):
    t, c, rate = dists
    steps = np.arange(41, dtype=np.float32)
    _close(TV.default_read_levels(), RV.default_read_levels(), atol=1e-6)
    _close(TV.retry_read_levels(_t(steps)),
           RV.retry_read_levels(jnp.asarray(steps)), atol=1e-6)
    _, sg = RV.degraded_distributions(jnp.asarray(t), jnp.asarray(c),
                                      jnp.asarray(rate))
    scale = np.linspace(0.6, 1.0, 5).astype(np.float32)
    _close(TV.sensing_sigma(_t(sg), _t(scale)),
           RV.sensing_sigma(sg, jnp.asarray(scale)))


@pytest.mark.parametrize("page_type", ["lsb", "csb", "msb"])
@pytest.mark.parametrize("tr_scale", [1.0, 0.75])
def test_error_rates(dists, page_type, tr_scale):
    t, c, rate = dists
    rmu, rsg = RV.degraded_distributions(jnp.asarray(t), jnp.asarray(c),
                                         jnp.asarray(rate))
    mu, sg = _t(rmu), _t(rsg)
    levels = np.asarray(RV.retry_read_levels(jnp.arange(41.0)))[7]
    _close(TV.boundary_error_rates(mu, sg, _t(levels), tr_scale),
           RV.boundary_error_rates(rmu, rsg, jnp.asarray(levels), tr_scale))
    _close(TV.rber_from_distributions(mu, sg, _t(levels), page_type,
                                      tr_scale),
           RV.rber_from_distributions(rmu, rsg, jnp.asarray(levels),
                                      page_type, tr_scale))
    jit = (0.01 * np.random.default_rng(5).standard_normal(
        (6, 5, 7))).astype(np.float32)
    _close(TR.rber_per_retry_step(mu, sg, page_type, tr_scale, _t(jit)),
           RR.rber_per_retry_step(rmu, rsg, page_type, tr_scale,
                                  jnp.asarray(jit)))
    rber = np.asarray(RR.rber_per_retry_step(rmu, rsg, page_type, tr_scale))
    _close(TE.capability_margin(_t(rber)), RE.capability_margin(rber))
    assert np.array_equal(TE.correctable(_t(rber)).numpy(),
                          np.asarray(RE.correctable(jnp.asarray(rber))))


def test_process_variation():
    got = TV.sample_process_variation(prng.PRNGKey(3), 16, 8)
    want = RV.sample_process_variation(jax.random.PRNGKey(3), 16, 8)
    _close(got, want)


@pytest.mark.parametrize("start", [0, "sota"])
def test_first_success_and_sota_start_given_equal_rber(start):
    rng = np.random.default_rng(2)
    rber = (10.0 ** rng.uniform(-4.0, -1.5, (4, 8, 41))).astype(np.float32)
    rber = np.sort(rber, axis=-1)[..., ::-1].copy()   # improves with k
    rber[0, 0] = 1.0                                    # never succeeds
    k_ref = RR.first_success_step(jnp.asarray(rber))
    k = TR.first_success_step(_t(rber))
    assert np.array_equal(k.numpy(), np.asarray(k_ref))
    if start == "sota":
        s_ref = RR.sota_start_step(k_ref, jax.random.PRNGKey(9))
        s = TR.sota_start_step(k, prng.PRNGKey(9))
        assert np.array_equal(s.numpy(), np.asarray(s_ref))
        assert np.array_equal(
            TR.first_success_step(_t(rber), s).numpy(),
            np.asarray(RR.first_success_step(jnp.asarray(rber), s_ref)))


@pytest.mark.parametrize("page_type,sota,tr_scale", [
    ("lsb", False, 1.0), ("csb", True, 1.0), ("msb", False, 0.75),
    ("csb", True, 0.75),
])
def test_attempts_for_population_per_page(page_type, sota, tr_scale):
    key = jax.random.fold_in(jax.random.PRNGKey(101), 1)
    tkey = prng.fold_in(prng.PRNGKey(101), 1)
    a_ref, f_ref = RR.attempts_for_population(
        key, 365.0, 1000.0, page_type, n_chips=4, n_blocks=2, n_pages=8,
        sota=sota, tr_scale=tr_scale)
    a, f = TR.attempts_for_population(
        tkey, 365.0, 1000.0, page_type, n_chips=4, n_blocks=2, n_pages=8,
        sota=sota, tr_scale=tr_scale)
    a_ref = np.asarray(a_ref)
    flips = np.argwhere(a.numpy() != a_ref)
    for idx in flips:
        print(f"page {tuple(idx)} flips: port {a.numpy()[tuple(idx)]} "
              f"reference {a_ref[tuple(idx)]}")
    assert len(flips) <= MAX_FLIP_FRACTION * a_ref.size
    same = a.numpy() == a_ref
    _close(f.numpy()[same], np.asarray(f_ref)[same], rtol=1e-4)


def test_characterize_condition_small_population():
    ref = RC.characterize_condition(365.0, 1000.0, n_chips=4)
    got = TC.characterize_condition(365.0, 1000.0, n_chips=4, device="cpu")
    assert got.safe_tr_scale == ref.safe_tr_scale
    assert got.mean_retry_steps == pytest.approx(ref.mean_retry_steps,
                                                 abs=1e-3)
    assert got.p99_retry_steps == ref.p99_retry_steps
    assert got.mean_margin_final == pytest.approx(ref.mean_margin_final,
                                                  rel=1e-4)
    # memoized: the second call returns the same record
    assert TC.characterize_condition(365.0, 1000.0, n_chips=4,
                                     device="cpu") is got


@pytest.mark.parametrize("page_type,sota,tr_scale", [
    ("lsb", False, 1.0), ("csb", True, 0.75), ("msb", False, 0.75),
])
def test_attempt_histograms(page_type, sota, tr_scale):
    ref = RC.attempt_histogram(365.0, 1000.0, page_type, sota, tr_scale)
    got = TC.attempt_histogram(365.0, 1000.0, page_type, sota, tr_scale,
                               device="cpu")
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-3
    cdf = TC.attempt_cdf(365.0, 1000.0, page_type, sota, tr_scale,
                         device="cpu")
    assert not cdf.flags.writeable
    np.testing.assert_allclose(cdf, np.cumsum(got))


def test_load_tables_seeds_the_memo():
    from repro_torch.core.characterize import ConditionStats

    stats = ConditionStats(365.0, 1000.0, 1.0, 2.0, 0.5, 0.4, 0.1, 0.8)
    hist = np.zeros(42)
    hist[3] = 1.0
    TC.load_tables({(365.0, 1000.0): stats},
                   {(365.0, 1000.0, "csb", False, 0.8): hist})
    assert TC.characterize_condition(365, 1000, device="cpu") == stats
    cdf = TC.attempt_cdf(365.0, 1000.0, "csb", False, 0.8, device="cpu")
    assert np.array_equal(cdf, np.cumsum(hist))
