"""Public functions of the reference's ``core`` and ``models.common``
held against the port's copies on the same inputs.

``rber_all_page_types`` stacks the three page types' RBER; the
reference contracts the per-boundary rates with the 0/1 page masks by
``einsum``, the port sums each page type's boundaries left to right
(``voltage.sum_last``, the order of ``rber_from_distributions``).  The
masks make every product exact, so the two agree bit for bit (0 ulps)
wherever the per-boundary rates do.  ``mean_retry_steps`` draws the
160-chip population through the port's threefry, key for key with
``jax.random`` in the reference's non-partitionable mode, and reduces
as ``jnp.mean`` does on XLA's CPU backend: equal floats.  ``dtype_of``
names the same dtype for every published config.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import retry as RR
from repro.core import voltage as RV
from repro.models import common as RM
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import prng
from repro_torch.core import retry as TR
from repro_torch.core import voltage as TV
from repro_torch.models import common as TM

#: ``rber_all_page_types`` against the reference, in float32 ulps.
RBER_ULPS = 0


@pytest.fixture
def reference_mode(monkeypatch):
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    monkeypatch.setenv("REPRO_CHAR_CACHE", "0")
    yield
    jax.config.update("jax_threefry_partitionable", prev)


@pytest.mark.parametrize("retention,pec", [(0.0, 0.0), (365.0, 1000.0),
                                           (30.0, 1500.0), (180.0, 500.0)])
@pytest.mark.parametrize("tr_scale", [1.0, 0.75])
def test_rber_all_page_types(retention, pec, tr_scale):
    rng = np.random.default_rng(int(retention + pec))
    rate = rng.uniform(0.8, 1.2, (6, 5)).astype(np.float32)
    levels = (np.asarray(RV.default_read_levels())
              + rng.normal(0.0, 0.05, 7).astype(np.float32))
    mu, sigma = RV.degraded_distributions(retention, pec, jnp.asarray(rate))
    want = np.asarray(RV.rber_all_page_types(mu, sigma, jnp.asarray(levels),
                                             tr_scale))
    tmu, tsigma = TV.degraded_distributions(retention, pec,
                                            torch.as_tensor(rate))
    got = TV.rber_all_page_types(tmu, tsigma, torch.as_tensor(levels),
                                 tr_scale).numpy()
    assert got.shape == want.shape == (6, 5, 3) and got.dtype == want.dtype
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert int(ulps.max()) <= RBER_ULPS
    # each column is the page type's own RBER
    for i, pt in enumerate(("lsb", "csb", "msb")):
        assert np.array_equal(got[..., i], TV.rber_from_distributions(
            tmu, tsigma, torch.as_tensor(levels), pt, tr_scale).numpy())


@pytest.mark.parametrize("seed,retention,pec,sota", [
    (0, 365.0, 1000.0, False), (3, 30.0, 0.0, True)])
def test_mean_retry_steps(reference_mode, seed, retention, pec, sota):
    want = RR.mean_retry_steps(jax.random.PRNGKey(seed), retention, pec,
                               sota=sota)
    got = TR.mean_retry_steps(prng.PRNGKey(seed), retention, pec, sota=sota)
    assert isinstance(got, float)
    assert got == want


@pytest.mark.parametrize("overrides", [
    {}, dict(param_dtype="bfloat16", activation_dtype="float32")],
    ids=["published", "swapped"])
def test_dtype_of(overrides):
    for arch in ARCHS:
        ref = dataclasses.replace(ref_config(arch), **overrides)
        cfg = dataclasses.replace(get_config(arch), **overrides)
        for kind in ("param", "act", "activation"):
            got = TM.dtype_of(cfg, kind)
            assert isinstance(got, torch.dtype)
            assert str(got) == f"torch.{RM.dtype_of(ref, kind).name}"
        assert TM.dtype_of(cfg) == TM.dtype_of(cfg, "param")
        assert TM.act_dtype(cfg) == TM.dtype_of(cfg, "act")
