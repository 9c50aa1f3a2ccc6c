"""The port's float32 math layer against XLA's CPU results, bit for bit.

``repro_torch.core.xla_math`` restates XLA's CPU expansions of ``exp``,
``log``, ``log1p``, ``erfc`` and ``sqrt``.  Through it the port's
normals, population RBER tensors and characterization records are
bitwise the reference's:

  * every one of the 2^23 uniforms ``normal`` can draw maps to the
    reference's ``sqrt(2) * erf_inv(u)`` exactly, and ``log1p32`` equals
    ``jnp.log1p`` at every ``-u*u`` those uniforms give ``erf_inv``;
  * ``_population_rber`` equals the reference's for the three page types
    at 365 d / 1000 P/E and 0 d / 0 P/E;
  * ``characterize_condition``'s float fields equal the reference's.

The reference runs eagerly in JAX's non-partitionable threefry mode,
with its characterization caches off and cleared (as ``test_torch_core``
runs it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import jax.scipy.special as jss
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import characterize as RC
from repro.core import constants as RCC
from repro_torch.core import characterize as TC
from repro_torch.core import constants as TCC
from repro_torch.core import prng
from repro_torch.core import xla_math as X


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
    RC.characterize_condition.cache_clear()
    TC.clear_tables()
    yield
    RC.characterize_condition.cache_clear()
    TC.clear_tables()
    jax.config.update("jax_threefry_partitionable", prev)


def _bits_equal(want, got: torch.Tensor) -> np.ndarray:
    """Mask of elements whose float32 bits differ (NaN equals NaN)."""
    want = np.asarray(want, dtype=np.float32)
    got = got.numpy()
    assert want.shape == got.shape and got.dtype == np.float32
    bad = want.view(np.int32) != got.view(np.int32)
    return bad & ~(np.isnan(want) & np.isnan(got))


def _all_normal_uniforms() -> torch.Tensor:
    """The 2^23 float32 uniforms ``prng.normal`` can draw, as
    ``prng.uniform`` makes them from every 23-bit mantissa."""
    mant = torch.arange(1 << 23, dtype=torch.int64)
    floats = (mant | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(prng._NORMAL_LO, dtype=torch.float32)
    return torch.maximum(lo, floats * (1.0 - lo) + lo)


def test_normal_bitwise_for_every_reachable_uniform():
    u = _all_normal_uniforms()
    sqrt2 = np.array(np.sqrt(2), np.float32)
    want = jax.jit(lambda v: lax.mul(sqrt2, lax.erf_inv(v)))(u.numpy())
    got = torch.tensor(float(sqrt2)) * prng.erfinv32(u)
    bad = _bits_equal(want, got)
    assert not bad.any(), f"{bad.sum()} of {bad.size} normals differ"


def test_log1p32_at_every_erfinv_argument():
    u = _all_normal_uniforms()
    x = -(u * u)
    bad = _bits_equal(jnp.log1p(x.numpy()), X.log1p32(x))
    assert not bad.any(), f"{bad.sum()} of {bad.size} differ"


def _samples(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.uniform(-12.0, 12.0, 1 << 18), rng.standard_normal(1 << 18),
        np.exp(rng.uniform(-95.0, 88.0, 1 << 18)),
        -np.exp(rng.uniform(-95.0, 0.0, 1 << 16)),
        [0.0, -0.0, 1.0, -1.0, 2.0, np.inf, -np.inf, np.nan, 1e-39,
         -1e-39, 1e-30, 88.72, -88.72, 9.4, -9.4],
    ]).astype(np.float32)


@pytest.mark.parametrize("name,port,ref", [
    ("exp", X.exp32, jnp.exp),
    ("log", X.log32, jnp.log),
    ("log1p", X.log1p32, jnp.log1p),
    ("erfc", X.erfc32, jss.erfc),
    ("sqrt", X.sqrt32, jnp.sqrt),
])
def test_function_bitwise_on_samples(name, port, ref):
    """Each function over a million float32 values spanning its range:
    denormals count as zero and denormal results flush, as on XLA's
    CPU backend."""
    x = _samples(sum(map(ord, name)))
    bad = _bits_equal(ref(x), port(torch.from_numpy(x)))
    assert not bad.any(), (name, x[bad][:8])


def test_erfc32_blocks_equal_one_block():
    x = torch.from_numpy(_samples(3))
    assert x.numel() > X._CPU_BLOCK
    assert torch.equal(X.erfc32(x).view(torch.int32),
                       X._erfc32(x).view(torch.int32))


def test_powf_matches_jax_power():
    rng = np.random.default_rng(4)
    base = rng.uniform(0.0, 5.0, 2000).astype(np.float32)
    expo = rng.uniform(-2.0, 2.0, 2000).astype(np.float32)
    want = np.asarray(jnp.power(base, expo))
    got = np.array([X.powf(b, e) for b, e in zip(base, expo)], np.float32)
    assert np.array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("retention,pec", [(365.0, 1000.0), (0.0, 0.0)])
@pytest.mark.parametrize("index,page_type", list(enumerate(RCC.PAGE_TYPES)))
def test_population_rber_bitwise(retention, pec, index, page_type):
    key = jax.random.fold_in(jax.random.PRNGKey(0), 1 + index)
    want = RC._population_rber(key, retention, pec, page_type, 160, 8, 16,
                               1.0, RCC.DEFAULT_NAND)
    tkey = prng.fold_in(prng.PRNGKey(0, device="cpu"), 1 + index)
    got = TC._population_rber(tkey, retention, pec, page_type, 160, 8, 16,
                              1.0, TCC.DEFAULT_NAND)
    bad = _bits_equal(want, got)
    assert not bad.any(), f"{bad.sum()} of {bad.size} RBER values differ"


@pytest.mark.parametrize("retention,pec", [(365.0, 1000.0), (90.0, 0.0)])
def test_characterize_condition_float_fields_bitwise(retention, pec):
    want = dataclasses.asdict(RC.characterize_condition(retention, pec))
    got = dataclasses.asdict(TC.characterize_condition(retention, pec,
                                                       device="cpu"))
    assert got == want
