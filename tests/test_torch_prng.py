"""Threefry draws of the port against ``jax.random``, key for key.

The reference's goldens were pinned in JAX's non-partitionable threefry
mode; the fixture pins that mode for the duration of each test and
restores the process's setting afterwards.  Raw bits, derived keys,
uniforms, normals and randints are bitwise equal (normals through XLA's
``erf_inv`` polynomial and its CPU ``log1p`` and ``sqrt``, restated in
``repro_torch.core.xla_math``).
"""

import jax
import numpy as np
import pytest

from repro_torch.core import prng

SEEDS = (0, 7, 101, 123456789)
SHAPES = ((1,), (7,), (4, 5), (160, 8, 3, 7))


@pytest.fixture(autouse=True)
def threefry_original():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _data(key):
    return np.asarray(jax.random.key_data(key)
                      if jax.dtypes.issubdtype(key.dtype,
                                               jax.dtypes.prng_key)
                      else key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in(seed):
    k = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed, device="cpu")
    assert np.array_equal(_data(k), tk.numpy())
    for num in (2, 3):
        assert np.array_equal(_data(jax.random.split(k, num)),
                              prng.split(tk, num).numpy())
    for i in (0, 1, 2, 2**31 + 3):
        assert np.array_equal(_data(jax.random.fold_in(k, i)),
                              prng.fold_in(tk, i).numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_and_uniform_bitwise(seed, shape):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    tk = prng.fold_in(prng.PRNGKey(seed, device="cpu"), 1)
    bits = np.asarray(jax.random.bits(k, shape)).astype(np.int64)
    assert np.array_equal(bits, prng.random_bits(tk, shape).numpy())
    u = np.asarray(jax.random.uniform(k, shape))
    tu = prng.uniform(tk, shape).numpy()
    assert u.dtype == tu.dtype == np.float32
    assert np.array_equal(u, tu)
    lo = np.float32(prng._NORMAL_LO)
    u2 = np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=1.0))
    assert np.array_equal(u2, prng.uniform(tk, shape, prng._NORMAL_LO,
                                           1.0).numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_normal_close(seed, shape):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
    tk = prng.fold_in(prng.PRNGKey(seed, device="cpu"), 2)
    want = np.asarray(jax.random.normal(k, shape))
    got = prng.normal(tk, shape).numpy()
    assert got.dtype == np.float32
    ulp = np.abs(want.view(np.int32).astype(np.int64)
                 - got.view(np.int32).astype(np.int64))
    print(f"normal seed={seed} shape={shape}: max ulp gap {ulp.max()}, "
          f"{(ulp > 0).mean():.4%} of draws differ")
    assert np.array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES[1:])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_randint_equal(seed, shape):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    tk = prng.fold_in(prng.PRNGKey(seed, device="cpu"), 3)
    want = np.asarray(jax.random.randint(k, shape, -1, 1))
    got = prng.randint(tk, shape, -1, 1).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(want, got)
    assert set(np.unique(got)) <= {-1, 0}
