"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
reference's ``repro.models.rglru``.

Parameters come from the reference's ``rglru_init`` on the reduced
``recurrentgemma-2b`` (lru width 64) through ``params_from_jax``; inputs
are made with numpy from a seed.  Held, in float32:

  * the scan: ``linear_scan`` against ``lax.associative_scan`` of the
    same combine on the same (a, b), within 1e-5 of max|h| (the port
    restates the reference's recursion, so it is bitwise on this host);
  * ``rglru_fullseq`` at T in {1, 2, 37, 40, 64} (odd, even and powers
    of two): y within 1e-5 of max|y|, the cache's conv state and h
    within 1e-5 of their largest;
  * decode from the prefill cache: within 1e-5 of the reference's
    decode, and equal (within 1e-5) to the port's own full sequence one
    token longer;
  * bfloat16 activations: y within 5% of max|y|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced_config as ref_reduced_config
from repro.models import rglru as RR
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import rglru as PR
from repro_torch.models.convert import params_from_jax

ARCH = "recurrentgemma-2b"
B = 2
TOL = 1e-5
BF16_REL_TOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(act="float32"):
    return (dataclasses.replace(ref_reduced_config(ref_get_config(ARCH)),
                                activation_dtype=act),
            dataclasses.replace(reduced_config(get_config(ARCH)),
                                activation_dtype=act))


@pytest.fixture(scope="module")
def params():
    rcfg, _ = _cfgs()
    p = jax.tree.map(np.asarray, RR.rglru_init(jax.random.PRNGKey(0), rcfg))
    return p, params_from_jax(p, "cpu")


def _x(T, seed=0):
    w = _cfgs()[1].d_model
    return np.random.default_rng(seed).standard_normal((B, T, w)).astype(
        np.float32)


def _close(got, want, tol=TOL):
    want = np.asarray(want, dtype=np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("T", [1, 2, 5, 37, 40, 64, 257])
def test_scan_matches_associative_scan(T):
    rng = np.random.default_rng(T)
    a = rng.uniform(0.3, 1.0, (B, T, 16)).astype(np.float32)
    b = rng.standard_normal((B, T, 16)).astype(np.float32)

    def combine(l, r):
        return l[0] * r[0], l[1] * r[0] + r[1]

    want_a, want_h = jax.lax.associative_scan(
        combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got_a, got_h = PR.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(got_h, want_h)
    _close(got_a, want_a)


def test_scan_depth_is_logarithmic():
    """The recursion takes ceil(log2 T) levels, not T steps."""
    calls = []
    orig = PR.linear_scan

    def counted(a, b):
        calls.append(a.shape[1])
        return orig(a, b)

    PR.linear_scan = counted
    try:
        counted(torch.ones(1, 2048, 1), torch.ones(1, 2048, 1))
    finally:
        PR.linear_scan = orig
    assert calls == [2048 >> i for i in range(12)]


@pytest.mark.parametrize("T", [1, 2, 37, 40, 64])
def test_fullseq_and_decode_match_reference(params, T):
    rcfg, cfg = _cfgs()
    p, tp = params
    x = _x(T)
    want_y, want_c = RR.rglru_fullseq(rcfg, p, jnp.asarray(x))
    y, c = PR.rglru_fullseq(cfg, tp, torch.from_numpy(x))
    _close(y, want_y)
    assert sorted(c) == sorted(want_c) == ["conv", "h"]
    assert c["h"].dtype == torch.float32
    _close(c["conv"], want_c["conv"])
    _close(c["h"], want_c["h"])

    x1 = _x(1, seed=T + 100)
    want_y1, want_c1 = RR.rglru_decode(rcfg, p, jnp.asarray(x1), want_c)
    y1, c1 = PR.rglru_decode(cfg, tp, torch.from_numpy(x1), c)
    _close(y1, want_y1)
    _close(c1["conv"], want_c1["conv"])
    _close(c1["h"], want_c1["h"])
    # Decoding one token from the prefill cache is the full sequence's
    # next step.
    y_full, c_full = PR.rglru_fullseq(cfg, tp, torch.from_numpy(
        np.concatenate([x, x1], axis=1)))
    _close(y1, y_full[:, -1:].numpy())
    _close(c1["h"], c_full["h"].numpy())
    _close(c1["conv"], c_full["conv"].numpy())


def test_bfloat16_fullseq_and_decode(params):
    rcfg, cfg = _cfgs("bfloat16")
    p, tp = params
    x = _x(40)
    want_y, want_c = RR.rglru_fullseq(rcfg, p, jnp.asarray(x, jnp.bfloat16))
    y, c = PR.rglru_fullseq(cfg, tp, torch.from_numpy(x).bfloat16())
    assert y.dtype == c["conv"].dtype == torch.bfloat16
    assert c["h"].dtype == torch.float32
    _close(y, np.asarray(want_y.astype(jnp.float32)), BF16_REL_TOL)
    x1 = _x(1, seed=7)
    want_y1, _ = RR.rglru_decode(rcfg, p, jnp.asarray(x1, jnp.bfloat16),
                                 want_c)
    y1, _ = PR.rglru_decode(cfg, tp, torch.from_numpy(x1).bfloat16(), c)
    _close(y1, np.asarray(want_y1.astype(jnp.float32)), BF16_REL_TOL)


def test_seeded_init_matches_reference_layout(params):
    _, cfg = _cfgs()
    p, _ = params
    got = PR.rglru_init(torch.Generator().manual_seed(0), cfg)
    assert sorted(got) == sorted(p)
    for k, v in got.items():
        assert tuple(v.shape) == p[k].shape and v.dtype == torch.float32, k
    # a^c = exp(-c softplus(Lambda)) = sqrt(u) lies in (0.9, 0.999).
    ac = torch.exp(-PR._C * torch.nn.functional.softplus(got["lambda_p"]))
    assert bool((ac > 0.9 - 1e-6).all() and (ac < 0.999 + 1e-6).all())
