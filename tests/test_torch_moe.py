"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
reference's ``repro.models.moe``.

Parameters come from the reference's ``moe_init`` on the reduced
``olmoe-1b-7b`` (softmax router, 8 experts, top-2) and the reduced
``llama4-maverick-400b-a17b`` (sigmoid router, top-1, a shared expert)
through ``params_from_jax``; inputs are made with numpy from a seed,
with a common offset on every token so that the router favours a few
experts.  Held, in float32: ``moe_apply``'s output within 1e-5 of its
largest magnitude and the load-balance aux loss within rtol 1e-6, at
capacity factor 8 (no assignment dropped) and at the default 1.25 (the
reference drops some, asserted); ``router_aux_loss``; ties broken as
``lax.top_k`` breaks them (the lower expert index first); and
``REPRO_MOE_EP=1``, under which the port computes the dense dispatch
(the reference recurses without end there: ROADMAP C11).  With bfloat16
activations the output is held within 5% of its largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced_config as ref_reduced_config
from repro.models import moe as RM
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import moe as PM
from repro_torch.models.convert import params_from_jax

ARCHS = ("olmoe-1b-7b", "llama4-maverick-400b-a17b")
B, T = 2, 37
TOL = 1e-5
BF16_REL_TOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, cf=None, act="float32"):
    out = []
    for cfg in (ref_reduced_config(ref_get_config(arch)),
                reduced_config(get_config(arch))):
        moe = cfg.moe if cf is None else dataclasses.replace(
            cfg.moe, capacity_factor=cf)
        out.append(dataclasses.replace(cfg, activation_dtype=act, moe=moe))
    return out


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        rcfg, _ = _cfgs(arch)
        p = jax.tree.map(np.asarray,
                         RM.moe_init(jax.random.PRNGKey(0), rcfg, rcfg.moe))
        _PARAMS[arch] = (p, params_from_jax(p, "cpu"))
    return _PARAMS[arch]


def _x(d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, d))
            + 1.5 * rng.standard_normal(d)).astype(np.float32)


def _ref_dropped(rcfg, p, x):
    """Assignments the reference's dispatch drops (its routing and
    capacity, restated)."""
    moe = rcfg.moe
    N = x.shape[0] * x.shape[1]
    logits = x.reshape(N, -1) @ p["router"]
    probs = jax.nn.sigmoid(logits) if moe.router == "sigmoid" else \
        jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, moe.top_k)
    cap = max(int(N * moe.top_k / moe.n_experts * moe.capacity_factor), 4)
    counts = np.bincount(np.asarray(idx).ravel(), minlength=moe.n_experts)
    return int(np.maximum(counts - cap, 0).sum())


def _close(got, want, tol):
    want = np.asarray(want).astype(np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_moe_apply_and_aux_match_reference(arch, cf):
    rcfg, cfg = _cfgs(arch, cf)
    p, tp = _params(arch)
    x = _x(cfg.d_model)
    dropped = _ref_dropped(rcfg, p, x)
    assert (dropped > 0) == (cf < 2), dropped
    want, want_aux = RM.moe_apply(rcfg, rcfg.moe, p, jnp.asarray(x),
                                  with_aux=True)
    got, aux = PM.moe_apply(cfg, cfg.moe, tp, torch.from_numpy(x),
                            with_aux=True)
    _close(got, want, TOL)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)
    _close(PM.moe_apply(cfg, cfg.moe, tp, torch.from_numpy(x)), want, TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_bfloat16(arch):
    rcfg, cfg = _cfgs(arch, act="bfloat16")
    p, tp = _params(arch)
    x = _x(cfg.d_model, seed=1)
    want = RM.moe_apply(rcfg, rcfg.moe, p, jnp.asarray(x, jnp.bfloat16))
    got = PM.moe_apply(cfg, cfg.moe, tp, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)), BF16_REL_TOL)


def test_router_aux_loss_matches_reference():
    rcfg, cfg = _cfgs("olmoe-1b-7b")
    p, tp = _params("olmoe-1b-7b")
    for seed in range(3):
        x = _x(cfg.d_model, seed)
        want = RM.router_aux_loss(rcfg, rcfg.moe, p, jnp.asarray(x))
        got = PM.router_aux_loss(cfg, cfg.moe, tp, torch.from_numpy(x))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_top_k_breaks_ties_by_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.3],
                      [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1],
                      [0.0, 0.5, 0.0, 0.5]], np.float32)
    for k in (1, 2, 3):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = PM.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert PM.top_k(torch.from_numpy(probs), 2)[1].tolist() == [
        [1, 2], [0, 1], [0, 2], [1, 3]]


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_router_columns_pick_the_lower_expert(arch):
    """Experts 2 and 5 with equal router columns tie on every token: both
    packages route to the same experts, the lower first."""
    rcfg, cfg = _cfgs(arch)
    p, _ = _params(arch)
    p = dict(p)
    router = p["router"].copy()
    router[:, 5] = router[:, 2]
    router[:, 2] += 0.5 * np.abs(router).max()      # 2 and 5 lead the rest
    router[:, 5] = router[:, 2]
    p["router"] = router
    tp = params_from_jax(p, "cpu")
    x = np.abs(_x(cfg.d_model, seed=2))
    _, gate_v, gate_i = PM.route(cfg.moe, tp, torch.from_numpy(
        x.reshape(B * T, -1)))
    assert bool((gate_i[:, 0] == 2).all())
    if cfg.moe.top_k > 1:
        assert bool((gate_i[:, 1] == 5).all())
    want = RM.moe_apply(rcfg, rcfg.moe, p, jnp.asarray(x))
    _close(PM.moe_apply(cfg, cfg.moe, tp, torch.from_numpy(x)), want, TOL)


def test_expert_parallel_flag_is_the_dense_dispatch(monkeypatch):
    """``REPRO_MOE_EP=1`` with no device mesh (ROADMAP C11): the
    reference's ``moe_apply_ep`` falls back to ``moe_apply``, which sees
    the flag again and calls back, until Python's recursion limit.  The
    port computes the dense dispatch the fallback means, equal to the
    reference's without the flag."""
    rcfg, cfg = _cfgs("olmoe-1b-7b")
    p, tp = _params("olmoe-1b-7b")
    x = _x(cfg.d_model, seed=3)
    want, want_aux = RM.moe_apply(rcfg, rcfg.moe, p, jnp.asarray(x),
                                  with_aux=True)
    dense = PM.moe_apply(cfg, cfg.moe, tp, torch.from_numpy(x))
    monkeypatch.setenv("REPRO_MOE_EP", "1")
    with pytest.raises(RecursionError):
        RM.moe_apply(rcfg, rcfg.moe, p, jnp.asarray(x))
    got, aux = PM.moe_apply(cfg, cfg.moe, tp, torch.from_numpy(x),
                            with_aux=True)
    assert torch.equal(got, dense)
    _close(got, want, TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)


def test_seeded_init_matches_reference_layout():
    for arch in ARCHS:
        _, cfg = _cfgs(arch)
        p, _ = _params(arch)
        got = PM.moe_init(torch.Generator().manual_seed(0), cfg, cfg.moe)
        assert sorted(got) == sorted(p)
        for k in ("router", "moe_wi", "moe_wg", "moe_wd"):
            assert tuple(got[k].shape) == p[k].shape
        # Each expert's fan-in scale is 1/sqrt(d), truncated at 2 sigma.
        assert float(got["moe_wi"].abs().max()) <= 2 * cfg.d_model ** -0.5
