"""Port's Mamba-2 SSD model (``models/ssm.py``, the SSD blocks, the LM and
serving) against the JAX reference.

Reduced ``mamba2-130m`` (2 SSD layers, d 64, 8 heads of hd 16, ds 16,
chunk 32) with parameters from the reference's ``init`` carried over by
``params_from_jax``; tokens are made with numpy from a seed, and prompts
of 40 tokens span two chunks.  The port's prefill runs the ``ssd_scan``
entry (its plain version on the CPU).  The reference runs each test
twice: with ``REPRO_PALLAS_SSD=1``, where its prefill calls the Pallas
kernel in interpret mode, and in its default mode on the CPU ("off"),
where it calls its jnp ``ssd_chunked``.

Tolerances: in float32, prefill logits, block outputs and caches (conv
and ssm) within 1e-4, and 6 greedy decode steps give equal tokens
(logits within 1e-4).  In bfloat16 the two packages round the conv and
the projections at other places, so logits are held within 5% of the
largest logit (0.9% measured; the test prints its gap).  The serving engines give
equal tokens, and both KV stores read 0 pages: an attention-free model
has no KV leaves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ssd_scan as ref_ssd_pkg
from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced_config as ref_reduced_config
from repro.core.retry import RetryPolicy as RefPolicy
from repro.models import build_model as ref_build_model
from repro.models import ssm as REF_SSM
from repro.serving import ServeEngine as RefEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.retry import RetryPolicy
from repro_torch.models import build_model
from repro_torch.models import ssm as SSM
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ServeEngine

ARCH = "mamba2-130m"
F32_TOL = 1e-4
BF16_REL_TOL = 0.05
B, T = 2, 40          # two chunks of the reduced chunk 32
DECODE_STEPS = 6
PROMPTS = [np.array([5, 9, 11, 2], np.int32), np.array([7, 3], np.int32)]
MAX_NEW = 6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(params=["kernel", "off"])
def ref_mode(request, monkeypatch):
    """The reference's SSD path: its Pallas kernel in interpret mode, or
    its default jnp path; counts the reference's kernel entry calls."""
    calls = []
    if request.param == "kernel":
        monkeypatch.setenv("REPRO_PALLAS_SSD", "1")
        entry = ref_ssd_pkg.ssd_scan

        def counted(*a, **kw):
            calls.append(1)
            return entry(*a, **kw)

        monkeypatch.setattr(ref_ssd_pkg, "ssd_scan", counted)
    else:
        monkeypatch.delenv("REPRO_PALLAS_SSD", raising=False)
    assert REF_SSM._pallas_ssd_mode() == request.param
    yield request.param, calls
    if request.param == "kernel":
        assert calls, "the reference never reached its Pallas kernel"


def _cfgs(act):
    ref = dataclasses.replace(ref_reduced_config(ref_get_config(ARCH)),
                              activation_dtype=act)
    port = dataclasses.replace(reduced_config(get_config(ARCH)),
                               activation_dtype=act)
    return ref, port


_PARAMS = {}


def _ref_params():
    if "p" not in _PARAMS:
        ref_cfg, _ = _cfgs("float32")
        _PARAMS["p"] = jax.tree.map(
            np.asarray, ref_build_model(ref_cfg).init(jax.random.PRNGKey(0)))
    return _PARAMS["p"]


def _models(act):
    ref_cfg, cfg = _cfgs(act)
    ref = ref_build_model(ref_cfg)
    ref_params = jax.tree.map(jnp.asarray, _ref_params())
    return ref, ref_params, build_model(cfg, device="cpu"), \
        params_from_jax(_ref_params(), "cpu")


def _tokens(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def _close(got, want, tol):
    a = got.float().numpy()
    b = np.asarray(want).astype(np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def _assert_caches_close(got, want, tol):
    for u in got["units"]:
        for k in ("conv", "ssm"):
            _close(got["units"][u]["ssm"][k], want["units"][u]["ssm"][k], tol)
    assert sorted(got["units"]) == sorted(want["units"])


def test_ssm_block_matches_reference(ref_mode):
    """``ssm_fullseq`` and two ``ssm_decode`` steps of one layer, on the
    same normalized input."""
    ref_cfg, cfg = _cfgs("float32")
    p_np = jax.tree.map(lambda a: a[0], _ref_params()["units"]["b0"]["ssm"])
    p_ref = jax.tree.map(jnp.asarray, p_np)
    p = params_from_jax(p_np, "cpu")
    u = (0.5 * np.random.default_rng(3).standard_normal(
        (B, T, cfg.d_model))).astype(np.float32)
    want, want_c = jax.jit(lambda p, u: REF_SSM.ssm_fullseq(ref_cfg, p, u))(
        p_ref, jnp.asarray(u))
    got, c = SSM.ssm_fullseq(cfg, p, torch.from_numpy(u))
    _close(got, want, F32_TOL)
    assert c["conv"].shape == (B, cfg.ssm.d_conv - 1,
                               cfg.ssm.d_inner(cfg.d_model)
                               + 2 * cfg.ssm.d_state)
    assert c["ssm"].dtype == torch.float32
    for k in ("conv", "ssm"):
        _close(c[k], want_c[k], F32_TOL)
    decode = jax.jit(lambda p, u, c: REF_SSM.ssm_decode(ref_cfg, p, u, c))
    for step in range(2):
        ut = u[:, step:step + 1] * 1.5
        want, want_c = decode(p_ref, jnp.asarray(ut), want_c)
        got, c = SSM.ssm_decode(cfg, p, torch.from_numpy(ut), c)
        _close(got, want, F32_TOL)
        for k in ("conv", "ssm"):
            _close(c[k], want_c[k], F32_TOL)


def test_prefill_and_greedy_decode_float32(ref_mode):
    ref, ref_params, port, params = _models("float32")
    toks = _tokens(ref.cfg.vocab)
    want_logits, want_cache = jax.jit(ref.prefill)(
        ref_params, {"tokens": jnp.asarray(toks)})
    logits, cache = port.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert logits.dtype == torch.float32 and logits.shape == (B, 1,
                                                              ref.cfg.vocab)
    _close(logits, want_logits, F32_TOL)
    _assert_caches_close(cache, want_cache, F32_TOL)

    decode = jax.jit(ref.decode_step)
    tok_ref = np.asarray(jnp.argmax(want_logits[:, -1], -1))
    tok = logits[:, -1].argmax(-1).numpy()
    assert np.array_equal(tok, tok_ref)
    for step in range(DECODE_STEPS):
        want_logits, want_cache = decode(ref_params, {
            "token": jnp.asarray(tok_ref[:, None]), "pos": T + step,
            "cache": want_cache})
        logits, cache = port.decode_step(params, {
            "token": torch.from_numpy(tok[:, None]).long(), "pos": T + step,
            "cache": cache})
        _close(logits, want_logits, F32_TOL)
        tok_ref = np.asarray(jnp.argmax(want_logits[:, -1], -1))
        tok = logits[:, -1].argmax(-1).numpy()
        assert np.array_equal(tok, tok_ref), step
    _assert_caches_close(cache, want_cache, F32_TOL)


def test_prefill_bfloat16_logits():
    ref, ref_params, port, params = _models("bfloat16")
    toks = _tokens(ref.cfg.vocab, seed=1)
    want, _ = jax.jit(ref.prefill)(ref_params, {"tokens": jnp.asarray(toks)})
    got, cache = port.prefill(params, {"tokens": torch.from_numpy(toks)})
    want = np.asarray(want)
    gap = np.abs(got.numpy() - want).max() / np.abs(want).max()
    print(f"bf16 prefill logits gap {gap:.3g} of the largest")
    assert gap <= BF16_REL_TOL
    assert cache["units"]["b0"]["ssm"]["conv"].dtype == torch.bfloat16
    assert cache["units"]["b0"]["ssm"]["ssm"].dtype == torch.float32


@pytest.mark.parametrize("mechanism", ["pr2ar2", "baseline"])
def test_serve_engine_matches_reference(ref_mode, mechanism):
    ref_cfg, cfg = _cfgs("float32")
    ref_params = jax.tree.map(jnp.asarray, _ref_params())
    params = params_from_jax(_ref_params(), "cpu")
    want, want_st = RefEngine(ref_cfg, params=ref_params,
                              policy=RefPolicy(mechanism)).generate(
        PROMPTS, max_new_tokens=MAX_NEW)
    eng = ServeEngine(cfg, params=params, policy=RetryPolicy(mechanism),
                      device="cpu")
    got, st = eng.generate(PROMPTS, max_new_tokens=MAX_NEW)
    assert got.shape == (len(PROMPTS), MAX_NEW)
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(st.kv) == dataclasses.asdict(want_st.kv)
    assert st.kv.pages == 0 and st.kv.fast_fraction == 0.0
    assert eng.store.fast == {}          # nothing quantizable: passthrough


def test_params_from_jax_carries_ssm_leaves():
    params = params_from_jax(_ref_params(), "cpu")
    ref_leaves = _ref_params()["units"]["b0"]
    assert sorted(params["units"]["b0"]) == sorted(ref_leaves) == \
        ["ln1", "ssm"]
    for k, v in ref_leaves["ssm"].items():
        t = params["units"]["b0"]["ssm"][k]
        assert t.dtype == torch.float32 and tuple(t.shape) == v.shape
        assert np.array_equal(t.numpy(), v)


def test_seeded_init_matches_reference_layout():
    """The port's own draws: the reference's leaves, shapes and fixed
    values (a_log within an ulp), with softplus(dt_bias) in [1e-3,
    1e-1]."""
    _, cfg = _cfgs("float32")
    a = build_model(cfg, "cpu", torch.Generator().manual_seed(3)).init()
    b = build_model(cfg, "cpu", torch.Generator().manual_seed(3)).init()
    ref = _ref_params()["units"]["b0"]["ssm"]
    p = a["units"]["b0"]["ssm"]
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert torch.equal(p["in_proj"], b["units"]["b0"]["ssm"]["in_proj"])
    dt0 = torch.nn.functional.softplus(p["dt_bias"])
    assert bool(((dt0 >= 1e-3 * 0.999) & (dt0 <= 0.1 * 1.001)).all())
    for k in ("d_skip", "norm_scale", "conv_b"):
        assert np.array_equal(p[k].numpy(), ref[k]), k
    # log(1..nh): torch's and XLA's log differ by an ulp at some heads.
    np.testing.assert_allclose(p["a_log"].numpy(), ref["a_log"], rtol=1e-6)
