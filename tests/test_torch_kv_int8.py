"""The in-model int8 KV cache (``REPRO_KV_INT8=1``, ROADMAP D13) and the
KV retry read on int8 backing (kernel B3), against the JAX reference.

Held on the CPU, inputs made with numpy from a seed:

  * ``_quant_kv``, ``_dequant_kv`` and ``quantize_pages`` of int8
    leaves bitwise against the reference's;
  * ``kv_retry_plain`` and ``kv_retry_emulate`` on int8 backing against
    ``kv_retry_ref`` and the Pallas kernel in interpret mode: outputs bit
    for bit (a fast page is ``trunc(q * s)``, truncated toward zero as
    XLA's float-to-int8 convert does, so pages whose amax is below 127
    come out off their backing), 0 flipped decisions, margins within
    rtol 1e-6 (the reference forms the rms and the ratio in another
    order); the emulation and the wrapper equal the plain version bit for
    bit, margins too on the pages the in-model cache makes (amax 127,
    scale exactly 1, or all zero: their sums of squares are integers
    below 2^24, exact in any order), as the card must;
  * ``attention_fullseq`` and ``attention_decode`` with the flag in the
    causal, local and cross kinds: outputs within 1e-5, the scales
    within 1e-4 and the int8 data equal wherever the float value it
    quantizes does not sit within 1e-4 of a rounding boundary (the two
    packages' float K/V differ by ulps);
  * every family with attention (the archs of ``test_torch_models.py``,
    whisper-large-v3 and internvl2-1b) reduced: float32 prefill logits
    and caches, ``k_s``/``v_s`` included, within 1e-4, 6 equal greedy
    decode steps, bfloat16 logits within 5% of the largest;
  * ``ServeEngine`` tokens and ``KVReadStats`` equal to the reference's
    under pr2ar2 at tau 0.05 and 0.01 and under baseline, the store
    reading the int8 leaves through B3's plain version and passing the
    scales through.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced_config as ref_reduced_config
from repro.core.retry import RetryPolicy as RefPolicy
from repro.kernels.kv_retry.kernel import kv_retry_pallas
from repro.kernels.kv_retry.ops import quantize_pages as ref_quantize
from repro.kernels.kv_retry.ref import kv_retry_ref
from repro.models import attention as RA
from repro.models import build_model as ref_build_model
from repro.serving import ServeEngine as RefEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.retry import RetryPolicy
from repro_torch.kernels.kv_retry import ops as KV
from repro_torch.kernels.kv_retry.emulate import kv_retry_emulate
from repro_torch.kernels.kv_retry.plain import kv_retry_plain, quantize_pages
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.models.api import frontend_zeros
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ServeEngine
from repro_torch.serving.kv_store import QuantizedKVStore

#: Every family with attention, as ``test_torch_models.py`` and the
#: encoder-decoder and VLM files name them (recurrentgemma at a depth
#: with its tail).
ARCHS = ("llama3.2-3b", "gemma2-2b", "recurrentgemma-2b", "olmoe-1b-7b",
         "llama4-maverick-400b-a17b", "whisper-large-v3", "internvl2-1b")
_OVERRIDES = {"recurrentgemma-2b": dict(n_layers=8)}
F32_TOL = 1e-4
BF16_REL_TOL = 0.05
MARGIN_RTOL = 1e-6
B, T = 2, 40          # T > the reduced window of 32
DECODE_STEPS = 6
MAX_NEW = 6
PROMPTS = [np.arange(3, 43, dtype=np.int32) % 500 + 2,
           np.array([7, 3, 9], np.int32)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def int8_cache(monkeypatch):
    monkeypatch.setenv("REPRO_KV_INT8", "1")


# -- the quantizer ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 4, 40, 16), (3, 2, 1, 64),
                                   (1, 1, 7, 128)])
def test_quant_kv_matches_reference(dtype, shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0                                 # an all-zero vector
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    q, s = TA._quant_kv(t)
    qr, sr = RA._quant_kv(jx)
    assert q.dtype == torch.int8 and s.shape == shape[:-1] + (1,)
    assert np.array_equal(q.numpy(), np.asarray(qr))
    assert np.array_equal(s.numpy(), np.asarray(sr))
    got = TA._dequant_kv(q, s, t.dtype).float().numpy()
    want = np.asarray(RA._dequant_kv(qr, sr, jx.dtype).astype(jnp.float32))
    assert np.array_equal(got, want)


def _int8_pages(P, E, seed):
    """int8 pages of every kind the read must take: amax below 127
    (scale not 1: fast reads truncate), amax 127 (the in-model cache's),
    all zero, and spiky ones (one large value over small ones, so the
    margin turns negative and the page retries)."""
    rng = np.random.default_rng(seed)
    b = rng.integers(-100, 101, (P, E)).astype(np.int8)
    kind = rng.integers(0, 4, P)
    b[kind == 1, 0] = 127
    b[kind == 2] = 0
    spiky = np.flatnonzero(kind == 3)
    b[spiky] = rng.integers(-3, 4, (spiky.size, E))
    b[spiky, rng.integers(0, E, spiky.size)] = -127
    return torch.from_numpy(b), kind


@pytest.mark.parametrize("P,E", [(64, 16), (300, 64), (1037, 128),
                                 (100, 256)])
def test_quantize_pages_on_int8_leaves_bitwise(P, E):
    b, _ = _int8_pages(P, E, seed=P + E)
    q, s = quantize_pages(b)
    qr, sr = ref_quantize(jnp.asarray(b.numpy()))
    assert np.array_equal(q.numpy(), np.asarray(qr))
    assert np.array_equal(s.numpy(), np.asarray(sr))


@pytest.mark.parametrize("impl", ["plain", "emulate", "wrapper"])
@pytest.mark.parametrize("tau", [0.05, 0.01])
@pytest.mark.parametrize("P,E", [(300, 64), (1037, 128), (100, 16)])
def test_int8_backing_matches_reference(impl, tau, P, E):
    b, kind = _int8_pages(P, E, seed=7 * P + E)
    q, s = quantize_pages(b)
    fn = {"plain": kv_retry_plain, "emulate": kv_retry_emulate,
          "wrapper": KV.kv_retry_fwd}[impl]
    out, margin = fn(q, s, b, tau=tau)
    assert out.dtype == torch.int8 and margin.dtype == torch.float32
    jq, js, jb = (jnp.asarray(t.numpy()) for t in (q, s, b))
    exact = kind != 0          # integer dequant: sums exact in any order
    fast = margin.numpy()[:, 0] >= 0
    # Against the reference: outputs and decisions bit for bit, margins
    # within rtol 1e-6 (XLA forms the ratio in another order).
    for want_out, want_m in (kv_retry_ref(jq, js, jb, tau=tau),
                             kv_retry_pallas(jq, js, jb, tau=tau, bp=32,
                                             interpret=True)):
        want_m = np.asarray(want_m)
        assert np.array_equal(out.numpy(), np.asarray(want_out))
        assert np.array_equal(fast, want_m[:, 0] >= 0)
        tol = MARGIN_RTOL * np.maximum(np.abs(want_m), np.abs(1 - want_m))
        assert (np.abs(margin.numpy() - want_m) <= tol).all()
    # Against the plain version (what the card is held against), the
    # margins of integer pages are bit for bit in any summation order.
    plain_out, plain_m = kv_retry_plain(q, s, b, tau=tau)
    assert torch.equal(out, plain_out)
    assert torch.equal(margin[torch.from_numpy(exact)],
                       plain_m[torch.from_numpy(exact)])
    # Both branches (a page retries where amax / rms > 254 tau, which
    # pages of E <= 128 reach only below tau 0.06), and the truncation:
    # fast pages of amax < 127 come out as trunc(q * s), off their
    # backing where rint would restore it.
    assert fast.any() and (tau > 0.02 or (~fast).any())
    deq = q.float() * s
    trunc = fast & (kind == 0)
    assert np.array_equal(out.numpy()[trunc],
                          deq.trunc().to(torch.int8).numpy()[trunc])
    assert (out.numpy()[trunc] != b.numpy()[trunc]).any()
    assert np.array_equal(torch.round(deq).to(torch.int8).numpy()[trunc],
                          b.numpy()[trunc])
    # The in-model cache's pages read fast are exact.
    keep = fast & exact
    assert np.array_equal(out.numpy()[keep], b.numpy()[keep])


def test_int8_backing_retried_pages_copy_backing():
    b, kind = _int8_pages(200, 64, seed=11)
    q, s = quantize_pages(b)
    out, margin = kv_retry_plain(q, s, b, tau=0.01)
    retried = margin[:, 0] < 0
    assert retried.any() and bool((torch.from_numpy(kind == 3)
                                   [retried]).all())
    assert torch.equal(out[retried], b[retried])


# -- attention layers ---------------------------------------------------------


def _assert_int8_close(got, want, value, scale):
    """int8 data equal, except by one level where ``value / scale`` (the
    port's float input) lies within 1e-4 of a rounding boundary."""
    got, want = got.astype(np.int32), np.asarray(want).astype(np.int32)
    r = value / np.maximum(scale, 1e-30)
    near = np.abs(np.abs(r - np.floor(r)) - 0.5) < 1e-4
    diff = got != want
    assert (np.abs(got - want) <= 1).all()
    assert (~diff | near).all(), int((diff & ~near).sum())


def _layer(arch, seed=0):
    rcfg = dataclasses.replace(ref_reduced_config(ref_get_config(arch)),
                               activation_dtype="float32")
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              activation_dtype="float32")
    from repro.models.attention import attn_init

    p = jax.tree.map(np.asarray, attn_init(jax.random.PRNGKey(seed), rcfg))
    return rcfg, cfg, jax.tree.map(jnp.asarray, p), \
        {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("kind,arch", [("causal", "llama3.2-3b"),
                                       ("local", "gemma2-2b"),
                                       ("cross", "whisper-large-v3")])
def test_attention_int8_matches_reference(kind, arch, monkeypatch):
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    rcfg, cfg, rp, tp = _layer(arch)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    pos = np.arange(T, dtype=np.int32)
    kw, rkw = {}, {}
    if kind == "cross":
        enc = rng.standard_normal((B, 24, cfg.d_model)).astype(np.float32)
        epos = np.arange(24, dtype=np.int32)
        kw = dict(enc_out=torch.from_numpy(enc),
                  enc_positions=torch.from_numpy(epos))
        rkw = dict(enc_out=jnp.asarray(enc), enc_positions=jnp.asarray(epos))
    y, cache = TA.attention_fullseq(cfg, tp, torch.from_numpy(x),
                                    torch.from_numpy(pos), kind, **kw)
    ry, rcache = RA.attention_fullseq(rcfg, rp, jnp.asarray(x),
                                      jnp.asarray(pos), kind, **rkw)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=0, atol=1e-5)
    assert sorted(cache) == sorted(rcache) == ["k", "k_s", "v", "v_s"]
    assert cache["k"].dtype == torch.int8
    # The float cache the int8 one was made of, for the rounding rule.
    monkeypatch.setenv("REPRO_KV_INT8", "0")
    _, fcache = TA.attention_fullseq(cfg, tp, torch.from_numpy(x),
                                     torch.from_numpy(pos), kind, **kw)
    monkeypatch.setenv("REPRO_KV_INT8", "1")

    def check(cache, rcache, fcache):
        for n in ("k", "v"):
            np.testing.assert_allclose(cache[n + "_s"].numpy(),
                                       np.asarray(rcache[n + "_s"]),
                                       rtol=0, atol=F32_TOL)
            _assert_int8_close(cache[n].numpy(), rcache[n],
                               fcache[n].numpy(), cache[n + "_s"].numpy())

    check(cache, rcache, fcache)
    for step in range(3):
        xs = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        y, new = TA.attention_decode(cfg, tp, torch.from_numpy(xs), cache,
                                     T + step, kind)
        ry, rnew = RA.attention_decode(rcfg, rp, jnp.asarray(xs), rcache,
                                       jnp.int32(T + step), kind)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=0,
                                   atol=1e-5)
        assert sorted(new) == ["k", "k_s", "v", "v_s"]
        if kind == "cross":
            assert new is cache
        else:
            np.testing.assert_allclose(new["k_s"].numpy(),
                                       np.asarray(rnew["k_s"]), rtol=0,
                                       atol=F32_TOL)
            assert new["k"].dtype == torch.int8
            assert not torch.equal(new["k"], cache["k"])
        cache, rcache = new, rnew


def test_bidirectional_layer_keeps_no_cache_with_the_flag(int8_cache):
    _, cfg, _, tp = _layer("whisper-large-v3")
    x = torch.zeros((B, 5, cfg.d_model))
    y, cache = TA.attention_fullseq(cfg, tp, x, torch.arange(5), "bidir")
    assert cache is None and y.shape == x.shape


def test_flag_is_read_at_each_call(monkeypatch):
    _, cfg, _, tp = _layer("llama3.2-3b")
    x = torch.randn((B, 5, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    pos = torch.arange(5, dtype=torch.int32)
    for flag, keys in (("1", ["k", "k_s", "v", "v_s"]), ("0", ["k", "v"])):
        monkeypatch.setenv("REPRO_KV_INT8", flag)
        _, cache = TA.attention_fullseq(cfg, tp, x, pos, "causal")
        assert sorted(cache) == keys


# -- whole models -------------------------------------------------------------


_PARAMS = {}


def _models(arch, act):
    kw = dict(activation_dtype=act, **_OVERRIDES.get(arch, {}))
    rcfg = dataclasses.replace(ref_reduced_config(ref_get_config(arch)), **kw)
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **kw)
    ref = ref_build_model(rcfg)
    if arch not in _PARAMS:
        _PARAMS[arch] = jax.tree.map(np.asarray,
                                     ref.init(jax.random.PRNGKey(0)))
    return (ref, jax.tree.map(jnp.asarray, _PARAMS[arch]),
            build_model(cfg, device="cpu"),
            params_from_jax(_PARAMS[arch], "cpu"))


def _batch(cfg, seed=0):
    """A prefill batch of ``cfg``'s family with seeded frontend inputs:
    (reference batch, port batch, the first decode position)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    for name, v in frontend_zeros(cfg, B, "cpu", torch.float32).items():
        out[name] = rng.standard_normal(tuple(v.shape)).astype(np.float32)
    pos0 = T + (cfg.n_patches if cfg.family == "vlm" else 0)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()}, pos0)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _assert_caches_close(got, want, floats=None):
    """Every leaf within 1e-4 (the scales as floats, int8 leaves stay
    int8).  The int8 data: equal wherever the port's float value (the
    leaf of ``floats``, the same prefill without the flag) does not sit
    within 1e-4 of a rounding boundary, one level apart there; without
    ``floats`` (caches written by decode), at most one level apart on at
    most 1e-3 of the elements (float32 ulps move about 2e-4 of them
    across a boundary).  Returns the number of scale leaves."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    f = None if floats is None else dict(_leaves(floats))
    assert g.keys() == w.keys()
    for path in w:
        want_leaf = np.asarray(w[path])
        assert (g[path].dtype == torch.int8) == (want_leaf.dtype == np.int8)
        if want_leaf.dtype != np.int8:
            np.testing.assert_allclose(g[path].numpy(), want_leaf, rtol=0,
                                       atol=F32_TOL, err_msg=str(path))
        elif f is not None:
            scale = g[path[:-1] + (path[-1] + "_s",)].numpy()
            _assert_int8_close(g[path].numpy(), want_leaf,
                               f[path].numpy(), scale)
        else:
            diff = np.abs(g[path].numpy().astype(np.int32) - want_leaf)
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, path
    return sum(1 for p in w if p[-1] in ("k_s", "v_s"))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_float32(arch, monkeypatch):
    ref, ref_params, port, params = _models(arch, "float32")
    rbatch, tbatch, pos0 = _batch(port.cfg)
    _, floats = port.prefill(params, tbatch)
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    want_logits, want_cache = jax.jit(ref.prefill)(ref_params, rbatch)
    logits, cache = port.prefill(params, tbatch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=F32_TOL)
    assert _assert_caches_close(cache, want_cache, floats) > 0
    decode = jax.jit(ref.decode_step)
    tok_ref = np.asarray(jnp.argmax(want_logits[:, -1], -1))
    tok = logits[:, -1].argmax(-1).numpy()
    assert np.array_equal(tok, tok_ref)
    for step in range(DECODE_STEPS):
        want_logits, want_cache = decode(ref_params, {
            "token": jnp.asarray(tok_ref[:, None]),
            "pos": jnp.int32(pos0 + step), "cache": want_cache})
        logits, cache = port.decode_step(params, {
            "token": torch.from_numpy(tok[:, None]), "pos": pos0 + step,
            "cache": cache})
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                                   rtol=0, atol=F32_TOL)
        tok_ref = np.asarray(jnp.argmax(want_logits[:, -1], -1))
        tok = logits[:, -1].argmax(-1).numpy()
        assert np.array_equal(tok, tok_ref), step
    _assert_caches_close(cache, want_cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_first_decode_bfloat16(arch, int8_cache):
    ref, ref_params, port, params = _models(arch, "bfloat16")
    rbatch, tbatch, pos0 = _batch(port.cfg, seed=1)
    rbatch = {k: v.astype(jnp.bfloat16) if v.dtype == jnp.float32 else v
              for k, v in rbatch.items()}
    tbatch = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
              for k, v in tbatch.items()}
    want_logits, want_cache = jax.jit(ref.prefill)(ref_params, rbatch)
    logits, cache = port.prefill(params, tbatch)
    for path, leaf in _leaves(cache):
        if path[-1] in ("k", "v") and any(k in ("attn", "xattn")
                                          for k in path):
            assert leaf.dtype == torch.int8, path
    want = np.asarray(want_logits)
    gaps = [float(np.abs(logits.numpy() - want).max() / np.abs(want).max())]
    tok = np.array(jnp.argmax(want_logits[:, -1], -1))
    want_logits, _ = jax.jit(ref.decode_step)(ref_params, {
        "token": jnp.asarray(tok[:, None]), "pos": jnp.int32(pos0),
        "cache": want_cache})
    logits, _ = port.decode_step(params, {
        "token": torch.from_numpy(tok[:, None]), "pos": pos0,
        "cache": cache})
    want = np.asarray(want_logits)
    gaps.append(float(np.abs(logits.numpy() - want).max()
                      / np.abs(want).max()))
    print(f"{arch} bfloat16 int8 cache: prefill logits gap {gaps[0]:.4f}, "
          f"first decode {gaps[1]:.4f} of the largest logit")
    assert max(gaps) <= BF16_REL_TOL


# -- the serving engine -------------------------------------------------------


_ENGINE_PARAMS = {}


def _engines(arch, mechanism, tau):
    kw = dict(activation_dtype="float32", **_OVERRIDES.get(arch, {}))
    rcfg = dataclasses.replace(ref_reduced_config(ref_get_config(arch)), **kw)
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **kw)
    if arch not in _ENGINE_PARAMS:
        _ENGINE_PARAMS[arch] = jax.tree.map(
            np.asarray, ref_build_model(rcfg).init(jax.random.PRNGKey(1)))
    p = _ENGINE_PARAMS[arch]
    return (RefEngine(rcfg, params=jax.tree.map(jnp.asarray, p),
                      policy=RefPolicy(mechanism), tau=tau),
            ServeEngine(cfg, params=params_from_jax(p, "cpu"),
                        policy=RetryPolicy(mechanism), tau=tau,
                        device="cpu"))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mechanism,tau", [("pr2ar2", 0.05),
                                           ("pr2ar2", 0.01),
                                           ("baseline", 0.05)])
def test_engine_matches_reference(arch, mechanism, tau, int8_cache):
    ref, port = _engines(arch, mechanism, tau)
    want, want_st = ref.generate(PROMPTS, max_new_tokens=MAX_NEW)
    got, st = port.generate(PROMPTS, max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(st.kv) == dataclasses.asdict(want_st.kv)
    assert (st.kv.fast_pages > 0) == (mechanism != "baseline")
    # The store read int8 leaves, hd values a page, and kept the scales.
    leaves = dict(_leaves(port.store.backing))
    assert any(p[-1] == "k_s" for p in leaves)
    if mechanism != "baseline":
        assert all(port.store.fast[k][0].shape[1] == port.cfg.resolved_head_dim
                   for k in port.store.fast)
        assert not any(k.endswith("_s']") for k in port.store.fast)
    print(f"{arch} {mechanism} tau={tau} int8 cache: {st.summary()}")


def test_store_passes_scales_through_and_reads_int8_leaves(int8_cache):
    _, port = _engines("llama3.2-3b", "pr2ar2", 0.05)
    _, cache = port.model.prefill(port.params, {
        "tokens": torch.from_numpy(np.stack([PROMPTS[0][:5],
                                             PROMPTS[0][5:10]]))})
    store = QuantizedKVStore(RetryPolicy("pr2ar2"), tau=0.05)
    store.pack(cache)
    out = store.materialize()
    for path, leaf in _leaves(cache):
        got = dict(_leaves(out))[path]
        assert got.dtype == leaf.dtype, path
        if path[-1] in ("k_s", "v_s"):
            assert got is leaf
        else:
            # scale-1 and all-zero pages read fast are exact.
            assert torch.equal(got, leaf), path
    assert store.stats.pages == sum(
        leaf.numel() // leaf.shape[-1] for p, leaf in _leaves(cache)
        if p[-1] in ("k", "v"))
