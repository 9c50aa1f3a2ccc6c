"""Port's decoder LM (configs, common, attention, rglru, moe, blocks, lm,
api) against the JAX reference.

Reduced ``llama3.2-3b`` (global attention, swiglu; also with ``qk_norm``),
``gemma2-2b`` (alternating local/global, both softcaps, geglu, scaled
embeddings), ``recurrentgemma-2b`` at 8 layers (two units of RG-LRU,
RG-LRU, local MQA attention, then a tail of two RG-LRU layers),
``olmoe-1b-7b`` (softmax-routed MoE in every layer, qk-norm) and
``llama4-maverick-400b-a17b`` (sigmoid-routed MoE with a shared expert
in every second layer), with prompts longer than the reduced window of
32.  Parameters come
from the reference's ``init`` through ``params_from_jax``; tokens are
made with numpy from a seed.  The reference's CPU prefill runs its
blockwise/windowed scans; the port's runs the flash-attention wrapper
(the kernel's plain version on the CPU), so these tests hold the port's
kernel path against the reference's fallback.

Tolerances: with float32 activations, prefill logits and caches within
1e-4, and 6 greedy decode steps give equal tokens (logits within 1e-4).
With bfloat16 activations the two round at other places (the reference's
blockwise path rounds p to bfloat16 before P·V; the kernel keeps it in
float32), so logits are held within 5% of the logits' largest magnitude
(about 1.6% measured for both architectures; the test prints its gap).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced_config as ref_reduced_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax

MODEL_ARCHS = ("llama3.2-3b", "gemma2-2b")
#: The RG-LRU and MoE families; recurrentgemma at a depth with a tail
#: (its reduced config has 6 layers, two whole units).
NEW_ARCHS = ("recurrentgemma-2b", "olmoe-1b-7b", "llama4-maverick-400b-a17b")
_OVERRIDES = {"recurrentgemma-2b": dict(n_layers=8)}
F32_TOL = 1e-4
BF16_REL_TOL = 0.05
B, T = 2, 40          # T > gemma2's reduced window (32)
DECODE_STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, act, qk_norm=None):
    """Reference and port configs of ``arch`` reduced, in ``act``
    (``qk_norm`` None: the config's own)."""
    kw = dict(activation_dtype=act, **_OVERRIDES.get(arch, {}))
    if qk_norm is not None:
        kw["qk_norm"] = qk_norm
    ref = dataclasses.replace(ref_reduced_config(ref_get_config(arch)), **kw)
    port = dataclasses.replace(reduced_config(get_config(arch)), **kw)
    return ref, port


_PARAMS = {}


def _models(arch, act, qk_norm=None):
    """Reference and port models over the same (reference-drawn) weights."""
    ref_cfg, cfg = _cfgs(arch, act, qk_norm)
    ref = ref_build_model(ref_cfg)
    key = (arch, qk_norm)
    if key not in _PARAMS:
        _PARAMS[key] = jax.tree.map(np.asarray,
                                    ref.init(jax.random.PRNGKey(0)))
    ref_params = jax.tree.map(jnp.asarray, _PARAMS[key])
    port = build_model(cfg, device="cpu")
    return ref, ref_params, port, params_from_jax(_PARAMS[key], "cpu")


def _tokens(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _assert_caches_close(got, want, tol):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for path in w:
        a = g[path].float().numpy()
        b = np.asarray(w[path]).astype(np.float32)
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=str(path))


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_configs_equal(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        ref_get_config(arch))
    assert dataclasses.asdict(reduced_config(get_config(arch))) == \
        dataclasses.asdict(ref_reduced_config(ref_get_config(arch)))
    assert sorted(ARCHS) == sorted(REF_ARCHS)


@pytest.mark.parametrize("arch,qk_norm", [(a, False) for a in MODEL_ARCHS]
                         + [("llama3.2-3b", True)]
                         + [(a, None) for a in NEW_ARCHS])
def test_prefill_and_greedy_decode_float32(arch, qk_norm):
    ref, ref_params, port, params = _models(arch, "float32", qk_norm)
    toks = _tokens(ref.cfg.vocab)
    want_logits, want_cache = jax.jit(ref.prefill)(
        ref_params, {"tokens": jnp.asarray(toks)})
    logits, cache = port.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert logits.dtype == torch.float32 and logits.shape == (B, 1,
                                                              ref.cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=F32_TOL)
    _assert_caches_close(cache, want_cache, F32_TOL)

    decode = jax.jit(ref.decode_step)
    tok_ref = np.asarray(jnp.argmax(want_logits[:, -1], -1))
    tok = logits[:, -1].argmax(-1).numpy()
    assert np.array_equal(tok, tok_ref)
    for step in range(DECODE_STEPS):
        want_logits, want_cache = decode(ref_params, {
            "token": jnp.asarray(tok_ref[:, None]), "pos": jnp.int32(T + step),
            "cache": want_cache})
        logits, cache = port.decode_step(params, {
            "token": torch.from_numpy(tok[:, None]), "pos": T + step,
            "cache": cache})
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                                   rtol=0, atol=F32_TOL)
        tok_ref = np.asarray(jnp.argmax(want_logits[:, -1], -1))
        tok = logits[:, -1].argmax(-1).numpy()
        assert np.array_equal(tok, tok_ref), step
    _assert_caches_close(cache, want_cache, F32_TOL)


@pytest.mark.parametrize("arch", MODEL_ARCHS + NEW_ARCHS)
def test_prefill_and_first_decode_bfloat16(arch):
    ref, ref_params, port, params = _models(arch, "bfloat16")
    toks = _tokens(ref.cfg.vocab, seed=1)
    want_logits, want_cache = jax.jit(ref.prefill)(
        ref_params, {"tokens": jnp.asarray(toks)})
    logits, cache = port.prefill(params, {"tokens": torch.from_numpy(toks)})
    for path, leaf in _leaves(cache):
        # The RG-LRU state is float32 in both packages.
        want = torch.float32 if path[-1] == "h" else torch.bfloat16
        assert leaf.dtype == want, path
    want = np.asarray(want_logits)
    gaps = [float(np.abs(logits.numpy() - want).max() / np.abs(want).max())]
    tok = np.array(jnp.argmax(want_logits[:, -1], -1))
    want_logits, _ = jax.jit(ref.decode_step)(ref_params, {
        "token": jnp.asarray(tok[:, None]), "pos": jnp.int32(T),
        "cache": want_cache})
    logits, _ = port.decode_step(params, {
        "token": torch.from_numpy(tok[:, None]), "pos": T, "cache": cache})
    want = np.asarray(want_logits)
    gaps.append(float(np.abs(logits.numpy() - want).max()
                      / np.abs(want).max()))
    print(f"{arch} bfloat16: prefill logits gap {gaps[0]:.4f}, first decode "
          f"{gaps[1]:.4f} of the largest logit")
    assert max(gaps) <= BF16_REL_TOL


def test_stacked_unit_layout():
    _, _, port, params = _models("gemma2-2b", "float32")
    U = port.cfg.unit_count()
    assert params["units"]["b0"]["attn"]["wq"].shape[0] == U
    _, cache = port.prefill(params, {"tokens": torch.from_numpy(
        _tokens(port.cfg.vocab))})
    k = cache["units"]["b0"]["attn"]["k"]          # local: the window ring
    assert k.shape == (U, B, port.cfg.n_kv_heads, port.cfg.window,
                       port.cfg.resolved_head_dim)
    assert cache["units"]["b1"]["attn"]["k"].shape[3] == T


def test_seeded_init_is_reproducible():
    cfg = reduced_config(get_config("llama3.2-3b"))
    a = build_model(cfg, "cpu", torch.Generator().manual_seed(3)).init()
    b = build_model(cfg, "cpu", torch.Generator().manual_seed(3)).init()
    wq = a["units"]["b0"]["attn"]["wq"]
    assert torch.equal(wq, b["units"]["b0"]["attn"]["wq"])
    assert wq.dtype == torch.float32 and wq.abs().max() <= 2 * 64 ** -0.5
    assert not a["final_norm"]["scale"].any()


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-1b"])
def test_encdec_and_vlm_configs_build(arch):
    """``build_model`` takes the published encoder-decoder and VLM
    configs (no parameters drawn at full size here), and at the reduced
    size the port's init holds the config's analytic count of matrix
    parameters (``n_params`` leaves out norms and learned positions)."""
    cfg = get_config(arch)
    assert build_model(cfg, "cpu").cfg is cfg
    small = reduced_config(cfg)
    params = build_model(small, "cpu", torch.Generator().manual_seed(1)).init()
    n = sum(t.numel() for path, t in _leaves(params)
            if path[-1] not in ("scale", "bias", "pos_embed"))
    assert n == small.n_params()
    assert ("pos_embed" in params) == (arch == "whisper-large-v3")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_configs_build(arch):
    """``build_model`` takes the published RG-LRU and MoE configs (no
    parameters drawn at full size here)."""
    cfg = get_config(arch)
    model = build_model(cfg, "cpu")
    assert model.cfg is cfg
    assert bool(cfg.tail_pattern()) == (arch == "recurrentgemma-2b")


def test_pattern_tail_layout():
    """A tailed recurrentgemma keeps the reference's tree: stacked units
    plus plain lists for the tail's parameters and caches."""
    ref, ref_params, port, params = _models("recurrentgemma-2b", "float32")
    cfg = port.cfg
    assert cfg.unit_count() == 2 and cfg.tail_pattern() == ("rglru",) * 2
    assert isinstance(params["tail"], list) and len(params["tail"]) == 2
    _, cache = port.prefill(params, {"tokens": torch.from_numpy(
        _tokens(cfg.vocab))})
    assert [sorted(c) for c in cache["tail"]] == [["rglru"], ["rglru"]]
    assert cache["tail"][1]["rglru"]["h"].shape == (B, cfg.rglru.lru_width)
    assert cache["units"]["b2"]["attn"]["k"].shape == (
        2, B, cfg.n_kv_heads, cfg.window, cfg.resolved_head_dim)
    own = build_model(cfg, "cpu").init()
    assert [sorted(t) for t in own["tail"]] == [
        sorted(t) for t in ref_params["tail"]]
