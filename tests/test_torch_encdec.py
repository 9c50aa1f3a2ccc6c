"""Port's encoder-decoder family (``models.encdec``, bidirectional and
cross attention, the cross sub-block) against the JAX reference.

Reduced ``whisper-large-v3`` (2 encoder and 2 decoder layers, d 64, 4
heads of hd 16, 16 encoder frames, LayerNorm, GELU, tied unembedding,
no rope).  Parameters come from the reference's ``init`` through
``params_from_jax``; tokens and frame embeddings are made with numpy
from a seed.  The reference's CPU prefill runs its blockwise scans; the
port's runs the flash-attention wrapper (the kernel's plain version on
the CPU: non-causal for the encoder and cross attention), so these
tests hold the port's kernel path against the reference's fallback.

Tolerances: ``sinusoids`` within 1e-5 at the reduced and the published
shapes (its timescales take XLA's float32 ``exp``: bit for bit), the
encoder output and single attention layers within 1e-5; in float32 the
prefill logits and every cache leaf (``attn`` and ``xattn``) within
1e-4, and 6 greedy decode steps give equal tokens (logits within 1e-4);
with bfloat16 activations logits within 5% of the largest (the
reference's blockwise path rounds p to bfloat16 before P·V, the
kernel's plain version keeps it in float32); ``train_loss`` within rtol
1e-5 and each gradient leaf within rtol 1e-5 plus 1e-5 of the leaf's
largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced_config as ref_reduced_config
from repro.models import attention as RA
from repro.models import build_model as ref_build_model
from repro.models.encdec import encode as ref_encode
from repro.models.encdec import sinusoids as ref_sinusoids
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.encdec import encode, sinusoids
from repro_torch.optim.adamw import tree_leaves, tree_map

ARCH = "whisper-large-v3"
F32_TOL = 1e-4
LAYER_TOL = 1e-5
BF16_REL_TOL = 0.05
B, T = 2, 12
DECODE_STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(act):
    return (dataclasses.replace(ref_reduced_config(ref_get_config(ARCH)),
                                activation_dtype=act),
            dataclasses.replace(reduced_config(get_config(ARCH)),
                                activation_dtype=act))


_PARAMS = {}


def _models(act):
    """Reference and port models over the same (reference-drawn) weights."""
    ref_cfg, cfg = _cfgs(act)
    ref = ref_build_model(ref_cfg)
    if "p" not in _PARAMS:
        _PARAMS["p"] = jax.tree.map(np.asarray,
                                    ref.init(jax.random.PRNGKey(0)))
    return (ref, jax.tree.map(jnp.asarray, _PARAMS["p"]),
            build_model(cfg, device="cpu"), params_from_jax(_PARAMS["p"],
                                                            "cpu"))


def _inputs(cfg, seed=0, t=T):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, t)).astype(np.int32)
    audio = rng.standard_normal((B, cfg.enc_positions, cfg.d_model)).astype(
        np.float32)
    return toks, audio


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
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


@pytest.mark.parametrize("length,channels", [(16, 64), (1500, 1280),
                                             (448, 1280), (40, 64)])
def test_sinusoids_match_reference(length, channels):
    want = np.asarray(ref_sinusoids(length, channels))
    got = sinusoids(length, channels).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LAYER_TOL)


def test_encode_matches_reference():
    ref, ref_params, port, params = _models("float32")
    _, audio = _inputs(port.cfg)
    want = np.asarray(jax.jit(lambda p, a: ref_encode(ref.cfg, p, a))(
        ref_params, jnp.asarray(audio)))
    got = encode(port.cfg, params, torch.from_numpy(audio))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LAYER_TOL)


def _layer(seed=0):
    """One attention layer's reference-drawn weights, in both packages."""
    ref_cfg, cfg = _cfgs("float32")
    p = jax.tree.map(np.asarray, RA.attn_init(jax.random.PRNGKey(seed),
                                              ref_cfg))
    return ref_cfg, cfg, jax.tree.map(jnp.asarray, p), params_from_jax(p,
                                                                       "cpu")


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("t", [1, 5, 16, 37, 40])
def test_bidirectional_attention_matches_reference(t):
    ref_cfg, cfg, rp, tp = _layer()
    x = _rand(np.random.default_rng(t), B, t, cfg.d_model)
    pos = np.arange(t, dtype=np.int32)
    want, _ = RA.attention_fullseq(ref_cfg, rp, jnp.asarray(x),
                                   jnp.asarray(pos), "bidir",
                                   return_cache=False)
    got, cache = TA.attention_fullseq(cfg, tp, torch.from_numpy(x),
                                      torch.from_numpy(pos), "bidir")
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LAYER_TOL)


@pytest.mark.parametrize("s", [16, 40])
@pytest.mark.parametrize("t", [1, 5, 37])
def test_cross_attention_and_its_decode_match_reference(t, s):
    """Prefill cross attention of t queries over s encoder positions (and
    its static cache), then two decode steps of the cross branch."""
    ref_cfg, cfg, rp, tp = _layer(1)
    rng = np.random.default_rng(100 * t + s)
    x, enc = _rand(rng, B, t, cfg.d_model), _rand(rng, B, s, cfg.d_model)
    pos, epos = np.arange(t, dtype=np.int32), np.arange(s, dtype=np.int32)
    want, want_c = RA.attention_fullseq(
        ref_cfg, rp, jnp.asarray(x), jnp.asarray(pos), "cross",
        enc_out=jnp.asarray(enc), enc_positions=jnp.asarray(epos))
    got, cache = TA.attention_fullseq(
        cfg, tp, torch.from_numpy(x), torch.from_numpy(pos), "cross",
        torch.from_numpy(enc), torch.from_numpy(epos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LAYER_TOL)
    assert cache["k"].shape == (B, cfg.n_kv_heads, s, cfg.resolved_head_dim)
    _assert_caches_close(cache, want_c, LAYER_TOL)
    for step in range(2):
        xd = _rand(rng, B, 1, cfg.d_model)
        want, want_c = RA.attention_decode(ref_cfg, rp, jnp.asarray(xd),
                                           want_c, jnp.int32(t + step),
                                           "cross")
        got, new = TA.attention_decode(cfg, tp, torch.from_numpy(xd), cache,
                                       t + step, "cross")
        assert new is cache
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LAYER_TOL)


def test_prefill_and_greedy_decode_float32():
    ref, ref_params, port, params = _models("float32")
    toks, audio = _inputs(port.cfg)
    want_logits, want_cache = jax.jit(ref.prefill)(
        ref_params, {"tokens": jnp.asarray(toks),
                     "audio_embed": jnp.asarray(audio)})
    logits, cache = port.prefill(params, {
        "tokens": torch.from_numpy(toks),
        "audio_embed": torch.from_numpy(audio)})
    assert logits.dtype == torch.float32 and logits.shape == (
        B, 1, port.cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=F32_TOL)
    assert sorted(cache["units"]["b0"]) == ["attn", "xattn"]
    assert cache["units"]["b0"]["xattn"]["k"].shape == (
        port.cfg.unit_count(), B, port.cfg.n_kv_heads, port.cfg.enc_positions,
        port.cfg.resolved_head_dim)
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


def test_learned_position_is_clamped_as_in_the_reference():
    """A decode step past the learned-position table reads its last row,
    as the reference's ``dynamic_slice_in_dim`` clamps."""
    ref, ref_params, port, params = _models("float32")
    toks, audio = _inputs(port.cfg, seed=3, t=4)
    _, want_cache = ref.prefill(ref_params, {
        "tokens": jnp.asarray(toks), "audio_embed": jnp.asarray(audio)})
    _, cache = port.prefill(params, {"tokens": torch.from_numpy(toks),
                                     "audio_embed": torch.from_numpy(audio)})
    pos = port.cfg.max_positions + 5
    want, _ = ref.decode_step(ref_params, {
        "token": jnp.asarray(toks[:, :1]), "pos": jnp.int32(pos),
        "cache": want_cache})
    got, _ = port.decode_step(params, {"token": torch.from_numpy(toks[:, :1]),
                                       "pos": pos, "cache": cache})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_TOL)


def test_prefill_and_first_decode_bfloat16():
    ref, ref_params, port, params = _models("bfloat16")
    toks, audio = _inputs(port.cfg, seed=1)
    want_logits, want_cache = jax.jit(ref.prefill)(
        ref_params, {"tokens": jnp.asarray(toks),
                     "audio_embed": jnp.asarray(audio, jnp.bfloat16)})
    logits, cache = port.prefill(params, {
        "tokens": torch.from_numpy(toks),
        "audio_embed": torch.from_numpy(audio).to(torch.bfloat16)})
    for path, leaf in _leaves(cache):
        assert leaf.dtype == torch.bfloat16, path
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
    print(f"{ARCH} bfloat16: prefill logits gap {gaps[0]:.4f}, first decode "
          f"{gaps[1]:.4f} of the largest logit")
    assert max(gaps) <= BF16_REL_TOL


def test_train_loss_and_gradients_match_reference():
    ref, _, port, _ = _models("float32")
    params = _PARAMS["p"]
    toks, audio = _inputs(port.cfg, seed=2)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "audio_embed": audio}
    loss, grads = jax.value_and_grad(ref.train_loss)(params, batch)
    tp = tree_map(lambda p: p.requires_grad_(True),
                  params_from_jax(params, device="cpu"))
    tloss = port.train_loss(tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    want = [np.asarray(g) for g in jax.tree.leaves(grads)]
    got = [p.grad.numpy() for p in tree_leaves(tp)]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    # The cross sub-block and the encoder are trained.
    assert tp["dec_units"]["b0"]["xattn"]["wk"].grad.abs().max() > 0
    assert tp["enc_units"]["b0"]["attn"]["wq"].grad.abs().max() > 0


def test_layout_matches_reference():
    """The port's own init has the reference's tree: the same keys,
    shapes and leaf order."""
    _, ref_params, port, _ = _models("float32")
    own = port.init()
    want = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    got = list(_leaves(own))
    assert [jax.tree_util.keystr(p) for p, _ in want] == [
        "".join(f"[{k!r}]" for k in p) for p, _ in got]
    for (_, w), (_, g) in zip(want, got):
        assert tuple(w.shape) == tuple(g.shape) and g.dtype == torch.float32
    assert own["pos_embed"].shape == (port.cfg.max_positions,
                                      port.cfg.d_model)
