"""Port's VLM family (the decoder LM over a prepended patch prefix)
against the JAX reference.

Reduced ``internvl2-1b`` (2 layers, d 64, 4 query heads over 2 KV heads
of hd 16, swiglu, rope, tied unembedding, 8 patch embeddings in front
of the tokens).  Parameters come from the reference's ``init`` through
``params_from_jax``; tokens and patch embeddings are made with numpy
from a seed.  The reference's CPU prefill runs its blockwise scan; the
port's runs the flash-attention wrapper (the kernel's plain version on
the CPU, causal at G 2).

Tolerances, as for the decoder family: in float32 the prefill logits
and cache within 1e-4 and 6 greedy decode steps (from position
n_patches + T) give equal tokens; with bfloat16 activations logits
within 5% of the largest; ``train_loss`` (over the token rows only)
within rtol 1e-5 and each gradient leaf within rtol 1e-5 plus 1e-5 of
the leaf's largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced_config as ref_reduced_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import tree_leaves, tree_map

ARCH = "internvl2-1b"
F32_TOL = 1e-4
BF16_REL_TOL = 0.05
B, T = 2, 40
DECODE_STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_PARAMS = {}


def _models(act):
    kw = dict(activation_dtype=act)
    ref_cfg = dataclasses.replace(ref_reduced_config(ref_get_config(ARCH)),
                                  **kw)
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), **kw)
    ref = ref_build_model(ref_cfg)
    if "p" not in _PARAMS:
        _PARAMS["p"] = jax.tree.map(np.asarray,
                                    ref.init(jax.random.PRNGKey(0)))
    return (ref, jax.tree.map(jnp.asarray, _PARAMS["p"]),
            build_model(cfg, device="cpu"), params_from_jax(_PARAMS["p"],
                                                            "cpu"))


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    patches = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(
        np.float32)
    return toks, patches


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


def test_prefill_and_greedy_decode_float32():
    ref, ref_params, port, params = _models("float32")
    cfg = port.cfg
    toks, patches = _inputs(cfg)
    want_logits, want_cache = jax.jit(ref.prefill)(
        ref_params, {"tokens": jnp.asarray(toks),
                     "patches": jnp.asarray(patches)})
    logits, cache = port.prefill(params, {
        "tokens": torch.from_numpy(toks),
        "patches": torch.from_numpy(patches)})
    assert logits.shape == (B, 1, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=F32_TOL)
    # The cache holds the patch slots and the token slots.
    assert cache["units"]["b0"]["attn"]["k"].shape == (
        cfg.unit_count(), B, cfg.n_kv_heads, cfg.n_patches + T,
        cfg.resolved_head_dim)
    _assert_caches_close(cache, want_cache, F32_TOL)

    decode = jax.jit(ref.decode_step)
    pos0 = cfg.n_patches + T
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
    _assert_caches_close(cache, want_cache, F32_TOL)


def test_patches_change_the_logits():
    """The prefix is attended to: other patches, other logits."""
    _, _, port, params = _models("float32")
    toks, patches = _inputs(port.cfg)
    a, _ = port.prefill(params, {"tokens": torch.from_numpy(toks),
                                 "patches": torch.from_numpy(patches)})
    b, _ = port.prefill(params, {"tokens": torch.from_numpy(toks),
                                 "patches": torch.zeros(patches.shape)})
    assert float((a - b).abs().max()) > 1e-3


def test_prefill_and_first_decode_bfloat16():
    ref, ref_params, port, params = _models("bfloat16")
    toks, patches = _inputs(port.cfg, seed=1)
    want_logits, want_cache = jax.jit(ref.prefill)(
        ref_params, {"tokens": jnp.asarray(toks),
                     "patches": jnp.asarray(patches, jnp.bfloat16)})
    logits, cache = port.prefill(params, {
        "tokens": torch.from_numpy(toks),
        "patches": torch.from_numpy(patches).to(torch.bfloat16)})
    for path, leaf in _leaves(cache):
        assert leaf.dtype == torch.bfloat16, path
    want = np.asarray(want_logits)
    gaps = [float(np.abs(logits.numpy() - want).max() / np.abs(want).max())]
    pos = port.cfg.n_patches + T
    tok = np.array(jnp.argmax(want_logits[:, -1], -1))
    want_logits, _ = jax.jit(ref.decode_step)(ref_params, {
        "token": jnp.asarray(tok[:, None]), "pos": jnp.int32(pos),
        "cache": want_cache})
    logits, _ = port.decode_step(params, {
        "token": torch.from_numpy(tok[:, None]), "pos": pos, "cache": cache})
    want = np.asarray(want_logits)
    gaps.append(float(np.abs(logits.numpy() - want).max()
                      / np.abs(want).max()))
    print(f"{ARCH} bfloat16: prefill logits gap {gaps[0]:.4f}, first decode "
          f"{gaps[1]:.4f} of the largest logit")
    assert max(gaps) <= BF16_REL_TOL


def test_train_loss_and_gradients_match_reference():
    ref, _, port, _ = _models("float32")
    params = _PARAMS["p"]
    toks, patches = _inputs(port.cfg, seed=2)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "patches": patches}
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


def test_no_patches_is_the_decoder_lm():
    """With 0 patch embeddings the VLM is the decoder LM on the same
    weights: equal prefill logits, cache and loss."""
    _, _, port, params = _models("float32")
    cfg = port.cfg
    toks, _ = _inputs(cfg, seed=4)
    dec = build_model(dataclasses.replace(cfg, family="decoder"), "cpu")
    tt = torch.from_numpy(toks)
    batch = {"tokens": tt, "labels": tt.roll(-1, dims=1),
             "patches": torch.zeros((B, 0, cfg.d_model))}
    with torch.no_grad():
        a, ca = port.prefill(params, batch)
        b, cb = dec.prefill(params, {"tokens": tt})
        assert torch.equal(a, b)
        for (pa, la), (pb, lb) in zip(_leaves(ca), _leaves(cb)):
            assert pa == pb and torch.equal(la, lb)
        assert torch.equal(port.train_loss(params, batch),
                           dec.train_loss(params, batch))


@pytest.mark.parametrize("patches", ["zero", "random"])
def test_c12_zero_patches_overflow_the_gradients_in_both_packages(patches):
    """ROADMAP C12.  The reference's launcher (and the port's) trains the
    VLM on zero patch embeddings: those rows stay exactly 0 through
    every layer, each RMSNorm's backward scales their gradient by
    1/sqrt(1e-6) and the attention's V feeds it to the next layer down,
    so at 24 layers the gradients overflow, in the reference as in the
    port (the loss itself is finite).  On random patches both packages'
    gradients are finite and agree."""
    kw = dict(activation_dtype="float32", n_layers=24)
    ref_cfg = dataclasses.replace(ref_reduced_config(ref_get_config(ARCH)),
                                  **kw)
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), **kw)
    params = jax.tree.map(np.asarray, ref_build_model(ref_cfg).init(
        jax.random.PRNGKey(0)))
    toks, front = _inputs(cfg, seed=5)
    if patches == "zero":
        front = np.zeros_like(front)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "patches": front}
    loss, grads = jax.value_and_grad(ref_build_model(ref_cfg).train_loss)(
        params, batch)
    tp = tree_map(lambda p: p.requires_grad_(True),
                  params_from_jax(params, device="cpu"))
    tloss = build_model(cfg, device="cpu").train_loss(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    want = [np.asarray(g) for g in jax.tree.leaves(grads)]
    got = [p.grad.numpy() for p in tree_leaves(tp)]
    finite = (all(np.isfinite(w).all() for w in want),
              all(np.isfinite(g).all() for g in got))
    assert finite == ((True, True) if patches == "random" else
                      (False, False))
    if patches == "random":
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())
