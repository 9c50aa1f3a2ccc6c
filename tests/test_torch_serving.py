"""Port's serving path (``ServeEngine`` with the quantized KV store)
against the JAX reference.

Both engines serve the prompts of ``tests/test_serving_data.py`` with the
same (reference-drawn) weights of the reduced ``llama3.2-3b``, in
float32; the RG-LRU and MoE families (``recurrentgemma-2b`` at 8 layers,
with its tail; ``olmoe-1b-7b``; ``llama4-maverick-400b-a17b``) serve
longer prompts, past the reduced window of 32.  The port runs on the CPU, where its kernels run their plain
versions.  Held: equal generated tokens under pr2ar2 (tau 0.2, 0.05
and 0.01, where some pages retry) and baseline, equal ``KVReadStats``
fields, and the reference test's own assertions.  One test shows ROADMAP C6: the engines prefill without
cache headroom, so a decode step writes the last cache slot in both
packages.
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
from repro.models import build_model as ref_build_model
from repro.serving import QuantizedKVStore as RefStore
from repro.serving import ServeEngine as RefEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.retry import RetryPolicy
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import QuantizedKVStore, ServeEngine

ARCH = "llama3.2-3b"
PROMPTS = [np.array([5, 9, 11, 2], np.int32), np.array([7, 3], np.int32)]
MAX_NEW = 6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    ref_cfg = dataclasses.replace(ref_reduced_config(ref_get_config(ARCH)),
                                  activation_dtype="float32")
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)),
                              activation_dtype="float32")
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu")
    return ref_cfg, ref_params, cfg, params


def _serve(setup, mechanism, tau):
    ref_cfg, ref_params, cfg, params = setup
    ref = RefEngine(ref_cfg, params=ref_params, policy=RefPolicy(mechanism),
                    tau=tau)
    port = ServeEngine(cfg, params=params, policy=RetryPolicy(mechanism),
                       tau=tau, device="cpu")
    return (ref.generate(PROMPTS, max_new_tokens=MAX_NEW),
            port.generate(PROMPTS, max_new_tokens=MAX_NEW))


@pytest.mark.parametrize("mechanism,tau", [("pr2ar2", 0.2), ("baseline", 0.2),
                                           ("pr2ar2", 0.05), ("pr2ar2", 0.01)])
def test_engine_matches_reference(setup, mechanism, tau):
    (want, want_st), (got, st) = _serve(setup, mechanism, tau)
    assert got.dtype == np.int32 and got.shape == (len(PROMPTS), MAX_NEW)
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(st.kv) == dataclasses.asdict(want_st.kv)
    assert (st.n_requests, st.prompt_tokens, st.generated_tokens) == (
        want_st.n_requests, want_st.prompt_tokens, want_st.generated_tokens)
    print(f"{mechanism} tau={tau}: {st.summary()}")


#: The RG-LRU, MoE, encoder-decoder and VLM families, reduced
#: (recurrentgemma with its tail).  The engines feed whisper zero frame
#: embeddings and internvl zero patch embeddings, and internvl decodes
#: from position T + n_patches.
FAMILY_ARCHS = {"recurrentgemma-2b": dict(n_layers=8), "olmoe-1b-7b": {},
                "llama4-maverick-400b-a17b": {}, "whisper-large-v3": {},
                "internvl2-1b": {}}
FAMILY_PROMPTS = [np.arange(3, 43, dtype=np.int32) % 500 + 2,
                  np.array([7, 3, 9], np.int32)]
_FAMILY = {}


def _family(arch):
    if arch not in _FAMILY:
        kw = dict(activation_dtype="float32", **FAMILY_ARCHS[arch])
        ref_cfg = dataclasses.replace(
            ref_reduced_config(ref_get_config(arch)), **kw)
        cfg = dataclasses.replace(reduced_config(get_config(arch)), **kw)
        ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(1))
        _FAMILY[arch] = (ref_cfg, ref_params, cfg, params_from_jax(
            jax.tree.map(np.asarray, ref_params), "cpu"))
    return _FAMILY[arch]


@pytest.mark.parametrize("arch", sorted(FAMILY_ARCHS))
@pytest.mark.parametrize("mechanism,tau", [("pr2ar2", 0.05),
                                           ("baseline", 0.05),
                                           ("pr2ar2", 0.01)])
def test_families_engine_matches_reference(arch, mechanism, tau):
    ref_cfg, ref_params, cfg, params = _family(arch)
    ref = RefEngine(ref_cfg, params=ref_params, policy=RefPolicy(mechanism),
                    tau=tau)
    port = ServeEngine(cfg, params=params, policy=RetryPolicy(mechanism),
                       tau=tau, device="cpu")
    want, want_st = ref.generate(FAMILY_PROMPTS, max_new_tokens=MAX_NEW)
    got, st = port.generate(FAMILY_PROMPTS, max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(st.kv) == dataclasses.asdict(want_st.kv)
    # Baseline keeps no fast tier and reads through it 0 pages.
    assert (st.kv.fast_pages > 0) == (mechanism != "baseline")
    print(f"{arch} {mechanism} tau={tau}: {st.summary()}")


def test_store_reads_cross_leaves_in_the_references_order():
    """A whisper prefill cache (self ``attn`` and static cross ``xattn``
    leaves of every decoder unit): the same fast-tier keys in the same
    order, bitwise int8 pages, equal stats and reads as the reference's
    store."""
    ref_cfg, ref_params, cfg, params = _family("whisper-large-v3")
    toks = np.array([[5, 9, 11, 2], [0, 0, 7, 3]], np.int32)
    audio = np.random.default_rng(6).standard_normal(
        (2, cfg.enc_positions, cfg.d_model)).astype(np.float32)
    _, ref_cache = ref_build_model(ref_cfg).prefill(ref_params, {
        "tokens": jnp.asarray(toks), "audio_embed": jnp.asarray(audio)})
    cache = params_from_jax(jax.tree.map(np.asarray, ref_cache), "cpu")
    ref_store, store = RefStore(RefPolicy("pr2ar2"), tau=0.01), \
        QuantizedKVStore(RetryPolicy("pr2ar2"), tau=0.01)
    ref_store.pack(ref_cache)
    store.pack(cache)
    assert list(store.fast) == list(ref_store.fast) == [
        f"['units']['b0']['{a}']['{n}']" for a in ("attn", "xattn")
        for n in ("k", "v")]
    for key, (q, sc) in store.fast.items():
        assert np.array_equal(q.numpy(), np.asarray(ref_store.fast[key][0]))
        assert np.array_equal(sc.numpy(), np.asarray(ref_store.fast[key][1]))
    got, want = store.materialize(), ref_store.materialize()
    assert dataclasses.asdict(store.stats) == dataclasses.asdict(
        ref_store.stats)
    assert store.stats.pages == 2 * 2 * 2 * 4 * (4 + cfg.enc_positions)
    for a in ("attn", "xattn"):
        for n in ("k", "v"):
            assert np.array_equal(got["units"]["b0"][a][n].numpy(),
                                  np.asarray(want["units"]["b0"][a][n]))


def test_store_walks_lists_in_the_references_order():
    """A cache with a list (a pattern tail), holding attention leaves
    too: the same fast-tier keys, int8 pages, stats and reads as the
    reference's store, in the reference's flattening order."""
    rng = np.random.default_rng(4)

    def leaf(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    tree = {"units": {"b0": {"attn": {"k": leaf(2, 2, 1, 8, 16),
                                      "v": leaf(2, 2, 1, 8, 16)}}},
            "tail": [{"rglru": {"conv": leaf(2, 3, 16), "h": leaf(2, 16)}},
                     {"attn": {"k": leaf(2, 1, 8, 16),
                               "v": leaf(2, 1, 8, 16)}}]}
    tree["tail"][1]["attn"]["k"][:, :, 3, 0] *= 60.0   # pages that retry
    ref_store, store = RefStore(RefPolicy("pr2ar2"), tau=0.01), \
        QuantizedKVStore(RetryPolicy("pr2ar2"), tau=0.01)
    ref_store.pack(jax.tree.map(jnp.asarray, tree))
    store.pack(params_from_jax(tree, "cpu"))
    assert list(store.fast) == list(ref_store.fast) == [
        "['tail'][1]['attn']['k']", "['tail'][1]['attn']['v']",
        "['units']['b0']['attn']['k']", "['units']['b0']['attn']['v']"]
    for key, (q, sc) in store.fast.items():
        assert np.array_equal(q.numpy(), np.asarray(ref_store.fast[key][0]))
        assert np.array_equal(sc.numpy(), np.asarray(ref_store.fast[key][1]))
    got, want = store.materialize(), ref_store.materialize()
    assert dataclasses.asdict(store.stats) == dataclasses.asdict(
        ref_store.stats)
    assert 0 < store.stats.retried_pages < store.stats.pages
    assert isinstance(got["tail"], list)
    for a, b in zip(jax.tree.leaves(want),
                    [got["tail"][0]["rglru"]["conv"],
                     got["tail"][0]["rglru"]["h"],
                     got["tail"][1]["attn"]["k"], got["tail"][1]["attn"]["v"],
                     got["units"]["b0"]["attn"]["k"],
                     got["units"]["b0"]["attn"]["v"]]):
        assert np.array_equal(b.numpy(), np.asarray(a))


def test_reference_assertions_hold(setup):
    """The reference's ``test_retry_kv_matches_baseline_greedy``, on the
    port."""
    _, _, cfg, params = setup
    eng = ServeEngine(cfg, params=params, policy=RetryPolicy("pr2ar2"),
                      tau=0.2, device="cpu")
    gen, st = eng.generate(PROMPTS, max_new_tokens=MAX_NEW)
    eng_b = ServeEngine(cfg, params=eng.params,
                        policy=RetryPolicy("baseline"), device="cpu")
    gen_b, st_b = eng_b.generate(PROMPTS, max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(gen, gen_b)
    assert st.kv.fast_fraction > 0.9
    assert st_b.kv.fast_fraction == 0.0
    assert st.kv.bytes_saved_fraction > 0.5


def test_eos_stops_and_pads(setup):
    _, _, cfg, params = setup
    eng = ServeEngine(cfg, params=params, device="cpu")
    gen, _ = eng.generate(PROMPTS, max_new_tokens=MAX_NEW)
    eos = int(gen[0, 1])
    gen_e, _ = ServeEngine(cfg, params=params, device="cpu").generate(
        PROMPTS, max_new_tokens=MAX_NEW, eos_id=eos)
    row = gen_e[0]
    assert row[1] == eos and (row[1:] == eos).all()


def test_decode_writes_last_cache_slot_in_both_packages(setup):
    """ROADMAP C6: a prefill without headroom holds exactly T slots; the
    reference's decode write at pos = T clamps to slot T-1, and so does
    the port's — both change slot S-1 of every global cache leaf and no
    other slot."""
    ref_cfg, ref_params, cfg, params = setup
    toks = np.array([[5, 9, 11, 2, 4], [0, 0, 0, 7, 3]], np.int32)
    T = toks.shape[1]
    ref = ref_build_model(ref_cfg)
    _, ref_cache = ref.prefill(ref_params, {"tokens": jnp.asarray(toks)})
    _, ref_new = ref.decode_step(ref_params, {
        "token": jnp.asarray(toks[:, -1:]), "pos": jnp.int32(T),
        "cache": ref_cache})
    port = build_model(cfg, "cpu")
    _, cache = port.prefill(params, {"tokens": torch.from_numpy(toks)})
    _, new = port.decode_step(params, {"token": torch.from_numpy(toks[:, -1:]),
                                       "pos": T, "cache": cache})
    for name in ("k", "v"):
        before = np.asarray(ref_cache["units"]["b0"]["attn"][name])
        after = np.asarray(ref_new["units"]["b0"]["attn"][name])
        tb = cache["units"]["b0"]["attn"][name].numpy()
        ta = new["units"]["b0"]["attn"][name].numpy()
        assert before.shape == tb.shape and before.shape[3] == T
        for b_, a_ in ((before, after), (tb, ta)):
            changed = np.any(b_ != a_, axis=(0, 1, 2, 4))
            assert changed.tolist() == [False] * (T - 1) + [True]
        np.testing.assert_allclose(ta, after, rtol=0, atol=1e-4)


def test_store_stats_and_tiers(setup):
    """Pack/materialize on the same cache: equal fast tiers (bitwise),
    equal stats, and reads equal to the reference's."""
    ref_cfg, ref_params, cfg, params = setup
    toks = np.array([[5, 9, 11, 2], [0, 0, 7, 3]], np.int32)
    _, ref_cache = ref_build_model(ref_cfg).prefill(
        ref_params, {"tokens": jnp.asarray(toks)})
    cache = params_from_jax(jax.tree.map(np.asarray, ref_cache), "cpu")
    ref_store, store = RefStore(RefPolicy("pr2ar2"), tau=0.1), \
        QuantizedKVStore(RetryPolicy("pr2ar2"), tau=0.1)
    ref_store.pack(ref_cache)
    store.pack(cache)
    assert sorted(store.fast) == sorted(ref_store.fast)
    for key, (q, s) in store.fast.items():
        assert np.array_equal(q.numpy(), np.asarray(ref_store.fast[key][0]))
        assert np.array_equal(s.numpy(), np.asarray(ref_store.fast[key][1]))
    got = store.materialize()
    want = ref_store.materialize()
    assert dataclasses.asdict(store.stats) == dataclasses.asdict(
        ref_store.stats)
    for name in ("k", "v"):
        assert np.array_equal(got["units"]["b0"]["attn"][name].numpy(),
                              np.asarray(want["units"]["b0"]["attn"][name]))


def test_serve_cli(capsys):
    from repro_torch.launch import serve

    serve.main(["--smoke", "--device", "cpu", "--max-new", "2",
                "--batch", "2"])
    out = capsys.readouterr().out
    assert "kv_fast=" in out and "req1:" in out
    with pytest.raises(NotImplementedError, match="item 13"):
        serve.main(["--dry-run"])


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-1b"])
def test_serve_cli_encdec_and_vlm(arch, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--max-new",
                "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert "kv_fast=" in out and "req1:" in out
