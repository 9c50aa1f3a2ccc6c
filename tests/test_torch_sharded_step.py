"""The port's sharded train step (``repro_torch.distributed.steps``) over
gloo meshes of CPU ranks, against the reference's ``make_train_step`` on
a host mesh of 4 CPU devices at the same mesh shape.

Two subprocesses run the reference's cases, half each
(``tests/sharded_reference.py``,
``XLA_FLAGS=--xla_force_host_platform_device_count=4``), while one
``torch.multiprocessing`` spawn a world size (1, 4, then 2) runs the
port's cases (``tests/sharded_port.py``; ranks meet through a
``FileStore`` in ``tmp_path``, no fixed port).  Both start from the
reference's seed-0 parameters (the first subprocess writes them before
its cases), float32 activations, batch 4 x 16.

  * meshes (1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4); reduced
    llama3.2-3b, gemma2-2b, mamba2-130m, recurrentgemma-2b (8 layers:
    two units and a tail), whisper-large-v3 and olmoe-1b-7b with
    ``REPRO_MOE_EP`` 0 and 1 (tp 2 and 4): the first step's loss and
    grad_norm within 1e-5 relative of the reference's, three steps'
    losses within 1e-4 (the budget of ``tests/test_torch_train.py``);
  * each rank's local state bytes equal to one device's share of the
    reference's state;
  * at (1, 1), ``launch.train.train`` on a mesh equal to the
    single-device loop bit for bit;
  * the tensor-parallel products over "model" (ROADMAP D15c-1):
    llama3.2-3b at (1, 2), (2, 2), (1, 4), gemma2-2b at (1, 4) and
    internvl2-1b at (2, 2) among the train cases; at (2, 1) no
    collective on the "model" group;
  * Mamba-2's and RG-LRU's products over "model" (ROADMAP D15c-3):
    mamba2-130m and recurrentgemma-2b at (1, 4) and (2, 2) among the
    train cases, mamba2-130m at (1, 4) and (2, 2) and recurrentgemma-2b
    at (1, 4) among the serve cases; a Mamba-2 and an RG-LRU layer
    divided over (1, 4) (and a Mamba-2 layer at widths whose in_proj
    and heads "model" does not divide) against the whole layer: y, the
    cache and decode state, and every gradient within 1e-5;
  * the serve steps on shards (ROADMAP D15c-2a): ``make_prefill_step``
    and three greedy ``make_decode_step`` steps, handed the prompt and
    then their own DTensors, against the reference's: llama3.2-3b and
    whisper-large-v3 at (1, 2), (2, 2) and (1, 4), olmoe-1b-7b (the
    divided dense MoE) at (2, 2) and (1, 4), llama3.2-3b's int8 cache
    and gemma2-2b (its window cache divided over "model") at (1, 4),
    the recurrent cases above, and llama3.2-3b at (2, 2) on a 64-token
    prompt (its slots divided:
    the other cases' 16 slots tie the head dim, which is divided):
    logits within 1e-4 of the largest, greedy tokens equal, each rank's
    bytes of the last cache equal to one device's shard on the
    reference's ``cache_shardings``;
  * the expert-parallel layer's y and aux against the reference's
    ``moe_apply_ep`` at (1, 2), (1, 4) and (2, 2) within 1e-5;
  * the dense MoE layer divided over (2, 1), (2, 2) and (1, 4) (ROADMAP
    D15c-2a), with a capacity below d (its products' d contracted on
    the weights' shards) and above it (wi and wg gathered): y, the aux
    loss and the gradients of its input, router and experts within
    1e-5 of the whole layer's;
  * ``compress_grads`` and ``global_norm`` on DTensor gradients over
    (2, 2) against the whole tree;
  * elastic restart: two steps at (2, 2) saved to disk, restored on
    ``plan_mesh(2, (2, 2))``'s mesh (1, 2) through ``reshard_state``
    bit for bit, two more steps equal to an unbroken (1, 2) run's;
  * the reference's flash mode (ROADMAP D15c-2b), ``REPRO_ATTN_IMPL=
    flash`` on both sides (the reference's attention on the CPU is its
    blockwise and windowed scans under its sequence-parallel layouts;
    the port's stream is each rank's T / model rows, its attention
    context-parallel): the train cases ``*/flash`` (llama3.2-3b,
    gemma2-2b and recurrentgemma-2b at (1, 4) and (2, 2), olmoe-1b-7b
    at (2, 2)) and the serve cases ``*/flash`` (llama3.2-3b and
    gemma2-2b at (1, 4) on a 64-token prompt, whose local layers' window
    of 32 cuts the keys) at the tolerances above, tokens equal, each
    rank's cache bytes one device's shard; each rank's saved unit
    carry its T / model rows in ``base`` and in ``flash``; a
    context-parallel attention layer (causal, and windowed with softcap)
    at (1, 4) against the whole layer: y, the prefill's output and
    cache, and the gradients of x and of every leaf within 1e-5.

The ``torchrun`` launch is in ``tests/test_torch_distributed.py``.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import sharded_port as SP

ROOT = Path(__file__).resolve().parents[1]

TRAIN_CASES = [
    ["llama3.2-3b", [1, 1], 0, 3],
    ["gemma2-2b", [2, 1], 0, 3],
    ["mamba2-130m", [1, 2], 0, 3],
    ["olmoe-1b-7b", [1, 2], 1, 3],
    ["recurrentgemma-2b", [4, 1], 0, 3],
    ["whisper-large-v3", [1, 4], 0, 3],
    ["olmoe-1b-7b", [2, 2], 0, 3],
    ["olmoe-1b-7b", [1, 4], 1, 3],
    ["olmoe-1b-7b", [2, 2], 1, 3],
    # Tensor-parallel products over "model" (ROADMAP D15c-1); gemma2-2b
    # at (1, 4): tied embeddings, softcaps, kv heads (2) that "model"
    # does not divide; internvl2-1b: the VLM's patch rows.
    ["llama3.2-3b", [1, 2], 0, 3],
    ["llama3.2-3b", [2, 2], 0, 3],
    ["llama3.2-3b", [1, 4], 0, 3],
    ["gemma2-2b", [1, 4], 0, 3],
    ["internvl2-1b", [2, 2], 0, 3],
    # Mamba-2's and RG-LRU's products over "model" (ROADMAP D15c-3):
    # in_proj's packed columns moved to the conv channels and scan
    # heads, the gated norm's sum over "model"; recurrentgemma-2b with its
    # tail.
    ["mamba2-130m", [1, 4], 0, 3],
    ["mamba2-130m", [2, 2], 0, 3],
    ["recurrentgemma-2b", [1, 4], 0, 3],
    ["recurrentgemma-2b", [2, 2], 0, 3],
    # The reference's flash mode: the sequence-parallel stream and
    # context-parallel attention (ROADMAP D15c-2b).
    ["llama3.2-3b", [1, 4], 0, 3, "flash"],
    ["llama3.2-3b", [2, 2], 0, 3, "flash"],
    ["gemma2-2b", [1, 4], 0, 3, "flash"],
    ["gemma2-2b", [2, 2], 0, 3, "flash"],
    ["recurrentgemma-2b", [1, 4], 0, 3, "flash"],
    ["recurrentgemma-2b", [2, 2], 0, 3, "flash"],
    ["olmoe-1b-7b", [2, 2], 0, 3, "flash"],
]
MOE_CASES = [[1, 2], [1, 4], [2, 2]]
DENSE_MOE_CASES = [[s, t] for s in ([2, 1], [2, 2], [1, 4]) for t in (1, 8)]
SERVE_CASES = [[a, s] for a in ("llama3.2-3b", "whisper-large-v3")
               for s in ([1, 2], [2, 2], [1, 4])] + [
    ["olmoe-1b-7b", [2, 2]], ["olmoe-1b-7b", [1, 4]],
    ["llama3.2-3b", [1, 4], "kvint8"], ["gemma2-2b", [1, 4]],
    ["llama3.2-3b", [2, 2], "slots"], ["mamba2-130m", [1, 4]],
    ["mamba2-130m", [2, 2]], ["recurrentgemma-2b", [1, 4]],
    ["llama3.2-3b", [1, 4], "flash"], ["gemma2-2b", [1, 4], "flash"]]
#: The recurrent layers divided over "model" against whole (ROADMAP
#: D15c-3): (arch, mesh[, widths of ``sharded_port.RECURRENT_WIDTHS``]).
RECURRENT_CASES = [["mamba2-130m", [1, 4]], ["recurrentgemma-2b", [1, 4]],
                   ["mamba2-130m", [1, 4], "mixed"]]


def _serve_tag(case):
    return "/".join([case[0], f"{case[1][0]}x{case[1][1]}"] + case[2:])


def _tag(case):
    arch, shape, ep, _, *variant = case
    return "/".join([arch, f"{shape[0]}x{shape[1]}", f"ep{ep}"] + variant)


#: Reference subprocesses (each takes every second case).
N_REF = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, the port's by world size)."""
    work = tmp_path_factory.mktemp("sharded")
    (work / "cases.json").write_text(json.dumps(
        {"train": TRAIN_CASES, "moe": MOE_CASES, "serve": SERVE_CASES,
         "dense_moe": DENSE_MOE_CASES, "recurrent": RECURRENT_CASES}))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    refs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "sharded_reference.py"),
         str(work), str(i), str(N_REF)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(N_REF)]
    try:
        deadline = time.monotonic() + 300
        while not (work / "params.pkl").exists():
            assert refs[0].poll() is None, refs[0].stdout.read().decode()
            assert time.monotonic() < deadline
            time.sleep(0.2)
        port = {w: SP.run(w, work) for w in (1, 4, 2)}
    finally:
        outs = [r.communicate(timeout=600)[0] for r in refs]
    for r, out in zip(refs, outs):
        assert r.returncode == 0, out.decode()[-4000:]
    ref = {}
    for i in range(N_REF):
        ref.update(np.load(work / f"ref_{i}.npz"))
    return ref, port


def _port_case(port, case):
    shape = case[1]
    return port[shape[0] * shape[1]]


@pytest.mark.parametrize("case", TRAIN_CASES, ids=_tag)
def test_sharded_step_matches_reference(runs, case):
    ref, port = runs
    tag = _tag(case)
    want = ref[f"train/{tag}"]
    got = np.array(_port_case(port, case)["train"][tag])
    assert got.shape == want.shape
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)


@pytest.mark.parametrize("case", TRAIN_CASES, ids=_tag)
def test_local_state_bytes_equal_reference_shard(runs, case):
    ref, port = runs
    tag = _tag(case)
    per_rank = _port_case(port, case)["bytes"][tag]
    assert per_rank == [int(ref[f"bytes/{tag}"])] * len(per_rank)


def test_one_by_one_mesh_equals_unsharded_loop(runs):
    _, port = runs
    plain, sharded = port[1]["plain_vs_mesh"]
    assert len(plain) == 4 and plain == sharded


@pytest.mark.parametrize("shape", MOE_CASES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_expert_parallel_layer_matches_reference(runs, shape):
    ref, port = runs
    tag = f"{shape[0]}x{shape[1]}"
    y, aux = port[shape[0] * shape[1]]["moe"][tag]
    want = ref[f"moe/y/{tag}"]
    np.testing.assert_allclose(np.array(y), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(aux, float(ref[f"moe/aux/{tag}"]), rtol=1e-5)


@pytest.mark.parametrize("case", DENSE_MOE_CASES,
                         ids=lambda c: f"{c[0][0]}x{c[0][1]}/T{c[1]}")
def test_dense_moe_divided_matches_whole(runs, case):
    """The dense MoE divided over the mesh against the whole layer: y,
    aux and every gradient within 1e-5 of the whole's largest."""
    _, port = runs
    shape, T_moe = case
    errs = port[shape[0] * shape[1]]["dense_moe"][
        f"{shape[0]}x{shape[1]}/T{T_moe}"]
    assert set(errs) == {"y", "aux", "x", "router", "moe_wi", "moe_wg",
                         "moe_wd"}
    assert max(errs.values()) <= 1e-5, errs


@pytest.mark.parametrize("case", RECURRENT_CASES, ids=_serve_tag)
def test_recurrent_layer_divided_matches_whole(runs, case):
    """A Mamba-2 and an RG-LRU layer divided over the mesh against the
    whole layer: the training output y and the gradients of its input
    and of every weight (the divided leaves and the replicated ones
    each rank slices), the prefill's output and cache, and a decode
    step's output and new state, within 1e-5 of the whole's largest;
    and a Mamba-2 layer whose in_proj and heads "model" does not divide
    while it divides the conv channels and d_inner (as at full width)."""
    _, port = runs
    arch, shape = case[:2]
    errs = port[shape[0] * shape[1]]["recurrent"][_serve_tag(case)]
    block = {"mamba2-130m": ("in_proj", "conv_w", "out_proj"),
             "recurrentgemma-2b": ("w_gate", "w_rec", "w_out", "conv_w",
                                   "a_gate", "x_gate")}[arch]
    assert {"y", "x", "prefill", "decode", *block} <= set(errs)
    assert any(k.startswith("state/") for k in errs)
    assert max(errs.values()) <= 1e-5, errs


@pytest.mark.parametrize("case", SERVE_CASES, ids=_serve_tag)
def test_serve_steps_match_reference(runs, case):
    """``make_prefill_step`` and three greedy ``make_decode_step`` steps
    against the reference's on the same mesh: each step's float32
    logits within 1e-4 relative of the reference's largest, the greedy
    tokens equal."""
    ref, port = runs
    tag = _serve_tag(case)
    shape = case[1]
    logits, tokens, _ = port[shape[0] * shape[1]]["serve"][tag]
    want = ref[f"serve/logits/{tag}"]
    np.testing.assert_allclose(np.array(logits), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(np.array(tokens), ref[f"serve/tokens/{tag}"])


@pytest.mark.parametrize("case", SERVE_CASES, ids=_serve_tag)
def test_serve_cache_bytes_equal_reference_shard(runs, case):
    """After the last decode step each rank holds exactly one device's
    share of the reference's cache on ``cache_shardings``: the batch
    over "data", the largest dim "model" divides over "model"."""
    ref, port = runs
    tag = _serve_tag(case)
    shape = case[1]
    per_rank = port[shape[0] * shape[1]]["serve"][tag][2]
    want = int(ref[f"serve/cache_bytes/{tag}"])
    assert per_rank == [want] * (shape[0] * shape[1])


def test_model_axis_of_one_issues_no_model_collective(runs):
    """A train step, a prefill and a decode step of reduced llama3.2-3b on
    the two ranks: at (2, 1) no collective on the "model" group (the
    tensor-parallel pieces are the identity there) and some on "data";
    at (1, 2) some on "model" (the pieces' all-reduces and gathers)."""
    _, port = runs
    groups = port[2]["groups"]
    assert groups["2x1"]["model"] == 0 and groups["2x1"]["data"] > 0
    assert groups["1x2"]["model"] > 0


def test_compression_and_norm_span_the_mesh(runs):
    """On DTensor gradients over (2, 2), ``compress_grads`` takes each
    leaf's amax over the whole tensor (outputs and feedback equal the
    whole tree's bit for bit) and ``global_norm`` counts a replicated
    leaf once."""
    _, port = runs
    equal, (sharded, plain) = port[4]["compress"]
    assert equal
    np.testing.assert_allclose(sharded, plain, rtol=1e-6)


def test_elastic_restart_on_planned_mesh(runs):
    _, port = runs
    el = port[2]["elastic"]
    assert el["plan"] == [1, 2]
    assert el["exact"]
    assert len(port[4]["elastic_saved"]) == 2
    resumed, unbroken = np.array(el["resumed"]), np.array(el["unbroken"])
    np.testing.assert_allclose(resumed[:, 0], unbroken[:, 0], rtol=1e-5)
    np.testing.assert_allclose(resumed[:, 1], unbroken[:, 1], rtol=1e-5)


@pytest.mark.parametrize("variant", ["", "flash"],
                         ids=["base", "flash"])
def test_saved_unit_carry_is_the_sequence_shard(runs, variant):
    """Reduced llama3.2-3b's train loss at (1, 4), in ``base`` and under
    ``REPRO_ATTN_IMPL=flash``: each unit's carry (the remat region's
    input, which autograd keeps for the backward pass) is among the
    tensors ``saved_tensors_hooks`` sees, and is this rank's T / 4 rows
    of the (B, T, d) stream, as the reference constrains it to
    ``act_seq`` (``repro/models/lm.py:92``)."""
    _, port = runs
    carries, (b, t, d) = port[4]["saved"][variant]
    assert len(carries) == 2
    for shape, saved in carries:
        assert saved
        assert shape == [b, t // 4, d]


@pytest.mark.parametrize("kind", ["causal", "local"])
def test_context_parallel_attention_matches_whole(runs, kind):
    """A reduced gemma2-2b attention layer at (1, 4) on the
    sequence-divided stream (each rank's 16 of 64 rows: q, rope and o at
    the rows' positions, k and v gathered; ``local``: the window of 32
    and the softcap), training and prefill, against the whole layer: y,
    the prefill's output and cache, and the gradients of x and of every
    leaf within 1e-5 of the whole's largest."""
    _, port = runs
    errs = port[4]["cp_attention"][kind]
    assert {"y", "x", "prefill", "cache/k", "cache/v", "wq", "wk", "wv",
            "wo"} <= set(errs)
    assert max(errs.values()) <= 1e-5, errs
