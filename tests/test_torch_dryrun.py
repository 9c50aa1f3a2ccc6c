"""The port's dry-run (``repro_torch.launch.dryrun``, ``launch.cost``,
``models.api.input_specs``, ``distributed.steps.build_cell``) against the
reference's dry-run cells.

The reference's cells are compiled in subprocesses on a host mesh of 4
CPU devices (``tests/dryrun_reference.py``); the port's are traced in
subprocesses on fake CUDA tensors over a fake process group of the
mesh's world size (``tests/dryrun_port.py``, through
``launch.fake_cuda.python_cmd``), one process a mesh, both at once.
Reduced configs; the shapes of :data:`SHAPES`.

  * ``input_specs`` equal to the reference's (``jax.eval_shape``) for
    every published config x shape, with and without
    ``REPRO_KV_INT8=1``: shapes, dtypes and the decode cache's tree;
  * meshes (1, 1), (2, 1), (2, 2) and (1, 4), the cells of
    :data:`CELLS`: each rank's argument and output bytes equal to the
    reference's ``memory_analysis`` (a differing leaf is named; XLA's
    output size also holds the output tuple's index table, 8 bytes a
    leaf, which is not data); ``dot`` FLOPs equal to
    ``hlo_cost.breakdown``'s, and a prefill's ``dot`` and ``kernel``
    equal to the reference's cell with its kernel stand-ins (``dot``,
    ``custom-call(kernel)``), where the training cells differ by the
    reference's nested remat, the recurrent cells by the products the
    reference's HLO counts as dots and the port's autograd and decode
    conv do not, and the (1, 4) and (2, 2) cells by the partitioner
    decisions :func:`test_flops_match_reference` names (the products
    are divided over "model", ROADMAP D15c-1, the dense MoE's over
    "model" and the batch axes, D15c-2a, and Mamba-2's and RG-LRU's
    over "model", D15c-3);
  * at (1, 1) and (2, 1), each cell's FLOPs and collectives equal to
    :data:`MODEL_ONE`'s records;
  * one rank issues no collective;
  * the collectives of a fake-group trace equal those the same step
    issues on a real 4-rank gloo run at (2, 2), for train and prefill
    (``tests/sharded_port.py``);
  * ``launch.cost`` on small functions: FLOPs scale with a loop's
    length, a 64^3 product counts 2 * 64^3, each collective kind gets
    its ring multiplier;
  * the custom ops B4 and B5: ``torch.library.opcheck`` (the CPU
    implementation), fake outputs against the plain outputs, and the
    FLOP formulas against ``hlo_cost``'s;
  * ``run_cell`` on fake 256- and 512-rank groups writes a record with
    every key of the reference's, for each kind and for the stand-in
    variants ``flash``, ``ssdk``, ``flash+kvint8`` and ``flash+ep``
    (their counts against the reference's cells:
    ``test_torch_dryrun_standins.py``); ``long_500k`` skips where the
    reference skips; the variants;
  * ``launch.serve --dry-run`` runs.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
TESTS = ROOT / "tests"

#: The reduced cells' shapes: [name, seq_len, global batch] by kind.
SHAPES = {"train": ["train_small", 32, 4], "prefill": ["prefill_small", 64, 4],
          "decode": ["decode_small", 64, 4]}
CELLS = [("gemma2-2b", "train"), ("llama3.2-3b", "prefill"),
         ("mamba2-130m", "prefill"), ("olmoe-1b-7b", "decode"),
         ("olmoe-1b-7b", "prefill"), ("whisper-large-v3", "prefill"),
         ("internvl2-1b", "train"), ("mamba2-130m", "decode"),
         ("recurrentgemma-2b", "prefill"), ("recurrentgemma-2b", "decode"),
         ("mamba2-130m", "train")]
MESHES = [(1, 1), (2, 1), (2, 2), (1, 4)]
#: The reference's record keys (``repro.launch.dryrun.run_cell``); the
#: port's ``trace_s`` takes the place of ``lower_s`` and ``compile_s``.
REF_KEYS = {"arch", "shape", "mesh", "variant", "status", "n_devices",
            "flops_per_device", "bytes_accessed_per_device",
            "transcendentals", "xla_cost_analysis", "memory", "collectives",
            "collectives_loop_body_once", "model", "shape_cfg"}
REF_MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
                   "alias_bytes", "generated_code_bytes"}


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(TESTS)])
    return env


def _reference(work, name, cells=None):
    if cells is not None:
        (work / f"{name}.json").write_text(json.dumps(cells))
    return subprocess.Popen(
        [sys.executable, str(TESTS / "dryrun_reference.py"), str(work), name],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _port(work, name, cells):
    from repro_torch.launch import fake_cuda

    (work / f"{name}.json").write_text(json.dumps(cells))
    return subprocess.Popen(
        fake_cuda.python_cmd("dryrun_port", [str(work), name]), env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _result(work, name, proc):
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-4000:]
    return json.loads((work / f"{name}.out.json").read_text())


def _tag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


#: The port's records by mesh, as the fixture or a test first makes them.
_PORT = {}


#: The prefill cells the port also traces in the reference's flash mode
#: (ROADMAP D15c-2b: the sequence-divided stream, context-parallel
#: attention), held to the reference's flash cell.
FLASH_PREFILL = ("llama3.2-3b", "recurrentgemma-2b")


def _port_cells(mesh):
    return [[a, k, list(mesh), "base", SHAPES[k]] for a, k in CELLS] + [
        [a, "prefill", list(mesh), "flash", SHAPES["prefill"]]
        for a in FLASH_PREFILL]


def _port_records(mesh, tmp_path_factory):
    """The port's records of :data:`CELLS` on ``mesh`` (made once)."""
    mesh = tuple(mesh)
    if mesh not in _PORT:
        work = tmp_path_factory.mktemp(f"dryrun_port_{_tag(mesh)}")
        _PORT[mesh] = _result(work, "port",
                              _port(work, "port", _port_cells(mesh)))
    return _PORT[mesh]


#: Reference subprocesses a mesh (each compiles every second cell).
N_REF = 2


@pytest.fixture(scope="module", params=MESHES, ids=_tag)
def mesh_run(request, tmp_path_factory):
    """(mesh, the reference's cells, the port's records) of one mesh
    shape; the reference's prefill cells also with its kernel stand-ins
    (variant ``opaque``)."""
    mesh = tuple(request.param)
    work = tmp_path_factory.mktemp(f"dryrun_{_tag(mesh)}")
    cells = _port_cells(mesh)
    ref_cells = cells + [[a, k, list(mesh), "opaque", SHAPES[k]]
                         for a, k in CELLS if k == "prefill"]
    refs = [_reference(work, f"ref{i}", ref_cells[i::N_REF])
            for i in range(N_REF)]
    if mesh not in _PORT:
        port = _port(work, "port", cells)
        _PORT[mesh] = _result(work, "port", port)
    ref = {}
    for i, proc in enumerate(refs):
        ref.update(_result(work, f"ref{i}", proc))
    return mesh, ref, _PORT[mesh]


def _key(arch, kind, mesh, variant="base"):
    return f"{arch}/{kind}/{_tag(mesh)}/{variant}"


# ---------------------------------------------------------------------------
# input_specs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_specs(tmp_path_factory):
    work = tmp_path_factory.mktemp("dryrun_specs")
    return _result(work, "specs", _reference(work, "specs"))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("arch", ["deepseek-67b", "deepseek-coder-33b",
                                  "gemma2-2b", "internvl2-1b", "llama3.2-3b",
                                  "llama4-maverick-400b-a17b", "mamba2-130m",
                                  "olmoe-1b-7b", "recurrentgemma-2b",
                                  "whisper-large-v3"])
def test_input_specs_match_reference(ref_specs, arch, monkeypatch):
    """Every shape of ``SHAPES``, bf16 and int8 KV caches: the same
    leaves (paths), shapes and dtypes as the reference's specs, exactly;
    where the reference's ``input_specs`` raises (whisper's decoder
    positions end before ``long_500k``), the port's raises too."""
    from repro_torch.configs import ARCHS, SHAPES as FULL
    from repro_torch.models.api import input_specs

    for int8 in ("0", "1"):
        monkeypatch.setenv("REPRO_KV_INT8", int8)
        for s in FULL:
            want = ref_specs[f"{arch}/{s}/kv_int8={int8}"]
            if isinstance(want, str):
                with pytest.raises(Exception):
                    input_specs(ARCHS[arch], FULL[s])
                continue
            got = {p: [list(t.shape), str(t.dtype).replace("torch.", "")]
                   for p, t in _flat(input_specs(ARCHS[arch], FULL[s]))}
            assert all(t.device.type == "meta"
                       for _, t in _flat(input_specs(ARCHS[arch], FULL[s]))
                       if isinstance(t, torch.Tensor))
            assert got == want, (s, int8)


# ---------------------------------------------------------------------------
# Cells against the reference's compiled cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_memory_bytes_match_reference(mesh_run, cell):
    """Each rank's argument and output bytes (the local shards on the
    cell's placements) equal to the reference's ``memory_analysis``
    exactly; a differing argument leaf is named.  A serve step holds
    exactly those bytes (its ``step_*`` bytes equal them: it takes and
    returns its shards, ROADMAP D15c-2a).  A decode step of a model
    without attention (mamba2-130m) never reads ``pos``: XLA drops the
    unused parameter from the compiled program, so the reference's
    ``memory_analysis`` leaves out its 4 bytes, which every leaf's bytes
    still hold."""
    mesh, ref, port = mesh_run
    r, p = ref[_key(*cell, mesh)], port[_key(*cell, mesh)]
    bad = {k: (p["leaves"].get(k), r["leaves"].get(k))
           for k in set(p["leaves"]) | set(r["leaves"])
           if p["leaves"].get(k) != r["leaves"].get(k)}
    assert not bad, f"argument leaves (port, reference): {bad}"
    unused = p["leaves"]["1/pos"] if cell == ("mamba2-130m", "decode") else 0
    assert p["memory"]["argument_bytes"] == r["argument_bytes"] + unused
    # XLA's output size also counts the output tuple's index table, 8
    # bytes a leaf; the outputs' data is the rest.
    assert r["output_bytes"] == r["output_data_bytes"] + 8 * r["output_leaves"]
    assert p["memory"]["output_bytes"] == r["output_data_bytes"]
    assert p["status"] == "ok" and p["device"] == "cuda"
    if cell[1] != "train":
        assert p["memory"]["step_argument_bytes"] == \
            r["argument_bytes"] + unused
        assert p["memory"]["step_output_bytes"] == r["output_data_bytes"]


def _layer_kinds(cfg):
    return (list(cfg.block_pattern) * cfg.unit_count()
            + list(cfg.tail_pattern()))


def _attention_tile_flops(arch, B, T):
    """One forward pass of every self-attention layer's tile products
    (the port's training attention, blockwise or windowed) at B rows of
    T positions; 0 for the recurrent layers."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ATTN, LOCAL, get_config, reduced_config
    from repro_torch.models import attention as A

    cfg = reduced_config(get_config(arch))
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    q = torch.zeros(B, T, K, cfg.n_heads // K, hd)
    k = v = torch.zeros(B, T, K, hd)
    pos = torch.arange(T, dtype=torch.int32)
    total = 0
    for kind in _layer_kinds(cfg):
        if kind not in (ATTN, LOCAL):
            continue
        with FlopCounterMode(display=False) as fc:
            if kind == LOCAL:
                A.windowed_attention(cfg, q, k, v, pos, cfg.window)
            else:
                A.blockwise_attention(cfg, q, k, v, pos, pos, causal=True)
        total += fc.get_total_flops()
    return total


def _router_split(arch, kind, mesh) -> float:
    """The partitioner decision of the reduced olmoe-1b-7b decode cell at
    (2, 2), read from the compiled HLO: the reference contracts the
    router (d, E) over d / "model" on each rank's rows (its FSDP slice
    moved to the "model" rank by a collective-permute, the partial
    logits all-reduced over "model"), where at (2, 1), at (1, 4) and in
    every prefill cell it contracts all of d, as the port does at every
    mesh.  The port's count is the reference's plus (1 - 1 / model) of
    the router products, every MoE layer: 2 048 FLOPs."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm as LM

    cfg = reduced_config(get_config(arch))
    if kind != "decode" or mesh != (2, 2) or cfg.moe is None:
        return 0.0
    n = len(cfg.block_pattern)
    layers = sum(LM._moe_here(cfg, i % n) for i, _ in
                 enumerate(_layer_kinds(cfg)))
    rows = SHAPES[kind][2] // mesh[0]
    return layers * 2 * rows * cfg.d_model * cfg.moe.n_experts * (
        1 - 1 / mesh[1])


def _decode_conv(arch, kind, mesh) -> float:
    """The decode conv of every Mamba-2 and RG-LRU layer, which the
    reference writes as an einsum over the K taps (``bkc,kc->bc``,
    counted as a dot) and the port as a product summed in float32 (no
    dot, the same roundings): 2 B K C a layer at this rank's rows and
    conv channels."""
    from repro_torch.configs import RGLRU, SSM, get_config, reduced_config
    from repro_torch.distributed.sharding import model_share

    if kind != "decode":
        return 0.0
    cfg = reduced_config(get_config(arch))
    if cfg.ssm is not None:
        K = cfg.ssm.d_conv
        C = cfg.ssm.d_inner(cfg.d_model) + 2 * cfg.ssm.d_state
    elif cfg.rglru is not None:
        K, C = cfg.rglru.d_conv, cfg.rglru.lru_width or cfg.d_model
    else:
        return 0.0
    layers = sum(k in (SSM, RGLRU) for k in _layer_kinds(cfg))
    B = SHAPES[kind][2] // mesh[0]
    return float(layers * 2 * B * K * model_share(C, mesh[1]))


def _ssd_train_split(arch, mesh) -> float:
    """The port's training scan against the reference's, at a reduced
    mamba2-130m train cell (each rank's rows; 0 for other cells): the
    reference's count less the port's.

      * The gradients of dt through x * dt and through the chunk state,
        which XLA contracts over the head dim as dots (``(B, T, nh, hd)
        x (B, T, nh, hd) -> (B, T, nh)``, two a layer) and autograd as
        products and sums: 2 * 2 B T nh hd a layer at this rank's heads,
        which the reference counts and the port does not.
      * The scores C.B^T (B, L, L) a chunk, which B and C (one group,
        whole on every rank) share across the heads: the port's scan
        computes them whole on every "model" rank, where the reference's
        partitioner divides their query rows over "model".  Four
        products a layer (the forward, the unit's recomputation and the
        two gradients) of 2 B T L ds each, (1 - 1 / model) of them more
        in the port."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed.sharding import model_share

    cfg = reduced_config(get_config(arch))
    if cfg.ssm is None:
        return 0.0
    s = cfg.ssm
    _, T, B = SHAPES["train"]
    B //= mesh[0]
    nh = model_share(s.n_heads(cfg.d_model), mesh[1])
    L = min(s.chunk, T)
    dt_grad = 2 * 2 * B * T * nh * s.head_dim
    scores = 4 * 2 * B * T * L * s.d_state * (1 - 1 / mesh[1])
    return float(cfg.n_layers * (dt_grad - scores))


def _local_heads(arch, model: int) -> float:
    """The share of the q heads a "model" rank computes, by the port's
    rule (``sharding.model_share``: 1 / model where "model" divides the
    heads, as ``param_specs`` divides ``wq``, else 1)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed.sharding import model_share

    H = reduced_config(get_config(arch)).n_heads
    return model_share(H, model) / H


def _kv_products(arch, B, T):
    """The port's k and v projections in one train step at B rows of T
    positions: the forward, the unit's remat recomputation and the two
    backward products (input and weight gradients) of each, every
    layer."""
    from repro_torch.configs import get_config, reduced_config

    cfg = reduced_config(get_config(arch))
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    return len(_layer_kinds(cfg)) * 4 * 2 * (2 * B * T * cfg.d_model * kv)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_flops_match_reference(mesh_run, cell):
    """Where "model" is 1, against ``hlo_cost.breakdown``:

      * prefill: ``dot`` and ``kernel`` each equal to the reference's
        cell with its kernel stand-ins (``dot``, ``custom-call(kernel)``),
        exactly; but mamba2-130m's scan, which ``hlo_cost`` counts as 0
        FLOPs (its windowed-flash branch, ``marker >= 10000``, takes the
        scan's markers 30000 + L first: ROADMAP C15), is held to the
        formula of ``hlo_cost.py:191-200``;
      * decode: ``dot`` equal exactly: the dense MoE dispatch divides
        its experts over "model" and its products over "data" as the
        reference's partitioner does (ROADMAP D15c-2a); but the decode
        conv of the Mamba-2 and RG-LRU layers, which the reference
        counts as a dot and the port sums as a product (no dot,
        :func:`_decode_conv`), 2 B K C a layer, exactly;
      * train: the reference's attention rematerializes its tiles once
        more inside the attention's backward (``jax.checkpoint`` on its
        tile steps, ``models/attention.py:174, 202, 239``), the port's
        only with its unit; the port counts fewer, by between one and
        two forward passes of the attention tile products (the
        tolerance), and no more.  mamba2-130m (no attention) exactly
        the reference's less the dt gradients its HLO contracts as dots
        (:func:`_ssd_train_split`).

    Where "model" is above 1, the port divides attention, the dense MLP,
    the embedding and the head over "model" (ROADMAP D15c-1), and the
    dense MoE's experts over "model" (D15c-2a):

      * prefill: ``kernel`` as at "model" 1; ``dot`` equal to the
        ``opaque`` cell's where "model" divides the kv heads.  The
        ``opaque`` cell runs the reference's flash mode, whose
        sequence-parallel stream (q on ``act_seq``,
        ``repro/models/attention.py:307``) the port runs too (ROADMAP
        D15c-2b): llama3.2-3b's and recurrentgemma-2b's flash cells
        (:data:`FLASH_PREFILL`) equal it exactly at every mesh, ``dot``
        and ``kernel``, also where "model" does not divide the kv heads
        ((1, 4): k on the T/4 rows of a sequence shard, v from the
        gathered stream).  There the base cell, which divides the
        heads, is held to the reference's base cell: its ``dot`` less
        the blockwise tile products that B4 takes over, at the port's
        local q heads, exactly;
      * train: as at "model" 1, the reference's count less the port's
        within one to two attention tile forwards, at the local q
        heads.  Where "model" does not divide the kv heads (gemma2-2b
        and internvl2-1b at (1, 4)), the port computes k and v whole on
        every rank (the q heads are divided; each rank takes its q
        heads' kv head), while the reference's partitioner keeps the
        remat carry's sequence shard (``act_seq``,
        ``repro/models/lm.py:92``) for six of the eight k/v products a
        layer (the forward and recomputation of one projection and the
        four backward products, on T/4 tokens) and computes two whole
        (the other projection's forward and recomputation): 7/16 of the
        port's k/v FLOPs at "model" 4, read from the dot shapes of the
        compiled HLO.  The port's count is held with its k/v products
        at the reference's share;
      * decode (olmoe-1b-7b over a cache whose slots "model" divides):
        ``dot`` equal to the reference's exactly at (1, 4); at (2, 2)
        the reference's plus the router decision
        :func:`_router_split` names, exactly; the recurrent cells (their
        products divided over "model", ROADMAP D15c-3; recurrentgemma-2b's
        local attention as gemma2-2b's, k and v whole where "model" does
        not divide the kv head) the reference's less the decode conv at
        this rank's channels, exactly;
      * Mamba-2 (D15c-3): prefill as above, ``dot`` equal to the
        ``opaque`` cell's and ``kernel`` B5's formula at this rank's
        heads; train the reference's less :func:`_ssd_train_split`,
        which also holds the scores C.B^T the port's scan computes whole
        on every "model" rank, exactly; recurrentgemma-2b's prefill
        follows llama3.2-3b's rule (its one kv head), exactly."""
    from repro_torch.configs import get_config, reduced_config

    mesh, ref, port = mesh_run
    arch, kind = cell
    cfg = reduced_config(get_config(arch))
    p = port[_key(*cell, mesh)]
    split = p["flops_breakdown"]
    r = ref[_key(*cell, mesh)]
    _, T, B = SHAPES[kind]
    B //= mesh[0]
    heads = _local_heads(arch, mesh[1])
    if kind == "prefill":
        o = ref[_key(*cell, mesh, "opaque")]
        if arch == "mamba2-130m":
            assert o["kernel"] == 0.0        # ROADMAP C15
            assert split["kernel"] == _ssd_formula_flops(p, SHAPES[kind]) > 0
        else:
            assert split["kernel"] == o["kernel"] > 0
        if arch in FLASH_PREFILL:
            flash = port[_key(*cell, mesh, "flash")]["flops_breakdown"]
            assert flash == {"dot": o["dot"], "kernel": o["kernel"]}
        if cfg.n_kv_heads % mesh[1] == 0:
            assert split["dot"] == o["dot"]
        else:
            tile = _attention_tile_flops(arch, B, T) * heads
            assert split["dot"] == r["dot"] - tile
    elif kind == "decode":
        assert split["kernel"] == 0.0
        assert split["dot"] == r["dot"] + _router_split(arch, kind, mesh) \
            - _decode_conv(arch, kind, mesh)
    elif cfg.ssm is not None:
        assert split["kernel"] == 0.0
        assert split["dot"] == r["dot"] - _ssd_train_split(arch, mesh)
    else:
        assert split["kernel"] == 0.0
        T += cfg.n_patches if cfg.family == "vlm" else 0
        tile = _attention_tile_flops(arch, B, T) * heads
        dot = split["dot"]
        if cfg.n_kv_heads % mesh[1]:
            kv = _kv_products(arch, B, T)
            dot += kv * (2 + 6 / mesh[1]) / 8 - kv
        gap = r["dot"] - dot
        print(f"{arch} train {mesh}: reference - port = {gap:.0f} "
              f"FLOPs, {gap / tile:.3f} attention tile forwards")
        assert tile <= gap <= 2 * tile


#: The records at meshes whose "model" axis is 1: (``dot``, ``kernel``)
#: FLOPs and, by collective kind issued, (count, output bytes, ring
#: traffic); at (1, 1) no collective.  As the port gave them before its
#: products were divided over "model" (the parent of ROADMAP D15c-1),
#: but for the serve cells at (2, 1) since the serve steps return their
#: shards (D15c-2a): each lost the all-gathers of its outputs over
#: "data", one a leaf, their bytes the global outputs' (llama3.2-3b
#: prefill 18 -> 15, 286 720 -> 212 992 bytes: 8 192 of logits and 65
#: 536 of cache; mamba2-130m 8 -> 5, 81 408 fewer; whisper-large-v3 7 ->
#: 2, 172 032 fewer), and olmoe-1b-7b's decode, whose dense MoE no
#: longer computes the global batch's experts on every data rank (6 627
#: 328 -> 3 477 504 FLOPs, the reference's) and sums its buffers and
#: products over "data" (the all-reduces).  The recurrent cells (the
#: last four of :data:`CELLS`) as the port gave them before Mamba-2's
#: and RG-LRU's products were divided over "model" (the parent of ROADMAP
#: D15c-3).
MODEL_ONE = {
    ("gemma2-2b", "train", (1, 1)): (197132288, 0, {}),
    ("llama3.2-3b", "prefill", (1, 1)): (38010880, 4194304, {}),
    ("mamba2-130m", "prefill", (1, 1)): (28049408, 12582912, {}),
    ("olmoe-1b-7b", "decode", (1, 1)): (6955008, 0, {}),
    ("olmoe-1b-7b", "prefill", (1, 1)): (420216832, 4194304, {}),
    ("whisper-large-v3", "prefill", (1, 1)): (52690944, 6815744, {}),
    ("internvl2-1b", "train", (1, 1)): (127401984, 0, {}),
    ("gemma2-2b", "train", (2, 1)): (98566144, 0, {
        "all-gather": (57, 1310720, 655360),
        "all-reduce": (11, 2312, 2312),
        "reduce-scatter": (29, 360448, 360448)}),
    ("llama3.2-3b", "prefill", (2, 1)): (19005440, 2097152, {
        "all-gather": (15, 212992, 106496)}),
    ("mamba2-130m", "prefill", (2, 1)): (14024704, 6291456, {
        "all-gather": (5, 174080, 87040)}),
    ("olmoe-1b-7b", "decode", (2, 1)): (3477504, 0, {
        "all-gather": (16, 215168, 107584),
        "all-reduce": (4, 81920, 81920)}),
    ("olmoe-1b-7b", "prefill", (2, 1)): (344326144, 2097152, {
        "all-gather": (20, 1779712, 889856),
        "all-reduce": (2, 1048576, 1048576)}),
    ("whisper-large-v3", "prefill", (2, 1)): (26345472, 3407872, {
        "all-gather": (2, 4259840, 2129920)}),
    ("internvl2-1b", "train", (2, 1)): (63700992, 0, {
        "all-gather": (29, 720896, 360448),
        "all-reduce": (7, 1288, 1288),
        "reduce-scatter": (15, 212992, 212992)}),
    ("mamba2-130m", "decode", (1, 1)): (729088, 0, {}),
    ("recurrentgemma-2b", "prefill", (1, 1)): (128188416, 4194304, {}),
    ("recurrentgemma-2b", "decode", (1, 1)): (2326528, 0, {}),
    ("mamba2-130m", "train", (1, 1)): (91226112, 0, {}),
    ("mamba2-130m", "decode", (2, 1)): (364544, 0, {
        "all-gather": (5, 174080, 87040)}),
    ("recurrentgemma-2b", "prefill", (2, 1)): (64094208, 2097152, {
        "all-gather": (39, 499712, 249856)}),
    ("recurrentgemma-2b", "decode", (2, 1)): (1163264, 0, {
        "all-gather": (39, 499712, 249856)}),
    ("mamba2-130m", "train", (2, 1)): (45613056, 0, {
        "all-gather": (9, 565248, 282624),
        "all-reduce": (17, 8392, 8392),
        "reduce-scatter": (5, 174080, 174080)}),
}


@pytest.mark.parametrize("mesh", [(1, 1), (2, 1)], ids=_tag)
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_model_one_records_unchanged(cell, mesh, tmp_path_factory):
    """Where "model" is 1 the tensor-parallel pieces are the identity:
    each cell's ``flops_breakdown`` and collectives (count, bytes and
    traffic of every kind) equal :data:`MODEL_ONE`'s exactly."""
    dot, kernel, kinds = MODEL_ONE[tuple(cell) + (mesh,)]
    rec = _port_records(mesh, tmp_path_factory)[_key(*cell, mesh)]
    assert rec["flops_breakdown"] == {"dot": dot, "kernel": kernel}
    coll = rec["collectives"]
    assert {k: (n, coll["bytes"][k], coll["traffic"][k])
            for k, n in coll["counts"].items() if n} == kinds
    assert not any(coll["bytes"][k] or coll["traffic"][k]
                   for k in coll["counts"] if k not in kinds)


def _ssd_formula_flops(rec, shape):
    """``B nh T (2 L (ds + hd) + 4 ds hd)`` summed over the layers, at a
    reduced mamba2-130m prefill, each rank's rows and heads (the scan
    runs on the heads "model" divides, ROADMAP D15c-3)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed.sharding import model_share

    cfg = reduced_config(get_config("mamba2-130m"))
    s = cfg.ssm
    n_data, n_model = map(int, rec["mesh"].split("x"))
    B, T = shape[2] // n_data, shape[1]
    nh = model_share(s.n_heads(cfg.d_model), n_model)
    hd, ds, L = s.head_dim, s.d_state, s.chunk
    return float(cfg.n_layers * B * nh * T * (2 * L * (ds + hd)
                                              + 4 * ds * hd))


def test_one_rank_issues_no_collective(mesh_run):
    """At (1, 1) no cell issues a collective; elsewhere every cell does."""
    mesh, _, port = mesh_run
    for cell in CELLS:
        counts = port[_key(*cell, mesh)]["collectives"]["counts"]
        if mesh == (1, 1):
            assert not any(counts.values()), (cell, counts)
        else:
            assert any(counts.values()), (cell, counts)


# ---------------------------------------------------------------------------
# Collectives against a real gloo run
# ---------------------------------------------------------------------------

GLOO_CELLS = [["gemma2-2b", "train", [2, 2], "base", SHAPES["train"]],
              ["llama3.2-3b", "prefill", [2, 2], "base", SHAPES["prefill"]],
              ["olmoe-1b-7b", "decode", [2, 2], "base", SHAPES["decode"]],
              ["gemma2-2b", "decode", [1, 4], "base", SHAPES["decode"]],
              # Mamba-2's in_proj columns moved by one all-to-all, its
              # norm's and out_proj's all-reduces; RG-LRU's gates' input
              # all-gathered (reduce-scattered back in training).
              ["mamba2-130m", "prefill", [1, 4], "base", SHAPES["prefill"]],
              ["recurrentgemma-2b", "prefill", [1, 4], "base",
               SHAPES["prefill"]],
              ["recurrentgemma-2b", "train", [1, 4], "base",
               SHAPES["train"]]]


@pytest.fixture(scope="module")
def gloo_costs(tmp_path_factory):
    """(the fake-group trace's records, the real 4-rank gloo run's
    collectives) of :data:`GLOO_CELLS`."""
    import sharded_port as SP

    work = tmp_path_factory.mktemp("dryrun_gloo")
    fake = _port(work, "fake", GLOO_CELLS)
    (work / "cost_cases.json").write_text(json.dumps(GLOO_CELLS))
    real = SP.run_costs(4, work)
    return _result(work, "fake", fake), real


@pytest.mark.parametrize("cell", GLOO_CELLS,
                         ids=lambda c: c[1] if c[1] != "decode" and c[0] in (
                             "gemma2-2b", "llama3.2-3b") else
                         f"{c[0]}-{c[1]}")
def test_collectives_match_gloo_run(gloo_costs, cell):
    """Counts, output bytes and ring traffic of every collective kind,
    from the fake 4-rank group's trace and from the same step run on
    four gloo ranks: equal; the decode cells take the divided dense MoE
    (olmoe-1b-7b at (2, 2): its all-reduces over "data") and the window
    cache's shift across shards (gemma2-2b at (1, 4): the
    collective-permute), the recurrent cells Mamba-2's and RG-LRU's
    products over "model" (the uneven all-to-all of in_proj's columns,
    the gates' all-gather and its reduce-scatter backward)."""
    fake, real = gloo_costs
    key = _key(cell[0], cell[1], cell[2])
    assert fake[key]["collectives"] == real[key]
    assert sum(real[key]["counts"].values()) > 0


# ---------------------------------------------------------------------------
# launch.cost on small functions (the reference's TestHLOCostAnalyzer)
# ---------------------------------------------------------------------------


def _layers(x, ws):
    for w in ws:
        x = torch.tanh(x @ w)
    return x


@pytest.mark.parametrize("L", [2, 3, 8])
def test_loop_flops_scale_with_layers(L):
    """An L-layer loop counts L times one layer's FLOPs (and
    transcendentals): a Python loop runs every trip."""
    from repro_torch.launch import cost as C

    x = torch.randn(16, 32)
    ws = [torch.randn(32, 32) for _ in range(L)]
    one = C.analyze(_layers, x, ws[:1])
    many = C.analyze(_layers, x, ws)
    assert one.flops == 2 * 16 * 32 * 32
    assert many.flops == L * one.flops
    assert many.transcendentals == L * one.transcendentals == L * 16 * 32


def test_matmul_counts_two_n_cubed():
    """A 64^3 product counts at least (exactly) 2 * 64^3 FLOPs, all of
    them ``dot``; its bytes are its operands and result."""
    from repro_torch.launch import cost as C

    a, b = torch.randn(64, 64), torch.randn(64, 64)
    tr = C.trace(torch.matmul, a, b)
    assert tr.cost.flops >= 2 * 64 ** 3
    assert tr.breakdown() == {"dot": 2.0 * 64 ** 3, "kernel": 0.0}
    assert tr.cost.bytes == 3 * 64 * 64 * 4
    assert not any(tr.cost.coll_counts.values())


@pytest.fixture
def fake_group():
    """A fake 8-rank process group (rank 0) in this process."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield dist.group.WORLD
    dist.destroy_process_group()


def _collective(kind, x, group):
    import torch.distributed as dist
    import torch.distributed._functional_collectives as F

    if kind == "all-gather":
        out = F.all_gather_tensor(x, 0, group)
    elif kind == "reduce-scatter":
        out = F.reduce_scatter_tensor(x, "sum", 0, group)
    elif kind == "all-reduce":
        out = F.all_reduce(x, "sum", group)
    elif kind == "all-to-all":
        out = F.all_to_all_single(x, None, None, group)
    else:
        dist.broadcast(x, src=0, group=group)
        return x
    return F.wait_tensor(out)


@pytest.mark.parametrize("kind", ["all-gather", "reduce-scatter",
                                  "all-reduce", "all-to-all",
                                  "collective-permute"])
def test_collective_ring_multiplier(fake_group, kind):
    """One collective over 8 ranks: counted once under its kind, its
    output bytes on this rank, traffic = bytes x the reference's ring
    multiplier for k = 8 (all-gather and all-to-all 7/8, reduce-scatter
    7, all-reduce 14/8, a broadcast as a collective-permute 1)."""
    from repro_torch.launch import cost as C

    x = torch.randn(64, 16)
    c = C.analyze(lambda t: _collective(kind, t, fake_group), x)
    out = {"all-gather": 8 * x.nbytes,
           "reduce-scatter": x.nbytes // 8}.get(kind, x.nbytes)
    mult = {"all-gather": 7 / 8, "reduce-scatter": 7.0, "all-reduce": 14 / 8,
            "all-to-all": 7 / 8, "collective-permute": 1.0}[kind]
    assert c.coll_counts == {k: float(k == kind) for k in C.KINDS}
    assert c.coll_bytes[kind] == out
    assert c.coll_traffic[kind] == pytest.approx(out * mult, rel=1e-12)
    assert C.RING[kind](8) == pytest.approx(mult, rel=1e-12)


# ---------------------------------------------------------------------------
# B4 and B5 as custom ops
# ---------------------------------------------------------------------------

FA_CASES = {
    "causal": dict(G=1, causal=True, window=None, softcap=None,
                   kv_valid=None),
    "window": dict(G=1, causal=True, window=5, softcap=None, kv_valid=None),
    "softcap": dict(G=1, causal=True, window=None, softcap=30.0,
                    kv_valid=None),
    "kv_valid": dict(G=1, causal=False, window=None, softcap=None,
                     kv_valid=7),
    "gqa": dict(G=3, causal=True, window=None, softcap=None, kv_valid=None),
    "bidirectional": dict(G=2, causal=False, window=None, softcap=None,
                          kv_valid=None),
}


def _fa_inputs(G, dtype=torch.float32, T=11, S=11, hd=16, BK=2):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(BK * G, T, hd, generator=g).to(dtype)
    k = torch.randn(BK, S, hd, generator=g).to(dtype)
    v = torch.randn(BK, S, hd, generator=g).to(dtype)
    return q, k, v


def _meta(t):
    return tuple(t.shape), t.dtype, tuple(t.stride())


@pytest.mark.parametrize("case", sorted(FA_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_custom_op(case, dtype):
    """``repro_torch::flash_attention`` passes ``torch.library.opcheck``
    (schema, fake tensor, dispatch) on its CPU implementation, its fake
    output has the plain output's shape, dtype and strides, and through
    ``flash_attention_fwd`` its values are the plain version's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.plain import \
        flash_attention_plain

    kw = dict(FA_CASES[case])
    q, k, v = _fa_inputs(kw.pop("G"), dtype)
    args = (q, k, v, kw["causal"], kw["window"], kw["softcap"],
            kw["kv_valid"])
    torch.library.opcheck(torch.ops.repro_torch.flash_attention.default,
                          args)
    got = FA.flash_attention_fwd(q, k, v, **kw)
    assert torch.equal(got, flash_attention_plain(q, k, v, **kw))
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        fake = torch.ops.repro_torch.flash_attention(fq, fk, fv, *args[3:])
    assert _meta(fake) == _meta(got)


@pytest.mark.parametrize("chunk", [8, 16, 37, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_scan_custom_op(chunk, dtype):
    """``repro_torch::ssd_scan`` passes ``opcheck`` on its CPU
    implementation at chunks shorter than, equal to and longer than T
    (37), its fake outputs have the CPU outputs' shapes, dtypes and
    strides (contiguous, as the launch makes them), and its values are
    the plain scan's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.ssd_scan import ops as SO
    from repro_torch.kernels.ssd_scan.plain import ssd_scan_plain

    g = torch.Generator().manual_seed(1)
    BH, BG, T, hd, ds = 6, 2, 37, 16, 8
    x = torch.randn(BH, T, hd, generator=g).to(dtype)
    Bm = torch.randn(BG, T, ds, generator=g).to(dtype)
    Cm = torch.randn(BG, T, ds, generator=g).to(dtype)
    dt = torch.rand(BH, T, generator=g) * 0.1
    dA = -dt * 2.0
    args = (x, Bm, Cm, dt, dA, chunk)
    torch.library.opcheck(torch.ops.repro_torch.ssd_scan.default, args)
    y, H = SO.ssd_scan_fwd(*args[:5], chunk=chunk)
    want = ssd_scan_plain(*args)
    assert torch.equal(y, want[0]) and torch.equal(H, want[1])
    assert y.is_contiguous() and H.is_contiguous()
    with FakeTensorMode() as mode:
        fy, fH = torch.ops.repro_torch.ssd_scan(
            *(mode.from_tensor(t) for t in args[:5]), chunk)
    assert (_meta(fy), _meta(fH)) == (_meta(y), _meta(H))


def _ref_kernel_flops(marker, operand_shapes, out_shapes):
    """The reference's ``hlo_cost._opaque_kernel_cost`` on a custom-call
    with these operand shapes (bf16) and outputs plus its marker."""
    from repro.launch import hlo_cost as HC

    symtab = {f"a{i}": [("bf16", s)] for i, s in enumerate(operand_shapes)}
    ins = HC._Instr("cc", [("bf16", s) for s in out_shapes]
                    + [("f32", (marker,))], "custom-call", "")
    return HC._opaque_kernel_cost(ins, symtab, list(symtab))[0]


@pytest.mark.parametrize("case", [(True, None, 2, 3, 64, 64),
                                  (False, None, 1, 4, 40, 56),
                                  (True, 16, 2, 2, 64, 64),
                                  (True, 128, 1, 3, 64, 64)])
def test_flash_attention_flop_formula_is_the_reference(case):
    """B4's FLOP formula equals ``hlo_cost``'s count of the reference's
    stand-in with the same configuration (causal 101, full 103, window
    10000 + w) on the same q (B, T, K, G, hd) and k (B, S, K, hd)."""
    from torch.utils.flop_counter import FlopCounterMode

    causal, window, K, G, T, S = case
    B, hd = 2, 16
    marker = 10000 + window if window else (101 if causal else 103)
    want = _ref_kernel_flops(marker, [(B, T, K, G, hd), (B, S, K, hd),
                                      (B, S, K, hd)], [(B, T, K, G, hd)])
    q = torch.zeros(B * K * G, T, hd)
    k = v = torch.zeros(B * K, S, hd)
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.flash_attention(q, k, v, causal, window, None,
                                              None)
    assert want > 0 and fc.get_total_flops() == want


@pytest.mark.parametrize("chunk", [16, 32, 256])
def test_ssd_flop_formula_is_the_reference(chunk):
    """B5's FLOP formula is ``hlo_cost.py:191-200``'s ``B nh T (2 L (ds +
    hd) + 4 ds hd)`` with L the configured chunk; ``hlo_cost`` itself
    returns 0 for the scan's stand-in, whose marker 30000 + L its
    windowed-flash branch takes first (ROADMAP C15)."""
    from torch.utils.flop_counter import FlopCounterMode

    B, T, nh, hd, ds = 2, 48, 3, 16, 8
    assert _ref_kernel_flops(30000 + chunk, [(B, T, nh, hd), (B, T, ds),
                                             (B, T, ds), (B, T, nh), (nh,)],
                             [(B, T, nh, hd), (B, nh, hd, ds)]) == 0.0
    x = torch.zeros(B * nh, T, hd)
    Bm = Cm = torch.zeros(B, T, ds)
    dt = dA = torch.zeros(B * nh, T)
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.ssd_scan(x, Bm, Cm, dt, dA, chunk)
    assert fc.get_total_flops() == B * nh * T * (2 * chunk * (ds + hd)
                                                 + 4 * ds * hd)


# ---------------------------------------------------------------------------
# Records on the production meshes, the variants, the launchers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def production_records(tmp_path_factory):
    """``python -m repro_torch.launch.dryrun --smoke --mesh both`` for
    llama3.2-3b at train_4k, prefill_32k and decode_32k (a process for
    each, at once): {(shape, mesh): record}."""
    out = tmp_path_factory.mktemp("dryrun_production")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-3b", "--shape", s, "--mesh", "both", "--smoke",
         "--out-dir", str(out)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for s in ("train_4k", "prefill_32k", "decode_32k")]
    for p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log[-4000:]
    return {(s, m): json.loads(
        (out / f"llama3.2-3b__{s}__{m}.json").read_text())
        for s in ("train_4k", "prefill_32k", "decode_32k")
        for m in ("single", "multi")}


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_production_record_keys(production_records, shape, mesh):
    """A fake 256-rank (16 x 16) or 512-rank (2 x 16 x 16) group: the
    record has every key of the reference's record (``trace_s`` for
    ``lower_s`` and ``compile_s``), its memory keys (alias and generated
    code null), collectives by the five kinds, and the kernel calls of
    the kind (prefill: one B4 call a layer; no stand-in under ``base``);
    a serve cell's step holds its argument bytes exactly."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import cost as C

    rec = production_records[(shape, mesh)]
    assert REF_KEYS <= set(rec) and "trace_s" in rec
    assert REF_MEMORY_KEYS <= set(rec["memory"])
    assert rec["memory"]["alias_bytes"] is None
    assert rec["memory"]["generated_code_bytes"] is None
    assert rec["n_devices"] == (256 if mesh == "single" else 512)
    assert rec["status"] == "ok" and rec["device"] == "cuda"
    for part in ("bytes", "traffic", "counts"):
        assert set(rec["collectives"][part]) == set(C.KINDS)
    assert sum(rec["collectives"]["counts"].values()) > 0
    from repro_torch.kernels.opaque import OPS

    cfg = reduced_config(get_config("llama3.2-3b"))
    want = cfg.n_layers if shape == "prefill_32k" else 0
    assert rec["kernel_calls"] == dict({"flash_attention": want,
                                        "ssd_scan": 0},
                                       **{op: 0 for op in OPS})
    assert rec["flops_breakdown"]["kernel"] > 0 if want else \
        rec["flops_breakdown"]["kernel"] == 0
    assert rec["memory"]["total_bytes"] == (
        rec["memory"]["step_argument_bytes"] + rec["memory"]["temp_bytes"])
    if shape != "train_4k":      # the serve steps take their shards
        assert rec["memory"]["step_argument_bytes"] == \
            rec["memory"]["argument_bytes"]


def test_long_context_skips_as_the_reference(tmp_path):
    """``long_500k`` on a config without long context: a ``skipped``
    record with the reference's reason, no trace."""
    from repro_torch.launch import dryrun as DR

    rec = DR.run_cell("llama3.2-3b", "long_500k", "single", tmp_path)
    assert rec["status"] == "skipped" and rec["reason"] == DR.SKIP_REASON
    assert json.loads((tmp_path / "llama3.2-3b__long_500k__single.json")
                      .read_text()) == rec


@pytest.mark.parametrize("variant,err", [("turbo", ValueError)])
def test_later_variants_raise(variant, err):
    """An unknown flag raises; ``base``, ``kvint8``, ``ep``, ``flash``,
    ``ssdk`` and their joins are taken, and the stand-in flags set
    ``REPRO_OPAQUE_KERNELS=1`` beside their own switches."""
    from repro_torch.launch import dryrun as DR

    with pytest.raises(err, match="unknown"):
        DR.variant_flags(variant)
    assert DR.variant_flags("kvint8+ep") == {"kvint8", "ep"}
    assert DR.variant_flags("flash+kvint8") == {"flash", "kvint8"}
    assert DR.variant_flags("base") == set()
    env = DR.variant_env(DR.variant_flags("flash+ssdk"))
    assert env["REPRO_OPAQUE_KERNELS"] == "1"
    assert env["REPRO_ATTN_IMPL"] == "flash"
    assert env["REPRO_PALLAS_SSD"] == "opaque"
    assert env["REPRO_KV_INT8"] == "0"
    assert DR.variant_env(DR.variant_flags("kvint8+ep"))[
        "REPRO_OPAQUE_KERNELS"] == "0"


#: The stand-in variants on the production meshes: (variant, arch,
#: shape), reduced configs.
STANDIN_VARIANTS = [("flash", "llama3.2-3b", "train_4k"),
                    ("ssdk", "mamba2-130m", "train_4k"),
                    ("flash+kvint8", "llama3.2-3b", "decode_32k"),
                    ("flash+ep", "olmoe-1b-7b", "decode_32k")]


@pytest.fixture(scope="module")
def standin_records(tmp_path_factory):
    """``python -m repro_torch.launch.dryrun --smoke --mesh both
    --variant V`` for each of :data:`STANDIN_VARIANTS` (a process for
    each, at once): {(variant, mesh): record}."""
    out = tmp_path_factory.mktemp("dryrun_standins")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
         "--shape", s, "--mesh", "both", "--smoke", "--variant", v,
         "--out-dir", str(out)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for v, a, s in STANDIN_VARIANTS]
    for p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log[-4000:]
    return {(v, m): json.loads((out / f"{a}__{s}__{m}__{v}.json").read_text())
            for v, a, s in STANDIN_VARIANTS for m in ("single", "multi")}


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("variant", [v for v, _, _ in STANDIN_VARIANTS])
def test_standin_variant_records(standin_records, production_records,
                                 variant, mesh):
    """``flash``, ``ssdk``, ``flash+kvint8`` and ``flash+ep`` are taken
    on fake 256- and 512-rank groups: each record has every key of the
    reference's record, its variant, ``kernel`` FLOPs from the variant's
    stand-ins (counted by name in ``kernel_calls``), a note naming them,
    and, for llama3.2-3b, a ``dot`` below the same cell's ``base``
    record's (the attention products moved into the stand-ins)."""
    from repro_torch.kernels import opaque

    rec = standin_records[(variant, mesh)]
    assert REF_KEYS <= set(rec) and REF_MEMORY_KEYS <= set(rec["memory"])
    assert rec["status"] == "ok" and rec["variant"] == variant
    assert rec["n_devices"] == (256 if mesh == "single" else 512)
    assert set(rec["kernel_calls"]) == {"flash_attention", "ssd_scan",
                                        *opaque.OPS}
    ops = {"flash": ("flash_attention_fwd_standin",
                     "flash_attention_bwd_standin"),
           "ssdk": ("ssd_scan_fwd_standin", "ssd_scan_bwd_standin"),
           "flash+kvint8": ("decode_attention_standin",),
           "flash+ep": ("decode_attention_standin",)}[variant]
    calls = {k: n for k, n in rec["kernel_calls"].items() if n}
    assert set(calls) == set(ops)
    assert all(op in rec["variant_note"] for op in ops)
    assert rec["flops_breakdown"]["kernel"] > 0 and rec["kernel_bytes"] > 0
    shape = {"flash": "train_4k", "flash+kvint8": "decode_32k"}.get(variant)
    if shape is not None:
        base = production_records[(shape, mesh)]
        assert rec["flops_breakdown"]["dot"] < base["flops_breakdown"]["dot"]


def test_serve_dry_run(tmp_path):
    """``launch.serve --dry-run --smoke``: prefill_32k and decode_32k of
    the reduced llama3.2-3b on the 16 x 16 mesh, each record written."""
    from repro_torch.launch import serve as SV

    SV.main(["--arch", "llama3.2-3b", "--smoke", "--dry-run", "--out-dir",
             str(tmp_path)])
    for s in ("prefill_32k", "decode_32k"):
        rec = json.loads((tmp_path / f"llama3.2-3b__{s}__single.json")
                         .read_text())
        assert rec["status"] == "ok" and rec["n_devices"] == 256


@pytest.mark.parametrize("arch,shape,variant", [
    ("llama3.2-3b", "decode_32k", "kvint8"),
    ("olmoe-1b-7b", "prefill_32k", "ep")])
def test_variant_changes_the_cell(tmp_path, arch, shape, variant):
    """A variant's switch reaches the traced program, against ``base`` on
    the same fake group (reduced configs): ``kvint8`` at (1, 4) makes the
    decode cache int8 with scales, so the argument bytes fall; ``ep`` at
    (2, 2) runs the expert-parallel MoE, whose ranks dispatch their own
    rows with a local capacity where the dense dispatch's buffers hold
    the global batch's (ROADMAP D15c-2a), so the FLOPs fall and the
    dense dispatch's all-reduces of its buffers over "data" go.  The
    record's file carries the variant."""
    mesh = "2x2" if variant == "ep" else "1x4"
    recs = {}
    for v in ("base", variant):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--smoke",
             "--variant", v, "--out-dir", str(tmp_path)], env=_env(),
            capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
        tag = "" if v == "base" else f"__{v}"
        recs[v] = json.loads((tmp_path / f"{arch}__{shape}__{mesh}{tag}.json")
                             .read_text())
        assert recs[v]["variant"] == v and recs[v]["status"] == "ok"
    base, var = recs["base"], recs[variant]
    if variant == "kvint8":
        assert var["memory"]["argument_bytes"] < \
            base["memory"]["argument_bytes"]
        assert var["flops_per_device"] == base["flops_per_device"]
    else:
        assert var["flops_per_device"] < base["flops_per_device"]
        counts = var["collectives"]["counts"]
        assert counts["all-reduce"] < base["collectives"]["counts"][
            "all-reduce"]
