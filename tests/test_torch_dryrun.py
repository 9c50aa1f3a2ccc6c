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
    leaf, which is not data); on
    meshes whose "model" axis is 1, ``dot`` FLOPs equal to
    ``hlo_cost.breakdown``'s, and a prefill's ``dot + kernel`` equal to
    the reference's cell with its kernel stand-ins (``dot +
    custom-call(kernel)``); on (2, 2) and (1, 4) the port's FLOPs over
    the reference's at most the model axis size (ROADMAP D15c: every
    "model" rank computes its rows in full, so the port's count is the
    model-1 mesh's) and above 1, printed;
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
    every key of the reference's, for each kind; ``long_500k`` skips
    where the reference skips; the variants;
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
         ("whisper-large-v3", "prefill"), ("internvl2-1b", "train")]
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


def _port_cells(mesh):
    return [[a, k, list(mesh), "base", SHAPES[k]] for a, k in CELLS]


def _port_records(mesh, tmp_path_factory):
    """The port's records of :data:`CELLS` on ``mesh`` (made once)."""
    mesh = tuple(mesh)
    if mesh not in _PORT:
        work = tmp_path_factory.mktemp(f"dryrun_port_{_tag(mesh)}")
        _PORT[mesh] = _result(work, "port",
                              _port(work, "port", _port_cells(mesh)))
    return _PORT[mesh]


@pytest.fixture(scope="module", params=MESHES, ids=_tag)
def mesh_run(request, tmp_path_factory):
    """(mesh, the reference's cells, the port's records) of one mesh
    shape; on a mesh without a "model" axis the reference's prefill
    cells also with its kernel stand-ins (variant ``opaque``)."""
    mesh = tuple(request.param)
    work = tmp_path_factory.mktemp(f"dryrun_{_tag(mesh)}")
    cells = _port_cells(mesh)
    ref_cells = cells + ([[a, k, list(mesh), "opaque", SHAPES[k]]
                          for a, k in CELLS if k == "prefill"]
                         if mesh[1] == 1 else [])
    ref = _reference(work, "ref", ref_cells)
    if mesh not in _PORT:
        port = _port(work, "port", cells)
        _PORT[mesh] = _result(work, "port", port)
    ref = _result(work, "ref", ref)
    _REF_DOTS.setdefault(mesh, {k: v["dot"] for k, v in ref.items()})
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
    exactly; a differing argument leaf is named."""
    mesh, ref, port = mesh_run
    r, p = ref[_key(*cell, mesh)], port[_key(*cell, mesh)]
    bad = {k: (p["leaves"].get(k), r["leaves"].get(k))
           for k in set(p["leaves"]) | set(r["leaves"])
           if p["leaves"].get(k) != r["leaves"].get(k)}
    assert not bad, f"argument leaves (port, reference): {bad}"
    assert p["memory"]["argument_bytes"] == r["argument_bytes"]
    # XLA's output size also counts the output tuple's index table, 8
    # bytes a leaf; the outputs' data is the rest.
    assert r["output_bytes"] == r["output_data_bytes"] + 8 * r["output_leaves"]
    assert p["memory"]["output_bytes"] == r["output_data_bytes"]
    assert p["status"] == "ok" and p["device"] == "cuda"


def _layer_kinds(cfg):
    return (list(cfg.block_pattern) * cfg.unit_count()
            + list(cfg.tail_pattern()))


def _attention_tile_flops(arch, B, T):
    """One forward pass of every self-attention layer's tile products
    (the port's training attention, blockwise or windowed) at B rows of
    T positions."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import LOCAL, get_config, reduced_config
    from repro_torch.models import attention as A

    cfg = reduced_config(get_config(arch))
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    q = torch.zeros(B, T, K, cfg.n_heads // K, hd)
    k = v = torch.zeros(B, T, K, hd)
    pos = torch.arange(T, dtype=torch.int32)
    total = 0
    for kind in _layer_kinds(cfg):
        with FlopCounterMode(display=False) as fc:
            if kind == LOCAL:
                A.windowed_attention(cfg, q, k, v, pos, cfg.window)
            else:
                A.blockwise_attention(cfg, q, k, v, pos, pos, causal=True)
        total += fc.get_total_flops()
    return total


def _moe_flops(arch, n_tokens):
    """The dense MoE dispatch's products over ``n_tokens`` tokens, summed
    over the MoE layers."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm as LM
    from repro_torch.models import moe as MOE

    cfg = reduced_config(get_config(arch))
    p = MOE.moe_init(torch.Generator().manual_seed(0), cfg, cfg.moe)
    with FlopCounterMode(display=False) as fc:
        MOE.moe_apply(cfg, cfg.moe, p, torch.zeros(n_tokens, 1, cfg.d_model))
    n = len(cfg.block_pattern)
    layers = sum(LM._moe_here(cfg, i % n) for i, _ in
                 enumerate(_layer_kinds(cfg)))
    return layers * fc.get_total_flops()


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_flops_match_reference(mesh_run, cell, tmp_path_factory):
    """Where "model" is 1, against ``hlo_cost.breakdown``:

      * prefill: ``dot`` and ``kernel`` each equal to the reference's
        cell with its kernel stand-ins (``dot``, ``custom-call(kernel)``),
        exactly; but mamba2-130m's scan, which ``hlo_cost`` counts as 0
        FLOPs (its windowed-flash branch, ``marker >= 10000``, takes the
        scan's markers 30000 + L first: ROADMAP C15), is held to the
        formula of ``hlo_cost.py:191-200``;
      * decode: ``dot`` equal exactly at (1, 1); at (2, 1) the port's
        dense MoE dispatch computes the global batch's experts on every
        data rank (it gathers the tokens for the reference's global
        capacity; ROADMAP D15c), so the port counts the reference's
        FLOPs plus (1 - 1/data) of the MoE products, exactly;
      * train: the reference's attention rematerializes its tiles once
        more inside the attention's backward (``jax.checkpoint`` on its
        tile steps, ``models/attention.py:174, 202, 239``), the port's
        only with its unit; the port counts fewer, by between one and
        two forward passes of the attention tile products (the
        tolerance), and no more.

    Where "model" is above 1 (ROADMAP D15c): the port's count is the
    mesh without the model axis's, exactly (each "model" rank computes
    its batch rows in full), and its ratio to the reference's is above 1
    and at most the model axis size times that mesh's ratio (the
    reference divides its work by at most the model axis size)."""
    mesh, ref, port = mesh_run
    arch, kind = cell
    p = port[_key(*cell, mesh)]
    split = p["flops_breakdown"]
    total = split["dot"] + split["kernel"]
    if mesh[1] == 1:
        r = ref[_key(*cell, mesh)]
        if kind == "prefill":
            o = ref[_key(*cell, mesh, "opaque")]
            assert split["dot"] == o["dot"]
            if arch == "mamba2-130m":
                assert o["kernel"] == 0.0        # ROADMAP C15
                assert split["kernel"] == _ssd_formula_flops(p, SHAPES[kind])
            else:
                assert split["kernel"] == o["kernel"] > 0
        elif kind == "decode":
            assert split["kernel"] == 0.0
            _, T, B = SHAPES[kind]
            excess = (1 - 1 / mesh[0]) * _moe_flops(arch, B)
            assert split["dot"] == r["dot"] + excess
        else:
            assert split["kernel"] == 0.0
            _, T, B = SHAPES[kind]
            from repro_torch.configs import get_config, reduced_config

            cfg = reduced_config(get_config(arch))
            T += cfg.n_patches if cfg.family == "vlm" else 0
            tile = _attention_tile_flops(arch, B // mesh[0], T)
            gap = r["dot"] - split["dot"]
            print(f"{arch} train {mesh}: reference - port = {gap:.0f} "
                  f"FLOPs, {gap / tile:.3f} attention tile forwards")
            assert tile <= gap <= 2 * tile
        return
    base_mesh = (mesh[0], 1)
    no_model = _port_records(base_mesh, tmp_path_factory)
    assert split == no_model[_key(*cell, base_mesh)]["flops_breakdown"]
    ref_base = _reference_dots(base_mesh, tmp_path_factory)[
        _key(*cell, base_mesh)]
    r = ref[_key(*cell, mesh)]
    ratio, base_ratio = total / r["dot"], total / ref_base
    print(f"{arch} {kind} mesh {mesh}: port/reference FLOPs {ratio:.4f}; "
          f"the reference divides its {base_mesh} count by "
          f"{ref_base / r['dot']:.4f} over the model axis (D15c bound "
          f"{mesh[1] * base_ratio:.4f})")
    assert 1.0 < ratio <= mesh[1] * base_ratio * (1 + 1e-12)


#: The reference's base-variant ``dot`` by mesh, as a test first needs it.
_REF_DOTS = {}


def _reference_dots(mesh, tmp_path_factory):
    mesh = tuple(mesh)
    if mesh not in _REF_DOTS:
        work = tmp_path_factory.mktemp(f"dryrun_ref_{_tag(mesh)}")
        out = _result(work, "ref", _reference(work, "ref",
                                              _port_cells(mesh)))
        _REF_DOTS[mesh] = {k: v["dot"] for k, v in out.items()}
    return _REF_DOTS[mesh]


def _ssd_formula_flops(rec, shape):
    """``B nh T (2 L (ds + hd) + 4 ds hd)`` summed over the layers, at a
    reduced mamba2-130m prefill, each rank's rows."""
    from repro_torch.configs import get_config, reduced_config

    cfg = reduced_config(get_config("mamba2-130m"))
    s = cfg.ssm
    n_data = int(rec["mesh"].split("x")[0])
    B, T = shape[2] // n_data, shape[1]
    nh, hd, ds, L = s.n_heads(cfg.d_model), s.head_dim, s.d_state, s.chunk
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
              ["llama3.2-3b", "prefill", [2, 2], "base", SHAPES["prefill"]]]


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


@pytest.mark.parametrize("cell", GLOO_CELLS, ids=lambda c: c[1])
def test_collectives_match_gloo_run(gloo_costs, cell):
    """Counts, output bytes and ring traffic of every collective kind,
    from the fake 4-rank group's trace and from the same step run on
    four gloo ranks: equal."""
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
    the kind (prefill: one B4 call a layer)."""
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
    cfg = reduced_config(get_config("llama3.2-3b"))
    want = cfg.n_layers if shape == "prefill_32k" else 0
    assert rec["kernel_calls"] == {"flash_attention": want, "ssd_scan": 0}
    assert rec["flops_breakdown"]["kernel"] > 0 if want else \
        rec["flops_breakdown"]["kernel"] == 0
    assert rec["memory"]["total_bytes"] == (
        rec["memory"]["step_argument_bytes"] + rec["memory"]["temp_bytes"])


def test_long_context_skips_as_the_reference(tmp_path):
    """``long_500k`` on a config without long context: a ``skipped``
    record with the reference's reason, no trace."""
    from repro_torch.launch import dryrun as DR

    rec = DR.run_cell("llama3.2-3b", "long_500k", "single", tmp_path)
    assert rec["status"] == "skipped" and rec["reason"] == DR.SKIP_REASON
    assert json.loads((tmp_path / "llama3.2-3b__long_500k__single.json")
                      .read_text()) == rec


@pytest.mark.parametrize("variant,err", [("flash", NotImplementedError),
                                         ("ssdk", NotImplementedError),
                                         ("kvint8+flash", NotImplementedError),
                                         ("turbo", ValueError)])
def test_later_variants_raise(variant, err):
    """``flash`` and ``ssdk`` (the reference's kernel stand-ins) raise
    naming D15b-2; an unknown flag raises; ``base``, ``kvint8``, ``ep``
    and their joins are taken."""
    from repro_torch.launch import dryrun as DR

    with pytest.raises(err, match="D15b-2" if err is NotImplementedError
                       else "unknown"):
        DR.variant_flags(variant)
    assert DR.variant_flags("kvint8+ep") == {"kvint8", "ep"}
    assert DR.variant_flags("base") == set()


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
    the same (1, 4) fake group (reduced configs): ``kvint8`` makes the
    decode cache int8 with scales, so the argument bytes fall;
    ``ep`` runs the expert-parallel MoE, the one layer that divides its
    products over "model", so the FLOPs fall and its combine adds
    all-reduces.  The record's file carries the variant."""
    recs = {}
    for v in ("base", variant):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "1x4", "--smoke",
             "--variant", v, "--out-dir", str(tmp_path)], env=_env(),
            capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
        tag = "" if v == "base" else f"__{v}"
        recs[v] = json.loads((tmp_path / f"{arch}__{shape}__1x4{tag}.json")
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
        assert counts["all-reduce"] > base["collectives"]["counts"][
            "all-reduce"]
