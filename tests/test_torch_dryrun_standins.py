"""The dry-run's kernel stand-ins (``repro_torch.kernels.opaque``) and its
``flash``, ``ssdk`` and ``flash+kvint8`` variants against the reference's
(``kernels/opaque.py``, ``launch/hlo_cost.py``).

The reference's cells are compiled on a host mesh of 4 CPU devices with
the variant's switches set as its ``launch/dryrun.py`` sets them
(``tests/dryrun_reference.py``); the port's are traced on fake CUDA
tensors over a fake process group (``tests/dryrun_port.py``), both at
once, at reduced configs:

  * meshes (1, 1) and (2, 1), the cells of :data:`CELLS`: ``dot`` and
    ``kernel`` FLOPs equal to ``hlo_cost.breakdown``'s exactly, but the
    scan's ``kernel``, which ``hlo_cost`` counts as 0 (C15), held to
    its formula; the stand-ins' bytes equal to the reference's
    ``custom-call(kernel)`` bytes up to the operands named in
    :func:`test_standin_bytes_match_reference`; argument and output
    bytes equal to ``memory_analysis``'s; the stand-ins' calls;
  * mesh (2, 2), gemma2-2b's train cell under ``flash``: its (2, 1)
    count halved and the reference's ``dot`` and ``kernel``, exactly
    (the products divided over "model", ROADMAP D15c-1);
  * each op: its fake results against the reference stand-in's result
    shapes and dtypes (``jax.eval_shape``), its FLOP formula against
    ``hlo_cost._opaque_kernel_cost`` on the same operand shapes, its
    raising on real tensors, and gradients through
    ``register_autograd`` under ``FakeTensorMode``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import opaque as O

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"

#: The reduced cells' shapes: [name, seq_len, global batch] by kind.
SHAPES = {"train": ["train_small", 32, 4], "decode": ["decode_small", 64, 4]}
#: (arch, kind, variant): windowed (gemma2's local layers, with softcap)
#: and causal flash; bidirectional and cross flash; decode over bf16 and
#: int8 caches; the SSD scan.
CELLS = [("gemma2-2b", "train", "flash"),
         ("whisper-large-v3", "train", "flash"),
         ("llama3.2-3b", "decode", "flash"),
         ("llama3.2-3b", "decode", "flash+kvint8"),
         ("mamba2-130m", "train", "ssdk")]
MESHES = [(1, 1), (2, 1)]


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(TESTS)])
    return env


def _start(work, name, cells, port):
    from repro_torch.launch import fake_cuda

    (work / f"{name}.json").write_text(json.dumps(cells))
    cmd = (fake_cuda.python_cmd("dryrun_port", [str(work), name]) if port
           else [sys.executable, str(TESTS / "dryrun_reference.py"),
                 str(work), name])
    return subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _result(work, name, proc):
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-4000:]
    return json.loads((work / f"{name}.out.json").read_text())


def _cells(mesh, cells=CELLS):
    return [[a, k, list(mesh), v, SHAPES[k]] for a, k, v in cells]


def _key(arch, kind, variant, mesh):
    return f"{arch}/{kind}/{mesh[0]}x{mesh[1]}/{variant}"


def _run(tmp_path_factory, tag, cells):
    """(the reference's cells, the port's records), run at once."""
    work = tmp_path_factory.mktemp(f"standins_{tag}")
    ref = _start(work, "ref", cells, port=False)
    port = _start(work, "port", cells, port=True)
    return _result(work, "ref", ref), _result(work, "port", port)


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def mesh_run(request, tmp_path_factory):
    mesh = tuple(request.param)
    ref, port = _run(tmp_path_factory, f"{mesh[0]}x{mesh[1]}", _cells(mesh))
    return mesh, ref, port


def _cfg(arch):
    from repro_torch.configs import get_config, reduced_config

    return reduced_config(get_config(arch))


def _attention_layers(cfg):
    """(self-attention layers, cross-attention layers) of a reduced
    config; the encoder's layers count as self-attention."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + cfg.n_layers, cfg.n_layers
    return cfg.n_layers, 0


def _ssd_fwd_flops(cfg, B, T):
    """``B nh T (2 L (ds + hd) + 4 ds hd)``, the scan branch of
    ``hlo_cost._opaque_kernel_cost`` (``hlo_cost.py:191-200``)."""
    s = cfg.ssm
    nh, hd, ds, L = s.n_heads(cfg.d_model), s.head_dim, s.d_state, s.chunk
    return B * nh * T * (2 * L * (ds + hd) + 4 * ds * hd)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[2]}")
def test_standin_flops_match_reference(mesh_run, cell):
    """``dot`` and ``kernel`` FLOPs equal to ``hlo_cost.breakdown``'s of
    the reference's cell with the same variant, exactly.  The scan's
    stand-ins count 0 there (its windowed-flash branch takes the markers
    30000 + L first: ROADMAP C15); the port's ``kernel`` is the scan
    branch's formula for two forwards (the unit's forward and its remat)
    and one backward (x 3) a layer."""
    mesh, ref, port = mesh_run
    arch, kind, variant = cell
    r, p = ref[_key(*cell, mesh)], port[_key(*cell, mesh)]
    split = p["flops_breakdown"]
    assert split["dot"] == r["dot"] > 0
    if variant == "ssdk":
        cfg = _cfg(arch)
        _, T, B = SHAPES[kind]
        want = cfg.n_layers * (2 + 3) * _ssd_fwd_flops(cfg, B // mesh[0], T)
        assert r["kernel"] == 0.0
        assert split["kernel"] == want > 0
    else:
        assert split["kernel"] == r["kernel"] > 0


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[2]}")
def test_standin_calls(mesh_run, cell):
    """Each stand-in is called where the reference calls it: under the
    unit's remat (decoder training) the forward twice and the backward
    once a layer; whisper's encoder and decoder have no remat, so one
    forward and one backward an attention (bidirectional, causal and
    cross); decode one fused call an attention layer.  B4 and B5, the
    prefill's ops, are not called."""
    mesh, _, port = mesh_run
    arch, kind, variant = cell
    cfg = _cfg(arch)
    self_layers, cross = _attention_layers(cfg)
    if variant == "ssdk":
        want = {"ssd_scan_fwd_standin": 2 * cfg.n_layers,
                "ssd_scan_bwd_standin": cfg.n_layers}
    elif kind == "decode":
        want = {"decode_attention_standin": self_layers + cross}
    elif cfg.family == "encdec":
        want = {"flash_attention_fwd_standin": self_layers + cross,
                "flash_attention_bwd_standin": self_layers + cross}
    else:
        want = {"flash_attention_fwd_standin": 2 * self_layers,
                "flash_attention_bwd_standin": self_layers}
    calls = port[_key(*cell, mesh)]["kernel_calls"]
    assert calls == {op: want.get(op, 0) for op in
                     ("flash_attention", "ssd_scan", *O.OPS)}


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[2]}")
def test_standin_bytes_match_reference(mesh_run, cell):
    """The stand-ins' operand and result bytes against the reference's
    ``custom-call(kernel)`` bytes (its marker excluded):

      * flash, forward and backward: equal;
      * decode over a bf16 cache: 4 bytes a call below, the reference's
        ``valid_len`` operand (an int32 scalar; the port's op takes a
        Python int);
      * decode over an int8 cache: equal, as ``hlo_cost`` does not count
        the sixth operand, ``valid_len``: XLA prints operands from the
        sixth on behind an ``/*index=5*/`` comment, which its operand
        parser drops (ROADMAP C17);
      * the scan: the port counts each backward's sixth operand, g_y (B,
        T, nh, hd), which ``hlo_cost`` drops (C17)."""
    mesh, ref, port = mesh_run
    arch, kind, variant = cell
    r, p = ref[_key(*cell, mesh)], port[_key(*cell, mesh)]
    calls = p["kernel_calls"]
    if variant == "flash" and kind == "decode":
        extra = -4 * calls["decode_attention_standin"]
    elif variant == "ssdk":
        cfg = _cfg(arch)
        s = cfg.ssm
        _, T, B = SHAPES[kind]
        g_y = (B // mesh[0]) * T * s.n_heads(cfg.d_model) * s.head_dim * 2
        extra = g_y * calls["ssd_scan_bwd_standin"]
    else:
        extra = 0
    assert r["kernel_bytes"] > 0
    assert p["kernel_bytes"] == r["kernel_bytes"] + extra


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[2]}")
def test_standin_memory_matches_reference(mesh_run, cell):
    """Each rank's argument and output bytes under the variant equal to
    the reference's ``memory_analysis`` (XLA's output size also holds the
    output tuple's index table, 8 bytes a leaf); the int8 cache's
    argument leaves are the reference's."""
    mesh, ref, port = mesh_run
    r, p = ref[_key(*cell, mesh)], port[_key(*cell, mesh)]
    assert p["leaves"] == r["leaves"]
    assert p["memory"]["argument_bytes"] == r["argument_bytes"]
    assert r["output_bytes"] == r["output_data_bytes"] + 8 * r["output_leaves"]
    assert p["memory"]["output_bytes"] == r["output_data_bytes"]
    assert p["status"] == "ok" and p["variant"] == cell[2]


def test_model_axis_flash_cell(tmp_path_factory):
    """(2, 2), gemma2-2b's train cell under ``flash``: the port divides
    its products over "model" (ROADMAP D15c-1), and "model" divides
    every one of them (heads 4, kv heads 2, ff 128, vocab 512), so its
    count is its (2, 1) count halved, exactly, and equals the
    reference's ``dot`` and ``custom-call(kernel)`` exactly: the
    reference's sequence-parallel stream under ``flash`` (D15c-2) moves
    where its products run, not how many there are."""
    cell = ("gemma2-2b", "train", "flash")
    work = tmp_path_factory.mktemp("standins_2x2")
    procs = [_start(work, "ref", _cells((2, 1), [cell]) +
                    _cells((2, 2), [cell]), port=False)]
    procs += [_start(work, f"port{m[1]}", _cells(m, [cell]), port=True)
              for m in ((2, 1), (2, 2))]
    ref, port21, port22 = (_result(work, n, p) for n, p in
                           zip(("ref", "port1", "port2"), procs))
    split = port22[_key(*cell, (2, 2))]["flops_breakdown"]
    half = {k: v / 2 for k, v in
            port21[_key(*cell, (2, 1))]["flops_breakdown"].items()}
    r = ref[_key(*cell, (2, 2))]
    print(f"gemma2-2b train flash (2, 2): port {split}, reference dot "
          f"{r['dot']:.0f}, kernel {r['kernel']:.0f}")
    assert split == half
    assert split == {"dot": r["dot"], "kernel": r["kernel"]}


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------

#: Operand shapes: flash q (B, T, K, G, hd), k/v (B, S, K, hd); decode
#: q (B, 1, K, G, hd), cache (B, K, S, hd); scan x (B, T, nh, hd), Bm/Cm
#: (B, T, ds), dt (B, T, nh), A (nh,).
B_, T_, K_, G_, HD, S_ = 2, 24, 2, 3, 16, 40
NH, DS = 3, 8


def _flash_args(S=S_, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B_, T_, K_, G_, HD, generator=g).to(dtype)
    k = torch.randn(B_, S, K_, HD, generator=g).to(dtype)
    return q, k, k.clone()


def _decode_args(int8):
    q = torch.zeros(B_, 1, K_, G_, HD, dtype=torch.bfloat16)
    cache = torch.zeros(B_, K_, S_, HD,
                        dtype=torch.int8 if int8 else torch.bfloat16)
    scales = (torch.ones(B_, K_, S_, 1),) * 2 if int8 else None
    return q, cache, cache.clone(), scales


def _ssd_args():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B_, T_, NH, HD, generator=g).to(torch.bfloat16)
    Bm = torch.randn(B_, T_, DS, generator=g).to(torch.bfloat16)
    dt = torch.rand(B_, T_, NH, generator=g)
    A = -torch.rand(NH, generator=g)
    return x, Bm, Bm.clone(), dt, A


def _jnp(t):
    import jax.numpy as jnp

    return jnp.asarray(t.float().numpy()).astype(
        str(t.dtype).replace("torch.", ""))


def _sds(tree):
    import jax

    return [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(tree)]


def _meta(ts):
    return [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in ts]


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16)])
def test_flash_fake_results_are_the_reference(causal, window):
    """The flash forward's fake result and the backward's three are the
    reference stand-in's (``make_flash_opaque``; its backward through
    ``jax.vjp``), shape and dtype."""
    import jax

    from repro.kernels import opaque as R

    q, k, v = _flash_args()
    f = R.make_flash_opaque(causal, window)
    jq, jk, jv = map(_jnp, (q, k, v))
    want_o = _sds(jax.eval_shape(f, jq, jk, jv))
    want_g = _sds(jax.eval_shape(
        lambda a, b, c: jax.vjp(f, a, b, c)[1](f(a, b, c)), jq, jk, jv))
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        o = torch.ops.repro_torch.flash_attention_fwd_standin(
            fq, fk, fv, causal, window)
        grads = torch.ops.repro_torch.flash_attention_bwd_standin(
            fq, fk, fv, o, causal, window)
    assert _meta([o]) == want_o and _meta(grads) == want_g


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_fake_result_is_the_reference(int8):
    """The decode stand-in's fake result is the reference's
    (``decode_attention_opaque``), over a bf16 or an int8 cache."""
    import jax

    from repro.kernels import opaque as R

    q, ck, cv, scales = _decode_args(int8)
    js = None if scales is None else tuple(map(_jnp, scales))
    want = _sds(jax.eval_shape(
        lambda a, b, c: R.decode_attention_opaque(a, b, c, 7, int8=int8,
                                                  scales=js),
        _jnp(q), _jnp(ck), _jnp(cv)))
    with FakeTensorMode() as mode:
        f = [mode.from_tensor(t) for t in (q, ck, cv)]
        fs = None if scales is None else [mode.from_tensor(s)
                                          for s in scales]
        o = O.decode_attention(*f, 7, fs)
    assert _meta([o]) == want


def test_ssd_fake_results_are_the_reference():
    """The scan forward's fake results (y, H float32) and the backward's
    five gradients are the reference stand-in's (``make_ssd_opaque``),
    shape and dtype."""
    import jax

    from repro.kernels import opaque as R

    args = _ssd_args()
    f = R.make_ssd_opaque(16)
    jargs = [_jnp(t) for t in args]
    want_fwd = _sds(jax.eval_shape(f, *jargs))
    want_bwd = _sds(jax.eval_shape(
        lambda *a: jax.vjp(f, *a)[1](f(*a)), *jargs))
    with FakeTensorMode() as mode:
        fa = [mode.from_tensor(t) for t in args]
        y, H = torch.ops.repro_torch.ssd_scan_fwd_standin(*fa, 16)
        grads = torch.ops.repro_torch.ssd_scan_bwd_standin(*fa, y, 16)
    assert _meta([y, H]) == want_fwd and _meta(grads) == want_bwd


def _ref_flops(marker, operands, results):
    """``hlo_cost._opaque_kernel_cost`` of a custom-call with these
    operands and results (each (dtype, shape)) plus its marker."""
    from repro.launch import hlo_cost as HC

    symtab = {f"a{i}": [o] for i, o in enumerate(operands)}
    ins = HC._Instr("cc", list(results) + [("f32", (marker,))],
                    "custom-call", "")
    return HC._opaque_kernel_cost(ins, symtab, list(symtab))


def _hlo(ts):
    names = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "s8"}
    return [(names[t.dtype], tuple(t.shape)) for t in ts]


def _flops(op, *args):
    with FakeTensorMode() as mode:
        fa = torch.utils._pytree.tree_map_only(torch.Tensor, mode.from_tensor,
                                               args)
        with FlopCounterMode(display=False) as fc:
            out = op(*fa)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    return fc.get_total_flops(), outs


@pytest.mark.parametrize("causal,window,S", [
    (True, None, S_), (False, None, S_), (True, 16, S_), (True, 64, S_),
    (False, None, 7)], ids=["causal", "full", "window", "wide-window",
                            "cross"])
@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
def test_flash_flop_formula_is_the_reference(causal, window, S, bwd):
    """The flash stand-ins' FLOP formulas equal ``hlo_cost``'s count of
    the reference's custom-call with the same marker (101-104, 10000 + w,
    20000 + w) on the same operand shapes; the window counts min(w, S)
    keys a query."""
    q, k, v = _flash_args(S)
    marker = O.flash_marker(causal, window, bwd)
    if bwd:
        got, outs = _flops(torch.ops.repro_torch.flash_attention_bwd_standin,
                           q, k, v, q, causal, window)
        ins = [q, k, v, q]
    else:
        got, outs = _flops(torch.ops.repro_torch.flash_attention_fwd_standin,
                           q, k, v, causal, window)
        ins = [q, k, v]
    want, _ = _ref_flops(marker, _hlo(ins), _hlo(outs))
    assert want > 0 and got == want


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_flop_formula_is_the_reference(int8):
    """401 and 402: ``4 B K G hd S``, ``hlo_cost``'s count on the same
    operands (the reference's ``valid_len`` an int32 scalar)."""
    q, ck, cv, scales = _decode_args(int8)
    got, outs = _flops(O.decode_attention, q, ck, cv, 5, scales)
    ins = [q, ck, cv] + ([] if scales is None else list(scales))
    want, _ = _ref_flops(O.decode_marker(int8),
                         _hlo(ins) + [("s32", ())], _hlo(outs))
    assert want > 0 and got == want


@pytest.mark.parametrize("chunk", [16, 32, 256])
@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
def test_ssd_flop_formula_is_the_scan_branch(chunk, bwd):
    """30000 + L and 40000 + L: ``hlo_cost`` returns 0 for them (C15);
    the port's formula is its scan branch, ``B nh T (2 L (ds + hd) + 4 ds
    hd)``, x 3 for the backward."""
    args = _ssd_args()
    if bwd:
        got, outs = _flops(torch.ops.repro_torch.ssd_scan_bwd_standin,
                           *args, args[0], chunk)
    else:
        got, outs = _flops(torch.ops.repro_torch.ssd_scan_fwd_standin,
                           *args, chunk)
    ins = list(args) + ([args[0]] if bwd else [])
    assert _ref_flops(O.ssd_marker(chunk, bwd), _hlo(ins),
                      _hlo(outs))[0] == 0.0
    fwd = B_ * NH * T_ * (2 * chunk * (DS + HD) + 4 * DS * HD)
    assert got == fwd * (3 if bwd else 1)


def _real_calls():
    q, k, v = _flash_args()
    dq, dck, dcv, scales = _decode_args(True)
    x, Bm, Cm, dt, A = _ssd_args()
    ops = torch.ops.repro_torch
    return {
        "flash_attention_fwd_standin":
            lambda: ops.flash_attention_fwd_standin(q, k, v, True, None),
        "flash_attention_bwd_standin":
            lambda: ops.flash_attention_bwd_standin(q, k, v, q, True, None),
        "decode_attention_standin":
            lambda: ops.decode_attention_standin(dq, dck, dcv, *scales, 3),
        "ssd_scan_fwd_standin":
            lambda: ops.ssd_scan_fwd_standin(x, Bm, Cm, dt, A, 16),
        "ssd_scan_bwd_standin":
            lambda: ops.ssd_scan_bwd_standin(x, Bm, Cm, dt, A, x, 16),
    }


@pytest.mark.parametrize("op", O.OPS)
def test_standin_raises_on_real_tensors(op):
    """No stand-in has a CPU (or CUDA) implementation: a call on real
    tensors raises (the reference's host callback returns zeros; ROADMAP
    C16)."""
    with pytest.raises(NotImplementedError, match=op):
        _real_calls()[op]()


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16)])
def test_flash_gradients_flow_through_the_standin(causal, window):
    """Under ``FakeTensorMode`` a loss through the flash stand-in
    back-propagates through ``register_autograd``: one backward
    stand-in call on the forward's q, k, v, gradients of their shapes
    and dtypes, and the two formulas' FLOPs (the backward 2.5 x)."""
    q, k, v = _flash_args()
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t).requires_grad_(True)
                      for t in (q, k, v))
        with FlopCounterMode(display=False) as fc:
            o = O.flash_attention(fq, fk, fv, causal=causal, window=window)
            o.float().sum().backward()
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    fwd = counts["repro_torch.flash_attention_fwd_standin"]
    assert counts == {"repro_torch.flash_attention_fwd_standin": fwd,
                      "repro_torch.flash_attention_bwd_standin": fwd * 5 // 2}
    assert _meta([fq.grad, fk.grad, fv.grad]) == _meta([q, k, v])


def test_ssd_gradients_flow_through_the_standin():
    """The scan stand-in back-propagates through ``register_autograd``
    with y's gradient alone (H's is not an operand, as in the
    reference): gradients of all five inputs, their shapes and dtypes,
    and the backward formula 3 x the forward."""
    args = _ssd_args()
    with FakeTensorMode() as mode:
        fa = [mode.from_tensor(t).requires_grad_(True) for t in args]
        with FlopCounterMode(display=False) as fc:
            y, H = O.ssd_scan(*fa, chunk=16)
            y.float().sum().backward()
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    fwd = counts["repro_torch.ssd_scan_fwd_standin"]
    assert counts == {"repro_torch.ssd_scan_fwd_standin": fwd,
                      "repro_torch.ssd_scan_bwd_standin": 3 * fwd}
    assert _meta([t.grad for t in fa]) == _meta(args)


def test_markers_are_the_reference():
    """The marker constants and the markers each configuration stands
    for are the reference's."""
    from repro.kernels import opaque as R

    for name in ("M_FLASH_FWD_CAUSAL", "M_FLASH_BWD_CAUSAL",
                 "M_FLASH_FWD_FULL", "M_FLASH_BWD_FULL", "M_DECODE_BF16",
                 "M_DECODE_INT8", "M_WINDOW_FWD_BASE", "M_WINDOW_BWD_BASE",
                 "M_SSD_FWD_BASE", "M_SSD_BWD_BASE"):
        assert getattr(O, name) == getattr(R, name), name
    for causal, window in [(True, None), (False, None), (True, 128)]:
        assert O.flash_marker(causal, window, False) == R._fwd_marker(
            causal, window)
        assert O.flash_marker(causal, window, True) == R._bwd_marker(
            causal, window)
    assert (O.ssd_marker(64, False), O.ssd_marker(64, True)) == (30064, 40064)
    assert (O.decode_marker(False), O.decode_marker(True)) == (401, 402)
