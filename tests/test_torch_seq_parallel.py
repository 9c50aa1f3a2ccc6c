"""The reference's flash mode in the port's dry-run (ROADMAP D15c-2b):
the sequence-parallel residual stream, the remat carry divided along
the sequence and context-parallel attention, against the reference's
compiled cells.

The reference's cells are compiled on a host mesh of 4 CPU devices under
its ``flash`` switches (``tests/dryrun_reference.py``); the port's are
traced on fake CUDA tensors over a fake 4-rank process group
(``tests/dryrun_port.py``), both at once, at reduced configs and the
shapes of ``tests/test_torch_dryrun.py``:

  * llama3.2-3b, gemma2-2b, recurrentgemma-2b and olmoe-1b-7b, prefill
    and train, at (2, 2) and (1, 4): ``dot`` and ``kernel`` FLOPs equal
    to ``hlo_cost.breakdown``'s (``custom-call(kernel)``: the flash
    stand-ins, B4's formula in the port's prefill) exactly, but for the
    partitioner decision :func:`_moe_backward_split` names;
  * llama3.2-3b at widths where "model" divides neither the q heads nor
    the kv heads (6 and 2 at (1, 4), as "model" 16 leaves llama3.2-3b's
    24 and 8 at full width): prefill and train exactly the reference's,
    and the port's base prefill's ``kernel`` "model" times the flash
    cell's (each rank's B4 over every head and query there);
  * the collectives of the fake-group trace of llama3.2-3b's flash
    prefill and train at (1, 4) equal to those the same steps issue on
    a real 4-rank gloo run (``tests/sharded_port.py``: the all-gathers
    and reduce-scatters along the sequence, the K/V gather and the
    whole weights' all-gathers);
  * B4's query offset (``q_offset``): its plain version on four query
    shards, concatenated, equal to the unsplit call bit for bit (CPU,
    float32), and its FLOP formula on a shard the reference stand-in's
    on the shard's shapes.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_dryrun import SHAPES, _port, _reference, _result

ARCHS = ["llama3.2-3b", "gemma2-2b", "recurrentgemma-2b", "olmoe-1b-7b"]
MESHES = [[2, 2], [1, 4]]
CELLS = [[a, k, m, "flash", SHAPES[k]] for m in MESHES for a in ARCHS
         for k in ("prefill", "train")]
#: llama3.2-3b's heads at the full width's proportion to "model" 4.
MIXED = {"n_heads": 6, "n_kv_heads": 2}
MIXED_CELLS = [["llama3.2-3b", k, [1, 4], "flash", SHAPES[k], MIXED]
               for k in ("prefill", "train")]
#: The port's base prefill at the mixed widths (the count before the
#: flash mode's context-parallel attention).
MIXED_BASE = ["llama3.2-3b", "prefill", [1, 4], "base", SHAPES["prefill"],
              MIXED]
GLOO_CELLS = [["llama3.2-3b", k, [1, 4], "flash", SHAPES[k]]
              for k in ("prefill", "train")]
#: Reference subprocesses (each compiles every third cell).
N_REF = 3


def _key(arch, kind, mesh, variant, shape=None, widths=None):
    key = f"{arch}/{kind}/{mesh[0]}x{mesh[1]}/{variant}"
    if widths:
        key += "/" + ",".join(f"{k}={v}" for k, v in sorted(widths.items()))
    return key


@pytest.fixture(scope="module")
def flash_run(tmp_path_factory):
    """(the reference's cells, the port's records) of :data:`CELLS` and
    :data:`MIXED_CELLS` (and the port's :data:`MIXED_BASE`)."""
    work = tmp_path_factory.mktemp("seq_parallel")
    ref_cells = CELLS + MIXED_CELLS
    refs = [_reference(work, f"ref{i}", ref_cells[i::N_REF])
            for i in range(N_REF)]
    port = _result(work, "port", _port(work, "port",
                                       ref_cells + [MIXED_BASE]))
    ref = {}
    for i, proc in enumerate(refs):
        ref.update(_result(work, f"ref{i}", proc))
    return ref, port


def _moe_backward_split(arch, kind, mesh) -> float:
    """The partitioner decision of the reduced olmoe-1b-7b train cell
    where the batch axes divide its rows ((2, 2)), read from the
    compiled HLO: in the backward pass the reference takes the dense
    MoE's gradient products of ``moe_wi`` and ``moe_wg`` (each the
    buffer's gradient and the weight's, 2 E_l cap d ff FLOPs) and the
    router weight's gradient (2 N_l d E) on d / data, where the port's
    autograd computes them over all of d on every data rank: the port's
    count is the reference's plus (1 - 1 / data) of those products,
    every MoE layer (the base cell holds the same decision)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm as LM
    from repro_torch.models.moe import _capacity

    cfg = reduced_config(get_config(arch))
    if kind != "train" or cfg.moe is None or mesh[0] == 1:
        return 0.0
    moe = cfg.moe
    _, T, B = SHAPES[kind]
    n = len(cfg.block_pattern)
    layers = sum(LM._moe_here(cfg, i % n) for i in range(cfg.n_layers))
    E_l = moe.n_experts // mesh[1]
    cap = _capacity(moe, B * T)
    experts = 4 * 2 * E_l * cap * cfg.d_model * moe.d_ff_expert
    router = 2 * (B // mesh[0]) * T * cfg.d_model * moe.n_experts
    return layers * (experts + router) * (1 - 1 / mesh[0])


@pytest.mark.parametrize("cell", CELLS,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2][0]}x{c[2][1]}")
def test_flash_flops_match_reference(flash_run, cell):
    """The port's flash cell against the reference's: ``kernel`` (the
    stand-ins' markers; B4 on each rank's queries in the prefill) and
    ``dot`` equal exactly, the products on the sequence shard, on the
    gathered rows or divided by heads or ff as the partitioner runs
    them (q and o on the rows with wq and wo whole, k on the rows and
    gathered, v from the gathered stream where "model" does not divide
    the kv heads, its gradients on the rows; the MLP's and RG-LRU's
    products column- and row-parallel over the gathered rows), but for
    :func:`_moe_backward_split`."""
    ref, port = flash_run
    r, p = ref[_key(*cell)], port[_key(*cell)]["flops_breakdown"]
    extra = _moe_backward_split(cell[0], cell[1], cell[2])
    print(f"{_key(*cell)}: port {p}, reference dot {r['dot']:.0f} "
          f"kernel {r['kernel']:.0f}, named {extra:.0f}")
    assert p["kernel"] == r["kernel"] > 0
    assert p["dot"] == r["dot"] + extra


@pytest.mark.parametrize("cell", MIXED_CELLS, ids=lambda c: c[1])
def test_mixed_width_flash_matches_reference(flash_run, cell):
    """llama3.2-3b with 6 q heads and 2 kv heads at (1, 4), where
    "model" divides neither (the full width's case at "model" 16):
    ``kernel`` and ``dot`` equal to the reference's flash cell exactly;
    the prefill's ``kernel`` is a quarter of the port's base cell's,
    which runs B4 over every head and every query on each rank."""
    ref, port = flash_run
    r, p = ref[_key(*cell)], port[_key(*cell)]["flops_breakdown"]
    base = port[_key(*MIXED_BASE)]["flops_breakdown"]
    print(f"{_key(*cell)}: port {p}, reference dot {r['dot']:.0f} kernel "
          f"{r['kernel']:.0f}; the port's base prefill {base}")
    assert p == {"dot": r["dot"], "kernel": r["kernel"]}
    assert p["kernel"] > 0
    if cell[1] == "prefill":
        assert base["kernel"] == 4 * p["kernel"]


@pytest.fixture(scope="module")
def gloo_costs(tmp_path_factory):
    """(the fake-group trace's records, the real 4-rank gloo run's
    collectives) of :data:`GLOO_CELLS`."""
    import sharded_port as SP

    work = tmp_path_factory.mktemp("seq_parallel_gloo")
    fake = _port(work, "fake", GLOO_CELLS)
    (work / "cost_cases.json").write_text(json.dumps(GLOO_CELLS))
    real = SP.run_costs(4, work)
    return _result(work, "fake", fake), real


@pytest.mark.parametrize("cell", GLOO_CELLS, ids=lambda c: c[1])
def test_flash_collectives_match_gloo_run(gloo_costs, cell):
    """Counts, output bytes and ring traffic of every collective kind,
    from the fake 4-rank group's trace and from the same step run on four
    gloo ranks (its attention the blockwise scans the stand-ins stand
    for, which issue none): equal, and the reduce-scatters of the
    sequence pieces among them."""
    fake, real = gloo_costs
    key = _key(*cell)
    assert fake[key]["collectives"] == real[key]
    assert real[key]["counts"]["reduce-scatter"] > 0
    assert real[key]["counts"]["all-gather"] > 0


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=24),
                                dict(causal=True, window=24, softcap=30.0),
                                dict(causal=False)],
                         ids=["causal", "window", "window-softcap",
                              "bidirectional"])
@pytest.mark.parametrize("T", [64, 200])
def test_plain_query_shards_equal_unsplit(kw, T):
    """``flash_attention_plain`` on four query shards, each against
    every key at its ``q_offset``, concatenated: the unsplit call's
    output bit for bit (float32 on the CPU; 200 rows: shards of 50, not
    a multiple of the kernels' tiles)."""
    from repro_torch.kernels.flash_attention.plain import \
        flash_attention_plain

    rng = np.random.default_rng(T)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((6, T, 16), (2, T, 16), (2, T, 16)))
    whole = flash_attention_plain(q, k, v, **kw)
    n = T // 4
    parts = [flash_attention_plain(q[:, i * n:(i + 1) * n], k, v,
                                   q_offset=i * n, **kw) for i in range(4)]
    assert torch.equal(torch.cat(parts, dim=1), whole)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_query_shard_flops_are_the_standins(causal, window):
    """B4's FLOP formula on a context-parallel shard (q (B, T/4, K, G,
    hd) at ``q_offset``, k and v whole) equals the reference stand-in's
    marker formula on the same operand shapes, as the reference counts
    its stand-in inside its ``shard_map``; the offset does not enter."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import opaque as O
    from repro_torch.kernels.flash_attention.ops import flash_attention

    B, T, K, G, hd = 2, 64, 2, 3, 16
    q = torch.zeros(B, T // 4, K, G, hd)
    k = v = torch.zeros(B, T, K, hd)
    with FlopCounterMode(display=False) as fc:
        flash_attention(q, k, v, causal=causal, window=window,
                        device="cpu", q_offset=3 * T // 4)
    want = O.marker_flops(O.flash_marker(causal, window, False),
                          tuple(q.shape), tuple(k.shape))
    assert fc.get_total_flops() == want > 0
