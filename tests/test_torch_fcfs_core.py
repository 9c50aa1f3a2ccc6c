"""Shard core of the port against the reference's kernel and oracle.

The port's CPU path (the plain torch lockstep version) must equal,
bitwise, both the reference's pure-Python oracle ``fcfs_core_ref`` and
the reference's Pallas kernel run in interpret mode, as the reference's
own tests run it.  The table helpers (padding, augmentation, step and
ring bounds) must be equal too.  The CUDA kernel is held against the
same plain version on the card by ``chip_smoke.py``.

The reference's ``fcfs_core`` package imports ``enable_x64`` from
``jax.experimental``, which this JAX lacks; the fixture supplies it for
the duration of a test and drops the modules it caused to be imported,
so other tests of the process see the reference exactly as before.
"""

import sys

import numpy as np
import pytest

from repro_torch.kernels.fcfs_core import ops as T
from repro_torch.kernels.fcfs_core import ref as TREF

_REF_PREFIXES = ("repro.kernels.fcfs_core", "repro.flashsim.engine_batched")


@pytest.fixture(scope="module")
def ref_kernel():
    """The reference's ``repro.kernels.fcfs_core`` package (imported once
    per module, so its jitted kernel variants are compiled once)."""
    import jax
    import jax.experimental

    before = set(sys.modules)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                   raising=False)
        mp.setenv("REPRO_CHAR_CACHE", "0")   # no persistent jit cache
        import repro.kernels.fcfs_core as pkg
        import repro.kernels.fcfs_core.ops  # noqa: F401

        yield pkg
    for name in set(sys.modules) - before:
        if name.startswith(_REF_PREFIXES):
            del sys.modules[name]


def _random_table(rng, n_ops, n_dies):
    arr = np.sort(rng.uniform(0.0, 400.0, n_ops))
    kind = rng.choice([0.0, 0.0, 1.0, 2.0], size=n_ops)
    die = rng.integers(0, n_dies, n_ops).astype(np.float64)
    dur = rng.uniform(10.0, 60.0, n_ops)
    att = rng.integers(1, 6, n_ops).astype(np.float64)
    tr = rng.uniform(5.0, 25.0, n_ops)
    hp = np.where((kind == 0.0) & (rng.random(n_ops) < 0.5), 1.0, 0.0)
    return np.stack([arr, kind, die, dur, att, tr, hp], axis=1)


def _table(seed, n_dies=3):
    rng = np.random.default_rng(seed)
    sizes = [12, 0, 1, 12] if seed == 2 else [12, 12, 7, 12]
    return T.pad_ops([_random_table(rng, n, n_dies) for n in sizes])


def _equal(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("age_bound", [None, 0.0, 1.0, 4.0, float("inf")],
                         ids=["fifo", "bound0", "bound1", "bound4", "inf"])
@pytest.mark.parametrize("pipelined", [False, True])
def test_plain_equals_reference_kernel_and_oracle(ref_kernel, pipelined,
                                                  age_bound, seed):
    ops = _table(seed)
    got = T.fcfs_core(ops, 3, pipelined, 3.0, 5.0, age_bound=age_bound,
                      device="cpu")
    _equal(got, ref_kernel.fcfs_core_ref(ops, 3, pipelined, 3.0, 5.0,
                                         age_bound=age_bound))
    _equal(got, ref_kernel.fcfs_core(ops, 3, pipelined, 3.0, 5.0,
                                     age_bound=age_bound))
    # the port's copy of the oracle is the reference's, verbatim
    _equal(got, TREF.fcfs_core_ref(ops, 3, pipelined, 3.0, 5.0,
                                   age_bound=age_bound))


@pytest.mark.parametrize("prio", [False, True])
@pytest.mark.parametrize("pipelined", [False, True])
def test_fused_cell_axis_law(ref_kernel, pipelined, prio):
    cells, rows = [], []
    for c, (tdma, tecc) in enumerate([(3.0, 5.0), (2.5, 7.0), (4.0, 1.0)]):
        ops = _table(c)
        bound = float(c) if prio else None
        cells.append((ops, tdma, tecc, bound))
        rows.append(np.tile([[tdma, tecc, bound if prio else 0.0]],
                            (ops.shape[0], 1)))
    stacked = np.concatenate([c[0] for c in cells], axis=0)
    got = T.fused_core(stacked, 3, pipelined, np.concatenate(rows),
                       prio=prio, device="cpu")
    _equal(got, ref_kernel.ref.fused_core_ref(cells, 3, pipelined))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_helpers_equal(ref_kernel, seed):
    rops = ref_kernel.ops
    rng = np.random.default_rng(seed)
    lanes = [_random_table(rng, n, 4) for n in (5, 31, 0, 16)]
    ops = T.pad_ops(lanes)
    assert np.array_equal(ops, rops.pad_ops(lanes))
    assert np.array_equal(T.pad_ops(lanes, maxp=128),
                          rops.pad_ops(lanes, maxp=128))
    assert T.pad_width(31) == rops.pad_width(31) == 32
    for pipelined in (False, True):
        assert np.array_equal(T.augment_ops(ops, pipelined),
                              rops.augment_ops(ops, pipelined))
    assert T.count_steps(ops) == rops.count_steps(ops)
    assert T.ring_caps(ops, 4) == rops.ring_caps(ops, 4)


@pytest.mark.parametrize("prio", [False, True], ids=["fifo", "prio"])
def test_mixed_pipelined_lanes_equal_reference_groups(ref_kernel, prio):
    """Serial and pipelined cells stacked in one table, each lane with
    its own flag, equal the reference's oracle run on each uniform
    group, row for row."""
    cells = []
    for c, (tdma, tecc) in enumerate([(3.0, 5.0), (2.5, 7.0), (4.0, 1.0),
                                      (1.5, 2.0)]):
        cells.append((_table(c % 3), tdma, tecc,
                      float(c) if prio else None, c % 2 == 1))
    stacked = np.concatenate([c[0] for c in cells], axis=0)
    rows = np.concatenate([np.tile([[tdma, tecc, b if prio else 0.0]],
                                   (ops.shape[0], 1))
                           for ops, tdma, tecc, b, _ in cells])
    pip = np.concatenate([[p] * ops.shape[0] for ops, *_, p in cells])
    got = T.fused_core(stacked, 3, pip, rows, prio=prio, device="cpu")
    L = cells[0][0].shape[0]
    for pipelined in (False, True):
        group = [c for c in cells if c[4] == pipelined]
        want = ref_kernel.ref.fused_core_ref([c[:4] for c in group], 3,
                                             pipelined)
        at = [i for i, c in enumerate(cells) if c[4] == pipelined]
        sel = np.concatenate([np.arange(i * L, (i + 1) * L) for i in at])
        _equal(tuple(g[sel] for g in got), want)


def _decode(pk, die):
    """The packed word's fields and the die column, by the layout
    ``csrc/fcfs_core.cu`` states: kind, hp, die, attempts."""
    pk = pk.numpy().astype(np.int64)
    return pk & 3, (pk >> 2) & 1, die.numpy().astype(np.int64), pk >> 3


@pytest.mark.parametrize("pipelined", [False, True, "mixed"])
def test_pack_ops_round_trips_augment_columns(pipelined):
    import torch

    ops = _table(1)
    pip = np.array([0, 1, 1, 0], bool) if pipelined == "mixed" \
        else pipelined
    aug = T.augment_ops(ops, pip)
    arr, gdt, pk, dk = T.pack_ops(torch.as_tensor(aug), 3)
    assert arr.dtype == gdt.dtype == torch.float64
    assert pk.dtype == dk.dtype == torch.int32
    kind, hp, die, att = _decode(pk, dk)
    real = aug[:, :, 1] != 3.0
    read = aug[:, :, 1] == 0.0
    assert np.array_equal(arr.numpy(), aug[:, :, 0])
    assert np.array_equal(gdt.numpy(), aug[:, :, 7])
    assert np.array_equal(kind, aug[:, :, 1])
    assert np.array_equal(hp, aug[:, :, 6] == 1.0)
    assert np.array_equal(die[real], aug[:, :, 2][real])
    assert np.array_equal(att[real].astype(np.float64), aug[:, :, 4][real])
    assert not die[~real].any() and not att[~real].any()
    # the columns the kernel reads through gdt and kind
    assert np.array_equal(gdt.numpy()[read], aug[:, :, 5][read])
    assert np.array_equal(gdt.numpy()[real & ~read], aug[:, :, 3][real & ~read])
    assert np.array_equal((kind != 0).astype(np.float64), aug[:, :, 8])
    pip_rows = np.broadcast_to(np.asarray(pip)[..., None] if np.ndim(pip)
                               else pip, kind.shape)
    assert np.array_equal(np.where(pip_rows | (kind != 0), 0.0,
                                   att.astype(np.float64)), aug[:, :, 9])


@pytest.mark.parametrize("col,value,match", [
    (4, 2.5, "attempts"), (4, -1.0, "attempts"), (4, float(1 << 24),
                                                   "attempts"),
    (2, 16.0, "die"), (2, 1.5, "die"), (1, 5.0, "kinds")])
def test_pack_ops_rejects_rows_the_kernel_does_not_take(col, value, match):
    import torch

    aug = T.augment_ops(_table(0), False)
    aug[0, 3, col] = value
    with pytest.raises(ValueError, match=match):
        T.pack_ops(torch.as_tensor(aug), 16)


def test_pack_ops_checks_die_against_lane_dies():
    import torch

    aug = T.augment_ops(_table(0), False)
    aug[1, 0, 2] = 3.0
    T.pack_ops(torch.as_tensor(aug), 4)
    with pytest.raises(ValueError, match="die"):
        T.pack_ops(torch.as_tensor(aug), 3)


@pytest.mark.parametrize("n_dies", [1, 16, 17, 64, 1000])
def test_pack_ops_round_trips_any_die_count(n_dies):
    """Kind, hp, die and attempts come back from the packed word and the
    die column at any die count, the lane's last die and the largest
    attempt count the word holds included."""
    import torch

    rng = np.random.default_rng(n_dies)
    lanes = [_random_table(rng, n, n_dies) for n in (40, 3, 0, 25)]
    lanes[0][:2, 1] = 0.0                     # two reads at the extremes
    lanes[0][0, 2], lanes[0][0, 4] = n_dies - 1, T.MAX_ATTEMPTS - 1
    lanes[0][1, 2], lanes[0][1, 4] = 0, 0
    aug = T.augment_ops(T.pad_ops(lanes), False)
    kind, hp, die, att = _decode(*T.pack_ops(torch.as_tensor(aug),
                                             n_dies)[2:])
    real = aug[:, :, 1] != 3.0
    assert np.array_equal(kind, aug[:, :, 1])
    assert np.array_equal(hp, aug[:, :, 6] == 1.0)
    assert np.array_equal(die[real], aug[:, :, 2][real])
    assert np.array_equal(att[real].astype(np.float64), aug[:, :, 4][real])
    assert not die[~real].any() and not att[~real].any()
    assert die[0, 0] == n_dies - 1 and att[0, 0] == T.MAX_ATTEMPTS - 1
    # one past the largest attempt count, or a die past the lane's, raises
    for col, value, match in ((4, T.MAX_ATTEMPTS, "attempts"),
                              (2, n_dies, "die")):
        bad = aug.copy()
        bad[0, 0, col] = value
        with pytest.raises(ValueError, match=match):
            T.pack_ops(torch.as_tensor(bad), n_dies)


@pytest.mark.parametrize("n_dies,slots", [(1, 8), (8, 8), (9, 16), (16, 16),
                                          (17, 32), (32, 32), (33, 64),
                                          (64, 64), (65, 0), (1000, 0)])
def test_instance_of_die_count(n_dies, slots):
    """The kernel instance a lane takes, and where its die state sits:
    static shared memory of the instance's slots up to 64 dies, the
    dynamic shared memory (beside the rings) past that."""
    assert T.die_slots(n_dies) == slots
    assert T.static_smem_bytes(n_dies) == T.DIE_BYTES * slots
    dies = T.DIE_BYTES * n_dies if slots == 0 else 0
    assert T.smem_bytes(64, n_dies, 4, 4, False) == \
        dies + 24 * 4 + 24 * 64 + 4 * n_dies * 4


def test_smem_placement_from_shapes():
    """The main path's table (MAXP 4096, 8 dies, capq 1024, capw 64)
    fits a block's shared memory under both lowerings; MAXP 16 384 does
    not and takes the global-memory variant."""
    budget = 232448 - 832                     # H100 opt-in less 8 dies' state
    assert T.static_smem_bytes(8) == 832
    assert T.smem_bytes(4096, 8, 1024, 64, False) == 132608
    assert T.smem_bytes(4096, 8, 1024, 64, True) == 165376
    assert T.placement(4096, 8, 1024, 64, False, budget) == T.SMEM
    assert T.placement(4096, 8, 1024, 64, True, budget) == T.SMEM
    assert T.placement(16384, 8, 1024, 64, False, budget) == T.GLOBAL


# Step bounds of the six mechanisms' cells on the main path (websearch,
# 20 000 requests, 365 d / 1000 P/E): baseline, sota, pr2, ar2, pr2ar2,
# sota+pr2ar2.
_MAIN_STEPS = (63312, 31255, 63312, 64070, 64070, 31497)


def test_card_chunks_put_main_path_cells_in_one_launch(ref_kernel):
    from repro_torch.flashsim import engine_batched as EB

    cells = [(s, i, f"cell{i}") for i, s in enumerate(_MAIN_STEPS)]
    (chunk,) = EB._card_chunks(cells, 8, 132)
    assert sorted(i for _, i, _ in chunk) == list(range(6))
    # past one wave the chunks hold like lengths together
    chunks = EB._card_chunks(cells, 8, 24)
    assert [[i for _, i, _ in c] for c in chunks] == [[1, 5, 0], [2, 3, 4]]
    assert EB._card_chunks(cells, 8, 4) == [[c] for c in sorted(cells)]
    # the CPU rule is still the reference's
    from repro.flashsim import engine_batched as REB

    for n_ch in (1, 8, 16):
        assert EB._fuse_chunks(cells, n_ch) == REB._fuse_chunks(cells, n_ch)


def test_launch_counter_counts_only_kernel_launches():
    before = T.launches, T.smem_launches
    T.fcfs_core(_table(0), 3, False, 3.0, 5.0, device="cpu")
    assert (T.launches, T.smem_launches) == before


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_on_card():
    """Runs where a CUDA card is present (``chip_smoke.py`` covers the
    main-path shapes); skipped on CPU-only hosts."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for pipelined in (False, True):
        for bound in (None, 0.0, float("inf")):
            ops = _table(1)
            cpu = T.fcfs_core(ops, 3, pipelined, 3.0, 5.0, age_bound=bound,
                              device="cpu")
            gpu = T.fcfs_core(ops, 3, pipelined, 3.0, 5.0, age_bound=bound,
                              device="cuda")
            _equal(gpu, cpu)
