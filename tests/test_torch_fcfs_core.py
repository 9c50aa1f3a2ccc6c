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


def test_launch_counter_counts_only_kernel_launches():
    before = T.launches
    T.fcfs_core(_table(0), 3, False, 3.0, 5.0, device="cpu")
    assert T.launches == before


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
