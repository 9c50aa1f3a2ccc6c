"""The port's training data path against the reference's ``repro.data``.

Corpus batches are the same arrays; the flash-tier reader, given the
reference's characterization tables (the seam ``load_tables``), samples
the same pages and attempts, so its ``FlashReadStats`` equal the
reference reader's for the same seed, for every mechanism; the prefetch
pipeline yields batches in order, on the CPU as tensors.  Mirrors
``tests/test_serving_data.py::TestData``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import characterize as RC
from repro.core.retry import RetryPolicy as RPolicy
from repro.data import CorpusConfig as RCorpusConfig
from repro.data import FlashTierReader as RReader
from repro.data import SyntheticCorpus as RCorpus
from repro.flashsim.config import OperatingCondition as RCond
from repro_torch.core import characterize as TC
from repro_torch.core.retry import RetryPolicy
from repro_torch.data import (CorpusConfig, FlashTierReader,
                              PrefetchPipeline, SyntheticCorpus)
from repro_torch.flashsim.config import OperatingCondition

MECHS = ("baseline", "pr2", "pr2ar2", "sota+pr2ar2")
COND = (365.0, 1000.0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and a 160-chip characterization on every core of each would
    oversubscribe the host.  (No result depends on the thread count.)"""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def shared_tables():
    """The reference's tables at 365 d / 1000 P/E (its own cache off),
    placed in the port's memo for the module."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_CHAR_CACHE", "0")
    RC.characterize_condition.cache_clear()
    RC.attempt_histogram.cache_clear()
    stats = RC.characterize_condition(*COND)
    hists = {}
    for sota in (False, True):
        for s in (1.0, stats.safe_tr_scale):
            for pt in ("lsb", "csb", "msb"):
                hists[COND + (pt, sota, s)] = RC.attempt_histogram(
                    *COND, page_type=pt, sota=sota, tr_scale=s)
    TC.clear_tables()
    TC.load_tables({COND: stats}, hists)
    yield stats
    TC.clear_tables()
    mp.undo()
    jax.config.update("jax_threefry_partitionable", prev)


@pytest.mark.parametrize("kw", [
    dict(vocab=512, seq_len=64, batch=4, seed=1),
    dict(vocab=128256, seq_len=128, batch=2),
    dict(vocab=64, seq_len=16, batch=3, seed=5, stickiness=0.6),
])
def test_corpus_batches_equal_reference(kw):
    ref = RCorpus(RCorpusConfig(**kw))
    port = SyntheticCorpus(CorpusConfig(**kw))
    assert port.nbytes_per_batch() == ref.nbytes_per_batch()
    for i in (0, 1, 7, 123):
        a, b = ref.batch(i), port[i]
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_corpus_deterministic_and_distinct():
    c = SyntheticCorpus(CorpusConfig(vocab=512, seq_len=64, batch=4, seed=1))
    np.testing.assert_array_equal(c.batch(3)["tokens"], c.batch(3)["tokens"])
    assert not np.array_equal(c.batch(3)["tokens"], c.batch(4)["tokens"])
    assert c.batch(0)["tokens"].max() < 512


@pytest.mark.parametrize("mech", MECHS)
def test_flash_read_stats_equal_reference(shared_tables, mech):
    kw = dict(vocab=512, seq_len=256, batch=16)
    ref = RReader(RCorpus(RCorpusConfig(**kw)), RPolicy(mech), RCond(*COND),
                  seed=2)
    port = FlashTierReader(SyntheticCorpus(CorpusConfig(**kw)),
                           RetryPolicy(mech), OperatingCondition(*COND),
                           seed=2, device="cpu")
    assert port.tr_scale == ref.tr_scale
    for i in range(12):
        a, b = ref.read(i), port.read(i)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)


def test_flash_tier_mechanism_ordering(shared_tables):
    c = SyntheticCorpus(CorpusConfig(vocab=512, seq_len=256, batch=16))
    means = {}
    for mech in MECHS:
        r = FlashTierReader(c, RetryPolicy(mech), OperatingCondition(*COND),
                            seed=2, device="cpu")
        for i in range(12):
            r.read(i)
        means[mech] = r.stats.mean_batch_us
    assert means["pr2ar2"] < means["pr2"] < means["baseline"]
    assert means["sota+pr2ar2"] < means["pr2ar2"]


def test_prefetch_order_and_completeness():
    c = SyntheticCorpus(CorpusConfig(vocab=64, seq_len=16, batch=2))
    pipe = PrefetchPipeline(c.batch, n_batches=7, start_index=3)
    seen = [i for i, _ in pipe]
    assert seen == list(range(3, 10))
    assert pipe.stall_s >= 0.0 and pipe.produce_s > 0.0


def test_prefetch_puts_tensors_on_the_device():
    c = SyntheticCorpus(CorpusConfig(vocab=64, seq_len=16, batch=2))
    pipe = PrefetchPipeline(c.batch, n_batches=3, device="cpu")
    for i, b in pipe:
        assert isinstance(b["tokens"], torch.Tensor)
        assert b["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      c.batch(i)["tokens"])
