"""Flash-tier reader: training batches served through the simulated SSD.

The paper's tie-in for the training data path: every batch is striped
over the simulated SSD's dies as 16 KiB page reads; each page's retry
attempt count is sampled from the port's 160-chip characterization
histograms for the operating condition, and its latency follows the
``RetryPolicy`` mechanism (baseline / SOTA / PR² / AR² / PR²+AR²).

The simulated batch fetch latency is

    max over dies of  sum of page read latencies on that die

plus the host overhead: the steady state of the full event simulation
without its event-queue cost per training step.  The characterization
runs on ``device`` (the CUDA card by default); its tables are bitwise
the reference's on every device, so the sampled attempts and
:class:`FlashReadStats` equal the reference reader's for the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core import characterize as CH
from repro_torch.core import timing as T
from repro_torch.core.retry import RetryPolicy
from repro_torch.data.corpus import SyntheticCorpus
from repro_torch.flashsim.config import DEFAULT_SSD, OperatingCondition, SSDConfig

PAGE_BYTES = 16 * 1024
PAGE_TYPES = ("lsb", "csb", "msb")


@dataclasses.dataclass
class FlashReadStats:
    batches: int = 0
    pages: int = 0
    attempts: int = 0
    sim_read_us: float = 0.0          # simulated wall time spent in reads

    @property
    def mean_batch_us(self) -> float:
        return self.sim_read_us / self.batches if self.batches else 0.0


class FlashTierReader:
    """corpus[i] + simulated SSD latency under a retry policy."""

    def __init__(self, corpus: SyntheticCorpus,
                 policy: RetryPolicy = RetryPolicy("pr2ar2"),
                 condition: OperatingCondition = OperatingCondition(),
                 ssd: SSDConfig = DEFAULT_SSD, seed: int = 0, device=None):
        self.corpus = corpus
        self.policy = policy
        self.cond = condition
        self.ssd = ssd
        self.rng = np.random.default_rng(seed)
        self.stats = FlashReadStats()

        if policy.adaptive_tr:
            self.tr_scale = (
                CH.lookup_tr_scale(condition.retention_days, condition.pec,
                                   device=device)
                if policy.tr_scale == "auto" else float(policy.tr_scale))
        else:
            self.tr_scale = 1.0
        self._cdfs = {
            pt: np.cumsum(CH.attempt_histogram(
                condition.retention_days, condition.pec, page_type=pt,
                sota=policy.sota_start, tr_scale=self.tr_scale,
                device=device))
            for pt in PAGE_TYPES}

    def _batch_latency_us(self, nbytes: int) -> float:
        n_pages = max(-(-nbytes // PAGE_BYTES), 1)
        ptypes = self.rng.integers(0, 3, n_pages)
        dies = self.rng.integers(0, self.ssd.n_dies, n_pages)
        u = self.rng.random(n_pages)
        per_die = np.zeros(self.ssd.n_dies)
        for i in range(n_pages):
            pt = PAGE_TYPES[ptypes[i]]
            a = max(int(np.searchsorted(self._cdfs[pt], u[i])), 1)
            per_die[dies[i]] += float(T.read_latency(
                a, self.policy.mechanism, page_type=pt,
                tr_scale=self.tr_scale))
            self.stats.attempts += a
        self.stats.pages += n_pages
        return float(per_die.max()) + self.ssd.host_overhead_us

    def read(self, index: int) -> Dict[str, np.ndarray]:
        """The batch dict, its simulated latency charged to ``stats``."""
        batch = self.corpus.batch(index)
        us = self._batch_latency_us(self.corpus.nbytes_per_batch())
        self.stats.batches += 1
        self.stats.sim_read_us += us
        return batch
