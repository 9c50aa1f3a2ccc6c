"""Deterministic synthetic training corpus (numpy, as the reference's).

Document-structured token stream with a Zipfian unigram distribution and
per-document Markov locality (tokens repeat within a document with
probability ``stickiness``).  Batch i is a pure function of (seed, i) —
the same array as the reference's ``repro.data.corpus`` — so restarts
replay batch i, not "the next batch".
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    doc_len_mean: float = 384.0
    zipf_a: float = 1.2
    stickiness: float = 0.35
    bos_id: int = 1


class SyntheticCorpus:
    """Indexable batch source: corpus[i] -> {"tokens","labels"} int32."""

    def __init__(self, cfg: CorpusConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()

    def batch(self, index: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, index]))
        n = cfg.batch * (cfg.seq_len + 1)
        toks = rng.choice(cfg.vocab - 1, size=n, p=self._p).astype(np.int32) + 1

        # Markov locality: with prob stickiness, copy a recent token.
        sticky = rng.random(n) < cfg.stickiness
        back = rng.integers(1, 32, n)
        idx = np.arange(n) - back
        valid = sticky & (idx >= 0)
        toks[valid] = toks[idx[valid]]

        # Document boundaries: BOS restarts at random starts.
        n_docs = max(int(n / cfg.doc_len_mean), 1)
        starts = np.sort(rng.integers(0, n, n_docs))
        toks[starts] = cfg.bos_id

        seq = toks.reshape(cfg.batch, cfg.seq_len + 1)
        return {"tokens": seq[:, :-1].copy(), "labels": seq[:, 1:].copy()}

    def __getitem__(self, index: int) -> dict:
        return self.batch(index)

    def nbytes_per_batch(self) -> int:
        return self.cfg.batch * self.cfg.seq_len * 4 * 2  # tokens + labels
