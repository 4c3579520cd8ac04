"""Deterministic, resumable data pipeline (the JAX package's
``data/pipeline.py``, a copy: pure numpy, its batches bitwise the
reference's; the trainer moves each batch to its device).

Every batch is a pure function of (seed, step) — no iterator state to
checkpoint, so restart/elastic-rescale recovery is exact: the trainer
stores only the step counter.  Per-host sharding: host h of H draws the
batch rows [h*B/H, (h+1)*B/H) of the global batch, so data parallelism
composes with multi-host launches.

The synthetic corpus is a mixture of (a) Zipf-distributed unigrams, (b)
local Markov bigram structure, and (c) copy spans — enough signal that a
~100M-param model shows a clearly decreasing loss in the e2e example.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def synth_corpus(vocab: int, seed: int = 0):
    """Build deterministic bigram tables for the synthetic language."""
    rng = np.random.default_rng(seed)
    # sparse "grammar": each token prefers a small successor set
    succ = rng.integers(0, vocab, size=(vocab, 4))
    return succ


@dataclasses.dataclass
class DataPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1

    def __post_init__(self):
        self.succ = synth_corpus(self.vocab, self.seed)
        assert self.global_batch % self.num_hosts == 0
        self.local_batch = self.global_batch // self.num_hosts

    def batch(self, step: int):
        """-> dict(tokens [b, s] int32, labels [b, s] int32), b = local."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 64 + self.host_id)
        b, s = self.local_batch, self.seq_len
        toks = np.empty((b, s), dtype=np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, b)
        choice = rng.integers(0, 4, (b, s))
        noise = rng.random((b, s)) < 0.1
        rand = rng.integers(0, self.vocab, (b, s))
        for t in range(1, s):
            nxt = self.succ[toks[:, t - 1], choice[:, t]]
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        # occasional copy spans (induction-head signal)
        n_copy = max(b // 4, 1)
        rows = rng.integers(0, b, n_copy)
        if s >= 64:
            for r in rows:
                src = rng.integers(0, s // 2 - 16)
                dst = rng.integers(s // 2, s - 16)
                toks[r, dst:dst + 16] = toks[r, src:src + 16]
        tokens = toks.astype(np.int32)
        labels = np.concatenate([tokens[:, 1:],
                                 np.full((b, 1), -1, np.int32)], axis=1)
        return {"tokens": tokens, "labels": labels}
