"""Deterministic synthetic language-modelling data (numpy).

Port of ``LMData`` from ``repro/data/synthetic.py``: token streams from a
seeded order-2 Markov chain over a small vocabulary, with stable example
ids (for AQ-SGD).  Pure numpy ``RandomState``, so the streams are bitwise
the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LMData:
    num_train: int = 512
    num_test: int = 128
    seq_len: int = 64
    vocab: int = 256
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        # sparse order-2 Markov transition structure
        self.succ = rng.randint(0, self.vocab, size=(self.vocab, self.vocab, 4))

        def sample(n, seed):
            r = np.random.RandomState(seed)
            out = np.zeros((n, self.seq_len), np.int32)
            out[:, 0] = r.randint(0, self.vocab, n)
            out[:, 1] = r.randint(0, self.vocab, n)
            for t in range(2, self.seq_len):
                choice = r.randint(0, 4, n)
                out[:, t] = self.succ[out[:, t - 2], out[:, t - 1], choice]
            return out

        self.train = sample(self.num_train, self.seed + 1)
        self.test = sample(self.num_test, self.seed + 2)

    def epoch(self, batch: int, epoch_idx: int):
        """Yields (tokens (batch, seq) int32, example ids (batch,) int32);
        drop_last."""
        rng = np.random.RandomState(self.seed + 100 + epoch_idx)
        order = rng.permutation(self.num_train)
        for i in range(0, self.num_train - batch + 1, batch):
            idx = order[i:i + batch]
            yield self.train[idx], idx.astype(np.int32)

    def test_batches(self, batch: int):
        for i in range(0, self.num_test - batch + 1, batch):
            yield self.test[i:i + batch], np.arange(i, i + batch,
                                                    dtype=np.int32)
