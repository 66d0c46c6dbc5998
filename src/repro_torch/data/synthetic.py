"""Deterministic synthetic data (numpy).

Port of ``ImageClassData`` and ``LMData`` from ``repro/data/synthetic.py``:
CIFAR-10-like images (10 smooth class templates, random shifts, noise) and
token streams from a seeded order-2 Markov chain over a small vocabulary,
both with stable example ids (for AQ-SGD).  Pure numpy ``RandomState``, so
images, labels, tokens and epoch orders are bitwise the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ImageClassData:
    num_train: int = 2000
    num_test: int = 500
    image: int = 32
    num_classes: int = 10
    noise: float = 0.6
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        # smooth class templates: low-frequency random fields
        freqs = rng.randn(self.num_classes, 4, 4, 3)
        t = np.linspace(0, 1, self.image)
        basis = np.stack([np.sin(np.pi * (i + 1) * t) for i in range(4)])
        self.templates = np.einsum("kabc,ai,bj->kijc", freqs, basis, basis)
        self.templates /= np.abs(self.templates).max(axis=(1, 2, 3),
                                                     keepdims=True)

        def make(n, seed):
            r = np.random.RandomState(seed)
            y = r.randint(0, self.num_classes, n)
            x = self.templates[y].copy()
            # random roll (translation invariance pressure)
            for i in range(n):
                x[i] = np.roll(x[i], r.randint(-4, 5, 2), axis=(0, 1))
            x += self.noise * r.randn(*x.shape)
            return x.astype(np.float32), y.astype(np.int32)

        self.x_train, self.y_train = make(self.num_train, self.seed + 1)
        self.x_test, self.y_test = make(self.num_test, self.seed + 2)

    def epoch(self, batch: int, epoch_idx: int):
        """Yields (images (batch, H, W, 3) float32 NHWC, labels (batch,)
        int32, example ids (batch,) int32); drop_last."""
        rng = np.random.RandomState(self.seed + 100 + epoch_idx)
        order = rng.permutation(self.num_train)
        for i in range(0, self.num_train - batch + 1, batch):
            idx = order[i:i + batch]
            yield self.x_train[idx], self.y_train[idx], idx.astype(np.int32)

    def test_batches(self, batch: int):
        for i in range(0, self.num_test - batch + 1, batch):
            yield (self.x_test[i:i + batch], self.y_test[i:i + batch],
                   np.arange(i, i + batch, dtype=np.int32))


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
