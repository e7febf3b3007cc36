"""Deterministic synthetic data generators (counterpart of
``paddle_tpu/dataset/synthetic.py``): numpy-seeded, so both packages
yield the same samples from the same seed."""

from __future__ import annotations

import numpy as np


def classification(dim, num_classes, n, seed=0, seq=False, max_len=None,
                   vocab=None):
    """Learnable synthetic classification: class = argmax of a fixed
    random projection (or, for id sequences, the ids' sum mod the class
    count), so models can actually fit it."""
    rng = np.random.RandomState(seed)
    W = rng.randn(dim, num_classes).astype(np.float32)

    def reader():
        r = np.random.RandomState(seed + 1)
        for _ in range(n):
            if seq:
                T = r.randint(2, max_len + 1)
                if vocab:
                    x = r.randint(0, vocab, size=T).tolist()
                    y = int(np.asarray(x).sum() % num_classes)
                else:
                    x = r.randn(T, dim).astype(np.float32)
                    y = int(np.argmax(x.mean(0) @ W))
                yield x, y
            else:
                x = r.randn(dim).astype(np.float32)
                yield x, int(np.argmax(x @ W))

    return reader
