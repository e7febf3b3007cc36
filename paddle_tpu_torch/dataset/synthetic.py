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


def seq_pairs(src_vocab, trg_vocab, n, max_len=10, seed=0):
    """(src ids, trg ids, trg next ids) triples for NMT-style training:
    sources of 3..max_len-1 ids, the target a fixed map of the source
    behind a <s> = 0, the next-word labels the target shifted by one and
    ended by <e> = 1."""
    def reader():
        r = np.random.RandomState(seed)
        for _ in range(n):
            T = r.randint(3, max_len)
            src = r.randint(2, src_vocab, size=T).tolist()
            trg = [0] + [(s * 7 + 1) % trg_vocab for s in src]
            nxt = trg[1:] + [1]
            yield src, trg, nxt

    return reader
