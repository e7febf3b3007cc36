"""Reader creators from data sources (counterpart of
``paddle_tpu/reader/creator.py``; python/paddle/v2/reader/creator.py:
np_array, text_file, recordio)."""

from __future__ import annotations

import numpy as np


def np_array(x):
    def reader():
        for row in np.asarray(x):
            yield row

    return reader


def text_file(path):
    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths, buf_size=100):
    """Reader over RecordIO-style length-prefixed binary records — the
    format the Go master shards datasets with (go/master task chunks).
    The writer is ``paddle_tpu_torch.io.recordio.RecordIOWriter``."""
    from paddle_tpu_torch.io.recordio import RecordIOReader

    if isinstance(paths, str):
        paths = [paths]

    def reader():
        for p in paths:
            with RecordIOReader(p) as r:
                yield from r

    return reader
