"""Shared dataset plumbing (counterpart of
``paddle_tpu/dataset/common.py``; python/paddle/v2/dataset/common.py
parity): download+cache with md5, and the shard writers and readers of
cluster files."""

from __future__ import annotations

import glob
import hashlib
import os
import pickle

DATA_HOME = os.path.expanduser(os.environ.get(
    "PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))


def md5file(fname: str) -> str:
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url: str, module_name: str, md5sum: str) -> str:
    """Download url into the cache dir, verifying md5. Without network
    access this raises IOError."""
    dirname = os.path.join(DATA_HOME, module_name)
    os.makedirs(dirname, exist_ok=True)
    filename = os.path.join(dirname, url.split("/")[-1])
    if os.path.exists(filename) and md5file(filename) == md5sum:
        return filename
    import urllib.request
    try:
        urllib.request.urlretrieve(url, filename)
    except Exception as e:
        raise IOError(f"cannot download {url}: {e}") from e
    if md5file(filename) != md5sum:
        raise IOError(f"{filename}: md5 mismatch")
    return filename


def _chunks(reader, n):
    """Yield the reader's samples in lists of up to n (shared buffering
    for split/convert shard writers)."""
    lines = []
    for d in reader():
        lines.append(d)
        if len(lines) == n:
            yield lines
            lines = []
    if lines:
        yield lines


def split(reader, line_count, suffix="%05d.pickle", dumper=None):
    """Split reader output into multiple files (cluster_files_split parity,
    used to shard datasets for the master's task queue)."""
    dumper = dumper or pickle.dump
    for idx, lines in enumerate(_chunks(reader, line_count)):
        with open(suffix % idx, "wb") as f:
            dumper(lines, f)


def convert(output_path, reader, line_count, name_prefix, shuffle_seed=0):
    """Convert a reader's samples into RecordIO shard files
    (reference common.convert): each shard holds up to ``line_count``
    pickled samples, shuffled within the shard; returns the shard paths
    (``recordio_sample_records`` reads one back)."""
    import random

    from paddle_tpu_torch.io.recordio import RecordIOWriter

    enforce_count = int(line_count)
    assert enforce_count >= 1
    rng = random.Random(shuffle_seed)
    os.makedirs(output_path, exist_ok=True)
    paths = []

    def write_shard(idx, lines):
        rng.shuffle(lines)
        path = os.path.join(output_path, f"{name_prefix}-{idx:05d}")
        with RecordIOWriter(path) as w:
            for sample in lines:
                w.write(pickle.dumps(sample, pickle.HIGHEST_PROTOCOL))
        paths.append(path)

    for idx, lines in enumerate(_chunks(reader, enforce_count)):
        write_shard(idx, lines)
    return paths


def recordio_task_records(payload: str):
    """The records of one task payload: 'path' or 'path:start:count'
    over a RecordIO file (the master client's payload mapping)."""
    from paddle_tpu_torch.io.recordio import RecordIOReader

    parts = payload.split(":")
    with RecordIOReader(parts[0]) as r:
        recs = list(r)
    if len(parts) == 3:
        s, c = int(parts[1]), int(parts[2])
        recs = recs[s:s + c]
    yield from recs


def recordio_sample_records(payload: str):
    """Task-payload mapper for shards written by ``convert``: yields the
    unpickled samples of one shard."""
    for rec in recordio_task_records(payload):
        yield pickle.loads(rec)


def cluster_files_reader(files_pattern, trainer_count, trainer_id, loader=None):
    """Read the file shards belonging to this trainer."""
    loader = loader or pickle.load

    def reader():
        flist = sorted(glob.glob(files_pattern))
        for i, fn in enumerate(flist):
            if i % trainer_count == trainer_id:
                with open(fn, "rb") as f:
                    for d in loader(f):
                        yield d

    return reader
