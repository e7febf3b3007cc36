"""The port's readers against the JAX package's: ``xmap_readers``
(ordered, unordered, a mapper's and a feeder's errors re-raised),
``mixed`` (ratios, main-data exhaustion, test mode, source ids),
``cache``, ``checkpointable`` (state, restore, reseeded shuffles), the
reader creators, RecordIO files (the same bytes, read in both directions)
and ``dataset.common``'s shard writers and readers.
"""

import os
import pickle
import random

import numpy as np
import pytest

import paddle_tpu.reader as jr
from paddle_tpu.dataset import common as jcommon
from paddle_tpu.io import recordio as jrecordio

import paddle_tpu_torch.reader as tr
from paddle_tpu_torch.dataset import common as tcommon
from paddle_tpu_torch.io import recordio as trecordio


def nums(n):
    return lambda: iter(range(n))


@pytest.mark.parametrize("order", [True, False])
def test_xmap_readers_match_jax(order):
    out = {}
    for name, m in (("jax", jr), ("port", tr)):
        r = m.xmap_readers(lambda x: x * x, nums(50), 4, 8, order=order)
        out[name] = list(r())
    want = [i * i for i in range(50)]
    if order:
        assert out["port"] == out["jax"] == want
    else:
        assert sorted(out["port"]) == sorted(out["jax"]) == want


@pytest.mark.parametrize("where", ["mapper", "feeder"])
def test_xmap_readers_reraise(where):
    def bad_mapper(x):
        if x == 7:
            raise ValueError("mapper died")
        return x

    def bad_reader():
        yield from range(5)
        raise ValueError("feeder died")

    for m in (jr, tr):
        if where == "mapper":
            r = m.xmap_readers(bad_mapper, nums(20), 3, 4, order=True)
        else:
            r = m.xmap_readers(lambda x: x, bad_reader, 3, 4, order=True)
        with pytest.raises(ValueError, match=f"{where} died"):
            list(r())


MIXED_CASES = {
    "even": dict(ratios=None),
    "weighted": dict(ratios=[3, 1]),
    "second_main": dict(ratios=[1, 2], is_main=[False, True]),
    "test_mode": dict(ratios=[1, 1], for_test=True),
    "source_id": dict(ratios=[2, 1], with_source_id=True),
}


@pytest.mark.parametrize("case", sorted(MIXED_CASES))
def test_mixed_matches_jax(case):
    kw = MIXED_CASES[case]

    def a():
        return iter([(i, "a") for i in range(12)])

    def b():
        return iter([(i, "b") for i in range(5)])

    got = list(tr.mixed([a, b], **kw)())
    want = list(jr.mixed([a, b], **kw)())
    assert got == want and len(got) > 0


def test_mixed_refusals_match_jax():
    for m in (jr, tr):
        with pytest.raises(ValueError, match="ratios"):
            m.mixed([nums(2), nums(2)], ratios=[1])
        with pytest.raises(ValueError, match="positive"):
            m.mixed([nums(2), nums(2)], ratios=[1, 0])
        with pytest.raises(ValueError, match="main"):
            m.mixed([nums(2)], is_main=[False])
        with pytest.raises(ValueError, match="empty"):
            list(m.mixed([nums(9), lambda: iter([])])())


def test_cache_reads_once():
    calls = []

    def src():
        calls.append(1)
        return iter(range(4))

    c = tr.cache(src)
    assert list(c()) == list(c()) == [0, 1, 2, 3]
    assert len(calls) == 1


def test_checkpointable_matches_jax():
    """state() after k items, restore() into a fresh wrapper, and the
    epoch's shuffle reseeded: the port's wrapper yields what JAX's does,
    through the port's own shuffle decorator."""
    out = {}
    for name, m in (("jax", jr), ("port", tr)):
        ck = m.checkpointable(m.shuffle(nums(20), 7), seed=5)
        first = list(ck())                     # epoch 0
        it = ck()                              # epoch 1, stop after 6
        part = [next(it) for _ in range(6)]
        st = ck.state()
        fresh = m.checkpointable(m.shuffle(nums(20), 7), seed=5)
        fresh.restore(st)
        rest = list(fresh())
        out[name] = (first, part, st, rest, fresh.state())
    assert out["port"] == out["jax"]
    first, part, st, rest, after = out["port"]
    assert st == {"epoch": 1, "consumed": 6, "seed": 5}
    assert sorted(part + rest) == list(range(20)) and first != part + rest
    assert after == {"epoch": 2, "consumed": 0, "seed": 5}


def test_creators_match_jax(tmp_path):
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    assert [r.tolist() for r in tr.creator.np_array(x)()] == \
        [r.tolist() for r in jr.creator.np_array(x)()]
    p = tmp_path / "lines.txt"
    p.write_text("a\nbb\n\nccc\n")
    assert list(tr.creator.text_file(str(p))()) == \
        list(jr.creator.text_file(str(p))()) == ["a", "bb", "", "ccc"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_recordio_crosses_packages(tmp_path, writer):
    recs = [b"", b"x", os.urandom(300), "text"]
    paths = {}
    for name, m in (("port", trecordio), ("jax", jrecordio)):
        paths[name] = str(tmp_path / f"{name}.rio")
        with m.RecordIOWriter(paths[name]) as w:
            for rec in recs:
                w.write(rec)
    assert open(paths["port"], "rb").read() == open(paths["jax"],
                                                    "rb").read()
    reader = trecordio if writer == "jax" else jrecordio
    want = [r.encode() if isinstance(r, str) else r for r in recs]
    with reader.RecordIOReader(paths[writer]) as r:
        assert list(r) == want
        assert r.index() == jrecordio.RecordIOReader(paths[writer]).index()
        assert r.read_range(r.index()[1][0], 2) == want[1:3]
    assert list(tr.creator.recordio([paths[writer]] * 2)()) == want * 2
    blob = bytearray(open(paths[writer], "rb").read())
    blob[-1] ^= 0xFF
    bad = str(tmp_path / "bad.rio")
    open(bad, "wb").write(bytes(blob))
    with pytest.raises(IOError, match="crc"):
        list(trecordio.RecordIOReader(bad))


def test_dataset_common_matches_jax(tmp_path, monkeypatch):
    samples = [(i, [i] * (i % 4)) for i in range(11)]
    out = {}
    for name, m in (("jax", jcommon), ("port", tcommon)):
        d = tmp_path / name
        paths = m.convert(str(d / "rio"), lambda: iter(samples), 4, "shard",
                          shuffle_seed=3)
        recs = [list(m.recordio_sample_records(p)) for p in paths]
        part = list(m.recordio_sample_records(f"{paths[0]}:1:2"))
        os.makedirs(d / "pk")
        m.split(lambda: iter(samples), 5, suffix=str(d / "pk" / "%05d.pickle"))
        shards = [m.cluster_files_reader(str(d / "pk" / "*.pickle"), 2, t)
                  for t in (0, 1)]
        out[name] = ([os.path.basename(p) for p in paths], recs, part,
                     [list(s()) for s in shards],
                     [open(p, "rb").read() for p in paths],
                     m.md5file(paths[0]))
    assert out["port"] == out["jax"]
    names, recs, part, shards, _, _ = out["port"]
    assert sorted(x for r in recs for x in r) == sorted(samples)
    assert part == recs[0][1:3]
    assert sorted(shards[0] + shards[1]) == sorted(samples)
    # download: a cached file with the right md5 is returned as it is
    # (no fetch); nothing here reaches the network
    import urllib.request

    def no_fetch(*a, **kw):
        raise AssertionError("download fetched")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_fetch)
    monkeypatch.setattr(tcommon, "DATA_HOME", str(tmp_path / "home"))
    cached = tmp_path / "home" / "mod" / "data.bin"
    os.makedirs(cached.parent)
    cached.write_bytes(pickle.dumps(samples))
    assert tcommon.download("http://example.invalid/x/data.bin", "mod",
                            tcommon.md5file(str(cached))) == str(cached)


def test_shuffle_follows_the_global_seed():
    """checkpointable's reseeding reaches the port's shuffle through the
    global ``random`` module, as in the JAX package."""
    random.seed(11)
    a = list(tr.shuffle(nums(30), 30)())
    random.seed(11)
    b = list(jr.shuffle(nums(30), 30)())
    assert a == b != list(range(30))
