"""Reader decorators (counterpart of ``paddle_tpu/reader/decorator.py``;
python/paddle/v2/reader/decorator.py parity). A reader creator is a
callable that returns an iterator over samples; these compose them."""

from __future__ import annotations

import itertools
import queue as _queue
import random
import threading


def map_readers(func, *readers):
    """Create a reader yielding func applied to the zipped outputs."""

    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    def shuffled_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return shuffled_reader


def _sample_seq_len(sample):
    """Default sort key: the length of the sample's first sized slot. A
    tuple sample (src_ids, trg_ids, label) must not sort by ``len`` (its
    constant slot count), so the key digs into the first slot with a
    length; a list whose first item is sized counts as slots too; a
    sequence of scalars is the sequence itself. A bare dense sequence
    outside a tuple is ambiguous with a list of slots: pass ``key=``."""
    if isinstance(sample, tuple):
        for slot in sample:
            if hasattr(slot, "__len__"):
                return len(slot)
        raise TypeError(
            "sort_within_buffer: no sized slot in sample %r; pass an "
            "explicit key=" % (sample,))
    if isinstance(sample, list) and sample \
            and hasattr(sample[0], "__len__"):
        return len(sample[0])
    return len(sample)


def sort_within_buffer(reader, buffer_size, key=None):
    """Length-sorted window: buffer ``buffer_size`` samples, emit them
    sorted by ``key`` (ascending; default: the length of the sample's
    first sized slot), repeat. After an upstream ``shuffle()``, batches cut
    from a sorted window hold near-equal lengths, so a padded batch's T
    follows its own longest sample, and packed rows fill tighter
    (docs/packing.md). Deterministic given the upstream order: ties keep
    their arrival order."""
    if key is None:
        key = _sample_seq_len

    def sorted_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buffer_size:
                buf.sort(key=key)
                yield from buf
                buf = []
        if buf:
            buf.sort(key=key)
            yield from buf

    return sorted_reader


def chain(*readers):
    def chained():
        return itertools.chain(*[r() for r in readers])

    return chained


def compose(*readers, **kwargs):
    """Zip readers into tuple samples; check_alignment like the reference."""
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def composed():
        rs = [r() for r in readers]
        if check_alignment:
            for items in zip(*rs):
                yield sum((make_tuple(i) for i in items), ())
        else:
            for items in itertools.zip_longest(*rs):
                yield sum((make_tuple(i) for i in items if i is not None), ())

    return composed


def buffered(reader, size):
    """Background-thread double buffering (the PyDataProvider2 async
    queue analog). An exception in the fill thread is re-raised in the
    consuming thread, so a dying producer never truncates the epoch
    silently."""

    class _End:
        pass

    def buffered_reader():
        q = _queue.Queue(maxsize=size)
        failure = []

        def fill():
            try:
                for d in reader():
                    q.put(d)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                failure.append(e)
            finally:
                q.put(_End)

        threading.Thread(target=fill, daemon=True).start()
        while True:
            e = q.get()
            if e is _End:
                if failure:
                    raise failure[0]
                break
            yield e

    return buffered_reader


def firstn(reader, n):
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i >= n:
                break
            yield item

    return firstn_reader
