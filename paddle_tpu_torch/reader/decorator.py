"""Reader decorators (counterpart of ``paddle_tpu/reader/decorator.py``;
python/paddle/v2/reader/decorator.py parity). A reader creator is a
callable that returns an iterator over samples; these compose them.
``checkpointable`` records a reader's position for step snapshots
(trainer.SGD.train's resume), and ``mixed`` is MultiDataProvider's
weighted mixing."""

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


def mixed(readers, ratios=None, is_main=None, for_test=False,
          with_source_id=False):
    """Weighted sample mixing across sub-readers — the reader-level analog
    of MultiDataProvider (gserver/dataproviders/MultiDataProvider.cpp).

    Reference semantics preserved:

    - every window of emitted samples holds each source in proportion
      ``ratios[i] / sum(ratios)`` (getNextBatchInternal computes
      ``subSize = size * data_ratio / totalDataRatio`` per batch;
      a largest-remainder scheduler is the sample-level equivalent),
    - at least one reader is "main data" (``is_main``; default: the
      first). In train mode an exhausted main reader ends the epoch
      (MultiDataProvider.cpp:94-97 returns 0), while an exhausted
      non-main reader is reset and recycled (:99-104),
    - in test mode (``for_test=True``) an exhausted non-main reader just
      stops contributing (:106-112 appends an empty argument).

    ``with_source_id=True`` appends the sub-reader index to each sample
    (the Argument::dataId tag multi-task networks dispatch on): tuple and
    list samples are flattened to a tuple with the index appended; any
    other sample type (scalar, dict, array) is wrapped as
    ``(sample, index)``.
    """
    readers = list(readers)
    if ratios is None:
        ratios = [1.0] * len(readers)
    ratios = [float(x) for x in ratios]
    if len(ratios) != len(readers):
        raise ValueError("mixed(): len(ratios) != len(readers)")
    if any(x <= 0 for x in ratios):
        raise ValueError("mixed(): ratios must be positive")
    if is_main is None:
        is_main = [i == 0 for i in range(len(readers))]
    is_main = list(is_main)
    if len(is_main) != len(readers):
        raise ValueError("mixed(): len(is_main) != len(readers)")
    if not any(is_main):
        raise ValueError("mixed(): at least one reader must be main data "
                         "(MultiDataProvider requires an is_main_data flag)")
    total = sum(ratios)

    def tag(sample, i):
        if not with_source_id:
            return sample
        if isinstance(sample, (tuple, list)):
            return tuple(sample) + (i,)
        return (sample, i)

    def mixed_reader():
        its = [iter(r()) for r in readers]
        done = [False] * len(readers)        # test-mode exhaustion flags
        emitted = [0] * len(readers)
        step = 0
        while True:
            step += 1
            # largest remainder: the most under-served live source next
            live = [i for i in range(len(readers)) if not done[i]]
            if not live:
                return
            i = max(live, key=lambda j: ratios[j] / total * step - emitted[j])
            try:
                sample = next(its[i])
            except StopIteration:
                if is_main[i]:
                    return                   # main exhausted -> epoch over
                if for_test:
                    done[i] = True
                    continue
                its[i] = iter(readers[i]())  # recycle non-main source
                try:
                    sample = next(its[i])
                except StopIteration:
                    raise ValueError(
                        f"mixed(): non-main reader {i} is empty even "
                        "after reset (CHECK_GT(realSize, 0) analog)")
            emitted[i] += 1
            yield tag(sample, i)

    return mixed_reader


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


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with worker threads (xmap_readers parity;
    threads, not processes).

    Feed- and worker-thread exceptions are captured and re-raised in the
    consuming thread once the pipeline drains — a crashed daemon worker
    must not silently truncate the epoch."""

    def xreader():
        in_q: _queue.Queue = _queue.Queue(buffer_size)
        out_q: _queue.Queue = _queue.Queue(buffer_size)
        END = object()
        failures = []

        def feed():
            try:
                for i, s in enumerate(reader()):
                    in_q.put((i, s))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                failures.append(e)
            finally:
                for _ in range(process_num):
                    in_q.put(END)

        def work():
            while True:
                item = in_q.get()
                if item is END:
                    out_q.put(END)
                    return
                i, s = item
                try:
                    out_q.put((i, mapper(s)))
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    failures.append(e)
                    out_q.put(END)
                    return

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()
        done = 0
        pending = {}
        next_i = 0
        while done < process_num:
            item = out_q.get()
            if item is END:
                done += 1
                continue
            if not order:
                yield item[1]
                continue
            pending[item[0]] = item[1]
            while next_i in pending:
                yield pending.pop(next_i)
                next_i += 1
        if failures:
            raise failures[0]
        if order:
            for i in sorted(pending):
                yield pending[i]

    return xreader


class CheckpointableReader:
    """Resumable wrapper around a reader creator: records (epoch, position,
    shuffle-seed) as it yields and skips ahead on restore — the reader-side
    half of step-granular checkpoint/resume.

    Apply OUTERMOST (after batch()/buffered(): a prefetching inner stage
    consumes ahead of the trainer, so an inner position would overcount).
    One ``__call__`` is one epoch/pass. When ``seed`` is given, the global
    ``random`` module is reseeded ``seed + epoch`` at each epoch start, so
    upstream ``shuffle()`` decorators replay the same order on restore and
    skip-ahead lands on exactly the batches the crashed run would have
    produced.

    Pipelined trainer interplay (docs/torch_train_loop.md): snapshots are only
    written at fully-drained batch boundaries, where the trainer has
    consumed exactly as many batches as it has trained — so ``state()``
    taken there is the same position a synchronous run would record,
    and a resume replays the identical trajectory regardless of the
    pipeline_depth of either run."""

    def __init__(self, reader, seed=None):
        self._reader = reader
        self._seed = seed
        self._epoch = 0
        self._consumed = 0          # items yielded in the current epoch
        self._pending_skip = 0      # restore-requested skip for next epoch

    def state(self) -> dict:
        return {"epoch": self._epoch, "consumed": self._consumed,
                "seed": self._seed}

    def restore(self, state: dict):
        self._epoch = int(state.get("epoch", 0))
        self._pending_skip = int(state.get("consumed", 0))
        self._consumed = 0

    def __call__(self):
        from paddle_tpu_torch.distributed import faults

        epoch = self._epoch
        if self._seed is not None:
            random.seed(self._seed + epoch)
        skip = self._pending_skip
        self._pending_skip = 0
        self._consumed = 0
        n = 0
        for item in self._reader():
            n += 1
            self._consumed = n
            if n <= skip:
                continue
            faults.fire("reader.next", position=n, epoch=epoch)
            yield item
        self._epoch = epoch + 1
        self._consumed = 0


def checkpointable(reader, seed=None) -> CheckpointableReader:
    """Wrap a reader creator so its position survives a crash (see
    CheckpointableReader)."""
    return CheckpointableReader(reader, seed=seed)


def cache(reader):
    """Cache the first full iteration in memory."""
    all_data = []
    filled = [False]

    def cached():
        if filled[0]:
            yield from all_data
            return
        for item in reader():
            all_data.append(item)
            yield item
        filled[0] = True

    return cached
