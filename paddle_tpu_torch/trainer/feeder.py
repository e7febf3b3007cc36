"""DataFeeder: convert python minibatches to padded + masked Args
(counterpart of ``paddle_tpu/trainer/feeder.py``; analog of
paddle/py_paddle/dataprovider_converter.py). Ragged sequences become
padded+masked numpy arrays; sequence lengths are bucketed to powers of two
(or to a multiple of ``bucket_rounding``), as in the JAX package, so both
run the same padded shapes.

The port converts integer and dense slots, flat, as plain sequences or
nested (a row is a list of sub-sequences, flattened in order, with
``seg_ids`` the index of each step's sub-sequence and -1 on padding), and
flat sparse slots (id lists, or (id, value) lists, padded to ``max_ids``
with -1). Sparse sequences have no padded format in either package and
are refused.

Packed-feed mode (``pack_sequences=True``, docs/packing.md): instead of
one padded row a sample, several ragged samples pack back to back into
each [R, T] row, with ``seg_ids`` numbering the samples of a row (0..k-1,
-1 on padding). One greedy first-fit-decreasing plan is shared by every
slot, so segment k of row r is the same sample in every feed; the row
count is rounded up to a multiple of ``pack_row_rounding`` with
all-padding filler rows (mask 0, seg -1).

``use_staging_arena`` assembles batches in reusable arena buffers
(io/staging.py: pinned on a CUDA trainer), rotated through
``rotate_buffers`` generations under the pipelined loop. Each sequence
slot's padding waste goes to the ``paddle_feed_pad_fraction`` histogram
and its padded T to the ``paddle_feed_padded_len`` gauge, the JAX
package's series.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.data_type import InputType, SeqType
from paddle_tpu_torch.observability import metrics as _obs
from paddle_tpu_torch.utils.error import enforce

# Padding waste of the sequence batching, per feed slot: 1 - real
# timesteps / (rows * padded T); packed="0" is the one-sample-per-row
# path, packed="1" the packed path's residual tail waste. The padded T of
# the last conversion is the paddle_feed_padded_len gauge.
_M_PAD_FRACTION = _obs.histogram(
    "paddle_feed_pad_fraction",
    "Fraction of a padded sequence batch that is padding: "
    "1 - real_timesteps / (rows * padded_T). packed=0: per-sample "
    "padding+bucketing waste; packed=1: residual tail waste of "
    "sequence-packed rows (docs/packing.md)",
    labels=("feed", "packed"),
    buckets=(0.01, 0.02, 0.05, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5,
             0.6, 0.7, 0.8, 0.9, 1.0))
_M_PADDED_LEN = _obs.gauge(
    "paddle_feed_padded_len",
    "Padded sequence length (T) chosen for the last converted batch of "
    "this feed slot — the paddle_feed_pad_fraction exemplar",
    labels=("feed", "packed"))


def _bucket(n: int, bucketing: bool, rounding: Optional[int] = None) -> int:
    """Padded length for a max sequence length ``n``. Default: next power
    of two. ``rounding=N`` rounds up to a multiple of N instead."""
    if rounding:
        enforce(rounding >= 1, "bucket_rounding must be >= 1")
        return max(-(-max(n, 1) // rounding) * rounding, 1)
    if not bucketing or n <= 1:
        return max(n, 1)
    p = 1
    while p < n:
        p <<= 1
    return p


def _pack_plan(lengths: Dict[str, List[int]],
               caps: Dict[str, int]) -> List[List[int]]:
    """Greedy first-fit-decreasing packing plan shared by every feed slot.

    lengths: {slot: [each sample's length]}; caps: {slot: row capacity}.
    A sample fits a row only if it fits in every slot, so all slots of one
    sample land in the same row at the same segment index. Returns the
    rows as lists of sample indices (packing order = segment order).
    Deterministic: it depends on the lengths alone (longest first, ties
    by index)."""
    names = list(lengths)
    n = len(lengths[names[0]]) if names else 0
    order = sorted(range(n),
                   key=lambda i: (-max(lengths[s][i] for s in names), i))
    rows: List[tuple] = []          # (used: {slot: int}, members: [i])
    for i in order:
        for used, members in rows:
            if all(used[s] + lengths[s][i] <= caps[s] for s in names):
                for s in names:
                    used[s] += lengths[s][i]
                members.append(i)
                break
        else:
            rows.append(({s: lengths[s][i] for s in names}, [i]))
    return [members for _used, members in rows]


def resolve_pack_flags(pack_sequences=None, pack_max_len=None,
                       bucket_rounding=None):
    """Resolve the packing/bucketing knobs against their same-named flags
    (None = flag fallback), as the JAX package does, so every surface
    feeds the same padded shapes."""
    from paddle_tpu_torch.utils.flags import FLAGS
    if pack_sequences is None:
        pack_sequences = bool(FLAGS.get("pack_sequences", False))
    if pack_max_len is None:
        pack_max_len = FLAGS.get("pack_max_len", 0) or None
    if bucket_rounding is None:
        bucket_rounding = FLAGS.get("bucket_rounding", 0) or None
    return bool(pack_sequences), pack_max_len, bucket_rounding


class DataFeeder:
    def __init__(self, data_types: Sequence,
                 feeding: Optional[Dict[str, int]] = None,
                 bucket_seq_len: bool = True,
                 bucket_rounding: Optional[int] = None,
                 pack_sequences: bool = False,
                 pack_max_len: Optional[int] = None,
                 pack_row_rounding: Optional[int] = None,
                 use_staging_arena: bool = False, rotate_buffers: int = 1,
                 pin_memory: bool = False):
        """data_types: [(name, InputType)] — from Topology.data_type().

        pack_sequences: pack several ragged samples into each [R, T] row
        with seg_ids (docs/packing.md). Every feed slot must be a plain
        index or dense SEQUENCE input. ``last_pack_plan`` holds the rows'
        sample indices of the last batch.

        pack_max_len: the packed row capacity T, honoured exactly (a
        longer sample bumps it to its bucketed length). None: twice the
        batch's longest sample in that slot, bucketed.

        pack_row_rounding: round the packed row count up to a multiple of
        N with all-padding filler rows (mask 0, seg -1), which every
        segment-aware consumer ignores. 1 keeps the plan's R; None is the
        default of 8.

        use_staging_arena: assemble batches into reusable buffers of the
        shared staging arena (io/staging.py), page-locked where
        ``pin_memory`` (a CUDA trainer). Recycled buffers alias across
        batches: a batch must be copied off its buffers within
        ``rotate_buffers`` assemblies, and no other feeder may share the
        feed names.

        rotate_buffers: arena generations to cycle through (the pipelined
        trainer passes its depth); ``next_gen`` is the generation the
        next call writes."""
        self.data_types = list(data_types)
        if feeding is None:
            feeding = {name: i for i, (name, _) in enumerate(self.data_types)}
        self.feeding = feeding
        self.bucket = bucket_seq_len
        self.bucket_rounding = bucket_rounding
        self.pack = bool(pack_sequences)
        self.pack_max_len = pack_max_len
        if pack_row_rounding is None:
            pack_row_rounding = 8
        enforce(pack_row_rounding >= 1, "pack_row_rounding must be >= 1")
        self.pack_row_rounding = int(pack_row_rounding)
        #: row -> [sample indices] of the last packed batch
        self.last_pack_plan: Optional[List[List[int]]] = None
        if self.pack:
            for name, itype in self.data_types:
                enforce(isinstance(itype, InputType)
                        and itype.seq_type == SeqType.SEQUENCE
                        and itype.kind in ("index", "dense"),
                        f"pack_sequences: feed slot {name!r} must be a "
                        "plain index/dense SEQUENCE input (non-sequence, "
                        "nested and sparse slots cannot be packed)")
        self._rotate = max(1, int(rotate_buffers))
        self._gen = 0
        self._arena = None
        if use_staging_arena:
            from paddle_tpu_torch.io.staging import shared_arena
            self._arena = shared_arena(pin_memory)

    @property
    def next_gen(self) -> int:
        """The buffer generation the next call assembles into."""
        return (self._gen + 1) % self._rotate

    def _zeros(self, shape, dtype, slot, role="v"):
        # role tells apart same-shape buffers of one slot (a sequence's
        # int32 value and its int32 seg_ids)
        if self._arena is not None:
            return self._arena.buffer(f"{slot}:{role}", shape, dtype,
                                      gen=self._gen)
        return np.zeros(shape, dtype)

    def _full(self, shape, fill, dtype, slot, role="v"):
        if self._arena is not None:
            return self._arena.full(f"{slot}:{role}", shape, fill, dtype,
                                    gen=self._gen)
        return np.full(shape, fill, dtype)

    def __call__(self, batch: List[Sequence]) -> Dict[str, Arg]:
        self._gen = self.next_gen
        if self.pack:
            return self._convert_packed(batch)
        feeds = {}
        for name, itype in self.data_types:
            col = self.feeding[name]
            feeds[name] = self.convert_one([sample[col] for sample in batch],
                                           itype, slot=name)
        return feeds

    def _convert_packed(self, batch: List[Sequence]) -> Dict[str, Arg]:
        """One first-fit-decreasing plan across the slots, then each
        slot's [R, T] value, mask and seg_ids."""
        cols = {name: self.feeding[name] for name, _ in self.data_types}
        lengths = {name: [len(sample[cols[name]]) for sample in batch]
                   for name, _ in self.data_types}
        for name, ls in lengths.items():
            # the loss counts sequences from seg_ids (max + 1 a row), so
            # an empty trailing segment would vanish from it
            enforce(all(t > 0 for t in ls),
                    f"pack_sequences: feed slot {name!r} contains a "
                    "zero-length sequence; packed mode requires every "
                    "sample to have >= 1 step in every slot (filter "
                    "empty samples out upstream)")
        caps = {}
        for name, _ in self.data_types:
            longest = max(lengths[name], default=1)
            if self.pack_max_len:
                caps[name] = self.pack_max_len \
                    if longest <= self.pack_max_len \
                    else _bucket(longest, self.bucket, self.bucket_rounding)
            else:
                caps[name] = _bucket(max(2 * longest, 1), self.bucket,
                                     self.bucket_rounding)
        plan = _pack_plan(lengths, caps)
        self.last_pack_plan = plan
        rr = self.pack_row_rounding
        R = -(-max(len(plan), 1) // rr) * rr
        return {name: self._fill_packed_slot(
                    [sample[cols[name]] for sample in batch], itype, plan,
                    caps[name], R, name)
                for name, itype in self.data_types}

    def _fill_packed_slot(self, rows, itype, plan, cap, R, slot) -> Arg:
        dense = itype.kind == "dense"
        step = (itype.dim,) if dense else ()
        value = self._zeros((R, cap) + step,
                            np.float32 if dense else np.int32, slot)
        mask = self._zeros((R, cap), np.float32, slot, role="mask")
        seg = self._full((R, cap), -1, np.int32, slot, role="seg")
        real = 0
        for r, members in enumerate(plan):
            off = 0
            for s_idx, i in enumerate(members):
                t = len(rows[i])
                value[r, off:off + t] = np.asarray(
                    rows[i], value.dtype).reshape((t,) + step)
                mask[r, off:off + t] = 1.0
                seg[r, off:off + t] = s_idx
                off += t
                real += t
        _M_PAD_FRACTION.labels(feed=slot or "unnamed", packed="1").observe(
            1.0 - real / float(R * cap))
        _M_PADDED_LEN.labels(feed=slot or "unnamed", packed="1").set(cap)
        return Arg(value, mask, seg)

    def convert_one(self, rows, itype, slot="") -> Arg:
        # slot tags arena buffers; callers converting several feeds must
        # pass distinct slots or same-shape feeds alias one buffer
        enforce(isinstance(itype, InputType),
                f"DataFeeder: a data layer without an InputType is not "
                f"ported yet, got {itype!r}")
        sparse = itype.kind in ("sparse_binary", "sparse_value")
        enforce(not (sparse and itype.is_seq),
                f"DataFeeder: sparse sequence inputs have no padded format "
                f"(use embedding + pooling over an integer sequence), got "
                f"{itype!r}")
        if itype.seq_type == SeqType.NO_SEQUENCE:
            return self._convert_flat(rows, itype, slot)
        dense = itype.kind == "dense"
        seg_rows = None
        if itype.seq_type == SeqType.SUB_SEQUENCE:
            # a row is a list of sub-sequences: flatten it in order and
            # keep each step's sub-sequence index
            seg_rows = [[si for si, sub in enumerate(r) for _ in sub]
                        for r in rows]
            rows = [[step for sub in r for step in sub] for r in rows]
        T = _bucket(max((len(r) for r in rows), default=1), self.bucket,
                    self.bucket_rounding)
        step = (itype.dim,) if dense else ()
        B = len(rows)
        if B and T:
            real = sum(min(len(r), T) for r in rows)
            _M_PAD_FRACTION.labels(feed=slot or "unnamed",
                                   packed="0").observe(
                1.0 - real / float(B * T))
            _M_PADDED_LEN.labels(feed=slot or "unnamed", packed="0").set(T)
        value = self._zeros((B, T) + step, np.float32 if dense else np.int32,
                            slot)
        mask = self._zeros((B, T), np.float32, slot, role="mask")
        for i, r in enumerate(rows):
            t = min(len(r), T)
            if t:
                value[i, :t] = np.asarray(r[:t], value.dtype).reshape(
                    (t,) + step)
            mask[i, :t] = 1.0
        if seg_rows is None:
            return Arg(value, mask)
        seg_ids = self._full((B, T), -1, np.int32, slot, role="seg")
        for i, segs in enumerate(seg_rows):
            t = min(len(segs), T)
            seg_ids[i, :t] = segs[:t]
        return Arg(value, mask, seg_ids)

    def _convert_flat(self, rows, itype, slot="") -> Arg:
        if itype.kind == "dense":
            return Arg(np.asarray(rows, np.float32).reshape(len(rows), -1))
        if itype.kind == "index":
            return Arg(np.asarray(rows, np.int32).reshape(len(rows), 1))
        # sparse: rows are id lists (or (id, value) lists) -> ids padded
        # with -1 and cut at max_ids
        K = itype.max_ids
        ids = self._full((len(rows), K), -1, np.int32, slot, role="ids")
        vals = self._zeros((len(rows), K), np.float32, slot, role="vals")
        for i, r in enumerate(rows):
            if itype.kind == "sparse_value":
                for j, (idx, v) in enumerate(list(r)[:K]):
                    ids[i, j] = idx
                    vals[i, j] = v
            else:
                rr = list(r)[:K]
                ids[i, :len(rr)] = rr
        if itype.kind == "sparse_value":
            # ids travel in a float32 channel beside the values: exact only
            # below 2^24, so larger ids are refused rather than corrupted
            enforce(int(ids.max(initial=0)) < (1 << 24),
                    "sparse_value ids >= 2^24 are not representable")
            return Arg(np.stack([ids.astype(np.float32), vals], axis=-1))
        return Arg(ids)
