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
are refused. Sequence packing and the staging arena come with the slices
that use them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.data_type import InputType, SeqType
from paddle_tpu_torch.utils.error import enforce


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
                 bucket_rounding: Optional[int] = None):
        """data_types: [(name, InputType)] — from Topology.data_type()."""
        self.data_types = list(data_types)
        if feeding is None:
            feeding = {name: i for i, (name, _) in enumerate(self.data_types)}
        self.feeding = feeding
        self.bucket = bucket_seq_len
        self.bucket_rounding = bucket_rounding

    def __call__(self, batch: List[Sequence]) -> Dict[str, Arg]:
        feeds = {}
        for name, itype in self.data_types:
            col = self.feeding[name]
            feeds[name] = self.convert_one([sample[col] for sample in batch],
                                           itype)
        return feeds

    def convert_one(self, rows, itype) -> Arg:
        enforce(isinstance(itype, InputType),
                f"DataFeeder: a data layer without an InputType is not "
                f"ported yet, got {itype!r}")
        sparse = itype.kind in ("sparse_binary", "sparse_value")
        enforce(not (sparse and itype.is_seq),
                f"DataFeeder: sparse sequence inputs have no padded format "
                f"(use embedding + pooling over an integer sequence), got "
                f"{itype!r}")
        if itype.seq_type == SeqType.NO_SEQUENCE:
            return self._convert_flat(rows, itype)
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
        value = np.zeros((len(rows), T) + step,
                         np.float32 if dense else np.int32)
        mask = np.zeros((len(rows), T), np.float32)
        for i, r in enumerate(rows):
            t = min(len(r), T)
            if t:
                value[i, :t] = np.asarray(r[:t], value.dtype).reshape(
                    (t,) + step)
            mask[i, :t] = 1.0
        if seg_rows is None:
            return Arg(value, mask)
        seg_ids = np.full((len(rows), T), -1, np.int32)
        for i, segs in enumerate(seg_rows):
            t = min(len(segs), T)
            seg_ids[i, :t] = segs[:t]
        return Arg(value, mask, seg_ids)

    def _convert_flat(self, rows, itype) -> Arg:
        if itype.kind == "dense":
            return Arg(np.asarray(rows, np.float32).reshape(len(rows), -1))
        if itype.kind == "index":
            return Arg(np.asarray(rows, np.int32).reshape(len(rows), 1))
        # sparse: rows are id lists (or (id, value) lists) -> ids padded
        # with -1 and cut at max_ids
        K = itype.max_ids
        ids = np.full((len(rows), K), -1, np.int32)
        vals = np.zeros((len(rows), K), np.float32)
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
