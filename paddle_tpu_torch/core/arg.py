"""Batch argument representation (counterpart of
``paddle_tpu/core/arg.py``; analog of paddle/parameter/Argument.h).

Ragged batches are padded + masked tensors:

- dense arg:      value [B, ...features]                      (mask None)
- sequence arg:   value [B, T, ...features], mask [B, T]       (1 = real step)
- nested arg:     + seg_ids [B, T] int32 (sub-sequence index, -1 = padding)

A nested feed (``*_sub_sequence`` data types) carries seg_ids from the
DataFeeder; the time-preserving layers pass them on, sub-sequence pooling
(``agg_level="to_sequence"``) and ``SubsequenceInput`` groups read them,
and beam search's ``num_results_per_sample > 1`` output makes them.
A packed feed (``DataFeeder(pack_sequences=True)``, docs/packing.md)
carries them on plain sequences too: there they number the samples packed
back to back into a row (0..k-1, -1 on padding).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass
class Arg:
    value: torch.Tensor
    mask: Optional[torch.Tensor] = None        # [B, T] float32 in {0,1}
    seg_ids: Optional[torch.Tensor] = None     # [B, T] int32

    def with_value(self, value: torch.Tensor) -> "Arg":
        return Arg(value, self.mask, self.seg_ids)

    def lengths(self) -> torch.Tensor:
        """Valid steps per row [B] (int32)."""
        assert self.mask is not None
        return self.mask.to(torch.float32).sum(dim=-1).to(torch.int32)

    def to(self, device) -> "Arg":
        move = (lambda t: None if t is None else
                torch.as_tensor(t).to(device))
        return Arg(move(self.value), move(self.mask), move(self.seg_ids))


@dataclasses.dataclass(frozen=True)
class ArgInfo:
    """Static shape/type info for a layer output (the reference config
    parser's per-layer size propagation)."""

    size: int                               # flattened feature size
    shape: Optional[Tuple[int, ...]] = None  # spatial shape e.g. (C, H, W)
    is_seq: bool = False
    is_nested: bool = False
    dtype: Any = torch.float32

    def replace(self, **kw) -> "ArgInfo":
        return dataclasses.replace(self, **kw)


def row_offset_segment_ids(seg_ids: torch.Tensor,
                           num_segments: int) -> torch.Tensor:
    """Flatten per-row segment ids [B, T] into one disjoint id space [B*T]
    (int64, for index_add_ / scatter_reduce): slot (row b, seg s) ->
    b*S + s, with S = ``num_segments`` bounding the per-row segment
    count. Ids are clipped into [0, S-1], so padding (seg -1) lands in
    slot 0: callers must zero its contribution (gate by the mask)."""
    B = seg_ids.shape[0]
    rows = torch.arange(B, device=seg_ids.device)[:, None] * num_segments
    return (seg_ids.long().clamp(0, num_segments - 1) + rows).reshape(-1)


def segment_start_resets(seg_ids: torch.Tensor, mask: torch.Tensor,
                         reverse: bool = False) -> torch.Tensor:
    """[B, T] reset vector of packed rows, in ``mask``'s dtype: 1.0 at the
    first valid step of each packed segment, where a recurrent carry must
    be zeroed so that no state crosses a sequence boundary. ``reverse``
    marks each segment's last valid step instead (a reverse recurrence's
    carry enters from t+1). Always multiplied by the mask: a padding step
    never cuts the carry it must pass through."""
    edge = torch.full_like(seg_ids[:, :1], -1)
    if reverse:
        r = seg_ids != torch.cat([seg_ids[:, 1:], edge], dim=1)
    else:
        r = seg_ids != torch.cat([edge, seg_ids[:, :-1]], dim=1)
    return r.to(mask.dtype) * mask


def packed_segment_count(seg_ids: torch.Tensor) -> torch.Tensor:
    """The number of packed sequences in a batch of packed rows, float32:
    the feeder numbers a row's segments 0..k-1 (-1 on padding), so the
    count is the sum over rows of (max seg id + 1); an all-padding row
    adds nothing."""
    return torch.clamp(seg_ids.max(dim=1).values + 1, min=0).sum() \
        .to(torch.float32)


def as_arg(x) -> Arg:
    """Coerce raw tensors / (value, mask) tuples to Arg."""
    if isinstance(x, Arg):
        return x
    if isinstance(x, tuple) and len(x) == 2:
        return Arg(torch.as_tensor(x[0]), torch.as_tensor(x[1]))
    return Arg(torch.as_tensor(x))
