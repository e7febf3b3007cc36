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


def as_arg(x) -> Arg:
    """Coerce raw tensors / (value, mask) tuples to Arg."""
    if isinstance(x, Arg):
        return x
    if isinstance(x, tuple) and len(x) == 2:
        return Arg(torch.as_tensor(x[0]), torch.as_tensor(x[1]))
    return Arg(torch.as_tensor(x))
