"""Batch argument representation (counterpart of
``paddle_tpu/core/arg.py``; analog of paddle/parameter/Argument.h).

Ragged batches are padded + masked tensors:

- dense arg:      value [B, ...features]                      (mask None)
- sequence arg:   value [B, T, ...features], mask [B, T]       (1 = real step)

The JAX package's nested sequences (``seg_ids``) come with nested inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass
class Arg:
    value: torch.Tensor
    mask: Optional[torch.Tensor] = None        # [B, T] float32 in {0,1}

    def with_value(self, value: torch.Tensor) -> "Arg":
        return Arg(value, self.mask)

    def to(self, device) -> "Arg":
        move = (lambda t: None if t is None else
                torch.as_tensor(t).to(device))
        return Arg(move(self.value), move(self.mask))


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


def as_arg(x) -> Arg:
    """Coerce raw tensors / (value, mask) tuples to Arg."""
    if isinstance(x, Arg):
        return x
    if isinstance(x, tuple) and len(x) == 2:
        return Arg(torch.as_tensor(x[0]), torch.as_tensor(x[1]))
    return Arg(torch.as_tensor(x))
