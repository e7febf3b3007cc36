"""Sparse-row gradients: the (rows, values) carrier for big-table dW
(counterpart of ``paddle_tpu/sparse_grad.py``; analog of the reference's
SparseRowMatrix gradients, SparseRowCpuMatrix::sgdUpdate and the
MAT_SPARSE_ROW* parameter formats of sparse_update tables).

A layer that reads only K of a table's C rows hands the optimizer the
touched row ids and a dense [K, D] block of their gradients, and the
optimizer updates those rows alone: the dense [C, D] gradient is never
built, neither as the zero buffer and index-add of autograd's gather
backward nor as an optimizer temporary.

``rows`` is int32 [M]; -1 marks a dead slot (padding, or a later duplicate
in a selection row, whose value is zero). Real ids may repeat (the same
row picked by two batch rows): ``dedup_rows`` sums them before the
optimizer updates its per-row state, since a non-linear rule (AdaGrad's
g^2) needs (sum g)^2, not sum g^2.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class SparseRowGrad:
    """Gradient of a [C, ...] table touched only at ``rows``.

    rows:   int32 [M], -1 = dead slot (dropped at apply)
    values: [M, ...] per-slot gradients (trailing dims as the table's)
    shape:  the dense table's shape
    """

    rows: torch.Tensor
    values: torch.Tensor
    shape: Tuple[int, ...]

    @property
    def num_rows(self) -> int:
        return self.shape[0]

    def dense(self) -> torch.Tensor:
        """The dense gradient, for tests: a train step that builds it
        defeats the point."""
        out = self.values.new_zeros(tuple(self.shape))
        live = self.rows >= 0
        out.index_add_(0, self.rows[live].long(), self.values[live])
        return out


def dedup_rows(rows: torch.Tensor, values: torch.Tensor):
    """Sum the values of repeated row ids.

    Returns (rows', values') of the same length M, where every real id
    appears once carrying its summed values and every other slot (a
    duplicate's tail, a -1 pad, an unused segment) has row' = -1. Fixed
    shapes, no ``torch.unique``: a stable sort groups equal ids, a cumsum
    numbers the groups, and ``index_add`` sums each group into its
    number's slot."""
    M = rows.shape[0]
    if M == 0:
        return rows, values
    rs, order = torch.sort(rows, stable=True)
    vs = values[order]
    start = torch.ones_like(rs, dtype=torch.bool)
    start[1:] = rs[1:] != rs[:-1]
    seg = torch.cumsum(start.to(torch.int64), 0) - 1      # [M] group number
    summed = torch.zeros_like(vs).index_add_(0, seg, vs)
    # each group's id sits at its number's slot; a -1 group stays -1, the
    # unused numbers keep -1
    seg_rows = torch.full_like(rows, -1).scatter_(0, seg, rs)
    return seg_rows, summed


def dedup_rows_np(rows, values):
    """Host twin of ``dedup_rows`` (for a host-table flush): drops
    negative ids and sums repeated ids' values. Returns (unique_rows [m]
    int64 ascending, summed_values [m, ...]), compact: no dead slots."""
    rows = np.asarray(rows).reshape(-1)
    values = np.asarray(values)
    if values.shape[0] != rows.shape[0]:
        raise ValueError(f"dedup_rows_np: values leading dim {values.shape} "
                         f"!= rows {rows.shape}")
    vals = values.reshape(rows.shape[0], -1)
    keep = rows >= 0
    rows, vals = rows[keep], vals[keep]
    uniq, inv = np.unique(rows, return_inverse=True)
    out = np.zeros((uniq.shape[0], vals.shape[1]), vals.dtype)
    if uniq.shape[0] == rows.shape[0]:
        # no repeats (a host table's cache rows): a permutation
        out[inv] = vals
    else:
        np.add.at(out, inv, vals)
    return uniq.astype(np.int64), out.reshape((uniq.shape[0],)
                                              + values.shape[1:])


def is_sparse(g) -> bool:
    return isinstance(g, SparseRowGrad)
