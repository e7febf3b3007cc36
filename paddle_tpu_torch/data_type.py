"""Input type descriptors (counterpart of ``paddle_tpu/data_type.py``;
analog of paddle.v2.data_type).

The port feeds integer and dense inputs, flat, as plain sequences or as
nested sequences (a row is a list of sub-sequences), and the sparse kinds
as padded id lists: ``sparse_binary`` rows as [B, max_ids] int32 ids,
``sparse_value`` rows as [B, max_ids, 2] float32 (id, value) pairs, -1 on
padding. The sparse kinds' sequence forms are declared, as in the JAX
package, and refused by the feeder.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


class SeqType:
    NO_SEQUENCE = 0
    SEQUENCE = 1
    SUB_SEQUENCE = 2


@dataclasses.dataclass(frozen=True)
class InputType:
    dim: int
    seq_type: int = SeqType.NO_SEQUENCE
    kind: str = "dense"     # dense | index | sparse_binary | sparse_value
    dtype: object = torch.float32
    # for the sparse kinds: ids a row after padding (a static shape bound)
    max_ids: Optional[int] = None

    @property
    def is_seq(self) -> bool:
        return self.seq_type != SeqType.NO_SEQUENCE

    @property
    def is_nested(self) -> bool:
        return self.seq_type == SeqType.SUB_SEQUENCE


def dense_vector(dim, seq_type=SeqType.NO_SEQUENCE):
    return InputType(dim, seq_type, "dense", torch.float32)


def dense_vector_sequence(dim):
    return dense_vector(dim, SeqType.SEQUENCE)


def dense_vector_sub_sequence(dim):
    return dense_vector(dim, SeqType.SUB_SEQUENCE)


def dense_array(dim, seq_type=SeqType.NO_SEQUENCE):
    return dense_vector(dim, seq_type)


def integer_value(value_range, seq_type=SeqType.NO_SEQUENCE):
    return InputType(value_range, seq_type, "index", torch.int32)


def integer_value_sequence(value_range):
    return integer_value(value_range, SeqType.SEQUENCE)


def integer_value_sub_sequence(value_range):
    return integer_value(value_range, SeqType.SUB_SEQUENCE)


def sparse_binary_vector(dim, seq_type=SeqType.NO_SEQUENCE, max_ids=64):
    return InputType(dim, seq_type, "sparse_binary", torch.int32, max_ids)


def sparse_binary_vector_sequence(dim, max_ids=64):
    return sparse_binary_vector(dim, SeqType.SEQUENCE, max_ids)


def sparse_binary_vector_sub_sequence(dim, max_ids=64):
    return sparse_binary_vector(dim, SeqType.SUB_SEQUENCE, max_ids)


def sparse_float_vector(dim, seq_type=SeqType.NO_SEQUENCE, max_ids=64):
    return InputType(dim, seq_type, "sparse_value", torch.float32, max_ids)


def sparse_float_vector_sequence(dim, max_ids=64):
    return sparse_float_vector(dim, SeqType.SEQUENCE, max_ids)


def sparse_float_vector_sub_sequence(dim, max_ids=64):
    return sparse_float_vector(dim, SeqType.SUB_SEQUENCE, max_ids)
