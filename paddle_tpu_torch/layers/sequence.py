"""Sequence pooling (counterpart of ``paddle_tpu/layers/sequence.py``;
analog of paddle/gserver/layers/SequencePoolLayer). This slice of the port
has the max pooling of a plain sequence to one vector per row; the
sub-sequence (nested) form comes with nested inputs.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg, ArgInfo
from paddle_tpu_torch.core.layer import register_layer
from paddle_tpu_torch.utils.error import enforce

BIG_NEG = -1e30


def _pool_infer(cfg, in_infos):
    level = cfg.attr("agg_level", "to_no_sequence")
    enforce(level == "to_no_sequence",
            f"{cfg.type} layer {cfg.name}: the port pools to one vector "
            "per row only (agg_level to_no_sequence)")
    return ArgInfo(size=in_infos[0].size, is_seq=False)


@register_layer("max", infer=_pool_infer)
def _max_pool_seq(cfg, params, ins, ctx):
    a = ins[0]
    enforce(a.mask is not None,
            f"{cfg.type} layer {cfg.name} needs sequence input")
    v, m = a.value, a.mask[..., None]
    out = torch.where(m > 0, v, torch.full_like(v, BIG_NEG)).amax(dim=1)
    nonempty = a.mask.sum(1, keepdim=True) > 0
    return Arg(torch.where(nonempty, out, torch.zeros_like(out)))
