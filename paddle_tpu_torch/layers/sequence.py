"""Sequence layers (counterpart of ``paddle_tpu/layers/sequence.py``;
analogs of paddle/gserver/layers/{SequencePoolLayer,
SequenceLastInstanceLayer,ExpandLayer}.cpp). The port has max and
sum/average/squarerootn pooling of a plain sequence to one vector per row,
the first or last step of a sequence, and the expansion of one vector per
row over a sequence; the sub-sequence (nested) forms come with nested
inputs.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg, ArgInfo
from paddle_tpu_torch.core.layer import register_layer
from paddle_tpu_torch.utils.error import enforce

BIG_NEG = -1e30


def _to_no_sequence(cfg):
    level = cfg.attr("agg_level", "to_no_sequence")
    enforce(level == "to_no_sequence",
            f"{cfg.type} layer {cfg.name}: the port reduces to one vector "
            "per row only (agg_level to_no_sequence)")


def _pool_infer(cfg, in_infos):
    _to_no_sequence(cfg)
    return ArgInfo(size=in_infos[0].size, is_seq=False)


def _seq_pool(cfg, ins, how):
    a = ins[0]
    enforce(a.mask is not None,
            f"{cfg.type} layer {cfg.name} needs sequence input")
    v, m = a.value, a.mask[..., None]
    count = a.mask.sum(1, keepdim=True)
    if how == "max":
        out = torch.where(m > 0, v, torch.full_like(v, BIG_NEG)).amax(dim=1)
        out = torch.where(count > 0, out, torch.zeros_like(out))
    elif how == "sum":
        out = (v * m).sum(dim=1)
    elif how == "squarerootn":
        out = (v * m).sum(dim=1) / torch.sqrt(torch.clamp(count, min=1.0))
    else:
        enforce(how == "average",
                f"{cfg.type} layer {cfg.name}: unknown average_strategy "
                f"{how!r}")
        out = (v * m).sum(dim=1) / torch.clamp(count, min=1.0)
    return Arg(out.to(v.dtype))


@register_layer("max", infer=_pool_infer)
def _max_pool_seq(cfg, params, ins, ctx):
    return _seq_pool(cfg, ins, "max")


@register_layer("average", infer=_pool_infer)
def _avg_pool_seq(cfg, params, ins, ctx):
    return _seq_pool(cfg, ins, cfg.attr("average_strategy", "average"))


def _lastins_infer(cfg, in_infos):
    _to_no_sequence(cfg)
    return ArgInfo(size=in_infos[0].size, is_seq=False)


@register_layer("seqlastins", infer=_lastins_infer)
def _seq_last_ins(cfg, params, ins, ctx):
    """The last (or, with ``select_first``, the first) step of each
    sequence."""
    a = ins[0]
    if cfg.attr("select_first", False):
        return Arg(a.value[:, 0])
    idx = torch.clamp(a.lengths().long() - 1, min=0)              # [B]
    return Arg(a.value[torch.arange(a.value.shape[0]), idx])


def _expand_infer(cfg, in_infos):
    return ArgInfo(size=in_infos[0].size, is_seq=True)


@register_layer("expand", infer=_expand_infer)
def _expand(cfg, params, ins, ctx):
    """Broadcast the per-sequence vector in0 [B, D] to every step of the
    template sequence in1 [B, T, *], zero on the template's padding."""
    v, tmpl = ins[0].value, ins[1]
    out = v[:, None, :].expand(v.shape[0], tmpl.value.shape[1], v.shape[-1])
    return Arg(out * tmpl.mask[..., None].to(out.dtype), tmpl.mask,
               tmpl.seg_ids)
