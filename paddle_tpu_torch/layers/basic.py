"""Basic layers: data, fc, embedding (counterpart of
``paddle_tpu/layers/basic.py``; analogs of
paddle/gserver/layers/{DataLayer,FullyConnectedLayer,TableProjection}.cpp).
Sequence inputs [B, T, D] contract on the last dim (batched matmul).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from paddle_tpu_torch.core.arg import Arg, ArgInfo
from paddle_tpu_torch.core.layer import ParamSpec, register_layer
from paddle_tpu_torch.utils.error import enforce


# --- data ----------------------------------------------------------------

def _data_infer(cfg, in_infos):
    t = cfg.attr("input_type")
    shape = cfg.attr("shape")
    if t is not None:
        return ArgInfo(size=t.dim, shape=shape, is_seq=t.is_seq,
                       is_nested=t.is_nested, dtype=t.dtype)
    return ArgInfo(size=cfg.size or 0, shape=shape,
                   is_seq=bool(cfg.attr("is_seq")))


@register_layer("data", infer=_data_infer)
def _data_forward(cfg, params, ins, ctx):  # never called; topology feeds it
    raise RuntimeError("data layer is fed, not computed")


# --- fc ------------------------------------------------------------------

def _fc_infer(cfg, in_infos):
    enforce(cfg.size is not None, f"fc layer {cfg.name} needs size")
    return ArgInfo(size=cfg.size,
                   is_seq=any(i.is_seq for i in in_infos),
                   is_nested=any(i.is_nested for i in in_infos))


def _fc_params(cfg, in_infos) -> Dict[str, ParamSpec]:
    specs = {}
    for i, info in enumerate(in_infos):
        specs[f"w{i}"] = ParamSpec(shape=(info.size, cfg.size),
                                   attr=cfg.param_attr(i), fan_in=info.size)
    battr = cfg.bias_param_attr()
    if battr is not None:
        specs["wbias"] = ParamSpec(shape=(cfg.size,), attr=battr,
                                   fan_in=cfg.size, is_bias=True)
    return specs


@register_layer("fc", infer=_fc_infer, params=_fc_params)
def _fc_forward(cfg, params, ins: List[Arg], ctx) -> Arg:
    out = None
    mask = None
    for i, a in enumerate(ins):
        enforce(a.value.dim() in (2, 3),
                f"fc layer {cfg.name}: the port takes [B, D] or [B, T, D] "
                f"inputs, got {tuple(a.value.shape)}")
        y = torch.matmul(a.value, params[f"w{i}"])
        out = y if out is None else out + y
        if a.mask is not None:
            mask = a.mask
    if "wbias" in params:
        out = out + params["wbias"]
    return Arg(out, mask)


# --- embedding (table projection) ---------------------------------------

def _embed_infer(cfg, in_infos):
    return ArgInfo(size=cfg.size, is_seq=in_infos[0].is_seq,
                   is_nested=in_infos[0].is_nested)


def _embed_params(cfg, in_infos):
    vocab = cfg.attr("vocab_size") or in_infos[0].size
    attr = cfg.param_attr(0)
    return {"w0": ParamSpec(shape=(vocab, cfg.size), attr=attr,
                            fan_in=cfg.size)}


@register_layer("embedding", infer=_embed_infer, params=_embed_params)
def _embed_forward(cfg, params, ins, ctx):
    ids = ins[0].value.long()
    table = params["w0"]
    out = table[ids.clamp(0, table.shape[0] - 1)]
    # ids < 0 are sparse-input padding: zero their rows
    out = torch.where((ids >= 0)[..., None], out, torch.zeros_like(out))
    return Arg(out, ins[0].mask)
