"""Multi-head attention (counterpart of ``paddle_tpu/layers/attention.py``;
beyond the 2017 reference, which builds attention from mixed-layer
primitives only). The products and the softmax are plain PyTorch in full
float32, as the JAX package computes this layer outside any Pallas
kernel.

The JAX layer's ``seq_parallel='ring'|'ulysses'`` backends shard long
sequences over a mesh; without a mesh it takes the single-device path,
and the port, which has no mesh, always does. On packed rows
(docs/packing.md) a block-diagonal segment mask keeps every query inside
its own sequence: it composes with ``causal`` and takes the place of the
key-padding mask (padding carries seg -1, which no valid query matches).
Cross-attention works because the feeder's shared plan puts segment k of
a query row and of its key row on the same sample.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg, ArgInfo
from paddle_tpu_torch.core.layer import ParamSpec, register_layer
from paddle_tpu_torch.parallel.ring_attention import reference_attention
from paddle_tpu_torch.utils.error import enforce


def _mha_infer(cfg, in_infos):
    return ArgInfo(size=cfg.size or in_infos[0].size, is_seq=True)


def _mha_params(cfg, in_infos):
    d_model = cfg.size or in_infos[0].size
    d_in = in_infos[0].size
    d_kv = in_infos[1].size if len(in_infos) > 1 else d_in
    specs = {
        "wq": ParamSpec((d_in, d_model), cfg.param_attr(0), fan_in=d_in),
        "wk": ParamSpec((d_kv, d_model), cfg.param_attr(0), fan_in=d_kv),
        "wv": ParamSpec((d_kv, d_model), cfg.param_attr(0), fan_in=d_kv),
        "wo": ParamSpec((d_model, d_model), cfg.param_attr(0),
                        fan_in=d_model),
    }
    battr = cfg.bias_param_attr()
    if battr is not None:
        specs["wbias"] = ParamSpec((d_model,), battr, fan_in=d_model,
                                   is_bias=True)
    return specs


@register_layer("multi_head_attention", infer=_mha_infer, params=_mha_params)
def _mha_forward(cfg, params, ins, ctx):
    """Input 0: query seq [B, T, Dq]; optional input 1: key/value seq.
    num_heads required; causal for decoder self-attention."""
    q_in = ins[0]
    kv_in = ins[1] if len(ins) > 1 else ins[0]
    H = cfg.attr("num_heads")
    causal = cfg.attr("causal", False)
    d_model = params["wq"].shape[1]
    enforce(d_model % H == 0, "d_model must divide num_heads")
    packed = getattr(ctx, "packed", False)
    if packed:
        enforce(q_in.seg_ids is not None and kv_in.seg_ids is not None,
                f"multi_head_attention {cfg.name}: packed feeds need "
                "seg_ids on both the query and key/value sequences")
    Dh = d_model // H
    B, T = q_in.value.shape[:2]

    q = torch.matmul(q_in.value, params["wq"]).reshape(B, T, H, Dh)
    Tk = kv_in.value.shape[1]
    k = torch.matmul(kv_in.value, params["wk"]).reshape(B, Tk, H, Dh)
    v = torch.matmul(kv_in.value, params["wv"]).reshape(B, Tk, H, Dh)

    if packed:
        # the block-diagonal segment mask, composed with causal
        o = reference_attention(q, k, v, causal=causal, seg_q=q_in.seg_ids,
                                seg_kv=kv_in.seg_ids)
    elif kv_in.mask is not None:
        # mask padding keys by an additive bias (a row with no valid key
        # gets a uniform softmax, as in JAX); scores accumulate at float32
        # or wider, so a float64 input stays float64
        mask = kv_in.mask.to(k.dtype)
        k = k * mask[..., None, None]
        big_neg_bias = (1.0 - mask)[:, None, None, :] * -1e30
        acc = torch.promote_types(q.dtype, torch.float32)
        s = torch.einsum("bqhd,bkhd->bqhk", q.to(acc), k.to(acc)) \
            * (Dh ** -0.5)
        s = s + big_neg_bias.transpose(1, 2)
        if causal:
            keep = (torch.arange(T, device=s.device)[:, None]
                    >= torch.arange(Tk, device=s.device)[None, :])
            s = torch.where(keep[None, :, None, :], s, s.new_tensor(-1e30))
        a = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bqhk,bkhd->bqhd", a, v)
    else:
        o = reference_attention(q, k, v, causal=causal)

    out = torch.matmul(o.reshape(B, T, d_model), params["wo"])
    if "wbias" in params:
        out = out + params["wbias"]
    if q_in.mask is not None:
        out = out * q_in.mask[..., None].to(out.dtype)
    return Arg(out, q_in.mask, q_in.seg_ids)
