"""Element-wise layers (counterpart of ``paddle_tpu/layers/math_ops.py``;
analogs of paddle/gserver/layers/{ScalingLayer,ResizeLayer}.cpp). The
port has ``scaling``, which the attention of the NMT model uses, and
``resize``, which the CTR model's wide and deep parts use.
"""

from __future__ import annotations

from paddle_tpu_torch.core.arg import Arg, ArgInfo
from paddle_tpu_torch.core.layer import register_layer
from paddle_tpu_torch.utils.error import enforce


def _second_input_infer(cfg, in_infos):
    # input 0 is the (scalar) weight; the data tensor is input 1
    return in_infos[1]


@register_layer("scaling", infer=_second_input_infer)
def _scaling(cfg, params, ins, ctx):
    """Input 0: per-sample (or per-step) scalar weight [B(,T),1]; input 1:
    the vector [B(,T),D] it scales."""
    w, v = ins[0].value, ins[1].value
    return Arg(v * w, ins[1].mask, ins[1].seg_ids)


def _resize_infer(cfg, in_infos):
    return ArgInfo(size=cfg.size)


@register_layer("resize", infer=_resize_infer)
def _resize(cfg, params, ins, ctx):
    """ResizeLayer: reinterpret [B, D] as [B*D/size, size]; a [B, T, D]
    input is flattened to [B, T*D] first (JAX ``image_flat``; its 4-D NHWC
    images come with the image slice)."""
    v = ins[0].value
    enforce(v.dim() <= 3, f"resize layer {cfg.name}: the port takes [B, D] "
            f"or [B, T, D] inputs, got {tuple(v.shape)}")
    if v.dim() == 3:
        v = v.reshape(v.shape[0], -1)
    return Arg(v.reshape(-1, cfg.size))
