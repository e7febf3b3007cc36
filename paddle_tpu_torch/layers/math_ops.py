"""Element-wise layers (counterpart of ``paddle_tpu/layers/math_ops.py``;
analog of paddle/gserver/layers/ScalingLayer.cpp). The port has
``scaling``, which the attention of the NMT model uses.
"""

from __future__ import annotations

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.layer import register_layer


def _second_input_infer(cfg, in_infos):
    # input 0 is the (scalar) weight; the data tensor is input 1
    return in_infos[1]


@register_layer("scaling", infer=_second_input_infer)
def _scaling(cfg, params, ins, ctx):
    """Input 0: per-sample (or per-step) scalar weight [B(,T),1]; input 1:
    the vector [B(,T),D] it scales."""
    w, v = ins[0].value, ins[1].value
    return Arg(v * w, ins[1].mask, ins[1].seg_ids)
