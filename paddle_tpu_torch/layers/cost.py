"""Classification cost (counterpart of the softmax cross-entropy part of
``paddle_tpu/layers/cost.py``; analog of paddle/gserver/layers/
CostLayer.cpp). The cost layer outputs per-sample cost [B, 1]; a sequence
cost sums over valid (mask=1) timesteps first.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg, ArgInfo
from paddle_tpu_torch.core.layer import register_layer


def _cost_infer(cfg, in_infos):
    return ArgInfo(size=1)


@register_layer("softmax_with_cross_entropy", infer=_cost_infer)
def _fused_xent_forward(cfg, params, ins, ctx):
    """-log_softmax(logits)[label], as lse - gathered logit, in f32 at
    least (softmax_with_cross_entropy_op analog)."""
    logits, label = ins[0], ins[1]
    ids = label.value.long()
    if ids.dim() == logits.value.dim():  # [B(,T),1] -> [B(,T)]
        ids = ids[..., 0]
    x = logits.value.to(torch.promote_types(logits.value.dtype,
                                            torch.float32))
    nll = torch.logsumexp(x, dim=-1) - torch.gather(x, -1,
                                                    ids[..., None])[..., 0]
    if logits.mask is not None:
        nll = (nll * logits.mask).sum(dim=-1)
    return Arg(nll[:, None])
