"""Classification costs (counterpart of the cross-entropy part of
``paddle_tpu/layers/cost.py``; analog of paddle/gserver/layers/
CostLayer.cpp): the fused softmax cross-entropy over logits, and the
probability-form ``multi-class-cross-entropy`` that follows a softmax
output. A cost layer outputs per-sample cost [B, 1]; a sequence cost sums
over valid (mask=1) timesteps first, and the result is scaled by the
layer's ``coeff``. Training differentiates these forwards with autograd.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg, ArgInfo
from paddle_tpu_torch.core.layer import register_layer


def _cost_infer(cfg, in_infos):
    return ArgInfo(size=1)


def register_cost(name):
    """``register_layer`` for a cost layer: multiplies the [B, 1] cost by
    the layer's ``coeff`` attribute (reference CostLayer coeff_ scaling),
    so that a weighted multi-cost objective matches the JAX package's
    ``register_cost`` (``paddle_tpu/layers/cost.py``). Two of its steps
    are left out, since the port has neither conv nor packed feeds yet:
    the flattening of 4-D NHWC inputs at the cost boundary, and the
    packed-sequence count ``<name>#n_seq`` published for the loss."""
    def deco(fn):
        def wrapped(cfg, params, ins, ctx):
            out = fn(cfg, params, ins, ctx)
            coeff = cfg.attr("coeff", 1.0)
            if coeff != 1.0:
                out = out.with_value(out.value * coeff)
            return out
        wrapped.__name__ = fn.__name__
        register_layer(name, infer=_cost_infer)(wrapped)
        return wrapped
    return deco


def _f32up(x):
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _label_ids(label, like):
    ids = label.value.long()
    if ids.dim() == like.value.dim():  # [B(,T),1] -> [B(,T)]
        ids = ids[..., 0]
    return ids


def _reduce_seq(cost, mask):
    """[B, T] per-step costs -> [B] via masked sum."""
    if mask is not None:
        return (cost * mask).sum(dim=-1)
    return cost


def _stable_nll(logits, ids):
    """-log_softmax(logits)[label], as lse - gathered logit, in f32 at
    least."""
    x = _f32up(logits)
    return torch.logsumexp(x, dim=-1) - torch.gather(x, -1,
                                                     ids[..., None])[..., 0]


@register_cost("multi-class-cross-entropy")
def _xent_forward(cfg, params, ins, ctx):
    """Input 0: a probability distribution (post-softmax); input 1: int
    labels. When the producing layer stashed its pre-softmax logits
    (core/layer.py Layer.forward), the stable log-softmax form is taken
    from them; otherwise the gathered probability is clipped to
    [1e-10, 1] before the log (reference CostLayer.cpp
    oneHotCrossEntropy)."""
    probs, label = ins[0], ins[1]
    ids = _label_ids(label, probs)
    logits = ctx.extras.get(f"{cfg.inputs[0].name}#logits")
    if logits is not None and logits.value.shape == probs.value.shape:
        cost = _reduce_seq(_stable_nll(logits.value, ids), probs.mask)
        return Arg(cost[:, None])
    p_lab = torch.gather(probs.value, -1, ids[..., None])[..., 0]
    nll = -torch.log(torch.clamp(_f32up(p_lab), 1e-10, 1.0))
    return Arg(_reduce_seq(nll, probs.mask)[:, None])


@register_cost("softmax_with_cross_entropy")
def _fused_xent_forward(cfg, params, ins, ctx):
    """-log_softmax(logits)[label] (softmax_with_cross_entropy_op
    analog)."""
    logits, label = ins[0], ins[1]
    ids = _label_ids(label, logits)
    return Arg(_reduce_seq(_stable_nll(logits.value, ids),
                           logits.mask)[:, None])
