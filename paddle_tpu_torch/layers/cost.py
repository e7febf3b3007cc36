"""Costs (counterpart of the cross-entropy and square-error part of
``paddle_tpu/layers/cost.py``; analog of paddle/gserver/layers/
CostLayer.cpp): the fused softmax cross-entropy over logits, the
probability-form ``multi-class-cross-entropy`` that follows a softmax
output, and ``square_error``. A cost layer outputs per-sample cost [B, 1]; a sequence cost sums
over valid (mask=1) timesteps first, and the result is scaled by the
layer's ``coeff``. Training differentiates these forwards with autograd.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg, ArgInfo, packed_segment_count
from paddle_tpu_torch.core.layer import register_layer
from paddle_tpu_torch.layers.conv import image_flat


def _cost_infer(cfg, in_infos):
    return ArgInfo(size=1)


def register_cost(name):
    """``register_layer`` for a cost layer: flattens carried NHWC image
    inputs back to CHW order (cost layers take flat matrices, reference
    CostLayer) and multiplies the [B, 1] cost by the layer's ``coeff``
    attribute (reference CostLayer coeff_ scaling), so that a weighted
    multi-cost objective matches the JAX package's ``register_cost``
    (``paddle_tpu/layers/cost.py``).

    Packed rows (docs/packing.md): a masked sum over steps adds up per
    segment, so a packed row's cost is the sum of its sequences' costs and
    the values need no change. The sample count does: on a packed forward
    the wrapper publishes the batch's sequence count as
    ``ctx.extras['<name>#n_seq']``, which ``Topology.loss_fn`` divides by
    instead of the rows."""
    def deco(fn):
        def wrapped(cfg, params, ins, ctx):
            ins = [a.with_value(image_flat(a.value))
                   if a.value.dim() == 4 else a for a in ins]
            out = fn(cfg, params, ins, ctx)
            coeff = cfg.attr("coeff", 1.0)
            if coeff != 1.0:
                out = out.with_value(out.value * coeff)
            if getattr(ctx, "packed", False):
                seg = next((a.seg_ids for a in ins
                            if a.seg_ids is not None), None)
                if seg is not None:
                    ctx.extras[f"{cfg.name}#n_seq"] = \
                        packed_segment_count(seg)
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


@register_cost("square_error")
def _mse_forward(cfg, params, ins, ctx):
    """0.5 * sum((input - label)^2) over the last dim (SumOfSquaresCost)."""
    d = ins[0].value - ins[1].value
    cost = 0.5 * torch.square(d).sum(dim=-1)
    return Arg(_reduce_seq(cost, ins[0].mask)[:, None])
