"""Normalisation layers: batch norm and the cross-map response norm
(counterpart of the ``batch_norm`` and ``norm`` layers of
``paddle_tpu/layers/norm.py``; analogs of paddle/gserver/layers/
{BatchNormalizationLayer,CudnnBatchNormLayer,NormLayer}.cpp).

Batch-norm's moving statistics are parameters (``wmean``, ``wvar``,
static: no gradient reaches them). A training forward writes their EMA
into the forward context's ``extras["batch_stats"]``;
``Topology.aux_updates`` names them and the train step writes them into
the returned parameters after the optimizer step, as the JAX package's
jitted step does. The layer does not use ``F.batch_norm``: its statistics
are single-pass (``E[x^2] - E[x]^2``, clamped at 0) and its running
variance unbiased, which give other numbers. ``data_norm`` and
``cross_channel_norm`` are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.attr import ParamAttr
from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.layer import ParamSpec, register_layer
from paddle_tpu_torch.layers.conv import (_square_side, as_nhwc,
                                          flat_from_nhwc)
from paddle_tpu_torch.utils.error import enforce


def _bn_params(cfg, in_infos):
    c = cfg.attr("num_channels")
    if c is None:
        info = in_infos[0]
        # image inputs (C, H, W known) normalise per channel, plain
        # feature vectors per feature
        c = info.shape[0] if (info.shape is not None
                              and len(info.shape) == 3) else info.size
    one = ParamAttr(initial_strategy="constant", initial_value=1.0)
    zero = ParamAttr(initial_strategy="zero")
    return {
        "w0": ParamSpec((c,), cfg.param_attr(0) if cfg.param_attrs else one,
                        fan_in=c),
        "wbias": ParamSpec((c,), cfg.bias_param_attr() or zero, fan_in=c,
                           is_bias=True),
        # the moving statistics: static, updated by the train step
        "wmean": ParamSpec((c,), ParamAttr(initial_strategy="zero",
                                           is_static=True), fan_in=c),
        "wvar": ParamSpec((c,), ParamAttr(initial_strategy="constant",
                                          initial_value=1.0, is_static=True),
                          fan_in=c),
    }


def _bn_infer(cfg, in_infos):
    return in_infos[0]


class _BatchStats(torch.autograd.Function):
    """Per-channel mean and single-pass variance of x over ``axes``, in
    float32 at least (float64 stays float64): mean = E[x], var =
    max(E[x^2] - mean^2, 0), the JAX layer's formula. The backward is
    that formula's gradient, d mean = 1/N, d var = 2(x - mean)/N where
    the clamp is open, computed elementwise from x without the float32
    copies of x that autograd would keep for it."""

    @staticmethod
    def forward(ctx, x, axes):
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xs.mean(dim=axes)
        var = torch.clamp((xs * xs).mean(dim=axes) - mean * mean, min=0.0)
        ctx.save_for_backward(x, mean, var)
        ctx.axes = axes
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x, mean, var = ctx.saved_tensors
        axes = ctx.axes
        n = 1
        for a in axes:
            n *= x.shape[a]
        shape = [1] * x.dim()
        ch = next(i for i in range(x.dim()) if i not in axes)
        shape[ch] = -1
        gm = (torch.zeros_like(mean) if g_mean is None else g_mean) / n
        gv = torch.zeros_like(var) if g_var is None else \
            torch.where(var > 0, g_var, 0.0)
        gv = 2.0 * gv / n
        xs = x.to(mean.dtype)
        dx = gm.reshape(shape) + gv.reshape(shape) * (xs - mean.reshape(shape))
        return dx.to(x.dtype), None


@register_layer("batch_norm", infer=_bn_infer, params=_bn_params)
def _batch_norm(cfg, params, ins, ctx):
    # the channel count comes from the parameter's shape, consistent with
    # _bn_params for 4-D, flat-image and vector inputs
    c = params["w0"].shape[0]
    eps = cfg.attr("epsilon", 1e-5)
    momentum = cfg.attr("moving_average_fraction", 0.9)
    v = ins[0].value
    orig_shape = v.shape
    img = v.dim() == 4 or (v.dim() == 2 and v.shape[-1] % c == 0
                           and v.shape[-1] != c)
    if v.dim() == 4:                              # [B, H, W, C] carried 4D
        x, axes = v, (0, 1, 2)
    elif img:
        x, axes = v.reshape(v.shape[0], c, -1), (0, 2)   # [B, C, HW]
    else:
        x, axes = v, tuple(range(v.dim() - 1))
    shape = [1] * x.dim()
    # the channel axis: 1 for the flat CHW view, last for NHWC and vectors
    shape[1 if (img and v.dim() != 4) else x.dim() - 1] = c
    if not ctx.training or cfg.attr("use_global_stats", False):
        mean, var = params["wmean"], params["wvar"]
    else:
        mask = ins[0].mask
        if mask is not None and not img and x.dim() == 3:
            # ragged [B, T, D] sequences: statistics weighted by the mask,
            # so that padding biases neither the normalisation nor the EMA
            xs = x.to(torch.promote_types(x.dtype, torch.float32))
            wgt = mask[..., None].to(torch.float32)
            denom = torch.clamp(wgt.sum(dim=(0, 1)), min=1.0)
            mean = (xs * wgt).sum(dim=(0, 1)) / denom
            var = (torch.square(xs - mean) * wgt).sum(dim=(0, 1)) / denom
        else:
            mean, var = _BatchStats.apply(x, axes)
        ctx.extras.setdefault("batch_stats", {})[cfg.name] = {
            "wmean": (momentum * params["wmean"]
                      + (1 - momentum) * mean).detach(),
            "wvar": (momentum * params["wvar"]
                     + (1 - momentum) * var).detach(),
        }
    mean_b, var_b = mean.reshape(shape), var.reshape(shape)
    g, b = params["w0"].reshape(shape), params["wbias"].reshape(shape)
    # scale and shift per channel in float32 (float64 stays so), applied
    # in the input's type: under bf16 mixed precision the [B, H, W, C]
    # elementwise work stays bf16
    inv = torch.rsqrt(var_b + eps) * g
    scale = inv.to(x.dtype)
    shift = (b - mean_b * inv).to(x.dtype)
    y = x * scale + shift
    return Arg(y.reshape(orig_shape), ins[0].mask, ins[0].seg_ids)


@register_layer("cudnn_batch_norm", infer=_bn_infer, params=_bn_params)
def _cudnn_batch_norm(cfg, params, ins, ctx):
    return _batch_norm(cfg, params, ins, ctx)


@register_layer("mkldnn_batch_norm", infer=_bn_infer, params=_bn_params)
def _mkldnn_batch_norm(cfg, params, ins, ctx):
    return _batch_norm(cfg, params, ins, ctx)


@register_layer("norm")
def _cmr_norm(cfg, params, ins, ctx):
    """NormLayer's cmrnorm-projection: local response norm across
    channel maps (paddle/function/CrossMapNormalOp). Outputs flat CHW, as
    the JAX layer does."""
    c = cfg.attr("num_channels")
    size = cfg.attr("norm_size", 5)
    scale = cfg.attr("scale", 0.0001)
    power = cfg.attr("power", 0.75)
    h = cfg.attr("img_size_y") or cfg.attr("img_size")
    w = cfg.attr("img_size") or h
    if ins[0].value.dim() == 4:                   # carried NHWC
        h, w, c = ins[0].value.shape[1:]
    elif h is None and c:
        h = w = _square_side(ins[0].value.shape[-1], c)
    enforce(c is not None and h is not None,
            f"cmrnorm layer {cfg.name}: specify num_channels/img_size")
    v = as_nhwc(ins[0].value, c, h, w)
    sq = torch.square(v)
    half = size // 2
    # the sum over a window of channels (the last axis)
    padded = F.pad(sq, (half, size - 1 - half))
    acc = sum(padded[..., i:i + c] for i in range(size))
    denom = torch.pow(1.0 + scale * acc, power)
    return Arg(flat_from_nhwc(v / denom))
