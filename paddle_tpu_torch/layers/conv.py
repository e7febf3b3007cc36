"""Convolution and pooling layers (counterpart of the 2-D part of
``paddle_tpu/layers/conv.py``; analogs of paddle/gserver/layers/
{ExpandConvLayer,CudnnConvLayer,PoolLayer}.cpp).

Layout, as in the JAX package: the API boundary stays logical NCHW, so
flat values are [B, C*H*W] in CHW order and weights are stored OIHW
(torch's ``conv2d`` layout too, so checkpoints carry across as they are).
Between image layers values are carried 4-D NHWC ([B, H, W, C]).
``as_nhwc`` / ``as_nchw`` / ``flat_from_nhwc`` / ``image_flat`` convert at
the boundaries; flattening always restores CHW order first. A layer hands
``F.conv2d`` the ``permute(0, 3, 1, 2)`` view of its NHWC value, which is
channels_last NCHW with no copy, and permutes the result back.

The convolutions are cuDNN's (``F.conv2d`` / ``F.conv_transpose2d``): the
JAX package computes them outside Pallas (``lax.conv_general_dilated``).
Its space-to-depth stem convolution is a TPU layout trick with the same
math; the port computes the plain convolution. The pools' forwards are
``F.max_pool2d`` / ``F.avg_pool2d`` (JAX: ``lax.reduce_window``).

The max pool's backward follows the module switch ``MAXPOOL_BWD``, with
the JAX package's meaning:

- ``"sas"`` (default): torch's max-pool backward, which gives a window's
  gradient to its first maximum in window order, as XLA's
  select-and-scatter does;
- ``"eq"``: every tied maximum of a window gets the window's gradient
  (JAX's ``_maxpool_eq``). At the ResNet stem's geometry (3 x 3, stride
  2, pad 1, floor mode, even H and W) it is ``kernels/pool.
  maxpool_3x3s2p1``, whose backward is the ``maxpool_bwd`` kernel on the
  card (its bf16 form ``maxpool_bwd_bf16`` on bf16) and its plain version
  on the CPU (a tensor off the CPU that the kernels cannot take, such as
  float64, raises; a float64 CPU tensor keeps its precision in
  ``_MaxPoolEq``); at any other geometry a plain PyTorch Function
  (``_MaxPoolEq``).

The layer chooses from its config and the input's shape alone.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.arg import Arg, ArgInfo
from paddle_tpu_torch.core.layer import ParamSpec, register_layer
from paddle_tpu_torch.kernels.pool import (maxpool_3x3s2p1,
                                           maxpool_3x3s2p1_supported)
from paddle_tpu_torch.utils.error import enforce


def as_nhwc(v, c, h, w):
    """Carried-4D or flat-CHW image value -> [B, h, w, c]. A flat value
    is copied into NHWC memory once, so that the layers after it run
    channels_last."""
    if v.dim() == 4:
        return v
    return v.reshape(-1, c, h, w).permute(0, 2, 3, 1).contiguous()


def as_nchw(v, c, h, w):
    """Carried-4D (NHWC) or flat-CHW image value -> [B, c, h, w]."""
    if v.dim() == 4:
        return v.permute(0, 3, 1, 2)
    return v.reshape(-1, c, h, w)


def flat_from_nhwc(v4):
    """[B, h, w, c] -> flat [B, c*h*w] in the reference's CHW order."""
    return v4.permute(0, 3, 1, 2).reshape(v4.shape[0], -1)


def image_flat(v):
    """Flatten any layer value to [B, features], restoring CHW order for
    carried NHWC images (the fc / cost / user-output boundary)."""
    if v.dim() == 4:
        return flat_from_nhwc(v)
    return v.reshape(v.shape[0], -1) if v.dim() > 2 else v


def _out_dim(in_dim, k, pad, stride, caffe_mode=True):
    """Reference output-size formula (config_parser.py cnn_output_size)."""
    if caffe_mode:
        return (in_dim + 2 * pad - k) // stride + 1
    return int(math.ceil((in_dim + 2 * pad - k) / stride)) + 1


def _square_side(size, channels):
    """Square-image side from flat size / channels (the reference
    config_parser ImageInput fallback), or None if size isn't square."""
    side = int(math.isqrt(size // channels))
    return side if side * side * channels == size else None


def _conv_geometry(cfg, in_info):
    c = cfg.attr("num_channels")
    h = cfg.attr("img_size_y") or cfg.attr("img_size")
    w = cfg.attr("img_size") or h
    if h is None and in_info.shape is not None:
        c, h, w = in_info.shape
    if h is None and c:
        h = w = _square_side(in_info.size, c)
    enforce(h is not None,
            f"conv layer {cfg.name}: specify img_size/num_channels")
    return c, h, w


def _conv_window(cfg):
    """(ky, kx, sy, sx, py, px) of a conv layer's config."""
    ky = cfg.attr("filter_size_y") or cfg.attr("filter_size")
    kx = cfg.attr("filter_size")
    sy = cfg.attr("stride_y") or cfg.attr("stride", 1)
    sx = cfg.attr("stride", 1)
    py = cfg.attr("padding_y") if cfg.attr("padding_y") is not None \
        else cfg.attr("padding", 0)
    px = cfg.attr("padding", 0)
    return ky, kx, sy, sx, py, px


def _conv_infer(cfg, in_infos):
    c, h, w = _conv_geometry(cfg, in_infos[0])
    # the resolved geometry is written back into the config, so that the
    # forward (which has no ArgInfo) reads input-inferred shapes, as the
    # reference config parser's size propagation does
    cfg.cfg["num_channels"], cfg.cfg["img_size_y"], cfg.cfg["img_size"] = \
        c, h, w
    ky, kx, sy, sx, py, px = _conv_window(cfg)
    nf = cfg.attr("num_filters")
    if cfg.attr("transposed"):
        oh = (h - 1) * sy + ky - 2 * py
        ow = (w - 1) * sx + kx - 2 * px
    else:
        oh = _out_dim(h, ky, py, sy)
        ow = _out_dim(w, kx, px, sx)
    return ArgInfo(size=nf * oh * ow, shape=(nf, oh, ow))


def _conv_params(cfg, in_infos):
    c, h, w = _conv_geometry(cfg, in_infos[0])
    ky = cfg.attr("filter_size_y") or cfg.attr("filter_size")
    kx = cfg.attr("filter_size")
    nf = cfg.attr("num_filters")
    groups = cfg.attr("groups", 1)
    fan_in = c * kx * ky // groups
    # filter layout OIHW (out, in/groups, H, W)
    specs = {"w0": ParamSpec((nf, c // groups, ky, kx), cfg.param_attr(0),
                             fan_in=fan_in)}
    battr = cfg.bias_param_attr()
    if battr is not None:
        shared = cfg.attr("shared_biases", True)
        n = nf if shared else _conv_infer(cfg, in_infos).size
        specs["wbias"] = ParamSpec((n,), battr, fan_in=nf, is_bias=True)
    return specs


def _run_conv(cfg, params, ins, transposed: bool):
    c = cfg.attr("num_channels")
    h = cfg.attr("img_size_y") or cfg.attr("img_size")
    w = cfg.attr("img_size") or h
    # the channels_last NCHW view of the NHWC value
    x = as_nhwc(ins[0].value, c, h, w).permute(0, 3, 1, 2)
    ky, kx, sy, sx, py, px = _conv_window(cfg)
    groups = cfg.attr("groups", 1)
    wgt = params["w0"]                       # stored OIHW
    if transposed:
        enforce(groups == 1, f"conv layer {cfg.name}: a transposed "
                "convolution with groups is not supported (nor in the JAX "
                "package)")
        # JAX correlates the stride-dilated input, padded k-1-p a side,
        # with the stored kernel as it is (lax.conv_transpose without
        # transpose_kernel): torch's conv_transpose2d flips the kernel and
        # reads it [in, out, kh, kw], so it gets the flipped, swapped one.
        # Its padding p gives out = (in - 1) * s + k - 2p, the reference
        # deconv geometry
        out = F.conv_transpose2d(x, wgt.flip(2, 3).transpose(0, 1),
                                 stride=(sy, sx), padding=(py, px))
    else:
        out = F.conv2d(x, wgt, stride=(sy, sx), padding=(py, px),
                       groups=groups)
    return Arg(_conv_bias(params, out.permute(0, 2, 3, 1)))


def _conv_bias(params, out):
    """out [B, OH, OW, NF] plus the layer's bias: shared (one a channel)
    or per position, stored flat in CHW order."""
    if "wbias" not in params:
        return out
    b = params["wbias"]
    if b.shape[0] == out.shape[3]:           # shared per-channel bias
        return out + b
    return out + b.reshape(1, out.shape[3], out.shape[1],
                           out.shape[2]).permute(0, 2, 3, 1)


@register_layer("exconv", infer=_conv_infer, params=_conv_params)
def _exconv(cfg, params, ins, ctx):
    return _run_conv(cfg, params, ins, transposed=False)


@register_layer("cudnn_conv", infer=_conv_infer, params=_conv_params)
def _cudnn_conv(cfg, params, ins, ctx):
    return _run_conv(cfg, params, ins, transposed=False)


@register_layer("mkldnn_conv", infer=_conv_infer, params=_conv_params)
def _mkldnn_conv(cfg, params, ins, ctx):
    return _run_conv(cfg, params, ins, transposed=False)


@register_layer("exconvt", infer=_conv_infer, params=_conv_params)
def _exconvt(cfg, params, ins, ctx):
    return _run_conv(cfg, params, ins, transposed=True)


@register_layer("cudnn_convt", infer=_conv_infer, params=_conv_params)
def _cudnn_convt(cfg, params, ins, ctx):
    return _run_conv(cfg, params, ins, transposed=True)


# --- pooling --------------------------------------------------------------

# the max pool's backward: "sas" = the first maximum of a window takes its
# gradient (torch's max-pool backward; XLA's select-and-scatter in the JAX
# package); "eq" = every tied maximum does (the reference's
# hl_maxpool_backward; the maxpool_bwd kernel at the stem's geometry).
# Post-ReLU maps tie at 0.0, so the two train differently on real data.
MAXPOOL_BWD = "sas"


class _MaxPoolEq(torch.autograd.Function):
    """Max pool of the -inf-padded NHWC ``xp`` (windows ``k``, strides
    ``s``) whose backward gives a window's gradient to every position
    equal to its max: JAX's ``_maxpool_eq_bwd`` in PyTorch, the compare
    in the input's type, the sums in float32, the gradient cast back (the
    padding's share is dropped by the pad's own backward)."""

    @staticmethod
    def forward(ctx, xp, k, s):
        y = F.max_pool2d(xp.permute(0, 3, 1, 2), kernel_size=k,
                         stride=s).permute(0, 2, 3, 1)
        ctx.save_for_backward(xp, y)
        ctx.window = (k, s)
        return y

    @staticmethod
    def backward(ctx, g):
        xp, y = ctx.saved_tensors
        (ky, kx), (sy, sx) = ctx.window
        OH, OW = y.shape[1], y.shape[2]
        grad = torch.zeros(xp.shape, dtype=torch.float32, device=xp.device)
        gf = g.float()
        for i in range(ky):
            for j in range(kx):
                rows = slice(i, i + sy * (OH - 1) + 1, sy)
                cols = slice(j, j + sx * (OW - 1) + 1, sx)
                hit = xp[:, rows, cols] == y
                grad[:, rows, cols] += torch.where(hit, gf, 0.0)
        return grad.to(xp.dtype), None, None


def _maxpool_stem_eq(v):
    """The stem geometry's max pool under ``"eq"``: ``kernels/pool.
    maxpool_3x3s2p1`` in x's dtype, whose backward is the ``maxpool_bwd``
    kernel on a float32 CUDA tensor and its bf16 form ``maxpool_bwd_bf16``
    on a bf16 one (each raises where it cannot run), its plain version on
    the CPU. A bf16 x stays bf16, saved so for the backward: the forward
    gives the bf16 max and dx is the float32 sum of <= 4 window gradients
    rounded once to bf16, as JAX's ``_maxpool_eq_bwd`` rounds it. Another
    dtype (float64 on the CPU) goes as it is; the card takes float32 and
    bf16."""
    return maxpool_3x3s2p1(v.contiguous())


def _pool_geometry(cfg):
    c = cfg.attr("num_channels")
    h = cfg.attr("img_size_y") or cfg.attr("img_size")
    w = cfg.attr("img_size") or h
    k = cfg.attr("pool_size")
    ky = cfg.attr("pool_size_y") or k
    s = cfg.attr("stride", 1)
    sy = cfg.attr("stride_y") or s
    p = cfg.attr("padding", 0)
    py = cfg.attr("padding_y") if cfg.attr("padding_y") is not None else p
    return c, h, w, ky, k, sy, s, py, p


def _pool_infer(cfg, in_infos):
    c = cfg.attr("num_channels")
    h = cfg.attr("img_size_y") or cfg.attr("img_size")
    w = cfg.attr("img_size") or h
    if (c is None or h is None) and in_infos[0].shape is not None:
        c, h, w = in_infos[0].shape
    if h is None and c:
        h = w = _square_side(in_infos[0].size, c)
    enforce(c is not None and h is not None,
            f"pool layer {cfg.name}: specify num_channels/img_size")
    cfg.cfg["num_channels"], cfg.cfg["img_size_y"], cfg.cfg["img_size"] = \
        c, h, w
    _c, _h, _w, ky, k, sy, s, py, p = _pool_geometry(cfg)
    # ceil_mode=True (the reference img_pool default) takes the ceil
    # formula, ceil_mode=False the floor one
    ceil = cfg.attr("ceil_mode", True)
    oh = _out_dim(h, ky, py, sy, caffe_mode=not ceil)
    ow = _out_dim(w, k, p, s, caffe_mode=not ceil)
    return ArgInfo(size=c * oh * ow, shape=(c, oh, ow))


@register_layer("pool", infer=_pool_infer)
def _pool(cfg, params, ins, ctx):
    c, h, w, ky, k, sy, s, py, p = _pool_geometry(cfg)
    ptype = cfg.attr("pool_type", "max")
    ceil = cfg.attr("ceil_mode", True)
    v = as_nhwc(ins[0].value, c, h, w)
    # ceil-mode output: the high side takes extra padding, so that the
    # windows of the ceil formula exist (torch's own ceil_mode drops a
    # last window that starts in the padding; Paddle's formula keeps it).
    # In floor mode extra_h and extra_w are 0 by construction
    oh = _out_dim(h, ky, py, sy, caffe_mode=not ceil)
    ow = _out_dim(w, k, p, s, caffe_mode=not ceil)
    extra_h = max((oh - 1) * sy + ky - h - 2 * py, 0)
    extra_w = max((ow - 1) * s + k - w - 2 * p, 0)
    pads = (0, 0, p, p + extra_w, py, py + extra_h)     # F.pad, NHWC
    if "max" in ptype:
        if MAXPOOL_BWD == "eq":
            if (ky, k, sy, s, py, p, extra_h, extra_w) == \
                    (3, 3, 2, 2, 1, 1, 0, 0) and h % 2 == 0 and w % 2 == 0:
                # the kernel's geometry: off the CPU the kernel runs or
                # this raises; on the CPU a float64 model keeps its
                # precision in the plain Function below
                fits = (v.element_size() <= 4
                        and maxpool_3x3s2p1_supported(tuple(v.shape)))
                if v.device.type != "cpu":
                    enforce(fits and v.dtype in (torch.float32,
                                                 torch.bfloat16),
                            f"pool layer {cfg.name}: the maxpool_bwd kernel "
                            f"takes float32 or bf16 and fewer than 2**31 2 x "
                            f"2 blocks, got {v.dtype} {list(v.shape)}")
                    return Arg(_maxpool_stem_eq(v))
                if fits:
                    return Arg(_maxpool_stem_eq(v))
            xp = F.pad(v, pads, value=-math.inf)
            return Arg(_MaxPoolEq.apply(xp, (ky, k), (sy, s)))
        x = v.permute(0, 3, 1, 2)
        if extra_h == extra_w == 0 and 2 * py <= ky and 2 * p <= k:
            # torch's own padding (at most half a window) is the -inf pad
            y = F.max_pool2d(x, (ky, k), (sy, s), (py, p))
        else:
            y = F.max_pool2d(F.pad(x, pads[2:], value=-math.inf), (ky, k),
                             (sy, s))
        return Arg(y.permute(0, 2, 3, 1))
    # the window sums over the zero-padded input
    x = F.pad(v, pads).permute(0, 3, 1, 2)
    ssum = F.avg_pool2d(x, (ky, k), (sy, s), divisor_override=1)
    if cfg.attr("exclude_mode", True) and (p or py or extra_h or extra_w):
        # divide by the clipped window size (reference
        # CpuMatrix::avgPoolForward), ceil-mode overhang windows included;
        # the count depends on the position alone
        ones = F.pad(v.new_ones(1, h, w, 1), pads).permute(0, 3, 1, 2)
        cnt = F.avg_pool2d(ones, (ky, k), (sy, s), divisor_override=1)
        out = ssum / torch.clamp(cnt, min=1.0)
    else:
        out = ssum / float(ky * k)
    return Arg(out.permute(0, 2, 3, 1))


@register_layer("mkldnn_pool", infer=_pool_infer)
def _mkldnn_pool(cfg, params, ins, ctx):
    return _pool(cfg, params, ins, ctx)
