"""LSTM and GRU layers (counterpart of the ``lstmemory``,
``gated_recurrent`` and ``gru_step`` parts of
``paddle_tpu/layers/recurrent.py``; analogs of
paddle/gserver/layers/{LstmLayer,GruLayer,GruStepLayer}.cpp and
hl_gpu_lstm.cuh / hl_gpu_gru.cuh).

The time-varying input projection is pre-computed by the layer below (an
fc producing 4*size for the LSTM, 3*size for the GRU), so the recurrence
holds only the recurrent products. LSTM gate order [i, f, c, o], its bias
holds the gate biases and the three peephole vectors, 7*size in all. GRU
gate order [z (update), r (reset), c (candidate)], bias 3*size.

Paths of the full-sequence layers, chosen from the config and the shape
alone:
- default activations: ``kernels.lstm.fused_lstm`` /
  ``kernels.gru.fused_gru``, which launch the Hopper kernel for CUDA
  tensors whose shape it takes (``fused_*_supported``; when training,
  ``fused_lstm_bwd_supported`` / ``fused_gru_bwd_supported`` too: the
  gradient runs the backward kernels) and run their plain version on the
  CPU;
- anything else: a time loop over ``lstm_cell`` / ``gru_cell``, as the
  JAX layer's ``lax.scan`` path.

On a packed feed (docs/packing.md) both paths zero the carry where a
packed segment starts: the kernels take the reset vector beside the mask,
the loops apply it before the step. A reverse layer runs forward over
flipped inputs, so its reset marks each segment's last step and is
flipped with them.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch import activation as act_mod
from paddle_tpu_torch.core.arg import Arg, ArgInfo, segment_start_resets
from paddle_tpu_torch.core.layer import ParamSpec, register_layer
from paddle_tpu_torch.layers.basic import matmul
from paddle_tpu_torch.kernels.gru import (fused_gru, fused_gru_bwd_supported,
                                          fused_gru_supported)
from paddle_tpu_torch.kernels.lstm import (fused_lstm, fused_lstm_bwd_supported,
                                           fused_lstm_supported)
from paddle_tpu_torch.utils.error import enforce


def _packed_resets(a, ctx, reverse):
    """The [B, T] segment-start reset vector of a packed input, in the
    mask's dtype, else None. Packed rows hold several sequences back to
    back; the carry entering each segment's first step (its last under
    ``reverse``, where a reverse recurrence's carry enters) is zeroed.
    Unpacked and nested inputs give None.

    A sequence input of a packed feed must still carry seg_ids: a
    time-preserving layer that dropped them would otherwise leak state
    across the packed boundaries without a word, so it raises."""
    if not getattr(ctx, "packed", False) or a.mask is None:
        return None
    enforce(a.seg_ids is not None,
            "recurrent layer over a packed feed lost its seg_ids "
            "(an upstream layer dropped them); packed rows without "
            "segment resets would leak state across sequence "
            "boundaries — feed this model unpacked or keep seg_ids "
            "propagating through every time-preserving layer")
    return segment_start_resets(a.seg_ids, a.mask, reverse=reverse)


def _lstm_infer(cfg, in_infos):
    enforce(in_infos[0].size % 4 == 0,
            "lstmemory input must be 4*size (pre-projected)")
    return ArgInfo(size=in_infos[0].size // 4, is_seq=True)


def _lstm_params(cfg, in_infos):
    n = in_infos[0].size // 4
    specs = {"w0": ParamSpec((n, 4 * n), cfg.param_attr(0), fan_in=n)}
    battr = cfg.bias_param_attr()
    if battr is not None:
        # gate biases + 3 peephole vectors, the reference LstmLayer packing
        specs["wbias"] = ParamSpec((7 * n,), battr, fan_in=n, is_bias=True)
    return specs


def lstm_cell(x4, h_prev, c_prev, W, bias, out_act, state_act, n,
              gate_act=None):
    """One LSTM step; x4 [B, 4n] pre-projected input. gate_act defaults to
    sigmoid (reference LstmLayer active_gate_type)."""
    gate = gate_act.apply if gate_act is not None else torch.sigmoid
    pre = x4 + torch.matmul(h_prev, W)
    if bias is not None:
        pre = pre + bias[:4 * n]
    i_, f_, c_, o_ = torch.split(pre, n, dim=-1)
    if bias is not None:
        pi, pf, po = bias[4 * n:5 * n], bias[5 * n:6 * n], bias[6 * n:7 * n]
        i_ = i_ + pi * c_prev
        f_ = f_ + pf * c_prev
    i = gate(i_)
    f = gate(f_)
    c_new = f * c_prev + i * state_act.apply(c_)
    if bias is not None:
        o_ = o_ + po * c_new
    o = gate(o_)
    h_new = o * out_act.apply(c_new)
    return h_new, c_new


def _default_lstm_acts(cfg):
    return (cfg.attr("active_type", "tanh") == "tanh"
            and cfg.attr("active_state_type", "tanh") == "tanh"
            and cfg.attr("active_gate_type", "sigmoid") == "sigmoid")


def _lstm_loop(x4, mask, W, bias, out_act, state_act, gate_act,
               reset=None):
    """Masked recurrence over lstm_cell with any activations; ``reset``
    [B, T] zeroes the carry entering a step (packed segment starts)."""
    B, T, H4 = x4.shape
    n = H4 // 4
    h = x4.new_zeros(B, n)
    c = x4.new_zeros(B, n)
    hs, cs = [], []
    for t in range(T):
        if reset is not None:
            keep = 1 - reset[:, t, None]
            h, c = keep * h, keep * c
        h_new, c_new = lstm_cell(x4[:, t], h, c, W, bias, out_act,
                                 state_act, n, gate_act)
        m = mask[:, t, None]
        h = m * h_new + (1 - m) * h
        c = m * c_new + (1 - m) * c
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1)


@register_layer("lstmemory", infer=_lstm_infer, params=_lstm_params)
def _lstmemory(cfg, params, ins, ctx):
    a = ins[0]
    x4 = a.value
    B, T, H4 = x4.shape
    n = H4 // 4
    W = params["w0"]
    bias = params.get("wbias")
    mask = a.mask.to(x4.dtype) if a.mask is not None else \
        x4.new_ones(B, T)
    reverse = cfg.attr("reverse", False)
    reset = _packed_resets(a, ctx, reverse)
    if reset is not None:
        reset = reset.to(mask.dtype)
    if reverse:
        # the recurrence always runs forward, over flipped inputs; the
        # segment ends of a reverse layer's reset flip into starts
        x4 = torch.flip(x4, dims=[1])
        mask = torch.flip(mask, dims=[1])
        if reset is not None:
            reset = torch.flip(reset, dims=[1])
    # the support predicates for the values' dtype (bf16 under mixed
    # precision takes the kernels' bf16 forms, which take the mask as
    # float32 and convert it); training takes the kernels' gradient too:
    # the backward kernel must take the shape as well
    training = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x4, W, bias))
    fused = _default_lstm_acts(cfg) and (
        x4.device.type == "cpu" or (
            fused_lstm_supported(B, n, x4.dtype)
            and (not training or fused_lstm_bwd_supported(B, n, x4.dtype))))
    if fused:
        b7 = bias if bias is not None else x4.new_zeros(7 * n)
        hs, cs = fused_lstm(x4.contiguous(), W.contiguous(),
                            b7.contiguous(), mask.contiguous(),
                            None if reset is None else reset.contiguous())
    else:
        hs, cs = _lstm_loop(
            x4, mask, W, bias,
            act_mod.resolve(cfg.attr("active_type", "tanh")),
            act_mod.resolve(cfg.attr("active_state_type", "tanh")),
            act_mod.resolve(cfg.attr("active_gate_type", "sigmoid")), reset)
    if reverse:
        hs = torch.flip(hs, dims=[1])
        cs = torch.flip(cs, dims=[1])
    mm = a.mask[..., None].to(hs.dtype) if a.mask is not None else 1.0
    ctx.extras[f"{cfg.name}:state"] = Arg(cs * mm, a.mask)
    # a nested input keeps its sub-sequences: no resets (the recurrence
    # runs over the whole row), seg_ids passed on; packed ones go on too
    return Arg(hs * mm, a.mask, a.seg_ids)


# --- GRU -----------------------------------------------------------------

def _gru_infer(cfg, in_infos):
    enforce(in_infos[0].size % 3 == 0, "gated_recurrent input must be 3*size")
    return ArgInfo(size=in_infos[0].size // 3, is_seq=True)


def _gru_params(cfg, in_infos):
    n = in_infos[0].size // 3
    specs = {
        "w0": ParamSpec((n, 2 * n), cfg.param_attr(0), fan_in=n),   # gates
        "w1": ParamSpec((n, n), cfg.param_attr(1), fan_in=n),       # candidate
    }
    battr = cfg.bias_param_attr()
    if battr is not None:
        specs["wbias"] = ParamSpec((3 * n,), battr, fan_in=n, is_bias=True)
    return specs


def gru_cell(x3, h_prev, Wg, Wc, bias, gate_act, candidate_act, n):
    """One GRU step; x3 [B, 3n] pre-projected input."""
    xg, xc = x3[..., :2 * n], x3[..., 2 * n:]
    g = xg + matmul(h_prev, Wg)
    if bias is not None:
        g = g + bias[:2 * n]
    z = gate_act.apply(g[..., :n])
    r = gate_act.apply(g[..., n:])
    c = xc + matmul(r * h_prev, Wc)
    if bias is not None:
        c = c + bias[2 * n:]
    c = candidate_act.apply(c)
    # reference GruLayer: h = z * h_prev + (1 - z) * candidate
    return z * h_prev + (1 - z) * c


def _default_gru_acts(cfg):
    return (cfg.attr("active_type", "tanh") == "tanh"
            and cfg.attr("active_gate_type", "sigmoid") == "sigmoid")


def _gru_loop(x3, mask, Wg, Wc, bias, gate_act, cand_act, reset=None):
    """Masked recurrence over gru_cell with any activations; ``reset``
    [B, T] zeroes the carry entering a step (packed segment starts)."""
    B, T, H3 = x3.shape
    n = H3 // 3
    h = x3.new_zeros(B, n)
    hs = []
    for t in range(T):
        if reset is not None:
            h = (1 - reset[:, t, None]) * h
        h_new = gru_cell(x3[:, t], h, Wg, Wc, bias, gate_act, cand_act, n)
        m = mask[:, t, None]
        h = m * h_new + (1 - m) * h
        hs.append(h)
    return torch.stack(hs, 1)


@register_layer("gated_recurrent", infer=_gru_infer, params=_gru_params)
def _gated_recurrent(cfg, params, ins, ctx):
    a = ins[0]
    x3 = a.value
    B, T, H3 = x3.shape
    n = H3 // 3
    Wg, Wc = params["w0"], params["w1"]
    bias = params.get("wbias")
    mask = a.mask.to(x3.dtype) if a.mask is not None else \
        x3.new_ones(B, T)
    reverse = cfg.attr("reverse", False)
    reset = _packed_resets(a, ctx, reverse)
    if reset is not None:
        reset = reset.to(mask.dtype)
    if reverse:
        # the recurrence always runs forward, over flipped inputs (autograd
        # carries the gradient back through the flips); the segment ends
        # of a reverse layer's reset flip into starts
        x3 = torch.flip(x3, dims=[1])
        mask = torch.flip(mask, dims=[1])
        if reset is not None:
            reset = torch.flip(reset, dims=[1])
    # the JAX layer's rule (default activations: the kernels hardcode
    # sigmoid/tanh) with support predicates derived for Hopper, for the
    # values' dtype (bf16 under mixed precision takes the kernels' bf16
    # forms, which take the mask as float32 and convert it); training
    # takes the kernels' gradient too, so the backward kernel must take the
    # shape as well. Eager CPU tensors take the kernels' plain version;
    # under torch.export the card's rule holds wherever the trace runs, so
    # an artifact does on the card what eager code does there
    training = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x3, Wg, Wc, bias))
    on_card = x3.device.type != "cpu" or torch.compiler.is_exporting()
    fused = _default_gru_acts(cfg) and (
        not on_card or (
            fused_gru_supported(B, n, x3.dtype)
            and (not training or fused_gru_bwd_supported(B, n, x3.dtype))))
    if fused:
        b3 = bias if bias is not None else x3.new_zeros(3 * n)
        hs = fused_gru(x3.contiguous(), Wg.contiguous(), Wc.contiguous(),
                       b3.contiguous(), mask.contiguous(),
                       None if reset is None else reset.contiguous())
    else:
        hs = _gru_loop(
            x3, mask, Wg, Wc, bias,
            act_mod.resolve(cfg.attr("active_gate_type", "sigmoid")),
            act_mod.resolve(cfg.attr("active_type", "tanh")), reset)
    if reverse:
        hs = torch.flip(hs, dims=[1])
    mm = a.mask[..., None].to(hs.dtype) if a.mask is not None else 1.0
    return Arg(hs * mm, a.mask, a.seg_ids)


# --- single-step cell (for recurrent groups / generation) -----------------

def _gru_step_infer(cfg, in_infos):
    return ArgInfo(size=cfg.size)


def _gru_step_params(cfg, in_infos):
    n = cfg.size
    specs = {"w0": ParamSpec((n, 2 * n), cfg.param_attr(0), fan_in=n),
             "w1": ParamSpec((n, n), cfg.param_attr(1), fan_in=n)}
    battr = cfg.bias_param_attr()
    if battr is not None:
        specs["wbias"] = ParamSpec((3 * n,), battr, fan_in=n, is_bias=True)
    return specs


@register_layer("gru_step", infer=_gru_step_infer, params=_gru_step_params)
def _gru_step(cfg, params, ins, ctx):
    """One GRU step: in0 = pre-projected [B, 3n], in1 = prev hidden [B, n]."""
    n = cfg.size
    x3, h_prev = ins[0].value, ins[1].value
    gate_act = act_mod.resolve(cfg.attr("active_gate_type", "sigmoid"))
    cand_act = act_mod.resolve(cfg.attr("active_type", "tanh"))
    h = gru_cell(x3, h_prev, params["w0"], params["w1"], params.get("wbias"),
                 gate_act, cand_act, n)
    return Arg(h)
