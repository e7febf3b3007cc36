"""Linear-chain CRF and CTC losses and decoders (counterpart of
``paddle_tpu/layers/crf_ctc.py``; analogs of paddle/gserver/layers/
{CRFLayer,CRFDecodingLayer,LinearChainCRF,CTCLayer,WarpCTCLayer}.cpp).

Each dynamic program has two implementations, switched by CRF_IMPL /
CTC_IMPL: a time loop in log space that autograd differentiates (the CPU
path), and an autograd Function whose forward and backward are Hopper
kernels on the card: ``crf_logz`` (kernels/crf.py), the long-sequence
path of the CRF, and ``ctc_fb`` (kernels/ctc.py), which the CTC layers
take only when asked for ("kernel"), as the JAX package's "auto" never
takes its CTC kernel. Both are masked for padding. Viterbi and the CTC
best-path decode are plain tensor code, as they are in the JAX package.

CRF parameter layout (LinearChainCRF.cpp parity): w is (L+2) x L — row 0
= start weights a, row 1 = end weights b, rows 2.. = transition matrix
w[i,j] = score(tag i -> tag j).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg, ArgInfo
from paddle_tpu_torch.core.layer import ParamSpec, register_layer
from paddle_tpu_torch.kernels._util import NEG
from paddle_tpu_torch.kernels.crf import crf_kernel_supported, crf_logz
from paddle_tpu_torch.kernels.ctc import ctc_nll_kernel, extended_labels
from paddle_tpu_torch.layers.cost import _cost_infer, _label_ids
from paddle_tpu_torch.layers.sequence import _no_packed
from paddle_tpu_torch.utils.error import enforce


def _crf_params(cfg, in_infos):
    L = cfg.size or in_infos[0].size
    return {"w0": ParamSpec((L + 2, L), cfg.param_attr(0), fan_in=L)}


def _crf_pieces(w):
    return w[0], w[1], w[2:]          # start, end, trans [L, L]


# CRF implementation switch: "auto" runs the crf_logz Function (the
# kernels) for CUDA tensors of LONG sequences whose shape the kernels take,
# the scan elsewhere (on the CPU always, as the JAX package takes its scan
# there); "kernel" forces the Function (its plain versions on the CPU),
# "scan" the time loop. The threshold is the JAX package's, so both take
# the same path for one config; chip_smoke.py measures the H100's own
# crossover.
CRF_IMPL = "auto"
_CRF_KERNEL_MIN_T = 256


def _crf_use_kernel(emit) -> bool:
    enforce(CRF_IMPL in ("auto", "scan", "kernel"),
            f"CRF_IMPL must be 'auto', 'scan' or 'kernel', got {CRF_IMPL!r}")
    if CRF_IMPL != "auto":
        return CRF_IMPL == "kernel"
    B, T, L = emit.shape
    return (emit.device.type == "cuda" and T >= _CRF_KERNEL_MIN_T
            and crf_kernel_supported(B, L))


def _crf_gold_score(emit, labels, mask, w):
    """Score of the gold path (shared by both logZ implementations)."""
    start, end, trans = _crf_pieces(w)
    lengths = mask.sum(-1).to(torch.int64)
    lab = labels.long()
    first = torch.gather(emit[:, 0], -1, lab[:, :1])[:, 0] + start[lab[:, 0]]
    emit_t = torch.gather(emit, -1, lab[..., None])[..., 0]      # [B, T]
    emit_sum = (emit_t * mask)[:, 1:].sum(-1)
    tr = trans[lab[:, :-1], lab[:, 1:]]                          # [B, T-1]
    tr_sum = (tr * mask[:, 1:]).sum(-1)
    last_idx = torch.clamp(lengths - 1, min=0)
    last_lab = torch.gather(lab, 1, last_idx[:, None])[:, 0]
    return first + emit_sum + tr_sum + end[last_lab]


def crf_logz_scan(emit, mask, w):
    """[B] log partition function via the alpha recursion as a time loop
    (the JAX package's ``lax.scan``)."""
    start, end, trans = _crf_pieces(w)
    alpha = start[None, :] + emit[:, 0]                          # [B, L]
    for t in range(1, emit.shape[1]):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None, :, :],
                              dim=1) + emit[:, t]
        m = mask[:, t, None]
        alpha = m * nxt + (1 - m) * alpha
    return torch.logsumexp(alpha + end[None, :], dim=-1)        # [B]


def crf_logz_kernel(emit, mask, w):
    """[B] log partition via the ``crf_logz`` Function (kernels/crf.py),
    the counterpart of ``crf_logz_pallas``: the Hopper kernels take L and
    B as they are, so nothing is padded."""
    start, end, trans = _crf_pieces(w)
    return crf_logz(emit.transpose(0, 1).contiguous(),
                    mask.transpose(0, 1).to(emit.dtype).contiguous(),
                    start.contiguous(), end.contiguous(), trans.contiguous())


def crf_nll(emit, labels, mask, w):
    """Negative log-likelihood of label paths under a linear-chain CRF.

    emit: [B, T, L] unary scores; labels: [B, T] int; mask: [B, T].
    Returns [B] costs. (LinearChainCRF::forward parity.)"""
    if _crf_use_kernel(emit):
        logz = crf_logz_kernel(emit, mask, w)
    else:
        logz = crf_logz_scan(emit, mask, w)
    return logz - _crf_gold_score(emit, labels, mask, w)


def crf_decode(emit, mask, w):
    """Viterbi decode -> ([B, T] best tags, [B] best scores)
    (LinearChainCRF::decode parity; a tie goes to the first maximum)."""
    mask = mask.to(emit.dtype)
    start, end, trans = _crf_pieces(w)
    B, T, L = emit.shape
    delta = start[None, :] + emit[:, 0]
    stay = torch.arange(L, device=emit.device).expand(B, L)
    bps = []                                 # bps[t-1]: transition into t
    for t in range(1, T):
        cand = delta[:, :, None] + trans[None, :, :]              # [B, L, L]
        best = cand.max(dim=1).values + emit[:, t]
        bp = torch.argmax(cand, dim=1)       # the first maximum, as jnp's
        m = mask[:, t, None]
        delta = m * best + (1 - m) * delta
        bps.append(torch.where(m > 0, bp, stay))
    final = delta + end[None, :]
    tags = [torch.argmax(final, dim=-1)]
    score = final.max(dim=-1).values
    for bp in reversed(bps):
        tags.append(torch.gather(bp, 1, tags[-1][:, None])[:, 0])
    return torch.stack(tags[::-1], dim=1), score


@register_layer("crf", infer=_cost_infer, params=_crf_params)
def _crf_layer(cfg, params, ins, ctx):
    """CRFLayer: cost = NLL of the gold tag sequence. Inputs: emissions
    sequence [B,T,L], label sequence [B,T]."""
    _no_packed(cfg, ctx, "the chain would score transitions across "
               "packed boundaries")
    emit, label = ins[0], ins[1]
    enforce(emit.mask is not None, "crf needs sequence input")
    nll = crf_nll(emit.value, _label_ids(label, emit), emit.mask,
                  params["w0"])
    coeff = cfg.attr("coeff", 1.0)
    return Arg((nll * coeff)[:, None])


def _crf_dec_infer(cfg, in_infos):
    return ArgInfo(size=1, is_seq=True, dtype=torch.int32)


def _step_tag_errors(tags, label, emit):
    """[B,T] 0/1 per-step viterbi-vs-gold errors, masked (shared by
    crf_decoding's label mode and crf_error)."""
    return (tags != _label_ids(label, emit)).to(torch.float32) * emit.mask


@register_layer("crf_decoding", infer=_crf_dec_infer, params=_crf_params)
def _crf_decoding_layer(cfg, params, ins, ctx):
    """CRFDecodingLayer: Viterbi tags; with a label input, emits 0/1
    per-step error indicators instead (reference semantics)."""
    _no_packed(cfg, ctx, "viterbi would score transitions across "
               "packed boundaries")
    emit = ins[0]
    tags, score = crf_decode(emit.value, emit.mask, params["w0"])
    ctx.extras[f"{cfg.name}:score"] = score
    if len(ins) > 1:
        err = _step_tag_errors(tags, ins[1], emit)
        return Arg(err[..., None], emit.mask)
    return Arg(tags[..., None].to(torch.int32), emit.mask)


@register_layer("crf_error", infer=_cost_infer, params=_crf_params)
def _crf_error_layer(cfg, params, ins, ctx):
    """CRFDecodingLayer's error mode as its own registered type
    (REGISTER_LAYER(crf_error), reference Layer registry): viterbi-decode
    and emit the per-SEQUENCE mean tag error [B,1] against the label
    input — the chunk-error building block."""
    _no_packed(cfg, ctx, "viterbi would score transitions across "
               "packed boundaries")
    emit, label = ins[0], ins[1]
    enforce(emit.mask is not None, "crf_error needs sequence input")
    tags, _score = crf_decode(emit.value, emit.mask, params["w0"])
    wrong = _step_tag_errors(tags, label, emit)
    denom = torch.clamp(emit.mask.sum(dim=-1), min=1.0)
    return Arg((wrong.sum(dim=-1) / denom)[:, None])


# --- CTC ------------------------------------------------------------------

def ctc_nll(logits, labels, in_mask, label_mask, blank=0):
    """CTC negative log-likelihood via the alpha recursion in log space, as
    a time loop that autograd differentiates (the JAX package's
    ``lax.scan``).

    logits: [B, T, C] (unnormalised); labels: [B, U] int (no blanks);
    in_mask: [B, T]; label_mask: [B, U]. Returns [B].
    (CTCLayer/LinearChainCTC parity; warp-ctc semantics, blank id
    configurable — the reference's warp_ctc uses blank=0.)"""
    logp = torch.log_softmax(logits, dim=-1)
    B, T, _ = logp.shape
    S = 2 * labels.shape[1] + 1
    ext, ext_ok, can_skip, slen = extended_labels(labels, label_mask, blank,
                                                  S)
    em = torch.gather(logp, 2, ext[:, None, :].expand(B, T, S))  # [B, T, S]
    neg = torch.full_like(em[:, 0], NEG)
    first = torch.arange(S, device=logits.device)[None, :] < 2
    alpha = torch.where(first & ext_ok, em[:, 0], neg)
    for t in range(1, T):
        a1 = torch.cat([neg[:, :1], alpha[:, :-1]], 1)
        a2 = torch.where(can_skip, torch.cat([neg[:, :2], alpha[:, :-2]], 1),
                         neg)
        nxt = torch.logaddexp(torch.logaddexp(alpha, a1), a2) + em[:, t]
        nxt = torch.where(ext_ok, nxt, neg)
        m = in_mask[:, t, None]
        alpha = m * nxt + (1 - m) * alpha
    # NLL = -log(alpha[S-1] + alpha[S-2]) at the last valid position; with
    # an empty label (slen = 1) there is no second terminal state
    last = torch.gather(alpha, 1, torch.clamp(slen - 1, min=0)[:, None])[:, 0]
    last2 = torch.gather(alpha, 1, torch.clamp(slen - 2, min=0)[:, None])[:, 0]
    last2 = torch.where(slen >= 2, last2, neg[:, 0])
    return -torch.logaddexp(last, last2)


# CTC implementation switch: "auto" takes the scan on every device, as the
# JAX package's "auto" never takes its CTC kernel (on a v5e it ran at
# 0.35 to 0.58x the scan, paddle_tpu/layers/crf_ctc.py); "kernel" forces
# the ctc_fb Function (its plain versions on the CPU, the kernels on the
# card, which raise on a shape they do not take), "scan" the time loop.
# chip_smoke.py measures the H100's own crossover.
CTC_IMPL = "auto"


def _ctc_use_kernel() -> bool:
    enforce(CTC_IMPL in ("auto", "scan", "kernel"),
            f"CTC_IMPL must be 'auto', 'scan' or 'kernel', got {CTC_IMPL!r}")
    return CTC_IMPL == "kernel"


@register_layer("ctc", infer=_cost_infer)
def _ctc_layer(cfg, params, ins, ctx):
    """CTCLayer: input 0 = frame logits/probs seq [B,T,C]; input 1 = label
    id seq [B,U]. norm_by_times divides by sequence length (reference
    flag)."""
    _no_packed(cfg, ctx, "the alpha recursion would align the "
               "concatenation of several sequences as one", kind="ctc")
    x, lab = ins[0], ins[1]
    enforce(x.mask is not None and lab.mask is not None,
            "ctc needs sequence inputs")
    blank = cfg.attr("blank", 0)
    ids = lab.value.long()
    if ids.dim() == 3:
        ids = ids[..., 0]
    nll_fn = ctc_nll_kernel if _ctc_use_kernel() else ctc_nll
    nll = nll_fn(x.value, ids, x.mask, lab.mask, blank)
    if cfg.attr("norm_by_times", False):
        nll = nll / torch.clamp(x.mask.sum(-1), min=1.0)
    coeff = cfg.attr("coeff", 1.0)
    return Arg((nll * coeff)[:, None])


@register_layer("warp_ctc", infer=_cost_infer)
def _warp_ctc_layer(cfg, params, ins, ctx):
    """WarpCTCLayer: the same math as ``ctc`` (warp-ctc was the
    reference's CUDA-side implementation); kept as a distinct type for
    config parity."""
    return _ctc_layer(cfg, params, ins, ctx)


def ctc_greedy_decode(logits, mask, blank=0):
    """Best-path decode: argmax per frame, collapse repeats, drop blanks.
    Returns dense ids [B, T] right-padded with -1, and their validity mask
    (a stable sort moves the kept ids to the front in order, as
    ``jnp.argsort(..., stable=True)`` does)."""
    ids = torch.argmax(logits, dim=-1)                         # [B, T]
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], 1)
    keep = (ids != blank) & (ids != prev) & (mask > 0)
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    compact = torch.gather(torch.where(keep, ids, -1), 1, order)
    out_mask = torch.gather(keep.to(torch.float32), 1, order)
    return compact, out_mask
