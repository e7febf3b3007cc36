"""Sequence layers (counterpart of ``paddle_tpu/layers/sequence.py``;
analogs of paddle/gserver/layers/{SequencePoolLayer,
SequenceLastInstanceLayer,ExpandLayer,FeatureMapExpandLayer,
SequenceConcatLayer,SequenceReshapeLayer,SeqSliceLayer,
SubNestedSequenceLayer,SubSequenceLayer,KmaxSeqScoreLayer,EosIdCheckLayer,
GetOutputLayer}.cpp).

Sequences are [B, T, D] + mask [B, T]; nested sequences add seg_ids
[B, T]. Pooling reduces a sequence to one vector per row, or (with
``agg_level="to_sequence"`` on a nested input) each sub-sequence to one
step, by a scatter over the B*S slots of ``row_offset_segment_ids``, as
the JAX package's ``jax.ops.segment_*`` do. The layers whose row-level
reduction or indexing would mix the sequences of a packed row
(docs/packing.md) refuse packed feeds, as the JAX layers do.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg, ArgInfo, row_offset_segment_ids
from paddle_tpu_torch.core.layer import register_layer
from paddle_tpu_torch.utils.error import enforce

BIG_NEG = -1e30


def _pool_infer(cfg, in_infos):
    # to_sequence (nested input) collapses each sub-sequence to one step
    level = cfg.attr("agg_level", "to_no_sequence")
    return ArgInfo(size=in_infos[0].size, is_seq=level == "to_sequence")


def _segment_pool(v, mask, seg_ids, num_segments, how):
    """Pool within sub-sequences: [B, T, D] -> ([B, S, D], mask [B, S]).

    A step adds ``mask`` under its seg id clipped into [0, S-1] (padding
    lands in slot 0 with weight 0, or at BIG_NEG for max); an empty slot
    gives 0; the output mask is count > 0. The sums are ``index_add``:
    in index order on the CPU, by atomics in no fixed order on CUDA (the
    card then agrees with the CPU to rounding, not bit for bit). The max
    is a ``scatter_reduce`` over the B*S slots, exact either way; the
    [B, S, T, D] one-hot form is never built."""
    B, T, D = v.shape
    S = num_segments
    flat = row_offset_segment_ids(seg_ids, S)                   # [B*T]
    m = mask.to(v.dtype).reshape(-1)
    cnt = torch.zeros(B * S, dtype=v.dtype, device=v.device) \
        .index_add(0, flat, m).reshape(B, S)
    if how == "max":
        big = torch.where(m[:, None] > 0, v.reshape(B * T, D),
                          torch.full_like(v.reshape(B * T, D), BIG_NEG))
        pooled = torch.zeros(B * S, D, dtype=v.dtype, device=v.device) \
            .scatter_reduce(0, flat[:, None].expand(B * T, D), big, "amax",
                            include_self=False).reshape(B, S, D)
        pooled = torch.where(cnt[..., None] > 0, pooled,
                             torch.zeros_like(pooled))
    else:
        vm = (v * m.reshape(B, T)[..., None]).reshape(B * T, D)
        pooled = torch.zeros(B * S, D, dtype=v.dtype, device=v.device) \
            .index_add(0, flat, vm).reshape(B, S, D)
        if how == "average":
            pooled = pooled / torch.clamp(cnt[..., None], min=1.0)
        elif how == "squarerootn":
            pooled = pooled / torch.sqrt(torch.clamp(cnt[..., None], min=1.0))
        else:
            enforce(how == "sum", f"unknown average_strategy {how!r}")
    return pooled, (cnt > 0).to(v.dtype)


def _no_packed(cfg, ctx, why, kind=None):
    """Refuse packed rows (docs/packing.md) in a layer whose row-level
    reduction or indexing would mix the packed sequences; the message
    names the layer ``kind`` (default: its type)."""
    enforce(not getattr(ctx, "packed", False),
            f"{kind or cfg.type} layer {cfg.name}: packed sequence rows are "
            f"not supported ({why}); feed this model unpacked")


def _seq_pool(cfg, ins, ctx, how):
    a = ins[0]
    enforce(a.mask is not None,
            f"{cfg.type} layer {cfg.name} needs sequence input")
    if cfg.attr("agg_level", "to_no_sequence") == "to_sequence" \
            and a.seg_ids is not None and not getattr(ctx, "packed", False):
        # nested input: each sub-sequence to one step (a packed feed's
        # seg_ids must not take this branch: it would hand the cost a row
        # count where the padded run sees the samples)
        S = cfg.attr("num_segments") or a.value.shape[1]
        return Arg(*_segment_pool(a.value, a.mask, a.seg_ids, S, how))
    _no_packed(cfg, ctx, "pooling would mix packed sequences or "
               "re-normalize the loss per packed row")
    v, m = a.value, a.mask[..., None]
    count = a.mask.sum(1, keepdim=True)
    if how == "max":
        out = torch.where(m > 0, v, torch.full_like(v, BIG_NEG)).amax(dim=1)
        out = torch.where(count > 0, out, torch.zeros_like(out))
    elif how == "sum":
        out = (v * m).sum(dim=1)
    elif how == "squarerootn":
        out = (v * m).sum(dim=1) / torch.sqrt(torch.clamp(count, min=1.0))
    else:
        enforce(how == "average",
                f"{cfg.type} layer {cfg.name}: unknown average_strategy "
                f"{how!r}")
        out = (v * m).sum(dim=1) / torch.clamp(count, min=1.0)
    return Arg(out.to(v.dtype))


@register_layer("max", infer=_pool_infer)
def _max_pool_seq(cfg, params, ins, ctx):
    return _seq_pool(cfg, ins, ctx, "max")


@register_layer("average", infer=_pool_infer)
def _avg_pool_seq(cfg, params, ins, ctx):
    return _seq_pool(cfg, ins, ctx, cfg.attr("average_strategy", "average"))


def _lastins_infer(cfg, in_infos):
    # declared a sequence under to_sequence, as in the JAX package, whose
    # forward then still returns one step a row (copied: see below)
    level = cfg.attr("agg_level", "to_no_sequence")
    return ArgInfo(size=in_infos[0].size, is_seq=level == "to_sequence")


@register_layer("seqlastins", infer=_lastins_infer)
def _seq_last_ins(cfg, params, ins, ctx):
    """The last (or, with ``select_first``, the first) step of each row.
    ``agg_level`` is not read: under to_sequence the JAX layer also
    returns each row's step, not each sub-sequence's."""
    _no_packed(cfg, ctx, "the row's last step belongs to one packed "
               "sequence only")
    a = ins[0]
    if cfg.attr("select_first", False):
        return Arg(a.value[:, 0])
    idx = torch.clamp(a.lengths().long() - 1, min=0)              # [B]
    return Arg(a.value[torch.arange(a.value.shape[0]), idx])


def _seq_infer(cfg, in_infos):
    return ArgInfo(size=in_infos[0].size, is_seq=True)


@register_layer("expand", infer=_seq_infer)
def _expand(cfg, params, ins, ctx):
    """Broadcast the per-sequence vector in0 [B, D] to every step of the
    template sequence in1 [B, T, *], zero on the template's padding."""
    _no_packed(cfg, ctx, "one vector per ROW cannot serve several packed "
               "sequences")
    v, tmpl = ins[0].value, ins[1]
    out = v[:, None, :].expand(v.shape[0], tmpl.value.shape[1], v.shape[-1])
    return Arg(out * tmpl.mask[..., None].to(out.dtype), tmpl.mask,
               tmpl.seg_ids)


def _featmap_expand_infer(cfg, in_infos):
    n = cfg.attr("num_filters")
    return ArgInfo(size=in_infos[0].size * n, is_seq=in_infos[0].is_seq)


@register_layer("featmap_expand", infer=_featmap_expand_infer)
def _featmap_expand(cfg, params, ins, ctx):
    """``num_filters`` copies of the features: the whole vector n times
    (``as_col_vector``, the default), else each feature n times."""
    n = cfg.attr("num_filters")
    v = ins[0].value
    if cfg.attr("as_col_vector", True):
        out = v[..., None, :].expand(*v.shape[:-1], n, v.shape[-1]) \
            .reshape(*v.shape[:-1], -1)
    else:
        out = torch.repeat_interleave(v, n, dim=-1)
    return Arg(out, ins[0].mask, ins[0].seg_ids)


def _take_steps(v, idx):
    """v [B, T, D] at the steps idx [B, T'] of each row: [B, T', D]."""
    return torch.gather(v, 1, idx[..., None].expand(*idx.shape, v.shape[-1]))


def _front(keep):
    """The stable order that brings each row's kept steps to the front
    (an integer copy sorted: the same on the CPU and on CUDA)."""
    return torch.argsort((~keep).to(torch.int32), dim=1, stable=True)


@register_layer("seqconcat", infer=_seq_infer)
def _seq_concat(cfg, params, ins, ctx):
    """Concatenate two sequences in time, row by row: [B, T1, D] and
    [B, T2, D] -> [B, T1 + T2, D], the valid steps of a, then of b."""
    _no_packed(cfg, ctx, "time concat is defined per sequence, not per "
               "packed row")
    a, b = ins[0], ins[1]
    la = a.lengths().long()                                   # [B]
    T1, T2 = a.value.shape[1], b.value.shape[1]
    pos = torch.arange(T1 + T2, device=a.value.device)[None, :]
    idx_a = pos.clamp(0, T1 - 1).expand(la.shape[0], -1)
    idx_b = (pos - la[:, None]).clamp(0, T2 - 1)
    out = torch.where((pos < la[:, None])[..., None],
                      _take_steps(a.value, idx_a), _take_steps(b.value, idx_b))
    mask = (pos < (la + b.lengths().long())[:, None]).to(a.value.dtype)
    return Arg(out * mask[..., None], mask)


def _seqreshape_infer(cfg, in_infos):
    return ArgInfo(size=cfg.size, is_seq=True)


@register_layer("seqreshape", infer=_seqreshape_infer)
def _seq_reshape(cfg, params, ins, ctx):
    """Regroup the steps to a new feature size: [B, T, D] -> [B, T*D /
    size, size]; a row's valid steps ceil(length * D / size)."""
    _no_packed(cfg, ctx, "regrouped timesteps would straddle packed "
               "boundaries")
    a = ins[0]
    B, T, D = a.value.shape
    size = cfg.size
    enforce(T * D % size == 0, "seqreshape: T*D must divide by size")
    new_t = T * D // size
    valid = (a.lengths().long() * D + size - 1) // size
    mask = (torch.arange(new_t, device=a.value.device)[None, :]
            < valid[:, None]).to(a.value.dtype)
    return Arg(a.value.reshape(B, new_t, size), mask)


def _row_ints(arg):
    """One int a row from a [B, 1] (or [B]) input."""
    v = arg.value
    return (v[..., 0] if v.dim() > 1 else v).to(torch.int32)


@register_layer("seq_slice", infer=_seq_infer)
def _seq_slice(cfg, params, ins, ctx):
    """Keep the steps in [start, end) of each row (inputs 1 and 2; start
    0 and the row's length without them), moved to the front."""
    _no_packed(cfg, ctx, "offsets are row-relative, not sequence-relative")
    a = ins[0]
    B, T = a.value.shape[:2]
    dev = a.value.device
    starts = _row_ints(ins[1]) if len(ins) > 1 else \
        torch.zeros(B, dtype=torch.int32, device=dev)
    ends = _row_ints(ins[2]) if len(ins) > 2 else a.lengths()
    pos = torch.arange(T, device=dev)[None, :]
    keep = (pos >= starts[:, None]) & (pos < ends[:, None])
    order = _front(keep)
    mask = torch.gather(keep.to(a.value.dtype) * a.mask, 1, order)
    return Arg(_take_steps(a.value, order) * mask[..., None], mask)


@register_layer("subseq", infer=_seq_infer)
def _subseq(cfg, params, ins, ctx):
    """``size`` steps of each row from ``offset`` on (inputs 1 and 2)."""
    _no_packed(cfg, ctx, "offsets are row-relative, not sequence-relative")
    a = ins[0]
    offsets, sizes = _row_ints(ins[1]), _row_ints(ins[2])
    T = a.value.shape[1]
    pos = torch.arange(T, device=a.value.device)[None, :]
    idx = (pos + offsets[:, None]).clamp(0, T - 1).long()
    mask = (pos < sizes[:, None]).to(a.value.dtype)
    return Arg(_take_steps(a.value, idx) * mask[..., None], mask)


@register_layer("sub_nested_seq", infer=_seq_infer)
def _sub_nested_seq(cfg, params, ins, ctx):
    """The sub-sequences of a nested input that input 1 selects by index
    ([B, K], -1 padded), concatenated in time order into the front of
    the row; their seg_ids go with them."""
    a = ins[0]
    enforce(a.seg_ids is not None, "sub_nested_seq needs nested input")
    sel = ins[1].value.to(torch.int32)                           # [B, K]
    seg = a.seg_ids
    keep = torch.zeros_like(seg, dtype=torch.bool)
    for k in range(sel.shape[-1]):
        s = sel[:, k:k + 1]
        keep = keep | ((seg == s) & (s >= 0))
    order = _front(keep)
    mask = torch.gather(keep.to(a.value.dtype) * a.mask, 1, order)
    segs = torch.gather(torch.where(keep, seg, torch.full_like(seg, -1)), 1,
                        order)
    return Arg(_take_steps(a.value, order) * mask[..., None], mask, segs)


def _kmax_infer(cfg, in_infos):
    return ArgInfo(size=1, is_seq=True, dtype=torch.int32)


@register_layer("kmax_seq_score", infer=_kmax_infer)
def _kmax_seq_score(cfg, params, ins, ctx):
    """The steps of the ``beam_size`` best scores of each row, best first;
    equal scores lowest step first (``jax.lax.top_k``'s order, by a
    stable sort: torch.topk promises none)."""
    _no_packed(cfg, ctx, "row top-k would rank across packed sequences")
    k = cfg.attr("beam_size", 1)
    a = ins[0]
    scores = a.value[..., 0] if a.value.dim() == 3 else a.value
    scores = torch.where(a.mask > 0, scores, torch.full_like(scores, BIG_NEG))
    idx = torch.sort(scores, dim=-1, descending=True, stable=True)[1][:, :k]
    mask = (torch.arange(k, device=idx.device)[None, :]
            < torch.clamp(a.lengths(), max=k)[:, None])
    return Arg(idx[..., None].to(torch.int32), mask.to(torch.float32))


def _eos_infer(cfg, in_infos):
    return ArgInfo(size=1, is_seq=in_infos[0].is_seq)


@register_layer("eos_id", infer=_eos_infer)
def _eos_id(cfg, params, ins, ctx):
    """1.0 where the input id is ``eos_id``."""
    ids = ins[0].value.to(torch.int32)
    if ids.dim() == 3:
        ids = ids[..., 0]
    return Arg((ids == cfg.attr("eos_id")).to(torch.float32)[..., None],
               ins[0].mask)


@register_layer("get_output")
def _get_output(cfg, params, ins, ctx):
    """A named output of the input layer: ``arg_name="value"`` is the
    input itself; other outputs are published by their layer into
    ``ctx.extras['<layer>:<arg_name>']`` (lstmemory's ``state``)."""
    arg = cfg.attr("arg_name", "value")
    if arg == "value":
        return ins[0]
    key = f"{cfg.inputs[0].name}:{arg}"
    enforce(key in ctx.extras,
            f"get_output: {cfg.inputs[0].name!r} has no output {arg!r}")
    return ctx.extras[key]
