"""Basic layers: data, fc, embedding, concat, addto, mixed (counterpart
of ``paddle_tpu/layers/basic.py``; analogs of
paddle/gserver/layers/{DataLayer,FullyConnectedLayer,TableProjection,
ConcatenateLayer,AddtoLayer,MixedLayer}.cpp). Sequence inputs [B, T, D]
contract on the last dim (batched matmul); a sparse data input of fc is a
sum of the weight's rows at its ids (``gather_rows``). Carried NHWC image
values (layers/conv.py) flatten to CHW at fc; concat joins images of one
H, W along the channels and addto keeps all-image sums 4-D. Of the mixed
layer's projections the port has the context projection.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from paddle_tpu_torch.core.arg import Arg, ArgInfo
from paddle_tpu_torch.core.layer import ParamSpec, register_layer
from paddle_tpu_torch.layers.conv import flat_from_nhwc
from paddle_tpu_torch.utils.error import enforce


# --- data ----------------------------------------------------------------

def _data_infer(cfg, in_infos):
    t = cfg.attr("input_type")
    shape = cfg.attr("shape")
    if t is not None:
        return ArgInfo(size=t.dim, shape=shape, is_seq=t.is_seq,
                       is_nested=t.is_nested, dtype=t.dtype)
    return ArgInfo(size=cfg.size or 0, shape=shape,
                   is_seq=bool(cfg.attr("is_seq")))


@register_layer("data", infer=_data_infer)
def _data_forward(cfg, params, ins, ctx):  # never called; topology feeds it
    raise RuntimeError("data layer is fed, not computed")


# --- fc ------------------------------------------------------------------

def _fc_infer(cfg, in_infos):
    enforce(cfg.size is not None, f"fc layer {cfg.name} needs size")
    return ArgInfo(size=cfg.size,
                   is_seq=any(i.is_seq for i in in_infos),
                   is_nested=any(i.is_nested for i in in_infos))


def _fc_params(cfg, in_infos) -> Dict[str, ParamSpec]:
    specs = {}
    for i, info in enumerate(in_infos):
        specs[f"w{i}"] = ParamSpec(shape=(info.size, cfg.size),
                                   attr=cfg.param_attr(i), fan_in=info.size)
    battr = cfg.bias_param_attr()
    if battr is not None:
        specs["wbias"] = ParamSpec(shape=(cfg.size,), attr=battr,
                                   fan_in=cfg.size, is_bias=True)
    return specs


def _sparse_input_type(cfg, i):
    """The declared InputType when input i is a non-sequence sparse data
    layer. Sparse *sequence* inputs are refused: the feeder has no
    padded-id sequence format, and densifying would drop the mask."""
    src = cfg.inputs[i]
    it = src.cfg.get("input_type") if src.type == "data" else None
    if it is None or not it.kind.startswith("sparse"):
        return None
    enforce(not it.is_seq,
            f"fc layer {cfg.name}: sparse sequence inputs are not "
            "supported (use embedding + pooling)")
    return it


@register_layer("fc", infer=_fc_infer, params=_fc_params)
def _fc_forward(cfg, params, ins: List[Arg], ctx) -> Arg:
    out = None
    mask = seg = None
    for i, a in enumerate(ins):
        it = _sparse_input_type(cfg, i)
        if it is not None:
            # padded id rows from the feeder: the product with a {0, 1} or
            # valued vector is a sum of W's rows
            v = a.value
            if it.kind == "sparse_value":      # [B, K, 2] = (id, value)
                ids, vals = v[..., 0].to(torch.int32), v[..., 1]
            else:                              # sparse_binary: [B, K] ids
                ids, vals = v.to(torch.int32), None
            y = gather_rows(params[f"w{i}"], ids, vals)
            out = y if out is None else out + y
            continue
        v = a.value
        if v.dim() == 4:                     # image input: flatten to CHW
            v = flat_from_nhwc(v)
        enforce(v.dim() in (2, 3),
                f"fc layer {cfg.name}: the port takes [B, D], [B, T, D] or "
                f"[B, H, W, C] inputs, got {tuple(v.shape)}")
        y = matmul(v, params[f"w{i}"])
        out = y if out is None else out + y
        if a.mask is not None:
            mask, seg = a.mask, a.seg_ids
    if "wbias" in params:
        out = out + params["wbias"]
    return Arg(out, mask, seg)


def matmul(a, b):
    """torch.matmul with jnp.matmul's dtype promotion: under mixed
    precision a value that a float32 mask widened (the attention's
    context, and what the decoder computes from it) meets bf16 weights,
    and the product runs in float32, as in the JAX package."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return torch.matmul(a, b)


def gather_rows(table, ids, weights=None):
    """Sum of table rows selected by padded id lists: rows at ids < 0
    (feeder padding) contribute nothing; optional per-id weights scale
    each row."""
    valid = (ids >= 0).to(table.dtype)
    if weights is not None:
        valid = valid * weights.to(table.dtype)
    rows = table[ids.long().clamp(0, table.shape[0] - 1)]
    return (rows * valid[..., None]).sum(dim=-2)


# --- embedding (table projection) ---------------------------------------

def _embed_infer(cfg, in_infos):
    return ArgInfo(size=cfg.size, is_seq=in_infos[0].is_seq,
                   is_nested=in_infos[0].is_nested)


def _embed_params(cfg, in_infos):
    vocab = cfg.attr("vocab_size") or in_infos[0].size
    attr = cfg.param_attr(0)
    return {"w0": ParamSpec(shape=(vocab, cfg.size), attr=attr,
                            fan_in=cfg.size)}


@register_layer("embedding", infer=_embed_infer, params=_embed_params)
def _embed_forward(cfg, params, ins, ctx):
    ids = ins[0].value.long()
    table = params["w0"]
    out = table[ids.clamp(0, table.shape[0] - 1)]
    # ids < 0 are sparse-input padding: zero their rows
    out = torch.where((ids >= 0)[..., None], out, torch.zeros_like(out))
    return Arg(out, ins[0].mask, ins[0].seg_ids)


# --- concat / addto ------------------------------------------------------

def _concat_infer(cfg, in_infos):
    return ArgInfo(size=sum(i.size for i in in_infos),
                   is_seq=any(i.is_seq for i in in_infos))


def _concat_params(cfg, in_infos):
    battr = cfg.bias_param_attr()
    if battr is None or cfg.bias_attr is None:
        # reference concat default: no bias unless requested (so
        # bias_attr=None means NO bias here, unlike fc; parameter names
        # depend on it)
        return {}
    size = sum(i.size for i in in_infos)
    return {"wbias": ParamSpec(shape=(size,), attr=battr,
                               fan_in=size, is_bias=True)}


@register_layer("concat", infer=_concat_infer, params=_concat_params)
def _concat_forward(cfg, params, ins, ctx):
    mask = next((a.mask for a in ins if a.mask is not None), None)
    # feature concat keeps the time axis: segment ids ride through
    seg = next((a.seg_ids for a in ins if a.seg_ids is not None), None)
    vals = [a.value for a in ins]
    if "wbias" not in params and all(v.dim() == 4 for v in vals) and \
            len({tuple(v.shape[1:3]) for v in vals}) == 1:
        # images of one H, W: the channel concat (the reference's flat CHW
        # feature concat), kept 4-D NHWC
        return Arg(torch.cat(vals, dim=-1), mask, seg)
    vals = [flat_from_nhwc(v) if v.dim() == 4 else v for v in vals]
    for v in vals:
        enforce(v.dim() in (2, 3),
                f"concat layer {cfg.name}: the port takes [B, D], "
                f"[B, T, D] or [B, H, W, C] inputs, got {tuple(v.shape)}")
    out = torch.cat(vals, dim=-1)
    if "wbias" in params:
        out = out + params["wbias"]
    return Arg(out, mask, seg)


def _addto_params(cfg, in_infos):
    battr = cfg.bias_param_attr()
    if battr is None or cfg.bias_attr is None:
        # reference addto default: no bias unless requested
        return {}
    return {"wbias": ParamSpec(shape=(in_infos[0].size,), attr=battr,
                               fan_in=in_infos[0].size, is_bias=True)}


def _canon(v, like):
    """addto's operand ``v`` in the form of ``like``: an NHWC image
    flattens to CHW beside a flat operand, a flat CHW one lifts to NHWC
    beside an image; anything else reshapes."""
    if v.shape == like.shape:
        return v
    if v.dim() == 4 and like.dim() == 2:
        return flat_from_nhwc(v)
    if v.dim() == 2 and like.dim() == 4:
        b, h, w, c = like.shape
        return v.reshape(-1, c, h, w).permute(0, 2, 3, 1)
    return v.reshape(like.shape)


@register_layer("addto", params=_addto_params)
def _addto_forward(cfg, params, ins, ctx):
    out = ins[0].value
    for a in ins[1:]:
        out = out + _canon(a.value, out)
    if "wbias" in params:
        b = params["wbias"]
        if out.dim() == 4:                   # the bias is stored flat CHW
            bb, hh, ww, cc = out.shape
            b = b.reshape(1, cc, hh, ww).permute(0, 2, 3, 1)
        out = out + b
    return Arg(out, ins[0].mask, ins[0].seg_ids)


# --- mixed (sum of projections) -------------------------------------------

def _proj_out_size(proj, infos):
    enforce(proj["kind"] == "context",
            f"mixed layer: the {proj['kind']!r} projection is not ported yet "
            "(the port has the context projection)")
    return infos[0].size * proj["context_len"]


def _walk_specs(projs, seq):
    """Yield (spec_index, spec, its slice of seq) honoring per-spec input
    arity (projections take 1 input, operators 2)."""
    idx = 0
    for i, p in enumerate(projs):
        n = p.get("n_in", 1)
        yield i, p, seq[idx:idx + n]
        idx += n


def _mixed_infer(cfg, in_infos):
    projs = cfg.attr("projections") or []
    sizes = {_proj_out_size(p, infos)
             for _i, p, infos in _walk_specs(projs, in_infos)}
    enforce(len(sizes) <= 1,
            f"mixed layer {cfg.name}: projection size mismatch {sizes}")
    fallback = in_infos[0].size if in_infos else None
    size = cfg.size or (sizes.pop() if sizes else fallback)
    enforce(size is not None and size > 0,
            f"mixed layer {cfg.name}: give size= (projections defer to it)")
    return ArgInfo(size=size, is_seq=any(i.is_seq for i in in_infos))


def _mixed_params(cfg, in_infos):
    """The context projection has no parameter: only the bias, when one is
    asked for (mixed's default is none)."""
    battr = cfg.bias_param_attr()
    if battr is not None and cfg.bias_attr is not None \
            and cfg.bias_attr is not False:
        size = _mixed_infer(cfg, in_infos).size
        return {"wbias": ParamSpec((size,), battr, fan_in=size,
                                   is_bias=True)}
    return {}


def _apply_context_projection(v, mask, context_start, context_len):
    """Context projection (paddle/function/ContextProjectionOp*): concat
    shifted copies of each timestep's neighbours along features.
    v: [B, T, D] -> [B, T, D*context_len]. As in the JAX package, a shifted
    copy is zeroed only past the edge of the padded array, not at each
    row's own length: the last steps of a short row see the padding's
    rows."""
    B, T, D = v.shape
    steps = torch.arange(T, device=v.device)
    cols = []
    for o in range(context_start, context_start + context_len):
        shifted = torch.roll(v, -o, dims=1)
        if o > 0:       # rolled from the front: zero the tail
            valid = steps < T - o
        elif o < 0:
            valid = steps >= -o
        else:
            valid = torch.ones_like(steps, dtype=torch.bool)
        cols.append(torch.where(valid[None, :, None], shifted,
                                torch.zeros_like(shifted)))
    return torch.cat(cols, dim=-1)


@register_layer("mixed", infer=_mixed_infer, params=_mixed_params)
def _mixed_forward(cfg, params, ins, ctx):
    projs = cfg.attr("projections") or []
    out = None
    mask = next((a.mask for a in ins if a.mask is not None), None)
    seg = next((a.seg_ids for a in ins if a.seg_ids is not None), None)
    for _i, p, args in _walk_specs(projs, ins):
        a = args[0]
        y = _apply_context_projection(a.value, a.mask, p["context_start"],
                                      p["context_len"])
        out = y if out is None else out + y
    if out is None:
        out = ins[0].value
    if "wbias" in params:
        out = out + params["wbias"]
    return Arg(out, mask, seg)
