"""Misc layers: the selective fully connected layer (counterpart of
``paddle_tpu/layers/misc.py``; analog of
paddle/gserver/layers/SelectiveFullyConnectedLayer.cpp). The JAX
module's hierarchical sigmoid, NCE and print layers are not ported yet.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg, ArgInfo
from paddle_tpu_torch.core.layer import ParamSpec, register_layer
from paddle_tpu_torch.utils.error import enforce


def _selfc_infer(cfg, in_infos):
    # compact_output: the layer's output lives in CANDIDATE space, one
    # score per selection slot ([..., K]), never scattered to [..., C]
    size = in_infos[-1].size if cfg.attr("compact_output") else cfg.size
    return ArgInfo(size=size,
                   is_seq=any(i.is_seq for i in in_infos[:-1]),
                   is_nested=any(i.is_nested for i in in_infos[:-1]))


def _selfc_params(cfg, in_infos):
    specs = {}
    # weight_transposed stores (in, out), fc's layout, so a selective
    # vocab projection shares an fc layer's parameters by name
    # (networks.gru_encoder_decoder names its selective projection like
    # the dense fc; checkpoints move between the modes as they are)
    transposed = bool(cfg.attr("weight_transposed", False))
    for i, info in enumerate(in_infos[:-1]):
        shape = (info.size, cfg.size) if transposed else (cfg.size, info.size)
        specs[f"w{i}"] = ParamSpec(shape, cfg.param_attr(i), fan_in=info.size)
    battr = cfg.bias_param_attr()
    if battr is not None:
        specs["wbias"] = ParamSpec((cfg.size,), battr, fan_in=cfg.size,
                                   is_bias=True)
    return specs


# The gather path's crossovers, the JAX package's values: C from which
# the gather path replaces the dense matmul + mask under plain autodiff,
# and under the train step's sparse-row gradient protocol when every
# weight of the layer has ``sparse_update`` (its dW is then a
# SparseRowGrad and no [C, D] gradient exists, so the gather pays off
# sooner). A layer's ``gather_min_c`` overrides both (the decode wiring
# sets 0: generation has no dW, and the gather wins as soon as K << C).
_SELFC_GATHER_MIN_C = 1 << 21
_SELFC_GATHER_MIN_C_SPARSE = 1 << 18


def _first_occurrence(sel: torch.Tensor) -> torch.Tensor:
    """[N, K] bool: True at the first slot of each id in its row. A
    stable sort puts equal ids next to each other in slot order; every
    sorted entry equal to its left neighbour is a duplicate, scattered
    back to its slot."""
    order = torch.argsort(sel, dim=-1, stable=True)
    ss = torch.gather(sel, -1, order)
    dup_sorted = torch.cat([torch.zeros_like(ss[:, :1], dtype=torch.bool),
                            ss[:, 1:] == ss[:, :-1]], dim=-1)
    return ~torch.zeros_like(dup_sorted).scatter(-1, order, dup_sorted)


def transposed_tables(topology, params):
    """``params`` with every fc-layout table that a ``weight_transposed``
    selective_fc of ``topology`` reads laid out transposed in memory: the
    same (in, out) shape and values, as the view ``W.T.contiguous().T``,
    so the layer's row gather of ``W.T`` reads contiguous rows. A loop
    that runs such a layer every tick (beam search) makes the copy once a
    call; it is made anew on every call and never kept."""
    out = dict(params)
    for l in topology.layers:
        if l.type == "selective_fc" and l.attr("weight_transposed"):
            for suffix, pname in topology.layer_params(l).items():
                if suffix != "wbias":
                    out[pname] = params[pname].t().contiguous().t()
    return out


@register_layer("selective_fc", infer=_selfc_infer, params=_selfc_params)
def _selective_fc(cfg, params, ins, ctx):
    """fc over the full output set of which only the columns the last
    input selects are kept; the others are ``fill``: -1e30 (a softmax
    gives them no mass), or 0 with ``selection_pass_generation``.

    The selection is an id list ([..., K], -1 padded) when
    ``select_is_id_list`` or ``compact_output`` is set or K != C, else a
    dense [..., C] selection that keeps entries > 0. A per-batch [B, K]
    selection on a [B, T, D] sequence input applies at every step.

    Two paths. The dense one: the full matmul, then the kept columns. The
    gather one (id lists, C >= ``gather_min_c``): the K selected rows of
    each row's table, their [N, K] products, scattered into [N, C]. Only
    an id's first slot in its row scatters (``select_unique`` promises
    unique ids and skips that sort); -1 pads and later duplicates go to a
    scratch column C that is dropped, so their gradients are zero.
    ``compact_output`` keeps the [..., K] products, dead slots filled,
    and records each slot's id (-1 when dead) in
    ``ctx.extras['selfc_compact'][name]`` for the compact-K beam search
    (layers/recurrent_group.py).

    Under the sparse-row protocol (``ctx.sparse_rows``, the train step's)
    the gather path reads a ``sparse_update`` weight's rows from the
    detached table into a leaf that requires grad and records ``(rows,
    leaf)`` for the weight, rows -1 on dead slots: the step's backward
    gives the rows' dW as ``leaf.grad``, and the table gets none."""
    sel = ins[-1].value.to(torch.int32)        # [..., K] ids or dense [..., C]
    C = cfg.size
    fill = 0.0 if cfg.attr("selection_pass_generation", False) else -1e30
    compact = bool(cfg.attr("compact_output", False))
    id_list = compact or bool(cfg.attr("select_is_id_list", False)) \
        or sel.shape[-1] != C
    transposed = bool(cfg.attr("weight_transposed", False))
    xs = ins[:-1]
    mask = next((a.mask for a in xs if a.mask is not None), None)
    seg = next((a.seg_ids for a in xs if a.seg_ids is not None), None)
    x_ndim = max(a.value.dim() for a in xs)
    if sel.dim() == x_ndim - 1:
        # per-batch selection on a sequence input: every step keeps the
        # same columns (the reference's per-sample selCols)
        T = next(a.value.shape[1] for a in xs if a.value.dim() == x_ndim)
        sel = sel[:, None, :].expand(sel.shape[0], T, sel.shape[-1])
    sparse_rows = ctx.sparse_rows
    sparse_w = [cfg.param_attr(i).sparse_update for i in range(len(xs))]
    min_c = cfg.attr("gather_min_c")
    if min_c is None:
        min_c = (_SELFC_GATHER_MIN_C_SPARSE
                 if sparse_rows is not None and all(sparse_w)
                 else _SELFC_GATHER_MIN_C)
    if id_list and (compact or C >= min_c) \
            and all(a.value.dim() == sel.dim() for a in xs):
        lead, K = sel.shape[:-1], sel.shape[-1]
        sel2 = sel.reshape(-1, K)
        N = sel2.shape[0]
        live = sel2 >= 0
        if not cfg.attr("select_unique", False):
            live = live & _first_occurrence(sel2)
        idx = sel2.clamp(0, C - 1).long()
        y = None
        for i, a in enumerate(xs):
            enforce(not (transposed and sparse_w[i]),
                    "selective_fc: weight_transposed does not compose with "
                    "sparse_update (row grads index axis 0)")
            x = a.value.reshape(N, a.value.shape[-1])
            w = params[f"w{i}"]
            pname = ctx.layer_param_names.get(f"w{i}")
            if sparse_rows is not None and sparse_w[i] and pname is not None:
                # one forward, so a second gather of the table is refused
                # here (JAX's discovery trace also checks the slot shapes)
                enforce(pname not in sparse_rows,
                        f"sparse param {pname} gathered twice in one "
                        "forward — sparse-row grads need one consumer")
                # the rows' dW is this leaf's gradient; the table, read
                # detached, gets none
                wk = w.detach()[idx].requires_grad_(True)
                sparse_rows[pname] = (torch.where(live, sel2, -1), wk)
            else:
                # rows of the (out, in) table; an fc-layout (in, out) table
                # is read through its transpose (transposed_tables lays it
                # out so for a decode)
                wk = (w.t() if transposed else w)[idx]      # [N, K, D]
            t = torch.bmm(wk, x[:, :, None])[..., 0]
            y = t if y is None else y + t
        if "wbias" in params:
            y = y + params["wbias"][idx]
        if compact:
            ctx.extras.setdefault("selfc_compact", {})[cfg.name] = \
                torch.where(live, sel2, -1).reshape(*lead, K)
            yk = torch.where(live, y, fill)
            return Arg(yk.reshape(*lead, K), mask, seg)
        # dead slots scatter into the scratch column C (a clip would alias
        # them onto id 0); the out-of-place scatter's gradient gathers the
        # dropped column's zeros for them. Only column C takes repeated
        # indices, whose order of writes does not matter.
        idx_sc = torch.where(live, idx, C)
        out = y.new_full((N, C + 1), fill).scatter(1, idx_sc, y)[:, :C]
        return Arg(out.reshape(*lead, C), mask, seg)
    enforce(not compact,
            f"selective_fc {cfg.name!r}: compact_output requires the "
            "gather path (selection rank must match the input rank)")
    out = None
    for i, a in enumerate(xs):
        w = params[f"w{i}"]
        t = torch.matmul(a.value, w if transposed else w.t())
        out = t if out is None else out + t
    if "wbias" in params:
        out = out + params["wbias"]
    if not id_list:
        keep = sel > 0
    else:
        # one scatter into [..., C + 1], pads to column C: the JAX
        # package's one_hot(sel, C).any(-2) without its [..., K, C] value
        cols = torch.where(sel >= 0, sel.clamp(0, C - 1), C).long()
        keep = torch.zeros(sel.shape[:-1] + (C + 1,), dtype=torch.bool,
                           device=sel.device).scatter_(-1, cols, True)[..., :C]
    return Arg(torch.where(keep, out, fill), mask, seg)
