"""Public layer API (counterpart of ``paddle_tpu/layer.py``; analog of
paddle.v2.layer). Each function builds a graph node; nothing runs until a
Topology runs the graph. The port has the layers of the LSTM text
classifier, of the NMT attention model (scoring and beam-search
generation), of the CRF sequence taggers (``mixed`` with the context
projection, ``crf``, ``crf_decoding``), the CTC costs (``ctc``,
``warp_ctc``), ``selective_fc``, the sequence layers of nested inputs
(sub-sequence pooling, ``seq_concat`` to ``get_output``),
``multi_head_attention``, ``resize``, and the image layers (``img_conv``,
``img_pool``, ``batch_norm``, ``img_cmrnorm``) with ``dropout``.
"""

from __future__ import annotations

from typing import List

import paddle_tpu_torch.layers  # noqa: F401  (registers every layer type)
from paddle_tpu_torch import activation as _act
from paddle_tpu_torch import pooling as _pooling
from paddle_tpu_torch.attr import ExtraAttr, to_param_attr
from paddle_tpu_torch.core.layer import Layer
from paddle_tpu_torch.utils.error import enforce

__all__ = ["data", "fc", "embedding", "concat", "addto", "lstmemory",
           "grumemory", "gru_step", "pooling", "first_seq", "last_seq",
           "expand", "scaling", "classification_cost", "cross_entropy_cost",
           "AggregateLevel", "ExpandLevel", "seq_concat", "seq_reshape",
           "seq_slice", "sub_seq", "sub_nested_seq", "kmax_seq_score", "eos",
           "get_output",
           "mixed", "context_projection", "crf", "crf_decoding", "ctc",
           "warp_ctc", "selective_fc", "square_error_cost",
           "regression_cost", "resize", "multi_head_attention", "dropout",
           "img_conv", "img_pool", "batch_norm", "img_cmrnorm"]


def _as_list(x) -> List[Layer]:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class AggregateLevel:
    TO_NO_SEQUENCE = "to_no_sequence"
    TO_SEQUENCE = "to_sequence"


class ExpandLevel:
    FROM_NO_SEQUENCE = "from_no_sequence"
    FROM_SEQUENCE = "from_sequence"


def data(name: str, type=None, shape=None, **kw):
    """paddle.v2.layer.data analog; ``type`` is a paddle_tpu_torch.data_type."""
    return Layer("data", [], name=name, size=getattr(type, "dim", None),
                 input_type=type, shape=shape, **kw)


def fc(input, size, act=None, name=None, param_attr=None, bias_attr=None,
       layer_attr=None):
    ins = _as_list(input)
    pattrs = param_attr if isinstance(param_attr, (list, tuple)) else \
        [param_attr] * len(ins)
    return Layer("fc", ins, name=name, size=size,
                 act=act or _act.Tanh(),
                 param_attrs=[to_param_attr(a) for a in pattrs],
                 bias_attr=bias_attr, extra=layer_attr)


def embedding(input, size, name=None, param_attr=None, layer_attr=None):
    return Layer("embedding", _as_list(input), name=name, size=size,
                 param_attrs=[to_param_attr(param_attr)], extra=layer_attr)


def concat(input, name=None, act=None, layer_attr=None, bias_attr=None):
    return Layer("concat", _as_list(input), name=name, act=act,
                 bias_attr=bias_attr, extra=layer_attr)


def addto(input, name=None, act=None, bias_attr=False, layer_attr=None):
    return Layer("addto", _as_list(input), name=name, act=act,
                 bias_attr=bias_attr, extra=layer_attr)


def dropout(input, dropout_rate, name=None):
    return Layer("addto", _as_list(input), name=name, bias_attr=False,
                 extra=ExtraAttr(drop_rate=dropout_rate))


def mixed(size=None, input=None, name=None, act=None, bias_attr=False,
          layer_attr=None):
    """mixed_layer: sums the projections in ``input``, a list of specs from
    *_projection() (the port has ``context_projection``). The
    context-manager form (``input=None``, ``with mixed_layer() as m``) is
    not ported."""
    enforce(input is not None, "mixed: the context-manager form "
            "(input=None) is not ported yet; pass input=[projection, ...]")
    ins, specs = [], []
    for p in _as_list(input):
        q = dict(p)
        ins.append(q.pop("input"))
        q["n_in"] = 1
        specs.append(q)
    return Layer("mixed", ins, name=name, size=size, act=act,
                 bias_attr=bias_attr, extra=layer_attr, projections=specs)


def context_projection(input, context_len, context_start=None,
                       padding_attr=False):
    start = context_start if context_start is not None else -(context_len // 2)
    return {"kind": "context", "input": input, "context_len": context_len,
            "context_start": start}


def crf(input, label, size=None, weight=None, param_attr=None, name=None,
        coeff=1.0, layer_attr=None):
    """Linear-chain CRF cost (crf_layer)."""
    ins = [input, label] + ([weight] if weight is not None else [])
    return Layer("crf", ins, name=name, size=size or input.size, coeff=coeff,
                 param_attrs=[to_param_attr(param_attr)], extra=layer_attr)


def crf_decoding(input, size=None, label=None, param_attr=None, name=None,
                 layer_attr=None):
    ins = [input] + ([label] if label is not None else [])
    return Layer("crf_decoding", ins, name=name, size=size or input.size,
                 param_attrs=[to_param_attr(param_attr)], extra=layer_attr)


def ctc(input, label, size=None, name=None, norm_by_times=False, blank=None,
        layer_attr=None):
    return Layer("ctc", [input, label], name=name, size=size,
                 norm_by_times=norm_by_times,
                 blank=blank if blank is not None else 0, extra=layer_attr)


def warp_ctc(input, label, size=None, name=None, norm_by_times=False,
             blank=0, layer_attr=None):
    return Layer("warp_ctc", [input, label], name=name, size=size,
                 norm_by_times=norm_by_times, blank=blank, extra=layer_attr)


def selective_fc(input, select, size, act=None, name=None, param_attr=None,
                 bias_attr=None, pass_generation=False, layer_attr=None,
                 select_is_id_list=False, gather_min_c=None,
                 weight_transposed=False, select_unique=False,
                 compact_output=False):
    """fc of which only the columns ``select`` names are kept
    (layers/misc.py). ``select_is_id_list=True`` reads ``select`` as an id
    list even when its width equals ``size``; ``gather_min_c`` overrides
    the gather path's crossover; ``compact_output=True`` returns the
    [..., K] candidate-space scores instead of scattering to [..., size],
    for the compact-K decode."""
    ins = _as_list(input) + [select]
    pattrs = param_attr if isinstance(param_attr, (list, tuple)) else \
        [param_attr] * (len(ins) - 1)
    return Layer("selective_fc", ins, name=name, size=size, act=act,
                 selection_pass_generation=pass_generation,
                 select_is_id_list=select_is_id_list,
                 gather_min_c=gather_min_c,
                 weight_transposed=weight_transposed,
                 select_unique=select_unique,
                 compact_output=compact_output,
                 param_attrs=[to_param_attr(a) for a in pattrs],
                 bias_attr=bias_attr, extra=layer_attr)


def classification_cost(input, label, name=None, weight=None, evaluator=None,
                        layer_attr=None):
    """Cross-entropy of ``input`` against ``label``: the probability form
    (multi-class-cross-entropy) when ``input`` is a softmax output, else
    softmax + cross-entropy over its logits, in the stable log-softmax
    form."""
    if input.act is not None and input.act.name == "softmax":
        return Layer("multi-class-cross-entropy", [input, label], name=name,
                     extra=layer_attr)
    return Layer("softmax_with_cross_entropy", [input, label], name=name,
                 extra=layer_attr)


def cross_entropy_cost(input, label, name=None, coeff=1.0, weight=None,
                       layer_attr=None):
    """multi-class-cross-entropy of a probability ``input`` (a softmax
    output) against ``label``, scaled by ``coeff``. ``weight`` is accepted
    and unused, as in the JAX package."""
    return Layer("multi-class-cross-entropy", [input, label], name=name,
                 coeff=coeff, extra=layer_attr)


def square_error_cost(input, label, name=None, coeff=1.0, layer_attr=None):
    """0.5 * the squared distance of ``input`` to ``label`` a sample.
    ``coeff`` is accepted and not applied, as in the JAX package."""
    return Layer("square_error", [input, label], name=name, extra=layer_attr)


regression_cost = square_error_cost


def lstmemory(input, name=None, reverse=False, act=None, gate_act=None,
              state_act=None, bias_attr=None, param_attr=None,
              layer_attr=None):
    return Layer("lstmemory", _as_list(input), name=name, reverse=reverse,
                 active_type="tanh" if act is None
                 else _act.resolve(act).name,
                 active_state_type="tanh" if state_act is None
                 else _act.resolve(state_act).name,
                 active_gate_type="sigmoid" if gate_act is None
                 else _act.resolve(gate_act).name,
                 param_attrs=[to_param_attr(param_attr)], bias_attr=bias_attr,
                 extra=layer_attr)


def grumemory(input, name=None, reverse=False, act=None, gate_act=None,
              bias_attr=None, param_attr=None, layer_attr=None):
    return Layer("gated_recurrent", _as_list(input), name=name,
                 reverse=reverse,
                 active_type="tanh" if act is None
                 else _act.resolve(act).name,
                 active_gate_type="sigmoid" if gate_act is None
                 else _act.resolve(gate_act).name,
                 param_attrs=[to_param_attr(param_attr)], bias_attr=bias_attr,
                 extra=layer_attr)


def gru_step(input, output_mem, size=None, act=None, gate_act=None, name=None,
             bias_attr=None, param_attr=None, layer_attr=None):
    return Layer("gru_step", [input, output_mem], name=name, size=size,
                 active_type=_act.resolve(act).name if act else "tanh",
                 active_gate_type=_act.resolve(gate_act).name if gate_act
                 else "sigmoid",
                 param_attrs=[to_param_attr(param_attr)], bias_attr=bias_attr,
                 extra=layer_attr)


def pooling(input, pooling_type=None, name=None, agg_level=None,
            layer_attr=None):
    pt = _pooling.resolve(pooling_type)
    level = agg_level or AggregateLevel.TO_NO_SEQUENCE
    if pt.name == "max":
        return Layer("max", _as_list(input), name=name, agg_level=level,
                     extra=layer_attr)
    enforce(pt.name in ("average", "sum", "squarerootn"),
            f"pooling: unknown pooling type {pt.name!r}")
    return Layer("average", _as_list(input), name=name, agg_level=level,
                 average_strategy=pt.name, extra=layer_attr)


def last_seq(input, name=None, agg_level=None, layer_attr=None):
    return Layer("seqlastins", _as_list(input), name=name,
                 agg_level=agg_level or AggregateLevel.TO_NO_SEQUENCE,
                 select_first=False, extra=layer_attr)


def first_seq(input, name=None, agg_level=None, layer_attr=None):
    return Layer("seqlastins", _as_list(input), name=name,
                 agg_level=agg_level or AggregateLevel.TO_NO_SEQUENCE,
                 select_first=True, extra=layer_attr)


def expand(input, expand_as, name=None, expand_level=None, layer_attr=None):
    return Layer("expand", [input, expand_as], name=name, extra=layer_attr)


def seq_concat(a, b, name=None, layer_attr=None):
    return Layer("seqconcat", [a, b], name=name, extra=layer_attr)


def seq_reshape(input, reshape_size, name=None, act=None, bias_attr=False,
                layer_attr=None):
    return Layer("seqreshape", _as_list(input), name=name, size=reshape_size,
                 act=act, extra=layer_attr)


def seq_slice(input, starts=None, ends=None, name=None):
    ins = [input] + [x for x in (starts, ends) if x is not None]
    return Layer("seq_slice", ins, name=name)


def sub_seq(input, offsets, sizes, name=None):
    return Layer("subseq", [input, offsets, sizes], name=name)


def sub_nested_seq(input, selected_indices, name=None):
    return Layer("sub_nested_seq", [input, selected_indices], name=name)


def kmax_seq_score(input, beam_size=1, name=None):
    return Layer("kmax_seq_score", _as_list(input), name=name,
                 beam_size=beam_size)


def eos(input, eos_id, name=None, layer_attr=None):
    return Layer("eos_id", _as_list(input), name=name, eos_id=eos_id,
                 extra=layer_attr)


def get_output(input, arg_name="value", name=None, layer_attr=None):
    return Layer("get_output", _as_list(input), name=name, arg_name=arg_name,
                 extra=layer_attr)


def scaling(input, weight, name=None, layer_attr=None):
    return Layer("scaling", [weight, input], name=name, extra=layer_attr)


def resize(input, size, name=None, layer_attr=None):
    return Layer("resize", _as_list(input), name=name, size=size,
                 extra=layer_attr)


def multi_head_attention(query, key_value=None, size=None, num_heads=8,
                         causal=False, seq_parallel=None, name=None,
                         param_attr=None, bias_attr=None, layer_attr=None):
    """Multi-head attention over a query sequence and, optionally, a
    key/value sequence (self-attention without one). ``seq_parallel``
    ('ring' | 'ulysses') is kept in the config; without a mesh the layer
    runs on one device, as the JAX one does."""
    ins = [query] + ([key_value] if key_value is not None else [])
    return Layer("multi_head_attention", ins, name=name, size=size,
                 num_heads=num_heads, causal=causal, seq_parallel=seq_parallel,
                 param_attrs=[to_param_attr(param_attr)], bias_attr=bias_attr,
                 extra=layer_attr)


# --- image ------------------------------------------------------------------

def img_conv(input, filter_size, num_filters, name=None, num_channels=None,
             stride=1, padding=0, groups=1, act=None, bias_attr=None,
             param_attr=None, shared_biases=True, layer_attr=None,
             filter_size_y=None, stride_y=None, padding_y=None,
             trans=False, img_size=None, img_size_y=None):
    """A 2-D convolution (``trans=True``: transposed), layers/conv.py;
    ``act`` defaults to Relu, as in the reference DSL."""
    type_name = "exconvt" if trans else "exconv"
    return Layer(type_name, _as_list(input), name=name,
                 num_filters=num_filters, num_channels=num_channels,
                 filter_size=filter_size,
                 filter_size_y=filter_size_y or filter_size,
                 stride=stride, stride_y=stride_y or stride,
                 padding=padding,
                 padding_y=padding_y if padding_y is not None else padding,
                 groups=groups, shared_biases=shared_biases,
                 img_size=img_size, img_size_y=img_size_y,
                 transposed=trans, act=act or _act.Relu(),
                 param_attrs=[to_param_attr(param_attr)], bias_attr=bias_attr,
                 extra=layer_attr)


def img_pool(input, pool_size, name=None, num_channels=None, pool_type=None,
             stride=1, padding=0, layer_attr=None, pool_size_y=None,
             stride_y=None, padding_y=None, img_size=None, img_size_y=None,
             ceil_mode=True, exclude_mode=None):
    """Max or average pooling of an image, layers/conv.py."""
    pt = _pooling.resolve(pool_type)
    return Layer("pool", _as_list(input), name=name, num_channels=num_channels,
                 pool_size=pool_size, pool_size_y=pool_size_y,
                 stride=stride, stride_y=stride_y,
                 padding=padding, padding_y=padding_y,
                 pool_type=pt.name, img_size=img_size, img_size_y=img_size_y,
                 ceil_mode=ceil_mode,
                 exclude_mode=exclude_mode if exclude_mode is not None
                 else True,
                 extra=layer_attr)


def batch_norm(input, act=None, name=None, num_channels=None, bias_attr=None,
               param_attr=None, layer_attr=None, batch_norm_type=None,
               moving_average_fraction=0.9, use_global_stats=None,
               epsilon=1e-5):
    """Batch normalisation with moving statistics, layers/norm.py."""
    return Layer("batch_norm", _as_list(input), name=name,
                 num_channels=num_channels, act=act,
                 moving_average_fraction=moving_average_fraction,
                 use_global_stats=bool(use_global_stats),
                 epsilon=epsilon,
                 param_attrs=[to_param_attr(param_attr)] if param_attr else [],
                 bias_attr=bias_attr, extra=layer_attr)


def img_cmrnorm(input, size=5, scale=0.0001, power=0.75, num_channels=None,
                name=None, img_size=None, img_size_y=None, layer_attr=None):
    """Local response norm across channel maps, layers/norm.py."""
    return Layer("norm", _as_list(input), name=name, norm_size=size,
                 scale=scale, power=power, num_channels=num_channels,
                 img_size=img_size, img_size_y=img_size_y, extra=layer_attr)


# --- recurrent group / generation ----------------------------------------

from paddle_tpu_torch.layers.recurrent_group import (   # noqa: E402
    BeamSearchControlCallbacks, GeneratedInput, StaticInput,
    SubsequenceInput, beam_search, memory, recurrent_group)

__all__ += ["recurrent_group", "memory", "StaticInput", "GeneratedInput",
            "SubsequenceInput", "BeamSearchControlCallbacks", "beam_search"]
