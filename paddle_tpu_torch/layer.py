"""Public layer API (counterpart of ``paddle_tpu/layer.py``; analog of
paddle.v2.layer). Each function builds a graph node; nothing runs until a
Topology runs the graph. The port has the layers of the LSTM text
classifier, of the NMT attention model (scoring and beam-search
generation), of the CRF sequence taggers (``mixed`` with the context
projection, ``crf``, ``crf_decoding``) and the CTC costs (``ctc``,
``warp_ctc``).
"""

from __future__ import annotations

from typing import List

import paddle_tpu_torch.layers  # noqa: F401  (registers every layer type)
from paddle_tpu_torch import activation as _act
from paddle_tpu_torch import pooling as _pooling
from paddle_tpu_torch.attr import to_param_attr
from paddle_tpu_torch.core.layer import Layer
from paddle_tpu_torch.utils.error import enforce

__all__ = ["data", "fc", "embedding", "concat", "addto", "lstmemory",
           "grumemory", "gru_step", "pooling", "first_seq", "last_seq",
           "expand", "scaling", "classification_cost", "cross_entropy_cost",
           "AggregateLevel",
           "mixed", "context_projection", "crf", "crf_decoding", "ctc",
           "warp_ctc"]


def _as_list(x) -> List[Layer]:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class AggregateLevel:
    TO_NO_SEQUENCE = "to_no_sequence"
    TO_SEQUENCE = "to_sequence"


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


def scaling(input, weight, name=None, layer_attr=None):
    return Layer("scaling", [weight, input], name=name, extra=layer_attr)


# --- recurrent group / generation ----------------------------------------

from paddle_tpu_torch.layers.recurrent_group import (   # noqa: E402
    BeamSearchControlCallbacks, GeneratedInput, StaticInput,
    SubsequenceInput, beam_search, memory, recurrent_group)

__all__ += ["recurrent_group", "memory", "StaticInput", "GeneratedInput",
            "SubsequenceInput", "BeamSearchControlCallbacks", "beam_search"]
