"""Public layer API (counterpart of ``paddle_tpu/layer.py``; analog of
paddle.v2.layer). Each function builds a graph node; nothing runs until a
Topology runs the graph. This slice of the port has the layers of the LSTM
text classifier.
"""

from __future__ import annotations

from typing import List

import paddle_tpu_torch.layers  # noqa: F401  (registers every layer type)
from paddle_tpu_torch import activation as _act
from paddle_tpu_torch import pooling as _pooling
from paddle_tpu_torch.attr import to_param_attr
from paddle_tpu_torch.core.layer import Layer
from paddle_tpu_torch.utils.error import enforce

__all__ = ["data", "fc", "embedding", "lstmemory", "pooling",
           "classification_cost", "AggregateLevel"]


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


def classification_cost(input, label, name=None, weight=None, evaluator=None,
                        layer_attr=None):
    """Softmax + cross-entropy over the logits of ``input``, in the stable
    log-softmax form. The JAX package's probability form for an input that
    is already a softmax (multi-class-cross-entropy) is not ported yet."""
    enforce(input.act is None or input.act.name != "softmax",
            "classification_cost: a softmax input (the probability-form "
            "cost) is not ported yet; give it the logits")
    return Layer("softmax_with_cross_entropy", [input, label], name=name,
                 extra=layer_attr)


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


def pooling(input, pooling_type=None, name=None, agg_level=None,
            layer_attr=None):
    pt = _pooling.resolve(pooling_type)
    level = agg_level or AggregateLevel.TO_NO_SEQUENCE
    return Layer(pt.name, _as_list(input), name=name, agg_level=level,
                 extra=layer_attr)
