"""Layer graph nodes + the layer-type registry (counterpart of
``paddle_tpu/core/layer.py``).

- ``register_layer`` fills LAYER_REGISTRY with LayerDefs (the reference's
  ``REGISTER_LAYER``, paddle/gserver/layers/Layer.h:31);
- a ``Layer`` is a graph node (v2 LayerOutput analog), not a stateful
  object: parameters live in a name -> tensor dict and each layer type is
  a ``forward`` function on tensors.

Each LayerDef supplies:
  infer(cfg, in_infos)   -> ArgInfo
  params(cfg, in_infos)  -> {suffix: ParamSpec}
  forward(cfg, params, ins, ctx) -> Arg

Auto-generated layer names (``__<type>_<n>__``) follow the JAX package's
counter exactly: parameter names in a checkpoint tar depend on them.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from paddle_tpu_torch.attr import ExtraAttr, ParamAttr, to_param_attr
from paddle_tpu_torch.core.arg import Arg, ArgInfo
from paddle_tpu_torch.utils.error import enforce
from paddle_tpu_torch.utils.registry import Registry


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of one learnable tensor of a layer."""

    shape: Tuple[int, ...]
    attr: ParamAttr
    fan_in: int = 1
    is_bias: bool = False
    dtype: Any = torch.float32


class ForwardContext:
    """Per-forward context passed to every layer: the training flag, the
    random generator of the forward (dropout), the outputs so far and a
    scratch dict for cross-layer plumbing (``extras``).

    ``sparse_rows`` turns the sparse-row gradient protocol on (the train
    step passes an empty dict; layers/misc.py selective_fc and
    trainer/trainer.py make_train_step): a layer that gathers rows of a
    ``sparse_update`` table records ``{param_name: (rows, leaf)}`` there,
    ``rows`` the int32 ids it read (-1 on dead slots) and ``leaf`` the
    gathered [..., D] block, a leaf tensor that requires grad, cut from
    the table; the step's backward then gives the rows' dW as
    ``leaf.grad`` and no [C, D] gradient exists. ``layer_param_names``
    maps the running layer's local parameter suffixes to global names
    (set by Topology.forward before each layer).

    ``packed`` is True when the feed packs several sequences a row
    (docs/packing.md: a plain sequence feed that carries seg_ids;
    ``Topology._feeds_packed``). It is fixed for the forward: the
    segment-aware layers then cut state and attention at the segments'
    edges, and the layers that cannot honour packed rows refuse them."""

    def __init__(self, training: bool = False,
                 generator: Optional[torch.Generator] = None,
                 sparse_rows: Optional[Dict[str, tuple]] = None,
                 packed: bool = False):
        self.training = training
        self._generator = generator
        self.packed = packed
        self.outputs: Dict[str, Arg] = {}
        self.extras: Dict[str, Any] = {}
        self.sparse_rows = sparse_rows
        self.layer_param_names: Dict[str, str] = {}

    def generator(self) -> torch.Generator:
        """The forward's generator; layers draw from it in topological
        order, so one seed gives one stream of random numbers."""
        enforce(self._generator is not None,
                "this forward needs a torch.Generator (a dropout layer is "
                "present); pass generator= to Topology.forward / the trainer")
        return self._generator


@dataclasses.dataclass(frozen=True)
class LayerDef:
    type: str
    infer: Callable[..., ArgInfo]
    forward: Callable[..., Arg]
    params: Optional[Callable[..., Dict[str, ParamSpec]]] = None


LAYER_REGISTRY: Registry = Registry("layer")


def register_layer(type_name: str, infer=None, params=None):
    """Decorator registering a forward fn as a layer type
    (REGISTER_LAYER analog)."""

    def deco(forward_fn):
        LAYER_REGISTRY.register(
            type_name,
            LayerDef(type=type_name, infer=infer or _infer_identity,
                     forward=forward_fn, params=params))
        return forward_fn

    return deco


def _infer_identity(cfg, in_infos):
    enforce(len(in_infos) >= 1, f"layer {cfg.name} needs >=1 input")
    return in_infos[0]


_name_counters = itertools.count()
_name_lock = threading.Lock()

# observers notified on every Layer construction; recurrent-group tracing
# registers one to find memory-target layers that are not step outputs
creation_hooks: List = []


def _auto_name(type_name: str) -> str:
    with _name_lock:
        return f"__{type_name}_{next(_name_counters)}__"


class layer_name_scope:
    """Deterministic auto-naming scope: inside the scope the counter
    restarts from 0, so building the same config twice yields identical
    layer names (and the JAX package, building it in its own scope, gives
    the same names)."""

    def __enter__(self):
        global _name_counters
        with _name_lock:
            self._saved = _name_counters
            _name_counters = itertools.count()
        return self

    def __exit__(self, *a):
        global _name_counters
        with _name_lock:
            _name_counters = self._saved


class Layer:
    """A node in the model graph (v2 LayerOutput analog)."""

    def __init__(self, type: str, inputs: Sequence["Layer"],
                 name: Optional[str] = None, size: Optional[int] = None,
                 act=None, param_attrs: Optional[List[ParamAttr]] = None,
                 bias_attr=None, extra: Optional[ExtraAttr] = None, **cfg):
        from paddle_tpu_torch import activation as _act_mod

        self.type = type
        self.name = name or _auto_name(type)
        self.inputs: List[Layer] = list(inputs)
        self.size = size
        self.act = _act_mod.resolve(act) if act is not None else None
        self.param_attrs = [to_param_attr(a) for a in (param_attrs or [])]
        # bias_attr follows the reference DSL: False = no bias,
        # None/True = default bias, ParamAttr = custom
        self.bias_attr = bias_attr
        self.extra = extra or ExtraAttr()
        self.cfg: Dict[str, Any] = cfg
        self._def: LayerDef = LAYER_REGISTRY.get(type)
        for hook in creation_hooks:
            hook(self)

    # --- config accessors used by layer implementations -------------------
    def attr(self, key: str, default=None):
        return self.cfg.get(key, default)

    def param_attr(self, i: int = 0) -> ParamAttr:
        if i < len(self.param_attrs):
            return self.param_attrs[i]
        return ParamAttr()

    def bias_param_attr(self) -> Optional[ParamAttr]:
        if self.bias_attr is False:
            return None
        if self.bias_attr in (None, True):
            return ParamAttr()
        return to_param_attr(self.bias_attr)

    # --- graph protocol ---------------------------------------------------
    def infer(self, in_infos: List[ArgInfo]) -> ArgInfo:
        return self._def.infer(self, in_infos)

    def out_info(self) -> ArgInfo:
        """The inferred output ArgInfo, from the graph up to this layer
        (cached: a graph does not change once built). Model code reads
        sizes and shapes here rather than re-deriving conv and pool
        arithmetic."""
        cached = getattr(self, "_out_info", None)
        if cached is None:
            cached = self.infer([i.out_info() for i in self.inputs])
            self._out_info = cached
        return cached

    def param_specs(self, in_infos: List[ArgInfo]) -> Dict[str, ParamSpec]:
        if self._def.params is None:
            return {}
        return self._def.params(self, in_infos)

    def forward(self, params: Dict[str, torch.Tensor], ins: List[Arg],
                ctx: ForwardContext) -> Arg:
        out = self._def.forward(self, params, ins, ctx)
        dropout = bool(self.extra.drop_rate) and ctx.training
        if self.act is not None:
            if self.act.name == "softmax" and not dropout:
                # pre-softmax logits for a downstream cross-entropy cost,
                # which then takes the stable log-softmax form
                # (layers/cost.py); '#' keeps the key apart from the
                # ':'-named extras of the layers. A dropout between the
                # softmax and the cost blocks it.
                ctx.extras[f"{self.name}#logits"] = out
            out = out.with_value(self.act.apply(out.value, out.mask))
        if dropout:
            keep = 1.0 - self.extra.drop_rate
            gen = ctx.generator()
            draw = torch.rand(out.value.shape, generator=gen,
                              device=gen.device)
            out = out.with_value(torch.where(
                draw.to(out.value.device) < keep, out.value / keep,
                torch.zeros_like(out.value)))
        return out

    def __repr__(self):
        return f"<Layer {self.name} type={self.type} size={self.size}>"


def param_name(layer_name: str, suffix: str, attr: ParamAttr) -> str:
    """Reference naming convention: _layer.w0 / _layer.wbias
    (config_parser.py parameter naming)."""
    return attr.name or f"_{layer_name}.{suffix}"
