"""Topology: extract the subgraph feeding given outputs and run it
(counterpart of ``paddle_tpu/core/topology.py``; analog of
python/paddle/v2/topology.py and gserver's NeuralNetwork topological
execution). PyTorch runs each layer's forward eagerly, in topological
order; training differentiates ``loss_fn``'s scalar with autograd.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch

from paddle_tpu_torch.core.arg import Arg, ArgInfo, as_arg
from paddle_tpu_torch.core.layer import (ForwardContext, Layer, ParamSpec,
                                         param_name)
from paddle_tpu_torch.utils.error import enforce


def topology_from_config(d: dict) -> "Topology":
    """Rebuild a runnable Topology from ``Topology.serialize()`` output
    (either package's: the format is shared). Parameter names are
    restored by binding explicit ParamAttr names wherever the serialized
    name differs from the default ``_<layer>.<suffix>`` convention."""
    from paddle_tpu_torch.attr import ParamAttr
    from paddle_tpu_torch.data_type import InputType

    enforce(d.get("format", "").startswith("paddle_tpu.model_config"),
            "not a serialized paddle_tpu model config")
    by_name: Dict[str, Layer] = {}
    for le in d["layers"]:
        cfg = dict(le.get("cfg") or {})
        it = cfg.pop("input_type", None)
        if isinstance(it, dict):
            dtype = torch.int32 if it["kind"] in ("index", "sparse_binary") \
                else torch.float32
            cfg["input_type"] = InputType(it["dim"], it["seq_type"],
                                          it["kind"], dtype, it.get("max_ids"))
        # JSON turns tuples into lists; shape-ish cfg values must be tuples
        cfg = {k: (tuple(v) if isinstance(v, list) else v)
               for k, v in cfg.items()}
        param_attrs: List[ParamAttr] = []
        bias_attr = None if le.get("bias", True) else False
        for suffix, pname in (le.get("param_names") or {}).items():
            if pname == f"_{le['name']}.{suffix}":
                continue
            if suffix == "wbias":
                bias_attr = ParamAttr(name=pname)
            elif suffix.startswith("w") and suffix[1:].isdigit():
                i = int(suffix[1:])
                while len(param_attrs) <= i:
                    param_attrs.append(ParamAttr())
                param_attrs[i] = ParamAttr(name=pname)
        inputs = [by_name[n] for n in le["inputs"]]
        lay = Layer(le["type"], inputs, name=le["name"], size=le["size"],
                    act=le["act"], param_attrs=param_attrs or None,
                    bias_attr=bias_attr, **cfg)
        by_name[le["name"]] = lay
    return Topology([by_name[n] for n in d["outputs"]])


# layer types whose value comes from feeds, not computation ("data" for the
# outer graph; "step_input"/"memory" inside recurrent groups)
FEED_TYPES = frozenset({"data", "step_input", "memory"})


class Topology:
    def __init__(self, outputs: Union[Layer, Sequence[Layer]]):
        if isinstance(outputs, Layer):
            outputs = [outputs]
        self.outputs: List[Layer] = list(outputs)
        self.layers: List[Layer] = self._topo_sort(self.outputs)
        self.layer_map: Dict[str, Layer] = {l.name: l for l in self.layers}
        enforce(len(self.layer_map) == len(self.layers),
                "duplicate layer names in topology")
        self.data_layers: List[Layer] = [l for l in self.layers
                                         if l.type == "data"]
        self._infos: Dict[str, ArgInfo] = {}
        self._param_specs: Dict[str, ParamSpec] = {}
        self._layer_params: Dict[str, Dict[str, str]] = {}
        self._infer_all()

    @staticmethod
    def _topo_sort(outputs: Sequence[Layer]) -> List[Layer]:
        """DFS from outputs (the v2 __get_used_layers__ analog);
        post-order = valid topo order."""
        seen, order = set(), []

        def visit(l: Layer):
            if id(l) in seen:
                return
            seen.add(id(l))
            for i in l.inputs:
                visit(i)
            order.append(l)

        for o in outputs:
            visit(o)
        return order

    def _infer_all(self):
        for l in self.layers:
            in_infos = [self._infos[i.name] for i in l.inputs]
            self._infos[l.name] = l.infer(in_infos)
            specs = l.param_specs(in_infos)
            self._layer_params[l.name] = {}
            for suffix, spec in specs.items():
                pname = param_name(l.name, suffix, spec.attr)
                self._layer_params[l.name][suffix] = pname
                if pname in self._param_specs:
                    # shared parameter: shapes must agree
                    enforce(self._param_specs[pname].shape == spec.shape,
                            f"shared parameter {pname} shape mismatch: "
                            f"{self._param_specs[pname].shape} vs {spec.shape}")
                else:
                    self._param_specs[pname] = spec

    # --- public query ----------------------------------------------------
    def info(self, layer: Union[str, Layer]) -> ArgInfo:
        name = layer if isinstance(layer, str) else layer.name
        return self._infos[name]

    def param_specs(self) -> Dict[str, ParamSpec]:
        return dict(self._param_specs)

    def layer_params(self, layer: Union[str, Layer]) -> Dict[str, str]:
        """{suffix: parameter name} of one layer."""
        name = layer if isinstance(layer, str) else layer.name
        return dict(self._layer_params[name])

    def layer_param_map(self, layer_name: str) -> Dict[str, str]:
        """{suffix: parameter name} of one layer, under the JAX package's
        name (``quant.quantizable_params`` reads it)."""
        return self.layer_params(layer_name)

    def data_type(self):
        """[(name, InputType-or-ArgInfo)] for data layers — the
        DataFeeder's input (v2 Topology.data_type analog)."""
        out = []
        for l in self.data_layers:
            itype = l.attr("input_type")
            out.append((l.name, itype if itype is not None
                        else self._infos[l.name]))
        return out

    def forward(self, params: Dict[str, torch.Tensor],
                feeds: Dict[str, object], training: bool = False,
                generator: Optional[torch.Generator] = None,
                return_ctx: bool = False,
                sparse_rows: Optional[Dict[str, tuple]] = None):
        """Run every layer once in topological order.

        feeds: {feed_layer_name: Arg | tensor | (value, mask)}.
        ``training`` turns dropout on, drawing from ``generator``.
        ``sparse_rows`` (a dict) turns the sparse-row gradient protocol on
        (core/layer.py ForwardContext). Returns every layer's output Arg
        keyed by layer name (plus the ForwardContext when ``return_ctx``,
        whose ``extras`` hold aux results such as beam search's ids and
        scores)."""
        ctx = ForwardContext(training=training, generator=generator,
                             sparse_rows=sparse_rows)
        for l in self.layers:
            if l.type in FEED_TYPES:
                enforce(l.name in feeds,
                        f"missing feed for data layer {l.name!r}")
                ctx.outputs[l.name] = as_arg(feeds[l.name])
                continue
            lparams = {suffix: params[pname]
                       for suffix, pname in self._layer_params[l.name].items()}
            ins = [ctx.outputs[i.name] for i in l.inputs]
            ctx.layer_param_names = self._layer_params[l.name]
            try:
                ctx.outputs[l.name] = l.forward(lparams, ins, ctx)
            except Exception as e:
                # say where in the MODEL the forward died
                e.add_note(f"while computing layer {l.name!r} "
                           f"(type {l.type!r}, inputs "
                           f"{[i.name for i in l.inputs]})")
                raise
        if return_ctx:
            return ctx.outputs, ctx
        return ctx.outputs

    # --- training ---------------------------------------------------------
    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
        """Materialize every parameter from its attributes (initializer.
        init_array), in name order, drawing from ``generator`` (a CPU
        torch.Generator; default: seeded with 1)."""
        from paddle_tpu_torch.initializer import init_array

        if generator is None:
            generator = torch.Generator().manual_seed(1)
        params = {}
        for pname, spec in sorted(self._param_specs.items()):
            enforce(not spec.attr.host_resident,
                    f"parameter {pname!r}: host-resident tables are not "
                    "ported yet")
            params[pname] = init_array(generator, spec.shape, spec.attr,
                                       spec.fan_in, spec.dtype, spec.is_bias)
        return params

    def static_map(self) -> Dict[str, bool]:
        """Which parameters are frozen w.r.t. gradients (is_static)."""
        return {n: s.attr.is_static for n, s in self._param_specs.items()}

    def lr_mults(self) -> Dict[str, float]:
        return {n: s.attr.learning_rate for n, s in self._param_specs.items()
                if s.attr.learning_rate != 1.0}

    def loss_fn(self, cost_layer: Optional[Union[str, Layer]] = None):
        """loss(params, feeds, generator=None, training=True,
        sparse_rows=None) -> (scalar, outputs): the sum over the cost
        layers (the topology's outputs, or ``cost_layer``) of sum(cost) /
        B, in float32. ``sparse_rows`` (a dict) turns the sparse-row
        gradient protocol on and receives what the gathers record;
        ``loss._sparse_capable`` says whether any parameter has
        ``sparse_update``. Packed feeds (rows holding several sequences)
        are not ported and raise: a feed that carries seg_ids into a plain
        sequence data layer. Nested (SUB_SEQUENCE) feeds carry them too,
        marking the sub-sequences of one sample, and train (the JAX
        package's ``_feeds_packed``)."""
        if cost_layer is not None:
            cost_names = [cost_layer if isinstance(cost_layer, str)
                          else cost_layer.name]
        else:
            cost_names = [o.name for o in self.outputs]
        # the data layers whose seg_ids would mean packing
        unnested = [l.name for l in self.data_layers
                    if not getattr(l.attr("input_type"), "is_nested", False)]

        def loss(params, feeds, generator=None, training=True,
                 sparse_rows=None):
            for n in unnested:
                a = feeds.get(n)
                enforce(not (isinstance(a, Arg) and a.mask is not None
                             and a.seg_ids is not None),
                        f"feed {n!r} is sequence-packed: packing is not "
                        "ported yet")
            outs = self.forward(params, feeds, training=training,
                                generator=generator, sparse_rows=sparse_rows)
            total = None
            for cn in cost_names:
                v = outs[cn].value
                term = v.sum() / v.shape[0]           # mean over the batch
                total = term if total is None else total + term
            return total, outs

        # the train step skips the protocol for a model without
        # sparse_update parameters
        loss._sparse_capable = any(s.attr.sparse_update
                                   for s in self._param_specs.values())
        return loss

    def serialize(self) -> dict:
        """JSON-able model config, in the JAX package's format: it
        round-trips through either package's ``topology_from_config``."""
        def layer_entry(l: Layer) -> dict:
            cfg = {k: v for k, v in l.cfg.items()
                   if isinstance(v, (int, float, str, bool, list, tuple,
                                     type(None)))}
            it = l.cfg.get("input_type")
            if it is not None:
                cfg["input_type"] = {"dim": it.dim, "seq_type": it.seq_type,
                                     "kind": it.kind, "max_ids": it.max_ids}
            return {"name": l.name, "type": l.type, "size": l.size,
                    "inputs": [i.name for i in l.inputs],
                    "act": l.act.name if l.act is not None else None,
                    "bias": (False if l.bias_attr is False else True),
                    "param_names": dict(self._layer_params[l.name]),
                    "cfg": cfg}

        return {
            "format": "paddle_tpu.model_config.v1",
            "layers": [layer_entry(l) for l in self.layers],
            "outputs": [o.name for o in self.outputs],
            "params": {n: {"shape": list(s.shape), "is_bias": s.is_bias,
                           "is_static": s.attr.is_static}
                       for n, s in self._param_specs.items()},
        }
