"""The decode's per-tick step export (counterpart of
``paddle_tpu/io/merged_model.py`` ``_input_specs`` and
``export_decode_step_stablehlo_ex``).

``export_decode_step_ex`` hands a continuous-batching scheduler
(step_decode.py) the decode's transition on its own, with the JAX
export's signature: an ``init`` run once per admission and a ``step`` run
once per tick over the whole slot array. Where the JAX package serializes
StableHLO modules, the port returns ``init`` and ``step`` objects whose
``call(*flat)`` runs ``BeamStepExport`` on the device, the parameters
moved there (and their transposed tables laid out) once. The rest of the
JAX module (bundles, their meta, serialized artifacts) is not ported.
"""

from __future__ import annotations

from typing import Union

import torch

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.parameters import Parameters
from paddle_tpu_torch.core.topology import Topology
from paddle_tpu_torch.data_type import InputType, SeqType
from paddle_tpu_torch.utils.device import resolve_device

# the static sequence length a padded, masked sequence feed is exported at
# unless the caller gives one (the JAX package's default)
EXPORT_SEQ_LEN = 16
# the slot batch of a step export unless the caller gives one
DECODE_EXPORT_SLOTS = 8

_TAGS = {torch.float32: "f32", torch.int32: "i32", torch.int64: "i64",
         torch.float64: "f64", torch.bool: "pred", torch.uint8: "u8"}
DTYPES = {tag: dt for dt, tag in _TAGS.items()}


def _input_specs(topology: Topology, seq_len):
    """Typed feed signature of an inference topology: one entry per
    argument, in feed order, value before mask. Returns (specs, None) or
    (None, skip_reason). Each spec: {feed, role: value|mask, name, dtype:
    f32|i32, shape: ['b', ...]}; ``seq_len`` an int or {feed: int}."""
    specs = []
    for d in topology.data_layers:
        it = d.attr("input_type")
        T = seq_len.get(d.name, EXPORT_SEQ_LEN) \
            if isinstance(seq_len, dict) else seq_len
        if it is None or not isinstance(it, InputType):
            specs.append({"feed": d.name, "role": "value", "name": d.name,
                          "dtype": "f32", "shape": ["b", int(d.size)]})
            continue
        if it.kind in ("sparse_binary", "sparse_value"):
            return None, (f"data layer {d.name!r}: sparse feed kind "
                          f"{it.kind!r} has no servable export form yet")
        if it.seq_type == SeqType.SUB_SEQUENCE:
            return None, (f"data layer {d.name!r}: nested SUB_SEQUENCE "
                          "feeds are not exportable (ragged sub-seqs)")
        if it.seq_type == SeqType.NO_SEQUENCE:
            # the feeder's shapes: ids [B, 1] int32, dense [B, dim]
            index = it.kind == "index"
            specs.append({"feed": d.name, "role": "value", "name": d.name,
                          "dtype": "i32" if index else "f32",
                          "shape": ["b", 1 if index else int(d.size)]})
            continue
        # a plain sequence: padded value and float32 mask at a static T
        index = it.kind == "index"
        specs.append({"feed": d.name, "role": "value", "name": d.name,
                      "dtype": "i32" if index else "f32",
                      "shape": ["b", int(T)] if index
                      else ["b", int(T), int(d.size)]})
        specs.append({"feed": d.name, "role": "mask",
                      "name": d.name + ":mask", "dtype": "f32",
                      "shape": ["b", int(T)]})
    if not specs:
        return None, "topology has no data layers"
    return specs, None


class StepModule:
    """Stands where the JAX export has a serialized module: ``call(*flat)``
    runs ``fn`` on the flat tensors, without autograd, and returns a
    tuple of tensors on the device."""

    def __init__(self, fn):
        self._fn = fn

    def call(self, *flat):
        with torch.no_grad():
            return self._fn(*flat)


def export_decode_step_ex(topology: Topology, parameters: Parameters,
                          slots=None, seq_len=None,
                          device: Union[str, torch.device] = "cuda"):
    """The per-tick decode step of a generation topology, for a scheduler
    that admits requests into free slots mid-decode (the JAX
    ``export_decode_step_stablehlo_ex``'s signature):

      init  (topology feeds at the slot batch) -> (slot state at tick 0,
            per-slot encoder state): once per admission;
      step  (slot state, encoder state) -> (slot state', emitted, done):
            once per tick over the whole slot array.

    Returns ``(result, None)`` or ``(None, skip_reason)``. ``result``
    holds ``signature`` (``slots``, ``beam``, ``max_length``, ``eos_id``,
    ``bos_id``, ``inputs``, ``state``, ``enc``, ``extra_outputs``,
    ``init_outputs``, ``step_inputs``, ``step_outputs``; ``"b"`` in the
    slot dimension), ``slots``, ``device`` and the ``init`` and ``step``
    StepModules. The parameters go to ``device`` once, their transposed
    tables laid out once; the export runs init once to learn the state's
    shapes. The JAX export's 32 MiB limit on parameters embedded as
    module constants does not apply: nothing is embedded."""
    from paddle_tpu_torch.layers.misc import transposed_tables
    from paddle_tpu_torch.layers.recurrent_group import (
        BeamStepExport, beam_step_unsupported)

    seq_len = EXPORT_SEQ_LEN if seq_len is None else seq_len
    slots = DECODE_EXPORT_SLOTS if slots is None else int(slots)
    device = resolve_device(device)

    reason = beam_step_unsupported(topology)
    if reason is not None:
        return None, reason
    in_specs, reason = _input_specs(topology, seq_len)
    if in_specs is None:
        return None, reason
    pspecs = topology.param_specs()
    missing = sorted(set(pspecs) - set(parameters.names()))
    if missing:
        return None, f"parameters missing for export: {missing}"
    ex = BeamStepExport(topology)
    params = transposed_tables(
        ex.inner.topology,
        {k: parameters.get(k).to(device) for k in pspecs})

    def feeds_from_flat(flat):
        vals = dict(zip((s["name"] for s in in_specs), flat))
        return {s["feed"]: Arg(vals[s["name"]], vals.get(s["feed"] + ":mask"))
                for s in in_specs if s["role"] == "value"}

    def dims(shape, b):
        return tuple(b if d == "b" else int(d) for d in shape)

    try:
        with torch.no_grad():
            probe = ex.init_fn(params, feeds_from_flat(
                [torch.zeros(dims(s["shape"], slots),
                             dtype=DTYPES[s["dtype"]], device=device)
                 for s in in_specs]))
    except Exception as e:  # noqa: BLE001 - an encoder that fails: say why
        return None, f"decode init does not run for step export: {e}"

    state_names = ex.state_names()
    enc_names = []
    for i in range(ex.n_static):
        enc_names.append(f"enc:{i}")
        if f"enc:{i}:mask" in probe:
            enc_names.append(f"enc:{i}:mask")
    init_out_names = state_names + enc_names
    step_out_names = state_names + ["emitted", "done"]

    def entry(name, t):
        return {"name": name, "dtype": _TAGS[t.dtype],
                "shape": ["b"] + list(t.shape[1:])}

    def init_flat(*flat):
        named = ex.init_fn(params, feeds_from_flat(flat))
        return tuple(named[n] for n in init_out_names)

    def step_flat(*flat):
        out = ex.step_fn(params, dict(zip(init_out_names, flat)))
        return tuple(out[n] for n in step_out_names)

    slot_vec = torch.zeros(slots, dtype=torch.int32)
    sig = {"slots": slots, "beam": int(ex.beam),
           "max_length": int(ex.max_len), "eos_id": int(ex.eos_id),
           "bos_id": int(ex.bos_id),
           "inputs": [dict(s) for s in in_specs],
           "state": [entry(n, probe[n]) for n in state_names],
           "enc": [entry(n, probe[n]) for n in enc_names],
           "extra_outputs": [entry(n, slot_vec) for n in ("emitted", "done")],
           "init_outputs": init_out_names,
           "step_inputs": init_out_names,
           "step_outputs": step_out_names}
    return {"init": StepModule(init_flat), "step": StepModule(step_flat),
            "signature": sig, "slots": slots, "device": device}, None
