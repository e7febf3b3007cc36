"""Recurrent group: a step sub-network run over time, with memory links,
and beam-search generation (counterpart of
``paddle_tpu/layers/recurrent_group.py``; analog of
paddle/gserver/gradientmachines/RecurrentGradientMachine.cpp).

The step function is traced ONCE into a sub-Topology; PyTorch then runs it
eagerly once per tick, the memories being the carry between ticks.

- ``memory(name, size, boot_layer)``: reads the previous tick's value of
  the same-named inner layer.
- ``recurrent_group(step, input)``: sequence inputs are scattered one step
  per tick; a StaticInput is visible whole at every tick (attention over
  the encoder); outputs are gathered back into a sequence. A
  SubsequenceInput (a nested input) still ticks per step, and every memory
  starts again from its boot value at each of its sub-sequences. This is the
  teacher-forced form, for scoring and for training: the step runs with
  the outer forward's ``training`` flag and generator (a dropout inside
  the step drops when training), and the gradient is autograd's across
  the tick loop, into the memories, their boot layers and the
  StaticInput sequences.
- ``beam_search(step, input, ...)``: generation with dense [B*beam, ...]
  state tensors, early exit and the closed-form completion of the JAX
  package, bit for bit in the ids. A step that ends in a compact-output
  ``selective_fc`` scores the beam in candidate space (compact-K).

- ``BeamStepExport``: the decode's init and per-tick step as functions
  over a named slot state (each slot carries its own tick counter and
  cap), for continuous batching (io/merged_model.py
  ``export_decode_step_ex``, step_decode.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from paddle_tpu_torch.attr import ParamAttr
from paddle_tpu_torch.core.arg import Arg, ArgInfo
from paddle_tpu_torch.core.layer import Layer, ParamSpec, register_layer
from paddle_tpu_torch.layers.misc import transposed_tables
from paddle_tpu_torch.utils.error import enforce

# the finite -inf of the beam scores, kept as the JAX package writes it
NEG = -1e30


# feed-type node registrations (values come from the group's driver, never
# computed: Topology treats FEED_TYPES specially)

def _feed_infer(cfg, in_infos):
    return ArgInfo(size=cfg.size or 0, is_seq=bool(cfg.attr("src_is_seq")))


@register_layer("step_input", infer=_feed_infer)
def _step_input_forward(cfg, params, ins, ctx):
    raise RuntimeError("step_input is fed by the recurrent-group driver")


@register_layer("memory", infer=_feed_infer)
def _memory_forward(cfg, params, ins, ctx):
    raise RuntimeError("memory is fed by the recurrent-group driver")


# --- user-facing input wrappers ------------------------------------------

@dataclasses.dataclass
class StaticInput:
    """Input visible in full at every tick (hands the encoder sequence to
    attention inside the step)."""

    input: Layer
    is_seq: bool = True


@dataclasses.dataclass
class GeneratedInput:
    """Generation-mode input: the step receives the previous tick's
    generated token embedding."""

    size: int                 # vocab size
    embedding_name: str       # parameter name of the embedding table
    embedding_size: int
    bos_id: int = 0
    eos_id: int = 1


@dataclasses.dataclass
class SubsequenceInput:
    """Nested-sequence input marker: the group ticks per step over the
    wrapped input, and every memory resets to its boot value at each
    sub-sequence start (a seg_ids transition), which gives the reference's
    fresh inner frame per sub-sequence."""

    input: Layer


@dataclasses.dataclass
class BeamSearchControlCallbacks:
    """Generation control hooks over the dense beam state.

    - candidate_adjust(t, logp [B*beam, V], state) -> logp: rewrite the
      per-tick candidate log-probs before top-k. In a compact-K decode
      logp is [B*beam, K] and ``state["cand_ids"]`` maps its slots to
      vocab ids (-1 on dead slots).
    - norm_or_drop(ids [B, beam, L], scores [B, beam], lengths [B, beam])
      -> scores: rescore or drop finished hypotheses before the best beam
      is chosen.
    """

    candidate_adjust: Optional[Callable] = None
    norm_or_drop: Optional[Callable] = None


class _MemorySpec:
    def __init__(self, name, size, boot_layer=None,
                 boot_with_const_value=None):
        self.name = name
        self.size = size
        self.boot_layer = boot_layer
        self.boot_with_const_value = boot_with_const_value


# step-trace context: collects memory() declarations while the user step fn
# runs
_current_trace: List = []


def memory(name: str, size: int, boot_layer: Optional[Layer] = None,
           boot_with_const_value: Optional[float] = None, **kw) -> Layer:
    """Declare a recurrent memory: returns a feed node whose value is the
    previous tick's output of the inner layer called ``name``."""
    enforce(_current_trace, "memory() may only be called inside a "
            "recurrent_group step function")
    spec = _MemorySpec(name, size, boot_layer, boot_with_const_value)
    node = Layer("memory", [], name=f"@mem:{name}", size=size)
    node.cfg["memory_of"] = name
    _current_trace[-1]["memories"].append((spec, node))
    return node


class _InnerGraph:
    """Traced step sub-network + bookkeeping."""

    def __init__(self, step: Callable, inputs: Sequence,
                 generating: bool = False,
                 gen_input: Optional[GeneratedInput] = None):
        from paddle_tpu_torch.core import layer as core_layer
        from paddle_tpu_torch.core.topology import Topology

        def out_size(l: Layer) -> int:
            return Topology(l).info(l).size

        self.seq_inputs: List[Layer] = []       # outer sequence layers
        self.static_inputs: List[StaticInput] = []
        self.gen_input = gen_input
        self.nested = False                     # any SubsequenceInput?
        self.nested_idx = -1                    # its index in seq_inputs
        placeholders = []
        self.ph_names: List[str] = []

        for item in inputs:
            if isinstance(item, SubsequenceInput):
                self.nested = True
                self.nested_idx = len(self.seq_inputs)
                item = item.input       # scattered per step like a sequence
            if isinstance(item, StaticInput):
                ph = Layer("step_input", [],
                           name=f"@static:{item.input.name}",
                           size=out_size(item.input))
                ph.cfg["static"] = True
                ph.cfg["src_is_seq"] = item.is_seq
                self.static_inputs.append(item)
            elif isinstance(item, GeneratedInput):
                enforce(generating, "GeneratedInput requires generation mode")
                ph = Layer("step_input", [], name="@gen:token",
                           size=item.embedding_size)
            else:  # sequence layer scattered per step
                ph = Layer("step_input", [], name=f"@step:{item.name}",
                           size=out_size(item))
                self.seq_inputs.append(item)
            placeholders.append(ph)
            self.ph_names.append(ph.name)

        created: List[Layer] = []
        core_layer.creation_hooks.append(created.append)
        _current_trace.append({"memories": []})
        try:
            out = step(*placeholders)
        finally:
            trace = _current_trace.pop()
            core_layer.creation_hooks.remove(created.append)
        self.memories: List[tuple] = trace["memories"]
        self.outputs: List[Layer] = out if isinstance(out, (list, tuple)) \
            else [out]
        # memory targets that are not step outputs must still be in the
        # inner topology so each tick can read them: add them as roots
        out_names = {o.name for o in self.outputs}
        extra = []
        for spec, node in self.memories:
            if spec.name not in out_names:
                target = next((l for l in created if l.name == spec.name),
                              None)
                if target is not None:
                    extra.append(target)
        self.topology = Topology(list(self.outputs) + extra)
        for spec, node in self.memories:
            enforce(spec.name in self.topology.layer_map,
                    f"memory({spec.name!r}): no inner layer with that name")

    def param_specs(self) -> Dict[str, ParamSpec]:
        # re-key inner params by their full name so outer naming == inner
        # naming (attr.name makes param_name return it verbatim)
        out = {}
        for pname, spec in self.topology.param_specs().items():
            attr = dataclasses.replace(spec.attr, name=pname)
            out[pname] = ParamSpec(spec.shape, attr, spec.fan_in,
                                   spec.is_bias, spec.dtype)
        return out

    def boot_values(self, boot_args: Sequence[Arg], rows: int,
                    like: torch.Tensor, tile=None) -> Dict[str, torch.Tensor]:
        """Each memory's value before the first tick: its boot layer's
        value (tiled per hypothesis by ``tile``), a constant, or zeros."""
        carry0 = {}
        boot_i = 0
        for spec, node in self.memories:
            if spec.boot_layer is not None:
                v = boot_args[boot_i].value
                carry0[spec.name] = tile(v) if tile is not None else v
                boot_i += 1
            elif spec.boot_with_const_value is not None:
                carry0[spec.name] = like.new_full(
                    (rows, spec.size), float(spec.boot_with_const_value))
            else:
                carry0[spec.name] = like.new_zeros(rows, spec.size)
        return carry0


# --- static (given-sequence) recurrent group -----------------------------

def _group_infer(cfg, in_infos):
    inner: _InnerGraph = cfg.attr("inner")
    info = inner.topology.info(inner.outputs[0])
    return ArgInfo(size=info.size, is_seq=True, is_nested=inner.nested)


def _group_params(cfg, in_infos):
    return cfg.attr("inner").param_specs()


@register_layer("recurrent_layer_group", infer=_group_infer,
                params=_group_params)
def _recurrent_group_forward(cfg, params, ins: List[Arg], ctx) -> Arg:
    inner: _InnerGraph = cfg.attr("inner")
    reverse = cfg.attr("reverse", False)
    n_seq = len(inner.seq_inputs)
    n_static = len(inner.static_inputs)
    seq_args = ins[:n_seq]
    static_args = ins[n_seq:n_seq + n_static]
    boot_args = ins[n_seq + n_static:]

    enforce(n_seq >= 1, "recurrent_group needs at least one sequence input")
    x0 = seq_args[0].value
    B, T = x0.shape[0], x0.shape[1]
    mask = seq_args[0].mask
    carry0 = inner.boot_values(boot_args, B, x0)
    carry = dict(carry0)
    seg = None
    if inner.nested:
        # the wrapped input's sub-sequences: a start is a step whose seg id
        # differs from the step before's (-2 before the first)
        seg = seq_args[inner.nested_idx].seg_ids
        enforce(seg is not None,
                "SubsequenceInput needs a nested input (no seg_ids on "
                f"{inner.seq_inputs[inner.nested_idx].name!r}; declare it "
                "with a *_sub_sequence data type)")
        enforce(not reverse,
                "nested recurrent_group does not support reverse=True")
        prev = torch.cat([torch.full_like(seg[:, :1], -2), seg[:, :-1]], 1)
        is_start = (seg != prev) & (seg >= 0)
    seq_ph = [n for n in inner.ph_names if n.startswith("@step:")]
    static_ph = [n for n in inner.ph_names if n.startswith("@static:")]

    ys: List[Optional[torch.Tensor]] = [None] * T
    for t in (reversed(range(T)) if reverse else range(T)):
        feeds = {name: Arg(a.value[:, t]) for name, a in zip(seq_ph, seq_args)}
        feeds.update(zip(static_ph, static_args))   # the whole arg each tick
        for spec, node in inner.memories:
            mem = carry[spec.name]
            if seg is not None:         # a sub-sequence starts: boot value
                mem = torch.where(is_start[:, t, None], carry0[spec.name],
                                  mem)
            feeds[node.name] = Arg(mem)
        # the outer forward's training flag and generator, as the JAX
        # package's scan step passes them on (its rng)
        outs = inner.topology.forward(params, feeds, training=ctx.training,
                                      generator=ctx._generator)
        m = mask[:, t, None].to(x0.dtype)
        for spec, node in inner.memories:
            # padding steps keep the previous memory
            carry[spec.name] = m * outs[spec.name].value \
                + (1 - m) * carry[spec.name]
        ys[t] = outs[inner.outputs[0].name].value
    out = torch.stack(ys, 1)                                   # [B, T, D]
    return Arg(out * mask[..., None].to(out.dtype), mask, seg)


def recurrent_group(step: Callable, input, name: Optional[str] = None,
                    reverse: bool = False) -> Layer:
    """paddle.layer.recurrent_group analog (training/scoring mode)."""
    inputs = input if isinstance(input, (list, tuple)) else [input]
    inner = _InnerGraph(step, inputs)
    outer_ins = list(inner.seq_inputs) + [s.input for s in
                                          inner.static_inputs]
    for spec, node in inner.memories:
        if spec.boot_layer is not None:
            outer_ins.append(spec.boot_layer)
    return Layer("recurrent_layer_group", outer_ins, name=name,
                 size=inner.topology.info(inner.outputs[0]).size,
                 inner=inner, reverse=reverse)


# --- beam-search generation ----------------------------------------------

def _beam_infer(cfg, in_infos):
    return ArgInfo(size=1, is_seq=True, dtype=torch.int32)


def _beam_params(cfg, in_infos):
    inner: _InnerGraph = cfg.attr("inner")
    specs = inner.param_specs()
    gen = inner.gen_input
    # the generated-token embedding table: shared by name with the scoring
    # graph's embedding layer (the topology dedups shared parameter names)
    specs[gen.embedding_name] = ParamSpec(
        (gen.size, gen.embedding_size),
        ParamAttr(name=gen.embedding_name), fan_in=gen.embedding_size)
    return specs


def _top_k(x: torch.Tensor, k: int):
    """Top k along the last dim with jax.lax.top_k's tie order: equal
    values come lowest index first. torch.topk promises no order among
    ties, and the beam's bit-identical completion depends on it (many
    candidates tie at the -1e30 sentinel), so this takes a stable
    descending sort."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class _BeamProgram:
    """The beam-search decode program: initial state, the per-tick
    transition and the closed-form completion once every hypothesis is
    dead (the JAX package's ``_BeamProgram``), shared by the whole loop
    (``_beam_search_forward``) and the per-tick step (``BeamStepExport``).

    ``one_step`` takes the tick ``t`` as an int (the whole loop: every
    sample at the same tick) or as a [B] int32 tensor (a slot batch whose
    slots were admitted at different ticks); ``completion`` takes ints or
    [B] tensors for ``ticks`` and ``done``. The integer writes are exact
    either way, so the two forms agree bit for bit when the counters are
    uniform."""

    def __init__(self, cfg, params, static_args: Sequence[Arg], B: int):
        inner: _InnerGraph = cfg.attr("inner")
        self.inner = inner
        self.gen = inner.gen_input
        self.beam = cfg.attr("beam_size", 1)
        self.max_len = cfg.attr("max_length", 25)
        self.ctrl: Optional[BeamSearchControlCallbacks] = \
            cfg.attr("ctrl_callbacks")
        self.eos_id = self.gen.eos_id
        self.bos_id = self.gen.bos_id
        self.out_layer = inner.outputs[0]
        self.compact = (self.out_layer.type == "selective_fc"
                        and bool(self.out_layer.attr("compact_output")))
        # the step runs max_len times: tables it reads transposed are laid
        # out so once a decode (no copy where they already are)
        self.params = transposed_tables(inner.topology, params)
        self.B = B
        self.BK = B * self.beam
        # static inputs replicated per hypothesis
        self.static_tiled = [
            Arg(self.tile_beam(a.value),
                None if a.mask is None else self.tile_beam(a.mask))
            for a in static_args]
        self.table = params[self.gen.embedding_name]
        self.static_ph = [n for n in inner.ph_names
                          if n.startswith("@static:")]

    def tile_beam(self, v):
        # jnp.repeat(v, beam, axis=0): each row `beam` times in a row,
        # which is repeat_interleave (Tensor.repeat would tile the batch)
        return torch.repeat_interleave(v, self.beam, dim=0)

    def init_state(self, boot_args: Sequence[Arg]) -> Dict:
        BK, beam = self.BK, self.beam
        dev = self.table.device
        # only hypothesis 0 of each sample is live at t=0 (all beams start
        # identical otherwise); the others score -1e30, in float32
        scores = torch.full((BK,), NEG, dtype=torch.float32, device=dev)
        scores[::beam] = 0.0
        return {
            "carry": self.inner.boot_values(boot_args, BK, self.table,
                                            self.tile_beam),
            "tokens": torch.full((BK,), self.bos_id, dtype=torch.int32,
                                 device=dev),
            "scores": scores,
            "alive": torch.ones((BK,), dtype=torch.float32, device=dev),
            "ids": torch.zeros((BK, self.max_len), dtype=torch.int32,
                               device=dev),
        }

    def one_step(self, state, t):
        inner, beam, B = self.inner, self.beam, self.B
        eos_id, ctrl = self.eos_id, self.ctrl
        feeds = {"@gen:token": Arg(self.table[state["tokens"].long()])}
        feeds.update(zip(self.static_ph, self.static_tiled))
        for spec, node in inner.memories:
            feeds[node.name] = Arg(state["carry"][spec.name])
        outs, ictx = inner.topology.forward(self.params, feeds,
                                            return_ctx=True)
        # [BK, V], or [BK, K] in candidate space (compact)
        probs = outs[self.out_layer.name].value
        logp = torch.log(torch.clamp(probs, min=1e-20))
        width = logp.shape[-1]
        if self.compact:
            # per-slot vocab ids as the projection used them, -1 on dead
            # slots (pads, later duplicates); the hook sees candidate space
            cand_ids = ictx.extras["selfc_compact"][self.out_layer.name]
            if ctrl is not None and ctrl.candidate_adjust is not None:
                logp = ctrl.candidate_adjust(t, logp,
                                             dict(state, cand_ids=cand_ids))
            logp = torch.where(cand_ids >= 0, logp, NEG)
            # a dead hypothesis extends only with its eos slot
            dead_logp = torch.where(cand_ids == eos_id, 0.0, NEG)
        else:
            if ctrl is not None and ctrl.candidate_adjust is not None:
                logp = ctrl.candidate_adjust(t, logp, state)
            # dead hypotheses only extend with eos at no cost: one [V] row
            # broadcast into the where
            dead_logp = torch.where(
                torch.arange(width, device=logp.device) == eos_id, 0.0,
                NEG).to(logp.dtype)
        logp = torch.where(state["alive"][:, None] > 0, logp, dead_logp)
        cand = state["scores"][:, None] + logp          # [BK, width]
        cand = cand.reshape(B, beam * width)
        top_scores, top_idx = _top_k(cand, beam)            # [B, beam]
        parent = top_idx // width                           # within-beam
        slot = top_idx % width
        parent_flat = (torch.arange(B, device=cand.device)[:, None] * beam
                       + parent).reshape(-1)
        if self.compact:
            # winners become vocab ids only here, at emission
            new_tokens = cand_ids.reshape(-1)[
                parent_flat * width + slot.reshape(-1)].to(torch.int32)
        else:
            new_tokens = slot.reshape(-1).to(torch.int32)
        alive = state["alive"][parent_flat]
        a = alive[:, None]
        new_carry = {}
        # memories advance only for alive hypotheses
        for spec, node in inner.memories:
            v_new = outs[spec.name].value[parent_flat]
            new_carry[spec.name] = a * v_new \
                + (1 - a) * state["carry"][spec.name][parent_flat]
        ids = state["ids"][parent_flat]
        if isinstance(t, int):
            ids[:, t] = new_tokens
        else:
            # per-slot counters: each row writes its own column; a counter
            # at or past max_len writes nothing (a free slot stays inert)
            tcol = torch.repeat_interleave(t.to(torch.int32), beam)
            steps = torch.arange(self.max_len, device=ids.device)
            ids = torch.where(steps[None, :] == tcol[:, None],
                              new_tokens[:, None], ids)
        new_alive = alive * (new_tokens != eos_id).to(torch.float32)
        return {"carry": new_carry, "tokens": new_tokens,
                "scores": top_scores.reshape(-1), "alive": new_alive,
                "ids": ids}

    def early_exit_loop(self, state):
        """The early exit as one ``while_loop`` (the form ``torch.export``
        traces, as JAX's ``lax.while_loop``): a tick runs while any
        hypothesis lives, then the closed-form completion. Its body
        traces once, and may hold no tensor constant (``torch.export.save``
        refuses one). Returns the final state and the ticks run, an int32
        tensor."""
        from torch._higher_order_ops import while_loop

        names = [spec.name for spec, _ in self.inner.memories]
        keys = ("tokens", "scores", "alive", "ids")

        def pack(st):
            return tuple(st["carry"][n].contiguous() for n in names) + \
                tuple(st[k].contiguous() for k in keys)

        def unpack(flat):
            return dict(zip(keys, flat[len(names):]),
                        carry=dict(zip(names, flat[:len(names)])))

        def cond(t, *flat):
            return (t < self.max_len) & (unpack(flat)["alive"] > 0).any()

        def body(t, *flat):
            new = self.one_step(unpack(flat), t.expand(self.B))
            return (t + 1,) + pack(new)

        t0 = torch.zeros((), dtype=torch.int32, device=state["ids"].device)
        t, *flat = while_loop(cond, body, (t0,) + pack(state))
        return self.completion(unpack(flat), t, t < self.max_len), t

    def completion(self, final, ticks, done=True):
        """Closed-form completion of the ticks the full-length loop would
        still run once every hypothesis is dead, bit for bit: the first
        all-dead tick's top-k sorts the hypotheses by score (ties lowest
        index first, as lax.top_k orders the eos slots), every later tick
        is a fixpoint, and each writes eos at its column. ``ticks`` and
        ``done`` are the whole loop's int and True, or per-sample [B]
        tensors: then only the ``done`` samples are replaced. Idempotent
        on a completed sample (sorting a sorted row moves nothing)."""
        B, beam, max_len, eos_id = self.B, self.beam, self.max_len, \
            self.eos_id
        s_sorted, perm = _top_k(final["scores"].reshape(B, beam), beam)
        perm_flat = (torch.arange(B, device=perm.device)[:, None] * beam
                     + perm).reshape(-1)
        ids = final["ids"][perm_flat]
        if isinstance(ticks, int) and done is True:
            ids[:, ticks:] = eos_id
            return dict(final, ids=ids, scores=s_sorted.reshape(-1),
                        tokens=torch.full_like(final["tokens"], eos_id))
        dev = ids.device
        rows = lambda v: torch.repeat_interleave(
            torch.as_tensor(v, device=dev).expand(B), beam)
        ticks_rows, done_rows = rows(ticks), rows(done)
        steps = torch.arange(max_len, device=dev)
        ids = torch.where(steps[None, :] >= ticks_rows[:, None], eos_id, ids)
        return dict(final,
                    ids=torch.where(done_rows[:, None], ids, final["ids"]),
                    scores=torch.where(done_rows, s_sorted.reshape(-1),
                                       final["scores"]),
                    tokens=torch.where(done_rows, eos_id, final["tokens"]))


@register_layer("beam_search", infer=_beam_infer, params=_beam_params)
def _beam_search_forward(cfg, params, ins: List[Arg], ctx) -> Arg:
    """Beam-search decode (generation analog of
    RecurrentGradientMachine::generateSequence/beamSearch).

    State tensors are [B*beam, ...]; each tick expands every live
    hypothesis over the vocab, takes top-k over (beam x vocab), reindexes
    the memories by the winning parent hypothesis, and (``early_exit``,
    the default) stops once every hypothesis has emitted eos, then
    completes the remaining ticks in closed form. ``early_exit=False``
    runs all max_length ticks. Ids [B, beam, L] and scores [B, beam] land
    in ctx.extras['<name>:ids' / ':scores'], the ticks run in ':ticks';
    the layer's output is the best beam's id sequence.

    Early exit reads ``alive.any()`` on the host every tick: on the card
    that is one device-to-host sync per tick. Traced by ``torch.export``,
    the early exit is one ``while_loop`` (``_BeamProgram.early_exit_loop``)
    and ':ticks' is an int32 tensor."""
    inner: _InnerGraph = cfg.attr("inner")
    beam = cfg.attr("beam_size", 1)
    max_len = cfg.attr("max_length", 25)
    early_exit = cfg.attr("early_exit", True)
    ctrl: Optional[BeamSearchControlCallbacks] = cfg.attr("ctrl_callbacks")

    n_static = len(inner.static_inputs)
    static_args = ins[:n_static]
    boot_args = ins[n_static:]
    B = (static_args[0].value.shape[0] if static_args else
         boot_args[0].value.shape[0])
    prog = _BeamProgram(cfg, params, static_args, B)
    eos_id = prog.eos_id
    state = prog.init_state(boot_args)

    ticks = 0
    exporting = torch.compiler.is_exporting()
    if early_exit and exporting:
        state, ticks = prog.early_exit_loop(state)
    elif early_exit:
        while ticks < max_len and bool((state["alive"] > 0).any()):
            state = prog.one_step(state, ticks)
            ticks += 1
        if ticks < max_len:
            state = prog.completion(state, ticks)
    else:
        for t in range(max_len):
            state = prog.one_step(state, t)
        ticks = max_len
    if exporting and isinstance(ticks, int):
        ticks = torch.full((), ticks, dtype=torch.int32,
                           device=state["ids"].device)
    ctx.extras[f"{cfg.name}:ticks"] = ticks

    ids = state["ids"].reshape(B, beam, max_len)
    scores = state["scores"].reshape(B, beam)
    if ctrl is not None and ctrl.norm_or_drop is not None:
        beam_eos = ids == eos_id
        beam_len = torch.where(beam_eos.any(-1),
                               beam_eos.int().argmax(-1) + 1,
                               torch.full_like(ids[..., 0], max_len))
        scores = ctrl.norm_or_drop(ids, scores, beam_len)
    ctx.extras[f"{cfg.name}:ids"] = ids
    ctx.extras[f"{cfg.name}:scores"] = scores

    n_results = min(cfg.attr("num_results_per_sample", 1), beam)
    steps = torch.arange(max_len, device=ids.device)
    if n_results > 1:
        # top-N hypotheses as ONE nested sequence per sample: value
        # [B, N*L, 1], seg_ids = result index, mask = each result's length
        order = torch.argsort(-scores, dim=-1, stable=True)[:, :n_results]
        top_ids = torch.gather(
            ids, 1, order[..., None].expand(B, n_results, max_len))
        eos_hit = top_ids == eos_id
        lengths = torch.where(eos_hit.any(-1), eos_hit.int().argmax(-1) + 1,
                              torch.full_like(order, max_len))
        mask = (steps[None, None, :] < lengths[..., None]).to(torch.float32)
        segs = torch.arange(n_results, device=ids.device)[None, :, None] \
            .expand(B, n_results, max_len)
        flat = lambda a: a.reshape(B, n_results * max_len)
        seg_ids = torch.where(flat(mask) > 0, flat(segs),
                              torch.full_like(flat(segs), -1)) \
            .to(torch.int32)
        return Arg(flat(top_ids)[..., None], flat(mask), seg_ids)

    best = torch.argmax(scores, dim=-1)                         # [B]
    best_ids = ids[torch.arange(B, device=ids.device), best]    # [B, L]
    is_eos = best_ids == eos_id
    length = torch.where(is_eos.any(-1), is_eos.int().argmax(-1) + 1,
                         torch.full_like(best, max_len))
    mask = (steps[None, :] < length[:, None]).to(torch.float32)
    return Arg(best_ids[..., None], mask)


def beam_search(step: Callable, input, bos_id: int = 0, eos_id: int = 1,
                beam_size: int = 5, max_length: int = 25,
                num_results_per_sample: int = 1,
                name: Optional[str] = None,
                ctrl_callbacks: Optional[BeamSearchControlCallbacks] = None,
                early_exit: bool = True) -> Layer:
    """paddle.layer.beam_search analog. ``input`` must contain exactly one
    GeneratedInput; step receives the previous generated token's embedding
    and must return a probability distribution over the vocab.
    ``num_results_per_sample`` > 1 returns the top-N hypotheses as one
    nested sequence per sample. ``early_exit`` ends the tick loop once
    every hypothesis has emitted eos (the same ids and scores as the
    full-length loop)."""
    inputs = input if isinstance(input, (list, tuple)) else [input]
    gen = next((i for i in inputs if isinstance(i, GeneratedInput)), None)
    enforce(gen is not None, "beam_search needs a GeneratedInput")
    inner = _InnerGraph(step, inputs, generating=True, gen_input=gen)
    outer_ins = [s.input for s in inner.static_inputs]
    for spec, node in inner.memories:
        if spec.boot_layer is not None:
            outer_ins.append(spec.boot_layer)
    return Layer("beam_search", outer_ins, name=name, inner=inner,
                 beam_size=beam_size, max_length=max_length,
                 num_results_per_sample=num_results_per_sample,
                 ctrl_callbacks=ctrl_callbacks, early_exit=early_exit)


# --- the per-tick decode step (continuous batching) -------------------------
#
# A serving scheduler that admits a new request into a slot freed in the
# middle of a decode needs the decode's transition on its own: (slot state,
# per-slot encoder state) -> (slot state', emitted token, done). These are
# those functions; the tick math is _BeamProgram's, the whole loop's.


def find_beam_layers(topology) -> List[Layer]:
    """The topology's beam_search generation layers (usually 0 or 1)."""
    return [l for l in topology.layers if l.type == "beam_search"]


def beam_step_unsupported(topology) -> Optional[str]:
    """Why this topology's decode has no per-tick step (None: it has),
    in the JAX package's words."""
    beams = find_beam_layers(topology)
    if not beams:
        return "topology has no beam_search generation layer"
    if len(beams) > 1:
        return (f"{len(beams)} beam_search layers "
                f"({[b.name for b in beams]}); step export handles one")
    b = beams[0]
    for l in topology.layers:
        if l is not b and b in l.inputs:
            return (f"beam_search output {b.name!r} feeds layer "
                    f"{l.name!r}; step export needs the generation "
                    "layer to be a terminal output")
    if b.attr("ctrl_callbacks") is not None:
        return (f"beam_search {b.name!r} uses Python beam-control "
                "callbacks (candidate_adjust/norm_or_drop), which "
                "cannot ride a compiled step module")
    if b.attr("num_results_per_sample", 1) > 1:
        return (f"beam_search {b.name!r} returns "
                "num_results_per_sample > 1; the step module carries "
                "the single-result state layout")
    return None


class BeamStepExport:
    """The per-tick decode step of a generation topology (the JAX
    package's ``BeamStepExport``).

    ``init_fn(params, feeds)`` runs the topology up to the beam layer's
    inputs (the encoder) and returns the named slot state at tick 0;
    ``step_fn(params, named)`` advances every slot one tick. ``params``
    is the whole parameter dict; a caller that ticks many times passes it
    with its transposed tables laid out once (layers/misc.py
    ``transposed_tables``), so no tick copies them.

    State entries, in this order: ``state:mem:<name>`` [b, beam, size] a
    memory, in declaration order; ``state:tokens`` [b, beam] int32,
    ``state:scores`` [b, beam] float32, ``state:alive`` [b, beam]
    float32, ``state:ids`` [b, beam, L] int32, ``state:t`` [b] int32 (each
    slot's tick counter) and ``state:cap`` [b] int32 (each slot's tick
    bound: a slot whose counter reaches its cap freezes as one at
    max_length does; init gives max_length, a scheduler writes
    min(max_new, max_length) into an admitted slot's row). Encoder
    entries: ``enc:<i>`` (and ``enc:<i>:mask``) a StaticInput, untiled.
    The step returns the state entries, then ``emitted`` [b] int32 (the
    best hypothesis's newest token) and ``done`` [b] int32 (1: every
    hypothesis dead or the cap reached; the slot is free). Free slots
    keep ticking inertly."""

    def __init__(self, topology):
        from paddle_tpu_torch.core.topology import Topology

        reason = beam_step_unsupported(topology)
        enforce(reason is None, f"decode step export: {reason}")
        self.topology = topology
        self.layer = find_beam_layers(topology)[0]
        inner: _InnerGraph = self.layer.attr("inner")
        self.inner = inner
        self.beam = self.layer.attr("beam_size", 1)
        self.max_len = self.layer.attr("max_length", 25)
        self.eos_id, self.bos_id = inner.gen_input.eos_id, \
            inner.gen_input.bos_id
        self.n_static = len(inner.static_inputs)
        self.mem_names = [spec.name for spec, _ in inner.memories]
        # the encoder: topology feeds -> the beam layer's inputs (static
        # encoder state and memory boot values)
        self.sub = Topology(self.layer.inputs)

    def _lparams(self, params):
        return {suffix: params[pname] for suffix, pname in
                self.topology.layer_params(self.layer).items()}

    def state_names(self) -> List[str]:
        return ([f"state:mem:{n}" for n in self.mem_names]
                + ["state:tokens", "state:scores", "state:alive",
                   "state:ids", "state:t", "state:cap"])

    def _pack_state(self, named, B):
        BK = B * self.beam
        return {
            "carry": {n: named[f"state:mem:{n}"].reshape(BK, -1)
                      for n in self.mem_names},
            "tokens": named["state:tokens"].reshape(BK),
            "scores": named["state:scores"].reshape(BK),
            "alive": named["state:alive"].reshape(BK),
            "ids": named["state:ids"].reshape(BK, self.max_len),
        }

    def _unpack_state(self, state, B):
        beam = self.beam
        out = {f"state:mem:{n}": state["carry"][n].reshape(B, beam, -1)
               for n in self.mem_names}
        out["state:tokens"] = state["tokens"].reshape(B, beam)
        out["state:scores"] = state["scores"].reshape(B, beam)
        out["state:alive"] = state["alive"].reshape(B, beam)
        out["state:ids"] = state["ids"].reshape(B, beam, self.max_len)
        return out

    def init_fn(self, params, feeds):
        outs = self.sub.forward(params, feeds)
        ins = [outs[l.name] for l in self.layer.inputs]
        static_args, boot_args = ins[:self.n_static], ins[self.n_static:]
        B = (static_args[0].value.shape[0] if static_args else
             boot_args[0].value.shape[0])
        prog = _BeamProgram(self.layer, self._lparams(params), static_args,
                            B)
        named = self._unpack_state(prog.init_state(boot_args), B)
        dev = named["state:tokens"].device
        named["state:t"] = torch.zeros(B, dtype=torch.int32, device=dev)
        named["state:cap"] = torch.full((B,), self.max_len,
                                        dtype=torch.int32, device=dev)
        for i, a in enumerate(static_args):
            named[f"enc:{i}"] = a.value
            if a.mask is not None:
                named[f"enc:{i}:mask"] = a.mask
        return named

    def step_fn(self, params, named):
        L, beam = self.max_len, self.beam
        static_args = [Arg(named[f"enc:{i}"], named.get(f"enc:{i}:mask"))
                       for i in range(self.n_static)]
        B = named["state:t"].shape[0]
        prog = _BeamProgram(self.layer, self._lparams(params), static_args,
                            B)
        t = named["state:t"].to(torch.int32)
        cap = torch.clamp(named["state:cap"].to(torch.int32), 0, L)
        new = prog.one_step(self._pack_state(named, B), t)
        # counters stop at the slot's own bound: a free or capped slot
        # reaches a fixpoint instead of running on
        t_new = torch.minimum(t + 1, cap)
        alive_slot = new["alive"].reshape(B, beam).amax(dim=1) > 0
        fixed = prog.completion(new, t_new, (~alive_slot) & (t_new < cap))
        out = self._unpack_state(fixed, B)
        # a row already at its bound does not move at all
        frozen = t >= cap
        for n in self.state_names()[:-2]:
            f = frozen.reshape((B,) + (1,) * (out[n].dim() - 1))
            out[n] = torch.where(f, named[n], out[n])
        out["state:t"] = torch.where(frozen, t, t_new)
        out["state:cap"] = cap
        toks = fixed["tokens"].reshape(B, beam)
        best = torch.argmax(fixed["scores"].reshape(B, beam), dim=-1)
        out["emitted"] = toks[torch.arange(B, device=toks.device),
                              best].to(torch.int32)
        out["done"] = ((~alive_slot) | (t_new >= cap)).to(torch.int32)
        return out
