"""Analytic model FLOPs for MFU reporting (counterpart of
``paddle_tpu/flops.py``).

``topology_fwd_flops`` walks the layer graph and sums the matmul work (2 *
positions * weight elements per consumed weight), ``train_flops`` applies
the usual 3x forward multiplier (dX and dW each re-run the forward's
contraction), and ``device_peak_flops`` gives the card's published dense
bf16 peak, so mfu = achieved / peak. As in the JAX package, elementwise
work (activations, norms, masks, the optimizer) and embedding gathers
are left out; a layer type with no entry below counts zero.

The one peak known here is the NVIDIA H100 SXM's published dense bf16
tensor-core rate, 989 TFLOP/s (NVIDIA's data sheet, at the full 700 W
power limit): a data-sheet figure, not a measurement. A device without a
published figure (the CPU) has no MFU.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

# published dense bf16 peak (FLOP/s) by the card's name as
# torch.cuda.get_device_name gives it
_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,      # H100 SXM
}

_CONV_TYPES = ("exconv", "exconvt", "cudnn_conv", "cudnn_convt",
               "mkldnn_conv")


def device_peak_flops(device=None) -> Optional[float]:
    """The published dense bf16 FLOP/s of ``device`` (a torch device or
    its name; default the current CUDA device), or None where none is
    known (the CPU, another card)."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return _PEAK_FLOPS.get(torch.cuda.get_device_name(device))


def _weight_numels(topo, lname) -> int:
    """Total elements of the non-bias weights a layer consumes."""
    specs = topo.param_specs()
    return sum(int(np.prod(specs[pname].shape))
               for suffix, pname in topo.layer_params(lname).items()
               if suffix != "wbias")


def _selective_fc_numel(topo, l) -> int:
    """Effective weight elements a position of a selective_fc, by the
    layer's own path choice (layers/misc.py): the gather path multiplies
    only the K selected rows (K*D instead of C*D); the dense-mask path
    pays the full matmul."""
    from paddle_tpu_torch.layers.misc import (_SELFC_GATHER_MIN_C,
                                              _SELFC_GATHER_MIN_C_SPARSE)

    numel = _weight_numels(topo, l.name)
    C = l.size
    K = topo.info(l.inputs[-1].name).size
    id_list = bool(l.attr("select_is_id_list")) or K != C
    min_c = l.attr("gather_min_c")
    if min_c is None:
        sparse = all(l.param_attr(i).sparse_update
                     for i in range(len(l.inputs) - 1))
        min_c = _SELFC_GATHER_MIN_C_SPARSE if sparse else _SELFC_GATHER_MIN_C
    gather = bool(l.attr("compact_output")) or (id_list and C >= min_c)
    if gather and K < C:
        numel = numel * K // C      # exact: every weight carries factor C
    return numel


def _beam_inner_numel(l) -> int:
    """Matmul weight elements a tick and a hypothesis of a beam_search
    layer's step network; selective_fc projections count in candidate
    space."""
    itopo = l.attr("inner").topology
    total = 0
    for il in itopo.layers:
        if il.type == "selective_fc":
            total += _selective_fc_numel(itopo, il)
        else:
            total += _weight_numels(itopo, il.name)
    return total


def layer_fwd_flops(topo, l, batch: int, seq_len: int = 1,
                    decode_ticks: Optional[int] = None) -> float:
    """Forward FLOPs (2 per multiply-add) ONE layer contributes to a
    batch, the term :func:`topology_fwd_flops` sums."""
    if l.type == "embedding":
        return 0.0              # a table lookup, not a matmul
    numel = _weight_numels(topo, l.name)
    if numel == 0 and l.type not in ("recurrent_layer_group",
                                     "beam_search"):
        return 0.0
    info = topo.info(l.name)
    if l.type in _CONV_TYPES:
        # out shape (C, H', W'): the weight slides over the output plane
        spatial = int(np.prod(info.shape[1:]))
        return 2.0 * batch * spatial * numel
    if l.type == "beam_search":
        beam = l.attr("beam_size", 1)
        ticks = decode_ticks if decode_ticks is not None \
            else l.attr("max_length", 25)
        return 2.0 * batch * beam * ticks * _beam_inner_numel(l)
    if l.type == "recurrent_layer_group":
        inner_numel = sum(
            int(np.prod(s.shape))
            for n, s in l.attr("inner").topology.param_specs().items()
            if not s.is_bias)
        return 2.0 * batch * seq_len * inner_numel
    if l.type == "selective_fc":
        pos = batch * seq_len if info.is_seq else batch
        return 2.0 * pos * _selective_fc_numel(topo, l)
    if l.type in ("lstmemory", "gated_recurrent"):
        return 2.0 * batch * seq_len * numel     # once a tick
    if info.is_seq:
        return 2.0 * batch * seq_len * numel
    return 2.0 * batch * numel


def topology_fwd_flops(topo, batch: int, seq_len: int = 1,
                       decode_ticks: Optional[int] = None) -> float:
    """Forward FLOPs of one batch through the topology: per layer 2 *
    positions * weight elements, positions being the batch for plain
    layers, batch*T for sequence layers and recurrent cells, H'*W'*batch
    for convolutions and batch*beam*ticks for beam search
    (``decode_ticks`` overrides max_length)."""
    return float(sum(layer_fwd_flops(topo, l, batch, seq_len, decode_ticks)
                     for l in topo.layers))


def train_flops(topo, batch: int, seq_len: int = 1) -> float:
    """Forward + backward ~= 3x the forward for matmul-dominated nets."""
    return 3.0 * topology_fwd_flops(topo, batch, seq_len)


def mfu(flops_per_sec: float, device=None) -> Optional[float]:
    """Achieved FLOP/s over the device's published bf16 peak, or None
    where no peak is known."""
    peak = device_peak_flops(device)
    if not peak:
        return None
    return flops_per_sec / peak


def bench_flop_fields(topo, batch: int, seq_len: int, sec_per_step: float,
                      device=None) -> Dict[str, Optional[float]]:
    """A training step's model TFLOPs, achieved TFLOP/s and mfu."""
    f = train_flops(topo, batch, seq_len)
    per_sec = f / sec_per_step
    m = mfu(per_sec, device)
    return {"model_tflops_per_step": round(f / 1e12, 3),
            "achieved_tflops_per_sec": round(per_sec / 1e12, 2),
            "mfu": (round(m, 4) if m is not None else None)}
