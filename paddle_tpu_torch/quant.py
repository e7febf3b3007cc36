"""Post-training quantization for merged-model bundles, int8 and bf16
(counterpart of ``paddle_tpu/quant.py``).

fc weight matrices and embedding tables drop to low precision; biases and
every other parameter stay float32.

int8: per-channel symmetric. An fc weight ``[K, C]`` gets one float32
scale per output channel (axis 1), an embedding table ``[V, D]`` one per
row (axis 0). ``scale = absmax / 127``, codes ``round(a / scale)`` with
ties to even, clipped to +-127; a zero-range channel stores scale 0 and
all-zero codes. Scales ride the bundle as float32 parameters named
``<param>:scale``. bf16: a round-to-nearest-even cast.

The transforms run on CPU tensors in the JAX package's float32 steps, so
the codes, scales and bf16 bits are the JAX package's, byte for byte.
Inputs may be tensors or numpy arrays (float32, int8 or int32); results
are tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

#: tar-entry suffix of the float32 per-channel scale of an int8 parameter
SCALE_SUFFIX = ":scale"

QUANT_MODES = ("bf16", "int8")

_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8",
         torch.int32: "i32"}


def _tensor(a) -> torch.Tensor:
    return a.detach() if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.asarray(a))


def dtype_tag(arr) -> str:
    """Short dtype tag used in bundle meta, signatures and metrics
    labels."""
    dt = _tensor(arr).dtype
    return _TAGS.get(dt, str(dt).replace("torch.", ""))


def param_bytes(params: Dict[str, object]) -> Dict:
    """Total and per-dtype parameter payload bytes (raw values, headers
    excluded), recorded in every bundle's meta."""
    by: Dict[str, int] = {}
    total = 0
    for v in params.values():
        t = _tensor(v)
        n = t.numel() * t.element_size()
        by[dtype_tag(t)] = by.get(dtype_tag(t), 0) + n
        total += n
    return {"total": total, "by_dtype": dict(sorted(by.items()))}


def quantizable_params(topology) -> Dict[str, int]:
    """{param name: channel axis} of the parameters quantization applies
    to: fc weights (per output channel, axis 1) and embedding tables (per
    row, axis 0). A parameter shared across layer kinds with conflicting
    axes stays float32."""
    axes: Dict[str, int] = {}
    dropped = set()
    for l in topology.layers:
        if l.type in ("fc", "mkldnn_fc"):
            ax = 1
        elif l.type == "embedding":
            ax = 0
        else:
            continue
        for suffix, pname in topology.layer_param_map(l.name).items():
            if suffix == "wbias":
                continue
            if pname in axes and axes[pname] != ax:
                dropped.add(pname)
            else:
                axes[pname] = ax
    for pname in dropped:
        axes.pop(pname, None)
    return axes


def quantize_array_int8(a, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel symmetric int8: (codes int8, scales float32 [a.shape[
    axis]]). Channels of zero range get scale 0 and all-zero codes."""
    a = _tensor(a).to(torch.float32)
    reduce_dims = tuple(d for d in range(a.dim()) if d != axis)
    absmax = a.abs().amax(dim=reduce_dims) if reduce_dims else a.abs()
    scale = absmax / 127.0
    shape = [1] * a.dim()
    shape[axis] = -1
    s = scale.reshape(shape)
    safe = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(a / safe), -127, 127)
    q = torch.where(s > 0, q, torch.zeros_like(q)).to(torch.int8)
    return q, scale


def dequantize_array_int8(q, scale, axis: int) -> torch.Tensor:
    q = _tensor(q)
    shape = [1] * q.dim()
    shape[axis] = -1
    return q.to(torch.float32) * _tensor(scale).to(torch.float32).reshape(
        shape)


def quantize_params(topology, params: Dict[str, object], mode: str
                    ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Quantize a parameter dict for ``mode`` in ``QUANT_MODES``.

    Returns ``(qparams, qmeta)``: fc and embedding weights in low
    precision (int8 with float32 ``<name>:scale`` sidecars), every other
    parameter untouched, and the bundle-meta record::

        {"mode": "int8",
         "param_dtypes": {name: "f32"|"bf16"|"int8", ...},
         "channel_axis": {name: 0|1, ...}}        # int8 only

    Raises ValueError when the topology has no fc weight or embedding
    table, naming the layer kinds found: a bundle is never labelled
    quantized while it stays float32."""
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantize mode {mode!r} "
                         f"(choose from {', '.join(QUANT_MODES)})")
    axes = quantizable_params(topology)
    axes = {n: ax for n, ax in axes.items() if n in params}
    if not axes:
        kinds = sorted({l.type for l in topology.layers})
        raise ValueError(
            "--quantize needs fc weights or embedding tables, but this "
            "topology has no quantizable params; layer kinds found: "
            + ", ".join(kinds))
    out: Dict[str, torch.Tensor] = {}
    dtypes: Dict[str, str] = {}
    channel_axis: Dict[str, int] = {}
    for name, v in params.items():
        t = _tensor(v)
        if name not in axes:
            out[name] = t
            dtypes[name] = dtype_tag(t)
            continue
        if mode == "bf16":
            out[name] = t.to(torch.bfloat16)
            dtypes[name] = "bf16"
        else:
            q, scale = quantize_array_int8(t, axes[name])
            out[name] = q
            out[name + SCALE_SUFFIX] = scale
            dtypes[name] = "int8"
            dtypes[name + SCALE_SUFFIX] = "f32"
            channel_axis[name] = axes[name]
    qmeta = {"mode": mode, "param_dtypes": dtypes}
    if channel_axis:
        qmeta["channel_axis"] = channel_axis
    return out, qmeta


def dequantize_params(params: Dict[str, object],
                      qmeta: Optional[Dict]) -> Dict[str, torch.Tensor]:
    """Widen a quantized parameter dict back to float32 (scale sidecars
    consumed, not returned); a copy of the dict when ``qmeta`` is falsy.
    Lossy by design. Inside an exported forward (JAX
    ``dequantize_tracer``) the program keeps the int8 or bf16 constants
    and float32 scales and widens them itself on each run."""
    if not qmeta:
        return {k: _tensor(v) for k, v in params.items()}
    axes = qmeta.get("channel_axis", {})
    dtypes = qmeta.get("param_dtypes", {})
    out: Dict[str, torch.Tensor] = {}
    for name, v in params.items():
        if name.endswith(SCALE_SUFFIX):
            continue
        t = _tensor(v)
        tag = dtypes.get(name, dtype_tag(t))
        if tag == "int8" or t.dtype == torch.int8:
            out[name] = dequantize_array_int8(
                t, params[name + SCALE_SUFFIX],
                int(axes.get(name, t.dim() - 1)))
        elif tag == "bf16" or t.dtype == torch.bfloat16:
            out[name] = t.to(torch.float32)
        else:
            out[name] = t
    return out
