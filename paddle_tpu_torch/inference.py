"""Inference API (counterpart of ``paddle_tpu/inference.py``: ``Inference``,
``infer``, the bundle-backed ``InferenceMachine`` and its C-ABI bridge
functions; analogs of python/paddle/v2/inference.py paddle.infer and the
C-API's shared-parameter inference machines, paddle/capi).

Runs on ``device="cuda"`` unless the caller asks for another device;
without a GPU the CUDA default raises rather than moving to the CPU.
Feeds are padded and bucketed as in the JAX package (power-of-two T, or
a multiple of the ``bucket_rounding`` flag; packing off: results are
indexed per row).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.parameters import Parameters
from paddle_tpu_torch.core.topology import Topology
from paddle_tpu_torch.data_type import SeqType
from paddle_tpu_torch.trainer.feeder import DataFeeder, resolve_pack_flags
from paddle_tpu_torch.utils.device import resolve_device
from paddle_tpu_torch.utils.error import Error


class Inference:
    def __init__(self, output_layer, parameters: Parameters,
                 device: Union[str, torch.device] = "cuda"):
        """Serves the current values of ``parameters``, as the JAX
        package's ``Inference`` does: ``infer`` copies them to ``device``
        again only when they changed since the last copy, through
        ``Parameters.set`` / ``update_from`` (``SGD.train``) or an in-place
        edit of a tensor taken from ``get`` (its autograd ``_version``).
        A write into the memory of a tensor behind PyTorch's back, e.g.
        into the numpy array a ``from_numpy`` tensor shares, is not seen."""
        self.device = resolve_device(device)
        outputs = output_layer if isinstance(output_layer, (list, tuple)) \
            else [output_layer]
        self.topology = Topology(outputs)
        self.out_names = [o.name for o in self.topology.outputs]
        self.parameters = parameters
        self._names = list(self.topology.param_specs())
        self._copied = None
        self._refresh()

    def _stamp(self):
        p = self.parameters
        # an inference-mode tensor has no version counter and cannot be
        # edited outside inference mode
        return p.version, tuple(0 if t.is_inference() else t._version
                                for t in map(p.get, self._names))

    def _refresh(self):
        """Copy the parameters to the device when they changed."""
        stamp = self._stamp()
        if stamp != self._copied:
            self._params = {n: self.parameters.get(n).to(self.device)
                            for n in self._names}
            self._copied = stamp

    def infer(self, input, feeding=None, field="value"):
        # the bucket_rounding flag sets the padded T, as in the JAX package
        _pack, _pml, bucket_rounding = resolve_pack_flags()
        feeder = DataFeeder(self.topology.data_type(), feeding,
                            bucket_rounding=bucket_rounding)
        feeds = {k: a.to(self.device) for k, a in feeder(input).items()}
        self._refresh()
        with torch.inference_mode():
            outs = self.topology.forward(self._params, feeds)
            results = [_flat(outs[n].value) for n in self.out_names]
        return results[0] if len(results) == 1 else results


def infer(output_layer, parameters, input, feeding=None, field="value",
          device: Union[str, torch.device] = "cuda"):
    """paddle.infer analog."""
    return Inference(output_layer, parameters, device).infer(
        input, feeding, field)


def _flat(t: torch.Tensor) -> np.ndarray:
    """An output as the [B, size] matrix of the reference's Argument API
    (carried NHWC images in CHW order, sequences [B, T, D] row-major), on
    the host."""
    from paddle_tpu_torch.layers.conv import image_flat

    return image_flat(t).cpu().numpy()


class InferenceMachine:
    """Bundle-backed inference engine, the Python object behind the C
    inference API (paddle/capi/gradient_machine.h:36-112).

    Loads a merged-model bundle (``io/merged_model``, written by either
    package), its parameters widened to float32, moves them to ``device``
    once and serves raw batches. ``share()`` returns a second machine over
    the same device tensors (paddle_gradient_machine_create_shared_param).
    Runs on ``device="cuda"`` unless the caller asks for another device.
    """

    def __init__(self, bundle_path: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda", *,
                 _shared=None):
        if _shared is not None:
            self.topology, self._params, self.meta, self.device = _shared
        else:
            from paddle_tpu_torch.io.merged_model import load_merged_model

            self.device = resolve_device(device)
            topo, params, meta = load_merged_model(bundle_path)
            if meta.get("host_tables"):
                raise Error(
                    f"host-resident table(s) {sorted(meta['host_tables'])} "
                    "in a bundle: serving them needs their rows staged per "
                    "request from the __hostrows__ sidecars, which the port "
                    "does not do yet (ROADMAP queue 1 item 8; JAX's serving "
                    "daemon does)")
            self.topology = topo
            self._params = {k: v.to(self.device)
                            for k, v in params.as_dict().items()}
            self.meta = meta
        self.out_names = [o.name for o in self.topology.outputs]
        self.in_names = [l.name for l in self.topology.data_layers]
        self._sequences = {
            l.name for l in self.topology.data_layers
            if getattr(l.attr("input_type"), "seq_type", None)
            == SeqType.SEQUENCE}

    def share(self) -> "InferenceMachine":
        return InferenceMachine(_shared=(self.topology, self._params,
                                         self.meta, self.device))

    def input_names(self):
        return list(self.in_names)

    def forward(self, feeds: Dict[str, np.ndarray]) -> np.ndarray:
        """feeds: {data_layer_name: float32 [B, size] (dense) or int32
        [B, T] (id sequences, no mask: every step valid)}. Returns the
        first output, flattened to [B, size]. Wider types narrow as in
        the JAX package (float64 to float32, int64 to int32).

        A plain sequence feed gets a mask of ones, so that the layers that
        need one (pooling) run on it. The JAX machine passes no mask and
        fails there; where it serves, a mask of ones gives its results."""
        args = {}
        for name, arr in feeds.items():
            # a read-only array (the C ABI's buffer) is copied: torch
            # takes writable memory only
            a = np.require(arr, requirements="W")
            if a.dtype == np.float64:
                a = a.astype(np.float32)
            elif a.dtype == np.int64:
                a = a.astype(np.int32)
            t = torch.as_tensor(a).to(self.device)
            args[name] = Arg(t, torch.ones(t.shape[:2], device=self.device)) \
                if name in self._sequences else t
        with torch.inference_mode():
            outs = self.topology.forward(self._params, args)
            return _flat(outs[self.out_names[0]].value)

    def forward_flat(self, name: str, data: np.ndarray) -> np.ndarray:
        """Single-input convenience used by the C ABI."""
        return self.forward({name: data})


def _capi_create(bundle_path: str) -> InferenceMachine:
    return InferenceMachine(bundle_path)


def _capi_forward(machine: InferenceMachine, name: str, buf: bytes,
                  rows: int, cols: int):
    """C-ABI bridge: raw little-endian float32 buffer in, (rows, cols,
    float32 bytes) out."""
    if not name:
        name = machine.in_names[0]
    arr = np.frombuffer(buf, dtype=np.float32).reshape(rows, cols)
    out = np.ascontiguousarray(machine.forward_flat(name, arr),
                               dtype=np.float32)
    return int(out.shape[0]), int(out.shape[1]), out.tobytes()
