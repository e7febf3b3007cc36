"""Inference API (counterpart of ``paddle_tpu/inference.py`` ``Inference``
and ``infer``; analog of python/paddle/v2/inference.py paddle.infer).

Runs on ``device="cuda"`` unless the caller asks for another device;
without a GPU the CUDA default raises rather than moving to the CPU.
Feeds are padded and bucketed as in the JAX package (power-of-two T, or
a multiple of the ``bucket_rounding`` flag; packing off: results are
indexed per row).
"""

from __future__ import annotations

from typing import Union

import torch

from paddle_tpu_torch.core.parameters import Parameters
from paddle_tpu_torch.core.topology import Topology
from paddle_tpu_torch.trainer.feeder import DataFeeder, resolve_pack_flags
from paddle_tpu_torch.utils.device import resolve_device


class Inference:
    def __init__(self, output_layer, parameters: Parameters,
                 device: Union[str, torch.device] = "cuda"):
        """Takes a copy of ``parameters`` on ``device`` once: later changes
        to ``parameters`` need a new Inference."""
        self.device = resolve_device(device)
        outputs = output_layer if isinstance(output_layer, (list, tuple)) \
            else [output_layer]
        self.topology = Topology(outputs)
        self.out_names = [o.name for o in self.topology.outputs]
        self.parameters = parameters
        self._params = {name: parameters.get(name).to(self.device)
                        for name in self.topology.param_specs()}

    def infer(self, input, feeding=None, field="value"):
        # the bucket_rounding flag sets the padded T, as in the JAX package
        _pack, _pml, bucket_rounding = resolve_pack_flags()
        feeder = DataFeeder(self.topology.data_type(), feeding,
                            bucket_rounding=bucket_rounding)
        feeds = {k: a.to(self.device) for k, a in feeder(input).items()}
        with torch.inference_mode():
            outs = self.topology.forward(self._params, feeds)
            # flatten each output to the [B, size] matrices of the
            # reference's Argument API (sequences [B, T, D] row-major)
            results = [outs[n].value.reshape(outs[n].value.shape[0], -1)
                       .cpu().numpy() for n in self.out_names]
        return results[0] if len(results) == 1 else results


def infer(output_layer, parameters, input, feeding=None, field="value",
          device: Union[str, torch.device] = "cuda"):
    """paddle.infer analog."""
    return Inference(output_layer, parameters, device).infer(
        input, feeding, field)
