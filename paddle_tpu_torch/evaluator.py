"""Evaluators (counterpart of ``paddle_tpu/evaluator.py``; analog of
paddle/gserver/evaluators/). Each evaluator names the layer outputs it
reads, computes a few statistics on the device each batch, and
accumulates them on the host across batches (the reference's per-batch
"CurrentEval" and per-pass printing, Evaluator.h start/finish protocol).

The port has the ``Evaluator`` base and ``classification_error``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _name(layer) -> str:
    return layer if isinstance(layer, str) else layer.name


class Evaluator:
    def reset(self):
        self._acc = None

    def compute(self, outs) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def accumulate(self, stats: Dict):
        stats = {k: np.asarray(torch.as_tensor(v).detach().cpu(), np.float64)
                 for k, v in stats.items()}
        if getattr(self, "_acc", None) is None:
            self._acc = stats
        else:
            self._acc = {k: self._acc[k] + stats[k] for k in stats}

    def value(self) -> float:
        raise NotImplementedError


def _sample_weight(outs, weight_name):
    """Per-sample weight column [B] from a named layer output (the
    reference's optional third evaluator input, Evaluator.cpp:39-78)."""
    w = outs[weight_name].value
    if w.dim() > 1:
        w = w[..., 0]
    return w.to(torch.float32)


class classification_error(Evaluator):
    """ClassificationErrorEvaluator: fraction of rows whose argmax doesn't
    match the label (sequence inputs: per valid step). Optional ``weight``
    input: errors and the sample count are weighted per row
    (Evaluator.cpp:50-56)."""

    def __init__(self, input, label, name=None, weight=None, **kw):
        self.input, self.label = _name(input), _name(label)
        self.weight = _name(weight) if weight is not None else None
        self.reset()

    def compute(self, outs):
        pred = outs[self.input]
        label = outs[self.label]
        ids = torch.argmax(pred.value, dim=-1)
        lab = label.value.long()
        if lab.dim() == ids.dim() + 1:
            lab = lab[..., 0]
        wrong = (ids != lab).to(torch.float32)
        count = pred.mask.to(torch.float32) if pred.mask is not None \
            else torch.ones_like(wrong)
        if self.weight is not None:
            w = _sample_weight(outs, self.weight)
            w = w.reshape(tuple(w.shape) + (1,) * (wrong.dim() - w.dim()))
            count = count * w
        if pred.mask is not None:
            wrong = wrong * pred.mask
        if self.weight is not None:
            wrong = wrong * w
        return {"wrong": wrong.sum(), "total": count.sum()}

    def value(self):
        if not getattr(self, "_acc", None):
            return float("nan")
        return float(self._acc["wrong"] / max(self._acc["total"], 1e-9))
