"""Whole-net gradient checking (counterpart of
``paddle_tpu/trainer/checkgrad.py``; analog of Trainer::checkGradient,
paddle/trainer/Trainer.cpp:332).

On one batch, the analytic gradient of the total cost with respect to
every trainable parameter is held against a central finite difference
along a random unit direction d of that parameter:

    (loss(p + eps*d) - loss(p - eps*d)) / (2*eps)   vs   <grad_p, d>

The check runs in float64 on the CPU, as the JAX package's runs under
x64: float32 rounding of the loss is the size of the difference itself
for parameters with small gradients. The directions come from
``np.random.RandomState(seed)`` in sorted parameter order, the JAX
package's, so both draw the same d.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from paddle_tpu_torch.core.arg import Arg, as_arg


def check_gradient(topology, cost_name, params: Dict[str, torch.Tensor],
                   feeds, eps: float = 1e-4, rtol: float = 1e-2,
                   seed: int = 0):
    """Returns (ok, report): report maps a parameter's name to its
    analytic and numeric directional derivatives, their relative
    difference and whether it is within ``rtol``. Static parameters
    (batch-norm's moving statistics) and integer ones are skipped."""
    cpu = torch.device("cpu")

    def to64(x):
        if x is None:
            return None
        x = torch.as_tensor(x).to(cpu)
        return x.to(torch.float64) if x.is_floating_point() else x

    params = {k: to64(v) for k, v in params.items()}
    feeds = {k: Arg(to64(a.value), to64(a.mask),
                    None if a.seg_ids is None else torch.as_tensor(a.seg_ids))
             for k, a in ((k, as_arg(v)) for k, v in feeds.items())}
    loss = topology.loss_fn(cost_name)
    static = topology.static_map()

    def scalar_loss(p):
        cost, _aux = loss(p, feeds, training=False)
        return cost

    leaves = {k: (v.clone().requires_grad_(True) if v.is_floating_point()
                  and not static.get(k) else v) for k, v in params.items()}
    scalar_loss(leaves).backward()
    rng = np.random.RandomState(seed)
    report, ok = {}, True
    with torch.no_grad():
        for name in sorted(params):
            p = params[name]
            if static.get(name) or not p.is_floating_point():
                continue
            d = rng.standard_normal(tuple(p.shape))
            d /= max(np.linalg.norm(d), 1e-12)
            d = torch.from_numpy(d)
            plus = dict(params)
            plus[name] = p + eps * d
            minus = dict(params)
            minus[name] = p - eps * d
            numeric = (float(scalar_loss(plus))
                       - float(scalar_loss(minus))) / (2 * eps)
            g = leaves[name].grad
            analytic = 0.0 if g is None else float(torch.sum(g * d))
            scale = max(abs(numeric), abs(analytic), 1e-5)
            rel = abs(numeric - analytic) / scale
            report[name] = {"analytic": analytic, "numeric": numeric,
                            "rel_diff": rel, "ok": rel <= rtol}
            if rel > rtol:
                ok = False
    return ok, report
