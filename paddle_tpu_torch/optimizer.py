"""Optimizers, learning-rate schedules, regularizers and gradient clipping
(counterpart of ``paddle_tpu/optimizer.py``; analog of
paddle/parameter/FirstOrderOptimizer.h: SGD/momentum :24, AdaGrad :111,
AdaDelta :141, RMSProp :167, DecayedAdaGrad :210, Adam :255, AdaMax :286;
LearningRateScheduler.cpp, Regularizer.cpp and the v2 wrapper
python/paddle/v2/optimizer.py).

Each optimizer maps ``init(params) -> state`` and ``update(grads, state,
params, lr_mults, static) -> (new_params, new_state)`` over dicts of
tensors, as the JAX package's pure transforms do. The state layout is the
JAX package's canonical one, ``{param: {slot: tensor}, "__step__": n}``,
so a snapshot's optimizer state reads the same in both. Updates run under
``torch.no_grad()`` on the parameters' device and build new tensors (the
caller keeps or drops the old ones).

Not ported yet, and refused when asked for: sparse-row gradients
(``SparseRowGrad``), the lazy per-row catch-up (``catch_up_rows``,
``init(sparse_catchup_for=...)``) and Polyak averaging (``ModelAverage``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.utils.error import Error, enforce


# --- learning-rate schedules (LearningRateScheduler.cpp parity) ----------

def lr_schedule(learning_rate: float, learning_rate_decay_a: float = 0.0,
                learning_rate_decay_b: float = 0.0,
                learning_rate_schedule: str = "constant"):
    """Returns f(step) -> lr, in float32 as the JAX package computes it.
    Schedules: constant, poly, exp, discexp, linear."""
    a = np.float32(learning_rate_decay_a)
    b = np.float32(learning_rate_decay_b)
    lr0 = np.float32(learning_rate)

    def f(t):
        t = np.float32(t)
        if learning_rate_schedule == "poly":
            return float(lr0 * np.power(np.float32(1.0) + a * t, -b))
        if learning_rate_schedule == "exp":
            return float(lr0 * np.power(a, t / b))
        if learning_rate_schedule == "discexp":
            return float(lr0 * np.power(a, np.floor(t / b)))
        if learning_rate_schedule == "linear":
            return float(np.maximum(lr0 - a * t, b))
        return float(lr0)

    return f


# --- regularizers (Regularizer.cpp parity) -------------------------------

@dataclasses.dataclass
class L2Regularization:
    rate: float

    def apply(self, grad, param, lr):
        return grad + self.rate * param


@dataclasses.dataclass
class L1Regularization:
    rate: float

    def apply(self, grad, param, lr):
        return grad + self.rate * torch.sign(param)


# --- gradient clipping ----------------------------------------------------

def clip_by_value(g, threshold):
    return torch.clamp(g, -threshold, threshold)


def global_norm_clip(grads: Dict[str, torch.Tensor], threshold: float):
    gn = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))
    scale = torch.clamp(threshold / torch.clamp(gn, min=1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}


# --- base optimizer -------------------------------------------------------

class Optimizer:
    """Base: subclasses implement init_one / update_one on single
    tensors."""

    def __init__(self, learning_rate=0.001, regularization=None,
                 gradient_clipping_threshold=None, global_clipping=False,
                 model_average=None, learning_rate_decay_a=0.0,
                 learning_rate_decay_b=0.0, learning_rate_schedule="constant",
                 batch_size=None, **extra):
        enforce(model_average is None,
                "model_average (Polyak averaging) is not ported yet")
        self.lr_fn = lr_schedule(learning_rate, learning_rate_decay_a,
                                 learning_rate_decay_b, learning_rate_schedule)
        self.regularization = regularization
        self.clip_threshold = gradient_clipping_threshold
        self.global_clipping = global_clipping
        self.extra = extra

    # per-tensor hooks -----------------------------------------------------
    def init_one(self, p: torch.Tensor) -> dict:
        return {}

    def update_one(self, g, p, s: dict, lr) -> tuple:
        raise NotImplementedError

    # dict API -------------------------------------------------------------
    def init(self, params: Dict[str, torch.Tensor],
             sparse_catchup_for: Sequence[str] = ()) -> dict:
        enforce(not sparse_catchup_for,
                "sparse_catchup_for: the lazy per-row catch-up is not "
                "ported yet")
        with torch.no_grad():
            state = {name: self.init_one(p) for name, p in params.items()}
        # the step counter stays on the host: the learning rate is a
        # function of it, and reading it needs no device sync
        state["__step__"] = torch.zeros((), dtype=torch.int32)
        return state

    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor],
               lr_mults: Optional[Dict[str, float]] = None,
               static: Optional[Dict[str, bool]] = None):
        step = state["__step__"] + 1
        lr = self.lr_fn(int(step))
        new_params, new_state = {}, {"__step__": step}
        with torch.no_grad():
            grads = {k: g for k, g in grads.items() if g is not None}
            if self.clip_threshold and self.global_clipping:
                grads = global_norm_clip(grads, self.clip_threshold)
            for name, p in params.items():
                g = grads.get(name)
                if g is None or (static and static.get(name)):
                    new_params[name] = p
                    new_state[name] = state[name]
                    continue
                plr = lr * (lr_mults.get(name, 1.0) if lr_mults else 1.0)
                if self.clip_threshold and not self.global_clipping:
                    g = clip_by_value(g, self.clip_threshold)
                if self.regularization is not None:
                    g = self.regularization.apply(g, p, lr)
                new_p, new_s = self.update_one(g, p, dict(state[name]), plr)
                new_params[name] = new_p
                new_state[name] = new_s
        return new_params, new_state

    def catch_up_rows(self, p_rows, s_rows: dict, gap, lr):
        raise Error("catch_up_rows (the lazy per-row catch-up of "
                    "sparse-row training) is not ported yet")


class Momentum(Optimizer):
    """SGD with (optionally Nesterov) momentum (FirstOrderOptimizer.h:24)."""

    def __init__(self, momentum=0.0, sparse=False, nesterov=False, **kw):
        super().__init__(**kw)
        self.momentum = momentum
        self.nesterov = nesterov

    def init_one(self, p):
        if self.momentum:
            return {"mom": torch.zeros_like(p)}
        return {}

    def update_one(self, g, p, s, lr):
        if not self.momentum:
            return p - lr * g, s
        mom = self.momentum * s["mom"] - lr * g
        if self.nesterov:
            new_p = p + self.momentum * mom - lr * g
        else:
            new_p = p + mom
        return new_p, {"mom": mom}


SGD = Momentum


class AdaGrad(Optimizer):
    """FirstOrderOptimizer.h:111; epsilon is the reference's ada_epsilon."""

    def __init__(self, epsilon=1e-6, **kw):
        super().__init__(**kw)
        self.eps = epsilon

    def init_one(self, p):
        return {"accum": torch.zeros_like(p)}

    def update_one(self, g, p, s, lr):
        accum = s["accum"] + torch.square(g)
        new_p = p - lr * g / (torch.sqrt(accum) + self.eps)
        return new_p, {"accum": accum}


class DecayedAdaGrad(Optimizer):
    """FirstOrderOptimizer.h:210: accum = rho*accum + (1-rho)*g^2."""

    def __init__(self, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(**kw)
        self.rho, self.eps = rho, epsilon

    def init_one(self, p):
        return {"accum": torch.zeros_like(p)}

    def update_one(self, g, p, s, lr):
        accum = self.rho * s["accum"] + (1 - self.rho) * torch.square(g)
        new_p = p - lr * g / (torch.sqrt(accum) + self.eps)
        return new_p, {"accum": accum}


class AdaDelta(Optimizer):
    """FirstOrderOptimizer.h:141."""

    def __init__(self, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(**kw)
        self.rho, self.eps = rho, epsilon

    def init_one(self, p):
        return {"accum_g": torch.zeros_like(p),
                "accum_x": torch.zeros_like(p)}

    def update_one(self, g, p, s, lr):
        ag = self.rho * s["accum_g"] + (1 - self.rho) * torch.square(g)
        dx = -torch.sqrt((s["accum_x"] + self.eps) / (ag + self.eps)) * g
        ax = self.rho * s["accum_x"] + (1 - self.rho) * torch.square(dx)
        return p + lr * dx, {"accum_g": ag, "accum_x": ax}


class RMSProp(Optimizer):
    """FirstOrderOptimizer.h:167, with the mean-gradient correction term
    (the reference's rmsprop tracks E[g] too)."""

    def __init__(self, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(**kw)
        self.rho, self.eps = rho, epsilon

    def init_one(self, p):
        return {"accum_g2": torch.zeros_like(p),
                "accum_g": torch.zeros_like(p)}

    def update_one(self, g, p, s, lr):
        g2 = self.rho * s["accum_g2"] + (1 - self.rho) * torch.square(g)
        g1 = self.rho * s["accum_g"] + (1 - self.rho) * g
        new_p = p - lr * g / torch.sqrt(g2 - torch.square(g1) + self.eps)
        return new_p, {"accum_g2": g2, "accum_g": g1}


class Adam(Optimizer):
    """FirstOrderOptimizer.h:255."""

    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8, **kw):
        super().__init__(**kw)
        self.b1, self.b2, self.eps = beta1, beta2, epsilon

    def init_one(self, p):
        return {"m": torch.zeros_like(p), "v": torch.zeros_like(p),
                "t": torch.zeros((), dtype=torch.float32, device=p.device)}

    def update_one(self, g, p, s, lr):
        t = s["t"] + 1
        m = self.b1 * s["m"] + (1 - self.b1) * g
        v = self.b2 * s["v"] + (1 - self.b2) * torch.square(g)
        mhat = m / (1 - torch.pow(self.b1, t))
        vhat = v / (1 - torch.pow(self.b2, t))
        new_p = p - lr * mhat / (torch.sqrt(vhat) + self.eps)
        return new_p, {"m": m, "v": v, "t": t}


class AdaMax(Optimizer):
    """FirstOrderOptimizer.h:286."""

    def __init__(self, beta1=0.9, beta2=0.999, **kw):
        super().__init__(**kw)
        self.b1, self.b2 = beta1, beta2

    def init_one(self, p):
        return {"m": torch.zeros_like(p), "u": torch.zeros_like(p),
                "t": torch.zeros((), dtype=torch.float32, device=p.device)}

    def update_one(self, g, p, s, lr):
        t = s["t"] + 1
        m = self.b1 * s["m"] + (1 - self.b1) * g
        u = torch.maximum(self.b2 * s["u"], torch.abs(g))
        new_p = p - lr / (1 - torch.pow(self.b1, t)) * m / (u + 1e-12)
        return new_p, {"m": m, "u": u, "t": t}


class ModelAverage:
    """Polyak averaging marker (v2 optimizer.py ModelAverage). Not ported
    yet: an optimizer given one raises."""

    def __init__(self, average_window=0.5, max_average_window=None):
        self.average_window = average_window
        self.max_average_window = max_average_window
