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
caller keeps or drops the old ones), except the sparse-row update.

A ``SparseRowGrad`` (sparse_grad.py) updates only its table's touched rows,
in place (``_update_sparse``), with the lazy per-row catch-up
(``catch_up_rows``) where ``init(sparse_catchup_for=...)`` gave the table
its ``t0`` slot.

Polyak averaging (``model_average=ModelAverage(...)``, AverageOptimizer.h
:23): the state carries the running mean of the parameters after each
update, ``"__avg__"`` (tensors beside the parameters) over
``"__avg_n__"`` updates (a float32 0-d tensor on the host, as
``"__step__"`` is), and ``apply_average`` swaps it in for evaluation.
``settings()`` is the v1 DSL's job-level configuration.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.sparse_grad import SparseRowGrad, dedup_rows


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
    # a sparse-row gradient's dead slots hold zeros and its duplicates
    # disjoint cotangents, so its value block's norm is the norm of the
    # dense gradient it stands for
    def values(g):
        return g.values if isinstance(g, SparseRowGrad) else g

    gn = torch.sqrt(sum(torch.sum(torch.square(values(g)))
                        for g in grads.values()))
    scale = torch.clamp(threshold / torch.clamp(gn, min=1e-12), max=1.0)
    return {k: (SparseRowGrad(g.rows, g.values * scale, g.shape)
                if isinstance(g, SparseRowGrad) else g * scale)
            for k, g in grads.items()}


def _trail(x, like):
    """``x`` [n] reshaped to broadcast over ``like``'s trailing dims."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


# elements of one [G, n, ...] block of a catch-up replay (128 MiB float32)
_REPLAY_BLOCK = 1 << 25


def _replayed_sum(gap, t, delta, *rows):
    """Sum over j = 1..gap[i] of the parameter step that row i's j-th
    skipped zero-gradient step made, for rules whose skipped steps have
    no closed form (Adam, AdaMax). That step ran at the global step tau =
    t - gap[i] + j; ``delta(j, tau, *rows)`` gives it for G steps of n
    rows at once, a [G, n, ...] block from j [G, 1, ...], tau [G, n, 1,
    ...] and the rows' slots [n, ...].

    The steps run G at a time on the device, G as large as
    ``_REPLAY_BLOCK`` allows, the rows sorted by gap so that a block
    holds only the rows whose gap reaches it: the work is sum(gap) rows,
    not n * max(gap), and the launches a few per block. The one host
    read is the sorted gaps. The JAX package replays one step per
    while_loop iteration; summing G steps at once changes only the order
    of the float additions.

    ``delta`` is zero wherever ``rows[0]`` (the first moment) is, so a
    row whose first moment is all zero, one never touched, moves nothing
    and is skipped."""
    total = torch.zeros_like(rows[0])
    n = gap.shape[0]
    if n == 0:
        return total
    moved = rows[0].reshape(n, -1).ne(0).any(1)
    gaps, order = torch.sort(torch.where(moved, gap, 0), descending=True)
    host = gaps.cpu().numpy()
    rows = [r.index_select(0, order) for r in rows]
    acc = torch.zeros_like(rows[0])
    gapf = gaps.to(torch.float32)
    width = max(1, rows[0][0].numel())
    trail = (1,) * (rows[0].dim() - 1)
    j0, last = 1, int(host[0])
    while j0 <= last:
        n_c = int(np.count_nonzero(host >= j0))
        G = min(last - j0 + 1, max(1, _REPLAY_BLOCK // (n_c * width)))
        j = torch.arange(j0, j0 + G, dtype=torch.float32,
                         device=gap.device)[:, None]          # [G, 1]
        g = gapf[None, :n_c]                                  # [1, n_c]
        tau = (t - g + j).reshape((G, n_c) + trail)
        blk = delta(j.reshape((G, 1) + trail), tau,
                    *(r[:n_c] for r in rows))
        blk.masked_fill_((j > g).reshape((G, n_c) + trail), 0)
        acc[:n_c] += blk.sum(0)
        j0 += G
    return total.index_copy_(0, order, acc)


# --- base optimizer -------------------------------------------------------

class Optimizer:
    """Base: subclasses implement init_one / update_one on single
    tensors."""

    def __init__(self, learning_rate=0.001, regularization=None,
                 gradient_clipping_threshold=None, global_clipping=False,
                 model_average=None, learning_rate_decay_a=0.0,
                 learning_rate_decay_b=0.0, learning_rate_schedule="constant",
                 batch_size=None, **extra):
        self.lr_fn = lr_schedule(learning_rate, learning_rate_decay_a,
                                 learning_rate_decay_b, learning_rate_schedule)
        self.regularization = regularization
        self.clip_threshold = gradient_clipping_threshold
        self.global_clipping = global_clipping
        self.model_average = model_average
        self.extra = extra

    # per-tensor hooks -----------------------------------------------------
    def init_one(self, p: torch.Tensor) -> dict:
        return {}

    def update_one(self, g, p, s: dict, lr) -> tuple:
        raise NotImplementedError

    # dict API -------------------------------------------------------------
    def init(self, params: Dict[str, torch.Tensor],
             sparse_catchup_for: Sequence[str] = ()) -> dict:
        """``sparse_catchup_for`` names [C, ...] tables trained through
        the sparse-row path whose state gets a per-row last-touched step
        ``t0``: on a touch, ``catch_up_rows`` first replays the row's
        skipped zero-gradient steps, which makes the lazy update equal to
        the dense one for momentum, Adam, AdaMax, DecayedAdaGrad, AdaDelta
        and RMSProp (SGD and AdaGrad are equal without it). The
        reference's t0Vec_ catch-up (ParameterOptimizer.h:100)."""
        with torch.no_grad():
            state = {name: self.init_one(p) for name, p in params.items()}
            for name in sparse_catchup_for:
                if name in state:
                    state[name]["t0"] = torch.zeros(
                        params[name].shape[0], dtype=torch.int32,
                        device=params[name].device)
        # the step counter stays on the host: the learning rate is a
        # function of it, and reading it needs no device sync
        state["__step__"] = torch.zeros((), dtype=torch.int32)
        if self.model_average is not None:
            with torch.no_grad():
                state["__avg__"] = {n: p.detach().clone()
                                    for n, p in params.items()}
            state["__avg_n__"] = torch.zeros((), dtype=torch.float32)
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
                if isinstance(g, SparseRowGrad):
                    new_params[name], new_state[name] = self._update_sparse(
                        g, p, dict(state[name]), plr, lr, int(step))
                    continue
                if self.clip_threshold and not self.global_clipping:
                    g = clip_by_value(g, self.clip_threshold)
                if self.regularization is not None:
                    g = self.regularization.apply(g, p, lr)
                new_p, new_s = self.update_one(g, p, dict(state[name]), plr)
                new_params[name] = new_p
                new_state[name] = new_s
            # Polyak window (AverageOptimizer.h:23): the running mean of
            # the parameters after each update
            if self.model_average is not None:
                n = state["__avg_n__"] + 1.0
                avg = state["__avg__"]
                # n stays a host scalar: dividing by it copies nothing to
                # the device (a pageable copy would sync the stream)
                new_state["__avg__"] = {
                    k: avg[k] + (new_params[k] - avg[k]) / n for k in avg}
                new_state["__avg_n__"] = n
            elif "__avg__" in state:
                new_state["__avg__"] = state["__avg__"]
                new_state["__avg_n__"] = state["__avg_n__"]
        return new_params, new_state

    def apply_average(self, state, params):
        """The parameters to evaluate with: the Polyak average where the
        optimizer keeps one, else ``params`` (the apply half of the
        ParameterUpdater apply/restore protocol,
        ParameterUpdaterBase.h:23)."""
        if self.model_average is None:
            return params
        return dict(state["__avg__"])

    def _update_sparse(self, g: SparseRowGrad, p, s: dict, plr, lr,
                       step: int):
        """The per-row update of a SparseRowGrad (the reference's
        ``ParameterOptimizer::update(vecs, config, sparseId)`` row branch,
        SparseRowCpuMatrix::sgdUpdate): sum repeated ids, clip and
        regularize the rows, gather the touched rows of the table and of
        its row-shaped slots, catch them up where the state has ``t0``,
        run ``update_one`` on the row block, and write the rows back.

        The one update that is not functional: the rows are written into
        ``p`` and its slots IN PLACE (``index_copy_``), and those same
        tensors are returned, so the step never copies the table (an
        out-of-place write of a 1M x 512 table would copy 2 GiB every
        step; the JAX step donates its buffers for the same reason).

        Semantics are the reference's lazy ones: only touched rows see
        this step, so momentum, accumulator decay and L2 act on a touch.
        Plain SGD and AdaGrad equal the dense update; with ``t0`` the
        replay makes the other rules equal it too (under a constant
        learning rate: the replay uses this step's)."""
        s = dict(s)
        t0 = s.pop("t0", None)
        rows, vals = dedup_rows(g.rows, g.values.reshape(g.rows.shape[0], -1))
        live = rows >= 0
        idx = rows[live].long()                 # the touched rows, once each
        vals = vals[live].reshape((idx.shape[0],) + p.shape[1:]).to(p.dtype)
        if self.clip_threshold and not self.global_clipping:
            vals = clip_by_value(vals, self.clip_threshold)
        p_rows = p[idx]
        if self.regularization is not None:
            vals = self.regularization.apply(vals, p_rows, lr)
        row_slots = {k for k, v in s.items()
                     if torch.is_tensor(v) and v.shape == p.shape}
        s_rows = {k: (v[idx] if k in row_slots else v) for k, v in s.items()}
        if t0 is not None:
            gap = torch.clamp(step - 1 - t0[idx], min=0)
            p_rows, s_rows = self.catch_up_rows(p_rows, dict(s_rows), gap,
                                                plr)
        new_p_rows, new_s_rows = self.update_one(vals, p_rows, s_rows, plr)
        p.index_copy_(0, idx, new_p_rows.to(p.dtype))
        new_s = {}
        for k, v in s.items():
            if k in row_slots:
                new_s[k] = v.index_copy_(0, idx, new_s_rows[k])
            else:
                new_s[k] = new_s_rows.get(k, v)
        if t0 is not None:
            new_s["t0"] = t0.index_fill_(0, idx, step)
        return p, new_s

    def catch_up_rows(self, p_rows, s_rows: dict, gap, lr):
        """Replay ``gap[i]`` skipped zero-gradient dense steps of row i of
        a lazily updated table, before its real update. The base rule is
        the identity: right wherever a zero-gradient step moves nothing
        (plain SGD, AdaGrad). Rules whose zero-gradient step moves state
        override it."""
        return p_rows, s_rows


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

    def catch_up_rows(self, p_rows, s_rows, gap, lr):
        """A zero-gradient momentum step still moves the parameter
        (mom_j = mu*mom_{j-1}; p_j = p_{j-1} + mom_j): in closed form, p +=
        mom * sum_{j=1..gap} mu^j (nesterov: mu^{j+1}), mom *= mu^gap."""
        if not self.momentum or "mom" not in s_rows:
            return p_rows, s_rows
        mu = self.momentum
        g = _trail(gap.to(p_rows.dtype), p_rows)
        decay = torch.pow(mu, g)
        series = g if mu >= 1.0 else mu * (1.0 - decay) / (1.0 - mu)
        mom = s_rows["mom"]
        p_rows = p_rows + mom * (mu * series if self.nesterov else series)
        return p_rows, {**s_rows, "mom": mom * decay}


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

    def catch_up_rows(self, p_rows, s_rows, gap, lr):
        """A zero-gradient step leaves p and multiplies accum by rho:
        rho^gap on a touch, the reference's DecayedAdagrad catch-up
        (FirstOrderOptimizer.cpp:203)."""
        g = _trail(gap.to(s_rows["accum"].dtype), s_rows["accum"])
        return p_rows, {**s_rows,
                        "accum": s_rows["accum"] * torch.pow(self.rho, g)}


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

    def catch_up_rows(self, p_rows, s_rows, gap, lr):
        """g = 0 gives dx = 0: p stays and both accumulators decay by
        rho, rho^gap on a touch."""
        g = _trail(gap.to(s_rows["accum_g"].dtype), s_rows["accum_g"])
        decay = torch.pow(self.rho, g)
        return p_rows, {**s_rows, "accum_g": s_rows["accum_g"] * decay,
                        "accum_x": s_rows["accum_x"] * decay}


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

    def catch_up_rows(self, p_rows, s_rows, gap, lr):
        """g = 0 moves nothing (the update is proportional to g) and both
        moments decay by rho: rho^gap on a touch."""
        g = _trail(gap.to(s_rows["accum_g2"].dtype), s_rows["accum_g2"])
        decay = torch.pow(self.rho, g)
        return p_rows, {**s_rows, "accum_g2": s_rows["accum_g2"] * decay,
                        "accum_g": s_rows["accum_g"] * decay}


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

    def catch_up_rows(self, p_rows, s_rows, gap, lr):
        """Zero-gradient Adam steps decay m and v (closed form: b^gap) AND
        move p, each step's bias correction tied to its global t: no
        closed form for p, so its skipped steps are summed by
        ``_replayed_sum``. Row i's skipped step j ran at t = t_now -
        gap[i] + j, as in the dense run."""
        if "m" not in s_rows:
            return p_rows, s_rows
        m, v = s_rows["m"], s_rows["v"]
        b1, b2, eps = self.b1, self.b2, self.eps

        def delta(j, tau, m, v):
            a = lr * torch.pow(b1, j) / (1 - torch.pow(b1, tau))
            c = torch.pow(b2, j) / (1 - torch.pow(b2, tau))
            return (a * m).div_((c * v).sqrt_().add_(eps))

        p_rows = p_rows - _replayed_sum(gap, s_rows["t"], delta, m, v)
        g = _trail(gap.to(m.dtype), m)
        return p_rows, {**s_rows, "m": m * torch.pow(b1, g),
                        "v": v * torch.pow(b2, g)}


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

    def catch_up_rows(self, p_rows, s_rows, gap, lr):
        """Zero-gradient AdaMax steps decay m by b1 and u by b2 (u >= 0,
        so max(b2*u, 0) = b2*u) AND move p with the global step's bias
        correction: summed as Adam's are."""
        if "m" not in s_rows:
            return p_rows, s_rows
        m, u = s_rows["m"], s_rows["u"]
        b1, b2 = self.b1, self.b2

        def delta(j, tau, m, u):
            a = lr * torch.pow(b1, j) / (1 - torch.pow(b1, tau))
            return (a * m).div_((torch.pow(b2, j) * u).add_(1e-12))

        p_rows = p_rows - _replayed_sum(gap, s_rows["t"], delta, m, u)
        g = _trail(gap.to(m.dtype), m)
        return p_rows, {**s_rows, "m": m * torch.pow(b1, g),
                        "u": u * torch.pow(b2, g)}


class ModelAverage:
    """Marker for Polyak averaging (AverageOptimizer analog; v2
    optimizer.py ModelAverage): pass it as ``model_average=`` to any
    optimizer, whose state then keeps the running mean of the parameters
    (``"__avg__"``); ``SGD.test`` evaluates with it and
    ``SGD.averaged_parameters()`` swaps it into the parameters. As in the
    JAX package, the mean runs over every update since the start:
    ``average_window`` and ``max_average_window`` are kept, not read."""

    def __init__(self, average_window=0.5, max_average_window=None):
        self.average_window = average_window
        self.max_average_window = max_average_window


def settings(batch_size=None, learning_rate=None, learning_method=None,
             regularization=None, gradient_clipping_threshold=None,
             learning_rate_decay_a=0.0, learning_rate_decay_b=0.0,
             learning_rate_schedule="constant", model_average=None, **kw):
    """v1 DSL settings() analog (trainer_config_helpers/optimizers.py
    settings): configures the given learning_method with the job-level
    learning rate, regularization, clipping and averaging knobs."""
    opt = learning_method or Momentum()
    if isinstance(opt, type):
        opt = opt()
    if learning_rate is not None:
        opt.lr_fn = lr_schedule(learning_rate, learning_rate_decay_a,
                                learning_rate_decay_b, learning_rate_schedule)
    if regularization is not None:
        opt.regularization = regularization
    if gradient_clipping_threshold is not None:
        opt.clip_threshold = gradient_clipping_threshold
    if model_average is not None:
        opt.model_average = model_average
    return opt
