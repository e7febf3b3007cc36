"""Deterministic fault injection for chaos testing (counterpart of
``paddle_tpu/distributed/faults.py``).

Faults are injected at named I/O boundaries: each injection point counts
its triggers, and a FaultPlan fires scripted faults at exact trigger
ordinals, so a chaos run is a pure function of (plan, workload) and
replays bit for bit. The port wires two points so far:

- ``checkpoint.write``  (io.checkpoint's atomic writer, before the rename)
- ``reader.next``       (reader.decorator.checkpointable, per item)

Actions: ``drop`` (raise FaultError, a ConnectionError), ``delay``/
``stall`` (sleep ``seconds``), ``kill`` (os._exit: the SIGKILL analog,
no cleanup), ``torn`` (truncate the in-flight temp file to half and
raise: a torn write).

Usage::

    plan = FaultPlan([FaultSpec("checkpoint.write", "torn", at=2)])
    with plan.installed():
        ...  # the second file the checkpoint writer lands is torn

Plans also load from JSON (``FaultPlan.from_json``) and install in a
subprocess when ``PADDLE_TPU_FAULT_PLAN`` names a plan file
(``install_from_env``), the variable the JAX package reads too.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional


class FaultError(ConnectionError):
    """An injected connection-level fault (subclasses ConnectionError so
    production retry/fallback paths handle it exactly like the real
    thing)."""


class TornWriteError(OSError):
    """An injected torn write: the writer crashed mid-file."""


_ACTIONS = ("drop", "delay", "stall", "kill", "torn")


class FaultSpec:
    """One scripted fault: fire ``action`` at trigger ordinals
    [``at``, ``at + count``) of injection point ``point`` (1-based)."""

    def __init__(self, point: str, action: str, at: int = 1, count: int = 1,
                 seconds: float = 0.05, exit_code: int = 137):
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r} "
                             f"(one of {_ACTIONS})")
        if at < 1 or count < 1:
            raise ValueError("at and count are 1-based and positive")
        self.point = point
        self.action = action
        self.at = at
        self.count = count
        self.seconds = seconds
        self.exit_code = exit_code

    def to_dict(self) -> dict:
        return {"point": self.point, "action": self.action, "at": self.at,
                "count": self.count, "seconds": self.seconds,
                "exit_code": self.exit_code}

    def __repr__(self):
        return (f"FaultSpec({self.point!r}, {self.action!r}, at={self.at}, "
                f"count={self.count})")


class FaultPlan:
    """A deterministic script of faults over named injection points."""

    def __init__(self, specs: Optional[List[FaultSpec]] = None, seed: int = 0):
        self.specs = list(specs or [])
        self.seed = seed
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._fired: List[tuple] = []

    # --- bookkeeping ------------------------------------------------------
    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def fired(self) -> List[tuple]:
        """[(point, ordinal, action), ...] in firing order — the replay
        transcript tests compare across runs for determinism."""
        with self._lock:
            return list(self._fired)

    # --- the injection call ----------------------------------------------
    def fire(self, point: str, **ctx):
        with self._lock:
            n = self._counters.get(point, 0) + 1
            self._counters[point] = n
            hits = [s for s in self.specs
                    if s.point == point and s.at <= n < s.at + s.count]
            for s in hits:
                self._fired.append((point, n, s.action))
        for s in hits:
            self._execute(s, point, n, ctx)

    def _execute(self, spec: FaultSpec, point: str, n: int, ctx: dict):
        if spec.action == "drop":
            raise FaultError(f"injected drop at {point}#{n}")
        if spec.action in ("delay", "stall"):
            time.sleep(spec.seconds)
            return
        if spec.action == "kill":
            # SIGKILL analog: no cleanup handlers run, buffers are lost
            os._exit(spec.exit_code)
        if spec.action == "torn":
            f = ctx.get("file")
            if f is not None:
                try:
                    f.flush()
                    size = f.tell()
                    f.truncate(max(size // 2, 0))
                except (OSError, ValueError):
                    pass
            raise TornWriteError(f"injected torn write at {point}#{n}")

    # --- (de)serialization ------------------------------------------------
    def to_json(self, path: str):
        with open(path, "w") as f:
            json.dump({"seed": self.seed,
                       "specs": [s.to_dict() for s in self.specs]}, f)

    @classmethod
    def from_json(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            d = json.load(f)
        return cls([FaultSpec(**s) for s in d.get("specs", [])],
                   seed=d.get("seed", 0))

    # --- installation -----------------------------------------------------
    def installed(self):
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            install(self)
            try:
                yield self
            finally:
                clear()

        return _ctx()


_active: Optional[FaultPlan] = None
_active_lock = threading.Lock()

PLAN_ENV = "PADDLE_TPU_FAULT_PLAN"


def install(plan: FaultPlan):
    global _active
    with _active_lock:
        _active = plan


def clear():
    global _active
    with _active_lock:
        _active = None


def active() -> Optional[FaultPlan]:
    return _active


def install_from_env() -> Optional[FaultPlan]:
    """Install the plan named by $PADDLE_TPU_FAULT_PLAN (chaos subprocess
    bootstrap); returns it, or None when the env var is unset."""
    path = os.environ.get(PLAN_ENV)
    if not path:
        return None
    plan = FaultPlan.from_json(path)
    install(plan)
    return plan


def fire(point: str, **ctx):
    """The hot-path hook: no-op unless a plan is installed."""
    plan = _active
    if plan is not None:
        plan.fire(point, **ctx)
