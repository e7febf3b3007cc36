"""Hierarchical wall-clock stats and named profiler ranges (counterpart of
``paddle_tpu/utils/stat.py``; analog of paddle/utils/Stat.h:114-246,
Stat/StatSet/TimerOnce and REGISTER_TIMER_INFO).

``timer_scope`` records host wall-clock into the global StatSet and opens
a ``torch.profiler.record_function`` range under the same name, where the
JAX package opened a ``jax.named_scope``: a ``torch.profiler`` trace of
the card then shows ``feedBatch``, ``trainBatch`` and ``drainBatch`` by
name beside the kernels they enqueued. When a tracer is active
(``observability.trace.enable``), every completed scope also lands as a
Chrome trace-event span through the ``set_trace_sink`` hook.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Optional

import torch

#: observability hook: fn(name, start_perf_counter, duration_seconds),
#: installed by observability.trace when tracing is enabled
_trace_sink: Optional[Callable[[str, float, float], None]] = None


def set_trace_sink(fn: Optional[Callable[[str, float, float], None]]):
    """Install (or clear, with None) the span sink timer_scope feeds."""
    global _trace_sink
    _trace_sink = fn


def profiler_range(name: str):
    """The profiler range a named scope opens (enter/exit it around the
    work): recorded by an active ``torch.profiler``, a no-op otherwise."""
    return torch.profiler.record_function(name)


class Stat:
    __slots__ = ("name", "total", "count", "max", "min", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.count = 0
        self.max = 0.0
        self.min = float("inf")
        # per-stat lock: add() races with reader fill threads and the
        # exporter's scrape thread
        self._lock = threading.Lock()

    def add(self, seconds: float):
        with self._lock:
            self.total += seconds
            self.count += 1
            self.max = max(self.max, seconds)
            self.min = min(self.min, seconds)

    def peek(self):
        """Consistent (total, count, max, min) read."""
        with self._lock:
            return self.total, self.count, self.max, self.min

    def __repr__(self):
        total, count, mx, mn = self.peek()
        avg = total / count if count else 0.0
        mn = 0.0 if count == 0 else mn
        return (f"Stat={self.name:<30} total={total * 1e3:10.2f}ms "
                f"avg={avg * 1e3:8.3f}ms max={mx * 1e3:8.3f}ms "
                f"min={mn * 1e3:8.3f}ms count={count}")


class StatSet:
    def __init__(self):
        self._stats: Dict[str, Stat] = {}
        self._lock = threading.Lock()

    def get(self, name: str) -> Stat:
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                st = self._stats[name] = Stat(name)
            return st

    def print_all_status(self, log=print):
        """globalStat.printAllStatus() analog."""
        with self._lock:
            stats = dict(self._stats)
        for name in sorted(stats):
            log(repr(stats[name]))

    def reset(self):
        with self._lock:
            self._stats.clear()

    def to_dict(self):
        with self._lock:
            stats = dict(self._stats)
        out = {}
        for n, s in stats.items():
            total, count, mx, mn = s.peek()
            out[n] = {"total_s": total, "count": count, "max_s": mx,
                      "min_s": 0.0 if count == 0 else mn}
        return out


global_stat = StatSet()


@contextlib.contextmanager
def timer_scope(name: str, use_named_scope: bool = True):
    """REGISTER_TIMER_INFO analog: host wall-clock stat, a profiler range
    of the same name (``use_named_scope``), and a Chrome trace span when
    observability tracing is enabled."""
    rng = profiler_range(name) if use_named_scope else None
    if rng is not None:
        rng.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dur = time.perf_counter() - t0
        global_stat.get(name).add(dur)
        sink = _trace_sink
        if sink is not None:
            sink(name, t0, dur)
        if rng is not None:
            rng.__exit__(None, None, None)


def register_timer(name: str):
    """Decorator form of timer_scope (REGISTER_TIMER analog)."""
    def deco(fn):
        def wrapped(*a, **kw):
            with timer_scope(name):
                return fn(*a, **kw)
        wrapped.__name__ = getattr(fn, "__name__", name)
        return wrapped
    return deco
