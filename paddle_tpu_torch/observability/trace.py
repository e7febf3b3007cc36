"""Span tracer emitting Chrome trace-event JSON, loadable in Perfetto
(counterpart of ``paddle_tpu/observability/trace.py``).

Host spans share one namespace with the rest of the profiling surface:
``span(name)`` records wall-clock into ``utils.stat.global_stat`` under
the same name and opens a ``torch.profiler.record_function`` range, so a
``torch.profiler`` trace of the card taken at the same time carries the
same names; while tracing is enabled, ``utils.stat.timer_scope``'s sink
feeds every ``timer_scope`` site into the same event buffer. Events are
"complete" records (ph="X", microsecond ts/dur) inside
``{"traceEvents": [...]}``; the buffer is bounded (drop-oldest).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Optional

from paddle_tpu_torch.utils import stat as _stat


class Tracer:
    """Thread-safe bounded buffer of Chrome trace events."""

    def __init__(self, max_events: int = 200_000):
        self._lock = threading.Lock()
        self._events = deque(maxlen=max_events)
        self._dropped = 0
        self._enabled = False
        self._dir: Optional[str] = None
        #: perf_counter -> wall-clock epoch offset, fixed at construction
        #: so concurrent threads' timestamps align on one axis
        self._epoch0 = time.time() - time.perf_counter()

    # --- lifecycle --------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, trace_dir: Optional[str] = None):
        """Start collecting; installs the timer_scope sink so legacy
        timer names flow into this buffer too. ``trace_dir`` is where
        ``save()`` lands by default (created eagerly so a bad path fails
        at enable time, not hours later at save time)."""
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
        self._dir = trace_dir
        self._enabled = True
        _stat.set_trace_sink(self._sink)
        return self

    def disable(self):
        self._enabled = False
        _stat.set_trace_sink(None)

    # --- recording --------------------------------------------------------
    def _sink(self, name: str, t0: float, dur: float):
        """timer_scope completion hook (name, perf_counter start, secs)."""
        self.add_complete(name, t0, dur)

    def add_complete(self, name: str, t0_perf: float, dur_s: float,
                     args: Optional[dict] = None):
        if not self._enabled:
            return
        ev = {"name": name, "ph": "X", "cat": "host",
              "ts": (self._epoch0 + t0_perf) * 1e6,
              "dur": dur_s * 1e6,
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(ev)

    def add_instant(self, name: str, args: Optional[dict] = None):
        """Instant event (ph="i"): markers like 'preempted', 'resumed'."""
        if not self._enabled:
            return
        ev = {"name": name, "ph": "i", "cat": "host", "s": "p",
              "ts": time.time() * 1e6,
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Traced scope: StatSet + a profiler range of the same name +
        a trace event."""
        rng = _stat.profiler_range(name)
        rng.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            _stat.global_stat.get(name).add(dur)
            self.add_complete(name, t0, dur, args or None)
            rng.__exit__(None, None, None)

    # --- export -----------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        meta = {"displayTimeUnit": "ms", "traceEvents": events}
        if dropped:
            meta["otherData"] = {"dropped_events": dropped}
        return meta

    def save(self, path: Optional[str] = None) -> str:
        """Write the trace JSON; default path is
        ``<trace_dir>/trace-<pid>.json``."""
        if path is None:
            d = self._dir or "."
            path = os.path.join(d, f"trace-{os.getpid()}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        os.replace(tmp, path)
        return path

    def clear(self):
        with self._lock:
            self._events.clear()
            self._dropped = 0


#: process-global tracer (disabled until enable()); the exporter's /trace
#: endpoint and ``exporter.configure(trace_dir=...)`` both talk to this one
global_tracer = Tracer()


def enable(trace_dir: Optional[str] = None) -> Tracer:
    return global_tracer.enable(trace_dir)


def disable():
    global_tracer.disable()


def span(name: str, **args):
    """Module-level convenience over the global tracer. Works (as a plain
    stat timer + profiler range) even when tracing is disabled, so call
    sites never need to guard."""
    return global_tracer.span(name, **args)
