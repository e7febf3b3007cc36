"""Thread-safe typed metrics registry with Prometheus-style exposition
(counterpart of ``paddle_tpu/observability/metrics.py``).

Three metric types: ``Counter`` (monotonic), ``Gauge`` (set or callback)
and ``Histogram`` (FIXED log-spaced buckets chosen at registration), each
with an optional label set. One registry-wide lock makes a ``snapshot()``
a consistent cut across every series; ``delta()`` is the change since the
previous ``delta()``; ``to_prometheus`` and ``to_json`` expose them.

The port's instrumented call sites register the JAX package's series
names and types (the trainer's ``paddle_train_*``, the checkpoint's
``paddle_checkpoint_*``, the feeder's ``paddle_feed_*``), so one
dashboard reads either package. Everything here is host-side Python:
instrumentation times around the device work and never inside it.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def log_buckets(lo: float = 1e-4, hi: float = 100.0,
                per_decade: int = 4) -> Tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds covering [lo, hi]: the
    default latency layout (100us..100s at 4 buckets/decade)."""
    if lo <= 0 or hi <= lo:
        raise ValueError("log_buckets needs 0 < lo < hi")
    n = int(math.ceil(math.log10(hi / lo) * per_decade))
    return tuple(round(lo * 10 ** (i / per_decade), 12) for i in range(n + 1))


DEFAULT_BUCKETS = log_buckets()


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integers print bare, floats repr."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()
                              and abs(v) < 1e15):
        return str(int(v))
    return repr(float(v))


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    parts = []
    for k, v in labels:
        escaped = str(v).replace("\\", "\\\\").replace('"', '\\"')
        parts.append(f'{k}="{escaped}"')
    return "{" + ",".join(parts) + "}"


class _Child:
    """One labeled series of a metric family. All mutation goes through
    the family's registry lock (consistent-snapshot contract)."""

    __slots__ = ("_family", "_labels")

    def __init__(self, family: "_Family", labels: Tuple[Tuple[str, str], ...]):
        self._family = family
        self._labels = labels

    def remove(self):
        """Drop this series (value AND any callback) from the family —
        for series tied to a finite lifetime (e.g. a lease's heartbeat-age
        gauge after the lease is released), so dead series neither
        accumulate nor keep reporting stale values."""
        fam = self._family
        with fam._lock:
            fam._values.pop(self._labels, None)
            fam._fns.pop(self._labels, None)


class CounterChild(_Child):
    def inc(self, n: float = 1):
        if n < 0:
            raise ValueError("counters only go up")
        fam = self._family
        with fam._lock:
            fam._values[self._labels] = fam._values.get(self._labels, 0) + n

    @property
    def value(self):
        fam = self._family
        with fam._lock:
            return fam._values.get(self._labels, 0)


class GaugeChild(_Child):
    def set(self, v: float):
        fam = self._family
        with fam._lock:
            fam._values[self._labels] = v
            fam._fns.pop(self._labels, None)

    def inc(self, n: float = 1):
        fam = self._family
        with fam._lock:
            fam._values[self._labels] = fam._values.get(self._labels, 0) + n

    def dec(self, n: float = 1):
        self.inc(-n)

    def set_function(self, fn: Callable[[], float]):
        """Callback gauge: evaluated at snapshot time (e.g. heartbeat age =
        now - last_beat) so scrapes see a live value without a writer."""
        fam = self._family
        with fam._lock:
            fam._fns[self._labels] = fn

    @property
    def value(self):
        fam = self._family
        with fam._lock:
            fn = fam._fns.get(self._labels)
            if fn is not None:
                return float(fn())
            return fam._values.get(self._labels, 0)


class HistogramChild(_Child):
    def observe(self, v: float):
        fam = self._family
        i = bisect.bisect_left(fam.buckets, v)
        with fam._lock:
            st = fam._values.get(self._labels)
            if st is None:
                st = fam._values[self._labels] = \
                    [[0] * (len(fam.buckets) + 1), 0.0, 0]
            st[0][i] += 1
            st[1] += v
            st[2] += 1

    def time(self):
        """Context manager observing the elapsed wall-clock seconds."""
        return _HistTimer(self)

    @property
    def count(self):
        fam = self._family
        with fam._lock:
            st = fam._values.get(self._labels)
            return st[2] if st else 0

    @property
    def sum(self):
        fam = self._family
        with fam._lock:
            st = fam._values.get(self._labels)
            return st[1] if st else 0.0


class _HistTimer:
    __slots__ = ("_h", "_t0")

    def __init__(self, h: HistogramChild):
        self._h = h

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._h.observe(time.perf_counter() - self._t0)
        return False


_CHILD_TYPES = {"counter": CounterChild, "gauge": GaugeChild,
                "histogram": HistogramChild}


class _Family:
    """A named metric family: type + help + label names + its series."""

    def __init__(self, registry: "MetricsRegistry", name: str, kind: str,
                 help_str: str, labelnames: Tuple[str, ...],
                 buckets: Optional[Tuple[float, ...]] = None):
        self.registry = registry
        self.name = name
        self.kind = kind
        self.help = help_str
        self.labelnames = labelnames
        self.buckets: Tuple[float, ...] = buckets or ()
        self._lock = registry._lock
        # counter/gauge: labels -> number; histogram: labels ->
        # [per-bucket counts (+overflow), sum, count]
        self._values: Dict[Tuple[Tuple[str, str], ...], object] = {}
        self._fns: Dict[Tuple[Tuple[str, str], ...], Callable] = {}
        self._default = _CHILD_TYPES[kind](self, ())

    def labels(self, **kw) -> _Child:
        if tuple(sorted(kw)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(kw))}")
        key = tuple((k, str(kw[k])) for k in self.labelnames)
        return _CHILD_TYPES[self.kind](self, key)

    # unlabeled convenience passthroughs
    def inc(self, n: float = 1):
        self._require_unlabeled()
        self._default.inc(n)

    def set(self, v: float):
        self._require_unlabeled()
        self._default.set(v)

    def dec(self, n: float = 1):
        self._require_unlabeled()
        self._default.dec(n)

    def set_function(self, fn):
        self._require_unlabeled()
        self._default.set_function(fn)

    def observe(self, v: float):
        self._require_unlabeled()
        self._default.observe(v)

    def time(self):
        self._require_unlabeled()
        return self._default.time()

    @property
    def value(self):
        return self._default.value

    @property
    def count(self):
        return self._default.count

    @property
    def sum(self):
        return self._default.sum

    def _require_unlabeled(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}; "
                             "use .labels(...)")

    def _snapshot_locked(self) -> dict:
        """Caller holds the registry lock."""
        out = {}
        if self.kind == "histogram":
            for key, st in self._values.items():
                out[key] = {"buckets": list(st[0]), "sum": st[1],
                            "count": st[2]}
        else:
            for key, v in self._values.items():
                out[key] = v
            for key, fn in self._fns.items():
                try:
                    out[key] = float(fn())
                except Exception:  # a broken callback must not kill a scrape
                    out[key] = float("nan")
        return out


class MetricsRegistry:
    """The typed registry. ``counter``/``gauge``/``histogram`` are
    get-or-create (module-level instrumentation re-imports freely); a
    name re-registered with a different type/labels raises."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}
        self._last_delta: Optional[dict] = None

    # --- registration -----------------------------------------------------
    def _register(self, name: str, kind: str, help_str: str,
                  labelnames: Sequence[str],
                  buckets: Optional[Sequence[float]] = None) -> _Family:
        labelnames = tuple(labelnames or ())
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind} "
                        f"with labels {fam.labelnames}")
                if kind == "histogram" and buckets is not None \
                        and tuple(buckets) != fam.buckets:
                    # silently landing observations in another layout
                    # would break the fixed-bucket premise
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {fam.buckets}")
                return fam
            fam = _Family(self, name, kind, help_str, labelnames,
                          tuple(buckets) if buckets else
                          (DEFAULT_BUCKETS if kind == "histogram" else None))
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_str: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._register(name, "counter", help_str, labels)

    def gauge(self, name: str, help_str: str = "",
              labels: Sequence[str] = ()) -> _Family:
        return self._register(name, "gauge", help_str, labels)

    def histogram(self, name: str, help_str: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> _Family:
        return self._register(name, "histogram", help_str, labels, buckets)

    # --- reading ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Consistent point-in-time cut of every series:
        {name: {"type", "help", "labelnames", "buckets"?, "series":
        {label_tuple: value-or-hist-dict}}}."""
        with self._lock:
            out = {}
            for name, fam in sorted(self._families.items()):
                entry = {"type": fam.kind, "help": fam.help,
                         "labelnames": list(fam.labelnames),
                         "series": fam._snapshot_locked()}
                if fam.kind == "histogram":
                    entry["buckets"] = list(fam.buckets)
                out[name] = entry
            return out

    def delta(self) -> dict:
        """Snapshot of CHANGE since the previous ``delta()`` call (first
        call: since process start). Counters/histograms subtract; gauges
        report their current value (a gauge delta is meaningless)."""
        snap = self.snapshot()
        prev = self._last_delta
        self._last_delta = snap
        if prev is None:
            return snap
        out = {}
        for name, entry in snap.items():
            pentry = prev.get(name)
            d = dict(entry)
            series = {}
            for key, v in entry["series"].items():
                pv = (pentry or {"series": {}})["series"].get(key)
                if entry["type"] == "gauge" or pv is None:
                    series[key] = v
                elif entry["type"] == "histogram":
                    series[key] = {
                        "buckets": [a - b for a, b in zip(v["buckets"],
                                                          pv["buckets"])],
                        "sum": v["sum"] - pv["sum"],
                        "count": v["count"] - pv["count"]}
                else:
                    series[key] = v - pv
            d["series"] = series
            out[name] = d
        return out

    def to_prometheus(self, snapshot: Optional[dict] = None) -> str:
        """Prometheus text exposition format 0.0.4."""
        snap = snapshot if snapshot is not None else self.snapshot()
        lines: List[str] = []
        for name, entry in snap.items():
            if entry["help"]:
                lines.append(f"# HELP {name} {entry['help']}")
            lines.append(f"# TYPE {name} {entry['type']}")
            if entry["type"] == "histogram":
                buckets = entry["buckets"]
                for key, st in sorted(entry["series"].items()):
                    cum = 0
                    for le, n in zip(buckets, st["buckets"]):
                        cum += n
                        lines.append(
                            f"{name}_bucket"
                            f"{_label_str(key + (('le', _fmt(le)),))} {cum}")
                    cum += st["buckets"][-1]
                    lines.append(
                        f"{name}_bucket"
                        f"{_label_str(key + (('le', '+Inf'),))} {cum}")
                    lines.append(f"{name}_sum{_label_str(key)} "
                                 f"{_fmt(st['sum'])}")
                    lines.append(f"{name}_count{_label_str(key)} "
                                 f"{st['count']}")
            else:
                for key, v in sorted(entry["series"].items()):
                    lines.append(f"{name}{_label_str(key)} {_fmt(v)}")
        return "\n".join(lines) + "\n"

    def to_json(self, snapshot: Optional[dict] = None) -> dict:
        """JSON-serializable dump (label tuples flattened to
        'k=v,k2=v2' strings; '' for the unlabeled series)."""
        snap = snapshot if snapshot is not None else self.snapshot()
        out = {}
        for name, entry in snap.items():
            series = {",".join(f"{k}={v}" for k, v in key): val
                      for key, val in entry["series"].items()}
            e = {"type": entry["type"], "help": entry["help"],
                 "series": series}
            if entry["type"] == "histogram":
                e["buckets"] = entry["buckets"]
            out[name] = e
        return out

    def reset(self):
        """Zero every series (definitions survive). Test isolation only."""
        with self._lock:
            for fam in self._families.values():
                fam._values.clear()
                fam._fns.clear()
            self._last_delta = None


#: process-global default registry — all built-in instrumentation lands
#: here; libraries embedding paddle_tpu_torch can pass their own registry to the
#: exporter instead
default_registry = MetricsRegistry()


def counter(name: str, help_str: str = "", labels: Sequence[str] = ()):
    return default_registry.counter(name, help_str, labels)


def gauge(name: str, help_str: str = "", labels: Sequence[str] = ()):
    return default_registry.gauge(name, help_str, labels)


def histogram(name: str, help_str: str = "", labels: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None):
    return default_registry.histogram(name, help_str, labels, buckets)


#: fixed integer-ish buckets for tick/count histograms (decode ticks,
#: queue depths): 1..4096 at powers of two
COUNT_BUCKETS = tuple(float(2 ** i) for i in range(13))


def bench_extras(delta: Optional[dict] = None,
                 registry: Optional[MetricsRegistry] = None) -> dict:
    """Compact nonzero-only summary for bench JSON artifacts: counter
    totals, gauge values, histogram (count, sum). Keys flatten to
    'name{k=v}'."""
    reg = registry or default_registry
    snap = delta if delta is not None else reg.snapshot()
    out = {}
    for name, entry in snap.items():
        for key, v in entry["series"].items():
            flat = name + (_label_str(key) if key else "")
            if entry["type"] == "histogram":
                if v["count"]:
                    out[flat] = {"count": v["count"],
                                 "sum_s": round(v["sum"], 6)}
            elif v:
                out[flat] = round(v, 6) if isinstance(v, float) else v
    return out
