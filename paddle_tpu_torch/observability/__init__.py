"""Observability (counterpart of ``paddle_tpu/observability``): the typed
metrics registry, trace spans and their exporters. Host-side only.

- ``metrics``  — thread-safe Counter/Gauge/Histogram registry with
  consistent snapshots, deltas, Prometheus text and JSON exposition,
- ``trace``    — span tracer emitting Chrome trace-event JSON, sharing
  one namespace with ``utils.stat.timer_scope`` and the
  ``torch.profiler.record_function`` ranges,
- ``exporter`` — opt-in HTTP server (/metrics, /healthz, /trace) and a
  periodic file exporter for headless runs.
"""

from paddle_tpu_torch.observability import exporter, metrics, trace  # noqa: F401
from paddle_tpu_torch.observability.metrics import (  # noqa: F401
    COUNT_BUCKETS, DEFAULT_BUCKETS, MetricsRegistry, bench_extras, counter,
    default_registry, gauge, histogram, log_buckets)
from paddle_tpu_torch.observability.trace import global_tracer, span  # noqa: F401
from paddle_tpu_torch.observability.exporter import (  # noqa: F401
    FileExporter, MetricsHTTPServer, configure, shutdown, start_file_exporter,
    start_http_server)
