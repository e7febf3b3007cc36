"""Telemetry egress (counterpart of
``paddle_tpu/observability/exporter.py``): a scrapeable HTTP endpoint and
a headless file exporter. Nothing starts unless asked; exporters only
read the registry, so turning one on changes no behaviour.

- ``MetricsHTTPServer``: background ThreadingHTTPServer serving
    ``/metrics``       Prometheus text exposition (scrape target)
    ``/metrics.json``  the same snapshot as JSON
    ``/healthz``       liveness: {"status": "ok", "uptime_s": ...}
    ``/trace``         Chrome trace-event JSON from the global tracer
- ``FileExporter``: a daemon thread appending one JSON snapshot line per
  interval to a file; the last line is always the freshest snapshot.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability import trace as _trace


class MetricsHTTPServer:
    """Background HTTP server over a registry (+ the global tracer)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 tracer: Optional[_trace.Tracer] = None):
        registry = registry or _metrics.default_registry
        tracer = tracer or _trace.global_tracer
        started = time.time()

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        body = registry.to_prometheus().encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif path == "/metrics.json":
                        body = json.dumps(registry.to_json()).encode()
                        ctype = "application/json"
                    elif path == "/healthz":
                        body = json.dumps(
                            {"status": "ok", "pid": os.getpid(),
                             "uptime_s": round(time.time() - started, 3)}
                        ).encode()
                        ctype = "application/json"
                    elif path == "/trace":
                        body = json.dumps(tracer.to_chrome_trace()).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as e:  # scrape must never kill the server
                    self.send_error(500, str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes are not log-worthy
                pass

        class Server(ThreadingHTTPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"metrics-http-{self.port}")

    def start(self) -> "MetricsHTTPServer":
        self._thread.start()
        return self

    def stop(self):
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()


class FileExporter:
    """Periodic JSON-lines snapshot writer for headless runs. Each line:
    {"ts": epoch_seconds, "metrics": <registry.to_json()>}; a final line
    is flushed on stop() so short runs always leave one snapshot."""

    def __init__(self, path: str, interval: float = 30.0,
                 registry: Optional[_metrics.MetricsRegistry] = None):
        if interval <= 0:
            raise ValueError("FileExporter interval must be > 0")
        self.path = path
        self.interval = interval
        self.registry = registry or _metrics.default_registry
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="metrics-file-exporter")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)

    def _write_line(self):
        line = json.dumps({"ts": round(time.time(), 3),
                           "metrics": self.registry.to_json()})
        with open(self.path, "a") as f:
            f.write(line + "\n")

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self._write_line()
            except OSError:
                pass  # a full disk must not kill training

    def start(self) -> "FileExporter":
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)
        try:
            self._write_line()           # final snapshot
        except OSError:
            pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()


def start_http_server(port: int = 0, host: str = "127.0.0.1",
                      registry=None, tracer=None) -> MetricsHTTPServer:
    return MetricsHTTPServer(port, host, registry, tracer).start()


def start_file_exporter(path: str, interval: float = 30.0,
                        registry=None) -> FileExporter:
    return FileExporter(path, interval, registry).start()


def configure(metrics_port: Optional[int] = None,
              trace_dir: Optional[str] = None,
              metrics_interval: float = 0.0,
              metrics_file: Optional[str] = None) -> dict:
    """One-call wiring of the exporters (the JAX CLI's ``--metrics_port/
    --trace_dir/--metrics_interval``). Returns {"http": server?, "file": exporter?,
    "tracer": tracer?} — callers stop/save these at exit. metrics_port=0
    binds an ephemeral port (logged); None/absent disables HTTP."""
    logger = logging.getLogger("paddle_tpu_torch")

    out = {"http": None, "file": None, "tracer": None}
    try:
        if trace_dir:
            out["tracer"] = _trace.enable(trace_dir)
            logger.info("trace spans -> %s (Chrome trace JSON on save)",
                        trace_dir)
        if metrics_port is not None:
            out["http"] = start_http_server(port=metrics_port)
            logger.info("metrics exporter on http://127.0.0.1:%d/metrics",
                        out["http"].port)
        if metrics_interval and metrics_interval > 0:
            path = metrics_file or os.path.join(trace_dir or ".",
                                                "metrics.jsonl")
            out["file"] = start_file_exporter(path, metrics_interval)
            logger.info("metrics snapshots -> %s every %.1fs", path,
                        metrics_interval)
    except BaseException:
        # a half-configured egress must not leak: e.g. the tracer's sink
        # installed but the HTTP port already bound — tear down what
        # started (saving any collected trace) before re-raising, since
        # the caller never gets handles to shut down
        shutdown(out)
        raise
    return out


def shutdown(handles: dict):
    """Tear down what configure() started; saves the trace if tracing."""
    if handles.get("file") is not None:
        handles["file"].stop()
    if handles.get("http") is not None:
        handles["http"].stop()
    tracer = handles.get("tracer")
    if tracer is not None and tracer.enabled:
        try:
            path = tracer.save()
            logger = logging.getLogger("paddle_tpu_torch")
            logger.info("trace written to %s (open in Perfetto / "
                        "chrome://tracing)", path)
        except OSError:
            pass
        tracer.disable()
