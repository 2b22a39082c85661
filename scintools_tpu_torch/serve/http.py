"""Live telemetry HTTP listener of the streaming daemon, and the serving
machinery the pod-level telemetry plane (obs/plane.py) shares.

The port's own copy of ``scintools_tpu/serve/http.py``: a stdlib
:class:`ThreadingHTTPServer` whose routing is a handler table
(:func:`daemon_routes`), so the daemon surface and the plane surface
share one dispatch path: the same ``/`` index, the same 404 with the
path listing, the same per-path request counter and latency histogram,
and the same crash-to-500 containment.

The daemon table:

==========  =====================================================
path        answer
==========  =====================================================
/           index: the paths this surface serves
/metrics    Prometheus text exposition of the process registry
            (``Content-Type: text/plain; version=0.0.4``), uptime
            refreshed per scrape
/healthz    liveness — 200 when the ingest loop and the spool
            watcher are alive and recently ticking, 503 otherwise
/readyz     readiness — 200 only when additionally every kernel and
            program the service launches is built and loaded (the
            warm-up ran, or an epoch published ok) and the daemon is
            not stopping
/report     the live RunReport snapshot (the end-of-run
            ``run_report.json`` schema plus ``in_progress``, latency
            and backlog)
/state      per-epoch status map: queued / in_flight / ok /
            quarantined / resumed / duplicate, with latency and
            backlog
/ledger     the program cost ledger snapshot (obs/ledger.py)
==========  =====================================================

A route is ``path -> fn(service) -> (status, body, content_type)``;
``content_type=None`` means "JSON-encode body". Handler threads only
READ service state through its snapshot methods (each takes the
service's lock or tolerates racy scalar reads) and never touch a device
value, so a scrape never synchronises the card."""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..obs import metrics as _metrics
from ..utils import slog


def metrics_route(service):
    """``/metrics``: the process registry, uptime freshened per
    scrape."""
    _metrics.touch_process_metrics()
    return (200, _metrics.REGISTRY.to_prometheus(),
            _metrics.PROMETHEUS_CONTENT_TYPE)


def probe_route(method_name):
    """A liveness/readiness probe route: the service method returns a
    detail dict whose ``ok`` decides 200 vs 503."""

    def route(service):
        detail = getattr(service, method_name)()
        return (200 if detail.get("ok") else 503), detail, None

    return route


def snapshot_route(method_name):
    """A JSON snapshot route bound to one service method."""

    def route(service):
        return 200, getattr(service, method_name)(), None

    return route


def ledger_route(service):
    """``/ledger``: the program cost ledger snapshot. A
    view object may supply its own ``ledger_snapshot()``; otherwise
    the process-wide ledger answers — the daemon's ledger IS the
    process ledger."""
    fn = getattr(service, "ledger_snapshot", None)
    if fn is not None:
        return 200, fn(), None
    from ..obs import ledger as _ledger

    return 200, _ledger.snapshot(), None


def daemon_routes():
    """The streaming daemon's handler table (the module docstring's
    table, as a dict)."""
    return {
        "/metrics": metrics_route,
        "/healthz": probe_route("healthy"),
        "/readyz": probe_route("ready"),
        "/report": snapshot_route("report_snapshot"),
        "/state": snapshot_route("state_snapshot"),
        "/ledger": ledger_route,
    }


class TelemetryServer:
    """Owns the listener socket (bound at construction, so an
    ephemeral ``port=0`` is known before the daemon starts) and the
    serving thread. ``start()``/``close()`` are idempotent.

    ``routes`` defaults to the daemon table; the telemetry plane
    passes its own table plus a distinct ``metric_prefix`` so the two
    surfaces' request counters stay separable."""

    def __init__(self, service, host="127.0.0.1", port=0, routes=None,
                 metric_prefix="serve_http", thread_name="serve-http"):
        self.service = service
        self.routes = dict(routes) if routes is not None \
            else daemon_routes()
        handler = _make_handler(service, self.routes, metric_prefix)
        self._httpd = ThreadingHTTPServer((host, int(port)), handler)
        self._httpd.daemon_threads = True
        self.host = self._httpd.server_address[0]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            kwargs={"poll_interval": 0.1}, name=thread_name)
        self._started = False

    def start(self):
        if not self._started:
            self._started = True
            self._thread.start()
            slog.log_event("serve.http", state="started",
                           host=self.host, port=self.port,
                           paths=sorted(self.routes))
        return self

    def close(self):
        if self._started:
            self._httpd.shutdown()
            self._thread.join(timeout=10)
            slog.log_event("serve.http", state="stopped",
                           port=self.port)
        self._httpd.server_close()
        self._started = False

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"


def _bounded_path(path, routes):
    """The bounded ``path`` metric label for a request: known route
    paths (and ``/``) keep their own label, anything else folds into
    ``"other"``: request paths are caller-controlled strings, and a
    scanner probing random URLs must not mint a label child each."""
    return path if path == "/" or path in routes else "other"


def _make_handler(service, routes, metric_prefix):
    """A request-handler class bound to one service instance and its
    route table."""

    class Handler(BaseHTTPRequestHandler):
        # access logs belong in metrics, not stderr noise
        def log_message(self, fmt, *args):
            return

        def _send(self, code, body, content_type="application/json"):
            data = body if isinstance(body, bytes) else body.encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _send_json(self, code, obj):
            self._send(code, json.dumps(obj, indent=1))

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            t0 = time.perf_counter()
            # the prefix keeps daemon vs plane request accounting
            # separable under one handler implementation
            _metrics.counter(
                f"{metric_prefix}_requests_total",
                help="telemetry requests served",
            ).labels(path=_bounded_path(path, routes)).inc()
            try:
                route = routes.get(path)
                if path == "/":
                    self._send_json(200, {
                        "service": type(service).__name__,
                        "paths": ["/"] + sorted(routes)})
                elif route is None:
                    self._send_json(404, {
                        "error": f"unknown path {path!r}",
                        "paths": ["/"] + sorted(routes)})
                else:
                    code, body, ctype = route(service)
                    if ctype is None:
                        self._send_json(code, body)
                    else:
                        self._send(code, body, ctype)
            except Exception as e:  # noqa: BLE001 — a handler crash
                # must answer 500 and never take the serving thread
                # (or the daemon) down with it
                slog.log_failure("serve.http_error", stage=path,
                                 error=e)
                try:
                    self._send_json(500, {"error": repr(e)[:300]})
                except OSError:
                    pass  # broad-except-ok: client hung up mid-error
            finally:
                _metrics.histogram(
                    f"{metric_prefix}_request_seconds",
                    help="telemetry request handling wall time",
                ).labels(path=_bounded_path(path, routes)).observe(
                    time.perf_counter() - t0)

    return Handler
