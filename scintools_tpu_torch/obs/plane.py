"""Pod-level telemetry plane: one merged observability surface over N
worker or daemon processes.

The port's own copy of ``scintools_tpu/obs/plane.py``; its merged
snapshots and Prometheus text are byte for byte the JAX package's for
the same inputs.

- :class:`SnapshotMerger` — the streaming, incremental form of
  :func:`obs.metrics.aggregate_snapshots`: per-worker metric snapshots
  (shipped through heartbeat files) fold into one pod view by DELTA,
  so an unchanged worker costs a dict compare. Counters and histograms
  sum pod-wide (histograms by bucket boundary); gauges keep a
  ``worker`` label;
- :func:`snapshot_to_prometheus` — Prometheus text rendering of any
  snapshot-shaped dict (``# HELP`` + ``# TYPE`` per family, histogram
  ``_bucket``/``_sum``/``_count`` expansion);
- :class:`TelemetryPlane` — the HTTP surface: the serve package's
  :class:`~scintools_tpu_torch.serve.http.TelemetryServer` with the
  plane's route table (``/metrics``, ``/state``, ``/report``,
  ``/workers``, ``/ledger``) over a duck-typed *view* object
  (fleet/telemetry.py:PodTelemetry is the fleet pod's view)."""

from __future__ import annotations

import threading

from . import metrics as _metrics


def _with_label(full, key, value):
    """Inject ``key="value"`` into a snapshot full name. An existing
    label under ``key`` (collision: the source process already
    labelled by worker) is preserved under ``<key>_src`` so neither
    attribution is lost."""
    name, labels = _metrics.parse_full_name(full)
    if key in labels:
        labels[f"{key}_src"] = labels.pop(key)
    labels[key] = str(value)
    return _metrics._full_name(name, _metrics._label_key(labels))


class SnapshotMerger:
    """Incrementally maintained pod-level merge of per-worker metric
    snapshots.

    ``update(worker, snapshot)`` folds ONLY that worker's change: the
    worker's previous contribution is subtracted (counters and
    histogram bucket deltas) and the new one added, so a monitor tick
    over O(100) workers whose heartbeats mostly didn't change does
    O(changed) work — the streaming generalisation of the one-shot
    :func:`obs.metrics.aggregate_snapshots`. A worker whose snapshot
    is unchanged is recognised by equality and skipped.

    ``merged()`` returns the aggregate in snapshot schema:

    - ``counters`` / ``histograms`` — summed pod-wide (label sets
      canonicalised, histogram buckets merged by boundary);
    - ``gauges`` — per-worker families: every sample carries a
      ``worker`` label (collisions renamed ``worker_src``).
    """

    def __init__(self, worker_label="worker"):
        self.worker_label = worker_label
        self._lock = threading.Lock()
        self._held = {}        # worker -> canonicalised snapshot
        self._counters = {}    # full -> running pod sum
        self._hists = {}       # full -> {"count","sum","deltas"}
        self._gauges = {}      # worker -> {full: value}
        self.updates = 0
        self.skipped = 0

    @staticmethod
    def _canonical(snapshot):
        """One-worker snapshot with full names canonicalised and
        malformed entries dropped (a heartbeat from an older worker
        build must not poison the pod view)."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        if not isinstance(snapshot, dict):
            return out
        for kind in ("counters", "gauges"):
            for name, val in dict(snapshot.get(kind) or {}).items():
                if isinstance(val, (int, float)):
                    out[kind][_metrics.canonical_full_name(name)] = val
        for name, st in dict(snapshot.get("histograms") or {}).items():
            if not isinstance(st, dict):
                continue
            out["histograms"][_metrics.canonical_full_name(name)] = {
                "count": int(st.get("count", 0)),
                "sum": float(st.get("sum", 0.0)),
                "buckets": {str(k): int(v) for k, v in
                            dict(st.get("buckets") or {}).items()},
            }
        return out

    def update(self, worker, snapshot):
        """Fold ``worker``'s latest snapshot; returns True when it
        changed the merge (False: identical to the held one)."""
        worker = str(worker)
        snap = self._canonical(snapshot)
        with self._lock:
            held = self._held.get(worker)
            if held == snap:
                self.skipped += 1
                return False
            old = held or {"counters": {}, "gauges": {},
                           "histograms": {}}
            for name, val in old["counters"].items():
                self._counters[name] = self._counters.get(name, 0) \
                    - val
            for name, val in snap["counters"].items():
                self._counters[name] = self._counters.get(name, 0) \
                    + val
            for name, st in old["histograms"].items():
                agg = self._hists.get(name)
                if agg is None:
                    continue
                agg["count"] -= st["count"]
                agg["sum"] -= st["sum"]
                for le, n in _metrics.bucket_deltas(
                        st["buckets"]).items():
                    agg["deltas"][le] = agg["deltas"].get(le, 0) - n
            for name, st in snap["histograms"].items():
                agg = self._hists.setdefault(
                    name, {"count": 0, "sum": 0.0, "deltas": {}})
                agg["count"] += st["count"]
                agg["sum"] += st["sum"]
                for le, n in _metrics.bucket_deltas(
                        st["buckets"]).items():
                    agg["deltas"][le] = agg["deltas"].get(le, 0) + n
            self._gauges[worker] = snap["gauges"]
            self._held[worker] = snap
            self.updates += 1
        return True

    def workers(self):
        with self._lock:
            return sorted(self._held)

    def merged(self):
        """The pod-level aggregate, snapshot-schema (see class
        docstring for the per-kind semantics)."""
        with self._lock:
            out = {"counters": dict(self._counters), "gauges": {},
                   "histograms": {}}
            for worker in sorted(self._gauges):
                for name, val in self._gauges[worker].items():
                    out["gauges"][_with_label(
                        name, self.worker_label, worker)] = val
            for name, st in self._hists.items():
                if st["count"] <= 0 and not any(st["deltas"].values()):
                    continue
                out["histograms"][name] = {
                    "count": st["count"], "sum": st["sum"],
                    "buckets": _metrics.cumulate_deltas(st["deltas"]),
                }
        return out


def snapshot_to_prometheus(snapshot, help_map=None):
    """Prometheus text exposition of a snapshot-schema dict (what
    :meth:`MetricsRegistry.snapshot`, ``aggregate_snapshots`` and
    :meth:`SnapshotMerger.merged` all emit): one ``# HELP`` and one
    ``# TYPE`` header per family (HELP falls back to the family name
    — snapshots don't carry help strings; ``help_map`` restores any
    the caller knows), samples sorted within a family, histogram
    ``_bucket``/``_sum``/``_count`` expansion with ``le`` labels.
    Serve with :data:`obs.metrics.PROMETHEUS_CONTENT_TYPE`."""
    help_map = help_map or {}
    families = {}             # (name, kind) -> [(full, payload)]
    for kind_key, kind in (("counters", "counter"),
                           ("gauges", "gauge"),
                           ("histograms", "histogram")):
        for full, payload in (snapshot.get(kind_key) or {}).items():
            name, _ = _metrics.parse_full_name(full)
            families.setdefault((name, kind), []).append(
                (full, payload))
    lines = []
    for (name, kind) in sorted(families):
        lines.append(f"# HELP {name} {help_map.get(name, name)}")
        lines.append(f"# TYPE {name} {kind}")
        for full, payload in sorted(families[(name, kind)]):
            if kind in ("counter", "gauge"):
                lines.append(f"{full} {payload}")
                continue
            base, labels = _metrics.parse_full_name(full)
            key = _metrics._label_key(labels)
            buckets = dict(payload.get("buckets") or {})
            for le in sorted(buckets,
                             key=_metrics._le_sort_key):
                lines.append(_metrics._full_name(
                    base + "_bucket", key + (("le", le),))
                    + f" {buckets[le]}")
            lines.append(f"{_metrics._full_name(base + '_sum', key)}"
                         f" {payload.get('sum', 0.0)}")
            lines.append(
                f"{_metrics._full_name(base + '_count', key)}"
                f" {payload.get('count', 0)}")
    return "\n".join(lines) + ("\n" if lines else "")


def plane_routes():
    """The plane's handler table — same route contract as
    :func:`serve.http.daemon_routes`, so the two surfaces share one
    dispatch/index/404/metric path and cannot drift."""
    from ..serve.http import ledger_route, snapshot_route

    def metrics_route(view):
        return (200, view.merged_metrics_text(),
                _metrics.PROMETHEUS_CONTENT_TYPE)

    return {
        "/metrics": metrics_route,
        "/state": snapshot_route("state_snapshot"),
        "/report": snapshot_route("report_snapshot"),
        "/workers": snapshot_route("workers_snapshot"),
        "/ledger": ledger_route,
    }


class TelemetryPlane:
    """The pod-level HTTP surface: a
    :class:`~scintools_tpu_torch.serve.http.TelemetryServer` bound to the
    plane route table over a *view* object providing
    ``merged_metrics_text()`` / ``state_snapshot()`` /
    ``report_snapshot()`` / ``workers_snapshot()``
    (fleet/telemetry.py:PodTelemetry is the fleet pod's view; a
    daemon-fleet aggregator can supply its own). ``port=0`` binds an
    ephemeral port readable at :attr:`port` before ``start()``."""

    def __init__(self, view, host="127.0.0.1", port=0):
        # lazy import: obs must stay importable without pulling the
        # serve package (which itself imports obs) at module load
        from ..serve.http import TelemetryServer

        self._server = TelemetryServer(
            view, host=host, port=port, routes=plane_routes(),
            metric_prefix="plane_http", thread_name="plane-http")
        self.view = view

    @property
    def host(self):
        return self._server.host

    @property
    def port(self):
        return self._server.port

    @property
    def url(self):
        return self._server.url

    def start(self):
        self._server.start()
        return self

    def close(self):
        self._server.close()
