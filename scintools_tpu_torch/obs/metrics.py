"""Thread-safe metrics registry: counters, gauges, histograms.

The port's own copy of ``scintools_tpu/obs/metrics.py``: the same
metric names, labels and export formats, so a snapshot or a scrape
reads the same from either package. Run-level quantities accumulate
here: epochs processed/quarantined, fallback-tier transitions, journal
bytes and fsyncs, prefetch-queue depth, device-idle seconds, program
builds. Two export views, both schema-stable:

- :meth:`MetricsRegistry.snapshot` — a JSON-able dict (consumed by
  the RunReport, obs/report.py);
- :meth:`MetricsRegistry.to_prometheus` — the Prometheus text
  exposition format.

One lock acquisition per update on the metric's own lock;
:func:`set_enabled` (False) turns every update into a no-op without
unwiring call sites; ``counter(name).labels(tier="jax_fused").inc()``
keeps per-tier / per-site breakdowns under one metric name, exported
Prometheus-style as ``name{tier="jax_fused"}``. Standard library only.
"""

from __future__ import annotations

import json
import re
import threading
import time

#: default histogram buckets [seconds]: spans the ~0.2 ms journal
#: fsync through multi-second epoch loads.
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0)

#: the Prometheus text exposition content type an HTTP scrape
#: endpoint must answer with (version 0.0.4 is the text-format
#: version every Prometheus server speaks).
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: process start (import time of the metrics module — the first
#: thing any survey entry point pulls in), the epoch of the
#: ``process_uptime_seconds`` gauge.
_PROCESS_START = time.time()


def process_uptime():
    """Seconds since this process imported the metrics module."""
    return time.time() - _PROCESS_START


def touch_process_metrics(registry=None):
    """Refresh the process-level gauges (currently
    ``process_uptime_seconds``) in ``registry`` (default: the
    process-wide one). Scrape handlers call this immediately before
    rendering, so the exposition always carries a fresh uptime."""
    reg = registry if registry is not None else REGISTRY
    reg.gauge("process_uptime_seconds",
              help="seconds since process start").set(process_uptime())


def _label_key(labels):
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _full_name(name, key):
    if not key:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return f"{name}{{{inner}}}"


_FULL_NAME_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def parse_full_name(full):
    """Split a snapshot full name (``name{a="1",b="2"}``) back into
    ``(name, {label: value})`` — the inverse of the exporter's
    :func:`_full_name`. An unparseable string round-trips as a bare
    name with no labels (aggregation must not crash on a foreign
    snapshot)."""
    m = _FULL_NAME_RE.match(str(full))
    if not m:
        return str(full), {}
    return m.group(1), dict(_LABEL_RE.findall(m.group(2) or ""))


def canonical_full_name(full):
    """Full name with its labels re-sorted into the registry's
    canonical order — the label-collision normaliser: two snapshots
    spelling ``m{a="1",b="2"}`` and ``m{b="2",a="1"}`` must fold into
    ONE sample, not two."""
    name, labels = parse_full_name(full)
    return _full_name(name, _label_key(labels))


def _le_sort_key(le):
    """Numeric sort key of a histogram ``le`` label (``+Inf`` last;
    an unparseable boundary sorts with ``+Inf`` rather than
    raising)."""
    try:
        return float("inf") if le == "+Inf" else float(le)
    except (TypeError, ValueError):
        return float("inf")


def bucket_deltas(buckets):
    """Cumulative ``{le: count}`` → per-bucket increments keyed by
    the same boundaries (ascending). The inverse of cumulation — the
    representation in which histograms from workers with DIFFERENT
    bucket sets merge exactly (each increment stays attached to its
    own upper boundary, so the merged cumulation over the boundary
    union is correct and monotone)."""
    out = {}
    prev = 0
    for le, n in sorted(dict(buckets).items(),
                        key=lambda kv: _le_sort_key(kv[0])):
        n = int(n)
        out[le] = out.get(le, 0) + n - prev
        prev = n
    return out


def cumulate_deltas(deltas):
    """Per-bucket increments → cumulative ``{le: count}`` over the
    boundaries present, ascending (``+Inf`` last)."""
    out = {}
    running = 0
    for le in sorted(deltas, key=_le_sort_key):
        running += int(deltas[le])
        out[le] = running
    return out


def merge_bucket_sets(a, b):
    """Merge two cumulative bucket dicts BY BOUNDARY: both are
    de-cumulated onto their own boundaries, the increments summed
    over the boundary union, and the result re-cumulated. Positional
    merging silently mis-bins when
    worker builds disagree on bucket sets; boundary merging is exact
    because a count ≤ b stays ≤ b in any superset of boundaries."""
    da = bucket_deltas(a)
    for le, n in bucket_deltas(b).items():
        da[le] = da.get(le, 0) + n
    return cumulate_deltas(da)


class _Metric:
    """Base: a named family of label-children sharing one lock."""

    kind = "untyped"

    def __init__(self, name, help="", registry=None):
        self.name = name
        self.help = help
        self._registry = registry
        self._lock = threading.Lock()
        self._children = {}

    def _enabled(self):
        return self._registry is None or self._registry.enabled

    def labels(self, **labels):
        """A child bound to one label set (created on first use)."""
        return _Child(self, _label_key(labels))

    def _items(self):
        with self._lock:
            return sorted(self._children.items())


class _Child:
    """View of one label set of a metric; forwards every update."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric, key):
        self._metric = metric
        self._key = key

    def inc(self, n=1):
        self._metric._inc(self._key, n)

    def dec(self, n=1):
        self._metric._inc(self._key, -n)

    def set(self, value):
        self._metric._set(self._key, value)

    def observe(self, value):
        self._metric._observe(self._key, value)

    @property
    def value(self):
        return self._metric._get(self._key)


class Counter(_Metric):
    """Monotonic counter. ``inc(n)``; negative increments rejected."""

    kind = "counter"

    def inc(self, n=1):
        self._inc((), n)

    def _inc(self, key, n):
        if not self._enabled():
            return
        if n < 0:
            raise ValueError("counters only go up (use a gauge)")
        with self._lock:
            self._children[key] = self._children.get(key, 0) + n

    def _get(self, key=()):
        with self._lock:
            return self._children.get(key, 0)

    @property
    def value(self):
        return self._get()


class Gauge(_Metric):
    """Last-write-wins instantaneous value; ``set``/``inc``/``dec``."""

    kind = "gauge"

    def set(self, value):
        self._set((), value)

    def inc(self, n=1):
        self._inc((), n)

    def dec(self, n=1):
        self._inc((), -n)

    def _set(self, key, value):
        if not self._enabled():
            return
        with self._lock:
            self._children[key] = float(value)

    def _inc(self, key, n):
        if not self._enabled():
            return
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + n

    def _get(self, key=()):
        with self._lock:
            return self._children.get(key, 0.0)

    @property
    def value(self):
        return self._get()


class Histogram(_Metric):
    """Fixed-bucket histogram: per-label ``count``/``sum`` plus
    cumulative bucket counts (Prometheus ``le`` convention, implicit
    ``+Inf`` bucket)."""

    kind = "histogram"

    def __init__(self, name, help="", registry=None,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help=help, registry=registry)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def observe(self, value):
        self._observe((), value)

    def _observe(self, key, value):
        if not self._enabled():
            return
        value = float(value)
        with self._lock:
            st = self._children.get(key)
            if st is None:
                st = self._children[key] = {
                    "count": 0, "sum": 0.0,
                    "bucket_counts": [0] * (len(self.buckets) + 1)}
            st["count"] += 1
            st["sum"] += value
            for i, b in enumerate(self.buckets):
                if value <= b:
                    st["bucket_counts"][i] += 1
                    break
            else:
                st["bucket_counts"][-1] += 1

    def _get(self, key=()):
        with self._lock:
            st = self._children.get(key)
            return dict(st) if st else {"count": 0, "sum": 0.0,
                                        "bucket_counts": []}

    def _cumulative(self, st):
        """``{le_label: cumulative_count}`` including ``+Inf``."""
        out = {}
        running = 0
        for b, n in zip(self.buckets, st["bucket_counts"]):
            running += n
            out[repr(b)] = running
        out["+Inf"] = running + st["bucket_counts"][-1]
        return out


class MetricsRegistry:
    """Process-wide metric store. ``counter``/``gauge``/``histogram``
    return the existing metric for a repeated name (same-kind check),
    so call sites never coordinate creation."""

    def __init__(self, enabled=True):
        self._lock = threading.Lock()
        self._metrics = {}
        self.enabled = bool(enabled)

    def set_enabled(self, flag):
        """Toggle every update under this registry (False = all
        ``inc``/``set``/``observe`` become no-ops; reads still work)."""
        self.enabled = bool(flag)

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help=help,
                                              registry=self, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name, help=""):
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help=""):
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="", buckets=DEFAULT_BUCKETS):
        return self._get_or_create(Histogram, name, help,
                                   buckets=buckets)

    def reset(self):
        """Drop every metric (test isolation; the enabled flag is
        kept)."""
        with self._lock:
            self._metrics = {}

    def metrics(self):
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self):
        """JSON-able dict of everything:
        ``{"counters": {full_name: value}, "gauges": {...},
        "histograms": {full_name: {"count", "sum", "buckets"}}}``.
        Round-trips through ``json.dumps``/``loads`` unchanged (tests
        pin this)."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self.metrics():
            for key, val in m._items():
                full = _full_name(m.name, key)
                if m.kind == "counter":
                    out["counters"][full] = val
                elif m.kind == "gauge":
                    out["gauges"][full] = val
                else:
                    out["histograms"][full] = {
                        "count": val["count"],
                        "sum": val["sum"],
                        "buckets": m._cumulative(val)}
        return out

    def to_prometheus(self):
        """Prometheus text exposition format: one ``# HELP`` AND one
        ``# TYPE`` header per metric family (HELP falls back to the
        metric name so scrapers that require the pair never see a
        bare family), histogram ``_bucket``/``_sum``/``_count``
        expansion. Serve it with :data:`PROMETHEUS_CONTENT_TYPE`."""
        lines = []
        for m in self.metrics():
            lines.append(f"# HELP {m.name} {m.help or m.name}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, val in m._items():
                if m.kind in ("counter", "gauge"):
                    lines.append(f"{_full_name(m.name, key)} {val}")
                    continue
                for le, n in m._cumulative(val).items():
                    lkey = key + (("le", le),)
                    lines.append(
                        f"{_full_name(m.name + '_bucket', lkey)} {n}")
                lines.append(
                    f"{_full_name(m.name + '_sum', key)} {val['sum']}")
                lines.append(
                    f"{_full_name(m.name + '_count', key)} "
                    f"{val['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self, **kw):
        return json.dumps(self.snapshot(), **kw)


def aggregate_snapshots(snapshots):
    """Fold N :meth:`MetricsRegistry.snapshot` dicts (e.g. one per
    worker process, shipped through their heartbeat files) into
    one pod-level view with the same schema: counters and histogram
    counts/sums/buckets SUM across workers; gauges sum too — the
    per-worker gauges this is used on (backlog, queue depth) are
    additive, and a pod-level "last writer wins" would be
    meaningless across processes. Malformed entries are skipped (a
    heartbeat from an older worker build must not kill the pod
    aggregation).

    Two cross-build hazards are normalised away:

    - **label collisions** — full names are canonicalised
      (:func:`canonical_full_name`) before summing, so two snapshots
      spelling the same label set in a different order fold into one
      sample;
    - **mismatched histogram buckets** — bucket dicts merge BY
      BOUNDARY (:func:`merge_bucket_sets`), never positionally, so
      workers built with different bucket tables still produce a
      monotone, exactly-binned merged histogram.
    """
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for snap in snapshots:
        if not isinstance(snap, dict):
            continue
        for kind in ("counters", "gauges"):
            for name, val in dict(snap.get(kind) or {}).items():
                if not isinstance(val, (int, float)):
                    continue
                name = canonical_full_name(name)
                out[kind][name] = out[kind].get(name, 0) + val
        for name, st in dict(snap.get("histograms") or {}).items():
            if not isinstance(st, dict):
                continue
            name = canonical_full_name(name)
            agg = out["histograms"].setdefault(
                name, {"count": 0, "sum": 0.0, "buckets": {}})
            agg["count"] += int(st.get("count", 0))
            agg["sum"] += float(st.get("sum", 0.0))
            agg["buckets"] = merge_bucket_sets(
                agg["buckets"], dict(st.get("buckets") or {}))
    return out


#: the process-wide default registry every library call site uses.
REGISTRY = MetricsRegistry()


def counter(name, help=""):
    return REGISTRY.counter(name, help=help)


def gauge(name, help=""):
    return REGISTRY.gauge(name, help=help)


def histogram(name, help="", buckets=DEFAULT_BUCKETS):
    return REGISTRY.histogram(name, help=help, buckets=buckets)


def set_enabled(flag):
    REGISTRY.set_enabled(flag)


def enabled():
    return REGISTRY.enabled


def snapshot():
    return REGISTRY.snapshot()
