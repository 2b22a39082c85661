"""Live heartbeat for long survey runs.

The port's own copy of ``scintools_tpu/obs/heartbeat.py``. A
10³-epoch survey on a quiet log is indistinguishable from a hung one.
The heartbeat emits one structured slog event (``survey.heartbeat``)
every N completed epochs or T seconds — whichever comes first —
carrying throughput, ETA, and the quarantine/fallback tallies.

Wired into ``robust/runner.py``: ``run_survey(...,
heartbeat=True)`` (or a cadence dict ``{"every_n": 50,
"every_s": 60}``, or a prebuilt :class:`Heartbeat`). Off by default:
the *events* are user-visible output a library must not emit unasked.
File heartbeats (:func:`write_heartbeat_file`,
:class:`HeartbeatScanner`) are the cross-process liveness channel of
multi-worker runs.
"""

from __future__ import annotations

import os
import threading
import time

from ..utils import slog
from . import metrics as _metrics


class Heartbeat:
    """Cadence-gated progress emitter.

    ``beat(done, **stats)`` is called once per completed epoch (cheap
    when not due); an event is emitted when ``done`` advanced by
    ``every_n`` since the last emit OR ``every_s`` wall seconds
    passed, and always when ``force=True`` (the runner forces a final
    beat so every run ends with a fresh snapshot). ``total`` enables
    the ETA estimate. Returns the emitted record (or None).

    **Streaming mode** (``streaming=True`` — a streaming
    service's mode): an open-ended stream has no meaningful epoch total, so a
    ``total``-derived ETA would be a bogus countdown to an arbitrary
    snapshot of the spool. Streaming beats therefore NEVER carry
    ``total``/``eta_s`` (even if a total was set) and instead report
    live stream health: throughput (``epochs_per_sec``) plus whatever
    ``stats_fn`` returns — the daemon supplies backlog depth and the
    ingest→publish latency percentiles there."""

    def __init__(self, every_n=25, every_s=30.0, total=None,
                 event="survey.heartbeat", streaming=False,
                 stats_fn=None):
        self.every_n = max(1, int(every_n))
        self.every_s = float(every_s)
        self.total = None if streaming else total
        self.event = event
        self.streaming = bool(streaming)
        self.stats_fn = stats_fn
        self.emitted = 0
        self._t0 = None
        self._last_t = None
        self._last_n = 0

    def beat(self, done, force=False, **stats):
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = self._last_t = now
        if force and self.emitted and self._last_n == done:
            return None               # cadence already emitted this n
        due = (force or done - self._last_n >= self.every_n
               or now - self._last_t >= self.every_s)
        if not due:
            return None
        elapsed = now - self._t0
        eps = done / elapsed if elapsed > 0 and done else None
        rec = {"done": int(done), "elapsed_s": round(elapsed, 3)}
        if self.streaming:
            rec["streaming"] = True
        if self.total is not None:
            rec["total"] = int(self.total)
        if eps is not None:
            rec["epochs_per_sec"] = round(eps, 3)
            if self.total is not None:
                rec["eta_s"] = round(
                    max(0, self.total - done) / eps, 1)
        if self.stats_fn is not None:
            rec.update(self.stats_fn())
        rec.update(stats)
        slog.log_event(self.event, **rec)
        self.emitted += 1
        self._last_t = now
        self._last_n = done
        return rec


# ---------------------------------------------------------------------
# file heartbeats — the cross-PROCESS liveness channel
# ---------------------------------------------------------------------
# A worker process can't slog into its coordinator's ring buffer; what
# it CAN do is atomically rewrite one small JSON file that the pod
# coordinator polls. Same guarantees as the queue's lease files: the
# write is temp+rename (a reader never sees a torn heartbeat) and
# staleness is judged against the reader's clock with the caller's
# skew allowance.

def write_heartbeat_file(path, now=None, writer=None, **fields):
    """Atomically (re)write a heartbeat file: ``fields`` plus a ``t``
    wall-clock stamp and the writing ``pid``. Returns the record.

    ``now`` overrides the stamp clock (so injected skew is visible to
    the scanner) and ``writer`` overrides the atomic-write call."""
    from ..parallel.checkpoint import atomic_write_json

    t = time.time() if now is None else float(now)
    rec = {"t": round(t, 3), "pid": os.getpid(), **fields}
    (writer or atomic_write_json)(os.fspath(path), rec)
    return rec


def read_heartbeat_file(path):
    """The last complete heartbeat record at ``path``, or None when
    missing/torn (a torn read is indistinguishable from a dead
    writer, and is treated the same way)."""
    import json

    try:
        with open(os.fspath(path)) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def heartbeat_age_s(rec, now=None, skew_s=0.0):
    """Seconds since the heartbeat was stamped (``inf`` for a missing
    record) — the staleness input for dead-worker detection.

    ``skew_s`` is the reader's clock-skew allowance: the
    stamp was written by the *worker's* clock and is compared
    against the *reader's*, so up to ``skew_s`` of the raw age is
    forgiven (floored at 0) — a skewed-but-alive worker is not
    reported stale."""
    if rec is None:
        return float("inf")
    now = time.time() if now is None else now
    try:
        age = now - float(rec.get("t", 0.0))
    except (TypeError, ValueError):
        return float("inf")
    if skew_s:
        age = max(0.0, age - float(skew_s))
    return age


def scan_heartbeat_dir(hb_dir, cache=None):
    """mtime/size-gated incremental scan of one heartbeat directory.

    At O(100) workers a pod monitor that re-reads and re-parses every
    heartbeat file per tick spends its whole budget on JSON; the mtime
    gate makes a quiet tick O(listdir + stat) instead. ``cache`` is a
    dict carried between calls (mutated in place):
    ``{filename: ((mtime_ns, size), record)}``. Only files whose stat
    key changed since the cached entry are re-read; entries for
    removed files are dropped.

    Returns ``(records, stats)``: ``records`` is
    ``{worker_id: record}`` (the :func:`read_heartbeat_file` view),
    ``stats`` counts the scan — ``{"n", "read", "cached",
    "removed"}`` — which is how tests pin that an unchanged file is
    never re-read.
    """
    cache = {} if cache is None else cache
    records = {}
    read = cached = 0
    try:
        names = sorted(os.listdir(os.fspath(hb_dir)))
    except FileNotFoundError:
        removed = len(cache)
        cache.clear()
        return {}, {"n": 0, "read": 0, "cached": 0,
                    "removed": removed}
    seen = set()
    for name in names:
        if not name.endswith(".json"):
            continue
        seen.add(name)
        path = os.path.join(os.fspath(hb_dir), name)
        try:
            st = os.stat(path)
        except OSError:
            continue                     # vanished mid-scan
        key = (st.st_mtime_ns, st.st_size)
        held = cache.get(name)
        if held is not None and held[0] == key:
            rec = held[1]
            cached += 1
        else:
            rec = read_heartbeat_file(path)
            read += 1
            cache[name] = (key, rec)
        if rec is not None:
            records[name[:-5]] = rec
    removed = [n for n in cache if n not in seen]
    for n in removed:
        del cache[n]
    return records, {"n": len(records), "read": read,
                     "cached": cached, "removed": len(removed)}


class HeartbeatScanner:
    """Thread-safe wrapper around :func:`scan_heartbeat_dir` shared
    by the pod monitor loop and the telemetry-plane handler threads:
    one cache, one lock, cumulative read accounting, and per-scan
    staleness export — ``fleet_heartbeat_files_read_total`` (the
    incrementality witness) plus the age-distribution gauges
    ``fleet_heartbeat_age_max_seconds`` /
    ``fleet_heartbeat_age_p50_seconds`` (a dead worker shows up as a
    runaway max while the median stays at the beat cadence).

    ``skew_s`` forgives that much reader-vs-writer clock
    disagreement in every age (see :func:`heartbeat_age_s`) — the
    pod passes its lease ``skew_s`` so the staleness gauges and the
    ``/workers`` stale flags apply the same tolerance the lease
    stealer does."""

    def __init__(self, hb_dir, export_metrics=True, skew_s=0.0):
        self.hb_dir = os.fspath(hb_dir)
        self.export_metrics = bool(export_metrics)
        self.skew_s = float(skew_s)
        self._lock = threading.Lock()
        self._cache = {}
        self.scans = 0
        self.reads = 0
        self.last_stats = {}

    def scan(self, now=None):
        """One incremental pass; returns ``{worker_id: record}``."""
        with self._lock:
            records, stats = scan_heartbeat_dir(self.hb_dir,
                                                self._cache)
            self.scans += 1
            self.reads += stats["read"]
            self.last_stats = stats
        if self.export_metrics:
            _metrics.counter(
                "fleet_heartbeat_files_read_total",
                help="heartbeat files actually (re)read by "
                     "mtime-gated scans").inc(stats["read"])
            ages = sorted(heartbeat_age_s(r, now=now,
                                          skew_s=self.skew_s)
                          for r in records.values())
            if ages:
                _metrics.gauge(
                    "fleet_heartbeat_age_max_seconds",
                    help="staleness of the stalest worker heartbeat"
                ).set(round(ages[-1], 3))
                _metrics.gauge(
                    "fleet_heartbeat_age_p50_seconds",
                    help="median worker heartbeat staleness"
                ).set(round(ages[len(ages) // 2], 3))
        return records


def as_heartbeat(spec, total=None):
    """Normalise the runner's ``heartbeat`` argument: ``None``/False →
    no heartbeat; ``True`` → default cadence; a dict → cadence kwargs;
    a :class:`Heartbeat` → used as-is. ``total`` fills the epoch count
    when the spec didn't set one."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return Heartbeat(total=total)
    if isinstance(spec, dict):
        kw = dict(spec)
        if not kw.get("streaming"):
            kw.setdefault("total", total)
        return Heartbeat(**kw)
    if isinstance(spec, Heartbeat):
        if spec.total is None and not spec.streaming:
            spec.total = total
        return spec
    raise TypeError(f"heartbeat must be None/bool/dict/Heartbeat, "
                    f"got {type(spec).__name__}")
