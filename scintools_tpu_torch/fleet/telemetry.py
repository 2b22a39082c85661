"""The fleet pod's telemetry-plane view.

The port's own copy of ``scintools_tpu/fleet/telemetry.py``. obs/plane.py
provides the process-agnostic plane (merger, renderer, HTTP surface);
this module binds it to one live pod run:

- :class:`JournalTail` — incremental CRC-verified reader of one
  worker's append-only journal: only newly appended complete lines are
  parsed per poll, a torn tail waits for its newline;
- :class:`FleetStateTracker` — the live union of per-epoch status maps
  across worker journals, resolved first-committed-wins like the
  end-of-run merge (fleet/merge.py), so a duplicate whose payload
  differs after the attribution strip is reported at once
  (``plane.state_conflict``, ``plane_state_conflicts_total``);
- :class:`PodTelemetry` — the view the
  :class:`~scintools_tpu_torch.obs.plane.TelemetryPlane` routes call:
  ``/metrics`` (the pod's registry and the per-worker snapshots merged
  through :class:`~scintools_tpu_torch.obs.plane.SnapshotMerger`),
  ``/state`` (the tracker and the queue counts), ``/report`` (the merged
  RunReport, built mid-run from the journal tails) and ``/workers``
  (liveness and lag from the heartbeat scan).

Every refresh is incremental: heartbeat files are re-read only on mtime
change, journals only past their tail offset, metric merges only for
workers whose snapshot changed. Plane handler threads and the pod's
monitor loop share the scanner (its own lock); the tracker serialises
ingest under its lock."""

from __future__ import annotations

import json
import os
import threading
import time

from ..obs import heartbeat as _hb
from ..obs import metrics as _metrics
from ..obs import report as _report
from ..obs.plane import SnapshotMerger, snapshot_to_prometheus
# the journal line CRC — the tail reader must apply exactly the
# checker the journal writer stamps
from ..parallel.checkpoint import _line_crc
from ..utils import slog
from .merge import ATTRIBUTION_FIELDS


class JournalTail:
    """Incremental reader of one append-only CRC-JSONL journal.

    ``poll()`` returns the records appended since the last poll —
    complete lines only (the offset never advances past the last
    newline, so a torn tail is re-examined once its writer finishes
    it), CRC-verified with corrupt lines skipped and counted."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self._offset = 0
        self.lines = 0
        self.corrupt = 0

    def poll(self):
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size <= self._offset:
            return []
        with open(self.path, "rb") as fh:
            fh.seek(self._offset)
            data = fh.read(size - self._offset)
        end = data.rfind(b"\n")
        if end < 0:
            return []                      # tail still torn
        self._offset += end + 1
        out = []
        for raw in data[:end + 1].decode("utf-8",
                                         "replace").splitlines():
            raw = raw.strip()
            if not raw:
                continue
            try:
                rec = json.loads(raw)
                crc = rec.pop("crc")
                if crc != _line_crc(json.dumps(rec, default=str)):
                    raise ValueError("crc mismatch")
            except (ValueError, KeyError, TypeError):
                self.corrupt += 1
                continue
            self.lines += 1
            out.append(rec)
        return out


def _commit_key(rec, line_index):
    """First-committed-wins total order (the live twin of
    fleet/merge.py:_commit_key): commit stamp, then worker id, then
    journal position."""
    try:
        t = float(rec.get("t_commit"))
    except (TypeError, ValueError):
        t = float("inf")
    return (t, str(rec.get("worker", "")), line_index)


def _stripped(rec):
    return {k: v for k, v in rec.items()
            if k not in ATTRIBUTION_FIELDS}


class FleetStateTracker:
    """Live union of per-epoch status maps over per-worker journals.

    ``refresh()`` discovers ``<workers_root>/<id>/journal.jsonl``
    tails and ingests their new records; each epoch resolves
    first-committed-wins. An epoch recorded by TWO workers is a
    ``duplicate`` (the normal trace of a steal); duplicates whose
    payloads DIFFER after attribution strip are ``conflicts`` — the
    workload broke per-epoch determinism, and the plane surfaces it
    live (``plane.state_conflict``, ``plane_state_conflicts_total``)
    instead of leaving it to the end-of-run merge."""

    def __init__(self, workers_root, journal_name="journal.jsonl"):
        self.workers_root = os.fspath(workers_root)
        self.journal_name = journal_name
        self._lock = threading.Lock()
        self._tails = {}          # worker -> JournalTail
        self._winning = {}        # epoch -> (commit_key, record)
        self._claimants = {}      # epoch -> sorted worker ids
        self.duplicates = 0
        self.conflicts = 0

    def _discover_locked(self):
        try:
            ids = sorted(os.listdir(self.workers_root))
        except FileNotFoundError:
            return
        for wid in ids:
            path = os.path.join(self.workers_root, wid,
                                self.journal_name)
            if wid not in self._tails and os.path.exists(path):
                self._tails[wid] = JournalTail(path)

    def refresh(self):
        """Ingest newly journaled records from every worker; returns
        the number of fresh records seen."""
        fresh = 0
        with self._lock:
            self._discover_locked()
            for wid in sorted(self._tails):
                tail = self._tails[wid]
                for rec in tail.poll():
                    fresh += 1
                    self._ingest_locked(wid, rec, tail.lines)
        return fresh

    def _ingest_locked(self, wid, rec, line_index):
        key = str(rec.get("epoch"))
        ck = _commit_key(rec, line_index)
        claimants = self._claimants.setdefault(key, [])
        worker = str(rec.get("worker", wid))
        if worker not in claimants:
            claimants.append(worker)
            claimants.sort()
        held = self._winning.get(key)
        if held is None:
            self._winning[key] = (ck, rec)
            return
        self.duplicates += 1
        _metrics.counter(
            "plane_state_duplicates_total",
            help="epochs journaled by more than one worker "
                 "(the live trace of a steal)").inc()
        if _stripped(held[1]) != _stripped(rec):
            self.conflicts += 1
            _metrics.counter(
                "plane_state_conflicts_total",
                help="duplicate epoch records diverging after "
                     "attribution strip — determinism violations "
                     "caught live").inc()
            slog.log_failure(
                "plane.state_conflict", epoch=key, stage="state",
                error=ValueError(
                    "duplicate records differ after stripping "
                    "attribution — workload is not deterministic"),
                workers=list(claimants))
        if ck < held[0]:
            self._winning[key] = (ck, rec)

    def records(self):
        """``{epoch: winning record}`` — the live first-committed
        view the mid-run ``/report`` is tallied from."""
        with self._lock:
            return {k: v[1] for k, v in self._winning.items()}

    def snapshot(self):
        """The ``/state`` core: per-epoch status + claimants, plus
        the duplicate/conflict tallies."""
        with self._lock:
            epochs = {
                k: {"status": v[1].get("status", "ok"),
                    "tier": v[1].get("tier", ""),
                    "workers": list(self._claimants.get(k, ()))}
                for k, v in self._winning.items()}
            return {"epochs": epochs,
                    "duplicates": self.duplicates,
                    "conflicts": self.conflicts}


class PodTelemetry:
    """The pod's live plane view (see module docstring). Constructed
    by :class:`fleet.pod.Pod` when ``plane_port`` is set; the
    :class:`~scintools_tpu_torch.obs.plane.TelemetryPlane` handler threads
    call the four snapshot methods below, each of which refreshes
    incrementally first — a scrape always sees current state, and an
    idle fleet makes every refresh O(stat calls)."""

    def __init__(self, pod):
        self.pod = pod
        self.merger = SnapshotMerger()
        self.state = FleetStateTracker(
            os.path.join(pod.out_root, "workers"))
        self._plane = None

    # ---- lifecycle ---------------------------------------------------
    def start(self, host="127.0.0.1", port=0):
        from ..obs.plane import TelemetryPlane

        self._plane = TelemetryPlane(self, host=host,
                                     port=port).start()
        return self

    def close(self):
        if self._plane is not None:
            self._plane.close()
            self._plane = None

    @property
    def url(self):
        return None if self._plane is None else self._plane.url

    @property
    def port(self):
        return None if self._plane is None else self._plane.port

    # ---- incremental refresh ----------------------------------------
    def refresh(self):
        """One incremental pass over heartbeats (mtime-gated),
        journal tails, and the metric merge; returns the heartbeat
        records."""
        beats = self.pod.heartbeats()
        for wid in sorted(beats):
            snap = beats[wid].get("metrics")
            if isinstance(snap, dict):
                self.merger.update(wid, snap)
        self.state.refresh()
        return beats

    # ---- the four plane routes --------------------------------------
    def merged_metrics_text(self):
        """``/metrics``: the pod process's own registry folded with
        the per-worker merge — counters/histograms pod-summed,
        worker gauges ``worker``-labelled, Prometheus text. (In
        ``mode="thread"`` pods the workers share the coordinator's
        registry, so sums over-count — process mode is the exact
        deployment shape.)"""
        self.refresh()
        _metrics.touch_process_metrics()
        combined = _metrics.aggregate_snapshots(
            [_metrics.REGISTRY.snapshot(), self.merger.merged()])
        return snapshot_to_prometheus(combined)

    def state_snapshot(self):
        """``/state``: the union of per-epoch status maps plus queue
        counts — ``pending`` epochs are those the survey ordered but
        no worker journaled yet."""
        self.refresh()
        st = self.state.snapshot()
        counts = {}
        for info in st["epochs"].values():
            counts[info["status"]] = counts.get(info["status"],
                                                0) + 1
        counts["pending"] = max(
            0, len(self.pod.order) - len(st["epochs"]))
        st["counts"] = counts
        st["n_epochs"] = len(self.pod.order)
        st["queue"] = self.pod.queue_counts()
        return st

    def report_snapshot(self):
        """``/report``: the merged RunReport the pod writes at
        end-of-run, built NOW from the journal tails (schema-v1
        valid, ``in_progress`` marked)."""
        from .pod import _pod_tally

        beats = self.refresh()
        summary, outcomes, _ = _pod_tally(self.pod.order,
                                          self.state.records())
        fleet = {
            "n_workers": self.pod.n_workers,
            "mode": self.pod.mode,
            "steals": sum(int(b.get("stolen", 0))
                          for b in beats.values()),
            "lease_lost": sum(int(b.get("lease_lost", 0))
                              for b in beats.values()),
            "duplicates": self.state.duplicates,
            "conflicts": self.state.conflicts,
        }
        report = _report.build_run_report(
            summary, outcomes, wall_s=self.pod.elapsed_s(),
            runner="run_pod",
            extra={"in_progress": True, "fleet": fleet,
                   "worker_metrics": self.merger.merged()})
        return _report.validate_run_report(report)

    def workers_snapshot(self):
        """``/workers``: per-worker liveness/lag from the heartbeat
        files, plus the scan accounting that witnesses the
        incremental (mtime-gated) read path. Ages apply the pod's
        ``skew_s`` allowance (the lease-stealer convention — a
        skewed-but-beating worker is not reported stale), and the
        degraded/draining lifecycle states ride along both
        per-worker and as fleet-level counts."""
        beats = self.refresh()
        now = time.time()
        alive = {w.worker_id: bool(w.alive())
                 for w in list(self.pod.workers)}
        draining = set(getattr(self.pod, "_draining", ()))
        stale_after = max(self.pod.lease_s, 1.0)
        skew_s = float(getattr(self.pod, "skew_s", 0.0))
        workers = {}
        for wid in sorted(set(beats) | set(alive)):
            b = beats.get(wid)
            age = round(_hb.heartbeat_age_s(b, now=now,
                                            skew_s=skew_s), 3) \
                if b is not None else None
            phase = (b or {}).get("phase")
            workers[wid] = {
                "phase": phase,
                "epochs": (b or {}).get("epochs"),
                "tasks": (b or {}).get("tasks"),
                "stolen": (b or {}).get("stolen"),
                "n_ok": (b or {}).get("n_ok"),
                "n_quarantined": (b or {}).get("n_quarantined"),
                "lease_lost": (b or {}).get("lease_lost"),
                "released": (b or {}).get("released"),
                "fsop_retries": (b or {}).get("fsop_retries"),
                "pid": (b or {}).get("pid"),
                "heartbeat_age_s": age,
                "stale": bool(age is None or age > stale_after),
                "alive": alive.get(wid),
                "degraded": phase == "degraded",
                "draining": bool(
                    wid in draining or phase == "draining"),
            }
        scanner = self.pod.heartbeat_scanner
        return {"workers": workers,
                "n_alive": sum(1 for v in alive.values() if v),
                "n_degraded": sum(1 for v in workers.values()
                                  if v["degraded"]),
                "n_draining": sum(1 for v in workers.values()
                                  if v["draining"]),
                "workers_target": getattr(self.pod, "_target",
                                          None),
                "stale_after_s": stale_after,
                "skew_s": skew_s,
                "scan": {"scans": scanner.scans,
                         "files_read": scanner.reads,
                         "last": dict(scanner.last_stats)}}
