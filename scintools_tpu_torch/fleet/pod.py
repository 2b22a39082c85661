"""Pod coordinator: launch, monitor, merge — one survey, N workers.

The port's own copy of ``scintools_tpu/fleet/pod.py``. The pod owns the
shared queue directory, seeds it with epoch-batch tasks, launches N
worker processes (fleet/worker.py), watches their heartbeat files and
exit codes, aggregates their metrics into pod-level gauges, and — once
the queue drains — merges the per-worker journals into the canonical
survey journal (fleet/merge.py) and one merged RunReport.

Failure model:

- a worker SIGKILLed mid-task stops heartbeating; its lease expires and
  a surviving worker STEALS the task — the pod counts the death
  (``fleet.worker_dead``, ``fleet_workers_dead_total``) and keeps
  watching;
- if EVERY worker dies with work outstanding, the pod spawns recovery
  workers (up to ``max_recoveries``);
- a worker that dies of a kernel error or a device fault (its final
  heartbeat's phase is ``kernel_error``; in thread mode, the thread's
  exception) ends the run: the pod kills the other workers and raises
  :class:`~scintools_tpu_torch.backend.KernelError`, with no recovery
  spawn and no steal of the dead worker's task. A broken kernel would
  otherwise kill worker after worker (the JAX pod recovers from every
  death);
- the merged journal equals an uninterrupted single-worker run's
  (modulo the stripped attribution columns) however many workers ran,
  died or stole.

Workers are fresh interpreters (``python -m
scintools_tpu_torch.fleet.worker``), never forks of a process that has
touched CUDA; each opens its own CUDA context and inherits
``CUDA_VISIBLE_DEVICES``. Before spawning workers that run on the card
the pod builds the kernels once in its own process (``_build.build()``),
so N workers do not run N compilers. ``mode="thread"`` runs the workers
as threads of this process instead, sharing its context."""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

from ..backend import KernelError, is_kernel_error, resolve_device
from ..obs import heartbeat as _hb
from ..obs import metrics as _metrics
from ..obs import report as _report
from ..obs import trace as _trace
from ..robust.runner import EpochOutcome
from ..utils import slog
from . import fsops as _fsops
from .chaos import ChaosSchedule
from .elastic import as_autoscaler
from .merge import merge_journals
from .queue import WorkQueue
from .worker import resolve_workload, run_worker

#: repo root (the directory holding the ``scintools_tpu_torch`` package) —
#: prepended to the worker subprocess PYTHONPATH so spawn works from
#: any caller cwd.
_PKG_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))


class _ProcessWorker:
    """Handle on one spawned worker subprocess."""

    def __init__(self, worker_id, cmd, env, log_path, fs=None):
        self.worker_id = worker_id
        self._log = (fs or _fsops.DEFAULT).open_write(log_path, "ab")
        self.proc = subprocess.Popen(cmd, env=env, stdout=self._log,
                                     stderr=subprocess.STDOUT)
        self.pid = self.proc.pid

    def alive(self):
        return self.proc.poll() is None

    def returncode(self):
        return self.proc.poll()

    def kill(self):
        if self.alive():
            self.proc.kill()
            self.proc.wait(timeout=30)
        self.close()

    def close(self):
        try:
            self._log.close()
        except OSError:
            pass


class _ThreadWorker:
    """Handle on one in-process worker thread (test mode)."""

    def __init__(self, worker_id, fn):
        self.worker_id = worker_id
        self.pid = None
        self.error = None

        def _run():
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — surfaced by the
                # pod as a dead worker; a thread must not kill the pod
                self.error = e
                slog.log_failure("fleet.worker_error",
                                 stage="thread", error=e,
                                 epoch=worker_id)

        self.thread = threading.Thread(target=_run, daemon=True,
                                       name=f"fleet-{worker_id}")
        self.thread.start()

    def alive(self):
        return self.thread.is_alive()

    def returncode(self):
        if self.thread.is_alive():
            return None
        return 1 if self.error is not None else 0

    def kill(self):                     # threads can't be killed —
        pass                            # process mode covers SIGKILL

    def close(self):
        pass


class Pod:
    """Coordinator for one fleet survey run. ``start()`` seeds the
    queue and spawns the workers; ``wait()`` monitors to completion,
    merges, and returns the result dict (see :func:`run_pod`)."""

    def __init__(self, workdir, workload, epochs=None, n_workers=3,
                 batch_size=32, lease_s=15.0, skew_s=2.0,
                 poll_s=0.25, monitor_s=0.2, mode="process",
                 worker_env=None, worker_options=None,
                 max_recoveries=2, journal_name="journal.merged.jsonl",
                 plane_port=None, plane_host="127.0.0.1",
                 autoscale=None, chaos=None):
        self.workdir = os.fspath(workdir)
        self.workload_spec = workload
        self.n_workers = int(n_workers)
        self.batch_size = max(1, int(batch_size))
        self.lease_s = float(lease_s)
        self.skew_s = float(skew_s)
        self.poll_s = float(poll_s)
        self.monitor_s = float(monitor_s)
        self.mode = mode
        self.worker_env = dict(worker_env or {})
        self.worker_options = dict(worker_options or {})
        self.max_recoveries = int(max_recoveries)
        self.journal_name = journal_name
        # the coordinator's own (unfaulted) filesystem seam; the
        # chaos spec — when set — ships to WORKERS via worker_spec
        self._fs = _fsops.FsOps(worker="pod")
        self.autoscaler = as_autoscaler(autoscale)
        self.chaos_spec = None if chaos is None \
            else ChaosSchedule.from_spec(chaos).to_spec()

        self.queue_root = os.path.join(self.workdir, "queue")
        self.out_root = self.workdir
        os.makedirs(self.workdir, exist_ok=True)
        self.drain_dir = os.path.join(self.out_root, "drain")
        self._fs.makedirs(self.drain_dir)
        if epochs is None:
            # resolving builds the epoch table (cheap — no device
            # program runs until a worker processes a task)
            epochs = resolve_workload(workload).get("epochs")
            if epochs is None:
                raise ValueError(
                    "workload resolves to no epoch list — pass "
                    "epochs= explicitly")
        self.epochs = [(str(e), p) for e, p in epochs]
        self.order = [e for e, _ in self.epochs]
        self.workers = []
        self._dead = set()
        self._recoveries = 0
        self._spawned = 0           # next scale-up/initial worker id
        self._draining = set()      # drain-signalled worker ids
        self._compute_lock = threading.Lock()   # thread-mode workloads
        self._target = self.n_workers
        self._t0 = None
        self._queue = WorkQueue(self.queue_root, worker="pod",
                                lease_s=self.lease_s,
                                skew_s=self.skew_s, fs=self._fs)
        # incremental heartbeat reads: one mtime-gated
        # scanner shared by the monitor loop and the telemetry-plane
        # handler threads — a tick over unchanged files is stat-only;
        # staleness forgives the same skew the lease stealer does
        self.heartbeat_scanner = _hb.HeartbeatScanner(
            os.path.join(self.out_root, "heartbeats"),
            skew_s=self.skew_s)
        self.plane_port = plane_port
        self.plane_host = plane_host
        self.telemetry = None

    # ---- lifecycle --------------------------------------------------
    def tasks(self):
        """The epoch batches: ``("t<index>", epochs[i:i+batch])`` —
        task granularity = one batched device dispatch."""
        return [(f"t{i // self.batch_size:06d}",
                 self.epochs[i:i + self.batch_size])
                for i in range(0, len(self.epochs), self.batch_size)]

    def _worker_options(self):
        opts = {"lease_s": self.lease_s, "skew_s": self.skew_s,
                "poll_s": self.poll_s, **self.worker_options}
        if self.chaos_spec is not None:
            opts["chaos"] = self.chaos_spec
        return opts

    def _workload_device(self):
        """The device the workers will resolve: a resolved workload's
        ``"device"``, else the spec's ``params["device"]``."""
        spec = self.workload_spec
        if "process_batch" in spec:
            return spec.get("device")
        return (spec.get("params") or {}).get("device")

    def start(self):
        if self.mode == "process" \
                and resolve_device(self._workload_device()).type == "cuda":
            # one build in this process; every worker then loads it
            from .. import _build

            _build.build()
        self._t0 = time.perf_counter()
        tasks = self.tasks()
        seeded = self._queue.seed(tasks)
        slog.log_event("fleet.pod_start", workdir=self.workdir,
                       n_workers=self.n_workers, n_tasks=len(tasks),
                       seeded=seeded, n_epochs=len(self.epochs),
                       mode=self.mode,
                       chaos=self.chaos_spec is not None)
        spec = {"workload": self.workload_spec,
                "options": self._worker_options()}
        self._spec_path = os.path.join(self.workdir,
                                       "worker_spec.json")
        self._fs.write_json(self._spec_path, spec)
        for _ in range(self.n_workers):
            self.workers.append(self._spawn(self._next_id()))
        if self.plane_port is not None:
            from .telemetry import PodTelemetry

            self.telemetry = PodTelemetry(self).start(
                host=self.plane_host, port=int(self.plane_port))
            # discovery file: an ephemeral port (plane_port=0) must
            # be findable by scrapers that only know the workdir
            self._fs.write_json(
                os.path.join(self.workdir, "plane.json"),
                {"url": self.telemetry.url,
                 "host": self.plane_host,
                 "port": self.telemetry.port})
            slog.log_event("fleet.plane_start",
                           url=self.telemetry.url,
                           workdir=self.workdir)
        return self

    def _next_id(self):
        wid = f"w{self._spawned}"
        self._spawned += 1
        return wid

    def _spawn(self, worker_id):
        if self.mode == "thread":
            options = self._worker_options()
            return _ThreadWorker(
                worker_id,
                lambda: run_worker(self.queue_root, self.out_root,
                                   self._serialised_workload(),
                                   worker_id=worker_id, **options))
        env = dict(os.environ)
        env["PYTHONPATH"] = _PKG_ROOT + os.pathsep \
            + env.get("PYTHONPATH", "")
        env.update(self.worker_env)
        cmd = [sys.executable, "-m", "scintools_tpu_torch.fleet.worker",
               "--queue", self.queue_root, "--out", self.out_root,
               "--worker-id", worker_id, "--spec", self._spec_path]
        log_path = os.path.join(self.workdir, "workers", worker_id)
        os.makedirs(log_path, exist_ok=True)
        return _ProcessWorker(worker_id, cmd, env,
                              os.path.join(log_path, "worker.log"),
                              fs=self._fs)

    def _serialised_workload(self):
        """The workload, resolved in the calling worker thread, with its
        ``process_batch`` and ``process`` run under one pod-wide lock:
        torch's forward-mode AD levels (the LM's ``jacfwd``) are process
        state, so two threads may not compute at once. Thread workers
        still overlap their queue, journal and heartbeat work."""
        wl = dict(resolve_workload(self.workload_spec))

        def serialised(fn):
            def call(*args, **kwargs):
                with self._compute_lock:
                    return fn(*args, **kwargs)

            return call

        for name in ("process_batch", "process"):
            if wl.get(name) is not None:
                wl[name] = serialised(wl[name])
        return wl

    # ---- elastic scaling (fleet/elastic.py) -------------------------
    def active_workers(self):
        """Workers that are alive and NOT drain-signalled — the
        population the autoscaler's target is compared against."""
        return [w for w in self.workers
                if w.alive() and w.worker_id not in self._draining]

    def scale_to(self, n):
        """Move the fleet toward ``n`` active workers: spawn the
        shortfall, or drain the excess (most-recently-spawned first)
        via per-worker drain signal files — the graceful hand-off
        documented in fleet/elastic.py. Returns the new target."""
        n = max(0, int(n))
        active = self.active_workers()
        if n > len(active):
            added = [self._next_id() for _ in range(n - len(active))]
            for wid in added:
                self.workers.append(self._spawn(wid))
            _metrics.counter(
                "fleet_scale_ups_total",
                help="workers spawned by scale-up decisions"
            ).inc(len(added))
            slog.log_event("fleet.scale_up", added=added, target=n)
        elif n < len(active):
            victims = [w.worker_id for w in
                       reversed(active)][:len(active) - n]
            for wid in victims:
                self._fs.write_json(
                    os.path.join(self.drain_dir, wid + ".drain"),
                    {"t": round(self._fs.now(), 3), "by": "pod"})
                self._draining.add(wid)
            _metrics.counter(
                "fleet_scale_downs_total",
                help="workers drain-signalled by scale-down "
                     "decisions").inc(len(victims))
            slog.log_event("fleet.scale_down", drained=victims,
                           target=n)
        self._target = n
        return n

    # ---- monitoring -------------------------------------------------
    def heartbeats(self):
        """``{worker_id: record}`` of the last complete heartbeat of
        every worker that ever wrote one — via the shared
        mtime-gated scanner, so a monitor tick (or a plane scrape)
        over unchanged heartbeat files re-reads nothing."""
        return self.heartbeat_scanner.scan()

    def queue_counts(self):
        """Live queue counts (pending/claimed/done) — the /state
        view's queue block."""
        return self._queue.counts()

    def elapsed_s(self):
        """Wall seconds since ``start()`` (0.0 before it)."""
        return 0.0 if self._t0 is None \
            else time.perf_counter() - self._t0

    def degraded_workers(self):
        """Worker ids whose last heartbeat declared the degraded
        park (fleet/worker.py:_park_degraded) — alive, but no longer
        claiming or renewing."""
        beats = self.heartbeat_scanner.scan()
        return sorted(
            w.worker_id for w in self.workers
            if w.alive() and (beats.get(w.worker_id) or {}
                              ).get("phase") == "degraded")

    def _end_on_kernel_error(self, worker, beat):
        """Raise when a dead worker died of a kernel error or a device
        fault: its thread's exception, or a final heartbeat whose phase
        is ``kernel_error``. No recovery worker is spawned for it."""
        err = getattr(worker, "error", None)
        if err is not None and is_kernel_error(err):
            raise err
        if beat.get("phase") == "kernel_error":
            raise KernelError(
                f"fleet worker {worker.worker_id} died of "
                f"{beat.get('error_class')}: {beat.get('error')}")

    def poll(self):
        """One monitor pass: pod-level gauges from the queue and the
        heartbeat files, dead-worker detection, the autoscaler step,
        recovery spawn when no worker can make progress with work
        outstanding. Returns the queue counts."""
        counts = self._queue.counts()
        beats = self.heartbeats()
        degraded = {w.worker_id for w in self.workers
                    if w.alive() and (beats.get(w.worker_id) or {}
                                      ).get("phase") == "degraded"}
        _metrics.gauge("fleet_queue_pending",
                       help="tasks waiting in the fleet queue"
                       ).set(counts["pending"])
        _metrics.gauge("fleet_queue_claimed",
                       help="tasks currently claimed by workers"
                       ).set(counts["claimed"])
        _metrics.gauge("fleet_queue_done",
                       help="tasks completed on the fleet queue"
                       ).set(counts["done"])
        _metrics.gauge("fleet_workers_alive",
                       help="fleet worker processes currently alive"
                       ).set(sum(1 for w in self.workers
                                 if w.alive()))
        _metrics.gauge(
            "fleet_workers_degraded",
            help="live workers parked in fsop-degraded mode"
        ).set(len(degraded))
        _metrics.gauge(
            "fleet_workers_draining",
            help="workers drain-signalled and not yet exited"
        ).set(sum(1 for w in self.workers
                  if w.alive() and w.worker_id in self._draining))
        _metrics.gauge(
            "fleet_pod_epochs_done",
            help="epochs completed across the pod (heartbeat view)"
        ).set(sum(int(b.get("epochs", 0)) for b in beats.values()))
        for w in self.workers:
            if w.alive() or w.worker_id in self._dead:
                continue
            beat = beats.get(w.worker_id) or {}
            if w.returncode() == 0 and beat.get("phase") in (
                    "done", "draining", "degraded"):
                continue                 # clean exit, not a death
            self._dead.add(w.worker_id)
            self._end_on_kernel_error(w, beat)
            _metrics.counter("fleet_workers_dead_total",
                             help="workers that died mid-run").inc()
            slog.log_failure(
                "fleet.worker_dead", stage="monitor",
                error=f"exit code {w.returncode()}",
                epoch=w.worker_id,
                last_phase=beat.get("phase"),
                heartbeat_age_s=round(
                    _hb.heartbeat_age_s(beat, skew_s=self.skew_s),
                    3) if beat else None)
        drained = counts["pending"] == 0 and counts["claimed"] == 0
        if drained and degraded:
            # the run is over: send parked-degraded workers home (a
            # dead disk may keep them from ever observing drained())
            for wid in degraded:
                if wid not in self._draining:
                    self._fs.write_json(
                        os.path.join(self.drain_dir,
                                     wid + ".drain"),
                        {"t": round(self._fs.now(), 3),
                         "by": "pod", "reason": "drained"})
                    self._draining.add(wid)
        if self.autoscaler is not None and not drained:
            target = self.autoscaler.target(counts)
            if target != len(self.active_workers()):
                self.scale_to(target)
        _metrics.gauge(
            "fleet_workers_target",
            help="autoscaler/scale_to worker-count target"
        ).set(self._target)
        # a degraded worker is alive but cannot make progress — the
        # recovery condition counts only workers that still can
        if not any(w.alive() and w.worker_id not in degraded
                   for w in self.workers) and not drained:
            if self._recoveries >= self.max_recoveries:
                raise RuntimeError(
                    "fleet stalled: all workers dead, queue not "
                    f"drained after {self._recoveries} recovery "
                    "workers")
            self._recoveries += 1
            wid = f"r{self._recoveries}"
            _metrics.counter(
                "fleet_recovery_spawns_total",
                help="recovery workers spawned after fleet-wide "
                     "death/degradation").inc()
            slog.log_event("fleet.recovery_spawn", worker=wid,
                           pending=counts["pending"],
                           claimed=counts["claimed"])
            self.workers.append(self._spawn(wid))
        return counts

    def wait(self, timeout=600.0, on_poll=None):
        """Monitor until the queue drains and every worker exits,
        then merge and report. Raises :class:`TimeoutError` when the
        run exceeds ``timeout`` (workers are killed first so the
        caller does not leak processes). ``on_poll(pod, counts)``
        runs after every monitor pass — the chaos soak drives its
        scripted scale-down/up cycles from there."""
        deadline = time.monotonic() + float(timeout)
        try:
            try:
                while True:
                    counts = self.poll()
                    if on_poll is not None:
                        on_poll(self, counts)
                    if counts["pending"] == 0 \
                            and counts["claimed"] == 0 \
                            and not any(w.alive()
                                        for w in self.workers):
                        break
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"fleet run exceeded {timeout}s "
                            f"(queue counts {counts})")
                    time.sleep(self.monitor_s)
            except BaseException:
                # a kernel error, a stall or a timeout ends the run:
                # no worker outlives it
                for w in self.workers:
                    w.kill()
                raise
            finally:
                for w in self.workers:
                    w.kill() if time.monotonic() > deadline \
                        else w.close()
            return self._finish()
        finally:
            if self.telemetry is not None:
                self.telemetry.close()

    # ---- merge + report ---------------------------------------------
    def worker_journals(self):
        root = os.path.join(self.out_root, "workers")
        out = []
        try:
            ids = sorted(os.listdir(root))
        except FileNotFoundError:
            return out
        for wid in ids:
            p = os.path.join(root, wid, "journal.jsonl")
            if os.path.exists(p):
                out.append(p)
        return out

    def worker_trace_spools(self):
        """``{worker_id: trace.jsonl path}`` of every worker that
        spooled trace fragments (fleet/worker.py)."""
        root = os.path.join(self.out_root, "workers")
        out = {}
        try:
            ids = sorted(os.listdir(root))
        except FileNotFoundError:
            return out
        for wid in ids:
            p = os.path.join(root, wid, "trace.jsonl")
            if os.path.exists(p):
                out[wid] = p
        return out

    def _merge_traces(self):
        """Merge the per-worker trace fragments into ONE validated
        Chrome trace next to the merged journal. Trace data is
        diagnostics: a merge failure is logged, never raised into
        the survey result."""
        frags = _trace.load_trace_fragments(self.worker_trace_spools())
        if not frags:
            return None
        path = os.path.join(self.workdir, "trace.merged.json")
        try:
            _, stats = _trace.write_merged_trace(
                path, frags, run_name="scintools_tpu_torch pod")
        except Exception as e:  # noqa: BLE001 — diagnostics only
            slog.log_failure("fleet.trace_error", stage="trace_merge",
                             error=e)
            return {"error": repr(e)[:200]}
        stats["path"] = path
        slog.log_event("fleet.trace_merge", **stats)
        return stats

    def _finish(self):
        wall_s = time.perf_counter() - self._t0
        t0 = time.perf_counter()
        merged_path = os.path.join(self.workdir, self.journal_name)
        merge_stats = merge_journals(self.worker_journals(),
                                     merged_path, order=self.order)
        merge_s = time.perf_counter() - t0
        from ..parallel.checkpoint import EpochJournal

        records = EpochJournal(merged_path).records()
        summary, outcomes, results = _pod_tally(self.order, records)
        beats = self.heartbeats()
        trace_stats = self._merge_traces()
        fleet = {
            "n_workers": self.n_workers,
            "n_tasks": len(self.tasks()),
            "batch_size": self.batch_size,
            "mode": self.mode,
            "steals": sum(int(b.get("stolen", 0))
                          for b in beats.values()),
            "lease_lost": sum(int(b.get("lease_lost", 0))
                              for b in beats.values()),
            "dead_workers": sorted(self._dead),
            "recoveries": self._recoveries,
            "released": sum(int(b.get("released", 0))
                            for b in beats.values()),
            "degraded": sum(int(b.get("degraded", 0))
                            for b in beats.values()),
            "fsop_retries": sum(int(b.get("fsop_retries", 0))
                                for b in beats.values()),
            "fsop_retry_s": round(
                sum(float(b.get("fsop_retry_s", 0.0))
                    for b in beats.values()), 4),
            "drained_workers": sorted(self._draining),
            "workers_target": self._target,
            "merge": {**merge_stats, "merge_s": round(merge_s, 4)},
            "trace": trace_stats,
            "workers": {w: {k: b.get(k) for k in
                            ("tasks", "stolen", "epochs", "n_ok",
                             "n_quarantined", "lease_lost",
                             "released", "degraded",
                             "fsop_retries", "fsop_retry_s",
                             "queue_op_s", "idle_wait_s", "busy_s",
                             "phase")}
                        for w, b in beats.items()},
        }
        worker_metrics = _metrics.aggregate_snapshots(
            [b.get("metrics") for b in beats.values()])
        report = _report.build_run_report(
            summary, outcomes, wall_s=wall_s, runner="run_pod",
            extra={"fleet": fleet, "worker_metrics": worker_metrics})
        _report.validate_run_report(report)
        _report.write_run_report(self.workdir, report)
        slog.log_event("fleet.pod_summary",
                       n_epochs=summary["n_epochs"],
                       n_ok=summary["n_ok"],
                       n_quarantined=summary["n_quarantined"],
                       steals=fleet["steals"],
                       dead_workers=fleet["dead_workers"],
                       wall_s=round(wall_s, 3))
        return {"results": results, "summary": summary,
                "report": report, "fleet": fleet,
                "journal": merged_path, "wall_s": wall_s}


def _pod_tally(order, records):
    """Rebuild the runner-shaped summary/outcomes/results views from
    the MERGED journal (the pod's ground truth — heartbeat counters
    are progress hints, the journal is the record)."""
    summary = {"n_epochs": len(order), "n_ok": 0, "n_quarantined": 0,
               "n_resumed": 0, "retries": 0, "tier_counts": {}}
    outcomes, results = [], {}
    for key in order:
        rec = records.get(key)
        if rec is None:
            continue                    # incomplete run: not counted
        status = rec.get("status", "ok")
        out = EpochOutcome(
            epoch=key, status=status, tier=rec.get("tier", ""),
            retries=int(rec.get("retries", 0) or 0),
            error=rec.get("error", ""),
            error_class=rec.get("error_class", ""),
            result=rec.get("result") or {})
        summary["retries"] += out.retries
        if status == "ok":
            summary["n_ok"] += 1
            summary["tier_counts"][out.tier] = \
                summary["tier_counts"].get(out.tier, 0) + 1
            results[key] = out.result
        else:
            summary["n_quarantined"] += 1
        outcomes.append(out)
    return summary, outcomes, results


def run_pod(workdir, workload, timeout=600.0, **kw):
    """One-call fleet survey: seed, spawn, monitor, merge, report.
    Returns ``{"results", "summary", "report", "fleet", "journal",
    "wall_s"}`` — ``summary``/``results`` are runner-shaped (rebuilt
    from the merged journal), ``fleet`` carries the pod-level
    worker/steal/merge tallies that also ride in the RunReport."""
    return Pod(workdir, workload, **kw).start().wait(timeout=timeout)
