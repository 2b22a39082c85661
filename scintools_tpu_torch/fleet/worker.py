"""Fleet worker: the queue-driven loop around the survey engine.

The port's own copy of ``scintools_tpu/fleet/worker.py``. One worker
process is the survey engine
(``robust/runner.py:run_survey_batched`` — ladder, lane quarantine,
CRC journal, resume) fed by the shared work queue (fleet/queue.py)
instead of an up-front epoch list. The worker

- claims one task (an epoch batch sized to the batched device
  programs) at a time, steals expired leases when the queue is empty,
  and exits when the queue is drained;
- journals every epoch to its OWN journal
  (``<out>/workers/<id>/journal.jsonl``) with the attribution columns
  (``worker``, ``t_commit``) appended via the runner's
  ``journal_extra`` hook — the merge (fleet/merge.py) strips them;
- heartbeats on two channels while it computes: the task's LEASE
  (a stopped heartbeat makes the task stealable) and its heartbeat
  FILE (``<out>/heartbeats/<id>.json``: progress counters and a metrics
  snapshot for the pod), both time-gated on the runner's per-epoch
  heartbeat callback.

The **workload** is a JSON-able spec ``{"target": "module:callable",
"params": {...}}`` resolved in the worker's own process by
:func:`resolve_workload`: the callable returns ``{"epochs": [(id,
payload), ...], "process_batch": fn, "process": fn, ...}``
(``scintools_tpu_torch.sim.scenario:scenario_workload`` for the
scenario survey; :func:`demo_workload` is the dependency-free toy).
``params["device"]`` (a string such as ``"cuda"`` or ``"cpu"``, or
None for the card) names the device the worker resolves through
:func:`~scintools_tpu_torch.backend.resolve_device`; a worker that finds
no card raises.

A worker whose task dies of a kernel error or a device fault
(:func:`~scintools_tpu_torch.backend.is_kernel_error`) writes the
error's class in a final ``kernel_error`` heartbeat and exits non-zero;
the pod then ends the run (fleet/pod.py).

Runnable directly (the pod's spawn line; a fresh interpreter, never a
fork of a process that has touched CUDA)::

    python -m scintools_tpu_torch.fleet.worker \
        --queue Q --out OUT --worker-id w0 --spec SPEC.json"""

from __future__ import annotations

import importlib
import json
import os
import time

from ..backend import is_kernel_error, resolve_device
from ..obs import heartbeat as _hb
from ..obs import metrics as _metrics
from ..utils import slog
from . import chaos as _chaos
from . import fsops as _fsops
from .queue import WorkQueue


def resolve_workload(workload):
    """Normalise a workload argument: an already-resolved dict (has
    ``process_batch``) passes through; a spec dict
    ``{"target": "module:callable", "params": {...}}`` is imported
    and called, and the resolved dict keeps the spec's
    ``params["device"]`` as ``"device"`` unless it names one itself.
    Raises :class:`ValueError` on anything else — a worker with no
    workload must die loudly, not idle."""
    if not isinstance(workload, dict):
        raise ValueError(f"workload must be a dict, got "
                         f"{type(workload).__name__}")
    if "process_batch" in workload:
        return workload
    target = workload.get("target")
    if not target or ":" not in target:
        raise ValueError(
            "workload spec needs target='module:callable' "
            f"(got {target!r})")
    mod_name, _, fn_name = target.partition(":")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    params = workload.get("params") or {}
    resolved = fn(**params)
    if "process_batch" not in resolved:
        raise ValueError(
            f"workload target {target} returned no process_batch")
    resolved.setdefault("device", params.get("device"))
    return resolved


def demo_workload(n_epochs=32, scale=1.0, fail_every=0, slow_s=0.0,
                  batch_size=None, device=None):
    """Dependency-free deterministic toy workload (fleet plumbing
    tests, multi-process smoke): each epoch's result is a pure
    function of its payload seed, so any worker — or a re-run after a
    steal — produces bit-identical records. ``fail_every`` makes
    every k-th epoch raise (quarantine-path coverage), ``slow_s``
    models per-epoch compute so tests can hold a task mid-lease.
    ``batch_size`` caps the runner's internal batch WITHIN one task
    (default: one batch per task) — smaller batches journal, beat,
    and trace-flush mid-task, which is what makes a SIGKILLed
    holder's partial progress observable. ``device`` is the device
    the worker resolves (``None``: the card), though the toy itself
    computes on the host."""
    import numpy as np

    def _one(payload):
        seed = int(payload["seed"])
        if fail_every and seed % fail_every == fail_every - 1:
            from ..io import MalformedInputError

            raise MalformedInputError(f"<epoch seed={seed}>",
                                      "demo poisoned epoch")
        rng = np.random.default_rng(seed)
        return {"v": round(float(rng.normal()) * scale, 12),
                "s": round(float(np.sin(seed * 1.7)), 12)}

    def process_batch(payloads, tier=None):
        if slow_s:
            time.sleep(slow_s * len(payloads))
        return [_one(p) for p in payloads]

    def process(payload, tier=None):
        if slow_s:
            time.sleep(slow_s)
        return _one(payload)

    epochs = [(f"e{i:05d}", {"seed": i}) for i in range(int(n_epochs))]
    out = {"epochs": epochs, "process_batch": process_batch,
           "process": process, "device": device}
    if batch_size:
        out["batch_size"] = int(batch_size)
    return out


class _LeaseBeat(_hb.Heartbeat):
    """The runner's per-epoch heartbeat hook, repurposed as the
    worker's liveness channel: every beat (cheap, time-gated) renews
    the current task's lease and rewrites the worker heartbeat file.
    Emits NO slog events — fleet liveness is file/lease-borne, the
    slog stream stays the runner's."""

    def __init__(self, worker, every_s):
        super().__init__(streaming=True)
        self._worker = worker
        self._every_s = float(every_s)
        self._last = 0.0

    def beat(self, done, force=False, **stats):
        now = time.monotonic()
        if not force and now - self._last < self._every_s:
            return None
        self._last = now
        self._worker._heartbeat(done=done, **stats)
        return None


class FleetWorker:
    """One worker's whole life: claim → run → journal → complete,
    until the queue drains. See the module docstring; construct and
    :meth:`run`, or use :func:`run_worker`."""

    def __init__(self, queue_root, out_root, workload, worker_id="w0",
                 lease_s=15.0, skew_s=2.0, poll_s=0.25,
                 heartbeat_s=None, retries=1, max_wall_s=None,
                 trace_spool=True, chaos=None, clock_offset_s=0.0,
                 fs=None):
        self.worker_id = str(worker_id)
        self.out_root = os.fspath(out_root)
        # the filesystem seam: chaos — a ChaosSchedule /
        # spec dict / ChaosEngine — injects faults at it; the
        # (possibly skewed) clock it owns stamps the leases,
        # heartbeats, and journal commits below
        engine = None
        if chaos is not None:
            engine = chaos if isinstance(chaos, _chaos.ChaosEngine) \
                else _chaos.ChaosEngine(chaos, self.worker_id)
        offset = float(clock_offset_s) \
            + (engine.clock_offset() if engine is not None else 0.0)
        self.fs = fs or _fsops.FsOps(chaos=engine,
                                     clock_offset_s=offset,
                                     worker=self.worker_id)
        self.queue = WorkQueue(queue_root, worker=self.worker_id,
                               lease_s=lease_s, skew_s=skew_s,
                               fs=self.fs)
        self.workload = resolve_workload(workload)
        self.device = resolve_device(self.workload.get("device"))
        self.poll_s = float(poll_s)
        self.retries = int(retries)
        self.max_wall_s = max_wall_s
        self.heartbeat_s = (float(heartbeat_s) if heartbeat_s
                            else max(0.2, lease_s / 3.0))
        self.workdir = os.path.join(self.out_root, "workers",
                                    self.worker_id)
        self.hb_path = os.path.join(self.out_root, "heartbeats",
                                    self.worker_id + ".json")
        # the drain signal (fleet/elastic.py): the pod writes this
        # file to request a graceful scale-down exit
        self.drain_path = os.path.join(self.out_root, "drain",
                                       self.worker_id + ".drain")
        self.fs.makedirs(self.workdir)
        self.fs.makedirs(os.path.dirname(self.hb_path))
        self.stats = {"worker": self.worker_id, "tasks": 0,
                      "stolen": 0, "epochs": 0, "n_ok": 0,
                      "n_quarantined": 0, "lease_lost": 0,
                      "queue_op_s": 0.0, "idle_wait_s": 0.0,
                      "busy_s": 0.0, "released": 0, "degraded": 0,
                      "fsop_retries": 0, "fsop_retry_s": 0.0}
        self._task = None
        self._exit_phase = None
        self._beat = _LeaseBeat(self, self.heartbeat_s)
        # per-worker trace fragment spool: every stage
        # span the runner records is flushed journal-adjacently (on
        # the heartbeat cadence, so spans survive a SIGKILL up to the
        # last beat) for the pod's cross-process trace merge
        # (obs/trace.py:merge_traces). perf_counter spans are shifted
        # onto the wall clock by a once-sampled anchor so fragments
        # from different processes share one timeline.
        self.timeline = None
        self.trace_path = os.path.join(self.workdir, "trace.jsonl")
        if trace_spool:
            from ..utils.profiling import StageTimeline

            self.timeline = StageTimeline()
        self._trace_anchor = time.time() - time.perf_counter()
        self._trace_flushed = 0
        self._trace_ids_flushed = set()

    # the journal attribution stamp (see fleet/merge.py): constant
    # worker id + per-record commit instant, appended at line end
    def _journal_extra(self):
        return {"worker": self.worker_id,
                "t_commit": round(self.fs.now(), 3)}

    def _heartbeat(self, done=None, final=False, phase=None, **stats):
        if self._task is not None:
            t0 = time.perf_counter()
            if not self.queue.renew(self._task):
                self.stats["lease_lost"] += 1
            self.stats["queue_op_s"] += time.perf_counter() - t0
        self.stats["fsop_retries"] = self.fs.retries
        self.stats["fsop_retry_s"] = round(self.fs.retry_wait_s, 4)
        rec = dict(self.stats)
        rec["phase"] = phase or ("done" if final else (
            "task" if self._task is not None else "idle"))
        if done is not None:
            rec["task_done"] = int(done)
        rec.update(stats)
        rec["metrics"] = _metrics.REGISTRY.snapshot() \
            if _metrics.REGISTRY.enabled else None
        # stamped with the seam's clock and written through it: a
        # skewed worker's heartbeats carry its OWN time (the scanner
        # compensates via skew_s), and a faulty write is retried
        _hb.write_heartbeat_file(self.hb_path, now=self.fs.now(),
                                 writer=self.fs.write_json, **rec)
        self._flush_trace()

    def _flush_trace(self):
        """Append spans (and trace-id assignments) recorded since
        the last flush to the journal-adjacent spool. Id assignments
        travel as their OWN lines: a loader thread can record a span
        before the dispatch loop assigns the epoch's trace ID, so
        binding is resolved at merge time, not flush time. Returns
        the number of lines written."""
        if self.timeline is None:
            return 0
        spans = self.timeline.spans()
        new = spans[self._trace_flushed:]
        ids = self.timeline.trace_ids()
        new_ids = {e: t for e, t in ids.items()
                   if e not in self._trace_ids_flushed}
        if not new and not new_ids:
            return 0
        lines = []
        for epoch, tid in sorted((str(e), t)
                                 for e, t in new_ids.items()):
            lines.append(json.dumps(
                {"worker": self.worker_id, "epoch": epoch,
                 "trace_id": tid}))
        for stage, epoch, t0, t1 in new:
            lines.append(json.dumps(
                {"worker": self.worker_id, "stage": stage,
                 "epoch": str(epoch),
                 "t0": round(t0 + self._trace_anchor, 6),
                 "t1": round(t1 + self._trace_anchor, 6)}))
        self.fs.append_text(self.trace_path, "\n".join(lines) + "\n")
        self._trace_flushed += len(new)
        self._trace_ids_flushed.update(new_ids)
        return len(lines)

    def _run_task(self, task):
        from ..robust.runner import _DEFAULT_TIERS, run_survey_batched

        self._task = task
        self.stats["tasks"] += 1
        if task.stolen:
            self.stats["stolen"] += 1
        t0 = time.perf_counter()
        try:
            out = run_survey_batched(
                task.epochs, self.workload["process_batch"],
                self.workdir, process=self.workload.get("process"),
                # one batch per task unless the workload caps it —
                # smaller batches journal/beat/flush mid-task
                batch_size=int(self.workload.get("batch_size")
                               or max(1, len(task.epochs))),
                tiers=self.workload.get("tiers") or _DEFAULT_TIERS,
                retries=self.retries,
                validate=self.workload.get("validate"),
                heartbeat=self._beat, report=False,
                timeline=self.timeline,
                journal_extra=self._journal_extra,
                device=self.device)
        finally:
            self.stats["busy_s"] += time.perf_counter() - t0
            self._task = None
        s = out["summary"]
        self.stats["epochs"] += s["n_epochs"]
        self.stats["n_ok"] += s["n_ok"] + sum(
            1 for o in out["outcomes"]
            if o.status == "resumed" and not o.error_class)
        self.stats["n_quarantined"] += s["n_quarantined"]
        _metrics.counter("fleet_epochs_done_total",
                         help="epochs completed by fleet workers"
                         ).inc(s["n_epochs"])
        t0 = time.perf_counter()
        self.queue.complete(task)
        self.stats["queue_op_s"] += time.perf_counter() - t0
        self._heartbeat()

    def _drain_requested(self):
        """Plain stat probe of the drain signal file (never faulted
        — the pod must be able to drain a degraded worker)."""
        return self.fs.exists(self.drain_path)

    def _drain(self):
        """The graceful scale-down hand-off (fleet/elastic.py): the
        in-flight task already completed (the drain check sits
        between tasks); release every remaining claim back to
        pending so survivors re-claim through the fresh path — zero
        tasks transit lease-expiry stealing on a clean drain."""
        t0 = time.perf_counter()
        released = self.queue.release_own()
        self.stats["queue_op_s"] += time.perf_counter() - t0
        self.stats["released"] += released
        self._exit_phase = "draining"
        slog.log_event("fleet.drain", worker=self.worker_id,
                       released=released)
        return "drain"

    def _park_degraded(self, err):
        """Degraded-mode park: this worker's filesystem
        exhausted its retry budget. Stop claiming, stop renewing
        (``self._task`` is cleared, so leases expire HONESTLY and a
        survivor steals the in-flight work — no half-renewed
        leases), keep best-effort ``degraded`` heartbeats so the pod
        and ``/workers`` see a parked-not-dead worker. Leaves the
        park when the queue drains, a drain signal arrives, or
        ``max_wall_s`` runs out."""
        self.stats["degraded"] = 1
        self._task = None
        self._exit_phase = "degraded"
        slog.log_event("fleet.worker_degraded",
                       worker=self.worker_id, op=err.op,
                       path=err.path, attempts=err.attempts)
        while True:
            try:
                self._heartbeat(phase="degraded")
            except (OSError, _fsops.FsOpDegradedError):
                # last-gasp channel: the park status must not depend
                # on the dead data plane — fall back to the plain
                # atomic writer so the pod still SEES the park (and
                # can drain-signal this worker home once the queue
                # empties; without this a dead disk wedges wait())
                try:
                    rec = dict(self.stats)
                    rec["phase"] = "degraded"
                    _hb.write_heartbeat_file(
                        self.hb_path, now=self.fs.now(), **rec)
                except OSError:
                    pass
            if self.max_wall_s is not None and time.monotonic() \
                    - self._t_start > self.max_wall_s:
                return "max_wall_s"
            if self._drain_requested():
                return "drain"
            try:
                if self.queue.drained():
                    return "degraded"
            except (OSError, _fsops.FsOpDegradedError):
                pass  # a dead disk must not crash the park loop
            time.sleep(self.poll_s)

    def _kernel_error_exit(self, err):
        """Last words of a worker whose task died of a kernel error or
        a device fault: a final ``kernel_error`` heartbeat carrying the
        error's class, which the pod reads to end the run instead of
        recovering (a broken kernel would kill worker after worker)."""
        slog.log_failure("fleet.worker_kernel_error", stage="task",
                         error=err, epoch=self.worker_id)
        try:
            self._heartbeat(final=True, phase="kernel_error",
                            error_class=type(err).__name__,
                            error=str(err)[:300])
        except (OSError, _fsops.FsOpDegradedError):
            pass                       # the exit code still says it

    def run(self):
        """The worker loop; returns the stats dict (also written as
        the final heartbeat record)."""
        slog.log_event("fleet.worker_start", worker=self.worker_id,
                       queue=self.queue.root)
        self._t_start = time.monotonic()
        reason = None
        while reason is None:
            if self.max_wall_s is not None and time.monotonic() \
                    - self._t_start > self.max_wall_s:
                reason = "max_wall_s"
                break
            if self._drain_requested():
                try:
                    reason = self._drain()
                except _fsops.FsOpDegradedError as e:
                    reason = self._park_degraded(e)
                break
            try:
                if self.stats["tasks"] == 0 \
                        and self.stats["idle_wait_s"] == 0:
                    self._heartbeat()   # announce before first claim
                t0 = time.perf_counter()
                task = self.queue.claim()
                self.stats["queue_op_s"] += time.perf_counter() - t0
                if task is not None:
                    try:
                        self._run_task(task)
                    except Exception as e:
                        if is_kernel_error(e):
                            self._kernel_error_exit(e)
                        raise
                    continue
                if self.queue.drained():
                    reason = "drained"
                    break
                # the queue is not drained but nothing is claimable:
                # some other worker holds a live lease — poll until
                # it completes or its lease expires and becomes
                # stealable
                self.stats["idle_wait_s"] += self.poll_s
                self._heartbeat()
            except _fsops.FsOpDegradedError as e:
                reason = self._park_degraded(e)
                break
            time.sleep(self.poll_s)
        slog.log_event("fleet.worker_exit", worker=self.worker_id,
                       reason=reason)
        try:
            self._heartbeat(final=True, phase=self._exit_phase)
        except _fsops.FsOpDegradedError:
            pass                       # parked worker, still-dead fs
        return dict(self.stats)


def run_worker(queue_root, out_root, workload, worker_id="w0", **kw):
    """Run one fleet worker to queue exhaustion (module docstring);
    returns its stats dict."""
    return FleetWorker(queue_root, out_root, workload,
                       worker_id=worker_id, **kw).run()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="scintools_tpu_torch fleet worker process")
    ap.add_argument("--queue", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--worker-id", default=None)
    ap.add_argument("--spec", required=True,
                    help="JSON file: {'workload': spec, 'options': {}}")
    args = ap.parse_args(argv)
    with open(args.spec) as fh:
        spec = json.load(fh)
    worker_id = args.worker_id or f"w{os.getpid()}"
    stats = run_worker(args.queue, args.out, spec["workload"],
                       worker_id=worker_id,
                       **(spec.get("options") or {}))
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
