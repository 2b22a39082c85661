"""Long-lived streaming survey daemon.

The port's own copy of ``scintools_tpu/serve/daemon.py``. The daemon
watches a spool (or an in-process queue) for arriving epochs, feeds
them through the same PrefetchLoader → dispatch-ahead pipeline as the
batch runner (parallel/pipeline.py and robust/runner.py's per-epoch
engine), publishes each result to an append-only, atomically readable
results store (serve/store.py) and serves its observability surface
live over HTTP (serve/http.py).

- **bounded ingest→publish latency** — an idle poll tick drains the
  dispatch-ahead window, so a lull publishes everything in flight;
- **per-epoch latency accounting** — each epoch carries an ``ingest →
  dispatch → fence → publish`` span chain on its trace ID, the
  ``serve_e2e_latency_seconds`` histogram and p50/p95 in heartbeats
  and the live RunReport;
- **crash = restart** — a SIGKILL loses at most the un-fsynced tail; a
  restarted daemon re-admits the spool, takes journaled epochs verbatim
  (nothing is published twice) and converges to a byte-consistent
  store;
- **fence before publish** — a result is published only after
  :func:`~scintools_tpu_torch.parallel.pipeline.finalize_result` has
  fenced it, so the store journals numbers, never tensors, and a device
  fault shows at the fence;
- **stream fault-hardening** — torn files wait (SpoolWatcher), content
  duplicates are dropped (``serve_duplicates_total``), malformed files
  are quarantined through the fallback ladder.

Unlike the JAX daemon, a :class:`~scintools_tpu_torch.backend.KernelError`
or a device fault that :func:`~scintools_tpu_torch.backend.is_kernel_error`
classifies is never contained: not in the warm-up, not in a
post-publish hook. It ends the loop thread (``/healthz`` turns
unhealthy) and :meth:`SurveyService.stop` and
:meth:`SurveyService.wait_idle` re-raise it in the caller. Every other
hook or warm-up exception is contained as in the JAX package.

Also unlike the JAX daemon, which runs an epoch's post-publish hooks
straight after its publish, the loop publishes newer arrivals before it
runs a waiting hook call (:meth:`SurveyService._defer`): a hook that
takes most of the arrival interval would otherwise queue every later
publish behind it."""

from __future__ import annotations

import collections
import os
import queue
import threading
import time

import numpy as np

from ..obs import heartbeat as _hb
from ..obs import ledger as _ledger
from ..obs import metrics as _metrics
from ..backend import is_kernel_error
from ..obs import report as _report
from ..parallel.pipeline import AsyncJournalWriter, PrefetchLoader
from ..robust import runner as _runner
from ..robust.runner import EpochOutcome
from ..utils import slog
from ..utils.profiling import StageTimeline
from . import lanes as _lanes
from .store import ResultsStore

_STOP = object()

#: post-publish hook calls the loop holds back while it has newer work:
#: past this many it runs the oldest before anything else, so a hook
#: slower than the stream slows the stream instead of piling up payloads
HOOK_BACKLOG = 32


def _raise_loop_error(err):
    """Re-raise the exception that ended the loop thread in the caller:
    a kernel error or device fault as itself, anything else wrapped."""
    if is_kernel_error(err):
        raise err
    raise RuntimeError("serve loop failed") from err

#: e2e latency buckets [seconds]: a streaming epoch should publish
#: within tens of ms (in-process) to seconds (real fits + spool I/O).
LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                   2.5, 5.0, 15.0, 60.0)


class _ServeRecorder(_runner._Recorder):
    """The runner's recorder with a content-hash column: every
    journal line the daemon publishes carries the epoch's ``sha``
    field, so the store's dedupe index survives restart."""

    def __init__(self, journal, writer, tiers, heartbeat=None):
        super().__init__(journal, writer, tiers, heartbeat=heartbeat)
        self._sha = {}

    def set_sha(self, key, sha):
        if sha:
            self._sha[str(key)] = sha

    def _append(self, key, **fields):
        sha = self._sha.pop(str(key), None)
        if sha:
            fields["sha"] = sha
        super()._append(key, **fields)


class SurveyService:
    """The streaming survey daemon.

    ``source`` is an epoch source (serve/watch.py:
    :class:`SpoolWatcher` / :class:`QueueSource`); ``process(payload,
    tier=...)`` is the per-epoch worker exactly as in
    :func:`~scintools_tpu_torch.robust.runner.run_survey` (tiered fallback,
    deferred device values, validator hook all behave identically —
    the daemon drives the runner's own engine); ``load_fn`` maps the
    arrived payload (a spool path) to the process payload in the
    background prefetch workers. Results journal to
    ``workdir/results.jsonl``; rerunning the same workdir resumes.

    Lifecycle: ``start()`` launches the ingest loop (and the
    telemetry HTTP listener when ``http`` is not False —
    ``http=(host, port)``, port 0 = ephemeral, see
    :attr:`http_port`); ``stop()`` finishes everything admitted,
    drains the journal writer (durability barrier), writes the final
    RunReport, and shuts the listener. Use as a context manager for
    the same pair.
    """

    def __init__(self, source, process, workdir,
                 tiers=_runner._DEFAULT_TIERS, retries=1,
                 validate=None, defer_validate=False, load_fn=None,
                 prefetch=4, inflight=2, loader_workers=2,
                 journal_name="results.jsonl", http=("127.0.0.1", 0),
                 heartbeat=True, warmup=None, stale_after_s=5.0,
                 report=True, on_published=None, process_batch=None,
                 max_batch=16, controller=None, tenant_policy=None,
                 geometry_fn=None, bucket_lanes=True,
                 on_published_group=None, gain_schedule=True,
                 tenant_label_cap=8):
        self.source = source
        self.process = process
        self.workdir = os.fspath(workdir)
        self.tiers = tuple(tiers)
        self.retries = retries
        self.validate = validate
        self.load_fn = load_fn
        self.prefetch = max(1, int(prefetch))
        self.inflight = max(1, int(inflight))
        if validate is not None and not defer_validate:
            self.inflight = 0        # runner semantics: fence per epoch
        self.loader_workers = max(1, int(loader_workers))
        self.stale_after_s = float(stale_after_s)
        self.report = bool(report)
        self._warmup_fn = warmup
        # post-publish consumers: ``fn(service, epoch_id,
        # loaded_payload, outcome)`` runs in the loop thread AFTER
        # the epoch's result is journaled — the hook point the online
        # arc detector (detect/online.py) registers through
        self._hooks = list(on_published or [])
        self._group_hooks = list(on_published_group or [])
        self._hook_q = collections.deque()   # (run, args), publish order

        # batched service mode: when ``process_batch``
        # is given, loaded arrivals STAGE in the lane assembler and
        # dispatch as ONE batched device program per geometry; the
        # controller maps the live backlog to the batch-size target
        # (track-up / decay-down — serve/lanes.py), the optional
        # tenant policy adds admission control + fair-share quotas,
        # and groups pad up to power-of-two buckets so steady-state
        # service builds no new program.
        self.process_batch = process_batch
        self.max_batch = max(1, int(max_batch))
        self.geometry_fn = geometry_fn
        self.bucket_lanes = bool(bucket_lanes)
        self.tenant_policy = tenant_policy
        self._assembler = None
        self._controller = None
        if process_batch is not None:
            self._assembler = _lanes.LaneAssembler(policy=tenant_policy)
            self._controller = controller \
                or _lanes.AdaptiveBatchController(max_batch=self.max_batch)
            self.max_batch = self._controller.max_batch
        self._tenant_pending = {}    # tenant -> admitted-not-published
        self._staged_t = {}          # key -> staging-entry instant

        # program cost ledger: batch service times feed
        # the controller's gain scheduling, and the accumulated
        # ledger persists per workdir (loaded here, saved at loop
        # exit) so a restarted daemon resumes its cost model
        self.gain_schedule = bool(gain_schedule)
        self._buckets_seen = set()
        self._ledger_path = _ledger.workdir_path(self.workdir)
        _ledger.load(self._ledger_path)

        # per-tenant SLO accounting: the first
        # ``tenant_label_cap`` distinct tenants (by ingest order) get
        # dedicated metric labels, later ones fold into "other" —
        # tenant names are user-controlled strings, so every
        # tenant-labeled metric goes through _tenant_label to keep
        # label cardinality bounded
        self.tenant_label_cap = max(1, int(tenant_label_cap))
        self._tenant_labels = {}
        self._lat_by_tenant = {}     # label -> deque of latencies

        os.makedirs(self.workdir, exist_ok=True)
        self.store = ResultsStore(self.workdir, name=journal_name)
        self._done_records = self.store.records()
        self.timeline = StageTimeline(device_stage="dispatch")
        self._writer = AsyncJournalWriter(self.store.journal,
                                          timeline=self.timeline)
        self._rec = _ServeRecorder(
            self.store.journal, self._writer, self.tiers,
            heartbeat=self._make_heartbeat(heartbeat))
        self._reporter = _report.RunReportBuilder(runner="serve_survey")

        self._lock = threading.Lock()
        self._inflight_sha = {}
        self._states = collections.OrderedDict()
        self._lat = collections.deque(maxlen=4096)
        self._window = collections.deque()
        self._fresh_q = queue.Queue()
        self._index = 0
        self._warm = False
        self._stopping = threading.Event()
        self._done = threading.Event()
        self._stop_sent = False
        self._last_tick = time.time()
        self._error = None

        self._loader = PrefetchLoader(
            self._fresh_stream(), depth=self.prefetch,
            workers=self.loader_workers, load_fn=self.load_fn,
            timeline=self.timeline)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-loop")
        self._http = None
        if http:
            from .http import TelemetryServer

            host, port = http if isinstance(http, (tuple, list)) \
                else ("127.0.0.1", int(http) if http is not True else 0)
            self._http = TelemetryServer(self, host=host, port=port)

    # ---- lifecycle --------------------------------------------------
    def start(self):
        if self._http is not None:
            self._http.start()
        self._thread.start()
        return self

    def stop(self, timeout=60.0):
        """Graceful shutdown: finish every admitted epoch, drain the
        journal writer, write the final RunReport, stop the HTTP
        listener. Idempotent."""
        self._stopping.set()
        if hasattr(self.source, "close"):
            self.source.close()
        if self._thread.is_alive() or not self._done.is_set():
            if self._thread.ident is not None:
                self._thread.join(timeout=timeout)
        self._loader.close()
        if self._http is not None:
            self._http.close()
        if self._error is not None:
            # the loop thread is joined above, so its final _error
            # write happens-before this read-and-clear
            err, self._error = self._error, None
            _raise_loop_error(err)
        return self

    close = stop

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def wait_idle(self, timeout=30.0, settle_s=0.05):
        """Block until nothing is queued, loading, or in flight (the
        test-friendly quiesce point; the stream may deliver more
        later). Returns True when idle was reached; re-raises the
        error that ended the loop thread, if one did."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._done.is_set() and self._error is not None:
                _raise_loop_error(self._error)
            if self.backlog() == 0 and not self._window \
                    and not self._hook_q:
                time.sleep(settle_s)
                if self.backlog() == 0 and not self._window \
                        and not self._hook_q:
                    return True
            time.sleep(0.01)
        return False

    # ---- ingest loop ------------------------------------------------
    def _fresh_stream(self):
        """The lazy (epoch_id, payload) stream feeding the prefetch
        loader; ends when the stop sentinel arrives."""
        while True:
            item = self._fresh_q.get()
            if item is _STOP:
                return
            yield item

    def _make_heartbeat(self, spec):
        if spec is None or spec is False:
            return None
        kw = {"streaming": True, "event": "serve.heartbeat",
              "stats_fn": self._live_stats}
        if isinstance(spec, dict):
            kw.update(spec)
        elif isinstance(spec, _hb.Heartbeat):
            return spec
        elif spec is not True:
            raise TypeError(
                f"heartbeat must be None/bool/dict/Heartbeat, got "
                f"{type(spec).__name__}")
        return _hb.Heartbeat(**kw)

    def _loop(self):
        try:
            with slog.span("serve.run", workdir=self.workdir):
                self._warmup()
                while True:
                    self._tick()
                    stopping = self._stopping.is_set()
                    if not stopping:
                        self._pull_arrivals()
                    elif not self._stop_sent:
                        self._fresh_q.put(_STOP)
                        self._stop_sent = True
                    busy = self._window or (
                        self._assembler is not None
                        and len(self._assembler))
                    # with hook calls waiting the loop does not block:
                    # the time it would wait goes to the oldest of them
                    got = self._loader.poll(
                        timeout=0.0 if self._hook_q
                        else 0.02 if busy else 0.05)
                    if got is not None:
                        self._route(*got)
                    if self._assembler is not None:
                        self._maybe_assemble(
                            idle=(got is None) or stopping)
                    while len(self._window) > self.inflight:
                        self._consume_one()
                    if got is None and self._window:
                        # idle stream → flush the window now: bounded
                        # ingest→publish latency beats dispatch-ahead
                        self._consume_one()
                    if self._hook_q and (got is None or len(
                            self._hook_q) > HOOK_BACKLOG):
                        run, args = self._hook_q.popleft()
                        run(*args)
                    self._update_gauges()
                    if stopping and self._stop_sent \
                            and self._loader.exhausted \
                            and not self._window \
                            and not self._hook_q \
                            and not (self._assembler is not None
                                     and len(self._assembler)):
                        break
            self._writer.close()       # durability barrier
            self._rec.beat(force=True)
            # persist the accumulated cost model next to the results
            # journal: a restarted daemon loads it back and resumes
            # gain scheduling with a warm cost model
            _ledger.save(self._ledger_path)
            if self.report:
                self._reporter.finalize(
                    self.workdir, dict(self._rec.tally),
                    list(self._rec.outcomes),
                    timeline=self.timeline.summary(),
                    extra=self._live_stats(),
                    slo=self.slo_snapshot())
        except Exception as e:  # noqa: BLE001 — the loop must die
            # loudly: surfaced by /healthz (loop no longer ticking),
            # re-raised from stop() and wait_idle(); only the loop
            # thread assigns _error
            self._error = e
            slog.log_failure("serve.loop_error", stage="loop", error=e)
        finally:
            self._done.set()

    def _warmup(self):
        """Optional warm-up: run ``warmup()`` (e.g. a synthetic epoch
        through ``process``, or ``ArcDetector.warmup``) before serving,
        so every kernel and program the service launches is built and
        loaded before ``/readyz`` goes ready. A kernel error or device
        fault ends the loop; any other warm-up failure is logged, not
        fatal — the first real epoch warms instead."""
        if self._warmup_fn is None:
            return
        try:
            self._warmup_fn()
            # a False→True latch written only by the loop thread;
            # /readyz reads it racily (a stale False is a harmless
            # not-ready-yet)
            self._warm = True
        except Exception as e:  # noqa: BLE001 — warm-up is advisory
            if is_kernel_error(e):
                raise
            slog.log_failure("serve.warmup_error", stage="warmup",
                             error=e)

    def _tick(self):
        self._last_tick = time.time()

    def _tenant_label(self, tenant):
        """The bounded metric label for a tenant namespace: the first
        ``tenant_label_cap`` distinct tenants keep their own label,
        every later one is ``"other"`` — tenant names come off the
        spool (user-controlled), and an unbounded label set is a
        cardinality leak. The mapping is sticky for the
        process lifetime. Callers hold ``self._lock``."""
        lbl = self._tenant_labels.get(tenant)
        if lbl is None:
            lbl = str(tenant) \
                if len(self._tenant_labels) < self.tenant_label_cap \
                else "other"
            self._tenant_labels[tenant] = lbl
        return lbl

    def _pull_arrivals(self):
        while self._fresh_q.qsize() < max(2, self.prefetch):
            item = self.source.get(timeout=0.0)
            if item is None:
                return
            self._admit(item)

    def _admit(self, item):
        key = str(item.epoch)
        tenant = getattr(item, "tenant", None) or "default"
        with self._lock:
            if key in self._states:
                return                       # already seen this run
            self._index += 1
            self.timeline.assign_trace(
                key, _runner._trace_id(self._index - 1, key))
            now = time.perf_counter()
            self.timeline.record(key, "ingest", item.t_arrive, now)
            if key in self._done_records:
                self._rec.tally["n_epochs"] += 1
                out = self._rec.resumed(key, self._done_records[key])
                self._states[key] = {
                    "status": "resumed",
                    "result_status": self._done_records[key].get(
                        "status", "ok"),
                    "tier": out.tier}
                return
            # dedupe against published content AND epochs still in
            # flight (two copies arriving back-to-back must not both
            # process just because neither has published yet)
            dup_of = self.store.known_content(item.sha) \
                or (item.sha and self._inflight_sha.get(item.sha))
            if dup_of is not None:
                _metrics.counter(
                    "serve_duplicates_total",
                    help="stream epochs dropped as content "
                         "duplicates").inc()
                slog.log_event("serve.duplicate", epoch=key,
                               duplicate_of=dup_of)
                self._states[key] = {"status": "duplicate",
                                     "duplicate_of": dup_of}
                return
            # tenant admission control: an over-quota
            # tenant's arrival is refused BEFORE it costs a load or a
            # lane — neighbours' admission is untouched
            if self.tenant_policy is not None \
                    and not self.tenant_policy.admit(
                        tenant, self._tenant_pending.get(tenant, 0)):
                _metrics.counter(
                    "serve_tenant_rejected_total",
                    help="arrivals refused by per-tenant admission "
                         "control").labels(
                    tenant=self._tenant_label(tenant)).inc()
                slog.log_event("serve.tenant_rejected", epoch=key,
                               tenant=tenant,
                               pending=self._tenant_pending.get(
                                   tenant, 0))
                self._states[key] = {"status": "rejected",
                                     "tenant": tenant}
                return
            _metrics.counter(
                "serve_epochs_ingested_total",
                help="fresh epochs admitted into the pipeline").inc()
            _metrics.counter(
                "serve_tenant_ingested_total",
                help="fresh epochs admitted, by tenant namespace"
            ).labels(tenant=self._tenant_label(tenant)).inc()
            self._tenant_pending[tenant] = \
                self._tenant_pending.get(tenant, 0) + 1
            self._rec.tally["n_epochs"] += 1
            self._rec.set_sha(key, item.sha)
            if item.sha:
                self._inflight_sha[item.sha] = key
            self._states[key] = {"status": "queued",
                                 "t_ingest": item.t_arrive,
                                 "sha": item.sha,
                                 "tenant": tenant}
        self._fresh_q.put((key, item.payload))

    def _dispatch(self, eid, loaded):
        key = str(eid)
        with self._lock:
            st = self._states.get(key, {})
            st["status"] = "in_flight"
        if not loaded.ok:
            # the dispatch window is loop-thread-only (_dispatch and
            # _consume_one both run in _loop); wait_idle only reads
            # its truthiness
            self._window.append(
                (key, None,
                 _runner._loader_outcome(key, loaded.error), None))
            return
        with _ledger.timed("serve.batch", shape=1), \
                self.timeline.span(key, "dispatch"):
            entry = _runner._dispatch_first(
                key, loaded.payload, self.process, self.tiers,
                self.retries, self.validate)
        self._window.append(entry)

    # ---- batched service mode -----------------------------------------
    def _route(self, eid, loaded):
        """Loaded-arrival routing: batched mode stages healthy loads
        in the lane assembler; everything else (no assembler, loader
        failure, controller drained to B=1 with nothing staged) takes
        the existing single-epoch dispatch window."""
        if self._assembler is None or not loaded.ok:
            self._dispatch(eid, loaded)
            return
        if self._controller.current <= 1 \
                and not len(self._assembler):
            # drained back to single-epoch dispatch at idle: bounded
            # low-cadence latency, zero staging detour
            self._dispatch(eid, loaded)
            return
        key = str(eid)
        with self._lock:
            st = self._states.get(key, {})
            st["status"] = "staged"
            tenant = st.get("tenant", "default")
        geometry = self.geometry_fn(loaded.payload) \
            if self.geometry_fn is not None else None
        # the assembler and the staging clock are loop-thread-only
        # (staged by _route, drained by _maybe_assemble and
        # _dispatch_group, all in _loop)
        self._staged_t[key] = time.perf_counter()
        self._assembler.stage((key, loaded.payload), tenant, geometry)

    def _maybe_assemble(self, idle):
        """Form and dispatch one batched group when the staging
        buffer has reached the controller's target B — or whatever is
        staged, on an idle tick (a lull must flush staged lanes, the
        single-path idle-drain guarantee carried over)."""
        staged = len(self._assembler)
        if not staged:
            return
        b = self._controller.current
        if staged < b and not idle:
            return
        took = self._assembler.take(b)
        if took is None:
            return
        geometry, entries = took
        if len(entries) == 1:
            # B drained to 1: ride the runner's per-epoch engine
            # (identical to non-batched dispatch, window semantics
            # and all)
            key, payload = entries[0]
            t_staged = self._staged_t.pop(key, None)
            if t_staged is not None:
                self.timeline.record(key, "assemble", t_staged,
                                     time.perf_counter())
            with self._lock:
                st = self._states.get(key, {})
                st["status"] = "in_flight"
            with _ledger.timed("serve.batch", shape=1), \
                    self.timeline.span(key, "dispatch"):
                entry = _runner._dispatch_first(
                    key, payload, self.process, self.tiers,
                    self.retries, self.validate)
            self._window.append(entry)
            return
        self._dispatch_group(geometry, entries)

    def _group_process(self, payloads, tier=None):
        """The assembler-facing ``process_batch`` wrapper: pads the
        group up to its power-of-two bucket with copies of a real
        payload (so the adaptive B builds no new program in steady
        state) and slices the padded lanes' results back
        off."""
        if not self.bucket_lanes:
            return self.process_batch(payloads, tier=tier)
        padded, n = _lanes.pad_group(payloads, self.max_batch)
        out = self.process_batch(padded, tier=tier)
        return list(out)[:n]

    def _dispatch_group(self, geometry, entries):
        """ONE batched device program for ``entries`` — the runner's
        shared group engine (robust/runner.py:run_group: ladder,
        batch fallback, per-lane health screening and individual
        descent), then per-lane publish in group order."""
        keys = [k for k, _ in entries]
        payloads = dict(entries)
        now = time.perf_counter()
        for key in keys:
            t_staged = self._staged_t.pop(key, None)
            if t_staged is not None:
                self.timeline.record(key, "assemble", t_staged, now)
        with self._lock:
            tenants = {}
            for key in keys:
                st = self._states.get(key, {})
                st["status"] = "in_flight"
                t = st.get("tenant", "default")
                tenants[t] = tenants.get(t, 0) + 1
        bucket = _lanes.bucket_size(len(entries), self.max_batch) \
            if self.bucket_lanes else len(entries)
        _metrics.counter(
            "serve_batches_total",
            help="assembled lane groups dispatched as one batched "
                 "device program").inc()
        _metrics.counter(
            "serve_batch_lanes_total",
            help="real (non-padding) lanes dispatched in batched "
                 "groups").inc(len(entries))
        _metrics.counter(
            "serve_batch_padded_lanes_total",
            help="padding lanes added to reach the power-of-two "
                 "bucket (results discarded)").inc(
            bucket - len(entries))
        slog.log_event(
            "serve.batch", n_lanes=len(entries), bucket=bucket,
            b_target=self._controller.current,
            geometry=repr(geometry) if geometry is not None else None,
            tenants=tenants)
        outs = []
        t0 = time.perf_counter()
        _runner.run_group(
            entries, self._group_process, self.process, self.tiers,
            self.retries, self.validate or _runner.default_lane_validate,
            lambda eid, out: outs.append((eid, out)),
            epoch_label=f"group[{keys[0]}+{len(entries)}]")
        t1 = time.perf_counter()
        # the measured per-bucket batch service time — the gain
        # scheduler's input and the /ledger endpoint's content
        _ledger.record("serve.batch", t1 - t0, "steady", shape=bucket)
        self._buckets_seen.add(int(bucket))
        self._reschedule_controller()
        for key in keys:
            # the batched program is the device stage: dispatch +
            # compute + fetch for every lane in one span
            self.timeline.record(key, "dispatch", t0, t1)
        for eid, out in outs:
            # per-lane fence span: program return → this lane's
            # publish (the lane's wait behind its groupmates)
            self.timeline.record(eid, "fence", t1,
                                 time.perf_counter())
            self._publish(out)
            if self._hooks:
                self._defer(self._run_hooks, eid, payloads.get(str(eid)),
                            out)
        if self._group_hooks:
            self._defer(self._run_group_hooks, entries, dict(outs))

    def _reschedule_controller(self):
        """Gain-schedule the batch controller from the ledger's
        measured per-bucket service time: the
        steady median of a 1-lane dispatch vs the widest observed
        bucket decides how amortised batching actually is, and the
        controller interpolates gain/decay accordingly (compute-bound
        lanes → under-track the backlog, less padding waste, faster
        drain). With no 1-lane samples (sustained load batches
        everything) T(1) is extrapolated from the two observed bucket
        extremes under a linear cost model. Runs once per dispatched
        group — a few ring-buffer median queries, microseconds
        against a batch program."""
        if self._controller is None or not self.gain_schedule \
                or not self._buckets_seen:
            return
        b = max(self._buckets_seen)
        if b <= 1:
            return
        tb = _ledger.steady_median("serve.batch", shape=b)
        t1 = _ledger.steady_median("serve.batch", shape=1)
        if t1 is None and len(self._buckets_seen) >= 2 and tb:
            # a daemon under sustained load never dispatches a single
            # lane, so T(1) may be unmeasured; estimate it from the
            # smallest and widest observed buckets via the linear
            # cost model t(b) = c_fixed + c_lane * b
            b0 = min(self._buckets_seen)
            t0 = _ledger.steady_median("serve.batch", shape=b0)
            if t0 and b > b0:
                c_lane = (tb - t0) / (b - b0)
                t1 = max(t0 - c_lane * (b0 - 1), 1e-9)
        factor = self._controller.reschedule(t1, tb, b)
        if factor is not None:
            _metrics.gauge(
                "serve_controller_gain",
                help="gain-scheduled batch controller gain",
            ).set(self._controller.gain)

    def _consume_one(self):
        epoch_id, payload, value, report = self._window.popleft()
        if isinstance(value, EpochOutcome):    # already decided
            out = value
        else:
            with self.timeline.span(epoch_id, "fence"):
                out = _runner._consume_deferred(
                    epoch_id, payload, value, report, self.process,
                    self.tiers, self.retries, self.validate)
        self._publish(out)
        if self._hooks:
            self._defer(self._run_hooks, epoch_id, payload, out)

    # ---- post-publish hook point ---------------------------------------
    def _defer(self, run, *args):
        """Queue a post-publish hook call: the loop runs it, in publish
        order, when no arrival is waiting (after publishing what it
        holds) or once :data:`HOOK_BACKLOG` calls wait, so a hook delays
        a later epoch's publish by at most one hook call while the
        hooks keep up with the stream."""
        self._hook_q.append((run, args))

    def add_on_published(self, fn):
        """Register a post-publish consumer ``fn(service, epoch_id,
        loaded_payload, outcome)``. Hooks run in the ingest-loop
        thread AFTER the epoch's result is journaled (the epoch's own
        ingest→publish latency is already accounted), in publish order,
        when the loop has no newer arrival to publish first
        (:meth:`_defer`); each hook call
        is a named span on the epoch's trace (``fn.hook_stage``,
        default ``'on_published'``) and a hook crash is contained —
        logged as ``serve.hook_error``, counted, never fatal to the
        loop — unless it is a kernel error or device fault, which
        ends the loop. Call before :meth:`start` (single-writer: the loop
        thread is the only reader)."""
        self._hooks.append(fn)
        return fn

    def add_on_published_group(self, fn):
        """Register a post-publish GROUP consumer ``fn(service,
        entries, outcomes)`` for the batched service mode: after a
        whole assembled group publishes, the hook receives the
        group's ``[(key, loaded_payload), ...]`` and its ``{key:
        EpochOutcome}`` map in one call — the spike-grouped
        confirmation hook point (detect/online.py:make_group_hook
        scans all lanes in ONE bank program instead of per-epoch).
        Same containment contract as :meth:`add_on_published`; spans
        land on the group's first lane trace. Call before
        :meth:`start`."""
        self._group_hooks.append(fn)
        return fn

    def _run_group_hooks(self, entries, outcomes):
        if not self._group_hooks or not entries:
            return
        first = str(entries[0][0])
        for fn in self._group_hooks:
            stage = getattr(fn, "hook_stage", "on_published_group")
            try:
                with self.timeline.span(first, stage):
                    fn(self, entries, outcomes)
            except Exception as e:  # noqa: BLE001 — contained like
                # per-epoch hooks: the stream keeps flowing
                if is_kernel_error(e):
                    raise
                slog.log_failure("serve.hook_error", stage=stage,
                                 error=e, epoch=first)
                _metrics.counter(
                    "serve_hook_errors_total",
                    help="post-publish hook failures (epoch "
                         "unaffected, hook skipped)").inc()

    def annotate(self, key, **fields):
        """Merge extra fields into an epoch's ``/state`` entry (hook
        consumers attach their per-epoch results — e.g. the detector's
        ``detect={...}`` record)."""
        with self._lock:
            st = self._states.get(str(key))
            if st is not None:
                st.update(fields)

    def _run_hooks(self, epoch_id, payload, out):
        for fn in self._hooks:
            stage = getattr(fn, "hook_stage", "on_published")
            try:
                with self.timeline.span(epoch_id, stage):
                    fn(self, epoch_id, payload, out)
            except Exception as e:  # noqa: BLE001 — a consumer crash
                # must not take the serving loop down; surfaced via
                # slog + metrics, the stream keeps flowing
                if is_kernel_error(e):
                    raise
                slog.log_failure("serve.hook_error", stage=stage,
                                 error=e, epoch=str(epoch_id))
                _metrics.counter(
                    "serve_hook_errors_total",
                    help="post-publish hook failures (epoch "
                         "unaffected, hook skipped)").inc()

    def _publish(self, out):
        key = str(out.epoch)
        t0 = time.perf_counter()
        with self._lock:
            self._rec.record(out)
            st = self._states.setdefault(key, {})
            st["status"] = out.status
            st["tier"] = out.tier
            if out.status == "quarantined":
                st["error_class"] = out.error_class
            t_pub = time.perf_counter()
            t_in = st.get("t_ingest")
            tenant = st.get("tenant")
            if t_in is not None:
                lat = t_pub - t_in
                st["latency_s"] = round(lat, 6)
                self._lat.append(lat)
                _metrics.histogram(
                    "serve_e2e_latency_seconds",
                    help="ingest-to-published end-to-end latency",
                    buckets=LATENCY_BUCKETS).observe(lat)
                if tenant is not None:
                    # per-tenant SLO view: same family,
                    # bounded tenant label (top-K + "other")
                    lbl = self._tenant_label(tenant)
                    _metrics.histogram(
                        "serve_e2e_latency_seconds",
                        help="ingest-to-published end-to-end latency",
                        buckets=LATENCY_BUCKETS).labels(
                        tenant=lbl).observe(lat)
                    self._lat_by_tenant.setdefault(
                        lbl, collections.deque(maxlen=1024)).append(lat)
            self.store.note_published(key, st.get("sha"))
            self._inflight_sha.pop(st.get("sha"), None)
            if tenant is not None:
                pend = self._tenant_pending.get(tenant, 0)
                if pend > 0:
                    self._tenant_pending[tenant] = pend - 1
                _metrics.counter(
                    "serve_tenant_published_total",
                    help="published epochs, by tenant namespace"
                ).labels(tenant=self._tenant_label(tenant)).inc()
                if out.status == "quarantined":
                    _metrics.counter(
                        "serve_tenant_quarantined_total",
                        help="quarantined epochs, by tenant "
                             "namespace").labels(
                        tenant=self._tenant_label(tenant)).inc()
        self.timeline.record(key, "publish", t0, time.perf_counter())
        if out.status == "ok":
            self._warm = True            # loop-thread latch (_warmup)

    def _update_gauges(self):
        backlog = self.backlog()
        _metrics.gauge(
            "serve_backlog_depth",
            help="epochs arrived but not yet published",
        ).set(backlog)
        if self._controller is not None:
            # the feedback loop: the backlog gauge drives the
            # batch-size target every tick
            _metrics.gauge(
                "serve_batch_size",
                help="current adaptive batch-size target B",
            ).set(self._controller.observe(backlog))

    # ---- live surfaces (HTTP handlers + heartbeat) ------------------
    def backlog(self):
        """Epochs arrived but not yet published: source queue +
        admitted-but-unloaded + loaded-or-loading + dispatch window."""
        n = self._fresh_q.qsize() + len(self._window) \
            + self._loader.buffered()
        if self._assembler is not None:
            n += len(self._assembler)
        if hasattr(self.source, "backlog"):
            n += self.source.backlog()
        return n

    def latency_percentiles(self):
        """``{"p50_s":, "p95_s":, "n":}`` over the recent
        ingest→published latencies (None values until the first
        publish)."""
        lat = list(self._lat)
        if not lat:
            return {"p50_s": None, "p95_s": None, "n": 0}
        return {"p50_s": round(float(np.percentile(lat, 50)), 6),
                "p95_s": round(float(np.percentile(lat, 95)), 6),
                "n": len(lat)}

    def tenant_latency_percentiles(self):
        """Per-tenant-label ``{"p50_s":, "p95_s":, "n":}`` over the
        recent latencies — keys are the BOUNDED labels
        (:meth:`_tenant_label`: top-K tenants + ``"other"``), the
        per-tenant SLO view heartbeats and the RunReport carry."""
        # lock-free like latency_percentiles: C-level dict/deque
        # copies under the GIL; heartbeats call this from inside
        # _publish (which holds self._lock), so taking the lock here
        # would self-deadlock
        by = {lbl: list(q) for lbl, q in
              list(self._lat_by_tenant.items()) if q}
        return {lbl: {"p50_s": round(float(np.percentile(lat, 50)), 6),
                      "p95_s": round(float(np.percentile(lat, 95)), 6),
                      "n": len(lat)}
                for lbl, lat in sorted(by.items())}

    def slo_snapshot(self):
        """The RunReport ``slo`` block: global + per-tenant
        latency percentiles plus the ledger's per-site steady medians
        (``{"global":, "tenants":, "sites":}``)."""
        return {"global": self.latency_percentiles(),
                "tenants": self.tenant_latency_percentiles(),
                "sites": _ledger.LEDGER.steady_site_medians()}

    def _live_stats(self):
        stats = {"backlog": self.backlog()}
        pct = self.latency_percentiles()
        if pct["n"]:
            stats["latency_p50_s"] = pct["p50_s"]
            stats["latency_p95_s"] = pct["p95_s"]
        tenants = self.tenant_latency_percentiles()
        if tenants:
            stats["tenants"] = tenants
        return stats

    def healthy(self):
        """Liveness: the ingest loop is running and recently ticked,
        and the source's own poll loop (when it has one) is alive.
        The ``/healthz`` answer."""
        detail = {
            "loop_alive": self._thread.is_alive(),
            "loop_staleness_s": round(time.time() - self._last_tick,
                                      3),
            "source_alive": bool(getattr(self.source, "alive",
                                         lambda: True)()),
        }
        if hasattr(self.source, "last_activity"):
            detail["source_staleness_s"] = round(
                time.time() - self.source.last_activity(), 3)
        ok = (detail["loop_alive"] and detail["source_alive"]
              and detail["loop_staleness_s"] < self.stale_after_s
              and detail.get("source_staleness_s",
                             0.0) < self.stale_after_s)
        detail["ok"] = bool(ok)
        return detail

    def ready(self):
        """Readiness: healthy AND warm (the warm-up built and loaded
        every kernel and program, or at least one epoch published ok)
        — an autoscaler must not route work at a process that would
        stall its first request on a kernel build. The ``/readyz``
        answer."""
        h = self.healthy()
        detail = {"healthy": h["ok"], "warm": self._warm,
                  "stopping": self._stopping.is_set()}
        detail["ok"] = bool(h["ok"] and self._warm
                            and not detail["stopping"])
        return detail

    def report_snapshot(self):
        """The CURRENT RunReport — schema-valid mid-run (the
        ``/report`` answer)."""
        with self._lock:
            tally = dict(self._rec.tally)
            tally["tier_counts"] = dict(tally.get("tier_counts", {}))
            outcomes = list(self._rec.outcomes)
        return self._reporter.snapshot(
            tally, outcomes, timeline=self.timeline.summary(),
            extra={**self._live_stats(),
                   "latency": self.latency_percentiles()},
            in_progress=not self._done.is_set(),
            slo=self.slo_snapshot())

    def state_snapshot(self):
        """Per-epoch status map (the ``/state`` answer):
        queued / in_flight / ok / quarantined / resumed /
        duplicate."""
        with self._lock:
            epochs = {k: dict(v) for k, v in self._states.items()}
        counts = {}
        for st in epochs.values():
            counts[st["status"]] = counts.get(st["status"], 0) + 1
        out = {"epochs": epochs, "counts": counts,
               "backlog": self.backlog(),
               "latency": self.latency_percentiles()}
        det = {"scanned": 0, "triggered": 0, "confirmed": 0}
        for st in epochs.values():
            d = st.get("detect")
            if not isinstance(d, dict):
                continue
            det["scanned"] += 1
            det["triggered"] += bool(d.get("triggered"))
            det["confirmed"] += bool(d.get("confirmed"))
        if det["scanned"]:
            out["detect"] = det
        return out

    def results(self):
        """Published results via the store's atomic read API."""
        return self.store.records()

    def export_trace(self, path):
        """Write the run-so-far stage spans (ingest/load/dispatch/
        fence/journal/publish tracks, per-epoch trace IDs) as
        Chrome-trace JSON."""
        return self.timeline.export_trace(path)

    @property
    def http_port(self):
        """Bound telemetry port (None when HTTP is disabled)."""
        return None if self._http is None else self._http.port
