"""Fault-tolerant, journaled, pipelined survey runner.

The port's own copy of ``scintools_tpu/robust/runner.py``: the
production shape of a survey, "for each of ~10³ epochs: load → search
→ fit → append results", wrapped in

- **per-epoch quarantine** — an epoch whose loader raises
  :class:`~scintools_tpu_torch.io.MalformedInputError` (or any loader
  exception — captured per epoch, never a pipeline crash), whose
  every fallback tier fails, or whose result a validator rejects is
  recorded as quarantined (structured slog record + journal line) and
  the survey moves on. Healthy epochs are never touched by a bad
  neighbour;
- **tiered fallback** — ``process(payload, tier=...)`` is dispatched
  through the ladder (robust/ladder.py), bounded retries on transient
  OOM errors, every transition one slog failure record;
- **journaled resume** — every completed epoch is one fsynced
  CRC-stamped JSONL line (parallel/checkpoint.py:EpochJournal), byte
  for byte the JAX package's line for the same record, so a journal
  either package wrote resumes in the other. A rerun after SIGKILL
  takes journaled records verbatim and processes only unfinished
  epochs;
- **pipelining** (default; ``pipeline=False`` keeps the strictly
  sequential oracle) — epoch loading runs in a bounded background
  prefetch queue (host work only: the upload to the card happens on
  the dispatching thread), up to ``inflight`` dispatched epochs stay
  un-fenced so CUDA's asynchronous launches keep the card busy
  (``process`` may return device tensors still running, or a
  :class:`~scintools_tpu_torch.parallel.pipeline.DeferredResult`;
  they are fenced only in ``finalize_result``), and journal CRC/fsync
  runs on a writer thread with group commit. Epoch order, quarantine
  semantics, journal bytes and resume behaviour are identical to the
  sequential oracle.

A :class:`~scintools_tpu_torch.backend.KernelError`, or a device fault
a kernel raised asynchronously and that shows at a fence
(:func:`~scintools_tpu_torch.backend.is_kernel_error`), is never
quarantined or descended past: it propagates out of
:func:`run_survey`, :func:`run_survey_batched` and :func:`run_group`
(see robust/ladder.py for why).

Pass a :class:`~scintools_tpu_torch.utils.profiling.StageTimeline` as
``timeline`` to account load/dispatch/fence/journal overlap per epoch.
"""

from __future__ import annotations

import collections
import os
import time
from dataclasses import asdict, dataclass, field

from . import ladder as _ladder
from ..backend import is_kernel_error, resolve_device
from ..obs import heartbeat as _hb
from ..obs import metrics as _metrics
from ..obs import report as _report
from ..parallel.checkpoint import EpochJournal
from ..utils import slog

_DEFAULT_TIERS = (_ladder.TIER_FUSED, _ladder.TIER_STAGED,
                  _ladder.TIER_NUMPY)


@dataclass
class EpochOutcome:
    """One epoch's fate: ``status`` is 'ok', 'quarantined', or
    'resumed' (taken verbatim from the journal)."""

    epoch: object
    status: str
    tier: str = ""
    retries: int = 0
    error: str = ""
    error_class: str = ""
    result: dict = field(default_factory=dict)


def _is_malformed(exc):
    from ..io import MalformedInputError

    return isinstance(exc, MalformedInputError)


def _loader_outcome(epoch_id, exc):
    """Quarantine outcome for an epoch whose LOADER failed (malformed
    file, truncated read, preprocessing crash). The exception class is
    preserved; non-:class:`MalformedInputError` loader failures are
    still per-epoch quarantines — a bad file must never crash the
    pipeline — but keep their own class for the post-mortem. A
    kernel error or device fault is re-raised, never quarantined."""
    if is_kernel_error(exc):
        raise exc
    slog.log_failure("robust.quarantine", epoch=epoch_id, stage="load",
                     error=exc, tier=None, retry=0)
    return EpochOutcome(
        epoch=epoch_id, status="quarantined", tier="", retries=0,
        error=str(exc)[:300], error_class=type(exc).__name__)


def _load_inline(payload, load_fn):
    """The sequential oracle's load stage: same semantics as the
    background prefetch loader, on the calling thread."""
    if load_fn is not None:
        return load_fn(payload)
    if callable(payload):
        return payload()
    return payload


class _Recorder:
    """Shared bookkeeping for both runner entries: tallies, ordered
    outcomes, results, journal appends (direct or via the async
    writer), per-epoch metrics, and the heartbeat cadence."""

    def __init__(self, journal, writer, tiers, heartbeat=None,
                 journal_extra=None):
        self.journal = journal
        self.writer = writer
        self.heartbeat = heartbeat
        self.journal_extra = journal_extra
        self.outcomes = []
        self.results = {}
        self.tally = {"n_epochs": 0, "n_ok": 0, "n_quarantined": 0,
                      "n_resumed": 0, "retries": 0,
                      "tier_counts": {t: 0 for t in tiers}}

    def _append(self, key, **fields):
        # worker-attribution columns: constant fields — or a callable
        # producing them per record (commit stamps) — ride at the END
        # of every journal line, so stripping them restores the exact
        # single-process line bytes
        extra = self.journal_extra() if callable(self.journal_extra) \
            else self.journal_extra
        if extra:
            fields.update(extra)
        if self.writer is not None:
            self.writer.append(key, **fields)
        else:
            self.journal.append(key, **fields)

    def beat(self, force=False):
        """One heartbeat tick (emits only when the cadence is due)."""
        if self.heartbeat is None:
            return
        t = self.tally
        self.heartbeat.beat(
            len(self.outcomes), force=force, ok=t["n_ok"],
            quarantined=t["n_quarantined"], resumed=t["n_resumed"],
            retries=t["retries"])

    def resumed(self, epoch_id, rec):
        out = EpochOutcome(epoch=epoch_id, status="resumed",
                           tier=rec.get("tier", ""),
                           result=rec.get("result") or {})
        if rec.get("status") == "quarantined":
            self.tally["n_quarantined"] += 1
            out.error = rec.get("error", "")
            out.error_class = rec.get("error_class", "")
        else:
            self.results[str(epoch_id)] = out.result
        self.tally["n_resumed"] += 1
        _metrics.counter("survey_epochs_resumed_total",
                         help="epochs taken verbatim from the journal"
                         ).inc()
        self.outcomes.append(out)
        self.beat()
        return out

    def record(self, out):
        """Tally + journal one fresh (non-resumed) outcome."""
        key = str(out.epoch)
        self.tally["retries"] += out.retries
        if out.status == "ok":
            self.tally["n_ok"] += 1
            self.tally["tier_counts"][out.tier] = \
                self.tally["tier_counts"].get(out.tier, 0) + 1
            self.results[key] = out.result
            self._append(key, status="ok", tier=out.tier,
                         retries=out.retries, result=out.result)
            _metrics.counter("survey_epochs_ok_total",
                             help="fresh successful epochs").inc()
        else:
            self.tally["n_quarantined"] += 1
            self._append(key, status="quarantined", tier=out.tier,
                         retries=out.retries, error=out.error,
                         error_class=out.error_class)
            _metrics.counter("survey_epochs_quarantined_total",
                             help="fresh quarantined epochs").inc()
        self.outcomes.append(out)
        self.beat()
        return out


def run_survey(epochs, process, workdir, tiers=_DEFAULT_TIERS,
               retries=1, validate=None, journal_name="journal.jsonl",
               resume=True, pipeline=True, prefetch=4, inflight=2,
               loader_workers=2, load_fn=None, defer_validate=False,
               timeline=None, heartbeat=None, report=True,
               journal_extra=None, device=None):
    """Process ``epochs`` — an iterable of ``(epoch_id, payload)`` —
    fault-tolerantly, journaling each completion to
    ``workdir/journal_name``.

    ``process(payload, tier=<name>)`` produces one epoch's result as
    a dict of JSON-able scalars (or device tensors, fenced at
    consumption); it is attempted through the fallback ``tiers`` in
    order (bounded ``retries`` on transient OOM RuntimeErrors per
    tier, robust/ladder.py semantics). A
    :class:`~scintools_tpu_torch.io.MalformedInputError` quarantines the
    epoch immediately (no tier can fix a corrupt file); exhaustion of
    every tier quarantines it with the full attempt trail. A
    ``validate(result) -> bool`` hook (optional) rejects a tier's
    result — e.g. require the device health bitmask be clean — and
    sends the epoch down to the next tier.

    **Pipelined by default** (``pipeline=True``): a payload that is
    CALLABLE is a lazy loader run in ``loader_workers`` background
    threads at most ``prefetch`` epochs ahead (``load_fn`` instead
    maps every payload in the background); up to ``inflight`` epochs
    stay dispatched-but-un-fenced so the device queue never drains —
    ``process`` may return a dict of in-flight device values or a
    :class:`~scintools_tpu_torch.parallel.pipeline.DeferredResult`, fenced
    only at consumption; journal fsyncs run on a writer thread
    (group commit, drained before return). Epoch order, quarantine
    semantics, journal bytes, and resume behaviour match the
    ``pipeline=False`` sequential oracle exactly. A ``validate`` hook
    disables dispatch-ahead (results fence immediately, in order)
    unless ``defer_validate=True`` declares it stateless. ``timeline``
    (a :class:`~scintools_tpu_torch.utils.profiling.StageTimeline`) records
    per-epoch load/dispatch/fence/journal spans.

    **Observability** (obs/): per-epoch counters and
    journal/prefetch metrics accumulate in the process metrics
    registry; ``heartbeat`` (True, a cadence dict
    ``{"every_n":, "every_s":}``, or a prebuilt
    :class:`~scintools_tpu_torch.obs.heartbeat.Heartbeat`) emits live
    ``survey.heartbeat`` progress events; with a ``timeline``, each
    epoch is assigned a deterministic trace ID and the spans export
    as Chrome-trace JSON via ``timeline.export_trace(path)``; and
    ``report=True`` (default) writes the schema-validated
    ``run_report.json`` + ``run_report.md`` artifact into
    ``workdir``.

    ``journal_extra`` (a dict, or a zero-arg callable returning one)
    appends constant attribution fields to the END of every journal
    line (e.g. a worker id), so stripping them recovers the
    single-process line bytes.

    Returns ``{"results": {epoch_id: result_dict},
    "outcomes": [EpochOutcome...], "summary": {...}}`` where summary
    counts ok/quarantined/resumed epochs, per-tier completions, and
    total retries. With ``resume=True`` (default), epochs already in
    the journal are not reprocessed — their journaled results are
    returned verbatim.

    ``device`` is the device the epochs' work runs on (``None``: the
    card), resolved before anything is loaded or journaled, so a survey
    meant for the card ends with a :class:`KernelError` before its
    first epoch where there is none."""
    resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    journal = EpochJournal(os.path.join(workdir, journal_name))
    done = journal.records() if resume else {}
    epochs = list(epochs)
    heartbeat = _hb.as_heartbeat(heartbeat, total=len(epochs))

    t_run0 = time.perf_counter()
    with slog.span("survey.robust_run", n_epochs=len(epochs),
                   workdir=os.fspath(workdir),
                   pipeline=bool(pipeline)):
        if pipeline:
            rec = _run_pipelined(
                epochs, process, journal, done, tiers, retries,
                validate, prefetch, inflight, loader_workers, load_fn,
                defer_validate, timeline, heartbeat, journal_extra)
        else:
            rec = _run_sequential(epochs, process, journal, done,
                                  tiers, retries, validate, load_fn,
                                  timeline, heartbeat, journal_extra)
        slog.log_event("survey.robust_summary", **{
            k: v for k, v in rec.tally.items() if k != "tier_counts"},
            tier_counts=dict(rec.tally["tier_counts"]))
    wall_s = time.perf_counter() - t_run0
    rec.beat(force=True)              # final fresh progress snapshot
    tl_summary = _finish_timeline(timeline)
    if report:
        _report.write_run_report(workdir, _report.build_run_report(
            rec.tally, rec.outcomes, wall_s=wall_s,
            timeline=tl_summary, runner="run_survey"))
    return {"results": rec.results, "outcomes": rec.outcomes,
            "summary": rec.tally}


def _finish_timeline(timeline):
    """Emit the timeline's slog summary and mirror its headline
    numbers into the metrics registry; returns the summary dict (None
    without a timeline)."""
    if timeline is None:
        return None
    s = timeline.log_summary()
    _metrics.gauge("survey_device_idle_seconds",
                   help="wall time no device-stage span covered"
                   ).set(s.get("device_idle_s", 0.0))
    _metrics.gauge("survey_overlap_frac",
                   help="pipeline stage-overlap fraction"
                   ).set(s.get("overlap_frac", 0.0))
    return s


def _trace_id(index, epoch_id):
    """Deterministic per-epoch trace ID: stable across reruns and
    across pipelined/sequential modes (resume byte-identity must not
    depend on when a run happened), unique within a run."""
    return f"{index:05d}/{epoch_id}"


def _run_sequential(epochs, process, journal, done, tiers, retries,
                    validate, load_fn, timeline, heartbeat=None,
                    journal_extra=None):
    """The strictly sequential oracle: load, process, fsync — one
    epoch at a time on the calling thread (the parity/throughput
    baseline)."""
    rec = _Recorder(journal, None, tiers, heartbeat=heartbeat,
                    journal_extra=journal_extra)
    for epoch_id, payload in epochs:
        rec.tally["n_epochs"] += 1
        if timeline is not None:
            timeline.assign_trace(
                epoch_id, _trace_id(rec.tally["n_epochs"] - 1,
                                    epoch_id))
        key = str(epoch_id)
        if key in done:
            rec.resumed(epoch_id, done[key])
            continue
        try:
            if timeline is not None:
                with timeline.span(epoch_id, "load"):
                    payload = _load_inline(payload, load_fn)
            else:
                payload = _load_inline(payload, load_fn)
        except Exception as e:  # noqa: BLE001 — per-epoch quarantine
            rec.record(_loader_outcome(epoch_id, e))
            continue
        rec.record(_run_one(epoch_id, payload, process, tiers,
                            retries, validate))
    return rec


def _run_pipelined(epochs, process, journal, done, tiers, retries,
                   validate, prefetch, inflight, loader_workers,
                   load_fn, defer_validate, timeline, heartbeat=None,
                   journal_extra=None):
    """The pipelined engine: bounded prefetch loader feeding a
    dispatch-ahead window of un-fenced epochs, results consumed (and
    journaled via the threaded writer) in strict epoch order.

    A ``validate`` hook forces immediate fencing (the window is
    consumed right after each dispatch) unless ``defer_validate``:
    validators may be stateful — closed over the last-dispatched
    tier, a call counter — and deferring them would change what they
    observe relative to the sequential oracle. ``defer_validate=True``
    opts a STATELESS validator (e.g. the device health-bitmask check)
    back into the full dispatch-ahead window."""
    from ..parallel.pipeline import AsyncJournalWriter, PrefetchLoader

    inflight = max(1, int(inflight))
    if validate is not None and not defer_validate:
        inflight = 0
    writer = AsyncJournalWriter(journal, timeline=timeline)
    rec = _Recorder(journal, writer, tiers, heartbeat=heartbeat,
                    journal_extra=journal_extra)
    window = collections.deque()   # (epoch_id, payload, value, report)

    def consume_one():
        epoch_id, payload, value, report = window.popleft()
        if isinstance(value, EpochOutcome):   # already decided
            rec.record(value)
            return
        if timeline is not None:
            with timeline.span(epoch_id, "fence"):
                out = _consume_deferred(epoch_id, payload, value,
                                        report, process, tiers,
                                        retries, validate)
        else:
            out = _consume_deferred(epoch_id, payload, value, report,
                                    process, tiers, retries, validate)
        rec.record(out)

    loader = PrefetchLoader(
        ((eid, p) for eid, p in epochs if str(eid) not in done),
        depth=prefetch, workers=loader_workers, load_fn=load_fn,
        timeline=timeline)
    try:
        with loader:
            loaded = iter(loader)
            for epoch_id, payload in epochs:
                rec.tally["n_epochs"] += 1
                if timeline is not None:
                    timeline.assign_trace(
                        epoch_id, _trace_id(rec.tally["n_epochs"] - 1,
                                            epoch_id))
                key = str(epoch_id)
                if key in done:
                    # strict order: everything dispatched before this
                    # resumed epoch is consumed first, so outcome and
                    # journal order match the sequential oracle
                    while window:
                        consume_one()
                    rec.resumed(epoch_id, done[key])
                    continue
                eid, item = next(loaded)
                assert str(eid) == key, (eid, epoch_id)
                if not item.ok:
                    window.append((epoch_id, None,
                                   _loader_outcome(epoch_id,
                                                   item.error), None))
                else:
                    if timeline is not None:
                        with timeline.span(epoch_id, "dispatch"):
                            entry = _dispatch_first(
                                epoch_id, item.payload, process,
                                tiers, retries, validate)
                    else:
                        entry = _dispatch_first(
                            epoch_id, item.payload, process, tiers,
                            retries, validate)
                    window.append(entry)
                while len(window) > inflight:
                    consume_one()
            while window:
                consume_one()
    finally:
        # durability barrier: every journal line fsynced before the
        # summary is trusted (the resume guarantee)
        writer.close()
    return rec


def _dispatch_first(epoch_id, payload, process, tiers, retries,
                    validate):
    """Dispatch the FIRST tier without fencing: on success the raw
    (possibly still in-flight) value enters the window; validation
    and host conversion wait for consumption. Tier-0 exhaustion falls
    through the remaining tiers synchronously with the attempt trail
    carried over (ladder semantics identical to the sequential
    path)."""
    report = _ladder.LadderReport()
    try:
        value, report = _ladder.run_ladder(
            [(tiers[0], lambda: process(payload, tier=tiers[0]))],
            epoch=epoch_id, stage="process", retries=retries,
            report=report)
        return (epoch_id, payload, value, report)
    except _ladder.LadderError as exc:
        if exc.fatal or len(tiers) == 1:
            return (epoch_id, None,
                    _quarantined_outcome(epoch_id, exc), None)
        out = _run_one(epoch_id, payload, process, tiers[1:], retries,
                       validate, report=report)
        return (epoch_id, None, out, None)


def _consume_deferred(epoch_id, payload, value, report, process,
                      tiers, retries, validate):
    """Fence + validate a deferred tier-0 result; a validator
    rejection descends the remaining tiers exactly as the sequential
    ladder would (same attempt records, same retry counts)."""
    from ..parallel.pipeline import finalize_result

    try:
        result = finalize_result(value)
        if validate is not None and not validate(result):
            raise ValueError(
                f"validator rejected tier {tiers[0]} result for "
                f"epoch {epoch_id!r}")
    except Exception as exc:  # noqa: BLE001 — a fence/validate
        # failure is one failed attempt on tier 0 (with its usual
        # slog robust.fallback record, emitted by _record); the
        # remaining tiers run synchronously with the trail carried.
        # A device fault shows here, at the fence: it propagates.
        if is_kernel_error(exc):
            raise
        _ladder._record(report, epoch_id, "process", tiers[0], exc, 0)
        if len(tiers) == 1:
            return _quarantined_outcome(epoch_id, _ladder.LadderError(
                epoch_id, "process", report.attempts))
        return _run_one(epoch_id, payload, process, tiers[1:],
                        retries, validate, report=report)
    return EpochOutcome(epoch=epoch_id, status="ok", tier=report.tier,
                        retries=report.retries, result=dict(result))


def default_lane_validate(result):
    """The batched entries' default per-lane screen: a lane is
    healthy when its device health bitmask (``"ok"`` — the
    fused-program / batched-LM guards code) is 0 or absent."""
    return int(result.get("ok", 0) or 0) == 0


def run_group(group, process_batch, process, tiers, retries,
              validate, record, epoch_label, span_key=None,
              timeline=None):
    """Dispatch ONE group of ``(epoch_id, loaded_payload)`` pairs as
    a single batched device call — the per-group engine of
    :func:`run_survey_batched` (and of a streaming lane assembler).
    Semantics are the batch entry's, verbatim:

    - the batch attempt runs ``process_batch(payloads, tier=tiers[0])``
      through the ladder's bounded transient retries; a whole-batch
      failure sends every lane down the per-epoch ladder (``process``;
      quarantined outright when ``process`` is None);
    - per-lane screening: a lane whose ``validate(result)`` is false
      (guards health bitmask, by default) is retried INDIVIDUALLY
      through the remaining tiers — one poisoned epoch never takes
      its batch down;
    - ``record(epoch_id, EpochOutcome)`` is called exactly once per
      lane, in group order for the healthy path;
    - a kernel error or device fault propagates: no lane descends on
      it.

    ``epoch_label`` names the group in ladder/slog records (e.g.
    ``batch[0:32]``); ``span_key`` + ``timeline`` wrap the batch
    attempt in a ``compute`` stage span."""
    from ..parallel.pipeline import finalize_result

    rest_tiers = tuple(tiers[1:])
    try:
        if timeline is not None and span_key is not None:
            with timeline.span(span_key, "compute"):
                value, report = _ladder.run_ladder(
                    [(tiers[0], lambda: process_batch(
                        [p for _, p in group], tier=tiers[0]))],
                    epoch=epoch_label, stage="process_batch",
                    retries=retries)
        else:
            value, report = _ladder.run_ladder(
                [(tiers[0], lambda: process_batch(
                    [p for _, p in group], tier=tiers[0]))],
                epoch=epoch_label, stage="process_batch",
                retries=retries)
        batch_results = [finalize_result(r) for r in value]
        if len(batch_results) != len(group):
            raise ValueError(
                f"process_batch returned {len(batch_results)} "
                f"results for {len(group)} epochs")
    except (_ladder.LadderError, ValueError) as exc:
        slog.log_failure("robust.batch_fallback", epoch=epoch_label,
                         stage="process_batch", error=exc,
                         tier=tiers[0], retry=0)
        # whole-batch failure: every lane takes the per-epoch ladder
        # (quarantine isolation unchanged)
        for epoch_id, payload in group:
            if process is None:
                record(epoch_id, EpochOutcome(
                    epoch=epoch_id, status="quarantined",
                    tier=tiers[0], error=str(exc),
                    error_class=type(exc).__name__))
            else:
                record(epoch_id, _run_one(epoch_id, payload, process,
                                          tiers, retries, None))
        return
    for (epoch_id, payload), result in zip(group, batch_results):
        if validate(result):
            record(epoch_id, EpochOutcome(
                epoch=epoch_id, status="ok", tier=tiers[0],
                result=dict(result)))
            continue
        slog.log_failure(
            "robust.lane_reject", epoch=epoch_id,
            stage="process_batch", tier=tiers[0],
            error=ValueError(
                f"lane health rejected (ok="
                f"{result.get('ok', 'validator')!r})"),
            retry=0)
        if process is None or not rest_tiers:
            record(epoch_id, EpochOutcome(
                epoch=epoch_id, status="quarantined", tier=tiers[0],
                error="lane health rejected",
                error_class="LaneRejected"))
        else:
            record(epoch_id, _run_one(epoch_id, payload, process,
                                      rest_tiers, retries, None))


def run_survey_batched(epochs, process_batch, workdir, process=None,
                       batch_size=32, tiers=_DEFAULT_TIERS, retries=1,
                       validate=None, journal_name="journal.jsonl",
                       resume=True, pipeline=True, prefetch=4,
                       loader_workers=2, load_fn=None, timeline=None,
                       heartbeat=None, report=True,
                       journal_extra=None, device=None):
    """Batched counterpart of :func:`run_survey` for device programs
    that fit a whole epoch stack at once (e.g.
    ``fit/acf2d.py:fit_acf2d_batch`` — one upload, one device call for
    N epochs).

    Pending (non-journaled) epochs are grouped into stacks of
    ``batch_size`` and dispatched as ``process_batch(payloads,
    tier=<tiers[0]>) -> list of per-epoch result dicts`` (one dict per
    payload, in order). The batch attempt runs through the ladder's
    bounded transient retries; if the whole batch fails, every lane
    falls back to the per-epoch path. Per-lane screening uses the
    device health flags: a lane is accepted when ``validate(result)``
    is true (default: its ``"ok"`` bitmask — the fused-program /
    batched-LM health code — is 0/absent). Rejected lanes are retried
    INDIVIDUALLY through the remaining tiers via ``process(payload,
    tier=...)`` (:func:`run_survey` semantics) when ``process`` is
    given, else quarantined — so one poisoned epoch never takes its
    batch down, and a healthy batch costs one device program instead
    of N.

    With ``pipeline=True`` (default) callable payloads load in a
    bounded background prefetch queue (``prefetch`` deep,
    ``loader_workers`` threads; loader failures quarantine that epoch
    only) and journal fsyncs run on the threaded writer, which DRAINS
    at every batch boundary — the SIGKILL-resume guarantee is
    unchanged. ``pipeline=False`` is the sequential oracle.

    Journal format, resume semantics, observability wiring
    (``heartbeat``/``report``/metrics — see :func:`run_survey`), the
    ``journal_extra`` attribution hook (see :func:`run_survey`), and
    the return
    structure are shared with :func:`run_survey` (same ``workdir``
    journal resumes either entry); the summary additionally counts
    ``n_batches``. ``device`` as in :func:`run_survey`.
    """
    from ..parallel.pipeline import AsyncJournalWriter, PrefetchLoader

    resolve_device(device)

    os.makedirs(workdir, exist_ok=True)
    journal = EpochJournal(os.path.join(workdir, journal_name))
    done = journal.records() if resume else {}

    if validate is None:
        validate = default_lane_validate

    writer = AsyncJournalWriter(journal, timeline=timeline) \
        if pipeline else None
    rec = _Recorder(journal, writer, tiers, heartbeat=None,
                    journal_extra=journal_extra)
    rec.tally["n_batches"] = 0
    outcomes_by_key = {}

    def _record(epoch_id, out):
        # the ordered outcome view is rebuilt from this map at return
        # (lane rejects complete out of epoch order)
        outcomes_by_key[str(epoch_id)] = out
        rec.record(out)

    epochs = list(epochs)
    rec.heartbeat = _hb.as_heartbeat(heartbeat, total=len(epochs))
    pending = []
    t_run0 = time.perf_counter()
    try:
        with slog.span("survey.robust_run_batched",
                       n_epochs=len(epochs), batch_size=batch_size,
                       workdir=os.fspath(workdir),
                       pipeline=bool(pipeline)):
            loader = None
            scan = iter(epochs)
            if pipeline:
                loader = PrefetchLoader(
                    ((eid, p) for eid, p in epochs
                     if str(eid) not in done),
                    depth=prefetch, workers=loader_workers,
                    load_fn=load_fn, timeline=timeline)
                loaded = iter(loader)
            for epoch_id, payload in scan:
                rec.tally["n_epochs"] += 1
                if timeline is not None:
                    timeline.assign_trace(
                        epoch_id,
                        _trace_id(rec.tally["n_epochs"] - 1,
                                  epoch_id))
                key = str(epoch_id)
                if key in done:
                    outcomes_by_key[key] = rec.resumed(epoch_id,
                                                       done[key])
                    continue
                if pipeline:
                    eid, item = next(loaded)
                    assert str(eid) == key, (eid, epoch_id)
                    if not item.ok:
                        _record(epoch_id,
                                _loader_outcome(epoch_id, item.error))
                        continue
                    payload = item.payload
                else:
                    try:
                        payload = _load_inline(payload, load_fn)
                    except Exception as e:  # noqa: BLE001 — per-epoch
                        _record(epoch_id, _loader_outcome(epoch_id, e))
                        continue
                pending.append((epoch_id, payload))
            if loader is not None:
                loader.close()

            for i in range(0, len(pending), batch_size):
                group = pending[i:i + batch_size]
                rec.tally["n_batches"] += 1
                run_group(group, process_batch, process, tiers,
                          retries, validate, _record,
                          epoch_label=f"batch[{i}:{i + len(group)}]",
                          span_key=f"batch[{i}]", timeline=timeline)
                if writer is not None:
                    # batch-boundary durability barrier (at most the
                    # in-flight batch is redone after a SIGKILL)
                    writer.drain()
            slog.log_event("survey.robust_batched_summary", **{
                k: v for k, v in rec.tally.items()
                if k != "tier_counts"},
                tier_counts=dict(rec.tally["tier_counts"]))
    finally:
        if writer is not None:
            writer.close()
    wall_s = time.perf_counter() - t_run0
    rec.beat(force=True)
    tl_summary = _finish_timeline(timeline)
    ordered = [outcomes_by_key[str(e)] for e, _ in epochs]
    if report:
        _report.write_run_report(workdir, _report.build_run_report(
            rec.tally, ordered, wall_s=wall_s, timeline=tl_summary,
            runner="run_survey_batched"))
    return {"results": rec.results, "outcomes": ordered,
            "summary": rec.tally}


def _quarantined_outcome(epoch_id, exc):
    """Quarantine outcome from an exhausted ladder, with the slog
    record :func:`_run_one` has always emitted."""
    slog.log_failure("robust.quarantine", epoch=epoch_id,
                     stage="process", error=exc,
                     tier=exc.attempts[-1]["tier"]
                     if exc.attempts else None,
                     retry=len(exc.attempts))
    last = exc.attempts[-1] if exc.attempts else {}
    # a malformed input shows up as the same error on every tier;
    # collapse the trail to the first record's class
    return EpochOutcome(
        epoch=epoch_id, status="quarantined",
        retries=len(exc.attempts),
        error=last.get("error", str(exc)),
        error_class=last.get("error_class", "LadderError"))


def _run_one(epoch_id, payload, process, tiers, retries, validate,
             report=None):
    """Dispatch one epoch through the ladder; never raises, but for a
    kernel error or device fault, which propagates. A seeded
    ``report`` carries earlier attempts (the pipelined path's
    deferred tier-0 failure) into the retry count and quarantine
    trail."""

    from ..parallel.pipeline import finalize_result

    def tier_fn(name):
        def run():
            # fenced at once: the sequential path journals host values
            # exactly as the pipelined path does after its fence
            result = finalize_result(process(payload, tier=name))
            if validate is not None and not validate(result):
                raise ValueError(
                    f"validator rejected tier {name} result for "
                    f"epoch {epoch_id!r}")
            return result

        return run

    try:
        value, report = _ladder.run_ladder(
            [(t, tier_fn(t)) for t in tiers], epoch=epoch_id,
            stage="process", retries=retries, report=report)
    except _ladder.LadderError as exc:
        return _quarantined_outcome(epoch_id, exc)
    return EpochOutcome(epoch=epoch_id, status="ok", tier=report.tier,
                        retries=report.retries, result=dict(value))


def outcome_dicts(outcomes):
    """JSON-able view of a list of :class:`EpochOutcome` (for result
    files / bench records)."""
    return [asdict(o) for o in outcomes]
