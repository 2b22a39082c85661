"""Chrome-trace (Perfetto-loadable) export of survey stage spans, and
the program's own spans on the profiler's clock.

The port's own copy of ``scintools_tpu/obs/trace.py``.
``StageTimeline`` (utils/profiling.py) records ``(stage, epoch, t0,
t1)`` wall-clock spans (seconds of ``time.time_ns()``) from the
prefetch loader threads, the dispatch loop, the fence points, and the
journal writer thread. This module turns that span list into the
Chrome Trace Event JSON format — the ``{"traceEvents": [...]}`` array
of ``"ph": "X"`` complete events — which loads directly in
``chrome://tracing`` and Perfetto.

Layout conventions (the JAX package's, so one validator reads both):

- one process (``pid`` = the recording process), one *track* (tid)
  per stage, with ``"M"`` (metadata) ``process_name``/``thread_name``
  events emitted first;
- ``ts``/``dur`` are microseconds relative to the earliest span, and
  the ``"X"`` events are sorted by ``ts``;
- each event's ``args`` carries the epoch id and its per-epoch
  ``trace_id``, so every row of one epoch's lifecycle is searchable
  by one string in the trace viewer.

Program spans (the port's own, :func:`span`): the host stages of the
hot path (``dynspec.*``, ``sspec.*``, ``thth.*``) each leave a
:class:`SpanRecord` (name, id, parent id, observation id, start and
end in ns of ``time.time_ns()``, the clock ``torch.profiler`` stamps
host events with, and attributes) in a bounded process-wide ring while
a torch profiler runs, and only then; :func:`program_spans` reads the
ring over an interval of that clock, and
:func:`program_trace_events` lays it out as a track of a profiler's
Chrome trace. A span never opens a ``record_function``: the profiler
mirrors those onto the device's timeline, where a reader of the trace
would count them as device work.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler


def chrome_trace_events(spans, trace_ids=None, pid=None,
                        process_name="scintools_tpu_torch survey"):
    """Build the Chrome-trace event list from ``(stage, epoch, t0,
    t1)`` spans (absolute seconds). ``trace_ids``
    optionally maps epoch id → trace-id string. Returns a list of
    event dicts: metadata events first, then the ``"X"`` spans sorted
    by ``ts``."""
    spans = list(spans)
    if pid is None:
        pid = os.getpid()
    stages = sorted({s for s, _, _, _ in spans})
    tids = {stage: i + 1 for i, stage in enumerate(stages)}
    events = [{"name": "process_name", "ph": "M", "pid": pid,
               "tid": 0, "args": {"name": process_name}}]
    for stage in stages:
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tids[stage], "args": {"name": stage}})
    if not spans:
        return events
    t_base = min(t0 for _, _, t0, _ in spans)
    xs = []
    for stage, epoch, t0, t1 in spans:
        args = {"epoch": str(epoch)}
        if trace_ids:
            tid_str = trace_ids.get(epoch, trace_ids.get(str(epoch)))
            if tid_str is not None:
                args["trace_id"] = str(tid_str)
        xs.append({
            "name": stage, "cat": "survey", "ph": "X",
            "ts": round((t0 - t_base) * 1e6, 3),
            "dur": round(max(0.0, t1 - t0) * 1e6, 3),
            "pid": pid, "tid": tids[stage], "args": args})
    xs.sort(key=lambda e: (e["ts"], e["tid"]))
    return events + xs


def write_chrome_trace(path, spans, trace_ids=None, pid=None,
                       process_name="scintools_tpu_torch survey"):
    """Write ``spans`` as a Chrome-trace JSON object file
    (``{"traceEvents": [...], "displayTimeUnit": "ms"}``) and return
    ``path``. The file loads as-is in chrome://tracing / Perfetto."""
    doc = {"traceEvents": chrome_trace_events(
        spans, trace_ids=trace_ids, pid=pid,
        process_name=process_name),
        "displayTimeUnit": "ms"}
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return os.fspath(path)


# ---------------------------------------------------------------------
# cross-process trace merge — multi-worker runs spool span
# fragments next to their journals; the pod merges them into ONE
# Chrome/Perfetto document for the whole run.
# ---------------------------------------------------------------------
# Fragment format (`<out>/workers/<id>/trace.jsonl`, append-only, one
# JSON object per line, torn tails tolerated):
#
#   {"worker": id, "stage": s, "epoch": e, "t0": unix_s, "t1": unix_s}
#   {"worker": id, "epoch": e, "trace_id": tid}          (id-map line)
#
# Times are WALL-clock seconds (perf_counter spans shifted by a
# once-sampled per-process anchor) so fragments from different
# processes share one timeline. Trace-id assignment travels as its
# own line because a span can be recorded (and flushed) by a loader
# thread before the dispatch loop assigns the epoch's ID — the merge
# resolves IDs last, so late binding is invisible.


def load_trace_fragments(paths):
    """Read per-worker ``.trace.jsonl`` span spools.

    ``paths`` maps worker id → fragment path. Returns
    ``{worker: {"spans": [(stage, epoch, t0, t1)], "trace_ids":
    {epoch: id}}}`` with unparseable lines (a SIGKILLed worker's torn
    tail) skipped — trace data is diagnostics, a lost tail span must
    not fail the merge. Missing files yield no entry."""
    out = {}
    for worker, path in sorted(dict(paths).items()):
        spans, ids = [], {}
        try:
            with open(os.fspath(path)) as fh:
                lines = fh.read().splitlines()
        except OSError:
            continue
        for raw in lines:
            raw = raw.strip()
            if not raw:
                continue
            try:
                rec = json.loads(raw)
            except ValueError:
                continue                   # torn tail line
            if not isinstance(rec, dict):
                continue
            if "trace_id" in rec and "t0" not in rec:
                if rec.get("epoch") is not None:
                    ids[str(rec["epoch"])] = str(rec["trace_id"])
                continue
            try:
                spans.append((str(rec["stage"]), str(rec["epoch"]),
                              float(rec["t0"]), float(rec["t1"])))
            except (KeyError, TypeError, ValueError):
                continue
        out[str(worker)] = {"spans": spans, "trace_ids": ids}
    return out


def merge_traces(fragments, run_name="scintools_tpu_torch fleet"):
    """Deterministically merge per-worker span fragments into ONE
    Chrome-trace document: one *process* (pid) per worker, one named
    track per stage per worker (stage → tid is a GLOBAL table, so the
    same stage sits on the same row of every worker's group), every
    span's ``args`` carrying its epoch and trace ID.

    Trace IDs are stable across steal/resume (the runner derives them
    from the epoch's position within its task), so a stolen epoch's
    spans — journaled by the dead holder before the SIGKILL, re-run
    by the stealer — land on ONE searchable ID across two worker
    tracks: the steal is visible as a track handoff. Exact duplicate
    spans within one worker (a re-exported tail after a crash-restart
    under the same id) are dropped; cross-worker duplicates are the
    signal and are kept.

    ``fragments`` is the :func:`load_trace_fragments` shape. Returns
    the trace document (validate with
    :func:`validate_chrome_trace`)."""
    workers = sorted(fragments)
    stages = sorted({s for w in workers
                     for s, _, _, _ in fragments[w]["spans"]})
    tids = {stage: i + 1 for i, stage in enumerate(stages)}
    pids = {w: i + 1 for i, w in enumerate(workers)}
    events = []
    xs = []
    t_base = min((t0 for w in workers
                  for _, _, t0, _ in fragments[w]["spans"]),
                 default=0.0)
    for w in workers:
        frag = fragments[w]
        pid = pids[w]
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0,
                       "args": {"name": f"{run_name} worker {w}"}})
        used = sorted({s for s, _, _, _ in frag["spans"]})
        for stage in used:
            events.append({"name": "thread_name", "ph": "M",
                           "pid": pid, "tid": tids[stage],
                           "args": {"name": stage}})
        ids = frag["trace_ids"]
        seen = set()
        for stage, epoch, t0, t1 in frag["spans"]:
            key = (stage, epoch, round(t0, 6), round(t1, 6))
            if key in seen:
                continue                  # re-exported duplicate
            seen.add(key)
            args = {"epoch": epoch, "worker": w}
            tid_str = ids.get(epoch)
            if tid_str is not None:
                args["trace_id"] = tid_str
            xs.append({
                "name": stage, "cat": "fleet", "ph": "X",
                "ts": round((t0 - t_base) * 1e6, 3),
                "dur": round(max(0.0, t1 - t0) * 1e6, 3),
                "pid": pid, "tid": tids[stage], "args": args})
    xs.sort(key=lambda e: (e["ts"], e["pid"], e["tid"]))
    return {"traceEvents": events + xs, "displayTimeUnit": "ms"}


def write_merged_trace(path, fragments,
                       run_name="scintools_tpu_torch fleet"):
    """Merge (+ validate) per-worker fragments and write the one pod
    Chrome-trace JSON at ``path``; returns ``(path, stats)`` where
    stats counts workers/stages/events."""
    doc = merge_traces(fragments, run_name=run_name)
    validate_chrome_trace(doc)
    with open(os.fspath(path), "w") as fh:
        json.dump(doc, fh)
    n_x = sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
    stats = {"workers": len(fragments), "events": n_x,
             "stages": len({e["name"] for e in doc["traceEvents"]
                            if e.get("ph") == "X"})}
    return os.fspath(path), stats


def validate_chrome_trace(doc):
    """Structural check of a Chrome-trace document: ``traceEvents`` present; every ``"X"``
    event carries name/ts/dur/pid/tid with ``ts`` sorted and
    non-negative ``dur``; every (pid, tid) used by an ``"X"`` event
    has a matching ``thread_name`` metadata event. Raises
    :class:`ValueError` on the first problem; returns the event
    list."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a Chrome-trace object "
                         "(missing traceEvents)")
    events = doc["traceEvents"]
    named = set()
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            named.add((e["pid"], e["tid"]))
    last_ts = None
    for e in events:
        if e.get("ph") != "X":
            continue
        for k in ("name", "ts", "dur", "pid", "tid"):
            if k not in e:
                raise ValueError(f"X event missing {k!r}: {e}")
        if e["dur"] < 0 or e["ts"] < 0:
            raise ValueError(f"negative ts/dur: {e}")
        if (e["pid"], e["tid"]) not in named:
            raise ValueError(
                f"X event on unnamed track pid={e['pid']} "
                f"tid={e['tid']}")
        if last_ts is not None and e["ts"] < last_ts:
            raise ValueError("X events not sorted by ts")
        last_ts = e["ts"]
    return events


# ---------------------------------------------------------------------
# program spans — the host stages of the hot path, recorded while a
# torch profiler runs, on its clock
# ---------------------------------------------------------------------

RING = collections.deque(maxlen=1 << 16)
_SPAN_IDS = itertools.count(1)
_OBSERVATIONS = itertools.count(1)
# (span id, observation id) of the innermost open span of this context
_OPEN = contextvars.ContextVar("scintools_tpu_torch_open_span",
                               default=None)
_OFF = contextlib.nullcontext()
_now = time.time_ns


class SpanRecord:
    """One finished program span (or, named ``build``, an instant: a
    cache miss of a built-function factory, its ``site`` an
    attribute). ``start_ns``/``end_ns`` are ``time.time_ns()``;
    ``parent`` is the enclosing span's ``span_id`` (None at the root);
    ``observation`` the id of the ``Dynspec`` the work belongs to.
    :attr:`device_ms` is the span's time on the device, read from its
    CUDA events when asked (None without them)."""

    __slots__ = ("name", "span_id", "parent", "observation", "start_ns",
                 "end_ns", "attrs", "events")

    def __init__(self, name, span_id, parent, observation, start_ns,
                 end_ns=None, attrs=None, events=None):
        self.name, self.span_id, self.parent = name, span_id, parent
        self.observation = observation
        self.start_ns, self.end_ns = start_ns, end_ns
        self.attrs = attrs or {}
        self.events = events

    @property
    def device_ms(self):
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return float(start.elapsed_time(end))


def new_observation():
    """A fresh observation id (a process-wide count from 1)."""
    return next(_OBSERVATIONS)


class _Span:
    __slots__ = ("record", "device", "token")

    def __init__(self, name, observation, device, attrs):
        self.record = SpanRecord(name, None, None, observation, None,
                                 attrs=attrs)
        self.device = device

    def __enter__(self):
        rec = self.record
        outer = _OPEN.get()
        rec.span_id = next(_SPAN_IDS)
        if outer is not None:
            rec.parent = outer[0]
            if rec.observation is None:
                rec.observation = outer[1]
        self.token = _OPEN.set((rec.span_id, rec.observation))
        if self.device is not None and torch.device(
                self.device).type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(stream)
        rec.start_ns = _now()
        return rec

    def __exit__(self, *exc):
        rec = self.record
        rec.end_ns = _now()
        if rec.events is not None:
            rec.events[1].record(torch.cuda.current_stream(self.device))
        _OPEN.reset(self.token)
        RING.append(rec)
        return False


def span(name, observation=None, device=None, **attrs):
    """Context manager of the program span ``name`` with attributes
    ``attrs``: while a torch profiler runs it leaves a
    :class:`SpanRecord` in :data:`RING` when it closes; otherwise it
    is one check and records nothing. ``observation`` (default: the
    enclosing span's) is the observation id. ``device``, the device
    the span's tensors are on, also times the span on the device with
    a pair of CUDA events on its current stream when it is a CUDA
    device (read lazily as :attr:`SpanRecord.device_ms`)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, observation, device, attrs)


def instant(name, **attrs):
    """An instant record ``name`` (start = end) under the open span,
    while a torch profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    outer = _OPEN.get()
    t = _now()
    RING.append(SpanRecord(name, next(_SPAN_IDS),
                           outer[0] if outer else None,
                           outer[1] if outer else None, t, t, attrs))


def program_spans(lo_ns=None, hi_ns=None):
    """The records of :data:`RING` that overlap [``lo_ns``, ``hi_ns``]
    (ns of ``time.time_ns()``; None: unbounded), oldest first."""
    lo = -1 if lo_ns is None else lo_ns
    hi = float("inf") if hi_ns is None else hi_ns
    return [r for r in list(RING) if r.end_ns >= lo and r.start_ns <= hi]


def program_trace_events(records, base_ns, pid="scintools program"):
    """``records`` as Chrome-trace events on a track of their own
    (``pid``, one ``tid`` per observation), ``ts`` in µs from
    ``base_ns`` (a profiler trace's ``baseTimeNanoseconds``): the
    spans as ``"X"`` events, builds as ``"i"`` instants, each with its
    ids and attributes in ``args``."""
    tids = sorted({r.observation or 0 for r in records})
    events = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
               "args": {"name": "scintools_tpu_torch program spans"}}]
    events += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": t,
                "args": {"name": f"observation {t}" if t
                         else "no observation"}} for t in tids]
    for r in records:
        args = {"span_id": r.span_id, "parent": r.parent,
                **{k: v if isinstance(v, (int, float, str, bool))
                   else repr(v) for k, v in r.attrs.items()}}
        ev = {"name": r.name, "cat": "program", "pid": pid,
              "tid": r.observation or 0,
              "ts": round((r.start_ns - base_ns) / 1e3, 3), "args": args}
        if r.end_ns == r.start_ns:
            ev.update(ph="i", s="t")
        else:
            ev.update(ph="X", dur=round((r.end_ns - r.start_ns) / 1e3, 3))
        events.append(ev)
    return events
