"""Chrome-trace (Perfetto-loadable) export of survey stage spans.

The port's own copy of ``scintools_tpu/obs/trace.py``.
``StageTimeline`` (utils/profiling.py) records ``(stage, epoch, t0,
t1)`` wall-clock spans from the prefetch loader threads, the dispatch
loop, the fence points, and the journal writer thread. This module
turns that span list into the Chrome Trace Event JSON format — the
``{"traceEvents": [...]}`` array of ``"ph": "X"`` complete events —
which loads directly in ``chrome://tracing`` and Perfetto.

Layout conventions (the JAX package's, so one validator reads both):

- one process (``pid`` = the recording process), one *track* (tid)
  per stage, with ``"M"`` (metadata) ``process_name``/``thread_name``
  events emitted first;
- ``ts``/``dur`` are microseconds relative to the earliest span, and
  the ``"X"`` events are sorted by ``ts``;
- each event's ``args`` carries the epoch id and its per-epoch
  ``trace_id``, so every row of one epoch's lifecycle is searchable
  by one string in the trace viewer.
"""

from __future__ import annotations

import json
import os


def chrome_trace_events(spans, trace_ids=None, pid=None,
                        process_name="scintools_tpu_torch survey"):
    """Build the Chrome-trace event list from ``(stage, epoch, t0,
    t1)`` spans (absolute ``perf_counter`` seconds). ``trace_ids``
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
