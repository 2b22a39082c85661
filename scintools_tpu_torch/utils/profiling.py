"""Profiling/tracing harness of the port.

The port's own copy of ``scintools_tpu/utils/profiling.py``:

- :class:`Timer` — device-aware wall-clock sections that accumulate
  into a table. CUDA launches are asynchronous, so every section
  entry and exit fences with ``torch.cuda.synchronize()`` (where the
  JAX package blocks until ready) before reading the clock;
- :func:`clock` — the timelines' clock: seconds of ``time.time_ns()``,
  the clock ``torch.profiler`` stamps host events with;
- :class:`StageTimeline` — per-epoch stage spans with overlap
  accounting for the pipelined survey runner;
- :func:`trace` — context manager around ``torch.profiler`` that
  writes a Chrome trace of the card's kernels, the host's ops and the
  program's own spans (``obs.trace.span``);
- :func:`timeit_fn` — best-of-N timing of a callable with a separate
  (reported) first-call time.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np
import torch


def _device_fence():
    """Drain the card's queues (``torch.cuda.synchronize()``); no-op
    without a card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _block(x):
    """Fence the card when ``x`` holds a CUDA tensor (a tensor, or a
    dict/list/tuple of them); returns ``x``."""
    if _has_cuda_tensor(x):
        torch.cuda.synchronize()
    return x


def _has_cuda_tensor(x):
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        return any(_has_cuda_tensor(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_has_cuda_tensor(v) for v in x)
    return False


class Timer:
    """Accumulating section timer.

    >>> tm = Timer()
    >>> with tm("sspec"):
    ...     out = jitted_sspec(dyn)      # implicit device sync on exit
    >>> with tm("search"):
    ...     eigs = search(cs)
    >>> print(tm.report())

    CUDA launches are asynchronous, so on entry AND exit the timer
    fences the card (``torch.cuda.synchronize()``); a section may also
    append its result to the yielded box.
    """

    def __init__(self, sync=True):
        self.sync = sync
        self.sections = {}          # name → list of seconds

    @contextmanager
    def __call__(self, name):
        if self.sync:
            _device_fence()
        t0 = time.perf_counter()
        box = []
        try:
            yield box
        finally:
            if self.sync:
                _block(box[-1]) if box else _device_fence()
            self.sections.setdefault(name, []).append(
                time.perf_counter() - t0)

    def add(self, name, seconds):
        self.sections.setdefault(name, []).append(float(seconds))

    def total(self, name):
        return float(np.sum(self.sections.get(name, [])))

    def report(self):
        """Fixed-width table: name, calls, total, mean, best."""
        rows = [f"{'section':<24}{'calls':>6}{'total_s':>10}"
                f"{'mean_s':>10}{'best_s':>10}"]
        for name, vals in self.sections.items():
            v = np.asarray(vals)
            rows.append(f"{name:<24}{len(v):>6}{v.sum():>10.4f}"
                        f"{v.mean():>10.4f}{v.min():>10.4f}")
        return "\n".join(rows)


def clock():
    """Seconds of ``time.time_ns()``: the wall clock that
    ``torch.profiler`` stamps host events with, so spans taken on it
    line up with a device trace, and with spans of other processes."""
    return time.time_ns() / 1e9


def _interval_union(intervals):
    """Total length of the union of ``[(t0, t1), ...]`` intervals."""
    total = 0.0
    end = -np.inf
    for t0, t1 in sorted(intervals):
        if t1 <= end:
            continue
        total += t1 - max(t0, end)
        end = t1
    return total


class StageTimeline:
    """Per-epoch stage-span recorder with overlap accounting — the
    observability half of the pipelined survey engine
    (parallel/pipeline.py + robust/runner.py).

    Each pipeline stage of each epoch records one wall-clock span:

    >>> tl = StageTimeline()
    >>> with tl.span("e0", "load"):
    ...     payload = load(path)          # in a prefetch worker
    >>> with tl.span("e0", "compute"):
    ...     out = program(payload)
    >>> tl.summary()["overlap_frac"]

    Spans may be recorded from any thread (`record` appends under a
    lock); the clock is :func:`clock` (seconds of ``time.time_ns()``),
    so spans from the loader threads, the main dispatch loop, and the
    journal writer share one timeline, which is also the timeline of a
    ``torch.profiler`` trace and of other processes' timelines.

    :meth:`summary` reports:

    - ``wall_s`` — last span end − first span start;
    - ``stage_busy_s`` — per-stage union of that stage's intervals
      (concurrent loads of two epochs count once where they overlap);
    - ``busy_s`` — union of ALL spans (time at least one stage was
      active);
    - ``overlap_frac`` — ``1 − busy_s / Σ stage_busy_s``: 0 for a
      strictly sequential run (stages never coincide), → 0.5 when two
      stages are perfectly hidden behind each other, higher with more
      stages overlapped;
    - ``device_idle_s`` — wall time NOT covered by a
      ``device_stage`` span (default ``"compute"``): what an
      accelerator would have wasted waiting on the host.

    ``log_summary()`` emits the summary as one structured slog event
    (utils/slog.py) so a survey run's pipeline efficiency is
    greppable next to its quarantine/fallback records, and
    ``export_trace(path)`` writes the raw spans as Chrome-trace JSON
    (obs/trace.py) for chrome://tracing / Perfetto, one named track
    per stage, each span tagged with its epoch's trace ID
    (:meth:`assign_trace` — the runner assigns deterministic per-epoch
    IDs and threads them through loader/dispatch/fence/journal spans).
    """

    def __init__(self, device_stage="compute"):
        import threading

        self.device_stage = device_stage
        self._spans = []                # (stage, epoch, t0, t1)
        self._trace_ids = {}            # epoch -> trace-id string
        self._lock = threading.Lock()

    def record(self, epoch, stage, t0, t1):
        """Record one finished span (absolute :func:`clock` times)."""
        with self._lock:
            self._spans.append((str(stage), epoch, float(t0),
                                float(t1)))

    def assign_trace(self, epoch, trace_id):
        """Bind ``epoch`` to a trace-id string: every span of that
        epoch (whichever thread recorded it) carries the ID in the
        exported trace."""
        with self._lock:
            self._trace_ids[epoch] = str(trace_id)

    def trace_ids(self):
        with self._lock:
            return dict(self._trace_ids)

    def spans(self):
        """Snapshot of the recorded ``(stage, epoch, t0, t1)`` spans."""
        with self._lock:
            return list(self._spans)

    def export_trace(self, path):
        """Write the recorded spans as a Chrome-trace JSON file
        (loads in chrome://tracing and ui.perfetto.dev); returns the
        path. See obs/trace.py for the format conventions."""
        from ..obs.trace import write_chrome_trace

        return write_chrome_trace(path, self.spans(),
                                  trace_ids=self.trace_ids())

    @contextmanager
    def span(self, epoch, stage):
        t0 = clock()
        try:
            yield
        finally:
            self.record(epoch, stage, t0, clock())

    def stages(self):
        return sorted({s for s, _, _, _ in self._spans})

    def summary(self):
        if not self._spans:
            return {"n_spans": 0, "n_epochs": 0, "wall_s": 0.0,
                    "busy_s": 0.0, "overlap_frac": 0.0,
                    "device_idle_s": 0.0, "stage_busy_s": {}}
        spans = list(self._spans)
        t_start = min(t0 for _, _, t0, _ in spans)
        t_end = max(t1 for _, _, _, t1 in spans)
        wall = t_end - t_start
        by_stage = {}
        for stage, _, t0, t1 in spans:
            by_stage.setdefault(stage, []).append((t0, t1))
        stage_busy = {s: _interval_union(v)
                      for s, v in by_stage.items()}
        busy = _interval_union([(t0, t1) for _, _, t0, t1 in spans])
        total = sum(stage_busy.values())
        device_busy = _interval_union(
            by_stage.get(self.device_stage, []))
        return {
            "n_spans": len(spans),
            "n_epochs": len({e for _, e, _, _ in spans}),
            "wall_s": round(wall, 4),
            "busy_s": round(busy, 4),
            "stage_busy_s": {s: round(v, 4)
                             for s, v in sorted(stage_busy.items())},
            "overlap_frac": round(1.0 - busy / total, 4)
            if total > 0 else 0.0,
            "device_idle_s": round(max(0.0, wall - device_busy), 4),
        }

    def log_summary(self, event="survey.pipeline_timeline", **extra):
        """Emit :meth:`summary` as one structured slog event; returns
        the summary dict."""
        from . import slog

        out = self.summary()
        slog.log_event(event, **out, **extra)
        return out

    def report(self):
        """Fixed-width per-stage table (cf. :class:`Timer.report`)."""
        s = self.summary()
        rows = [f"{'stage':<12}{'busy_s':>10}",
                *(f"{name:<12}{busy:>10.4f}"
                  for name, busy in s["stage_busy_s"].items()),
                f"{'wall':<12}{s['wall_s']:>10.4f}",
                f"overlap_frac {s['overlap_frac']:.3f}  "
                f"device_idle_s {s['device_idle_s']:.4f}"]
        return "\n".join(rows)


@contextmanager
def trace(trace_dir):
    """``torch.profiler`` trace context: the host's ops and, with a
    card, its kernels, exported as a Chrome trace
    ``<trace_dir>/trace.json`` (loads in Perfetto), with the program
    spans recorded meanwhile (``obs.trace.span``) on a track of their
    own above the kernels, on the profiler's time base. Yields the
    profiler, whose ``key_averages()`` give per-op device times. The
    traced body's own exceptions propagate untouched."""
    import json
    import os

    from torch.profiler import ProfilerActivity, profile

    from ..obs import trace as obs_trace

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(str(trace_dir), exist_ok=True)
    path = os.path.join(str(trace_dir), "trace.json")
    t0 = time.time_ns()
    with profile(activities=acts) as prof:
        yield prof
        _device_fence()
    records = obs_trace.program_spans(t0, time.time_ns())
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    doc["traceEvents"] += obs_trace.program_trace_events(
        records, int(doc.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as fh:
        json.dump(doc, fh)


def timeit_fn(fn, *args, repeats=3, **kwargs):
    """Time a (possibly jitted) callable: returns a dict with the
    first-call (compile+run) time and best-of-``repeats`` steady-state
    wall time, synchronising the device after every call."""
    t0 = time.perf_counter()
    out = _block(fn(*args, **kwargs))
    compile_s = time.perf_counter() - t0
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = _block(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return {"first_call_s": compile_s, "best_s": float(best),
            "repeats": repeats, "result": out}
