"""The traced window: ``torch.profiler`` around whole calls, reduced to
device intervals, the benchmark's own spans and the window's bounds,
all on the profiler's clock.

The benchmark wraps the window in a ``portbench.window`` span and each
call in ``portbench.call`` and in the driver's layer spans
(``record_function``); the idle share is taken over the whole window,
so idle time before the first device activity, after the last one and
between calls counts.
"""

from __future__ import annotations

import sys
import time

import torch

WINDOW = "portbench.window"
CALL = "portbench.call"


class Trace:
    """``device``: ``[(name, start_ns, end_ns)]`` of the device
    activities (kernels, copies, fills); ``spans``: the benchmark's spans
    ``[(name, start_ns, end_ns)]``; ``window``: ``(start_ns, end_ns)``."""

    def __init__(self, device, spans, window):
        self.device = device
        self.spans = spans
        self.window = window

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e9

    def in_window(self):
        lo, hi = self.window
        return [(n, max(a, lo), min(b, hi)) for n, a, b in self.device
                if b > lo and a < hi]

    def busy_s(self):
        lo, hi = self.window
        return busy_ns([(a, b) for _, a, b in self.device], lo, hi) / 1e9

    def span_times(self, name):
        """Durations [s] of the spans called ``name``."""
        return [(b - a) / 1e9 for n, a, b in self.spans if n == name]


def merged(intervals, lo, hi):
    """``intervals`` clipped to [lo, hi] and merged, in order."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals
                       if b > lo and a < hi):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_ns(intervals, lo, hi):
    """Length of the union of ``intervals`` within [lo, hi]."""
    return sum(b - a for a, b in merged(intervals, lo, hi))


def idle_gaps(intervals, lo, hi):
    """The stretches of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for a, b in merged(intervals, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def label_at(spans, t):
    """The innermost benchmark span running on the host at ``t``."""
    best = None
    for name, a, b in spans:
        if a <= t < b and name != WINDOW and (
                best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else "between calls"


def breakdown(trace, top=10):
    """``{"device_ops": [[name, s], ...], "idle_gaps": [[label, s],
    ...]}``: the device operations that took most time in the window
    (a name cut to 200 characters), and the window's idle time summed by
    the benchmark span the host was in when each gap began."""
    ops = {}
    for name, a, b in trace.in_window():
        ops[name] = ops.get(name, 0) + (b - a) / 1e9
    idle = {}
    for a, b in idle_gaps([(a, b) for _, a, b in trace.device],
                          *trace.window):
        lab = label_at(trace.spans, a)
        idle[lab] = idle.get(lab, 0) + (b - a) / 1e9
    return {
        "device_ops": [[n[:200], s] for n, s in sorted(
            ops.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, s] for n, s in sorted(
            idle.items(), key=lambda kv: -kv[1])[:top]],
    }


def _events(prof):
    """``(name, start_ns, end_ns, on_device)`` of every event the
    profiler kept."""
    out = []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            a, d = e.start_ns(), e.duration_ns()
        else:
            a, d = e.start_us() * 1000, e.duration_us() * 1000
        out.append((e.name(), int(a), int(a + d), e.device_type() == cuda))
    return out


def capture(warm, window, spans, tries=3):
    """Trace ``window()`` (whole calls) after one call ``warm()`` that the
    profiler holds as its warm-up step; ``spans`` names the benchmark's
    spans to keep. A trace in which no device activity falls inside the
    window is taken again, ``tries`` times in all."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    keep = set(spans) | {WINDOW, CALL}
    trace = None
    for attempt in range(1, tries + 1):
        got = []
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: got.extend(_events(p))) as prof:
            warm()
            _sync()
            time.sleep(0.1)
            prof.step()
            with record_function(WINDOW):
                window()
                _sync()
            prof.step()
        host = [(n, a, b) for n, a, b, dev in got if not dev and n in keep]
        wins = [(a, b) for n, a, b in host if n == WINDOW]
        if not wins:
            continue
        # the profiler mirrors each record_function range on the
        # device's timeline: those are spans, not device activity
        trace = Trace([(n, a, b) for n, a, b, dev in got
                       if dev and n not in keep
                       and not n.startswith("ProfilerStep")],
                      [s for s in host if s[0] != WINDOW], wins[-1])
        if trace.in_window() or not torch.cuda.is_available():
            return trace
        print(f"portbench: trace {attempt} of at most {tries} held no "
              "device activity in its window", file=sys.stderr, flush=True)
    return trace


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
