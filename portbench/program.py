"""The program's own spans in a traced window, for the per-layer readers
of the host stages (``metrics/thth.idle_*_ms.py`` and the rest).

The program (``scintools_tpu_torch.obs.trace``) records its spans while
the profiler runs, stamped with ``time.time_ns()``, the clock the
profiler stamps host events with, so they lie on the trace's own
timeline. A span's self time is its interval less the part its children
cover; the device idle under a span is the overlap of its self
intervals with the window's idle gaps, so a gap that runs across
several stages is split among them. Everything is clipped to the
trace's window and divided by the window's calls (one observation
each). A program without these spans gives no records, and every reader
then returns None.
"""

from __future__ import annotations

import bisect

from . import trace as tr

#: the stages each idle reader reads (span names of the program)
CHUNK = ("thth.row.chunk",)
LAUNCH = ("thth.row.search", "thth.cs", "thth.gather", "thth.eig",
          "thth.peak")
REST = ("dynspec.fit_thetatheta", "thth.row", "thth.row.upload",
        "thth.row.fetch", "thth.row.results", "thth.global_fit")
SSPEC = ("dynspec.calc_sspec", "sspec.transform", "sspec.fetch")
BUILD = "build"


def records(ctx):
    """The program's records that overlap the traced window, or None
    where there is no trace, no call, or no record (a program that
    records no spans)."""
    if ctx.trace is None or not ctx.window.get("calls"):
        return None
    from scintools_tpu_torch.obs import trace as program

    read = getattr(program, "program_spans", None)
    return (read(*ctx.trace.window) or None) if read else None


def self_intervals(recs, lo, hi):
    """``[(record, [(a, b), ...])]``: each span's own stretches of
    [lo, hi], its interval less its children's (instants, whose start is
    their end, are not spans and are left out)."""
    spans = [r for r in recs if r.end_ns > r.start_ns]
    kids = {}
    for r in spans:
        kids.setdefault(r.parent, []).append((r.start_ns, r.end_ns))
    out = []
    for r in spans:
        a, b = max(r.start_ns, lo), min(r.end_ns, hi)
        out.append((r, tr.idle_gaps(kids.get(r.span_id, []), a, b)
                    if b > a else []))
    return out


class Gaps:
    """The window's idle gaps (sorted, disjoint), with the length of
    their part inside any interval in O(log n)."""

    def __init__(self, gaps):
        self.starts = [a for a, _ in gaps]
        self.ends = [b for _, b in gaps]
        self.cum = [0]
        for a, b in gaps:
            self.cum.append(self.cum[-1] + b - a)

    @property
    def total(self):
        return self.cum[-1]

    def within(self, a, b):
        i = bisect.bisect_right(self.ends, a)
        j = bisect.bisect_left(self.starts, b)
        if i >= j:
            return 0
        return (self.cum[j] - self.cum[i] - max(0, a - self.starts[i])
                - max(0, self.ends[j - 1] - b))


def idle_by_stage(ctx):
    """``({span name: idle ns under its self time}, total idle ns)``
    over the window, or None without records."""
    recs = records(ctx)
    if recs is None:
        return None
    lo, hi = ctx.trace.window
    gaps = Gaps(tr.idle_gaps([(a, b) for _, a, b in ctx.trace.device],
                             lo, hi))
    idle = {}
    for r, pieces in self_intervals(recs, lo, hi):
        idle[r.name] = idle.get(r.name, 0) + sum(
            gaps.within(a, b) for a, b in pieces)
    return idle, gaps.total


def idle_ms(ctx, names):
    """Device idle [ms per observation] under the self time of the spans
    called ``names``."""
    got = idle_by_stage(ctx)
    if got is None:
        return None
    idle, _ = got
    return sum(idle.get(n, 0) for n in names) / 1e6 / ctx.window["calls"]


def unattributed_pct(ctx):
    """Share [%] of the window's idle time under no program span."""
    got = idle_by_stage(ctx)
    if got is None:
        return None
    idle, total = got
    if total <= 0:
        return None
    return 100.0 * (total - sum(idle.values())) / total


def self_ms(ctx, name):
    """Host self time [ms per observation] of the spans called
    ``name``."""
    recs = records(ctx)
    if recs is None:
        return None
    ns = sum(b - a for r, pieces in self_intervals(recs, *ctx.trace.window)
             if r.name == name for a, b in pieces)
    return ns / 1e6 / ctx.window["calls"]


def device_ms(ctx, name):
    """Device time [ms per observation] of the spans called ``name``
    that start in the window (their CUDA events), or None where one has
    no device time (the CPU) or there is none."""
    recs = records(ctx)
    if recs is None:
        return None
    lo, hi = ctx.trace.window
    ms = [r.device_ms for r in recs if r.name == name
          and lo <= r.start_ns < hi]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / ctx.window["calls"]


def builds_per_obs(ctx):
    """``build`` records (a built-function cache's misses) in the window
    per observation."""
    recs = records(ctx)
    if recs is None:
        return None
    lo, hi = ctx.trace.window
    n = sum(1 for r in recs if r.name == BUILD and lo <= r.start_ns <= hi)
    return n / ctx.window["calls"]
