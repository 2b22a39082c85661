"""Mean ms of the benchmark's ``thth.sspec`` spans in the traced window:
the host's time in that call of the façade, which returns with its
results on the host (host clock, on the profiler's timeline)."""


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.span_times("thth.sspec")
    return 1e3 * sum(t) / len(t) if t else None
