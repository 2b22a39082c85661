"""Mean ms of the benchmark's ``thth.search`` spans in the traced
window: ``fit_thetatheta``, from the chunking on the host through every
row's search on the card to the global fit, which returns with its
results on the host (host clock, on the profiler's timeline)."""


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.span_times("thth.search")
    return 1e3 * sum(t) / len(t) if t else None
