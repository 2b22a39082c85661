"""Share [%] of the traced window in which no device activity ran: 100
less the union of the device's activities (kernels, copies, fills) over
the whole window, on the profiler's own clock."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
