"""Device ms per ``fit_arc_batch`` call: the union of the device's
activities in the traced window over its calls."""


def read(ctx):
    if ctx.trace is None or not ctx.window["calls"]:
        return None
    busy = ctx.trace.busy_s()
    return 1e3 * busy / ctx.window["calls"] if busy > 0 else None
