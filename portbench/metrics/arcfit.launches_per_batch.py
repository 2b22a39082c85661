"""Device activities (kernels, copies, fills) per ``fit_arc_batch``
call in the traced window: how many launches the host makes, and so
how far it paces the call."""


def read(ctx):
    if ctx.trace is None or not ctx.window["calls"]:
        return None
    n = len(ctx.trace.in_window())
    return n / ctx.window["calls"] if n else None
