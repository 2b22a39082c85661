"""Share [%] of its roofline that ``arc_profile`` reaches: the least
time of one call's profile (``portbench/rooflines/arc_profile.py``)
over the kernel's device time per call, summed by name from the traced
window."""

from portbench.rooflines import arc_profile


def read(ctx):
    if ctx.trace is None or not ctx.window["calls"]:
        return None
    dev = sum(b - a for n, a, b in ctx.trace.in_window()
              if "arc_profile" in n) / 1e9
    if dev <= 0:
        return None
    least, _ = arc_profile.least_seconds(ctx.shapes, ctx.peaks)
    return 100.0 * least / (dev / ctx.window["calls"])
