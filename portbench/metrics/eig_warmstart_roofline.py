"""Share [%] of its roofline that ``eig_warmstart`` reaches: the least
time of one observation's search (``portbench/rooflines/
eig_warmstart.py``) over the kernel's device time per observation,
summed by name from the traced window."""

from portbench.rooflines import eig_warmstart


def read(ctx):
    if ctx.trace is None or not ctx.window["calls"]:
        return None
    dev = sum(b - a for n, a, b in ctx.trace.in_window()
              if "eig_warmstart" in n) / 1e9
    if dev <= 0:
        return None
    least, _ = eig_warmstart.least_seconds(ctx.shapes, ctx.peaks)
    return 100.0 * least / (dev / ctx.window["calls"])
