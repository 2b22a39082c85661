"""Observations fitted per second: every observation of the window over
the window's seconds (host clock)."""


def read(ctx):
    if ctx.window["unit"] != "obs" or ctx.window["units"] == 0:
        return None
    return ctx.window["units"] / ctx.window["elapsed"]
