"""Epochs fitted per second: every epoch of every batch call of the
window over the window's seconds (host clock)."""


def read(ctx):
    if ctx.window["unit"] != "epochs" or ctx.window["units"] == 0:
        return None
    return ctx.window["units"] / ctx.window["elapsed"]
