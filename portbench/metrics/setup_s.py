"""Set-up [s]: from the process's start (imports, the card's context,
kernel builds on a checkout's first run) through making the inputs and
the warm-up calls, to the window's start (host clock)."""


def read(ctx):
    return ctx.window["setup_s"]
