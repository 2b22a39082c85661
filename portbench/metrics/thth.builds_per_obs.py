"""Built functions per observation in the traced window: the program's
``build`` records (a cache miss of a built-function factory, as the
façade's fused searches), which a steady loop should not make."""

from portbench import program


def read(ctx):
    return program.builds_per_obs(ctx)
