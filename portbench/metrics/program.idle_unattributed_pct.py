"""Share [%] of the traced window's idle time under no program span: the
device idle that the program's spans do not put down to a host stage
(the benchmark's own loop, and stages that record no span)."""

from portbench import program


def read(ctx):
    return program.unattributed_pct(ctx)
