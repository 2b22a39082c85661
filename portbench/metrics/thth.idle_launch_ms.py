"""Device idle [ms per observation] while the host enqueues a row's
fused search: the program's ``thth.row.search`` spans and their
children (``thth.cs``, ``thth.gather``, ``thth.eig``, ``thth.peak``)
overlapped with the traced window's idle gaps."""

from portbench import program


def read(ctx):
    return program.idle_ms(ctx, program.LAUNCH)
