"""Host self time [ms per observation] in the program's
``thth.row.fetch`` spans: the rows' fetches of their results, which
wait for the row's device work, so the time the host could spend on
the next row."""

from portbench import program


def read(ctx):
    return program.self_ms(ctx, "thth.row.fetch")
