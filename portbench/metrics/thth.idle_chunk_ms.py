"""Device idle [ms per observation] while the host cuts a row's chunks:
the program's ``thth.row.chunk`` spans (the chunk extraction and the
float32 stack) overlapped with the traced window's idle gaps."""

from portbench import program


def read(ctx):
    return program.idle_ms(ctx, program.CHUNK)
