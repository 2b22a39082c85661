"""Device idle [ms per observation] in the rest of ``fit_thetatheta``:
the self time of the program's ``dynspec.fit_thetatheta`` and
``thth.row`` spans, and its ``thth.row.upload``, ``thth.row.fetch``,
``thth.row.results`` and ``thth.global_fit`` spans, overlapped with the
traced window's idle gaps."""

from portbench import program


def read(ctx):
    return program.idle_ms(ctx, program.REST)
