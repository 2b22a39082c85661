"""Device idle [ms per observation] in ``calc_sspec``: the program's
``dynspec.calc_sspec`` spans and their children (``sspec.transform``,
``sspec.fetch``) overlapped with the traced window's idle gaps."""

from portbench import program


def read(ctx):
    return program.idle_ms(ctx, program.SSPEC)
