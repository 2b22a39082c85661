"""Device ms per observation of the eigensolver: the CUDA events of the
program's ``thth.eig`` spans (the power steps in the thin search),
summed."""

from portbench import program


def read(ctx):
    return program.device_ms(ctx, "thth.eig")
