"""Device ms per observation of the θ-θ gather: the CUDA events of the
program's ``thth.gather`` spans (the two-curve θ-θ and its Gram in the
thin search), summed."""

from portbench import program


def read(ctx):
    return program.device_ms(ctx, "thth.gather")
