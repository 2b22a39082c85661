"""The work of ``arc_profile`` in one ``fit_arc_batch`` call, from the
shapes alone: the delay rows it averages of every epoch's spectrum
(epochs × rows × Doppler bins, float32) read once and the profile
(epochs × queries, float32) written once. Its arithmetic (a two-tap
interpolation per row and query) is far below the bytes' time."""

from . import least

FLOPS_PER_TAP = 20


def work(epochs, rows, doppler, queries):
    """``(flops, bytes)`` of one call."""
    return (FLOPS_PER_TAP * epochs * rows * queries,
            epochs * rows * doppler * 4 + epochs * queries * 4)


def least_seconds(shapes, peaks):
    flops, nbytes = work(shapes["epochs"], shapes["rows"],
                         shapes["doppler"], shapes["queries"])
    return least(flops, nbytes, peaks["f32_flop_per_s"],
                 peaks["hbm_bytes_per_s"])
