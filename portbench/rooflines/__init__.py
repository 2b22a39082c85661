"""Each kernel's least time from the shapes of a call alone: the larger
of its operations over the peak rate and its bytes over the memory's
peak bandwidth (``portbench/peaks.json``)."""


def least(flops, nbytes, flop_rate, byte_rate):
    """``(seconds, what binds)`` of ``flops`` at ``flop_rate`` and
    ``nbytes`` at ``byte_rate``."""
    t_ops, t_bytes = flops / flop_rate, nbytes / byte_rate
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
