"""The work of ``eig_warmstart`` in one observation's θ-θ search, from
the shapes alone: every θ-θ matrix of the search (chunks × η, n × n,
complex64) read once and each eigenvalue (float32) written once; one
complex mat-vec (8·n² real operations) per matrix per power step, at
``STEPS`` steps, the warm power steps the search gives each matrix
(``warm_iters`` of the port's fused search). Cold starts are not
counted: how many a chain needs depends on the data and on the kernel.
The operations run on the CUDA cores in float32."""

from . import least

STEPS = 24


def work(chunks, neta, n):
    """``(flops, bytes)`` of one observation's search."""
    matrices = chunks * neta
    return matrices * STEPS * 8 * n * n, matrices * (n * n * 8 + 4)


def least_seconds(shapes, peaks):
    flops, nbytes = work(shapes["chunks"], shapes["neta"], shapes["n"])
    return least(flops, nbytes, peaks["f32_flop_per_s"],
                 peaks["hbm_bytes_per_s"])
