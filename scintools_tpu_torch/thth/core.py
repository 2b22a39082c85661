"""θ-θ geometry helpers (numpy, host side).

The port's own copies of ``scintools_tpu/thth/core.py``:
``unit_checks`` (:32, plain floats only — no astropy), ``fft_axis``
(:47), ``th_cents_from_edges`` (:59), ``cs_to_ri`` (:274) and
``min_edges`` (:532). Units: tau µs, fd mHz, eta s³ (µs/mHz²), edges
mHz.
"""

from __future__ import annotations

import numpy as np


def unit_checks(var, name=None):
    """Coerce to a plain float/ndarray. Objects with a ``.value``
    (quantities) give their value; plain numbers are assumed to be in
    canonical units."""
    if hasattr(var, "value") and not isinstance(var, (int, float, complex,
                                                      np.ndarray)):
        return np.asarray(var.value)
    return var


def fft_axis(x, pad=0, scale=1.0):
    """Fourier-conjugate coordinates of a uniform axis ``x`` with
    ``pad`` extra copies of padding. ``scale`` converts units:
    time[s] → fd[mHz] uses 1e3; freq[MHz] → tau[us] uses 1.0."""
    x = np.asarray(x, dtype=float)
    return np.fft.fftshift(
        np.fft.fftfreq((pad + 1) * x.shape[0], x[1] - x[0])) * scale


def th_cents_from_edges(edges):
    """Bin centres, re-centred on the bin nearest zero."""
    edges = np.asarray(edges, dtype=float)
    cents = (edges[1:] + edges[:-1]) / 2
    return cents - cents[np.argmin(np.abs(cents))]


def cs_to_ri(CS):
    """Stack a complex conjugate spectrum into the (real, imag) float
    wire format, real part first."""
    CS = np.asarray(CS)
    return np.stack([CS.real, CS.imag])


def min_edges(fd_lim, fd, tau, eta, factor=2):
    """Minimum edges array oversampling the CS everywhere."""
    fd = np.asarray(unit_checks(fd, "fd"), dtype=float)
    tau = np.asarray(unit_checks(tau, "tau"), dtype=float)
    eta = float(unit_checks(eta, "eta"))
    fd_lim = float(unit_checks(fd_lim, "fd_lim"))
    dtau_lim = (tau[1] - tau[0]) / factor / (2 * eta * fd_lim)
    dfd_lim = (fd[1] - fd[0]) / factor
    npoints = int((2 * fd_lim) // min(dfd_lim, dtau_lim))
    npoints += npoints % 2
    return np.linspace(-fd_lim, fd_lim, npoints)
