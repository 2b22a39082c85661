"""Equal-wavelength rescaling of a dynamic spectrum (numpy, host side).

The port's own copy of ``lambda_rescale`` and ``SPEED_OF_LIGHT`` of
``scintools_tpu/ops/scale.py:17-50``, including the edge-snap of the
rounded frequency grid. Velocity and trapezoid rescaling are not
ported yet (``Dynspec.scale_dyn`` raises ``NotImplementedError``).
"""

from __future__ import annotations

import numpy as np

from .interp import columnwise_cubic_interp

SPEED_OF_LIGHT = 299792458.0  # m/s


def lambda_rescale(dyn, freqs, spacing="auto"):
    """Resample the frequency axis onto an equal-wavelength grid.

    ``dyn[nf, nt]`` with ascending ``freqs`` [MHz] → ``(lamdyn[nlam,
    nt]`` with descending-wavelength rows, ``lam`` [m] descending,
    ``dlam`` [m])."""
    dyn = np.asarray(dyn)
    freqs = np.asarray(freqs, dtype=float)
    lams = SPEED_OF_LIGHT / (freqs * 1e6)
    dl = np.abs(np.diff(lams))
    if spacing == "max":
        dlam = np.max(dl)
    elif spacing == "median":
        dlam = np.median(dl)
    elif spacing == "mean":
        dlam = np.mean(dl)
    elif spacing == "min":
        dlam = np.min(dl)
    elif spacing == "auto":
        dlam = (np.max(lams) - np.min(lams)) / len(freqs)
    else:
        raise ValueError(f"unknown spacing {spacing!r}")
    lam_eq = np.arange(np.min(lams) + 1e-10, np.max(lams) - 1e-10, dlam)
    feq = np.round(SPEED_OF_LIGHT / lam_eq / 1e6, 6)
    # snap rounded endpoints back into the valid range
    feq[np.argmax(feq)] = min(feq.max(), freqs.max())
    feq[np.argmin(feq)] = max(feq.min(), freqs.min())
    arout = columnwise_cubic_interp(dyn, freqs, feq, axis=0)
    return np.flipud(arout), np.flip(lam_eq), float(dlam)
