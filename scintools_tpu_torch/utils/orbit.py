"""Binary-orbit helpers: Kepler's equation, the true anomaly and the
binary phase, in float64 on numpy arrays or torch tensors.

The port's own copy of ``kepler_solve``, ``get_true_anomaly`` and
``get_binphase`` of ``scintools_tpu/utils/orbit.py:16-68``: a
vectorised Newton iteration solves every epoch at once. The type of the
MJDs (or mean anomalies) picks the route: a tensor stays on its device
in float64, anything else is numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def _lib(x):
    return torch if isinstance(x, torch.Tensor) else np


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return np.asarray(x, dtype=float)


def kepler_solve(M, ecc, iters=30):
    """Solve E − e·sin E = M for an array of mean anomalies (Newton)."""
    M = _f64(M)
    xp = _lib(M)
    E = M + ecc * xp.sin(M)
    for _ in range(iters):
        E = E - (E - ecc * xp.sin(E) - M) / (1 - ecc * xp.cos(E))
    return E


def _vals(pars):
    return pars.valuesdict() if hasattr(pars, "valuesdict") else pars


def get_true_anomaly(mjds, pars):
    """True anomalies [rad, 0 … 2π) at barycentric MJDs for a parameter
    dict (T0/ECC or the ELL1 TASC/EPS1/EPS2 set, PB, optional PBDOT in
    tempo units)."""
    p = _vals(pars)
    if "TASC" in p:
        T0 = p["TASC"]
        ECC = np.sqrt(p["EPS1"] ** 2 + p["EPS2"] ** 2)
    else:
        T0 = p["T0"]
        ECC = p["ECC"]
    PB = p["PB"]
    PBDOT = p.get("PBDOT", 0)
    if np.abs(PBDOT) > 1e-10:
        PBDOT *= 1e-12  # tempo format

    nb = 2 * np.pi / PB
    mjds = _f64(mjds)
    xp = _lib(mjds)
    M = nb * ((mjds - T0) - 0.5 * (PBDOT / PB) * (mjds - T0) ** 2)
    E = M if ECC < 1e-4 else kepler_solve(M, ECC)  # circular: E = M
    U = 2 * xp.arctan2(np.sqrt(1 + ECC) * xp.sin(E / 2),
                       np.sqrt(1 - ECC) * xp.cos(E / 2))
    return xp.where(U < 0, U + 2 * np.pi, U)


def get_binphase(mjds, pars):
    """Binary phase: the true anomaly plus ω(t) (OMDOT in deg/yr)."""
    p = _vals(pars)
    U = get_true_anomaly(mjds, p)
    if "TASC" in p:
        OM = 0.0
    else:
        OM = p["OM"] * np.pi / 180
        if "OMDOT" in p:
            OM = OM + (p["OMDOT"] * (np.pi / 180) / 365.2425
                       * (_f64(mjds) - p["T0"]))
    return U + OM
