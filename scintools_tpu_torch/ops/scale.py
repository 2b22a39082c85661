"""Rescaling of a dynamic spectrum: equal-wavelength, equal-velocity and
trapezoid.

Counterpart of ``scintools_tpu/ops/scale.py``. ``lambda_rescale``
(:20-50, with the edge-snap of the rounded frequency grid) and
``velocity_rescale`` (:53-59) are cubic resamplings along one axis on
the host in float64 (``ops.interp.columnwise_cubic_interp``), as in the
JAX package. ``trapezoid_rescale`` (:81-153) runs on the device: every
frequency row is resampled onto its own shorter time grid with trailing
zeros, as one fixed-shape masked row interpolation in float64 (per-row
positions, a validity mask, ``torch.searchsorted`` and a lerp with
``jnp.interp``'s edge rules). ``trapezoid_rescale_plain`` is the JAX
package's numpy row loop (:118-125), its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import resolve_device
from .interp import columnwise_cubic_interp
from .windows import get_window

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


def velocity_rescale(dyn, veff):
    """Resample the time axis onto an equal cumulative-|veff| grid;
    ``veff[nt]`` is the effective-velocity magnitude per subint."""
    dyn = np.asarray(dyn)
    vc_orig = np.cumsum(np.asarray(veff, dtype=float))
    vc_new = np.linspace(np.min(vc_orig), np.max(vc_orig), len(vc_orig))
    return columnwise_cubic_interp(dyn, vc_orig, vc_new, axis=1)


def _trapezoid_setup(dyn, times, freqs, window, window_frac):
    """The windowed, mean-subtracted spectrum and each row's sample
    count ``n_in`` (float64 numpy)."""
    dyn = np.asarray(dyn, dtype=float)
    dyn = dyn - np.mean(dyn)
    nf, nt = dyn.shape
    if window is not None:
        cw, sw = get_window(nt, nf, window=window, frac=window_frac)
        dyn = cw * dyn
        dyn = (sw * dyn.T).T
    times = np.asarray(times, dtype=float)
    scalefrac = 1 / (np.max(freqs) / np.min(freqs))
    timestep = np.max(times) * (1 - scalefrac) / (nf + 1)
    maxtimes = np.max(times) - (nf - (np.arange(nf) + 1)) * timestep
    n_in = (times[None, :] <= maxtimes[:, None]).sum(axis=1)
    return dyn, times, n_in


def trapezoid_rescale_plain(dyn, times, freqs, window="hanning",
                            window_frac=0.1):
    """Trapezoid scaling by a host row loop of ``np.interp``: row ii is
    resampled onto ``linspace(min(times), max(times), n_in[ii])`` and
    padded with trailing zeros."""
    dyn, times, n_in = _trapezoid_setup(dyn, times, freqs, window,
                                        window_frac)
    nf, nt = dyn.shape
    out = np.empty_like(dyn)
    for ii in range(nf):
        newline = np.interp(
            np.linspace(np.min(times), np.max(times), n_in[ii]),
            times, dyn[ii, :])
        out[ii, :] = np.concatenate([newline, np.zeros(nt - n_in[ii])])
    return out


def interp_rows(x, xp, fp):
    """``jnp.interp(x[r], xp, fp[r])`` for every row r: ``x`` and ``fp``
    are (rows, n) tensors, ``xp`` an ascending 1-D tensor. The cell is
    ``clip(searchsorted(xp, x, right), 1, len − 1)``, so a point on the
    last node is the lerp fp[−2] + 1·(fp[−1] − fp[−2]), as JAX computes
    it; points outside the grid take the edge values."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, n - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0 = torch.gather(fp, 1, i - 1)
    f1 = torch.gather(fp, 1, i)
    dx = x1 - x0
    eps = np.spacing(np.finfo(np.float64 if xp.dtype == torch.float64
                              else np.float32).eps)
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(
        dx0, torch.ones_like(dx), dx)) * (f1 - f0))
    f = torch.where(x < xp[0], fp[:, :1], f)
    return torch.where(x > xp[-1], fp[:, -1:], f)


def trapezoid_rescale(dyn, times, freqs, window="hanning", window_frac=0.1,
                      device=None):
    """Trapezoid scaling on ``device`` (``None``: the CUDA card), in
    float64: per-row resample positions ``X[r, j] = min(times) + j·(max
    − min)/(n_in[r] − 1)``, a validity mask ``j < n_in[r]`` and the row
    interpolation :func:`interp_rows`; invalid positions are 0. Returns
    float64 numpy ``(nf, nt)``."""
    dev = resolve_device(device)
    dyn, times, n_in = _trapezoid_setup(dyn, times, freqs, window,
                                        window_frac)
    nt = dyn.shape[1]
    f64 = torch.float64
    t = torch.as_tensor(times, dtype=f64, device=dev)
    n = torch.as_tensor(n_in, device=dev)[:, None]
    j = torch.arange(nt, device=dev)[None, :]
    tmin, tmax = float(np.min(times)), float(np.max(times))
    denom = torch.clamp(n - 1, min=1).to(f64)
    X = tmin + j.to(f64) * (tmax - tmin) / denom
    d = torch.as_tensor(dyn, dtype=f64, device=dev)
    out = torch.where(j < n, interp_rows(X, t, d), torch.zeros((), dtype=f64,
                                                               device=dev))
    return out.cpu().numpy()
