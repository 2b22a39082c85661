"""Scintillation velocity and the curvature likelihood (host float64).

The port's own copy of ``scint_velocity``,
``calculate_curvature_peak_probability``, ``curvature_log_likelihood``
and ``save_curvature_data`` of ``scintools_tpu/utils/velocity.py:10-111``
(reference ``scint_utils.py:732-766``, ``:835-957``).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter1d


def scint_velocity(params, dnu, tau, freq, dnuerr=None, tauerr=None,
                   a=2.53e4):
    """viss = a·√(2d(1−s)/s)·√Δν/(f·τ) ± error
    (scint_utils.py:732-766)."""
    freq = freq / 1e3  # GHz
    if params is not None:
        p = params
        d = p["d"].value if hasattr(p["d"], "value") else p["d"]
        s = p["s"].value if hasattr(p["s"], "value") else p["s"]
        d_err = (p["d"].stderr if hasattr(p["d"], "stderr")
                 else p.get("derr", 0)) or 0
        s_err = (p["s"].stderr if hasattr(p["s"], "stderr")
                 else p.get("serr", 0)) or 0
        coeff = a * np.sqrt(2 * d * (1 - s) / s)
        coeff_err = (dnu / s) * ((1 - s) * d_err ** 2 / (2 * d)
                                 + (d * s_err ** 2
                                    / (2 * s ** 2 * (1 - s))))
    else:
        coeff, coeff_err = a, 0
    viss = coeff * np.sqrt(dnu) / (freq * tau)
    if dnuerr is not None and tauerr is not None:
        viss_err = (1 / (freq * tau)) * np.sqrt(
            coeff ** 2 * ((dnuerr ** 2 / (4 * dnu))
                          + (dnu * tauerr ** 2 / tau ** 2)) + coeff_err)
        return viss, viss_err
    return viss


def calculate_curvature_peak_probability(power_data, noise_level,
                                         smooth=True, curvatures=None,
                                         log=False):
    """Gaussian probability of the Doppler-profile peak
    (scint_utils.py:835-854). ``curvatures`` is accepted for API
    parity and unused — the reference notes it "currently doesn't
    normalise using curvatures" (scint_utils.py:853)."""
    power_data = np.asarray(power_data, dtype=float)
    if smooth:
        power_data = gaussian_filter1d(power_data, noise_level)
    if np.shape(noise_level) == ():
        max_power = np.max(power_data)
    else:
        noise_level = np.reshape(noise_level, (len(noise_level), 1))
        max_power = np.max(power_data, axis=1).reshape(
            (len(power_data), 1))
    if log:
        return (np.log(1 / (noise_level * np.sqrt(2 * np.pi)))
                - 0.5 * ((power_data - max_power) / noise_level) ** 2)
    return (1 / (noise_level * np.sqrt(2 * np.pi))
            * np.exp(-0.5 * ((power_data - max_power)
                             / noise_level) ** 2))


def curvature_log_likelihood(power, nfdop, noise, model_nfdop):
    """Log likelihood of model nfdop against Doppler-profile densities
    (scint_utils.py:902-957)."""
    nfdop = np.asarray(nfdop, dtype=float)
    dim = len(np.shape(nfdop))
    eta_prob = calculate_curvature_peak_probability(power, noise,
                                                    log=True)
    integral = np.sum(np.exp(eta_prob[..., :-1])
                      * np.diff(nfdop, axis=dim - 1), axis=dim - 1)
    if dim == 2:
        integral = integral.reshape((len(integral), 1))
    eta_prob_norm = eta_prob - np.log(integral)

    if dim == 2:
        like = np.zeros(len(nfdop))
        outside = np.argwhere(
            (model_nfdop > np.max(nfdop, axis=1))
            | (model_nfdop < np.min(nfdop, axis=1))).flatten()
        inside = np.argwhere(
            (model_nfdop < np.max(nfdop, axis=1))
            & (model_nfdop > np.min(nfdop, axis=1))).flatten()
        like[outside] = -200
        model_in = np.reshape(np.asarray(model_nfdop)[inside],
                              (len(inside), 1))
        inds = np.argmin(np.abs(nfdop[inside] - model_in), axis=1)
        like[inside] = eta_prob_norm[inside, inds]
        return np.sum(like)
    if dim == 1:
        if np.min(nfdop) < model_nfdop < np.max(nfdop):
            return eta_prob_norm[np.argmin(np.abs(nfdop - model_nfdop))]
        return -200
    raise ValueError("Invalid input array dimension. Must be either 1D "
                     "(single observation) or 2D (multiple observations)")


def save_curvature_data(dyn, filename=None):
    """Save power-vs-curvature + noise to npz
    (scint_utils.py:857-875)."""
    if filename is None:
        filename = dyn.name + "curvature_data"
    sup_data = np.array([dyn.name, dyn.mjd])
    if hasattr(dyn, "normsspecavg"):
        np.savez(filename, sup_data, dyn.normsspec_fdop,
                 dyn.normsspecavg, dyn.noise)
    elif hasattr(dyn, "norm_sspec_avg1"):
        np.savez(filename, sup_data, dyn.eta_array, dyn.norm_sspec_avg1,
                 dyn.norm_sspec_avg2, dyn.noise)
    else:
        np.savez(filename, sup_data, dyn.eta_array, dyn.norm_sspec_avg,
                 dyn.noise)
