"""Scintillation model library: residual functions for the fitter, and
the parabola peak fitters of the arc fit.

Counterpart of ``scintools_tpu/fit/models.py``: the 1-D ACF models
``tau_acf_model``, ``dnu_acf_model``, ``scint_acf_model`` and their
``_values`` (:25-79), the approximate 2-D model (:82-113), the analytic
2-D model ``scint_acf_model_2d`` (:116-159), ``powerspectrum_model``
(:201-204), ``fit_parabola`` and ``fit_log_parabola`` (:227-250). Each
residual keeps the reference contract: (params, xdata, ydata, weights) →
(ydata − model)·weights.

Routes. The scipy fits (``fitter``) evaluate the 1-D, approximate 2-D
and power-spectrum residuals in float64 numpy on the host: a residual of
a few hundred points costs less than one round trip to the card, so
these stay on the host by design, not as a fall-back (nothing switches
on failure). The 1-D models take torch tensors as well, which is how the
batched Levenberg–Marquardt fit (``fit/batch.py``) runs them on the
device; the type of ``xdata`` picks the route. The analytic 2-D model
builds the theoretical ACF (``sim/acf_model.py``) on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch


def _vals(params):
    return params.valuesdict() if hasattr(params, "valuesdict") else params


def _exp(x):
    return torch.exp(x) if isinstance(x, torch.Tensor) else np.exp(x)


def _weights_lag0_zero(weights, ydata):
    """The weights with lag 0's set to 0 (ones when None)."""
    if isinstance(ydata, torch.Tensor):
        w = torch.ones_like(ydata) if weights is None else weights
        return torch.cat([torch.zeros_like(w[:1]), w[1:]])
    w = (np.ones(np.shape(ydata)) if weights is None
         else np.array(weights, dtype=float))
    w[0] = 0
    return w


# --------------------------------------------------------------------------
# 1-D and 2-D ACF models
# --------------------------------------------------------------------------

def tau_acf_model_values(params, xdata):
    """amp·exp(−(t/τ)^α) × triangle taper, unweighted."""
    p = _vals(params)
    model = p["amp"] * _exp(-(xdata / p["tau"]) ** p["alpha"])
    return model * (1 - xdata / xdata.max())


def tau_acf_model(params, xdata, ydata, weights):
    """amp·exp(−(t/τ)^α) × triangle taper; lag 0's weight zeroed."""
    model = tau_acf_model_values(params, xdata)
    return (ydata - model) * _weights_lag0_zero(weights, ydata)


def dnu_acf_model_values(params, xdata):
    """amp·exp(−f/(Δν/ln 2)) × triangle taper, unweighted."""
    p = _vals(params)
    model = p["amp"] * _exp(-xdata / (p["dnu"] / np.log(2)))
    return model * (1 - xdata / xdata.max())


def dnu_acf_model(params, xdata, ydata, weights):
    """amp·exp(−f/(Δν/ln 2)) × triangle taper; lag 0's weight zeroed."""
    model = dnu_acf_model_values(params, xdata)
    return (ydata - model) * _weights_lag0_zero(weights, ydata)


def scint_acf_model(params, xdata, ydata, weights):
    """Joint τ and Δν 1-D fit: xdata, ydata and weights are (time cut,
    frequency cut) pairs."""
    rt = tau_acf_model(params, xdata[0], ydata[0],
                       None if weights is None else weights[0])
    rf = dnu_acf_model(params, xdata[1], ydata[1],
                       None if weights is None else weights[1])
    if isinstance(rt, torch.Tensor):
        return torch.cat((rt, rf))
    return np.concatenate((rt, rf))


def scint_acf_model_2d_approx_values(params, tdata, fdata):
    """Approximate 2-D ACF surface (nf, nt) with phase-gradient shear,
    unweighted (float64 numpy)."""
    p = _vals(params)
    amp, dnu, tau, alpha = p["amp"], p["dnu"], p["tau"], p["alpha"]
    mu = p["phasegrad"] * 60  # min/MHz → s/MHz
    tobs, bw = p["tobs"], p["bw"]
    nt, nf = len(tdata), len(fdata)
    tdata = np.reshape(np.asarray(tdata), (nt, 1))
    fdata = np.reshape(np.asarray(fdata), (1, nf))
    model = amp * np.exp(
        -(np.abs((tdata - mu * fdata) / tau) ** (3 * alpha / 2)
          + np.abs(fdata / (dnu / np.log(2))) ** (3 / 2)) ** (2 / 3))
    model = model * (1 - np.abs(tdata) / tobs)
    model = model * (1 - np.abs(fdata) / bw)
    return np.transpose(model)


def _spike_weights(weights, shape):
    """The weights with the white-noise spike (the centre) zeroed."""
    if weights is None:
        weights = np.ones(shape)
    weights = np.fft.fftshift(np.asarray(weights))
    weights[-1, -1] = 0
    return np.fft.ifftshift(weights)


def scint_acf_model_2d_approx(params, tdata, fdata, ydata, weights):
    """Approximate analytic 2-D ACF; the white-noise spike is not
    fitted."""
    model = scint_acf_model_2d_approx_values(params, tdata, fdata)
    return (ydata - model) * _spike_weights(weights, np.shape(ydata))


def scint_acf_model_2d(params, ydata, weights, device=None):
    """Analytic 2-D ACF (Rickett et al. 2014): each evaluation builds the
    theoretical ACF on ``device`` (``None``: the CUDA card); the white-
    noise spike is not fitted."""
    model = scint_acf_model_2d_values(params, np.shape(ydata), device=device)
    return (ydata - model) * _spike_weights(weights, np.shape(ydata))


def scint_acf_model_2d_values(params, shape, device=None):
    """Analytic 2-D ACF surface for a (nf_crop, nt_crop) crop,
    unweighted, as float64 numpy; the ACF is built on ``device``."""
    from ..sim.acf_model import theoretical_acf

    p = _vals(params)
    tau, dnu = abs(p["tau"]), abs(p["dnu"])
    tobs, bw = p["tobs"], p["bw"]
    nt, nf = p["nt"], p["nf"]
    nf_crop, nt_crop = shape
    dt, df = 2 * tobs / nt, 2 * bw / nf
    taumax = nt_crop * dt / tau
    dnumax = nf_crop * df / dnu

    acf = theoretical_acf(
        taumax=taumax, dnumax=dnumax, nt=nt_crop, nf=nf_crop,
        ar=abs(p["ar"]), alpha=p["alpha"], phasegrad=p["phasegrad"],
        theta=p["theta"], amp=p["amp"], psi=p["psi"], wn=p.get("wn", 0),
        device=device)
    tri_t = 1 - np.abs(np.linspace(-taumax * tau, taumax * tau,
                                   nt_crop)) / tobs
    tri_f = 1 - np.abs(np.linspace(-dnumax * dnu, dnumax * dnu,
                                   nf_crop)) / bw
    return acf.acf * np.outer(tri_f, tri_t)


def powerspectrum_model(params, xdata, ydata):
    """wn + amp·x^alpha."""
    p = _vals(params)
    return ydata - (p["wn"] + p["amp"] * xdata ** p["alpha"])


# --------------------------------------------------------------------------
# parabola fitters (closed-form polyfit)
# --------------------------------------------------------------------------

def fit_parabola(x, y):
    """Deg-2 polyfit with covariance → (yfit, peak, peak_error)."""
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    ptp = np.ptp(x)
    xs = x * (1000 / ptp)
    params, pcov = np.polyfit(xs, y, 2, cov=True)
    yfit = params[0] * xs ** 2 + params[1] * xs + params[2]
    errors = np.sqrt(np.abs(np.diag(pcov)))
    peak = -params[1] / (2 * params[0])
    peak_error = np.sqrt((errors[1] ** 2) * ((1 / (2 * params[0])) ** 2)
                         + (errors[0] ** 2) * ((params[1] / 2) ** 2))
    return yfit, peak * (ptp / 1000), peak_error * (ptp / 1000)


def fit_log_parabola(x, y):
    """Parabola fit in log x → (yfit, peak, peak_error)."""
    logx = np.log(np.asarray(x, dtype=float))
    ptp = np.ptp(logx)
    xs = logx * (1000 / ptp)
    yfit, peak, peak_error = fit_parabola(xs, y)
    frac_error = peak_error / peak
    peak = np.e ** (peak * ptp / 1000)
    return yfit, peak, frac_error * peak
