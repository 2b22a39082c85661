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

The secondary-spectrum 1-D models ``tau_sspec_model``,
``dnu_sspec_model``, ``scint_sspec_model`` (:162-199, over
``ops.xfft.real_spectrum_1d``), the velocity and curvature models
``effective_velocity_annual``, ``arc_curvature``, ``veff_thin_screen``
(:207-367), the weak-scintillation arc models ``arc_weak``,
``arc_weak_2d`` (:375-427) and ``arc_power_curve`` (:207) take numpy
arrays or tensors alike.

Parameters are host scalars for the least-squares fits. Under the
ensemble sampler (``mcmc/likelihood.py``) they are tensors with a walker
axis, or a lane of ``torch.func.vmap``: the 1-D, approximate 2-D and
velocity models then dispatch every function of a parameter to torch
(:func:`_fn`), and ``_inclination`` branches by ``torch.where``. Host
scalars take the numpy functions they always took, so float64 host
results are unchanged.
"""

from __future__ import annotations

import numpy as np
import torch


def _vals(params):
    return params.valuesdict() if hasattr(params, "valuesdict") else params


def _exp(x):
    return torch.exp(x) if isinstance(x, torch.Tensor) else np.exp(x)


def _fn(name, x):
    """``torch.<name>(x)`` for a tensor, else ``np.<name>(x)``."""
    if isinstance(x, torch.Tensor):
        return getattr(torch, name)(x)
    return getattr(np, name)(x)


def _lib(*arrays):
    """torch when any of ``arrays`` is a tensor, else numpy."""
    return torch if any(isinstance(a, torch.Tensor) for a in arrays) else np


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
    xp = _lib(tdata, fdata, amp, dnu, tau, alpha, mu)
    nt, nf = len(tdata), len(fdata)
    if xp is torch:
        tdata = torch.reshape(torch.as_tensor(tdata), (nt, 1))
        fdata = torch.reshape(torch.as_tensor(fdata), (1, nf))
    else:
        tdata = np.reshape(np.asarray(tdata), (nt, 1))
        fdata = np.reshape(np.asarray(fdata), (1, nf))
    model = amp * xp.exp(
        -(xp.abs((tdata - mu * fdata) / tau) ** (3 * alpha / 2)
          + xp.abs(fdata / (dnu / np.log(2))) ** (3 / 2)) ** (2 / 3))
    model = model * (1 - xp.abs(tdata) / tobs)
    model = model * (1 - xp.abs(fdata) / bw)
    return model.T if xp is torch else np.transpose(model)


def _spike_weights(weights, shape):
    """The weights with the white-noise spike (the centre) zeroed."""
    if isinstance(weights, torch.Tensor):
        keep = torch.ones(shape, dtype=torch.bool, device=weights.device)
        keep[-1, -1] = False
        keep = torch.fft.ifftshift(keep)
        return torch.where(keep, weights, torch.zeros_like(weights))
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


# --------------------------------------------------------------------------
# secondary-spectrum 1-D models
# --------------------------------------------------------------------------

def _sspec_1d(model, xdata):
    """The spectrum of the mirrored, triangle-tapered profile: the
    length-(2L − 1) mirror is real, so ``real(fft(·))[:L]`` is the rfft
    half spectrum (``ops.xfft.real_spectrum_1d``)."""
    from ..ops.xfft import real_spectrum_1d

    xp = _lib(model, xdata)
    model = model * (1 - xdata / xdata.max())
    if xp is torch:
        model = torch.cat((model, torch.flip(model, (0,))))
    else:
        model = np.concatenate((model, model[::-1]))
    return real_spectrum_1d(model[: 2 * len(xdata) - 1], len(xdata))


def _lag0_zeroed(model, n):
    xp = _lib(model)
    first = xp.arange(n) == 0
    if xp is torch:
        first = first.to(model.device)
    return xp.where(first, 0.0, model)


def tau_sspec_model(params, xdata, ydata):
    """Residual of the time-lag profile's spectrum, weighted by the
    model: (ydata − model)·model."""
    p = _vals(params)
    model = p["amp"] * _exp(-(xdata / p["tau"]) ** p["alpha"])
    model = _sspec_1d(_lag0_zeroed(model, len(xdata)), xdata)
    return (ydata - model) * model


def dnu_sspec_model(params, xdata, ydata):
    """Residual of the frequency-lag profile's spectrum, weighted by the
    model."""
    p = _vals(params)
    model = p["amp"] * _exp(-xdata / (p["dnu"] / np.log(2)))
    model = _sspec_1d(_lag0_zeroed(model, len(xdata)), xdata)
    return (ydata - model) * model


def scint_sspec_model(params, xdata, ydata):
    """Joint τ and Δν spectrum fit over (time, frequency) pairs."""
    rt = tau_sspec_model(params, xdata[0], ydata[0])
    rf = dnu_sspec_model(params, xdata[1], ydata[1])
    if isinstance(rt, torch.Tensor):
        return torch.cat((rt, rf))
    return np.concatenate((rt, rf))


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


def arc_power_curve(params, xdata, ydata, weights):
    """Residuals of a noise floor plus power law in |x| (√curvature or
    normalised f_D): the reference leaves this model a stub, and the JAX
    package fits it with the family of the Doppler-profile power
    spectra."""
    p = _vals(params)
    if weights is None:
        weights = 1.0
    model = p["wn"] + p["amp"] * abs(xdata) ** p.get("alpha", -2.0)
    return (ydata - model) * weights


# --------------------------------------------------------------------------
# velocity and curvature models
# --------------------------------------------------------------------------

KM_PER_KPC = 3.085677581e16


def _inclination(p):
    if "KIN" in p:
        inc = p["KIN"] * np.pi / 180
    elif "COSI" in p:
        inc = _fn("arccos", p["COSI"])
    elif "SINI" in p:
        inc = _fn("arcsin", p["SINI"])
    else:
        raise KeyError("inclination parameter (KIN, COSI, or SINI) "
                       "not found")
    if "sense" in p:
        sense = p["sense"]
        if _lib(inc, sense) is torch:
            flip = (((sense < 0.5) & (inc > np.pi / 2))
                    | ((sense >= 0.5) & (inc < np.pi / 2)))
            return torch.where(torch.as_tensor(flip), np.pi - inc, inc)
        if sense < 0.5 and inc > np.pi / 2:
            inc = np.pi - inc
        if sense >= 0.5 and inc < np.pi / 2:
            inc = np.pi - inc
    return inc


def effective_velocity_annual(params, true_anomaly, vearth_ra, vearth_dec,
                              mjd=None):
    """Keplerian binary + proper motion + Earth → the effective velocity
    in RA/DEC [km/s]: ``(veff_ra, veff_dec, vp_ra, vp_dec)``."""
    xp = _lib(true_anomaly, mjd)
    p = _vals(params)
    v_c = 299792.458
    secperyr = 86400 * 365.2425
    masrad = np.pi / (3600 * 180 * 1000)

    if "PB" in p:
        A1, PB, ECC = p["A1"], p["PB"], p["ECC"]
        OM = p["OM"] * np.pi / 180
        if "OMDOT" in p and mjd is not None:
            omega = OM + (p["OMDOT"] * np.pi / 180
                          * (mjd - p["T0"]) / 365.2425)
        else:
            omega = OM
        INC = _inclination(p)
        KOM = p["KOM"] * np.pi / 180
        vp_0 = (2 * np.pi * A1 * v_c) / (_fn("sin", INC) * PB * 86400
                                         * _fn("sqrt", 1 - ECC ** 2))
        xp = _lib(true_anomaly, mjd, omega)
        vp_x = -vp_0 * (ECC * _fn("sin", omega)
                        + xp.sin(true_anomaly + omega))
        vp_y = vp_0 * _fn("cos", INC) * (ECC * _fn("cos", omega)
                                         + xp.cos(true_anomaly + omega))
    else:
        vp_x = 0.0
        vp_y = 0.0
        KOM = p.get("KOM", 0.0) * np.pi / 180

    d = p["d"] * KM_PER_KPC
    pmra_v = p.get("PMRA", 0.0) * masrad * d / secperyr
    pmdec_v = p.get("PMDEC", 0.0) * masrad * d / secperyr
    s = p["s"]

    vp_ra = _fn("sin", KOM) * vp_x + _fn("cos", KOM) * vp_y
    vp_dec = _fn("cos", KOM) * vp_x - _fn("sin", KOM) * vp_y
    veff_ra = s * vearth_ra + (1 - s) * (vp_ra + pmra_v)
    veff_dec = s * vearth_dec + (1 - s) * (vp_dec + pmdec_v)
    return veff_ra, veff_dec, vp_ra, vp_dec


def arc_curvature(params, ydata, weights, true_anomaly, vearth_ra,
                  vearth_dec, mjd=None, model_only=False,
                  return_veff=False):
    """Arc curvature η = d·s(1 − s)/(2·veff²)/1e9 [1/(m mHz²)], isotropic
    or projected on the anisotropy angle ``zeta``; residuals
    (ydata − η)·weights unless ``model_only``."""
    p = _vals(params)
    if "psi" in p:
        raise KeyError("parameter psi is no longer supported. "
                       "Please use zeta")
    if "vism_psi" in p:
        raise KeyError("parameter vism_psi is no longer supported. "
                       "Please use vism_zeta")
    dkm = p["d"] * KM_PER_KPC
    s = p["s"]
    veff_ra, veff_dec, _, _ = effective_velocity_annual(
        params, true_anomaly, vearth_ra, vearth_dec, mjd=mjd)

    nmodel = p.get("nmodel", 1 if "zeta" in p else 0)
    vism_ra = p.get("vism_ra", 0)
    vism_dec = p.get("vism_dec", 0)
    if nmodel > 0.5:  # anisotropic
        zeta = p["zeta"] * np.pi / 180
        if "vism_zeta" in p:
            veff2 = (veff_ra * _fn("sin", zeta) + veff_dec * _fn("cos", zeta)
                     - p["vism_zeta"]) ** 2
        else:
            veff2 = ((veff_ra - vism_ra) * _fn("sin", zeta)
                     + (veff_dec - vism_dec) * _fn("cos", zeta)) ** 2
    else:
        veff2 = (veff_ra - vism_ra) ** 2 + (veff_dec - vism_dec) ** 2

    model = dkm * s * (1 - s) / (2 * veff2) / 1e9
    if model_only:
        if return_veff:
            return model, (veff_ra - vism_ra), (veff_dec - vism_dec)
        return model
    if weights is None:
        weights = 1.0
    return (ydata - model) * weights


def veff_thin_screen(params, ydata, weights, true_anomaly, vearth_ra,
                     vearth_dec, mjd=None):
    """Thin-screen scintillation-velocity model (Rickett et al. 2014,
    Eq. 4), isotropic or with the anisotropy (R, psi); residuals
    (ydata − model)·weights."""
    p = _vals(params)
    s, d = p["s"], p["d"]
    kappa = p.get("kappa", 1)
    veff_ra, veff_dec, _, _ = effective_velocity_annual(
        params, true_anomaly, vearth_ra, vearth_dec, mjd=mjd)
    nmodel = p.get("nmodel", 1 if "psi" in p else 0)
    veff_ra = veff_ra - p.get("vism_ra", 0)
    veff_dec = veff_dec - p.get("vism_dec", 0)
    if nmodel > 0.5:
        R = p["R"]
        psi = p["psi"] * np.pi / 180
        cosa, sina = _fn("cos", 2 * psi), _fn("sin", 2 * psi)
        a = (1 - R * cosa) / _fn("sqrt", 1 - R ** 2)
        b = (1 + R * cosa) / _fn("sqrt", 1 - R ** 2)
        c = -2 * R * sina / _fn("sqrt", 1 - R ** 2)
    else:
        a, b, c = 1, 1, 0
    coeff = 1 / _fn("sqrt", 2 * d * (1 - s) / s)
    veff = kappa * _fn("sqrt", a * veff_dec ** 2 + b * veff_ra ** 2
                       + c * veff_ra * veff_dec)
    model = coeff * veff / s
    if weights is None:
        weights = 1.0
    return (ydata - model) * weights


# --------------------------------------------------------------------------
# weak-scintillation arc models
# --------------------------------------------------------------------------

def _aniso_coeffs(ar, psi):
    cs, sn = np.cos(psi * np.pi / 180), np.sin(psi * np.pi / 180)
    a = cs ** 2 / ar + ar * sn ** 2
    b = ar * cs ** 2 + sn ** 2 / ar
    c = 2 * sn * cs * (1 / ar - ar)
    return a, b, c


def arc_weak(ftn, ar=1, psi=0, alpha=11 / 3):
    """1-D weak-scintillation Doppler profile over the normalised f_D
    ``ftn``."""
    a, b, c = _aniso_coeffs(ar, psi)
    root = (1 - ftn ** 2) ** 0.5
    p = ((a * ftn ** 2 + b * (1 - ftn ** 2) + c * ftn * root)
         ** (-alpha / 2)
         + (a * ftn ** 2 + b * (1 - ftn ** 2) - c * ftn * root)
         ** (-alpha / 2))
    return p / root


def arc_weak_2d(fdop, tdel, eta=1, ar=1, psi=0, alpha=11 / 3):
    """2-D weak-scintillation model secondary spectrum on the (tdel,
    fdop) grid (NaN outside the arc)."""
    xp = _lib(fdop, tdel)
    a, b, c = _aniso_coeffs(ar, psi)
    if xp is torch:
        fdx, TDEL = torch.meshgrid(fdop, tdel, indexing="xy")
    else:
        fdx, TDEL = np.meshgrid(np.asarray(fdop), np.asarray(tdel))
    f_arc = xp.sqrt(TDEL / eta)
    fdy = xp.sqrt(TDEL / eta - fdx ** 2)
    p = ((a * fdx ** 2 + b * fdy ** 2 + c * fdx * fdy) ** (-11 / 6)
         + (a * fdx ** 2 + b * fdy ** 2 - c * fdx * fdy) ** (-11 / 6))
    arc_frac = xp.real(fdx) / xp.real(f_arc)
    return p / xp.sqrt(1 - arc_frac ** 2)
