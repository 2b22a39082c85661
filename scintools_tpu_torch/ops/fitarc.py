"""Scintillation-arc curvature measurement (Hough-style η grid search).

Counterpart of ``scintools_tpu/ops/fitarc.py``: ``ArcFit`` (:26),
``sspec_noise`` (:42), ``sspec_noise_batch`` (:54), ``_profile_from_norm``
(:91), ``fit_arc_profile`` (:105), ``_prep_profile`` (:125),
``_peak_parabola`` (:141), ``fit_arc`` (:207) and ``fit_arc_batch``
(:281, with its per-geometry cache of built functions, :23 and
:362-413). Normalise the secondary spectrum for a trial curvature,
delay-scrunch to a Doppler profile and fit a parabola to the profile
peak over a √η grid. The serial :func:`fit_arc` interpolates the rows on
the device and fits on the host; :func:`fit_arc_batch` computes every
epoch's profile with the arc-profile kernel and, by default, the whole
peak fit on the device too.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy.signal import savgol_filter

from ..backend import as_tensor, fifo_cached, resolve_device
from ..obs import retrace as _retrace
from ..fit.models import fit_log_parabola, fit_parabola
from .normsspec import make_arc_profile_batch_fn, normalise_sspec

# fit_arc_batch's built functions and their device grids, keyed on the
# geometry, the fit parameters and the device (FIFO of 8); every miss
# adds one to ``builds``
_ARC_FIT_CACHE = {}
_ARC_FIT_CACHE_SIZE = 8
ARC_FIT_CACHE_STATS = {"builds": 0}


@dataclass
class ArcFit:
    """Result of a single arc-curvature fit."""

    eta: float
    etaerr: float          # noise-based error (or parabola error)
    etaerr2: float         # parabola-fit error
    eta_array: np.ndarray  # η grid searched
    profile: np.ndarray    # delay-scrunched power profile over η grid
    norm_fdop: np.ndarray  # normalised fdop axis of the profile
    noise: float
    prob_eta_peak: np.ndarray = None
    yfit: np.ndarray = None
    xdata: np.ndarray = None


def sspec_noise(sspec, cutmid, n_rows):
    """Noise estimate from the outer quadrants of the secondary
    spectrum."""
    nr, nc = np.shape(sspec)
    a = np.asarray(sspec)[int(nr / 2):,
                          int(nc / 2 + np.ceil(cutmid / 2)):].ravel()
    b = np.asarray(sspec)[int(nr / 2):,
                          0:int(nc / 2 - np.floor(cutmid / 2))].ravel()
    noise = np.std(np.concatenate((a, b)))
    return noise / np.sqrt(n_rows * 2)


def sspec_noise_batch(sspecs, cutmid, n_rows):
    """:func:`sspec_noise` over an epoch batch, a ``[B, nr, nc]`` tensor,
    on its device and in its dtype: the two quadrants' two-pass moments
    pooled into the concatenated population std, without the copy."""
    _, nr, nc = sspecs.shape
    a = sspecs[:, int(nr / 2):, int(nc / 2 + np.ceil(cutmid / 2)):]
    b = sspecs[:, int(nr / 2):, 0:int(nc / 2 - np.floor(cutmid / 2))]
    na, nb = a.shape[1] * a.shape[2], b.shape[1] * b.shape[2]
    n = na + nb
    if n == 0:
        return torch.full((sspecs.shape[0],), float("nan"),
                          dtype=sspecs.dtype, device=sspecs.device)
    zeros = torch.zeros(sspecs.shape[0], dtype=sspecs.dtype,
                        device=sspecs.device)
    mu_a = a.mean(dim=(1, 2)) if na else zeros
    mu_b = b.mean(dim=(1, 2)) if nb else zeros
    var_a = a.var(dim=(1, 2), unbiased=False) if na else zeros
    var_b = b.var(dim=(1, 2), unbiased=False) if nb else zeros
    mu = (na * mu_a + nb * mu_b) / n
    var = (na * (var_a + (mu_a - mu) ** 2)
           + nb * (var_b + (mu_b - mu) ** 2)) / n
    return torch.sqrt(var) / np.sqrt(n_rows * 2)


def _profile_from_norm(ns, asymm=False):
    """Fold the scrunched profile about fdop = 0."""
    prof = np.asarray(ns.normsspecavg).squeeze()
    fdopnew = np.asarray(ns.fdop).squeeze()
    pos = fdopnew >= 0
    p_pos = prof[pos]
    p_neg = np.flip(prof[fdopnew < 0])
    etafrac = 1.0 / fdopnew[pos]
    if asymm:
        return [p_pos, p_neg], etafrac
    return [(p_pos + p_neg) / 2], etafrac


def fit_arc_profile(spec, etafrac, etamin, etamax, constraint=(0, np.inf),
                    nsmooth=5, low_power_diff=-1, high_power_diff=-0.5,
                    noise=0.0, noise_error=True, log_parabola=False, efac=1):
    """Peak search + parabola fit on one folded profile."""
    spec, eta_array = _prep_profile(spec, etafrac, etamin, etamax)
    if len(spec) <= nsmooth:
        raise ValueError(
            f"profile has only {len(spec)} valid points — too few for "
            f"smoothing window nsmooth={nsmooth}")
    smoothed = savgol_filter(spec, nsmooth, 1)
    return _peak_parabola(spec, smoothed, eta_array, constraint=constraint,
                          low_power_diff=low_power_diff,
                          high_power_diff=high_power_diff, noise=noise,
                          noise_error=noise_error, log_parabola=log_parabola,
                          efac=efac)


def _prep_profile(spec, etafrac, etamin, etamax):
    """Finite mask, flip to ascending η, crop at etamax (shared by the
    serial and batch paths)."""
    spec = np.asarray(spec).squeeze()
    etafrac = np.asarray(etafrac).squeeze()
    valid = np.isfinite(spec)
    spec = np.flip(spec[valid])
    etafrac = np.flip(etafrac[valid])
    eta_array = float(etamin) * etafrac ** 2
    sel = eta_array < float(etamax)
    return spec[sel], eta_array[sel]


def _peak_parabola(spec, smoothed, eta_array, constraint=(0, np.inf),
                   low_power_diff=-1, high_power_diff=-0.5, noise=0.0,
                   noise_error=True, log_parabola=False, efac=1):
    """Peak walk-out + parabola fit on an already-smoothed profile. The
    left power walk is bounded at the array start (the reference bounds
    it by the right edge); the device tail keeps this host form."""
    inrange = np.flatnonzero((eta_array > constraint[0])
                             & (eta_array < constraint[1]))
    if len(inrange) == 0:
        raise ValueError("no η grid points inside constraint range")
    max_in = np.max(smoothed[inrange])
    ind = int(np.argmin(np.abs(smoothed - max_in)))

    max_power = smoothed[ind]
    power = max_power
    i1 = 1
    while power > max_power + low_power_diff and ind - i1 > 0:
        i1 += 1
        power = smoothed[ind - i1]
    power = max_power
    i2 = 1
    while (power > max_power + high_power_diff
           and ind + i2 < len(smoothed) - 1):
        i2 += 1
        power = smoothed[ind + i2]

    xdata = eta_array[int(ind - i1):int(ind + i2)]
    ydata = spec[int(ind - i1):int(ind + i2)]
    if log_parabola:
        yfit, eta, etaerr = fit_log_parabola(xdata, ydata)
    else:
        yfit, eta, etaerr = fit_parabola(xdata, ydata)
    if np.mean(np.gradient(np.diff(yfit))) > 0:
        raise ValueError("Fit returned a forward parabola.")

    etaerr2 = etaerr
    if noise_error:
        power = max_power
        i1 = 1
        while power > (max_power - noise) and (ind - i1 > 1):
            power = smoothed[ind - i1]
            i1 += 1
        power = max_power
        i2 = 1
        while (power > (max_power - noise)
               and (ind + i2 < len(smoothed) - 1)):
            i2 += 1
            power = smoothed[ind + i2]
        etaerr = np.abs(eta_array[int(ind - i1)]
                        - eta_array[int(ind + i2)]) / 2

    sigma = noise * efac
    with np.errstate(divide="ignore", invalid="ignore"):
        prob = (1 / (sigma * np.sqrt(2 * np.pi))
                * np.exp(-0.5 * ((spec - np.max(spec)) / sigma) ** 2))

    # every curvature error is stored divided by sqrt(2), as the
    # reference does
    return ArcFit(eta=float(eta), etaerr=float(etaerr) / np.sqrt(2),
                  etaerr2=float(etaerr2) / np.sqrt(2), eta_array=eta_array,
                  profile=spec, norm_fdop=None, noise=noise,
                  prob_eta_peak=prob, yfit=yfit, xdata=xdata)


def _check_eta_bounds(etamin, etamax):
    if etamin is not None and np.any(np.asarray(etamin) <= 0):
        raise ValueError("etamin must be positive (curvature is η > 0)")
    if etamax is not None and np.any(np.asarray(etamax) <= 0):
        raise ValueError("etamax must be positive (curvature is η > 0)")


def fit_arc(sspec, yaxis, fdop, asymm=False, delmax=None, numsteps=1e4,
            startbin=3, cutmid=3, etamax=None, etamin=None,
            low_power_diff=-1, high_power_diff=-0.5, constraint=(0, np.inf),
            nsmooth=5, efac=1, noise_error=True, log_parabola=False,
            logsteps=False, fit_spectrum=False, subtract_artefacts=False,
            weighted=False, device=None):
    """Arc-curvature measurement on a (dB) secondary spectrum, in one
    curvature convention: ``yaxis`` is the delay-like axis (β [m⁻¹] for
    λ-scaled spectra, else tdel [µs]) with yaxis = η·fdop². The rows
    are interpolated on ``device``. Returns a list of :class:`ArcFit`
    (two when ``asymm``)."""
    sspec = np.array(sspec, dtype=float)
    yaxis = np.asarray(yaxis, dtype=float)
    _check_eta_bounds(etamin, etamax)
    if int(numsteps) <= 2 * nsmooth:
        raise ValueError(
            f"numsteps={int(numsteps)} too coarse for the smoothing "
            f"window (nsmooth={nsmooth}); increase numsteps")
    delmax = np.max(yaxis) if delmax is None else delmax
    ind = int(np.argmin(np.abs(yaxis - delmax)))
    ymax = yaxis[ind]
    noise = sspec_noise(sspec, cutmid, n_rows=ind)
    if etamax is None:
        etamax = ymax / ((fdop[1] - fdop[0]) * cutmid) ** 2
    if etamin is None:
        etamin = (yaxis[1] - yaxis[0]) * startbin / np.max(fdop) ** 2

    etamin_array = np.atleast_1d(np.asarray(etamin, dtype=float))
    etamax_array = np.atleast_1d(np.asarray(etamax, dtype=float))
    sqrt_eta_all = np.linspace(np.sqrt(np.min(etamin_array)),
                               np.sqrt(np.max(etamax_array)), int(numsteps))

    fits = []
    for emin, emax in zip(etamin_array, etamax_array):
        sqrt_eta = sqrt_eta_all[(sqrt_eta_all <= np.sqrt(emax))
                                & (sqrt_eta_all >= np.sqrt(emin))]
        ns = normalise_sspec(sspec, yaxis, fdop, eta=float(emin),
                             delmax=delmax, startbin=startbin, maxnormfac=1,
                             cutmid=cutmid, numsteps=len(sqrt_eta),
                             logsteps=logsteps, weighted=weighted,
                             fit_spectrum=fit_spectrum,
                             subtract_artefacts=subtract_artefacts,
                             device=device)
        specs, etafrac = _profile_from_norm(ns, asymm=asymm)
        for spec in specs:
            fit = fit_arc_profile(
                spec, etafrac, float(emin), float(emax),
                constraint=constraint, nsmooth=nsmooth,
                low_power_diff=low_power_diff,
                high_power_diff=high_power_diff, noise=noise,
                noise_error=noise_error, log_parabola=log_parabola,
                efac=efac)
            fit.norm_fdop = ns.fdop
            fits.append(fit)
    return fits


def _arc_fit_fn(yaxis, fdop, delmax, startbin, cutmid, numsteps, nsmooth,
                low_power_diff, high_power_diff, constraint, noise_error,
                on_device, dev, mesh=None):
    """The built function of :func:`fit_arc_batch` for one geometry and
    set of fit parameters on ``dev``: the whole device fit
    (``on_device``) or the folded profiles for the host tail; with
    ``mesh`` its sharded form (:func:`~..parallel.survey.
    make_arc_fit_sharded`, :func:`~..parallel.survey.
    make_arc_profile_sharded`). Built on the first call and kept, with
    its device grids, in a FIFO of 8."""
    fit_key = ((int(nsmooth), float(low_power_diff), float(high_power_diff),
                tuple(map(float, constraint)), bool(noise_error))
               if on_device else None)
    key = (yaxis.tobytes(), fdop.tobytes(), float(delmax), int(startbin),
           int(cutmid), int(numsteps), fit_key, bool(on_device), str(dev),
           None if mesh is None else mesh.key)

    def build():
        ARC_FIT_CACHE_STATS["builds"] += 1
        _retrace.record_build("ops.arc_fit_device", key)
        if mesh is not None:
            from ..parallel import survey as par_survey

            if not on_device:
                return par_survey.make_arc_profile_sharded(
                    mesh, yaxis, fdop, delmax=delmax, startbin=startbin,
                    cutmid=cutmid, numsteps=numsteps, fold=True)[0]
            return par_survey.make_arc_fit_sharded(
                mesh, yaxis, fdop, delmax=delmax, startbin=startbin,
                cutmid=cutmid, numsteps=numsteps, nsmooth=nsmooth,
                low_power_diff=low_power_diff,
                high_power_diff=high_power_diff, constraint=constraint,
                noise_error=noise_error)[0]
        if not on_device:
            return make_arc_profile_batch_fn(
                yaxis, fdop, delmax=delmax, startbin=startbin,
                cutmid=cutmid, numsteps=numsteps, fold=True, device=dev)
        from .fitarc_device import make_arc_fit_batch_fn

        return make_arc_fit_batch_fn(
            yaxis, fdop, delmax=delmax, startbin=startbin, cutmid=cutmid,
            numsteps=numsteps, nsmooth=nsmooth,
            low_power_diff=low_power_diff, high_power_diff=high_power_diff,
            constraint=constraint, noise_error=noise_error, device=dev)

    return fifo_cached(_ARC_FIT_CACHE, key, build, _ARC_FIT_CACHE_SIZE)


def fit_arc_batch(sspecs, yaxis, fdop, delmax=None, numsteps=1e4,
                  startbin=3, cutmid=3, etamax=None, etamin=None,
                  low_power_diff=-1, high_power_diff=-0.5,
                  constraint=(0, np.inf), nsmooth=5, efac=1,
                  noise_error=True, log_parabola=False, mesh=None,
                  sspecs_device=None, on_device=None, full_output=True,
                  device=None):
    """Arc-curvature fit over a batch of same-geometry epochs.

    ``sspecs[B, ntdel, nfdop]`` in dB, a numpy array or a tensor on any
    device (a contiguous float32 tensor on ``device`` is used in place,
    so a survey keeps its epochs resident), with shared axes ``yaxis``
    (µs or m⁻¹) and ``fdop`` (mHz); ``etamin``/``etamax`` scalars or
    per-epoch arrays. Returns a list of B :class:`ArcFit` (NaN η for an
    epoch the fit refuses). The profiles of all epochs come from one
    call of the arc-profile kernel on ``device`` (its plain version on
    the CPU). The function this builds and its device grids are kept per
    geometry, fit parameters and device (a FIFO of 8), so a survey's
    later batches build nothing (``ARC_FIT_CACHE_STATS``).

    ``sspecs_device`` is the JAX package's name for spectra already on
    the device: given alone it stands for ``sspecs``; given with
    ``sspecs``, the two must have one shape. ``on_device`` (default:
    True unless ``log_parabola``) runs the peak fit on the device too
    and fetches ten numbers per epoch; ``on_device=False`` runs the
    float64 host tail on the fetched profiles. With the device tail,
    ``full_output=False`` skips the profile fetch and leaves the
    diagnostic fields (profile, eta_array, prob_eta_peak, xdata, yfit)
    None. ``mesh`` (:func:`~..parallel.mesh.make_mesh`) splits the
    epochs over its devices, one kernel launch per shard, and gathers on
    its first device (``device`` is then the mesh's); every epoch's fit
    is what it is without the mesh."""
    if mesh is not None:
        device = mesh.first
    dev = resolve_device(device)
    if sspecs_device is not None:
        if sspecs is not None and \
                tuple(sspecs_device.shape) != tuple(np.shape(sspecs)):
            raise ValueError(
                f"sspecs_device shape {tuple(sspecs_device.shape)} != "
                f"sspecs shape {tuple(np.shape(sspecs))} — they must be "
                "the same epoch batch")
        sspecs = sspecs_device
    B = len(sspecs)
    yaxis = np.asarray(yaxis, dtype=float)
    fdop = np.asarray(fdop, dtype=float)
    _check_eta_bounds(etamin, etamax)
    # even grid: the ±fdop fold pairs bins about zero
    numsteps = int(numsteps) + int(numsteps) % 2
    if numsteps <= 2 * nsmooth:
        raise ValueError(
            f"numsteps={numsteps} too coarse for the smoothing "
            f"window (nsmooth={nsmooth}); increase numsteps")
    delmax = np.max(yaxis) if delmax is None else delmax
    ind = int(np.argmin(np.abs(yaxis - delmax)))
    ymax = yaxis[ind]
    if etamax is None:
        etamax = ymax / ((fdop[1] - fdop[0]) * cutmid) ** 2
    if etamin is None:
        etamin = (yaxis[1] - yaxis[0]) * startbin / np.max(fdop) ** 2
    etamin_b = np.broadcast_to(np.asarray(etamin, dtype=float), (B,)).copy()
    etamax_b = np.broadcast_to(np.asarray(etamax, dtype=float), (B,)).copy()
    if on_device is None:
        on_device = not log_parabola
    if on_device and log_parabola:
        raise ValueError("log_parabola is host-only — pass on_device=False")

    s_dev = as_tensor(sspecs, dev)
    e_dev = as_tensor(etamin_b, dev, torch.float64)
    fn = _arc_fit_fn(yaxis, fdop, delmax, startbin, cutmid, numsteps,
                     nsmooth, low_power_diff, high_power_diff, constraint,
                     noise_error, on_device, dev, mesh=mesh)

    if on_device:
        from .fitarc_device import eta_crop_lengths, eta_grid

        # a non-finite pixel would make the host crop reshape that
        # epoch's η grid; such epochs get L = 0 and come out NaN
        # (on the device: a host test would stall the queue mid-fit)
        Ls = torch.where(torch.isfinite(s_dev).flatten(1).all(dim=1),
                         as_tensor(eta_crop_lengths(numsteps, etamin_b,
                                                    etamax_b), dev,
                                   torch.int64), 0)
        packed, folded_dev = fn(s_dev, e_dev, Ls)
        out = packed.cpu().numpy()
        _, fdopnew = eta_grid(numsteps)
        with np.errstate(divide="ignore"):
            etafrac_f = 1.0 / fdopnew[fdopnew >= 0]
        folded = folded_dev.cpu().numpy() if full_output else None
        fits = []
        for b in range(B):
            (eta_b, err_b, err2_b, noise_b, lo_b, n_b, a2_b, a1_b, a0_b,
             scale_b) = out[b].astype(float)
            fit = ArcFit(eta=eta_b, etaerr=err_b, etaerr2=err2_b,
                         eta_array=None, profile=None, norm_fdop=fdopnew,
                         noise=noise_b)
            if full_output:
                spec = folded[b]
                spec_s, eta_s = _prep_profile(spec, etafrac_f, etamin_b[b],
                                              etamax_b[b])
                if np.isfinite(eta_b):
                    fit.profile, fit.eta_array = spec_s, eta_s
                    sigma = noise_b * efac
                    with np.errstate(divide="ignore", invalid="ignore"):
                        fit.prob_eta_peak = (
                            1 / (sigma * np.sqrt(2 * np.pi))
                            * np.exp(-0.5 * ((spec_s - np.max(spec_s))
                                             / sigma) ** 2))
                    # fit_parabola's diagnostics from the packed window
                    # and the xs-parameterised coefficients
                    lo_i, n_i = int(lo_b), int(n_b)
                    fit.xdata = eta_s[lo_i:lo_i + n_i]
                    xs = fit.xdata * scale_b
                    fit.yfit = a2_b * xs ** 2 + a1_b * xs + a0_b
                else:
                    # quarantined: the unflipped profile with its
                    # descending η axis, as the host path returns it
                    fit.profile = spec
                    fit.eta_array = float(etamin_b[b]) * etafrac_f ** 2
            fits.append(fit)
        return fits

    folded = fn(s_dev, e_dev).cpu().numpy().astype(float)
    noises = sspec_noise_batch(
        as_tensor(sspecs, "cpu", torch.float64), cutmid, n_rows=ind).numpy()
    fdopnew = np.linspace(-1.0, 1.0, numsteps)
    with np.errstate(divide="ignore"):
        etafrac = 1.0 / fdopnew[fdopnew >= 0]

    def nan_fit(b, spec):
        # one arc-free epoch must not kill the batch: NaN, as a survey
        # sorter quarantines it
        return ArcFit(eta=np.nan, etaerr=np.nan, etaerr2=np.nan,
                      eta_array=float(etamin_b[b]) * etafrac ** 2,
                      profile=spec, norm_fdop=fdopnew, noise=noises[b])

    # savgol once per group of equal-length profiles (row-wise it is
    # scipy's 1-D computation)
    prepped = {}
    fits = [None] * B
    for b in range(B):
        spec_s, eta_s = _prep_profile(folded[b], etafrac, etamin_b[b],
                                      etamax_b[b])
        if len(spec_s) <= nsmooth:
            fits[b] = nan_fit(b, folded[b])
            continue
        prepped.setdefault(len(spec_s), []).append(
            (b, folded[b], spec_s, eta_s))
    for items in prepped.values():
        smoothed = savgol_filter(np.stack([it[2] for it in items]), nsmooth,
                                 1, axis=-1)
        for (b, spec, spec_s, eta_s), sm_row in zip(items, smoothed):
            try:
                fit = _peak_parabola(
                    spec_s, sm_row, eta_s, constraint=constraint,
                    low_power_diff=low_power_diff,
                    high_power_diff=high_power_diff, noise=noises[b],
                    noise_error=noise_error, log_parabola=log_parabola,
                    efac=efac)
                fit.norm_fdop = fdopnew
                fits[b] = fit
            except ValueError:
                fits[b] = nan_fit(b, spec)
    return fits
