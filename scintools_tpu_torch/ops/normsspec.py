"""Arc-normalised secondary spectrum (the arc fit's workhorse).

Counterpart of ``scintools_tpu/ops/normsspec.py``: ``NormSspec`` (:31),
``scaled_row_interp`` (:58), ``make_arc_profile_batch_fn`` (:105) and
``normalise_sspec`` (:295). Each delay row i is sampled at the original
Doppler ``fdopnew·√(tdel_i/η)``; a point is masked outside the row's
renormalised data support or where the interpolation is NaN.

Two interpolations live here, as in the JAX package, and they differ
in two places (both pinned in ``tests/test_torch_arc.py``):

- the serial path (:func:`scaled_row_interp`, used by
  :func:`normalise_sspec` and so by ``fit_arc``) follows ``np.interp``:
  on a uniform grid a gather of the two neighbours with ``i0`` clipped
  to ``nc − 2``, so a NaN neighbour poisons a query even at zero
  weight, exactly as the JAX gather formulation does;
- the batch path (:func:`make_arc_profile_batch_fn`, used by
  ``fit_arc_batch``) follows the tent of the TPU kernel: only bins of
  positive weight count, and the right edge is tap ``nc − 1`` alone.
  A CUDA tensor runs the hand-written kernel ``ops/arc_profile.py``;
  a CPU tensor its plain version. ``pallas=False`` (the JAX package's
  XLA route) runs no kernel and takes the ``ops.arc_profile_interp``
  formulation (the JAX package's :24, registered here): ``"tent"`` the
  kernel's plain version, ``"gather"`` the serial path's index gather.

The serial path interpolates in float64 (its host tail is float64
numpy, as in the JAX package); the batch path in float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..backend import (REAL, as_tensor, formulation, register_formulation,
                       resolve_device)
from ..fit.fitter import fitter
from ..fit.models import powerspectrum_model
from ..fit.parameters import Parameters
from .arc_profile import arc_profile, arc_profile_rows_plain
from .interp import interp_nan_2d


register_formulation(
    "ops.arc_profile_interp", default="tent", choices=("tent", "gather"),
    platforms={"cpu": "tent", "cuda": "tent"},
    doc="arc-normalised profile interpolation without the kernel: the "
        "kernel's tent arithmetic vs the serial path's index gather")


@dataclass
class NormSspec:
    """Result record for a normalised secondary spectrum."""

    normsspecavg: np.ndarray     # delay-scrunched Doppler profile
    normsspec: np.ndarray        # (ntdel, nfdop) normalised spectrum
    mask: np.ndarray             # True where outside data support / NaN
    tdel: np.ndarray             # delay axis used (cropped)
    fdop: np.ndarray             # normalised fdop axis
    powerspectrum: np.ndarray    # masked mean linear power per delay row
    weights: np.ndarray          # per-row weights used for the average
    ps_wn: float = None          # the power-spectrum fit (fit_spectrum)
    ps_amp: float = None
    ps_alpha: float = None
    ps_wn_err: float = None
    ps_amp_err: float = None
    ps_alpha_err: float = None


def _is_uniform(fdop):
    d = np.diff(fdop)
    return bool(d.size) and bool(np.allclose(d, d[0], rtol=1e-6))


def _interp_any_grid(xq, xp, fp):
    """``jnp.interp`` row by row: ``fp[M, n]`` over the shared ascending
    axis ``xp[n]``, sampled at ``xq[M, Q]``; ends clamp to the end
    values and a NaN neighbour poisons its span."""
    n = xp.shape[0]
    i = torch.searchsorted(xp, xq.contiguous(), right=True).clamp(1, n - 1)
    fl = torch.gather(fp, 1, i - 1)
    fr = torch.gather(fp, 1, i)
    dx = xp[i] - xp[i - 1]
    dx0 = dx.abs() <= np.spacing(np.finfo(np.float64).eps)
    f = torch.where(dx0, fl, fl + ((xq - xp[i - 1])
                                   / torch.where(dx0, 1.0, dx)) * (fr - fl))
    f = torch.where(xq < xp[0], fp[:, :1], f)
    return torch.where(xq > xp[-1], fp[:, -1:], f)


def _uniform_interp(xq, fdop, s):
    """``np.interp`` of the rows ``s[M, n]`` over the uniform ascending
    axis ``fdop`` at ``xq[M, Q]`` as index arithmetic and two gathers:
    w = 0/1 at the ends selects y[0]/y[-1], and a NaN neighbour poisons
    the query even at zero weight (NaN·0), as np.interp's spans and the
    JAX gather formulation do. Float64 tensors on one device."""
    # (a tensor divisor: a division by a Python scalar may multiply by
    # its reciprocal, which moves floor(pos) at integers)
    step = torch.full((), fdop[1] - fdop[0], dtype=torch.float64,
                      device=xq.device)
    pos = (xq - fdop[0]) / step
    i0 = pos.floor().long().clamp(0, len(fdop) - 2)
    w = (pos - i0).clamp(0.0, 1.0)
    return torch.gather(s, 1, i0) * (1 - w) + torch.gather(s, 1, i0 + 1) * w


def scaled_row_interp(sspec, fdop, tdel, eta, fdopnew, device=None):
    """Sample each delay row of ``sspec[ntdel, nfdop]`` at the original
    Doppler ``fdopnew·√(tdel_i/η)``, in float64 on ``device``.

    Returns ``(norm[ntdel, nq], mask[ntdel, nq])`` tensors; ``mask``
    marks points outside each row's renormalised data support
    (``|fdopnew|·√(tdel_i/η) > max|fdop|``) or with a NaN value."""
    dev = resolve_device(device)
    s = as_tensor(sspec, dev, dtype=torch.float64)
    fdop = np.asarray(fdop, dtype=float)
    scale = torch.sqrt(as_tensor(tdel, dev, dtype=torch.float64) / eta)
    fq = as_tensor(fdopnew, dev, dtype=torch.float64)
    xq = fq[None, :] * scale[:, None]
    if _is_uniform(fdop):
        norm = _uniform_interp(xq, fdop, s)
    else:
        norm = _interp_any_grid(xq, as_tensor(fdop, dev, torch.float64), s)
    sup = xq.abs() > float(np.max(np.abs(fdop)))
    return norm, sup | torch.isnan(norm)


def make_arc_profile_batch_fn(tdel, fdop, delmax=None, startbin=1, cutmid=0,
                              numsteps=10000, maxnormfac=1, fold=False,
                              pallas=None, device=None):
    """Batched arc-normalised Doppler profile on ``device``:
    ``fn(sspecs[B, ntdel, nfdop], etas[B]) → profiles[B, numsteps]``
    float32, the delay-scrunched profile of ``normalise_sspec(...,
    maxnormfac, weighted=False)`` for every epoch of a same-geometry
    batch (0.0 where no delay row contributes). ``numsteps`` is rounded
    up to even. With ``fold=True`` the ±fdop halves are averaged about
    zero and the output is ``[B, numsteps//2]`` over the fdopnew ≥ 0
    bins.

    ``pallas`` (``None``: on where the grid allows it): a uniform Doppler
    grid goes through one call of :func:`~.arc_profile.arc_profile` (the
    kernel on a CUDA device, which reads the rows, the NaN mask and the
    cut in place; its plain version on the CPU); ``pallas=True`` on any
    other grid raises ``ValueError``. Otherwise the
    ``ops.arc_profile_interp`` formulation on ``device`` decides, as on
    the JAX package's XLA route: ``"tent"`` takes the kernel's plain
    version on a uniform grid, ``"gather"`` the serial path's index
    gather; any other grid takes the ``jnp.interp``-semantics row
    interpolation. ``fn.kernel_args(sspecs, etas)`` gives the kernel's
    arguments."""
    dev = resolve_device(device)
    tdel = np.asarray(tdel, dtype=float)
    fdop = np.asarray(fdop, dtype=float)
    delmax = np.max(tdel) if delmax is None else delmax
    ind = int(np.argmin(np.abs(tdel - delmax)))
    tdel_c = tdel[startbin:ind]
    nc = len(fdop)
    # the cut columns [c0, c1), as the slice of the JAX package selects
    c0, c1 = slice(int(nc / 2 - np.floor(cutmid / 2)),
                   int(nc / 2 + np.floor(cutmid / 2))).indices(nc)[:2] \
        if cutmid > 0 else (0, 0)
    cut = (c0, max(c0, c1))
    numsteps = int(numsteps) + int(numsteps) % 2
    fdopnew = np.linspace(-maxnormfac, maxnormfac, numsteps)
    uniform = _is_uniform(fdop)
    if pallas and not uniform:
        raise ValueError("pallas=True needs a uniform Doppler grid (the "
                         "tent kernel assumes index arithmetic); this axis "
                         "is non-uniform")
    route = "kernel" if uniform and pallas in (None, True) else (
        formulation("ops.arc_profile_interp", dev.type) if uniform
        else "any")
    f0 = float(fdop[0])
    dfd = float(np.mean(np.diff(fdop))) if nc > 1 else 1.0
    fmax = float(np.max(np.abs(fdop)))
    tdel_t = as_tensor(tdel_c, dev, dtype=torch.float64)
    fq = as_tensor(fdopnew, dev)
    fq64 = as_tensor(fdopnew, dev, dtype=torch.float64)
    fdop64 = as_tensor(fdop, dev, dtype=torch.float64)
    pos = torch.as_tensor(np.flatnonzero(fdopnew >= 0), device=dev)
    neg = torch.as_tensor(np.flatnonzero(fdopnew < 0)[::-1].copy(),
                          device=dev)

    def scales_of(etas):
        """``√(tdel_r/η_b)`` in float64."""
        return torch.sqrt(tdel_t[None, :]
                          / as_tensor(etas, dev, torch.float64)[:, None])

    def kernel_args(sspecs, etas):
        """The arguments :func:`~.arc_profile.arc_profile` gets: the
        spectra as they are and the scales rounded once to float32."""
        return (as_tensor(sspecs, dev), scales_of(etas).to(REAL), fq,
                startbin, cut, f0, dfd, fmax)

    def base(sspecs, etas):
        if route == "kernel":
            return arc_profile(*kernel_args(sspecs, etas))
        if route == "tent":
            return arc_profile_rows_plain(*kernel_args(sspecs, etas))
        s = as_tensor(sspecs, dev)[:, startbin:ind, :]
        if cut[1] > cut[0]:
            s = s.clone()
            s[:, :, cut[0]:cut[1]] = float("nan")
        scales = scales_of(etas)
        B, R, _ = s.shape
        xq = (scales[:, :, None] * fq64).reshape(B * R, -1)
        rows = s.reshape(B * R, nc).double()
        norm = (_uniform_interp(xq, fdop, rows) if route == "gather"
                else _interp_any_grid(xq, fdop64, rows))
        ok = ~((xq.abs() > fmax) | torch.isnan(norm))
        num = torch.where(ok, norm, 0.0).reshape(B, R, -1).sum(dim=1)
        den = ok.reshape(B, R, -1).sum(dim=1)
        return torch.where(den > 0, num / den.clamp_min(1), 0.0).to(REAL)

    if not fold:
        base.kernel_args = kernel_args
        return base

    def folded(sspecs, etas):
        profs = base(sspecs, etas)
        return (profs[:, pos] + profs[:, neg]) / 2

    folded.kernel_args = kernel_args
    return folded


def normalise_sspec(sspec, tdel, fdop, eta, delmax=None, startbin=1,
                    maxnormfac=5, minnormfac=0, cutmid=0, numsteps=None,
                    logsteps=False, weighted=True, interp_nan=False,
                    fit_spectrum=False, powerspec_cut=False,
                    subtract_artefacts=False, device=None):
    """Full norm_sspec pipeline on a (dB) secondary spectrum
    ``sspec[ntdel, nfdop]`` with delay axis ``tdel`` (µs or m⁻¹) and
    Doppler axis ``fdop`` (mHz); ``eta`` in the matching curvature
    convention. The row interpolation runs on ``device``; the rest is
    host numpy. ``interp_nan`` fills the normalised spectrum's NaNs by
    linear ``griddata`` on the host. ``fit_spectrum`` fits wn + amp·x^α
    to the delay power spectrum over x = √tdel on the host (``fitter``
    with ``powerspectrum_model``), sets the ``ps_*`` fields and weights
    the average by the fitted model. Returns :class:`NormSspec`."""
    sspec = np.array(sspec, dtype=float)
    tdel_full = np.asarray(tdel, dtype=float)
    fdop = np.asarray(fdop, dtype=float)

    delmax = np.max(tdel_full) if delmax is None else delmax
    ind = int(np.argmin(np.abs(tdel_full - delmax)))
    sspec = sspec[startbin:ind, :]
    tdel_c = tdel_full[startbin:ind]
    nc = sspec.shape[1]
    if cutmid > 0:
        sspec[:, int(nc / 2 - np.floor(cutmid / 2)):
              int(nc / 2 + np.floor(cutmid / 2))] = np.nan

    if subtract_artefacts:
        # delay response estimated from outer 10% in Doppler
        outer = np.abs(fdop) > 0.9 * np.max(fdop)
        delay_response = np.nanmean(sspec[:, outer], axis=1)
        delay_response = delay_response - np.median(delay_response)
        sspec = sspec - delay_response[:, None]

    maxfdop = maxnormfac * np.sqrt(tdel_c[-1] / eta)
    maxfdop = min(maxfdop, np.max(fdop))
    nfdop = (2 * np.sum(np.abs(fdop) <= maxfdop) if numsteps is None
             else int(numsteps))
    if nfdop % 2 != 0:
        nfdop += 1

    if logsteps:
        fdoplin = np.abs(np.linspace(-maxnormfac, maxnormfac, int(nfdop)))
        fdop_pos = 10 ** np.linspace(np.log10(np.min(fdoplin)),
                                     np.log10(np.max(fdoplin)),
                                     int(nfdop / 2))
        fdopnew = np.concatenate((-np.flip(fdop_pos), fdop_pos))
    else:
        fdopnew = np.linspace(-maxnormfac, maxnormfac, nfdop)
    if minnormfac > 0:
        fdopnew = fdopnew[np.abs(fdopnew) > minnormfac]

    dev = resolve_device(device)
    s_dev = as_tensor(sspec, dev, dtype=torch.float64)
    norm, mask = scaled_row_interp(s_dev, fdop, tdel_c, eta, fdopnew,
                                   device=dev)
    norm, mask = norm.cpu().numpy(), mask.cpu().numpy()
    if interp_nan:
        norm = interp_nan_2d(norm)
        mask = mask & ~np.isfinite(norm) | (np.abs(fdopnew)[None, :]
                                            * np.sqrt(tdel_c / eta)[:, None]
                                            > np.max(np.abs(fdop)))
    mnorm = np.ma.array(norm, mask=mask)
    if logsteps:
        # the delay power spectrum comes from a parallel *linear*-grid
        # interpolation so log-spaced oversampling of the arc core does
        # not bias it (the positive side sampled twice, as the reference)
        fdoplin = np.abs(np.linspace(-maxnormfac, maxnormfac, int(nfdop)))
        nlin, mlin = scaled_row_interp(s_dev, fdop, tdel_c, eta, fdoplin,
                                       device=dev)
        mlin_arr = np.ma.array(nlin.cpu().numpy(), mask=mlin.cpu().numpy())
        powerspectrum = np.asarray(np.ma.mean(10 ** (mlin_arr / 10), axis=1))
    else:
        powerspectrum = np.asarray(np.ma.mean(10 ** (mnorm / 10), axis=1))

    # arc power-spectrum model: wn + amp·x^alpha over x = √tdel
    xdata = np.sqrt(tdel_c)
    ydata = xdata * powerspectrum
    valid = np.isfinite(xdata) & np.isfinite(ydata)
    xdata, ydata = xdata[valid], ydata[valid]
    alpha = -11 / 3
    index = int(np.argmin(np.abs(xdata - 10)))
    amp = ydata[index] * xdata[index] ** -alpha
    wn = np.min(ydata)
    ps = {}
    if fit_spectrum:
        params = Parameters()
        params.add("wn", value=wn, vary=True, min=np.min(ydata), max=np.inf)
        params.add("alpha", value=alpha, vary=True, min=-np.inf, max=0)
        params.add("amp", value=amp, vary=True, min=0.0, max=np.inf)
        results = fitter(powerspectrum_model, params, (xdata, ydata))
        wn = results.params["wn"].value
        amp = results.params["amp"].value
        alpha = results.params["alpha"].value
        ps = dict(ps_wn=wn, ps_amp=amp, ps_alpha=alpha,
                  ps_wn_err=results.params["wn"].stderr,
                  ps_amp_err=results.params["amp"].stderr,
                  ps_alpha_err=results.params["alpha"].stderr)

    arc_spectrum = amp * xdata ** alpha
    if weighted:
        weights = 10 * np.log10(arc_spectrum)
    else:
        weights = np.ones(np.shape(arc_spectrum))

    if powerspec_cut:
        sel = (arc_spectrum > wn)
        avg = np.ma.average(mnorm[sel, :], axis=0, weights=weights[sel])
    else:
        avg = np.ma.average(mnorm, axis=0, weights=weights)

    return NormSspec(normsspecavg=np.asarray(avg), normsspec=mnorm.data,
                     mask=mnorm.mask, tdel=tdel_c, fdop=fdopnew,
                     powerspectrum=powerspectrum, weights=weights, **ps)
