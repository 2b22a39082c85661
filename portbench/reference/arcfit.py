"""Plain reference of the batched arc-curvature fit: what
``ops.fitarc.fit_arc_batch`` computes for each epoch, in float64 (or,
for the control, in a lower :class:`~.common.Precision`), from the
epoch's dynamic spectrum.

The method is the Hough-style fit of upstream scintools
(``dynspec.py`` ``fit_arc`` with ``norm_sspec``): the secondary spectrum
in dB (:func:`.common.sspec_dB`), its delay rows ``startbin`` up to the
last resampled at the Doppler ``f·√(τ/η_min)`` for a normalised
Doppler grid ``f`` of ``numsteps`` points in [−1, 1], masked where the
sample leaves the spectrum or touches the ``cutmid`` central columns,
averaged over the rows; the profile folded about ``f = 0`` and read as
a function of η = η_min/f²; smoothed by a linear Savitzky–Golay filter
of ``nsmooth`` points; the peak walked out to the points ``1`` dB
below on the left and ``0.5`` dB below on the right; a parabola fitted
there (η and its error), and the noise error from the walk to one
noise level below the peak. Every error is divided by √2, as upstream.

Two choices are the batched program's (``fit_arc_batch`` in both
packages), kept so that the same epoch gives the same answer: the
resampling is its two-tap tent (a bin of weight zero does not count,
the right edge is its last bin alone), which the serial upstream path
reads with ``np.interp``, and a parabola is refused as opening upwards
when its x² coefficient is positive (the serial path tests the mean
curvature of its fitted values on the uneven η grid, which can differ
for a shallow one). The rest follows the serial path's host code,
including its quirks: the left power walk stops at the array's start,
the noise walk's left scan stops at index 2 and lands one past the
crossing, a left edge walked out to index −1 reads the last point, and
a right edge walked past the last point reads the last point.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import Precision, sspec_axes, sspec_db


def spectra(dyns, dt, df, precision="float64"):
    """``(fdop, tdel, sec[B, nr/2, nc])``: the secondary spectra in dB of
    ``dyns[B, nf, nt]`` (a tensor; ``sec`` on its device)."""
    P = Precision(precision)
    nf, nt = dyns.shape[-2:]
    _, _, fdop, tdel = sspec_axes(nf, nt, dt, df)
    return fdop, tdel, sspec_db(dyns, P)


def profiles(sec, tdel, fdop, etamin, numsteps, startbin, cutmid, P,
             block=32):
    """Folded profiles ``(B, numsteps/2)`` (numpy float64, over the
    normalised Doppler f ≥ 0 ascending)."""
    dev = sec.device
    B, ntdel, nc = sec.shape
    ind = int(np.argmin(np.abs(tdel - np.max(tdel))))
    rows = torch.as_tensor(tdel[startbin:ind], dtype=torch.float64,
                           device=dev)
    fq = np.linspace(-1.0, 1.0, numsteps)
    fqt = torch.as_tensor(fq, device=dev)
    f0, dfd, fmax = float(fdop[0]), float(np.mean(np.diff(fdop))), \
        float(np.max(np.abs(fdop)))
    bad = torch.zeros(nc, dtype=P.real, device=dev)
    if cutmid > 0:
        bad[int(nc / 2 - np.floor(cutmid / 2)):
            int(nc / 2 + np.floor(cutmid / 2))] = 1
    out = []
    for b0 in range(0, B, block):
        s = P(sec[b0:b0 + block, startbin:ind])
        nb = s.shape[0]
        scale = torch.sqrt(rows[None, :] / float(etamin))      # (1, R)
        xq = P(scale[:, :, None] * fqt[None, None, :])         # (1, R, Q)
        pos = ((xq - f0) / dfd).clamp(0.0, nc - 1.0)
        k0 = pos.floor()
        k1 = k0 + 1
        w0 = (1 - (pos - k0).abs()).clamp_min(0.0)
        w1 = torch.where(k1 <= nc - 1, (1 - (pos - k1).abs()).clamp_min(0.0),
                         0.0)
        i0 = k0.long()
        i1 = k1.clamp_max(nc - 1).long()
        rowbad = torch.isnan(s).to(P.real) + bad                # (nb, R, nc)
        s0 = torch.nan_to_num(s)
        R, Q = i0.shape[1:]
        i0e, i1e = i0.expand(nb, R, Q), i1.expand(nb, R, Q)
        val = P(w0 * s0.gather(2, i0e) + w1 * s0.gather(2, i1e))
        nanw = w0 * rowbad.gather(2, i0e) + w1 * rowbad.gather(2, i1e)
        ok = ((xq.abs() <= fmax) & (nanw <= 0)).to(P.real)
        num = (val * ok).sum(dim=1)
        den = ok.sum(dim=1)
        prof = P(torch.where(den > 0, num / den.clamp_min(1.0), 0.0))
        pos_i = np.flatnonzero(fq >= 0)
        neg_i = np.flatnonzero(fq < 0)[::-1].copy()
        out.append(P((prof[:, pos_i] + prof[:, neg_i]) / 2).double().cpu())
    return torch.cat(out).numpy()


def savgol_linear(y, w):
    """``scipy.signal.savgol_filter(y, w, 1)`` (mode ``interp``): the
    moving mean of ``w`` points inside, the least-squares line through
    the first and last ``w`` points at the ``w//2`` points of each end."""
    n, h = len(y), w // 2
    out = np.convolve(y, np.ones(w) / w, mode="same")
    t = np.arange(w, dtype=float)
    for sl, idx in ((slice(0, w), np.arange(h)),
                    (slice(n - w, n), np.arange(w - h, w))):
        c = np.polyfit(t, y[sl], 1)
        out[sl][idx] = np.polyval(c, t[idx])
    return out


def fit_profile(spec, eta, noise, nsmooth=5, low=-1.0, high=-0.5):
    """``(eta, etaerr, etaerr2)`` of one cropped profile ``spec`` over
    the ascending grid ``eta``; NaN where the fit is refused."""
    nan = (np.nan, np.nan, np.nan)
    L = len(spec)
    if L <= nsmooth:
        return nan
    sm = savgol_linear(spec, nsmooth)
    mx = np.max(sm)
    ind = int(np.argmin(np.abs(sm - mx)))
    i1, p = 1, mx
    while p > mx + low and ind - i1 > 0:
        i1 += 1
        p = sm[ind - i1]
    i2, p = 1, mx
    while p > mx + high and ind + i2 < L - 1:
        i2 += 1
        p = sm[ind + i2]
    lo, hi = ind - i1, ind + i2
    if lo < 0 or hi - lo <= 3:
        return nan
    x, y = eta[lo:hi], spec[lo:hi]
    ptp = np.ptp(x)
    xs = x * (1000 / ptp)
    params, pcov = np.polyfit(xs, y, 2, cov=True)
    if params[0] > 0:
        return nan
    err = np.sqrt(np.abs(np.diag(pcov)))
    peak = -params[1] / (2 * params[0]) * ptp / 1000
    err2 = np.sqrt(err[1] ** 2 / (2 * params[0]) ** 2
                   + err[0] ** 2 * (params[1] / 2) ** 2) * ptp / 1000
    i1, p = 1, mx
    while p > mx - noise and ind - i1 > 1:
        p = sm[ind - i1]
        i1 += 1
    i2, p = 1, mx
    while p > mx - noise and ind + i2 < L - 1:
        i2 += 1
        p = sm[ind + i2]
    err1 = np.abs(eta[ind - i1] - eta[min(ind + i2, L - 1)]) / 2
    if not np.isfinite(peak):
        return nan
    return peak, err1 / np.sqrt(2), err2 / np.sqrt(2)


def sspec_noise(sec, cutmid, n_rows):
    """Noise of each spectrum ``sec[B, nr, nc]`` (numpy): the standard
    deviation of the outer Doppler columns of its upper half of delays,
    over √(2·n_rows)."""
    nr, nc = sec.shape[1:]
    a = sec[:, nr // 2:, int(nc / 2 + np.ceil(cutmid / 2)):]
    b = sec[:, nr // 2:, :int(nc / 2 - np.floor(cutmid / 2))]
    both = np.concatenate([a.reshape(len(sec), -1), b.reshape(len(sec), -1)],
                          axis=1)
    return both.std(axis=1) / np.sqrt(n_rows * 2)


def fit_batch(sec, tdel, fdop, numsteps=2000, startbin=3, cutmid=3,
              nsmooth=5, low=-1.0, high=-0.5, precision="float64"):
    """Every epoch's ``(eta, etaerr, etaerr2)`` (numpy arrays) from its
    spectrum ``sec[B, ntdel, nfdop]`` in dB, at the default η range:
    η_min = 3 delay bins at the largest Doppler, η_max the last delay
    at ``cutmid`` Doppler bins."""
    P = Precision(precision)
    numsteps = int(numsteps) + int(numsteps) % 2
    tdel = np.asarray(tdel, dtype=float)
    fdop = np.asarray(fdop, dtype=float)
    ind = int(np.argmin(np.abs(tdel - np.max(tdel))))
    etamax = tdel[ind] / ((fdop[1] - fdop[0]) * cutmid) ** 2
    etamin = (tdel[1] - tdel[0]) * startbin / np.max(fdop) ** 2
    folded = profiles(sec, tdel, fdop, etamin, numsteps, startbin, cutmid, P)
    fq = np.linspace(-1.0, 1.0, numsteps)
    with np.errstate(divide="ignore"):
        eta_grid = etamin * (1.0 / fq[fq >= 0]) ** 2
    eta_grid = eta_grid[::-1]
    keep = eta_grid < etamax
    noise = sspec_noise(P(sec).double().cpu().numpy(), cutmid, ind)
    out = np.full((len(sec), 3), np.nan)
    for b in range(len(sec)):
        spec = folded[b][::-1]
        if not np.isfinite(spec).all():
            continue
        out[b] = fit_profile(spec[keep], eta_grid[keep], noise[b], nsmooth,
                             low, high)
    return out[:, 0], out[:, 1], out[:, 2]
