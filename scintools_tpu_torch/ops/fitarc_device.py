"""Whole-survey arc fit on the device: profile, then the per-epoch tail
as fixed-shape masked tensor math over the epoch axis.

Counterpart of ``scintools_tpu/ops/fitarc_device.py:61-339``
(``eta_grid``, ``eta_crop_lengths``, ``make_savgol_interp``,
``make_arc_fit_batch_fn``); the JAX ``vmap`` over epochs is the leading
axis here. The tail is pinned to the host path
(``ops/fitarc.py:_peak_parabola``) index for index:

- ``savgol_filter(window, 1, mode='interp')``: the uniform moving mean
  inside, a linear least-squares fit over the first/last ``window``
  valid points for the first/last ``window//2`` points;
- the walk-outs keep the host loops' quirks: the power walks scan from
  ``ind ± 2``; the noise walk's left scan stops at index 2 and
  over-counts by one; a left edge walked fully out lands on index −1,
  which wraps to the last valid point (a floor-mod, as ``jnp.mod``);
  ``lo < 0`` (the peak on the first grid point) quarantines;
- the parabola is solved in centred, scaled coordinates
  (``u = (xs − m)/500``, y centred) so the normal equations stay
  conditioned in float32, then mapped back for the reference's error
  formula; a singular system gives a NaN lane through ``solve_ex``
  (``torch.linalg.solve`` would raise), which then refuses.

Epochs whose spectrum holds a non-finite pixel get the crop length 0
(``fitarc.fit_arc_batch`` sets it on the device) and come out NaN,
since the host path's finite mask would change their η grid point by
point.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import as_tensor, resolve_device
from .fitarc import sspec_noise_batch
from .normsspec import make_arc_profile_batch_fn


def eta_grid(numsteps):
    """The ascending per-epoch η grid factor (``eta_array = etamin ·
    eta_grid(numsteps)[0]``) and the normalised Doppler axis."""
    numsteps = int(numsteps) + int(numsteps) % 2
    fdopnew = np.linspace(-1.0, 1.0, numsteps)
    pos = fdopnew >= 0
    with np.errstate(divide="ignore"):
        etafrac = 1.0 / fdopnew[pos]
    return np.flip(etafrac) ** 2, fdopnew


def eta_crop_lengths(numsteps, etamins, etamaxs):
    """Per-epoch valid-prefix length of the flipped folded profile: the
    count of ``etamin·etafrac² < etamax`` (the host crop's expression)."""
    ef2, _ = eta_grid(numsteps)
    etamins = np.atleast_1d(np.asarray(etamins, dtype=float))
    etamaxs = np.atleast_1d(np.asarray(etamaxs, dtype=float))
    return (etamins[:, None] * ef2[None, :]
            < etamaxs[:, None]).sum(axis=1).astype(np.int32)


def make_savgol_interp(nsmooth, H):
    """``smooth(q[B, H], L[B]) → [B, H]``: ``savgol_filter(q[b, :L[b]],
    nsmooth, 1, mode='interp')`` at fixed shape (entries at j ≥ L are
    unused)."""
    w = int(nsmooth)
    half = w // 2
    tc = (w - 1) / 2.0
    t_rel = np.arange(w, dtype=float) - tc
    den_t = float(np.sum(t_rel ** 2))

    def smooth(q, L):
        dev, dt = q.device, q.dtype
        idx = torch.arange(H, device=dev)
        t = torch.as_tensor(t_rel, dtype=dt, device=dev)
        qp = torch.nn.functional.pad(q, (half, half))
        mov = sum(qp[:, i:i + H] for i in range(w)) / w
        yl = q[:, :w]
        val_l = yl.mean(dim=1, keepdim=True) + (yl @ t / den_t)[:, None] \
            * (idx - tc)
        # the right window starts at L − w, clamped into the row as a
        # dynamic slice is
        start = (L - w).clamp(0, H - w)
        yr = torch.gather(q, 1, start[:, None] + torch.arange(w, device=dev))
        val_r = yr.mean(dim=1, keepdim=True) + (yr @ t / den_t)[:, None] \
            * ((idx - (L - w)[:, None]) - tc)
        return torch.where(idx < half, val_l,
                           torch.where(idx >= (L - half)[:, None], val_r,
                                       mov))

    return smooth


def make_arc_fit_batch_fn(tdel, fdop, delmax=None, startbin=3, cutmid=3,
                          numsteps=10000, nsmooth=5, low_power_diff=-1.0,
                          high_power_diff=-0.5, constraint=(0.0, np.inf),
                          noise_error=True, pallas=None, device=None):
    """The whole fit on ``device``: ``fn(sspecs[B, ntdel, nfdop] float32,
    etamins[B] float64, Ls[B] int) → (out[B, 10], folded[B,
    numsteps//2])``, both float32, with the packed columns ``(eta,
    etaerr, etaerr2, noise, lo, n, a2, a1, a0, scale)``: the last six
    rebuild the ``fit_parabola`` diagnostics on the host. NaN η marks
    an epoch the host path would quarantine. ``pallas`` picks the
    profile's route as :func:`~.normsspec.make_arc_profile_batch_fn`
    does."""
    if nsmooth % 2 != 1 or nsmooth < 3:
        raise ValueError("nsmooth must be an odd window >= 3 "
                         "(scipy savgol_filter requirement)")
    dev = resolve_device(device)
    tdel = np.asarray(tdel, dtype=float)
    fdop = np.asarray(fdop, dtype=float)
    numsteps = int(numsteps) + int(numsteps) % 2
    H = numsteps // 2
    delmax = np.max(tdel) if delmax is None else float(delmax)
    n_rows = int(np.argmin(np.abs(tdel - delmax)))   # noise divisor

    profile_fn = make_arc_profile_batch_fn(
        tdel, fdop, delmax=delmax, startbin=startbin, cutmid=cutmid,
        numsteps=numsteps, fold=True, pallas=pallas, device=dev)
    ef2 = as_tensor(eta_grid(numsteps)[0].copy(), dev, torch.float64)
    c0, c1 = float(constraint[0]), float(constraint[1])
    w = int(nsmooth)
    idx = torch.arange(H, device=dev)
    smooth = make_savgol_interp(w, H)

    def first(mask, fill):
        """Least index where ``mask`` holds along axis 1, else ``fill``."""
        return torch.where(mask, idx, fill).amin(dim=1)

    def last(mask):
        """Greatest index where ``mask`` holds along axis 1, else −1."""
        return torch.where(mask, idx, -1).amax(dim=1)

    def masked_sum(mask, x):
        return torch.where(mask, x, 0.0).sum(dim=1)

    def tail(q, sm, L, eta_row, noise):
        """The peak fit of every epoch (rows of ``q``, ``sm``)."""
        inf = float("inf")
        valid = idx < L[:, None]
        # peak: max of smoothed inside the constraint, then the first
        # argmin of |smoothed − max| over the whole cropped row
        inr = valid & (eta_row > c0) & (eta_row < c1)
        has_inr = inr.any(dim=1)
        max_in = torch.where(inr, sm, -inf).amax(dim=1)
        ind = torch.where(valid, (sm - max_in[:, None]).abs(),
                          inf).argmin(dim=1)
        max_power = sm.gather(1, ind[:, None])[:, 0]
        at = ind[:, None]

        # power walk-outs over smoothed[ind−2], ind−3, … (ind+2, …) to
        # the first value at or below the threshold; the row start (end)
        # bounds them, and i stays 1 where the loop is never entered
        if low_power_diff < 0:
            jl = last(valid & (idx <= at - 2)
                      & (sm <= (max_power + low_power_diff)[:, None]))
            i1 = torch.where(ind >= 2, torch.where(jl >= 0, ind - jl, ind),
                             1)
        else:
            i1 = torch.ones_like(ind)
        if high_power_diff < 0:
            jr = first(valid & (idx >= at + 2)
                       & (sm <= (max_power + high_power_diff)[:, None]),
                       H + 1)
            i2 = torch.where(ind + 1 < L - 1,
                             torch.where(jr <= H, jr - ind, L - 1 - ind), 1)
        else:
            i2 = torch.ones_like(ind)

        # masked parabola over [ind − i1, ind + i2): xs = x·1000/ptp,
        # deg-2 least squares, np.polyfit's covariance inv(AᵀA)·resid/
        # (n − 3); solved in centred, scaled u = (xs − m)/500 with y
        # centred (f32 conditioning), then mapped back to xs
        lo, hi = ind - i1, ind + i2
        wm = valid & (idx >= lo[:, None]) & (idx < hi[:, None])
        n = wm.sum(dim=1)
        nf = n.to(q.dtype)
        xmin = torch.where(wm, eta_row, inf).amin(dim=1)
        xmax = torch.where(wm, eta_row, -inf).amax(dim=1)
        scale = 1000.0 / (xmax - xmin)
        xs = eta_row * scale[:, None]
        m = masked_sum(wm, xs) / nf
        h = 500.0
        u = torch.where(wm, (xs - m[:, None]) / h, 0.0)
        ym = masked_sum(wm, q) / nf
        y = torch.where(wm, q - ym[:, None], 0.0)
        u2 = u * u
        S1, S2 = u.sum(dim=1), u2.sum(dim=1)
        S3, S4 = (u2 * u).sum(dim=1), (u2 * u2).sum(dim=1)
        G = torch.stack([torch.stack([S4, S3, S2], dim=1),
                         torch.stack([S3, S2, S1], dim=1),
                         torch.stack([S2, S1, nf], dim=1)], dim=1)
        rhs = torch.stack([(u2 * y).sum(dim=1), (u * y).sum(dim=1),
                           y.sum(dim=1)], dim=1)
        # a lane the gate refuses anyway (n ≤ 3, so G may hold NaN)
        # solves the identity instead, so no solver sees a NaN
        usable = n > 3
        eye = torch.eye(3, dtype=q.dtype, device=q.device)
        G = torch.where(usable[:, None, None], G, eye)
        c = torch.linalg.solve_ex(G, rhs[:, :, None],
                                  check_errors=False)[0][:, :, 0]
        Ginv, info = torch.linalg.inv_ex(G, check_errors=False)
        singular = info != 0
        c = torch.where(singular[:, None], float("nan"), c)
        c2, c1_, c0_ = c[:, 0], c[:, 1], c[:, 2]
        fitv = c2[:, None] * u2 + c1_[:, None] * u + c0_[:, None]
        resid = masked_sum(wm, (y - fitv) ** 2)
        fac = resid / (nf - 3.0)
        var_c2 = Ginv[:, 0, 0] * fac
        var_c1 = Ginv[:, 1, 1] * fac
        cov12 = Ginv[:, 0, 1] * fac
        a2 = c2 / h ** 2
        a1 = c1_ / h - 2.0 * m * c2 / h ** 2
        var_a2 = var_c2 / h ** 4
        var_a1 = (var_c1 / h ** 2 + 4.0 * m ** 2 / h ** 4 * var_c2
                  - 4.0 * m / h ** 3 * cov12)
        err_a1 = var_a1.abs().sqrt()
        err_a2 = var_a2.abs().sqrt()
        eta_fit = (-a1 / (2.0 * a2)) / scale
        etaerr2 = torch.sqrt(err_a1 ** 2 * (1.0 / (2.0 * a2)) ** 2
                             + err_a2 ** 2 * (a1 / 2.0) ** 2) / scale

        # noise-error walk: the left scan reads smoothed[ind−1] …
        # smoothed[2] and lands one past the crossing; the right scan
        # mirrors the power walk with the threshold max − noise
        t_n = (max_power - noise)[:, None]
        walk = noise > 0
        jln = last(valid & (idx >= 2) & (idx <= at - 1) & (sm <= t_n))
        i1n = torch.where(walk & (ind > 2),
                          torch.where(jln >= 0, ind - jln + 1, ind - 1), 1)
        jrn = first(valid & (idx >= at + 2) & (sm <= t_n), H + 1)
        i2n = torch.where(walk & (ind + 1 < L - 1),
                          torch.where(jrn <= H, jrn - ind, L - 1 - ind), 1)
        # floor-mod: the host's eta_array[-1] (L = 0 lanes are refused)
        il = torch.remainder(ind - i1n, L.clamp_min(1))
        ir = torch.minimum(ind + i2n, L - 1).clamp_min(0)
        err_noise = (eta_row.gather(1, il[:, None])
                     - eta_row.gather(1, ir[:, None]))[:, 0].abs() / 2.0

        # the host path's quarantines → NaN η
        ok = ((L > w) & has_inr & (n > 3) & (lo >= 0) & ~(a2 > 0)
              & torch.isfinite(eta_fit))
        sq2 = np.sqrt(2.0)
        etaerr = (err_noise if noise_error else etaerr2) / sq2
        a0 = ym + c0_ - c1_ * m / h + c2 * m ** 2 / h ** 2
        nan = torch.full((), float("nan"), dtype=q.dtype, device=q.device)
        return torch.stack([
            torch.where(ok, eta_fit, nan), torch.where(ok, etaerr, nan),
            torch.where(ok, etaerr2 / sq2, nan), noise, lo.to(q.dtype),
            nf, a2, a1, a0, scale], dim=1)

    def program(sspecs, etamins, Ls):
        sspecs = as_tensor(sspecs, dev)
        etamins = as_tensor(etamins, dev, torch.float64)
        Ls = torch.as_tensor(Ls, device=dev).long()
        folded = profile_fn(sspecs, etamins)
        q = folded.flip(1)
        # the η grid in float64, rounded once (the host's eta_array)
        eta_rows = (etamins[:, None] * ef2).to(folded.dtype)
        noises = sspec_noise_batch(sspecs, cutmid, n_rows)
        return tail(q, smooth(q, Ls), Ls, eta_rows, noises), folded

    return program
