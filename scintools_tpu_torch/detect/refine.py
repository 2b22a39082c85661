"""Sub-grid η refinement of a trigger: zoom in on the hit instead of
widening the bank, on a torch device.

Counterpart of ``scintools_tpu/detect/refine.py``:
:func:`refine_program` (:59), :func:`refine_window` (:164),
:func:`refine_band` (:183) and :func:`refine_eta` (:197). On a trigger
the conjugate spectrum is band-limited to the hit template's (f_D, τ)
region through the chirp-Z zoom (``ops.sspec.secondary_spectrum_power(
zoom=)``, ``ops/xfft.py:zoom_dft_1d``: only the band's pixels are
computed) and parabola templates are scored on a ~16× denser local η
grid (±4 bank steps). The band edges and the η grid are inputs of the
built function, so a stream of triggers at other curvatures builds
nothing (``detect.refine`` site). The recipe is the correlator's (dB
relative to the peak, median/MAD standardisation over the valid region,
zero-mean unit-norm Gaussian-band parabolas with the native width law),
so a refined score compares with the bank score that triggered it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import cuda_graphed, fifo_cached
from ..obs import retrace as _retrace
from ..ops.sspec import fft_shapes, sspec_axes, zoom_band

#: default local η grid: 129 points over ±4 bank steps, ~16× the bank's
#: η density
DEFAULT_N_ETA = 129

#: default refinement window half-width, in bank grid steps
DEFAULT_SPAN_STEPS = 4

_REFINE_CACHE = {}
_MAX_CACHED = 8


def refine_program(nf, nt, dt, df, *, n_eta=DEFAULT_N_ETA, n_r=None,
                   n_c=None, tau_min=None, fd_min=None, sigma0=1.0,
                   rel_width=0.1, variant=None, window="hanning",
                   window_frac=0.1, device=None):
    """The cached refinement ``fn(dyn[nf, nt], band_r[2], band_c[2],
    etas[n_eta]) → scores[n_eta]`` on ``device`` (``None``: the card),
    one build per geometry, site ``detect.refine``.

    ``band_r``/``band_c`` are (f0, f1) band edges in the (fractional,
    signed) bin units of the padded frame (``ops.sspec.zoom_band``
    converts µs/mHz), tensors like the η grid. Inside: the band-limited
    spectrum power on the ``n_r × n_c`` zoom frame (``variant`` ``"czt"``
    or ``"dense"``), the correlator's standardisation, and the bank's
    parabola templates on the zoomed (τ, f_D) axes with the native width
    law ``sigma0·Δτ + rel_width·arc``."""
    from ..backend import resolve_device

    variant = "czt" if variant is None else variant
    dev = resolve_device(device)
    nrfft, ncfft = fft_shapes(nf, nt)
    fdop, tdel, _ = sspec_axes(nf, nt, dt, df, halve=True)
    n_r = nrfft // 4 if n_r is None else n_r
    n_c = ncfft // 4 if n_c is None else n_c
    if tau_min is None:
        tau_min = float(tdel[1])
    if fd_min is None:
        fd_min = 1.5 * float(fdop[1] - fdop[0])
    key = (int(nf), int(nt), float(dt), float(df), int(n_eta), int(n_r),
           int(n_c), float(tau_min), float(fd_min), float(sigma0),
           float(rel_width), variant, window, float(window_frac), str(dev))

    def make():
        from ..ops.sspec import secondary_spectrum_power
        from ..ops.windows import get_window

        _retrace.record_build("detect.refine", key)
        wins = None
        if window is not None:
            wins = tuple(torch.as_tensor(w, dtype=torch.float32, device=dev)
                         for w in get_window(int(nt), int(nf), window=window,
                                             frac=window_frac))
        nr, nc = int(n_r), int(n_c)
        dtau = float(tdel[1] - tdel[0])     # native delay bin width
        tau_scale = float(np.float32(1.0 / (nrfft * df)))   # bin → µs
        fd_scale = float(np.float32(1e3 / (ncfft * dt)))    # bin → mHz
        jr = torch.arange(nr, dtype=torch.float32, device=dev)
        jc = torch.arange(nc, dtype=torch.float32, device=dev)

        def run(dyn, band_r, band_c, etas):
            sec = secondary_spectrum_power(
                dyn.to(torch.float32), window_arrays=wins, variant=variant,
                zoom=((band_r[0], band_r[1], nr), (band_c[0], band_c[1], nc)))
            # the zoom frame's physical axes
            tau_z = (band_r[0] + (band_r[1] - band_r[0]) / nr * jr) \
                * tau_scale
            fd_z = (band_c[0] + (band_c[1] - band_c[0]) / nc * jc) \
                * fd_scale
            valid = ((tau_z[:, None] >= tau_min)
                     & (fd_z.abs()[None, :] >= fd_min)).to(torch.float32)
            n_valid = torch.clamp(valid.sum(), min=1.0)
            # the correlator's input standardisation
            smax = sec.amax()
            smax = torch.where(smax > 0, smax, torch.ones_like(smax))
            x = 10.0 * torch.log10(sec / smax + 1e-12)
            xv = torch.where(valid > 0, x, torch.full_like(x, np.nan))
            med = torch.nanquantile(xv.reshape(-1), 0.5)
            mad = torch.nanquantile((xv - med).abs().reshape(-1), 0.5)
            xhat = (x - med) / (1.4826 * mad + 1e-6) * valid
            # the bank's templates on the zoomed axes
            arc = etas[:, None, None] * fd_z[None, None, :] ** 2
            sig = sigma0 * dtau + rel_width * arc
            w = torch.exp(-0.5 * ((tau_z[None, :, None] - arc) / sig) ** 2)
            w = w * valid[None]
            mu = w.sum(dim=(1, 2), keepdim=True) / n_valid
            t = (w - mu) * valid[None]
            nrm = torch.sqrt((t * t).sum(dim=(1, 2), keepdim=True))
            t = t / torch.clamp(nrm, min=1e-20)
            return (t * xhat[None]).sum(dim=(1, 2))

        return cuda_graphed(run)

    return fifo_cached(_REFINE_CACHE, key, make, _MAX_CACHED)


def refine_window(bank, eta_bank, span=None):
    """The local η window ``(eta_lo, eta_hi)``: ``DEFAULT_SPAN_STEPS``
    bank grid-step ratios either side of the trigger's template
    (``span`` overrides the ratio). Wider than the bank's half step on
    purpose: the best template can sit a few steps off the true local
    peak."""
    etas = np.asarray(bank.etas, dtype=float)
    if span is None:
        step = (etas[-1] / etas[0]) ** (1.0 / max(len(etas) - 1, 1))
        span = step ** DEFAULT_SPAN_STEPS
    span = float(span)
    return float(eta_bank) / span, float(eta_bank) * span


def refine_band(bank, eta_lo, eta_hi):
    """The physical ``(tdel_band [µs], fdop_band [mHz])`` window holding
    every arc τ = η·f_D² with η in [eta_lo, eta_hi] inside the bank's
    frame: Doppler out to where the shallowest arc leaves the frame's
    top, delay up to where the steepest arc sits at that Doppler."""
    tau_max = float(bank.tdel[-1])
    fd_max = float(bank.fdop[-1])
    fd_lim = min(fd_max, float(np.sqrt(tau_max / eta_lo)))
    tau_hi = min(tau_max, float(eta_hi) * fd_lim ** 2)
    return (0.0, tau_hi), (-fd_lim, fd_lim)


def refine_eta(dyn, bank, eta_bank, *, n_eta=DEFAULT_N_ETA, span=None,
               variant=None, window="hanning", window_frac=0.1):
    """Refine a trigger's η below the bank grid on the bank's device: zoom
    the spectrum into the hit's (f_D, τ) band, score the dense local η
    grid, and put a parabola through the peak in log η.

    ``dyn[nf, nt]`` is the triggering frame; ``eta_bank`` the best
    template's η. Returns ``{"eta_refined", "eta_lo", "eta_hi", "etas",
    "scores", "band", "score"}`` (host values)."""
    nf, nt, dt, df = bank.geometry
    dev = bank.device
    eta_lo, eta_hi = refine_window(bank, eta_bank, span=span)
    etas = np.geomspace(eta_lo, eta_hi, int(n_eta))
    tdel_band, fdop_band = refine_band(bank, eta_lo, eta_hi)
    nrfft, ncfft = fft_shapes(nf, nt)
    # a quarter of the native counts, concentrated inside the band
    n_r, n_c = nrfft // 4, ncfft // 4
    band_r, band_c = zoom_band(nf, nt, dt, df, tdel_band, fdop_band, n_r,
                               n_c)
    fn = refine_program(
        nf, nt, dt, df, n_eta=int(n_eta), n_r=n_r, n_c=n_c,
        tau_min=bank.params["tau_min"], fd_min=bank.params["fd_min"],
        sigma0=bank.params["sigma0"], rel_width=bank.params["rel_width"],
        variant=variant, window=window, window_frac=window_frac,
        device=dev)

    def f32(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float32), device=dev)

    scores = fn(torch.as_tensor(dyn, device=dev), f32(band_r[:2]),
                f32(band_c[:2]), f32(etas)).cpu().numpy()
    i = int(np.argmax(scores))
    eta_refined = float(etas[i])
    if 0 < i < len(etas) - 1:
        # parabolic vertex on the uniform log-η grid
        num = scores[i - 1] - scores[i + 1]
        den = scores[i - 1] - 2.0 * scores[i] + scores[i + 1]
        if den < 0:
            step = np.log(etas[1] / etas[0])
            off = float(np.clip(0.5 * num / den, -0.5, 0.5))
            eta_refined = float(np.exp(np.log(etas[i]) + off * step))
    return {"eta_refined": eta_refined, "eta_lo": eta_lo, "eta_hi": eta_hi,
            "etas": etas, "scores": scores,
            "band": {"tdel": list(tdel_band), "fdop": list(fdop_band)},
            "score": float(scores[i])}
