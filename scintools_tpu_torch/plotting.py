"""Host-side matplotlib plotting of the façade's state.

Counterpart of ``scintools_tpu/plotting.py``: ``_mpl`` (:12), ``_finish``
(:25), ``plot_dyn`` (:35), ``plot_acf`` (:86), ``_split_filename``
(:178), ``plot_acf_tilt`` (:186), ``plot_cut_tiles`` (:245),
``_tile_sspec`` (:279), ``plot_sspec`` (:292), ``plot_arc_fit`` (:385),
``plot_norm_sspec`` (:408), ``plot_scattered_image`` (:460),
``plot_eta_evolution`` (:515), ``plot_scint_fit_1d`` (:545),
``plot_scint_fit_2d`` (:585) and ``plot_all`` (:620).

Plots are presentation only, with no device code of their own: they
draw the numpy arrays the façade already holds (a tensor they are given
is brought to the host first). matplotlib is imported inside the
functions, never when the package is imported, and with no display the
Agg backend is selected.
"""

from __future__ import annotations

import numpy as np

from .backend import is_kernel_error
from .utils.misc import centres_to_edges, is_valid


def _np(x):
    """A host numpy view of ``x`` (a tensor is copied off its device)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return x


def _mpl():
    import matplotlib
    if matplotlib.get_backend().lower() != "agg" and not hasattr(
            _mpl, "_interactive"):
        try:
            matplotlib.use("Agg", force=False)
        except (ImportError, ValueError):
            # backend already initialised interactively — keep it
            pass
    import matplotlib.pyplot as plt
    return plt


def _finish(plt, fig, filename, display, dpi):
    if filename is not None:
        fig.savefig(filename, dpi=dpi, bbox_inches="tight",
                    pad_inches=0.1)
        plt.close(fig)
    elif display:
        plt.show()
    return fig


def plot_dyn(ds, lamsteps=False, input_dyn=None, filename=None,
             input_x=None, input_y=None, trap=False, display=True,
             figsize=(9, 9), dpi=200, title=None, velocity=False):
    """Dynamic spectrum (dynspec.py:442-545)."""
    plt = _mpl()
    input_dyn = None if input_dyn is None else _np(input_dyn)
    if input_dyn is None:
        if lamsteps:
            if not hasattr(ds, "lamdyn"):
                ds.scale_dyn()
            dyn = ds.lamdyn
            yaxis = ds.lam
            ylabel = "Wavelength (m)"
        elif trap:
            if not hasattr(ds, "trapdyn"):
                ds.scale_dyn(scale="trapezoid")
            dyn = ds.trapdyn
            yaxis = ds.freqs
            ylabel = "Frequency (MHz)"
        else:
            dyn = ds.vdyn if velocity else ds.dyn
            yaxis = ds.freqs
            ylabel = "Frequency (MHz)"
        xaxis = ds.times / 60
    else:
        dyn = input_dyn
        xaxis = input_x
        yaxis = input_y
        ylabel = ""
    fig = plt.figure(figsize=figsize)
    valid = dyn[is_valid(dyn)]
    if valid.size:
        medval = np.median(valid[np.abs(valid) > 0])
        minval = np.min(valid)
        std = np.std(valid)
        vmin, vmax = max(minval, medval - 5 * std), medval + 5 * std
    else:
        vmin = vmax = None
    plt.pcolormesh(centres_to_edges(xaxis), centres_to_edges(yaxis),
                   dyn, vmin=vmin, vmax=vmax, linewidth=0,
                   rasterized=True, shading="auto")
    plt.xlabel("Time (mins)")
    plt.ylabel(ylabel)
    if title:
        plt.title(title)
    return _finish(plt, fig, filename, display, dpi)


def plot_acf(ds, method="acf1d", alpha=5 / 3, contour=False,
             filename=None, input_acf=None, input_t=None, input_f=None,
             nscale=4, mcmc=False, display=True, crop=False, tlim=None,
             flim=None, figsize=(9, 9), verbose=False, dpi=200):
    """ACF with fitted scintillation-scale axes
    (dynspec.py:547-691): white-noise spike subtracted, optional crop
    to ``nscale`` scales (or explicit tlim/flim), and — when plotting
    the object's own ACF — twin axes in units of the fitted τ_d/Δν_d
    (running ``get_scint_params(method, mcmc=...)`` first if needed)."""
    plt = _mpl()
    if input_acf is None:
        if not hasattr(ds, "acf"):
            ds.calc_acf()
        if not hasattr(ds, "tau"):
            try:
                ds.get_scint_params(method=method, alpha=alpha,
                                    mcmc=mcmc, verbose=verbose)
            except Exception as e:
                # a fit that fails is drawn without scales; a kernel
                # error or device fault is never swallowed
                if is_kernel_error(e):
                    raise
                print(e)
                print("Could not determine scintillation scales "
                      "for plot")
        arr = np.array(_np(ds.acf))
        tspan, fspan = ds.tobs, ds.bw
    else:
        arr = np.array(_np(input_acf))
        tspan = max(input_t) - min(input_t)
        fspan = max(input_f) - min(input_f)
    # subtract the white-noise spike (dynspec.py:626-630)
    arr = np.fft.ifftshift(arr)
    wn = arr[0][0] - max(arr[1][0], arr[0][1])
    arr[0][0] = arr[0][0] - wn
    arr = np.fft.fftshift(arr)

    t_delays = np.linspace(-tspan / 60, tspan / 60, arr.shape[1])
    f_shifts = np.linspace(-fspan, fspan, arr.shape[0])

    has_scales = hasattr(ds, "tau") and hasattr(ds, "dnu")
    if crop and tlim is None and not has_scales:
        # the fit failed above; honour the printed warning and plot
        # the full frame instead of crashing on ds.tau
        crop = False
    if crop or (tlim is not None):
        if tlim is None:
            tlim = nscale * ds.tau / 60
        if flim is None:
            flim = (nscale * ds.dnu if has_scales
                    else np.abs(f_shifts).max())
        tlim = min(tlim, ds.tobs / 60) if input_acf is None else tlim
        flim = min(flim, ds.bw) if input_acf is None else flim
        t_inds = np.flatnonzero(np.abs(t_delays) <= tlim)
        f_inds = np.flatnonzero(np.abs(f_shifts) <= flim)
        t_delays = t_delays[t_inds]
        f_shifts = f_shifts[f_inds]
        arr = arr[np.ix_(f_inds, t_inds)]

    fig, ax1 = plt.subplots(figsize=figsize)
    if contour:
        ax1.contourf(t_delays, f_shifts, arr)
    else:
        ax1.pcolormesh(centres_to_edges(t_delays),
                       centres_to_edges(f_shifts), arr, linewidth=0,
                       rasterized=True, shading="auto")
    if input_acf is None:
        ax1.set_ylabel(r"Frequency shift, $\Delta\nu$ (MHz)")
        ax1.set_xlabel(r"Time lag, $\tau$ (mins)")
        if hasattr(ds, "tau") and hasattr(ds, "dnu"):
            # twin axes in units of the fitted scales
            # (dynspec.py:663-673)
            miny, maxy = ax1.get_ylim()
            ax2 = ax1.twinx()
            ax2.set_ylim(miny / ds.dnu, maxy / ds.dnu)
            ax2.set_ylabel(r"$\Delta\nu$ / ($\Delta\nu_d = "
                           + f"{round(ds.dnu, 2)}" + r"\,$MHz)")
            ax3 = ax1.twiny()
            minx, maxx = ax1.get_xlim()
            ax3.set_xlim(minx / (ds.tau / 60), maxx / (ds.tau / 60))
            ax3.set_xlabel(r"$\tau$/($\tau_d="
                           + f"{round(ds.tau / 60, 2)}" + r"\,$min)")
    else:
        ax1.set_ylabel("Frequency lag (MHz)")
        ax1.set_xlabel("Time lag (mins)")
    return _finish(plt, fig, filename, display, dpi)


def _split_filename(filename, tag):
    """'x.png' → 'x_<tag>.png' (reference suffix convention,
    dynspec.py:2417-2419)."""
    name = "".join(filename.split(".")[:-1])
    ext = filename.split(".")[-1]
    return f"{name}_{tag}.{ext}"


def plot_acf_tilt(ds, peaks, peakerrs, ys, yfit, nscaleplot=2,
                  tmaxplot=None, fmaxplot=None, filename=None,
                  display=True, figsize=(9, 9), dpi=200):
    """Two tilt diagnostics (dynspec.py:2415-2462): the per-row peak
    measurements with the weighted line fit, and the ACF with the
    fitted tilt overlaid."""
    plt = _mpl()
    figs = []

    fig = plt.figure(figsize=figsize)
    plt.errorbar(peaks, ys, xerr=np.asarray(peakerrs).squeeze(),
                 marker=".")
    plt.plot(peaks, yfit)
    plt.ylabel("Frequency lag (MHz)")
    plt.xlabel("Time lag (mins)")
    plt.title("Peak measurements, and weighted fit")
    figs.append(_finish(plt, fig,
                        filename and _split_filename(filename,
                                                     "tilt_fit"),
                        display, dpi))

    acf = np.array(_np(ds.acf))
    # same lag-axis convention as the peak measurements in
    # get_acf_tilt (dynspec.py) so the overlay aligns with the pixels
    t_delays = np.linspace(-ds.tobs / 60, ds.tobs / 60,
                           acf.shape[1] + 1)[:-1]
    f_shifts = np.linspace(-ds.bw, ds.bw, acf.shape[0] + 1)[:-1]
    fig = plt.figure(figsize=figsize)
    plt.pcolormesh(centres_to_edges(t_delays),
                   centres_to_edges(f_shifts), acf, linewidth=0,
                   rasterized=True, shading="auto")
    plt.plot(peaks, ys, "r", alpha=0.5)
    plt.plot(peaks, yfit, "k", alpha=0.5)
    yl = plt.ylim()
    if yl[1] > nscaleplot * ds.dnu:
        plt.ylim(-nscaleplot * ds.dnu, nscaleplot * ds.dnu)
    if fmaxplot is not None and yl[1] > fmaxplot:
        plt.ylim(-fmaxplot, fmaxplot)
    xl = plt.xlim()
    if xl[1] > nscaleplot * ds.tau / 60:
        plt.xlim(-nscaleplot * ds.tau / 60, nscaleplot * ds.tau / 60)
    if tmaxplot is not None and xl[1] > tmaxplot:
        plt.xlim(-tmaxplot, tmaxplot)
    plt.ylabel("Frequency lag (MHz)")
    plt.xlabel("Time lag (mins)")
    err = np.sqrt(ds.acf_tilt_err ** 2 + ds.fse_tilt ** 2)
    plt.title(f"Tilt = {round(ds.acf_tilt, 3)} $\\pm$ "
              f"{round(err, 3)} (min/MHz)")
    figs.append(_finish(plt, fig,
                        filename and _split_filename(filename,
                                                     "tilt_acf"),
                        display, dpi))
    return figs


def plot_cut_tiles(ds, lamsteps=False, maxfdop=np.inf, filename=None,
                   display=True, figsize=(8, 13), dpi=200):
    """Tiled dynspec / ACF / sspec figures for ``cut_dyn``
    (dynspec.py:3211-3268): one subplot per tile, three figures saved
    with the reference's ``_dynspec``/``_acf``/``_sspec`` suffixes."""
    plt = _mpl()
    nfc, ntc = ds.cutdyn.shape[:2]
    figs = []
    for tag, plot_tile in (
            ("dynspec", lambda ii, jj: plt.pcolormesh(
                centres_to_edges(ds.cut_times[jj] / 60),
                centres_to_edges(ds.cut_freqs[ii]),
                ds.cutdyn[ii, jj], linewidth=0, rasterized=True,
                shading="auto")),
            ("acf", lambda ii, jj: plt.pcolormesh(
                ds.cutacf[ii, jj], linewidth=0, rasterized=True,
                shading="auto")),
            ("sspec", lambda ii, jj: _tile_sspec(
                plt, ds.cutsspec[ii, jj], ds.cut_sspec_x,
                ds.cut_sspec_y, maxfdop, lamsteps))):
        fig = plt.figure(figsize=figsize)
        plotnum = 1
        for ii in range(nfc):
            for jj in range(ntc):
                plt.subplot(nfc, ntc, plotnum)
                plot_tile(ii, jj)
                plotnum += 1
        figs.append(_finish(plt, fig,
                            filename and _split_filename(filename, tag),
                            display, dpi))
    return figs


def _tile_sspec(plt, sspec, x, y, maxfdop, lamsteps=False):
    valid = sspec[is_valid(sspec) & (np.abs(sspec) > 0)]
    vmin = np.median(valid) - 3 if valid.size else None
    vmax = np.max(valid) - 3 if valid.size else None
    sel = np.abs(x) <= maxfdop
    plt.pcolormesh(centres_to_edges(x[sel]), centres_to_edges(y),
                   sspec[:, sel], vmin=vmin, vmax=vmax, linewidth=0,
                   rasterized=True, shading="auto")
    plt.ylabel(r"$f_\lambda$ (m$^{-1}$)" if lamsteps
               else r"$f_\nu$ ($\mu$s)")


def plot_sspec(ds, lamsteps=False, input_sspec=None, filename=None,
               input_x=None, input_y=None, trap=False, prewhite=False,
               plotarc=False, maxfdop=np.inf, delmax=None, cutmid=0,
               startbin=0, display=True, colorbar=True, title=None,
               figsize=(9, 9), subtract_artefacts=False,
               overplot_curvature=None, dpi=200, velocity=False,
               vmin=None, vmax=None):
    """Secondary spectrum (dynspec.py:693-853): every reference kwarg
    is honoured — prewhitened recompute, constant-delay artefact
    subtraction, central-Doppler ``cutmid`` / low-delay ``startbin``
    masking, ``delmax`` crop, explicit colour limits, and arc
    overlays (fitted via ``plotarc`` or explicit curvature via
    ``overplot_curvature``)."""
    plt = _mpl()
    if input_sspec is None:
        if prewhite:
            # reference semantics (dynspec.py:756-772): prewhite only
            # affects a FRESH computation — an existing stored sspec
            # is plotted as-is, never overwritten
            attr = ("vlamsspec" if lamsteps and velocity else
                    "lamsspec" if lamsteps else
                    "vsspec" if velocity else
                    "trapsspec" if trap else "sspec")
            if not hasattr(ds, attr):
                ds.calc_sspec(lamsteps=lamsteps, trap=trap,
                              velocity=velocity, prewhite=True)
        sspec, yaxis = ds._select_sspec(lamsteps=lamsteps, trap=trap,
                                        velocity=velocity)
        xaxis = np.asarray(ds.fdop)
    else:
        sspec = _np(input_sspec)
        xaxis = np.asarray(_np(input_x))
        yaxis = np.asarray(_np(input_y))
    sspec = np.array(sspec, dtype=float)

    if subtract_artefacts:
        # constant-in-Doppler delay response from the outer 10%
        # (dynspec.py:780-787)
        outer = np.abs(xaxis) > 0.9 * np.max(np.abs(xaxis))
        delay_response = np.nanmean(sspec[:, outer], axis=1)
        delay_response = delay_response - np.median(delay_response)
        sspec = sspec - delay_response[:, None]

    valid = sspec[is_valid(sspec) & (np.abs(sspec) > 0)]
    if valid.size:
        vmin = np.median(valid) - 3 if vmin is None else vmin
        vmax = np.max(valid) - 3 if vmax is None else vmax

    sel = np.abs(xaxis) <= maxfdop
    xplot = xaxis[sel]
    sspec = sspec[:, sel]
    nc = sspec.shape[1]
    if cutmid:
        sspec[:, int(nc / 2 - np.floor(cutmid / 2)):
              int(nc / 2 + np.ceil(cutmid / 2))] = np.nan
    if startbin:
        sspec[:startbin, :] = np.nan
    if delmax is None:
        ind = len(yaxis)
    else:
        # delmax is defined on the tdel axis (µs) like the reference
        tdel = np.asarray(getattr(ds, "tdel", yaxis))
        ind = max(int(np.argmin(np.abs(tdel[:len(yaxis)] - delmax))),
                  1)

    fig = plt.figure(figsize=figsize)
    plt.pcolormesh(centres_to_edges(xplot),
                   centres_to_edges(yaxis[:ind]), sspec[:ind, :],
                   vmin=vmin, vmax=vmax, linewidth=0, rasterized=True,
                   shading="auto")
    bottom, top = plt.ylim()
    if overplot_curvature is not None:
        plt.plot(xplot, overplot_curvature * xplot ** 2, "r--")
    if plotarc:
        eta = ds.betaeta if lamsteps else ds.eta
        plt.plot(xplot, eta * xplot ** 2, "r--", alpha=0.5)
    plt.ylim(bottom, top)
    plt.xlabel(r"$f_t$ (mHz)")
    plt.ylabel(r"$f_\lambda$ (m$^{-1}$)" if lamsteps
               else r"$f_\nu$ ($\mu$s)")
    if colorbar:
        plt.colorbar()
    if title:
        plt.title(title)
    return _finish(plt, fig, filename, display, dpi)


def plot_arc_fit(fit, lamsteps=False, filename=None, display=True,
                 figsize=(9, 9), dpi=200, figN=None):
    """Curvature-fit diagnostic (dynspec.py:1315-1346). ``figN``
    selects an existing figure number (dynspec.py:1316-1319)."""
    plt = _mpl()
    fig = (plt.figure(figsize=figsize) if figN is None
           else plt.figure(figN, figsize=figsize))
    plt.plot(fit.eta_array[10:], fit.profile[10:])
    if fit.xdata is not None:
        plt.plot(fit.xdata, fit.yfit, "k")
    plt.axvspan(xmin=fit.eta - fit.etaerr, xmax=fit.eta + fit.etaerr,
                facecolor="C2", alpha=0.5)
    plt.xscale("log")
    if lamsteps:
        plt.xlabel(r"Arc curvature, "
                   r"$\eta$ (${\rm m}^{-1}\,{\rm mHz}^{-2}$)")
    else:
        plt.xlabel("eta (tdel)")
    plt.ylabel("Mean power (dB)")
    return _finish(plt, fig, filename, display, dpi)


def plot_norm_sspec(ds, scrunched=True, unscrunched=True, powerspec=True,
                    plot_fit=True, maxnormfac=5, lamsteps=True,
                    filename=None, display=True, figsize=(9, 9),
                    dpi=200):
    """Normalised sspec panels (dynspec.py:2185-2279)."""
    plt = _mpl()
    figs = []
    if scrunched:
        fig = plt.figure(figsize=figsize)
        plt.plot(ds.normsspec_fdop, ds.normsspecavg)
        if plot_fit:
            for x in (-1, 1):
                plt.axvline(x, color="r", linestyle="--", alpha=0.5)
        plt.xlabel(r"Normalised $f_t$")
        plt.ylabel("Mean power (dB)")
        plt.xlim(-maxnormfac, maxnormfac)
        figs.append(_finish(plt, fig, filename and
                            filename.replace(".", "_1d.", 1), display,
                            dpi))
    if unscrunched:
        fig = plt.figure(figsize=figsize)
        arr = np.ma.filled(np.ma.array(ds.normsspec, mask=ds.mask),
                           np.nan)
        plt.pcolormesh(centres_to_edges(ds.normsspec_fdop),
                       centres_to_edges(ds.normsspec_tdel), arr,
                       linewidth=0, rasterized=True, shading="auto")
        plt.xlabel(r"Normalised $f_t$")
        plt.ylabel(r"$f_\lambda$ (m$^{-1}$)" if lamsteps
                   else r"$f_\nu$ ($\mu$s)")
        plt.colorbar()
        figs.append(_finish(plt, fig, filename, display, dpi))
    if powerspec:
        fig = plt.figure(figsize=figsize)
        x = np.sqrt(ds.normsspec_tdel)
        y = x * ds.powerspectrum
        plt.loglog(x, y)
        plt.xlabel(r"$f_\lambda^{1/2}$" if lamsteps
                   else r"$f_\nu^{1/2}$")
        plt.ylabel(r"$f^{1/2} D(f^{1/2})$")
        plt.grid(which="both", axis="both")
        figs.append(_finish(plt, fig, filename and
                            filename.replace(".", "_power.", 1),
                            display, dpi))
    return figs


def plot_scattered_image(ds, input_scattered_image=None, input_fdop=None,
                         display=True, plot_log=True, colorbar=True,
                         title=None, use_angle=False, use_spatial=False,
                         s=None, veff=None, d=None, filename=None,
                         figsize=(9, 9), dpi=200):
    """Scattered image (dynspec.py:855-968): optional on-sky angle
    (arcsec, needs fractional screen distance ``s`` and effective
    velocity ``veff`` km/s) or spatial (AU, additionally distance
    ``d`` kpc) axes — dynspec.py:916-928."""
    plt = _mpl()
    c = 299792458.0
    im = np.array(_np(input_scattered_image
                      if input_scattered_image is not None
                      else ds.scattered_image), dtype=float)
    xyaxes = np.asarray(_np(input_fdop if input_fdop is not None
                            else ds.scattered_image_ax), dtype=float)
    if use_angle or use_spatial:
        if s is None or veff is None:
            raise ValueError("use_angle/use_spatial need s and veff")
        thetarad = (xyaxes / (1e9 * ds.freq)) * (c * s / (veff * 1000))
        thetaas = (thetarad * 180 / np.pi) * 3600
        if use_angle:
            xyaxes = thetaas
        else:
            if d is None:
                raise ValueError("use_spatial needs the distance d")
            xyaxes = thetaas * (1 - s) * d * 1000

    if plot_log:
        im = im - np.min(im)
        im = im + 1e-10
        im = 10 * np.log10(im)
    valid = im[is_valid(im) & (np.abs(im) > 0)]
    vmin = np.median(valid) - 3 if valid.size else None
    vmax = np.max(valid) - 3 if valid.size else None

    fig = plt.figure(figsize=figsize)
    plt.pcolormesh(centres_to_edges(xyaxes), centres_to_edges(xyaxes),
                   im, vmin=vmin, vmax=vmax, linewidth=0,
                   rasterized=True, shading="auto")
    if use_angle:
        plt.xlabel("Angle parallel to velocity (as)")
        plt.ylabel("Angle perpendicular to velocity (as)")
    elif use_spatial:
        plt.xlabel("Distance parallel to velocity (AU)")
        plt.ylabel("Distance perpendicular to velocity (AU)")
    else:
        plt.xlabel("Angle parallel to velocity")
        plt.ylabel("Angle perpendicular to velocity")
    plt.title(title if title else "Scattered image")
    if colorbar:
        plt.colorbar()
    return _finish(plt, fig, filename, display, dpi)


def plot_eta_evolution(ds, time_avg=False, filename=None, display=True,
                       figsize=(9, 9), dpi=200):
    """η(f) per-chunk datapoints + the fitted η ∝ f⁻² curve after
    ``fit_thetatheta`` (dynspec.py:1746-1764)."""
    from .thth.retrieval import err_string

    plt = _mpl()
    fig = plt.figure(figsize=figsize)
    label = err_string(ds.ththeta * ds.fref ** 2,
                       ds.ththetaerr * ds.fref ** 2)
    if time_avg:
        eta_avg = np.nanmean(ds.eta_evo, 1)
        avg_err = (np.nanstd(ds.eta_evo, 1)
                   / np.sqrt(max(ds.eta_evo.shape[1] - 1, 1)))
        plt.errorbar(ds.f0s, eta_avg, yerr=avg_err, fmt=".")
    else:
        plt.errorbar(
            np.ravel(ds.f0s[:, None] * np.ones(ds.eta_evo.shape)),
            np.ravel(ds.eta_evo), yerr=np.ravel(ds.eta_evo_err),
            fmt=".")
    A = ds.ththeta * ds.fref ** 2
    plt.plot(ds.f0s, A / ds.f0s ** 2,
             label=rf"$\eta$ = {label} $s^3$")
    plt.xlabel(r"$\rm{Freq}~\left(\rm{MHz}\right)$")
    plt.ylabel(r"$\eta~\left(\rm{s}^3\right)$")
    plt.legend()
    return _finish(plt, fig, filename, display, dpi)


def plot_scint_fit_1d(ds, results, xdata_t, ydata_t, t_errors,
                      xdata_f, ydata_f, f_errors, filename=None,
                      display=True, dpi=200):
    """acf1d fit diagnostic: data ± error with the fitted model and
    the ±1/√n white-noise bands (dynspec.py:3051-3109)."""
    from .fit import models as mdl

    plt = _mpl()
    fig, axes = plt.subplots(2, 1, figsize=(8, 6))
    panels = [
        (xdata_t, ydata_t, t_errors, mdl.tau_acf_model_values,
         ds.nsub, r"$\tau$ (s)", r"$\pm 1/\sqrt{n_\mathrm{sub}}$"),
        (xdata_f, ydata_f, f_errors, mdl.dnu_acf_model_values,
         ds.nchan, r"$\Delta\nu$ (MHz)",
         r"$\pm 1/\sqrt{n_\mathrm{chan}}$"),
    ]
    for ax, (x, y, err, model, n, xlabel, wnlabel) in zip(axes,
                                                          panels):
        xm = np.linspace(min(x), max(x), 1000)
        ym = np.asarray(model(results.params, xm))
        ax.plot(x, y, label="data")
        ax.fill_between(x, y + err, y - err, color="C0", alpha=0.4,
                        label="error")
        ax.plot(xm, ym, label="model")
        xl = ax.get_xlim()
        ax.plot([0, xl[1]], [0, 0], "k--")
        wn = 1 / np.sqrt(n)
        ax.plot([0, xl[1]], [wn, wn], ":", color="crimson",
                label=wnlabel)
        ax.plot([0, xl[1]], [-wn, -wn], ":", color="crimson")
        ax.set_xlabel(xlabel)
        ax.legend()
    fig.tight_layout()
    return _finish(plt, fig,
                   filename and _split_filename(filename, "1Dfit"),
                   display, dpi)


def plot_scint_fit_2d(ds, results, method, tdata, fdata, ydata_2d,
                      filename=None, display=True, dpi=200):
    """acf2d fit diagnostic: data / model / residual panels with the
    white-noise spike subtracted (dynspec.py:3111-3155)."""
    from .fit import models as mdl

    plt = _mpl()
    if method == "acf2d_approx":
        model = np.asarray(mdl.scint_acf_model_2d_approx_values(
            results.params, tdata, fdata))
    else:
        model = np.asarray(mdl.scint_acf_model_2d_values(
            results.params, np.shape(ydata_2d), device=ds.device))
    residuals = ydata_2d - model
    fig, axes = plt.subplots(1, 3, sharey=True, figsize=(15, 5))
    for i, (arr, name) in enumerate([(ydata_2d, "data"),
                                     (model, "model"),
                                     (residuals, "residuals")]):
        arr = np.array(arr, dtype=float)
        if name != "residuals":
            arr = np.fft.ifftshift(arr)
            arr[0][0] -= ds.wn
            arr = np.fft.fftshift(arr)
        mesh = axes[i].pcolormesh(centres_to_edges(tdata / 60),
                                  centres_to_edges(fdata), arr,
                                  linewidth=0, rasterized=True,
                                  shading="auto")
        if name == "residuals":
            mesh.set_clim(vmin=-1, vmax=1)
        axes[i].set_title(name)
        axes[i].set_xlabel(r"$\tau$ (mins)")
        if i == 0:
            axes[i].set_ylabel(r"$\Delta\nu$ (MHz)")
    fig.tight_layout()
    return _finish(plt, fig,
                   filename and _split_filename(filename, "2Dfit"),
                   display, dpi)


def plot_all(ds, dyn=1, sspec=3, acf=2, norm_sspec=4, colorbar=True,
             lamsteps=False, filename=None, display=True,
             figsize=(9, 9), dpi=200):
    """Composite summary (dynspec.py plot_all role). The reference
    renders four NUMBERED figures (``dyn``/``sspec``/``acf``/
    ``norm_sspec`` are figure numbers); here the same integers pick
    the subplot ordering of one composite figure — pass 0 to omit a
    panel."""
    plt = _mpl()
    if not hasattr(ds, "acf"):
        ds.calc_acf()
    sec, yaxis = ds._select_sspec(lamsteps=lamsteps)
    valid = sec[is_valid(sec) & (np.abs(sec) > 0)]

    def draw_dyn():
        plt.pcolormesh(centres_to_edges(ds.times / 60),
                       centres_to_edges(ds.freqs), ds.dyn,
                       shading="auto")
        plt.title("Dynamic spectrum")

    def draw_acf():
        plt.pcolormesh(ds.acf, shading="auto")
        plt.title("ACF")

    def draw_sspec():
        plt.pcolormesh(centres_to_edges(ds.fdop),
                       centres_to_edges(yaxis), sec,
                       vmin=np.median(valid) - 3,
                       vmax=np.max(valid) - 3, shading="auto")
        if colorbar:
            plt.colorbar()
        plt.title("Secondary spectrum")

    def draw_norm():
        if hasattr(ds, "normsspecavg"):
            plt.plot(ds.normsspec_fdop, ds.normsspecavg)
            plt.title("Normalised sspec")
        else:
            plt.gca().axis("off")

    panels = sorted([(dyn, draw_dyn), (acf, draw_acf),
                     (sspec, draw_sspec), (norm_sspec, draw_norm)],
                    key=lambda p: p[0])
    panels = [p for p in panels if p[0]]
    fig, axes = plt.subplots(2, 2, figsize=figsize)
    for ax, (_, draw) in zip(axes.ravel(), panels):
        plt.sca(ax)
        draw()
    for ax in axes.ravel()[len(panels):]:
        ax.axis("off")
    plt.tight_layout()
    return _finish(plt, fig, filename, display, dpi)
