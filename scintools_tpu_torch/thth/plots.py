"""Per-chunk θ-θ diagnostic figure.

Counterpart of ``scintools_tpu/thth/plots.py`` (``plot_func``, :19), the
reference's chunk diagnostic (ththmod.py:898-1220): data and model
dynamic spectra, data and model secondary spectra with the fitted arc
overlaid, data and model θ-θ, the derotated θ-θ (real and imaginary),
the η-search curve with its parabola fit, and the recovered wavefield's
phases and secondary wavefield. The θ-θ maps, the rank-1 model and the
inverse map come from :mod:`.core` on ``device``; the figure is drawn
from their host copies.
"""

from __future__ import annotations

import numpy as np

from .core import (ext_find, modeler, rev_map,
                   unit_checks)
from .search import chi_par


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


def plot_func(dspec, time, freq, CS, fd, tau, edges, eta_fit, eta_sig,
              etas, measure, etas_fit, fit_res, tau_lim=None,
              method="eigenvalue", fig=None, backend=None, device=None):
    """Build the 12-panel chunk diagnostic; returns the figure.

    Matches the reference's panel layout (ththmod.py:1021-1218). The
    θ-θ arrays are computed on ``device`` (``None``: the card);
    matplotlib is imported here, so a pipeline that draws nothing never
    loads it. ``backend`` is the JAX package's and must stay None.
    """
    if backend is not None:
        raise ValueError("backend is the JAX package's; the port runs on "
                         "device")
    from ..plotting import _mpl

    plt = _mpl()
    from matplotlib.gridspec import GridSpec

    time = np.asarray(unit_checks(time, "time"), dtype=float)
    freq = np.asarray(unit_checks(freq, "freq"), dtype=float)
    tau = np.asarray(unit_checks(tau, "tau"), dtype=float)
    fd = np.asarray(unit_checks(fd, "fd"), dtype=float)
    edges = np.asarray(unit_checks(edges, "edges"), dtype=float)
    etas = np.asarray(unit_checks(etas, "etas"), dtype=float)
    etas_fit = np.asarray(unit_checks(etas_fit, "etas_fit"), dtype=float)
    eta_fit = float(unit_checks(eta_fit, "eta_fit"))
    eta_sig = float(unit_checks(eta_sig, "eta_sig"))
    measure = np.asarray(_host(measure), dtype=float)
    dspec = np.asarray(_host(dspec), dtype=float)
    CS = _host(CS)
    tau_lim = tau.max() if tau_lim is None else float(
        unit_checks(tau_lim, "tau_lim"))
    fd_lim = min(2 * edges.max(), fd.max())

    eta = etas.mean() if np.isnan(eta_fit) else eta_fit
    thth_red, thth2_red, recov, model, edges_red, w, V = modeler(
        CS, tau, fd, eta, edges, device=device)
    thth_red, thth2_red, model, V = map(_host, (thth_red, thth2_red, model,
                                                V))

    # model wavefield (same construction as single_chunk_retrieval)
    ththE_red = np.zeros_like(thth_red)
    ththE_red[ththE_red.shape[0] // 2, :] = np.conj(V) * np.sqrt(w)
    recov_E = _host(rev_map(ththE_red, tau, fd, eta, edges_red,
                            hermetian=False, device=device))
    model_E = np.fft.ifft2(np.fft.ifftshift(recov_E))[
        : dspec.shape[0], : dspec.shape[1]]
    model_E *= dspec.shape[0] * dspec.shape[1] / 4
    good = dspec > 0
    model_E[good] = (np.sqrt(dspec[good])
                     * np.exp(1j * np.angle(model_E[good])))
    model_E = np.pad(model_E,
                     ((0, CS.shape[0] - model_E.shape[0]),
                      (0, CS.shape[1] - model_E.shape[1])),
                     mode="constant")
    recov_E = np.abs(np.fft.fftshift(np.fft.fft2(model_E))) ** 2
    model = model[: dspec.shape[0], : dspec.shape[1]]

    # derotated θ-θ: remove the rank-1 phase to expose residuals
    with np.errstate(divide="ignore", invalid="ignore"):
        derot = thth_red * np.conj(thth2_red) / np.abs(thth2_red)
    derot = np.nan_to_num(derot)

    S_data = np.abs(CS) ** 2
    S_model = np.abs(np.fft.fftshift(
        np.fft.fft2(model, s=CS.shape))) ** 2

    t_min = time / 60.0
    if fig is None:
        fig = plt.figure(figsize=(8, 16))
    grid = GridSpec(6, 2, figure=fig)
    ext_dyn = ext_find(t_min, freq)
    ext_ss = ext_find(fd, tau)
    ext_th = ext_find(edges_red, edges_red)

    def _log(x):
        with np.errstate(divide="ignore"):
            return np.log10(np.where(x > 0, x, np.nan))

    ax = fig.add_subplot(grid[0, 0])
    ax.imshow(dspec, aspect="auto", origin="lower", extent=ext_dyn)
    ax.set_xlabel("Time (min)")
    ax.set_ylabel("Freq (MHz)")
    ax.set_title("Data Dynamic Spectrum")

    ax = fig.add_subplot(grid[0, 1])
    ax.imshow(model, aspect="auto", origin="lower", extent=ext_dyn,
              vmin=np.nanmin(dspec), vmax=np.nanmax(dspec))
    ax.set_xlabel("Time (min)")
    ax.set_title("Model Dynamic Spectrum")

    for col, (S, name) in enumerate([(S_data, "Data"),
                                     (S_model, "Model")]):
        ax = fig.add_subplot(grid[1, col])
        ax.imshow(_log(S), aspect="auto", origin="lower", extent=ext_ss,
                  vmin=np.nanmedian(_log(S_data)),
                  vmax=np.nanmax(_log(S_data)))
        ax.plot(fd, eta * fd ** 2, "r", alpha=0.7)
        ax.set_xlim(-fd_lim, fd_lim)
        ax.set_ylim(0, tau_lim)
        ax.set_xlabel(r"$f_D$ (mHz)")
        ax.set_ylabel(r"$\tau$ (us)")
        ax.set_title(f"{name} Secondary Spectrum")

    for col, (M, name) in enumerate([(thth_red, r"Data $\theta-\theta$"),
                                     (thth2_red,
                                      r"Model $\theta-\theta$")]):
        ax = fig.add_subplot(grid[2, col])
        ax.imshow(_log(np.abs(M) ** 2), aspect="auto", origin="lower",
                  extent=ext_th)
        ax.set_xlabel(r"$\theta_1$")
        ax.set_ylabel(r"$\theta_2$")
        ax.set_title(name)

    for col, (M, name) in enumerate(
            [(derot.real, r"Derotated $\theta-\theta$ (real)"),
             (derot.imag, r"Derotated $\theta-\theta$ (imag)")]):
        ax = fig.add_subplot(grid[3, col])
        ax.imshow(M, aspect="auto", origin="lower", extent=ext_th,
                  norm=None)
        ax.set_xlabel(r"$\theta_1$")
        ax.set_ylabel(r"$\theta_2$")
        ax.set_title(name)

    ax = fig.add_subplot(grid[4, :])
    ax.plot(etas, measure)
    if np.isfinite(eta_fit) and fit_res is not None:
        fit_curve = chi_par(etas_fit, *fit_res)
        ax.plot(etas_fit, fit_curve, "r",
                label=rf"$\eta$ = {eta_fit:.3g} $\pm$ {eta_sig:.2g} "
                      r"$s^3$")
        ax.legend()
    ax.set_title("Eigenvalue Search" if method == "eigenvalue"
                 else "Chisquare Search")
    ax.set_xlabel(r"$\eta$ ($s^3$)")
    ax.set_ylabel(r"$\lambda$" if method == "eigenvalue"
                  else r"$\chi^2$")

    ax = fig.add_subplot(grid[5, 0])
    ax.imshow(np.angle(model_E[: dspec.shape[0], : dspec.shape[1]]),
              aspect="auto", origin="lower", extent=ext_dyn,
              cmap="twilight", vmin=-np.pi, vmax=np.pi)
    ax.set_xlabel("Time (min)")
    ax.set_ylabel("Freq (MHz)")
    ax.set_title("Recovered Phases")

    ax = fig.add_subplot(grid[5, 1])
    ax.imshow(_log(recov_E), aspect="auto", origin="lower",
              extent=ext_find(fd, np.fft.fftshift(np.fft.fftfreq(
                  model_E.shape[0], np.diff(freq).mean()))),
              vmin=np.nanmax(_log(recov_E)) - 8)
    ax.set_xlim(-fd_lim, fd_lim)
    ax.set_ylim(-tau_lim, tau_lim)
    ax.set_xlabel(r"$f_D$ (mHz)")
    ax.set_ylabel(r"$\tau$ (us)")
    ax.set_title("Recovered Secondary Wavefield")

    fig.tight_layout()
    return fig
