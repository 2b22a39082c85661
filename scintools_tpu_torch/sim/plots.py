"""Plotting for the simulation classes.

Counterpart of ``scintools_tpu/sim/plots.py`` (:23-332): the seven
:class:`~.simulation.Simulation` plots (reference scint_sim.py:313-415),
the three :class:`~.acf_model.ACF` model plots (:680-765) and the five
:class:`~.brightness.Brightness` plots (:960-1065). The classes keep
their results as host numpy arrays; these functions only draw them, so
they take the sim object first and are also the classes' ``plot_*``
methods. matplotlib is imported inside the functions.
"""

from __future__ import annotations

import os

import numpy as np

from ..plotting import _mpl, _finish
from ..utils.misc import is_valid, centres_to_edges


# ---------------------------------------------------------------- Simulation

def plot_screen(sim, subplot=False, filename=None, display=True, dpi=200):
    """Phase-screen image (scint_sim.py:313-324)."""
    plt = _mpl()
    fig = plt.gcf() if subplot else plt.figure()
    x_steps = np.linspace(0, sim.dx * sim.nx, sim.nx)
    y_steps = np.linspace(0, sim.dy * sim.ny, sim.ny)
    plt.pcolormesh(x_steps, y_steps, np.transpose(sim.xyp),
                   shading="auto")
    plt.title("Screen phase")
    plt.ylabel(r"$y/r_f$")
    plt.xlabel(r"$x/r_f$")
    if subplot:
        return fig
    return _finish(plt, fig, filename, display, dpi)


def plot_intensity(sim, subplot=False, filename=None, display=True,
                   dpi=200):
    """Observer-plane intensity image (scint_sim.py:326-338)."""
    plt = _mpl()
    fig = plt.gcf() if subplot else plt.figure()
    x_steps = np.linspace(0, sim.dx * sim.nx, sim.nx)
    y_steps = np.linspace(0, sim.dy * sim.ny, sim.ny)
    plt.pcolormesh(x_steps, y_steps, np.transpose(sim.xyi),
                   shading="auto")
    plt.title("Intensity / Mean")
    plt.ylabel(r"$y/r_f$")
    plt.xlabel(r"$x/r_f$")
    if subplot:
        return fig
    return _finish(plt, fig, filename, display, dpi)


def plot_sim_dynspec(sim, subplot=False, filename=None, display=True,
                     dpi=200):
    """Simulated dynamic spectrum in sim-normalised axes
    (scint_sim.py:340-354)."""
    plt = _mpl()
    fig = plt.gcf() if subplot else plt.figure()
    if not hasattr(sim, "spi"):  # nf=1 runs skip get_dynspec
        sim.get_dynspec()        # (scint_sim.py:341-342)
    yaxis = sim.lams if sim.lamsteps else sim.freqs
    plt.pcolormesh(sim.x, yaxis, np.transpose(sim.spi), shading="auto")
    plt.ylabel(r"Wavelength $\lambda$" if sim.lamsteps
               else "Frequency f")
    plt.title("Dynamic Spectrum (Intensity/Mean)")
    plt.xlabel(r"$x/r_f$")
    if subplot:
        return fig
    return _finish(plt, fig, filename, display, dpi)


def plot_efield(sim, subplot=False, filename=None, display=True,
                dpi=200):
    """Real part of the propagated electric field
    (scint_sim.py:356-372)."""
    plt = _mpl()
    fig = plt.gcf() if subplot else plt.figure()
    if not hasattr(sim, "x"):    # axes come from get_dynspec
        sim.get_dynspec()        # (scint_sim.py:357-358 guard role)
    yaxis = sim.lams if sim.lamsteps else sim.freqs
    plt.pcolormesh(sim.x, yaxis, np.real(np.transpose(sim.spe)),
                   shading="auto")
    plt.ylabel(r"Wavelength $\lambda$" if sim.lamsteps
               else "Frequency f")
    plt.title("Electric field (Intensity/Mean)")
    plt.xlabel(r"$x/r_f$")
    if subplot:
        return fig
    return _finish(plt, fig, filename, display, dpi)


def plot_delay(sim, filename=None, display=True, dpi=200):
    """Group delay along the screen + mean impulse response
    (scint_sim.py:374-387)."""
    plt = _mpl()
    fig = plt.figure()
    freq_ghz = sim.freq / 1000
    plt.subplot(2, 1, 1)
    plt.plot(np.linspace(0, sim.dx * sim.nx, sim.nx),
             -sim.dm / (2 * sim.dlam * freq_ghz))
    plt.ylabel("Group delay (ns)")
    plt.xlabel(r"$x/r_f$")
    plt.subplot(2, 1, 2)
    plt.plot(np.mean(sim.pulsewin, axis=1))
    plt.ylabel("Intensity (arb)")
    plt.xlabel("Delay (arb)")
    return _finish(plt, fig, filename, display, dpi)


def plot_pulse(sim, filename=None, display=True, dpi=200):
    """Log pulse-response waterfall with the group-delay overlay
    (scint_sim.py:389-404)."""
    plt = _mpl()
    fig = plt.figure()
    freq_ghz = sim.freq / 1000
    with np.errstate(divide="ignore"):
        lpw = np.log10(sim.pulsewin)
    vmax = np.max(lpw[np.isfinite(lpw)])
    vmin = np.median(lpw[np.isfinite(lpw)]) - 3
    x = np.linspace(0, sim.dx * sim.nx, sim.nx)
    delay = (np.arange(0, 3 * sim.nf / 2, 1) - sim.nf / 2) / (
        2 * sim.dlam * freq_ghz)
    plt.pcolormesh(x, delay, lpw[int(sim.nf / 2):, :], vmin=vmin,
                   vmax=vmax, shading="auto")
    plt.ylabel("Delay (ns)")
    plt.xlabel(r"$x/r_f$")
    # group delay = -phase delay
    plt.plot(x, -sim.dm / (2 * sim.dlam * freq_ghz), "k")
    return _finish(plt, fig, filename, display, dpi)


def plot_sim_all(sim, filename=None, display=True, dpi=200):
    """2×2 summary figure: screen, intensity, dynspec
    (scint_sim.py:406-414)."""
    plt = _mpl()
    fig = plt.figure(figsize=(9, 7))
    plt.subplot(2, 2, 1)
    plot_screen(sim, subplot=True)
    plt.subplot(2, 2, 2)
    plot_intensity(sim, subplot=True)
    plt.subplot(2, 1, 2)
    plot_sim_dynspec(sim, subplot=True)
    fig.tight_layout()
    return _finish(plt, fig, filename, display, dpi)


# ----------------------------------------------------------------------- ACF

def plot_acf_model(acf, display=True, contour=True, filled=False,
                   filename=None, dpi=200):
    """Model intensity ACF with optional 0.2–0.8 contours
    (scint_sim.py:680-709)."""
    plt = _mpl()
    fig = plt.figure()
    tn_edges = centres_to_edges(acf.tn)
    fn_edges = centres_to_edges(acf.fn)
    levels = acf.amp * np.array([0.2, 0.4, 0.6, 0.8])
    if not filled:
        plt.pcolormesh(tn_edges, fn_edges, acf.acf, shading="auto")
        if contour:
            plt.contour(acf.tn, acf.fn, acf.acf, levels, colors="k")
    else:
        plt.contourf(acf.tn, acf.fn, acf.acf,
                     acf.amp * np.arange(0, 1.05, 0.1))
    plt.xlabel(r"Time lag ($\tau/\tau_{d,\rm{iso}}$)")
    plt.ylabel(r"Frequency lag ($\Delta\nu/\Delta\nu_{d,\rm{iso}}$)")
    if display or filename:
        plt.title("ACF of intensity")
    return _finish(plt, fig, filename, display, dpi)


def plot_acf_efield_model(acf, display=True, filename=None, dpi=200):
    """Electric-field ACF on the spatial integration grid
    (scint_sim.py:711-726)."""
    plt = _mpl()
    fig = plt.figure()
    snp_edges = centres_to_edges(acf.snp)
    plt.pcolormesh(snp_edges, snp_edges, acf.acf_efield, shading="auto")
    plt.xlabel(r"$S_x$ ($x/s_{d,\rm{iso}}$)")
    plt.ylabel(r"$S_y$ ($y/s_{d,\rm{iso}}$)")
    plt.title("ACF of electric field")
    return _finish(plt, fig, filename, display, dpi)


def plot_acf_sspec(acf, display=True, vmin=None, vmax=None,
                   filename=None, dpi=200):
    """Secondary spectrum of the model ACF (scint_sim.py:744-765)."""
    plt = _mpl()
    fig = plt.figure()
    if not hasattr(acf, "sspec"):
        acf.calc_sspec()
    sspec = acf.sspec
    good = is_valid(sspec) & (np.abs(sspec) > 0)
    medval = np.median(sspec[good])
    maxval = np.max(sspec[good])
    vmin = medval - 3 if vmin is None else vmin
    vmax = maxval - 3 if vmax is None else vmax
    plt.pcolormesh(acf.tn, acf.fn, sspec, vmin=vmin, vmax=vmax,
                   shading="auto")
    plt.colorbar()
    plt.xlabel("Delay")
    plt.ylabel("Doppler")
    plt.title("Secondary spectrum (dB)")
    return _finish(plt, fig, filename, display, dpi)


# ---------------------------------------------------------------- Brightness

def _bright_title(br, what):
    return ("{0} for ar={1}, psi={2}, alpha={3}".format(
        what, br.ar, br.psi, br.alpha)
        + "\n Gradient Angle ({0}, {1}) Reference Angle ({2}, {3})"
        .format(br.thetagx, br.thetagy, br.thetarx, br.thetary))


def plot_brightness_efield(br, figsize=(6, 6), filename=None,
                           display=True, dpi=200):
    """E-field ACF on the (x, y) grid (scint_sim.py:960-969)."""
    plt = _mpl()
    fig = plt.figure(figsize=figsize)
    plt.pcolormesh(br.x, br.x, br.acf_efield, shading="auto")
    plt.grid(linewidth=0.2)
    plt.colorbar()
    plt.title("ACF of E-field for ar={0}, psi={1}, alpha={2}".format(
        br.ar, br.psi, br.alpha))
    plt.xlabel("X = velocity axis")
    plt.ylabel("Y axis")
    return _finish(plt, fig, filename, display, dpi)


def plot_brightness_dist(br, figsize=(6, 6), filename=None,
                         display=True, dpi=200):
    """Brightness distribution in dB (scint_sim.py:971-980)."""
    plt = _mpl()
    fig = plt.figure(figsize=figsize)
    with np.errstate(divide="ignore"):
        db = 10 * np.log10(br.B)
    plt.pcolormesh(br.x, br.x, db, shading="auto")
    plt.grid(linewidth=0.2)
    plt.colorbar()
    plt.title(_bright_title(br, "Brightness (dB)"))
    plt.xlabel(r"$\theta_x$ = velocity axis")
    plt.ylabel(r"$\theta_y$ axis")
    return _finish(plt, fig, filename, display, dpi)


def plot_brightness_sspec(br, figsize=(6, 6), filename=None,
                          display=True, dpi=200):
    """Delay-Doppler spectrum in dB (scint_sim.py:982-998)."""
    plt = _mpl()
    fig = plt.figure(figsize=figsize)
    plt.pcolormesh(br.fd, br.td, br.LSS, shading="auto")
    plt.colorbar()
    good = br.SS > 1e-6
    medval = np.median(br.LSS[good])
    maxval = np.max(br.LSS[good])
    plt.clim((medval - 3, maxval - 3))
    plt.title(_bright_title(br, "Delay-Doppler Spectrum (dB)"))
    plt.ylabel("Delay")
    plt.xlabel("Doppler")
    return _finish(plt, fig, filename, display, dpi)


def plot_brightness_acf(br, figsize=(6, 6), contour=True, filename=None,
                        display=True, dpi=200):
    """Intensity ACF from the brightness distribution
    (scint_sim.py:1000-1020)."""
    plt = _mpl()
    fig = plt.figure(figsize=figsize)
    plt.pcolormesh(br.fd, br.td, br.acf, shading="auto")
    plt.colorbar()
    if contour:
        plt.contour(br.fd, br.td, br.acf, [0.2, 0.4, 0.6, 0.8],
                    colors="k")
        plt.contour(br.fd, br.td, br.acf, [0.0], colors="r",
                    linestyles="dotted")
    plt.title(_bright_title(br, "ACF (Time, Freq)"))
    plt.ylim((-4, 4))
    plt.xlim((-1, 1))
    plt.xlabel("Time")
    plt.ylabel("Frequency")
    return _finish(plt, fig, filename, display, dpi)


def _suffixed(filename, tag):
    """Insert ``tag`` before the file extension."""
    if filename is None:
        return None
    root, ext = os.path.splitext(filename)
    return root + tag + ext


def plot_brightness_cuts(br, figsize=(6, 6), filename=None,
                         display=True, dpi=200):
    """Constant-delay Doppler cuts and the zero-Doppler delay cut
    (scint_sim.py:1022-1065). Returns (fig_cuts, fig_delay)."""
    plt = _mpl()
    fig1 = plt.figure(figsize=figsize)
    nt = len(br.td)
    # clamp: for ncuts values that don't divide nt/2 the reference's
    # index walk steps past the end of LSS (scint_sim.py:1035), and
    # ncuts > nt/2 would make the step zero
    step = max(int((nt / 2) / br.ncuts), 1)
    for itdp in range(int(nt / 2) + step - 1, nt + step - 1, step):
        plt.plot(br.fd, br.LSS[min(itdp, nt - 1), :])
    mn = np.min(br.LSS[nt - 1, round(len(br.fd) / 2 - 1)])
    yl = plt.ylim()
    plt.ylim((mn - 10, yl[1]))
    plt.title(_bright_title(br, "{0} Cuts in Doppler at constant Delay"
                            .format(br.ncuts)))
    plt.xlabel("Doppler")
    plt.ylabel("Log Power")
    plt.grid()
    f1 = _finish(plt, fig1, _suffixed(filename, "_doppler"),
                 display, dpi)

    fig2 = plt.figure(figsize=figsize)
    fi = int(np.argmin(np.abs(br.fd)))
    ti = np.flatnonzero(br.td >= 0)
    # semilogx drops td==0 silently; keep strictly positive delays
    pos = ti[br.td[ti] > 0]
    plt.semilogx(br.td[pos], br.LSS[pos, fi])
    plt.grid()
    plt.title(_bright_title(br, "Cut in Delay at Doppler=0"))
    plt.xlabel("Delay")
    plt.ylabel("Log Power")
    f2 = _finish(plt, fig2, _suffixed(filename, "_delay"),
                 display, dpi)
    return f1, f2
