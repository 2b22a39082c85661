"""The port's plots against the JAX package's, figure by figure.

Each test of ``tests/test_plotting.py``, ``tests/test_sim_plots.py`` and
``tests/test_thth_plots.py`` has its counterpart here: the same call on
the JAX object and on the port's, from the same numpy input, under Agg.
Per Axes the two figures must agree in each QuadMesh's and image's array
and colour limits, each Line2D's data, the contour levels, the texts
(title, labels, legend), the axis limits and the number of Axes, and the
calls must write the same file names.

Where a plot draws state that both packages hold as the same numpy array
(the port's object is given the JAX object's state), the arrays agree to
1e-12. Where the port computes what it draws, they agree within that
quantity's existing parity tolerance: the ACF 1e-5 (atol), secondary
spectra linearly relative to the peak at 1e-5 (T6), the simulation's
arrays rel 1e-10, the θ-θ maps rel 1e-4, fits at their parity tests'
tolerances, named at each call.
"""

import os
import sys
from contextlib import contextmanager

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from matplotlib.collections import QuadMesh  # noqa: E402
from matplotlib.contour import ContourSet  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from scintools_tpu import dynspec as jdyn  # noqa: E402
from scintools_tpu import plotting as jplot  # noqa: E402
from scintools_tpu.sim import ACF as JACF  # noqa: E402
from scintools_tpu.sim import Brightness as JBrightness  # noqa: E402
from scintools_tpu.sim import Simulation as JSimulation  # noqa: E402
from scintools_tpu_torch import dynspec as tdyn  # noqa: E402
from scintools_tpu_torch import plotting as tplot  # noqa: E402
from scintools_tpu_torch.backend import KernelError  # noqa: E402
from scintools_tpu_torch.sim import ACF as TACF  # noqa: E402
from scintools_tpu_torch.sim import Brightness as TBrightness  # noqa: E402
from scintools_tpu_torch.sim import Simulation as TSimulation  # noqa: E402

CPU = "cpu"
DPI = 20


# ---------------------------------------------------------------------
# figure comparison
# ---------------------------------------------------------------------

def _filled(a):
    return np.ma.filled(np.ma.asarray(a, dtype=float), np.nan)


def _arrays(ax):
    out = []
    for c in ax.collections:
        if isinstance(c, ContourSet):
            out.append(("contour", np.asarray(c.levels, dtype=float), None))
        elif isinstance(c, QuadMesh):
            out.append(("mesh", _filled(c.get_array()), c.get_clim()))
    for im in ax.get_images():
        out.append(("image", _filled(im.get_array()), im.get_clim()))
    return out


def _texts(ax):
    legend = ax.get_legend()
    return (ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
            [t.get_text() for t in ax.texts],
            [t.get_text() for t in legend.get_texts()] if legend else [])


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    ok = np.isfinite(b)
    den = np.linalg.norm(b[ok])
    return np.linalg.norm(a[ok] - b[ok]) / (den if den > 0 else 1.0)


def _db_linear(a):
    """dB → power relative to its peak (T6)."""
    lin = 10 ** (np.asarray(a, dtype=float) / 10)
    return lin / np.nanmax(lin)


def same_figure(ft, fj, arrays=1e-12, lines=1e-12, lims=1e-12, clim=1e-12,
                db=(), phase=(), skip=()):
    """Assert the port's figure ``ft`` draws what the JAX package's ``fj``
    draws: ``arrays``/``lines`` are relative-L2 bounds, ``lims`` and
    ``clim`` relative (and absolute, for values near 0) bounds on the
    axis and colour limits; Axes in ``db`` hold dB meshes compared
    linearly, Axes in ``phase`` phases compared as e^{iφ} up to one
    global phase (an eigenvector's, R5: aligned correlation within
    ``arrays`` of 1), Axes in ``skip`` have their arrays left out."""
    assert len(ft.axes) == len(fj.axes)
    for i, (at, aj) in enumerate(zip(ft.axes, fj.axes)):
        assert _texts(at) == _texts(aj), i
        for get in (lambda a: a.get_xlim(), lambda a: a.get_ylim()):
            np.testing.assert_allclose(get(at), get(aj), rtol=lims,
                                       atol=lims, err_msg=f"axes {i}")
        mt, mj = _arrays(at), _arrays(aj)
        assert [m[0] for m in mt] == [m[0] for m in mj], i
        if i not in skip:
            for (kind, a, ca), (_, b, cb) in zip(mt, mj):
                if kind == "contour":
                    np.testing.assert_allclose(a, b, rtol=arrays, atol=0)
                    continue
                if i in db:
                    a, b = _db_linear(a), _db_linear(b)
                if i in phase:
                    za, zb = np.exp(1j * a).ravel(), np.exp(1j * b).ravel()
                    corr = np.abs(np.vdot(za, zb)) / za.size
                    assert corr >= 1 - arrays, (i, kind, corr)
                    continue
                assert _rel(a, b) <= arrays, (i, kind, _rel(a, b))
                np.testing.assert_allclose(ca, cb, rtol=clim, atol=clim,
                                           err_msg=f"clim axes {i}")
            lt, lj = at.get_lines(), aj.get_lines()
            assert len(lt) == len(lj), i
            for x, y in zip(lt, lj):
                assert _rel(x.get_xydata(), y.get_xydata()) <= lines, i


@contextmanager
def drawn(figs):
    """Collect the figures a call opens into ``figs``, keeping the ones
    it saves open (``_finish`` closes a saved figure)."""
    before = set(plt.get_fignums())
    close = plt.close
    plt.close = lambda *a, **k: None
    try:
        yield figs
    finally:
        plt.close = close
    figs.extend(plt.figure(n) for n in sorted(plt.get_fignums())
                if n not in before)


def both(call_t, call_j):
    """Run a plotting call on the port and the JAX package; returns the
    two lists of figures each opened."""
    ft, fj = [], []
    with drawn(ft):
        call_t()
    with drawn(fj):
        call_j()
    return ft, fj


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


# ---------------------------------------------------------------------
# the façade (tests/test_plotting.py)
# ---------------------------------------------------------------------

def _scint_dyn():
    """tests/test_plotting.py's smooth scintles."""
    rng = np.random.default_rng(42)
    nf, nt = 64, 64
    raw = rng.normal(size=(nf, nt))
    spec = np.fft.fft2(raw)
    fy = np.fft.fftfreq(nf)[:, None]
    fx = np.fft.fftfreq(nt)[None, :]
    spec *= np.exp(-((fy / 0.08) ** 2 + (fx / 0.08) ** 2))
    return np.abs(np.fft.ifft2(spec)) ** 2


def _pair():
    dyn = _scint_dyn()
    nf, nt = dyn.shape
    dt, df = 10.0, 0.05
    kw = dict(times=np.arange(nt) * dt, freqs=1400.0 + np.arange(nf) * df,
              dt=dt, df=df)
    # the JAX backend: the one the port's parity tests hold it to
    dj = jdyn.Dynspec(dyn=jdyn.BasicDyn(dyn, name="synthetic", **kw),
                      process=False, verbose=False, backend="jax")
    dp = tdyn.Dynspec(dyn=tdyn.BasicDyn(dyn, name="synthetic", **kw),
                      process=False, verbose=False, device=CPU)
    return dp, dj


@pytest.fixture
def pair():
    """A fresh pair per test, so no test leans on another's state."""
    return _pair()


def _files(tmp_path, sub):
    d = tmp_path / sub
    d.mkdir()
    return d


def _listing(d):
    return sorted(p.name for p in d.iterdir() if p.stat().st_size > 0)


class TestPlotACF:
    def test_crop_and_scale_axes(self, pair, tmp_path):
        """The ACF (atol 1e-5 of the JAX one) with the fitted scales' twin
        axes (the host scipy fits, rel 1e-6)."""
        dp, dj = pair
        td, jd = _files(tmp_path, "t"), _files(tmp_path, "j")
        ft, fj = both(
            lambda: dp.plot_acf(crop=True, nscale=3, filename=str(
                td / "acf.png"), display=False, dpi=DPI),
            lambda: dj.plot_acf(crop=True, nscale=3, filename=str(
                jd / "acf.png"), display=False, dpi=DPI))
        assert _listing(td) == _listing(jd) == ["acf.png"]
        same_figure(ft[0], fj[0], arrays=1e-5, lims=1e-6, clim=1e-5)
        assert len(ft[0].axes) == 3       # the twin axes of τ_d and Δν_d

    def test_tlim_flim(self, pair, tmp_path):
        dp, dj = pair
        td, jd = _files(tmp_path, "t"), _files(tmp_path, "j")
        ft, fj = both(
            lambda: dp.plot_acf(tlim=dp.tobs / 120, flim=dp.bw / 2,
                                filename=str(td / "acf2.png"),
                                display=False, dpi=DPI),
            lambda: dj.plot_acf(tlim=dj.tobs / 120, flim=dj.bw / 2,
                                filename=str(jd / "acf2.png"),
                                display=False, dpi=DPI))
        assert _listing(td) == _listing(jd) == ["acf2.png"]
        same_figure(ft[0], fj[0], arrays=1e-5, lims=1e-6, clim=1e-5)

    @pytest.mark.parametrize("exc", [
        KernelError("eig kernel failed"),
        RuntimeError("CUDA error: an illegal memory access was "
                     "encountered")])
    def test_kernel_error_in_the_fit_propagates(self, pair, monkeypatch,
                                                exc):
        """A kernel error or device fault in the scales' fit is raised,
        not printed over; a fit that merely fails is drawn without
        scales, as in the JAX package."""
        dp, _ = pair

        def fit(**kw):
            raise exc

        monkeypatch.setattr(dp, "get_scint_params", fit)
        with pytest.raises(type(exc), match=str(exc)[:10]):
            dp.plot_acf(display=False)

        def fails(**kw):
            raise ValueError("fit did not converge")

        monkeypatch.setattr(dp, "get_scint_params", fails)
        dp.plot_acf(display=False)
        assert not hasattr(dp, "tau")

    def test_input_acf_path(self, pair, tmp_path):
        """Both draw the JAX ACF given as ``input_acf``: 1e-12."""
        dp, dj = pair
        if not hasattr(dj, "acf"):
            dj.calc_acf()
        acf = np.array(dj.acf)
        ft, fj = both(
            lambda: dp.plot_acf(input_acf=acf, input_t=dp.times,
                                input_f=dp.freqs, display=False),
            lambda: dj.plot_acf(input_acf=acf, input_t=dj.times,
                                input_f=dj.freqs, display=False))
        same_figure(ft[0], fj[0])


class TestTiltPlot:
    def test_plot_writes_two_figures(self, pair, tmp_path):
        """Both fit the same ACF (the JAX one given to the port), so the
        peaks, the line and the tilt agree to rounding (1e-9)."""
        dp, dj = pair
        dj.calc_acf()
        dp.acf = np.array(dj.acf)
        td, jd = _files(tmp_path, "t"), _files(tmp_path, "j")
        ft, fj = both(
            lambda: dp.get_acf_tilt(plot=True, filename=str(td / "tilt.png"),
                                    display=False, dpi=DPI),
            lambda: dj.get_acf_tilt(plot=True, filename=str(jd / "tilt.png"),
                                    display=False, dpi=DPI))
        assert _listing(td) == _listing(jd) == ["tilt_tilt_acf.png",
                                                "tilt_tilt_fit.png"]
        assert np.isfinite(dp.acf_tilt)
        assert dp.acf_tilt == pytest.approx(dj.acf_tilt, rel=1e-9)
        for a, b in zip(ft, fj):
            same_figure(a, b, arrays=1e-9, lines=1e-9, lims=1e-9)


class TestCutDynPlot:
    def test_plot_writes_three_tile_grids(self, pair, tmp_path):
        """Tiles of the same spectrum (1e-12); each tile's ACF (atol 1e-5)
        and secondary spectrum (linear, 1e-5 of the peak; its dB colour
        limits 1e-3 dB) computed by each package."""
        dp, dj = pair
        td, jd = _files(tmp_path, "t"), _files(tmp_path, "j")
        ft, fj = both(
            lambda: dp.cut_dyn(tcuts=1, fcuts=1, plot=True, filename=str(
                td / "cuts.png"), display=False, dpi=DPI),
            lambda: dj.cut_dyn(tcuts=1, fcuts=1, plot=True, filename=str(
                jd / "cuts.png"), display=False, dpi=DPI))
        assert _listing(td) == _listing(jd) == [
            "cuts_acf.png", "cuts_dynspec.png", "cuts_sspec.png"]
        assert dp.cutdyn.shape[:2] == (2, 2)
        same_figure(ft[0], fj[0])
        same_figure(ft[1], fj[1], arrays=1e-5, clim=1e-5)
        same_figure(ft[2], fj[2], arrays=1e-5, clim=1e-3,
                    db=range(4))


class TestPlotSspecKwargs:
    def test_all_kwargs_do_something(self, pair, tmp_path):
        """cutmid / startbin / delmax / vmin / vmax / subtract_artefacts
        / overplot_curvature on the JAX spectrum given to the port."""
        dp, dj = pair
        dj.calc_sspec()
        dp.calc_sspec()
        dp.sspec = np.array(dj.sspec)
        kw = dict(cutmid=4, startbin=2,
                  delmax=float(dj.tdel[len(dj.tdel) // 2]), vmin=-5.0,
                  vmax=40.0, subtract_artefacts=True,
                  overplot_curvature=0.1, display=False, dpi=DPI)
        td, jd = _files(tmp_path, "t"), _files(tmp_path, "j")
        ft, fj = both(
            lambda: dp.plot_sspec(filename=str(td / "ss.png"), **kw),
            lambda: dj.plot_sspec(filename=str(jd / "ss.png"), **kw))
        assert _listing(td) == _listing(jd) == ["ss.png"]
        same_figure(ft[0], fj[0])
        assert ft[0].axes[0].get_ylim()[1] < 0.7 * float(dp.tdel.max())
        with pytest.raises(TypeError):
            dp.plot_sspec(bogus=1, display=False)


class TestScintFitPlots:
    @pytest.mark.parametrize("method, tag", [("acf1d", "1Dfit"),
                                             ("acf2d_approx", "2Dfit")])
    def test_fit_plot(self, pair, tmp_path, method, tag):
        """Both fit the JAX ACF on the host with scipy, so data, model and
        residuals agree to the fits' rounding (rel 1e-6). The 2-D fit is
        unweighted here: weighted, the reference's recipe runs the scipy
        fit to its 50000 evaluations on this spectrum (about a minute in
        each package); the plot is the same."""
        dp, dj = pair
        if not hasattr(dj, "acf"):
            dj.calc_acf()
        dp.acf = np.array(dj.acf)
        kw = dict(method=method, plot=True, display=False, dpi=DPI,
                  weighted=method == "acf1d")
        td, jd = _files(tmp_path, "t"), _files(tmp_path, "j")
        ft, fj = both(
            lambda: dp.get_scint_params(filename=str(td / "fit.png"), **kw),
            lambda: dj.get_scint_params(filename=str(jd / "fit.png"), **kw))
        assert _listing(td) == _listing(jd) == [f"fit_{tag}.png"]
        same_figure(ft[0], fj[0], arrays=1e-6, lines=1e-6, lims=1e-6,
                    clim=1e-6)


class TestScatteredImageAxes:
    def test_use_angle_and_spatial(self, pair, tmp_path):
        dp, dj = pair
        dj.calc_scattered_image(sampling=16)
        dp.scattered_image = np.array(dj.scattered_image)
        dp.scattered_image_ax = np.array(dj.scattered_image_ax)
        for kw in (dict(use_angle=True, s=0.7, veff=30.0),
                   dict(use_spatial=True, s=0.7, veff=30.0, d=1.0)):
            td, jd = _files(tmp_path, f"t{len(kw)}"), \
                _files(tmp_path, f"j{len(kw)}")
            ft, fj = both(
                lambda: dp.plot_scattered_image(filename=str(td / "i.png"),
                                                display=False, dpi=DPI, **kw),
                lambda: dj.plot_scattered_image(filename=str(jd / "i.png"),
                                                display=False, dpi=DPI, **kw))
            assert _listing(td) == _listing(jd) == ["i.png"]
            same_figure(ft[0], fj[0])
        with pytest.raises(ValueError):
            dp.plot_scattered_image(use_angle=True, display=False)

    def test_calc_scattered_image_plot(self, pair):
        """``calc_scattered_image(plot=True)`` draws the image it
        computes from the same spectrum and curvature: the port's own
        interpolation, held to the JAX façade's at the parity test's 2e-3
        of its peak."""
        dp, dj = pair
        dj.calc_sspec()
        dp.calc_sspec()
        dp.sspec = np.array(dj.sspec)
        dj.fit_arc(log_parabola=True)
        kw = dict(sampling=16, plot=True, input_eta=dj.eta)
        ft, fj = both(lambda: dp.calc_scattered_image(**kw),
                      lambda: dj.calc_scattered_image(**kw))
        same_figure(ft[0], fj[0], arrays=2e-3, lims=1e-6, clim=1e-2,
                    db=(0,))


class TestPoolParity:
    def test_fit_thetatheta_and_asymmetry_pool(self, pair, tmp_path):
        """``pool`` is accepted; η(f) drawn from the JAX fit's state."""
        from multiprocessing.dummy import Pool

        dp, dj = pair
        prep = dict(cwf=32, cwt=32, npad=1, eta_min=1e-3, eta_max=1.0,
                    neta=6, nedge=12)
        for d in (dp, dj):
            d.prep_thetatheta(**prep)
        with Pool(2) as pool:
            dj.fit_thetatheta(pool=pool)
            dp.fit_thetatheta(pool=pool)
            asym = dp.calc_asymmetry(pool=pool)
        assert dp.eta_evo.shape == (2, 2)
        assert asym is not None and np.shape(asym) == (2, 2)
        for k in ("eta_evo", "eta_evo_err", "f0s", "ththeta", "ththetaerr",
                  "fref"):
            setattr(dp, k, np.copy(getattr(dj, k)))
        td, jd = _files(tmp_path, "t"), _files(tmp_path, "j")
        ft, fj = both(
            lambda: tplot.plot_eta_evolution(dp, filename=str(
                td / "eta_evo.png"), display=False, dpi=DPI),
            lambda: jplot.plot_eta_evolution(dj, filename=str(
                jd / "eta_evo.png"), display=False, dpi=DPI))
        assert _listing(td) == _listing(jd) == ["eta_evo.png"]
        same_figure(ft[0], fj[0])


class TestArcAndNormSspecPlots:
    def test_fit_arc_plot_kwarg(self, pair, tmp_path):
        """The arc fit of the same spectrum: its profile and curvature at
        the serial fit's parity (rel 1e-5 of the profile, A2)."""
        dp, dj = pair
        dj.calc_sspec()
        dp.sspec = np.array(dj.sspec)
        td, jd = _files(tmp_path, "t"), _files(tmp_path, "j")
        try:
            fj = []
            with drawn(fj):
                dj.fit_arc(plot=True, filename=str(jd / "arcfit.png"),
                           display=False, numsteps=500, dpi=DPI)
        except RuntimeError:
            pytest.skip("no arc in synthetic smoke data")
        ft = []
        with drawn(ft):
            dp.fit_arc(plot=True, filename=str(td / "arcfit.png"),
                       display=False, numsteps=500, dpi=DPI)
        assert _listing(td) == _listing(jd) == ["arcfit.png"]
        same_figure(ft[0], fj[0], lines=1e-5, lims=1e-3)

    def test_norm_sspec_plot_kwarg(self, pair, tmp_path):
        dp, dj = pair
        dj.calc_sspec()
        dp.sspec = np.array(dj.sspec)
        td, jd = _files(tmp_path, "t"), _files(tmp_path, "j")
        ft, fj = both(
            lambda: dp.norm_sspec(eta=1.0, plot=True, filename=str(
                td / "normsspec.png"), display=False, numsteps=100, dpi=DPI),
            lambda: dj.norm_sspec(eta=1.0, plot=True, filename=str(
                jd / "normsspec.png"), display=False, numsteps=100, dpi=DPI))
        assert _listing(td) == _listing(jd) == [
            "normsspec.png", "normsspec_1d.png", "normsspec_power.png"]
        # the normalised spectrum in dB, compared linearly (T6): its
        # deepest bins, 150 dB below the peak, differ by 1e-2 dB, and the
        # lower colour limit is the deepest bin; the colour bar (Axes 1)
        # is a ramp between the colour limits, which its axis limits hold
        for a, b in zip(ft, fj):
            same_figure(a, b, arrays=1e-5, lines=1e-5, lims=2e-2, clim=2e-2,
                        db=(0,), skip=(1,))


class TestFacadeMethods:
    def test_plot_dyn_and_all(self, pair):
        """``plot_dyn`` and ``plot_all`` on the JAX state (1e-12)."""
        dp, dj = pair
        dj.calc_sspec()
        dj.calc_acf()
        dj.norm_sspec(eta=1.0, numsteps=100)
        for k in ("sspec", "acf", "fdop", "tdel", "normsspecavg",
                  "normsspec_fdop"):
            setattr(dp, k, np.array(getattr(dj, k)))
        ft, fj = both(lambda: dp.plot_dyn(display=False, title="t"),
                      lambda: dj.plot_dyn(display=False, title="t"))
        same_figure(ft[0], fj[0])
        ft, fj = both(lambda: dp.plot_all(display=False),
                      lambda: dj.plot_all(display=False))
        same_figure(ft[0], fj[0])

    def test_calc_sspec_plot(self, pair):
        """``calc_sspec(plot=True)`` draws the spectrum it computes (dB,
        linear 1e-5 of the peak) and leaves what the call without it
        leaves, bitwise."""
        dp, dj = pair
        dp.calc_sspec()
        before = np.array(dp.sspec)
        ft, fj = both(lambda: dp.calc_sspec(plot=True),
                      lambda: dj.calc_sspec(plot=True))
        np.testing.assert_array_equal(dp.sspec, before)
        # the colour bar's axis spans the colour limits (dB)
        same_figure(ft[0], fj[0], arrays=1e-5, clim=1e-3, lims=1e-3,
                    db=(0,))


# ---------------------------------------------------------------------
# the simulation classes (tests/test_sim_plots.py)
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def sims():
    return (TSimulation(ns=64, nf=16, seed=3, device=CPU),
            JSimulation(ns=64, nf=16, seed=3, backend="numpy"))


SIM_TOL = dict(arrays=1e-9, lines=1e-9, lims=1e-9, clim=1e-9)


class TestSimulationPlots:
    """The simulation's arrays agree to rel 1e-10 (its parity test)."""

    @pytest.mark.parametrize("method", [
        "plot_screen", "plot_intensity", "plot_dynspec", "plot_efield",
        "plot_delay", "plot_pulse", "plot_all"])
    def test_method_draws(self, sims, method):
        st, sj = sims
        ft, fj = both(lambda: getattr(st, method)(display=False),
                      lambda: getattr(sj, method)(display=False))
        assert ft and fj
        same_figure(ft[0], fj[0], **SIM_TOL)

    def test_file_output(self, sims, tmp_path):
        st, sj = sims
        for sim, sub in ((st, "t"), (sj, "j")):
            d = _files(tmp_path, sub)
            sim.plot_screen(filename=str(d / "screen.png"), display=False,
                            dpi=DPI)
            assert _listing(d) == ["screen.png"]

    def test_lamsteps_axis(self):
        ft, fj = both(
            lambda: TSimulation(ns=32, nf=8, seed=1, lamsteps=True,
                                device=CPU).plot_dynspec(display=False),
            lambda: JSimulation(ns=32, nf=8, seed=1, lamsteps=True,
                                backend="numpy").plot_dynspec(display=False))
        assert ft[0].axes[0].get_ylabel().startswith("Wavelength")
        same_figure(ft[0], fj[0], **SIM_TOL)

    def test_constructor_plot_kwarg(self):
        ft, fj = both(
            lambda: TSimulation(ns=32, nf=8, seed=1, plot=True, device=CPU),
            lambda: JSimulation(ns=32, nf=8, seed=1, plot=True,
                                backend="numpy"))
        assert len(ft) == len(fj) == 1
        same_figure(ft[0], fj[0], **SIM_TOL)


class TestACFPlots:
    @pytest.fixture(scope="class")
    def acfs(self):
        return TACF(nf=17, nt=17, device=CPU), JACF(nf=17, nt=17,
                                                     backend="numpy")

    @pytest.mark.parametrize("kw", [dict(contour=True), dict(filled=True)])
    def test_plot_acf_variants(self, acfs, kw):
        """The model ACF agrees to rel 1e-5 (its parity test)."""
        at, aj = acfs
        ft, fj = both(lambda: at.plot_acf(display=False, **kw),
                      lambda: aj.plot_acf(display=False, **kw))
        same_figure(ft[0], fj[0], arrays=1e-5, clim=1e-5)

    def test_plot_acf_efield(self, acfs):
        at, aj = acfs
        ft, fj = both(lambda: at.plot_acf_efield(display=False),
                      lambda: aj.plot_acf_efield(display=False))
        same_figure(ft[0], fj[0], arrays=1e-5, clim=1e-5)

    def test_plot_sspec_lazy_calc(self, acfs):
        """The spectrum is computed on demand (rel 1e-8, its parity)."""
        at, aj = acfs
        for a in acfs:
            if hasattr(a, "sspec"):
                del a.sspec
        ft, fj = both(lambda: at.plot_sspec(display=False),
                      lambda: aj.plot_sspec(display=False))
        assert hasattr(at, "sspec")
        same_figure(ft[0], fj[0], arrays=1e-5, clim=1e-5)

    def test_constructor_plot_kwarg(self):
        ft, fj = both(
            lambda: TACF(nf=9, nt=9, plot=True, display=False, device=CPU),
            lambda: JACF(nf=9, nt=9, plot=True, display=False,
                         backend="numpy"))
        assert len(ft) == len(fj) == 1
        same_figure(ft[0], fj[0], arrays=1e-5, clim=1e-5)


BR_TOL = dict(arrays=1e-8, lines=1e-8, lims=1e-8, clim=1e-8)


class TestBrightnessPlots:
    """The brightness arrays agree to rtol 1e-8 (their parity test)."""

    @pytest.fixture(scope="class")
    def brs(self):
        kw = dict(nx=10, nt=24, ncuts=3)
        return TBrightness(device=CPU, **kw), JBrightness(backend="numpy",
                                                          **kw)

    @pytest.mark.parametrize("method", [
        "plot_acf_efield", "plot_brightness", "plot_sspec", "plot_acf",
        "plot_cuts"])
    def test_method_draws(self, brs, method):
        bt, bj = brs
        ft, fj = both(lambda: getattr(bt, method)(display=False),
                      lambda: getattr(bj, method)(display=False))
        assert len(ft) == len(fj) >= 1
        for a, b in zip(ft, fj):
            same_figure(a, b, **BR_TOL)

    def test_constructor_plot_kwarg(self):
        ft, fj = both(
            lambda: TBrightness(nx=6, nt=16, ncuts=2, plot=True, device=CPU),
            lambda: JBrightness(nx=6, nt=16, ncuts=2, plot=True,
                                backend="numpy"))
        assert len(ft) == len(fj) == 6
        for a, b in zip(ft, fj):
            same_figure(a, b, **BR_TOL)

    def test_cuts_two_figures(self, brs):
        f1, f2 = brs[0].plot_cuts(display=False)
        assert f1 is not None and f2 is not None

    def test_cuts_non_dividing_ncuts(self):
        ft, fj = both(
            lambda: TBrightness(nx=8, nt=20, ncuts=7, plot=True, device=CPU),
            lambda: JBrightness(nx=8, nt=20, ncuts=7, plot=True,
                                backend="numpy"))
        for a, b in zip(ft, fj):
            same_figure(a, b, **BR_TOL)


class TestLazyGuards:
    @pytest.mark.parametrize("method, attrs", [
        ("plot_dynspec", ("spi", "x", "lams", "freqs")),
        ("plot_efield", ("x", "lams", "freqs", "spi"))])
    def test_plot_recomputes(self, method, attrs):
        t = TSimulation(ns=32, nf=8, seed=1, device=CPU)
        j = JSimulation(ns=32, nf=8, seed=1, backend="numpy")
        for s in (t, j):
            for a in attrs:
                delattr(s, a)
        ft, fj = both(lambda: getattr(t, method)(display=False),
                      lambda: getattr(j, method)(display=False))
        assert hasattr(t, "spi") and hasattr(t, "x")
        same_figure(ft[0], fj[0], **SIM_TOL)


# ---------------------------------------------------------------------
# the θ-θ chunk diagnostic (tests/test_thth_plots.py)
# ---------------------------------------------------------------------

# panels drawn from the rank-1 model, whose f_D = τ = 0 bin holds the
# dtype's largest value in both packages (float32 here, float64 there):
# their arrays differ by design; titles, labels and limits are compared
MODEL_PANELS = (1, 3)
# the recovered phases: an eigenvector's, up to one global phase (R5)
PHASE_PANELS = (9,)


def _thth_inputs(seed, n, n_etas, n_edges):
    from scintools_tpu.thth.search import chunk_conjugate_spectrum

    rng = np.random.default_rng(seed)
    dspec = rng.normal(size=(n, n)) ** 2
    time = np.arange(n) * 10.0
    freq = 1400.0 + np.arange(n) * 0.2
    CS, tau, fd = chunk_conjugate_spectrum(dspec, time, freq, npad=1)
    eta_c = tau.max() / (fd.max() / 4) ** 2
    etas = np.linspace(0.5 * eta_c, 2.0 * eta_c, n_etas)
    edges = np.linspace(-fd.max() / 2, fd.max() / 2, n_edges)
    return dspec, time, freq, CS, tau, fd, etas, edges


class TestPlotFunc:
    def test_builds_12_panel_figure(self):
        """The same search result drawn by both: the data panels at the
        θ-θ maps' rel 1e-4 (complex64 here, complex128 there)."""
        from scintools_tpu.thth.plots import plot_func as jplot_func
        from scintools_tpu.thth.search import single_search
        from scintools_tpu_torch.thth import plot_func

        dspec, time, freq, CS, tau, fd, etas, edges = _thth_inputs(
            5, 32, 16, 24)
        res = single_search(dspec, freq, time, etas, edges, npad=1,
                            backend="numpy")
        e_pk = res.eta if np.isfinite(res.eta) else etas.mean()
        sel = np.abs(res.etas - e_pk) < 0.5 * e_pk
        args = (dspec, time, freq, CS, fd, tau, edges, res.eta, res.eta_sig,
                res.etas, res.eigs, res.etas[sel], res.popt)
        ft = plot_func(*args, device=CPU)
        fj = jplot_func(*args, backend="numpy")
        assert len(ft.axes) == len(fj.axes) == 11
        same_figure(ft, fj, arrays=1e-4, lines=1e-12, lims=1e-6, clim=1e-3,
                    skip=MODEL_PANELS, phase=PHASE_PANELS)

    def test_nan_eta_falls_back_to_mean(self):
        from scintools_tpu.thth.plots import plot_func as jplot_func
        from scintools_tpu_torch.thth import plot_func

        dspec, time, freq, CS, tau, fd, etas, edges = _thth_inputs(
            6, 16, 8, 16)
        eigs = np.ones_like(etas)
        args = (dspec, time, freq, CS, fd, tau, edges, np.nan, np.nan,
                etas, eigs, etas, None)
        ft = plot_func(*args, device=CPU)
        fj = jplot_func(*args, backend="numpy")
        assert len(ft.axes) == len(fj.axes) == 11
        same_figure(ft, fj, arrays=1e-4, lines=1e-12, lims=1e-6, clim=1e-3,
                    skip=MODEL_PANELS, phase=PHASE_PANELS)
        with pytest.raises(ValueError, match="backend"):
            plot_func(*args, backend="numpy", device=CPU)

    def test_thetatheta_single_plot(self, tmp_path):
        """``thetatheta_single(plot=True)`` writes the diagnostic and
        returns what the call without it returns, bitwise."""
        dp, _ = _pair()
        dp.prep_thetatheta(cwf=32, cwt=32, npad=1, eta_min=1e-3,
                           eta_max=1.0, neta=6, nedge=12)
        plain = dp.thetatheta_single(0, 0)
        res = dp.thetatheta_single(0, 0, plot=True,
                                   fname=str(tmp_path / "chunk.png"))
        assert _listing(tmp_path) == ["chunk.png"]
        np.testing.assert_array_equal(res.eigs, plain.eigs)
        assert (res.eta, res.ok) == (plain.eta, plain.ok) or (
            np.isnan(res.eta) and np.isnan(plain.eta))


class TestArchiveHook:
    def test_tools_unavailable_in_ci(self):
        from scintools_tpu_torch.utils.archive import (archive_tools_available,
                                                       clean_archive)

        if archive_tools_available():  # pragma: no cover
            pytest.skip("psrchive present")
        with pytest.raises(ImportError, match="psrchive"):
            clean_archive("nonexistent.ar")


class TestCompatLayer:
    def test_reference_names_resolve(self):
        from scintools_tpu import compat as J
        from scintools_tpu_torch import compat

        for name in compat.__all__:
            assert callable(getattr(compat, name)), name
        assert compat.plot_func.__name__ == J.plot_func.__name__
        assert callable(compat.rotFit)
        assert callable(compat.fullMosFit)

    def test_err_calc_on_parabola(self):
        from scintools_tpu.thth.search import err_calc as jerr_calc
        from scintools_tpu_torch.thth.search import chi_par, err_calc

        rng = np.random.default_rng(2)
        etas = np.linspace(0.5, 1.5, 60)
        pars = (-4.0, 1.0, 10.0)
        eigs = chi_par(etas, *pars) + 0.01 * rng.normal(size=60)
        err = err_calc(etas, eigs, pars)
        assert 0 < err < 0.05
        assert err == pytest.approx(jerr_calc(etas, eigs, pars), rel=1e-12)
