"""The port's ``Dynspec`` façade and north-star workload
(scintools_tpu_torch/dynspec.py, workloads.py) against the JAX package
on the CPU: the slices end to end.

The JAX side prepares the θ-θ geometry; the port is handed exactly the
same state through ``Dynspec.from_reference_state``. The JAX side's CPU
route is its XLA η-scan and the port's the warm-start squaring
algorithm in float32, so the fitted curvature is compared at rel 1e-2
(the JAX package's own warm-vs-staged gate). Retrieval starts from the
JAX side's fitted curvature, and the wavefields are compared by
intensity at the JAX package's cross-backend gates (rel L2 < 5e-3,
corr > 0.9999, tools/tpu_smoke.py).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_thth import make_arc_wavefield  # noqa: E402

from scintools_tpu import dynspec as jdyn  # noqa: E402
from scintools_tpu_torch import dynspec as tdyn  # noqa: E402
from scintools_tpu_torch import workloads as tw  # noqa: E402
from scintools_tpu_torch.thth import batch as tbatch  # noqa: E402

_PREP = dict(cwf=128, cwt=128, eta_min=0.1, eta_max=0.9, nedge=64,
             edges_lim=2.6, npad=1)
# a 256² spectrum in 64² chunks: a 7×7 half-overlap retrieval grid, N=128
_PREP_RET = dict(cwf=64, cwt=64, eta_min=0.1, eta_max=0.9, nedge=32,
                 edges_lim=2.6, npad=1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arc():
    """The tests/test_thth_batch.py:83-106 arc wavefield, 128×256."""
    E, times, freqs = make_arc_wavefield(nt=256, nf=128)
    return np.abs(E) ** 2, times, freqs


@pytest.fixture(scope="module")
def jax_fit(arc):
    dyn, times, freqs = arc
    bd = jdyn.BasicDyn(dyn, name="arcsim", times=times, freqs=freqs)
    d = jdyn.Dynspec(dyn=bd, verbose=False, process=False, backend="jax")
    d.prep_thetatheta(**_PREP)
    d.fit_thetatheta()
    return d


def _state(d):
    return {k: getattr(d, k) for k in tdyn._STATE_KEYS}


@pytest.fixture(scope="module")
def arc_square():
    E, times, freqs = make_arc_wavefield(nt=256, nf=256)
    return np.abs(E) ** 2, times, freqs


def _jax_dynspec(arc_square):
    dyn, times, freqs = arc_square
    bd = jdyn.BasicDyn(dyn, name="arcsim", times=times, freqs=freqs)
    d = jdyn.Dynspec(dyn=bd, verbose=False, process=False, backend="jax")
    d.prep_thetatheta(**_PREP_RET)
    return d


@pytest.fixture(scope="module")
def jax_retrieved(arc_square):
    """The JAX side fitted, then retrieved on its chunk-scan warm route
    (the CPU counterpart of its TPU kernel route)."""
    d = _jax_dynspec(arc_square)
    d.fit_thetatheta()
    d.retrieve_wavefield(method="warm")
    return d


def _port_from(d):
    st = _state(d)
    st["ththeta"] = d.ththeta
    return tdyn.Dynspec.from_reference_state(st, device="cpu")


def _intensity_gap(a, b):
    Ia, Ib = np.abs(a) ** 2, np.abs(b) ** 2
    return (np.linalg.norm(Ia - Ib) / np.linalg.norm(Ib),
            np.corrcoef(Ia.ravel(), Ib.ravel())[0, 1])


class TestFacadeVsJax:
    def test_fit_thetatheta_from_reference_state(self, jax_fit):
        ds = tdyn.Dynspec.from_reference_state(_state(jax_fit),
                                               device="cpu")
        ds.fit_thetatheta()
        assert ds.eta_evo.shape == jax_fit.eta_evo.shape == (1, 2)
        np.testing.assert_array_equal(np.isfinite(ds.eta_evo),
                                      np.isfinite(jax_fit.eta_evo))
        np.testing.assert_array_equal(ds.eta_evo_ok, jax_fit.eta_evo_ok)
        np.testing.assert_array_equal(ds.f0s, jax_fit.f0s)
        np.testing.assert_array_equal(ds.t0s, jax_fit.t0s)
        assert np.isfinite(ds.ththeta)
        assert ds.ththeta == pytest.approx(jax_fit.ththeta, rel=1e-2)

    def test_own_prep_matches_jax_geometry(self, arc, jax_fit):
        dyn, times, freqs = arc
        bd = tdyn.BasicDyn(dyn, name="arcsim", times=times, freqs=freqs)
        ds = tdyn.Dynspec(dyn=bd, verbose=False, process=False,
                          device="cpu")
        ds.prep_thetatheta(**_PREP)
        for k in tdyn._STATE_KEYS:
            if k == "dyn":
                continue
            np.testing.assert_array_equal(getattr(ds, k),
                                          getattr(jax_fit, k), err_msg=k)
        ds.fit_thetatheta()
        assert ds.ththeta == pytest.approx(jax_fit.ththeta, rel=1e-2)

    def test_calc_sspec_matches_jax(self, arc):
        dyn, times, freqs = arc
        kw = dict(name="arcsim", times=times, freqs=freqs)
        dj = jdyn.Dynspec(dyn=jdyn.BasicDyn(dyn, **kw), verbose=False,
                          process=False, backend="jax")
        dj.calc_sspec()
        dt_ = tdyn.Dynspec(dyn=tdyn.BasicDyn(dyn, **kw), verbose=False,
                           process=False, device="cpu")
        dt_.calc_sspec()
        np.testing.assert_array_equal(dt_.fdop, dj.fdop)
        np.testing.assert_array_equal(dt_.tdel, dj.tdel)
        # linear power within 1e-5 of the peak (float32 FFT)
        lin_t, lin_j = 10 ** (dt_.sspec / 10), 10 ** (dj.sspec / 10)
        np.testing.assert_allclose(lin_t, lin_j, rtol=0,
                                   atol=1e-5 * lin_j.max())


# a 256² known-curvature arc (the north star's synthetic at a CPU size):
# the JAX package's own Hough seed brackets η_true = 5e-4 on it
_SEED_PREP = dict(cwf=128, cwt=128, npad=1, nedge=64)


@pytest.fixture(scope="module")
def arc_north():
    n, dt, df, f0 = 256, 2.0, 0.05, 1400.0
    dyn = tw.make_arc_dynspec(n, n, dt, df, f0, 5e-4, n_images=96, seed=21)
    return dyn, dt * np.arange(n), f0 + df * np.arange(n)


def _pair(arc_north):
    dyn, times, freqs = arc_north
    kw = dict(name="arc", times=times, freqs=freqs)
    dj = jdyn.Dynspec(dyn=jdyn.BasicDyn(dyn, **kw), verbose=False,
                      process=False, backend="jax")
    dp = tdyn.Dynspec(dyn=tdyn.BasicDyn(dyn, **kw), verbose=False,
                      process=False, device="cpu")
    return dj, dp


@pytest.fixture(scope="module")
def seeded(arc_north):
    """Both façades after ``prep_thetatheta`` without η bounds (the
    Hough seed) and ``fit_thetatheta``."""
    dj, dp = _pair(arc_north)
    for d in (dj, dp):
        d.prep_thetatheta(**_SEED_PREP)
        d.fit_thetatheta()
    return dj, dp


class TestArcFacadeVsJax:
    """The arc fit of the façade against the JAX façade. The port's
    spectra are float32 (≲1e-6 of the peak in linear power), the JAX
    side's float64, and the rest of the path is the same float64
    arithmetic, so the fitted curvatures agree to ~1e-6 relative; the
    tolerances below leave a decade of room."""

    def test_fit_arc_lamsteps(self, arc_north):
        dj, dp = _pair(arc_north)
        fj = dj.fit_arc(lamsteps=True, numsteps=4000)[0]
        fp = dp.fit_arc(lamsteps=True, numsteps=4000)[0]
        np.testing.assert_array_equal(dp.lamdyn, dj.lamdyn)
        assert dp.dlam == dj.dlam and dp.nlam == dj.nlam
        np.testing.assert_array_equal(dp.beta, dj.beta)
        np.testing.assert_array_equal(dp.fdop, dj.fdop)
        assert dp.betaeta == pytest.approx(dj.betaeta, rel=1e-5)
        assert dp.betaetaerr == pytest.approx(dj.betaetaerr, rel=1e-4)
        assert dp.betaetaerr2 == pytest.approx(dj.betaetaerr2, rel=1e-3)
        assert fp.eta == dp.betaeta and fj.eta == dj.betaeta
        np.testing.assert_allclose(dp.eta_array, dj.eta_array, rtol=1e-12)

    def test_fit_arc_tdel_and_norm_sspec(self, arc_north):
        """The non-lamsteps fit (β bounds at ``ref_freq`` converted to
        η) and ``norm_sspec`` at the fitted curvature."""
        dj, dp = _pair(arc_north)
        kw = dict(numsteps=3000, etamin=2.0, etamax=6.0)
        dj.fit_arc(**kw)
        dp.fit_arc(**kw)
        assert dp.eta == pytest.approx(dj.eta, rel=1e-5)
        assert dp.etaerr == pytest.approx(dj.etaerr, rel=1e-4)
        nj = dj.norm_sspec(lamsteps=False, numsteps=600)
        np_ = dp.norm_sspec(lamsteps=False, numsteps=600)
        np.testing.assert_array_equal(np_.fdop, nj.fdop)
        np.testing.assert_array_equal(dp.mask, dj.mask)
        np.testing.assert_allclose(dp.normsspecavg, dj.normsspecavg,
                                   rtol=1e-4)

    def test_prep_thetatheta_hough_seed(self, seeded):
        dj, dp = seeded
        assert 0.5 * 5e-4 < dp.eta_min < 5e-4 < dp.eta_max < 2 * 5e-4
        assert dp.eta_min == pytest.approx(dj.eta_min, rel=1e-5)
        assert dp.eta_max == pytest.approx(dj.eta_max, rel=1e-5)
        assert dp.neta == dj.neta
        np.testing.assert_array_equal(dp.edges, dj.edges)
        assert dp.betaeta == pytest.approx(dj.betaeta, rel=1e-5)

    def test_fit_thetatheta_after_the_seed(self, seeded):
        """rel 1e-2: the JAX package's own warm-vs-staged gate."""
        dj, dp = seeded
        assert np.isfinite(dp.ththeta)
        assert dp.ththeta == pytest.approx(dj.ththeta, rel=1e-2)
        assert dp.ththeta == pytest.approx(5e-4, rel=0.05)

    def test_fit_thetatheta_plain_eig(self, arc_north):
        """``eig="plain"`` (the card's reference route) fits as the
        default does on the CPU, where both run the plain eigensolver:
        bitwise; an unknown name raises."""
        _, dp = _pair(arc_north)
        dp.prep_thetatheta(**_SEED_PREP)
        dp.fit_thetatheta()
        th, evo = dp.ththeta, dp.eta_evo.copy()
        dp.fit_thetatheta(eig="plain")
        assert dp.ththeta == th
        np.testing.assert_array_equal(dp.eta_evo, evo)
        with pytest.raises(ValueError, match="unknown eig"):
            dp.fit_thetatheta(eig="eigh")

    def test_wide_band_seed_matches_jax(self):
        """A 14% band (512 channels of 0.4 MHz from 1400 MHz, the north
        star's fractional band): the synthetic keeps η_true at every
        frequency while the façade searches row cf over [η_min, η_max]·
        (fref/f_cf)², so the narrow seeded range misses η_true in the
        highest row and ``ththeta`` lands ~5% off the truth, in both
        packages alike: range rel 1e-5, ththeta and per-row η rel 1e-3
        (the float32 spectra of the port)."""
        n, dt, df, f0, eta = 512, 2.0, 0.4, 1400.0, 5e-4
        dyn = tw.make_arc_dynspec(n, n, dt, df, f0, eta, n_images=96,
                                  seed=21)
        kw = dict(name="wide", times=dt * np.arange(n),
                  freqs=f0 + df * np.arange(n))
        prep = dict(cwf=128, cwt=128, npad=1, nedge=64)
        dj = jdyn.Dynspec(dyn=jdyn.BasicDyn(dyn, **kw), verbose=False,
                          process=False, backend="jax")
        dp = tdyn.Dynspec(dyn=tdyn.BasicDyn(dyn, **kw), verbose=False,
                          process=False, device="cpu")
        for d in (dj, dp):
            d.prep_thetatheta(**prep)
            d.fit_thetatheta()
        assert dp.eta_min == pytest.approx(dj.eta_min, rel=1e-5)
        assert dp.eta_max == pytest.approx(dj.eta_max, rel=1e-5)
        assert dp.neta == dj.neta
        assert dp.eta_min < eta < dp.eta_max
        top = dp.freqs[-128:].mean()
        assert dp.eta_max * (dp.fref / top) ** 2 < eta   # the last row
        assert dp.ththeta == pytest.approx(dj.ththeta, rel=1e-3)
        assert abs(dp.ththeta / eta - 1) > 0.03
        np.testing.assert_allclose(np.nanmedian(dp.eta_evo, axis=1),
                                   np.nanmedian(dj.eta_evo, axis=1),
                                   rtol=1e-3)

    def test_one_bound_keeps_it_and_seeds_the_other(self, arc_north):
        dj, dp = _pair(arc_north)
        for d in (dj, dp):
            d.prep_thetatheta(eta_max=9e-4, **_SEED_PREP)
        assert dp.eta_max == dj.eta_max
        assert dp.eta_min == pytest.approx(dj.eta_min, rel=1e-5)


class TestRetrievalVsJax:
    def test_retrieve_wavefield(self, jax_retrieved):
        ds = _port_from(jax_retrieved)
        wf = ds.retrieve_wavefield()
        assert (ds.ncf_ret, ds.nct_ret) == (7, 7)
        assert wf.shape == jax_retrieved.wavefield.shape == (256, 256)
        assert ds.wavefield is wf and np.isfinite(wf).all()
        np.testing.assert_array_equal(ds.wavefield_ok,
                                      jax_retrieved.wavefield_ok)
        rel, corr = _intensity_gap(wf, jax_retrieved.wavefield)
        assert rel < 5e-3 and corr > 0.9999, (rel, corr)
        assert not hasattr(ds, "chunks")

    def test_calc_wavefield(self, arc_square, jax_retrieved):
        dj = _jax_dynspec(arc_square)
        dj.ththeta = jax_retrieved.ththeta
        want = dj.calc_wavefield()
        ds = _port_from(jax_retrieved)
        got = ds.calc_wavefield()
        assert ds.chunks.shape == dj.chunks.shape == (7, 7, 64, 64)
        rel, corr = _intensity_gap(got, want)
        assert rel < 5e-3 and corr > 0.9999, (rel, corr)
        # the device stitch of the same chunks
        dev = ds.calc_wavefield(device_mosaic=True)
        assert np.linalg.norm(dev - got) < 1e-5 * np.linalg.norm(got)

    def test_gerchberg_saxton_after_retrieval(self, jax_retrieved):
        ds = _port_from(jax_retrieved)
        wf = ds.retrieve_wavefield(gs=True, niter=2)
        dyn = ds.dyn[: wf.shape[0], : wf.shape[1]]
        good = np.isfinite(dyn) & (dyn > 0)
        np.testing.assert_allclose(np.abs(wf[good]), np.sqrt(dyn[good]),
                                   rtol=1e-5)

    def test_own_prep_sets_the_mosaic_grid(self, arc_square):
        dyn, times, freqs = arc_square
        bd = tdyn.BasicDyn(dyn, name="arcsim", times=times, freqs=freqs)
        ds = tdyn.Dynspec(dyn=bd, verbose=False, process=False,
                          device="cpu")
        ds.prep_thetatheta(**_PREP_RET)
        dj = _jax_dynspec(arc_square)
        assert (ds.ncf_ret, ds.nct_ret) == (dj.ncf_ret, dj.nct_ret) == (7, 7)
        np.testing.assert_array_equal(ds.edges, dj.edges)


@pytest.fixture(scope="module")
def arc_small():
    """The north star's synthetic at 128²: at the default prep (one chunk
    of the whole spectrum, npad 3) it has 404 θ edges; a 512² spectrum
    would have ~1800, beyond a CPU test."""
    n, dt, df, f0 = 128, 2.0, 0.05, 1400.0
    dyn = tw.make_arc_dynspec(n, n, dt, df, f0, 5e-4, n_images=96, seed=21)
    return dyn, dt * np.arange(n), f0 + df * np.arange(n)


def _shared_methods():
    return sorted(n for n, v in vars(jdyn.Dynspec).items()
                  if callable(v) and n in vars(tdyn.Dynspec))


class TestFaultsFixed:
    """Each fault of the façade against the reference, with one input
    fed to both packages."""

    def test_fit_thetatheta_without_prep(self, arc_small):
        """No ``prep_thetatheta``: both façades prep with the defaults
        (one chunk, the Hough seed), then take the one-chunk route.
        ``ththeta`` at the seeded façade's rel 1e-2; the seeded range and
        the geometry as ``test_prep_thetatheta_hough_seed`` holds them."""
        dj, dp = _pair(arc_small)
        for d in (dj, dp):
            d.fit_thetatheta()
        assert (dp.ncf_fit, dp.nct_fit, dp.npad) == (1, 1, 3)
        assert dp.eta_min == pytest.approx(dj.eta_min, rel=1e-5)
        assert dp.eta_max == pytest.approx(dj.eta_max, rel=1e-5)
        assert dp.neta == dj.neta
        np.testing.assert_array_equal(dp.edges, dj.edges)
        np.testing.assert_array_equal(dp.eta_evo_ok, dj.eta_evo_ok)
        assert np.isfinite(dp.ththeta)
        assert dp.ththeta == pytest.approx(dj.ththeta, rel=1e-2)

    def test_retrieval_without_prep_or_fit(self, arc_small):
        """``retrieve_wavefield`` and ``calc_asymmetry`` on bare façades
        fit first, and so prep first, as the reference does."""
        dyn, times, freqs = arc_small
        kw = dict(times=times, freqs=freqs)
        ds = tdyn.Dynspec(dyn=tdyn.BasicDyn(dyn, **kw), verbose=False,
                          process=False, device="cpu")
        wf = ds.retrieve_wavefield()
        assert (ds.ncf_ret, ds.nct_ret) == (1, 1)
        assert np.isfinite(ds.ththeta)
        assert wf.shape == dyn.shape and np.isfinite(wf).all()
        ds = tdyn.Dynspec(dyn=tdyn.BasicDyn(dyn, **kw), verbose=False,
                          process=False, device="cpu")
        assert np.isfinite(ds.calc_asymmetry()).all()

    def test_load_dyn_obj_processes_by_default(self, arc):
        """``process=True`` is the default of ``load_dyn_obj`` in both,
        and runs the default processing (trim, linear refill, ACF, λ
        rescale with ``lamsteps``, spectrum): the port's state holds to
        the JAX façade's (host steps rtol 1e-12, ACF and spectrum within
        1e-5 of the peak). ``filename`` and ``lamsteps`` are set as in
        the reference; ``Dynspec(...)`` keeps ``process=False``."""
        import inspect

        dyn, times, freqs = arc
        kw = dict(name="arcsim", times=times, freqs=freqs)
        for cls in (jdyn.Dynspec, tdyn.Dynspec):
            sig = inspect.signature(cls.load_dyn_obj)
            assert sig.parameters["process"].default is True
            assert inspect.signature(cls).parameters["process"].default \
                is False
        dj = jdyn.Dynspec(dyn=jdyn.BasicDyn(dyn, **kw), verbose=False,
                          backend="jax")
        dp = tdyn.Dynspec(dyn=tdyn.BasicDyn(dyn, **kw), verbose=False,
                          device="cpu")
        assert not hasattr(dj, "sspec") and not hasattr(dp, "sspec")
        for d in (dj, dp):
            assert d.filename is None and d.lamsteps is False
        faulty = np.array(dyn)
        faulty[:2] = 0
        faulty[40, 17] = np.nan
        dj.load_dyn_obj(jdyn.BasicDyn(faulty, **kw), verbose=False,
                        lamsteps=True)
        dp.load_dyn_obj(tdyn.BasicDyn(faulty, **kw), verbose=False,
                        lamsteps=True)
        assert dp.lamsteps is True
        assert dp.dyn.shape == (dyn.shape[0] - 2, dyn.shape[1])
        np.testing.assert_allclose(dp.dyn, dj.dyn, rtol=1e-12, atol=0)
        np.testing.assert_allclose(dp.lamdyn, dj.lamdyn, rtol=1e-12)
        np.testing.assert_array_equal(dp.freqs, dj.freqs)
        assert (dp.nchan, dp.bw, dp.df, dp.freq) == (dj.nchan, dj.bw,
                                                     dj.df, dj.freq)
        np.testing.assert_allclose(dp.acf, dj.acf, rtol=0, atol=1e-5)
        lin_t, lin_j = 10 ** (dp.lamsspec / 10), 10 ** (dj.lamsspec / 10)
        np.testing.assert_allclose(lin_t, lin_j, rtol=0,
                                   atol=1e-5 * lin_j.max())

    @pytest.mark.parametrize("name", _shared_methods())
    def test_reference_parameters_come_first(self, name):
        """Every method both façades define takes the reference's
        parameters, in its order and with its defaults, before any of the
        port's own."""
        import inspect

        ref = list(inspect.signature(getattr(jdyn.Dynspec, name))
                   .parameters.values())
        ours = list(inspect.signature(getattr(tdyn.Dynspec, name))
                    .parameters.values())
        assert [p.name for p in ours[:len(ref)]] == [p.name for p in ref]
        for r, o in zip(ref, ours):
            assert o.kind == r.kind, r.name
            same = (o.default is r.default
                    or np.array_equal(np.asarray(o.default, dtype=object),
                                      np.asarray(r.default, dtype=object)))
            assert same, (r.name, o.default, r.default)

    def test_shared_methods_cover_the_port(self):
        names = _shared_methods()
        for n in ("__init__", "load_dyn_obj", "calc_sspec", "scale_dyn",
                  "fit_arc", "norm_sspec", "fit_thetatheta",
                  "thetatheta_single", "calc_asymmetry",
                  "thetatheta_chunks", "calc_wavefield", "load_file",
                  "write_file", "__add__", "remove_short_subs",
                  "trim_edges", "crop_dyn", "zap", "refill", "correct_dyn",
                  "calc_acf", "cut_dyn", "auto_processing",
                  "default_processing", "info", "calc_scattered_image"):
            assert n in names
        dyn = np.random.default_rng(0).random((8, 8)) + 1
        bd = tdyn.BasicDyn(dyn, times=np.arange(8.0), freqs=np.arange(8.0))
        with pytest.raises(NotImplementedError, match="backend"):
            tdyn.Dynspec(dyn=bd, verbose=False, backend="jax", device="cpu")
        ds = tdyn.Dynspec(dyn=bd, verbose=False, device="cpu")
        # input_dyn and return_sspec return the spectrum and store nothing
        for got in (ds.calc_sspec(input_dyn=dyn),
                    ds.calc_sspec(return_sspec=True)):
            assert got[2].shape == (8, 16) and len(got[0]) == 16
        assert not hasattr(ds, "sspec")
        # correct_dyn(velocity=True) is ported: without a velocity
        # spectrum it refuses as the JAX façade does
        dj = jdyn.Dynspec(dyn=jdyn.BasicDyn(dyn, times=np.arange(8.0),
                                            freqs=np.arange(8.0)),
                          verbose=False, backend="jax")
        for d in (ds, dj):
            with pytest.raises(ValueError, match="scale_dyn"):
                d.correct_dyn(velocity=True)
        for call in (lambda: ds.calc_sspec(plot=True),
                     lambda: ds.cut_dyn(plot=True),
                     lambda: ds.calc_scattered_image(plot=True),
                     lambda: ds.fit_thetatheta(plot=True),
                     lambda: ds.fit_thetatheta(mesh=object()),
                     lambda: ds.thetatheta_single(plot=True)):
            with pytest.raises(NotImplementedError):
                call()


class TestOneChunkPerRow:
    """The façade's serial route (one chunk per frequency row) and the
    single-chunk diagnostic against the JAX façade."""

    _PREP_ROWS = dict(cwf=64, eta_min=0.1, eta_max=0.9, nedge=32,
                      edges_lim=2.6, npad=1)

    def test_fit_thetatheta_one_chunk_per_row(self, arc_square):
        """η per row and ``ththeta`` rel 1e-2 (the single-chunk search's
        gate against JAX ``single_search``)."""
        dyn, times, freqs = arc_square
        kw = dict(name="arcsim", times=times, freqs=freqs)
        dj = jdyn.Dynspec(dyn=jdyn.BasicDyn(dyn, **kw), verbose=False,
                          process=False, backend="jax")
        dp = tdyn.Dynspec(dyn=tdyn.BasicDyn(dyn, **kw), verbose=False,
                          process=False, device="cpu")
        for d in (dj, dp):
            d.prep_thetatheta(**self._PREP_ROWS)
        dj.fit_thetatheta()
        dp.fit_thetatheta(pool=object())
        assert dp.eta_evo.shape == dj.eta_evo.shape == (4, 1)
        np.testing.assert_array_equal(dp.eta_evo_ok, dj.eta_evo_ok)
        np.testing.assert_allclose(dp.eta_evo, dj.eta_evo, rtol=1e-2)
        np.testing.assert_array_equal(dp.f0s, dj.f0s)
        np.testing.assert_array_equal(dp.t0s, dj.t0s)
        assert dp.ththeta == pytest.approx(dj.ththeta, rel=1e-2)

    def test_thetatheta_single(self, jax_fit):
        """η rel 1e-2; ``arrays=True`` gives ``(etas, eigs, popt)``; the
        chunk indices clip to the grid."""
        ds = tdyn.Dynspec.from_reference_state(_state(jax_fit),
                                               device="cpu")
        for cf, ct in ((0, 0), (0, 1), (5, 9)):
            want = jax_fit.thetatheta_single(cf, ct)
            got = ds.thetatheta_single(cf, ct)
            assert got.ok == want.ok == 0
            assert got.eta == pytest.approx(want.eta, rel=1e-2)
            assert got.time_mean == want.time_mean
        etas, eigs, popt = ds.thetatheta_single(0, 1, arrays=True)
        assert len(etas) == len(eigs) and len(popt) == 3
        plain = ds.thetatheta_single(0, 1, eig="plain")
        assert plain.eta == got.eta


class TestAsymmetryAndMemmap:
    def test_calc_asymmetry(self, jax_fit):
        """abs 1e-4 per chunk against the JAX façade at its ``ththeta``."""
        want = jax_fit.calc_asymmetry()
        ds = tdyn.Dynspec.from_reference_state(
            dict(_state(jax_fit), ththeta=jax_fit.ththeta), device="cpu")
        got = ds.calc_asymmetry(pool=object())
        assert got.shape == want.shape == (1, 2)
        assert np.isfinite(got).all() and np.all(np.abs(got) <= 1)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        ds.ththeta = np.nan
        assert np.isnan(ds.calc_asymmetry()).all()

    def test_memmap_matches_jax(self, arc_square, jax_retrieved, tmp_path,
                                monkeypatch):
        """The row-by-row route into ``memmap.dat``, each package in its
        own working directory: stitched intensities at rel L2 5e-3 (and
        corr > 0.9999), the port's chunks complex128 on the file."""
        dj = _jax_dynspec(arc_square)
        dj.ththeta = jax_retrieved.ththeta
        (tmp_path / "jax").mkdir()
        (tmp_path / "port").mkdir()
        monkeypatch.chdir(tmp_path / "jax")
        want = dj.calc_wavefield(memmap=True)
        monkeypatch.chdir(tmp_path / "port")
        ds = _port_from(jax_retrieved)
        got = ds.calc_wavefield(memmap=True, pool=object())
        assert isinstance(ds.chunks, np.memmap)
        assert ds.chunks.dtype == np.complex128
        assert (tmp_path / "port" / "memmap.dat").exists()
        rel, corr = _intensity_gap(got, want)
        assert rel < 5e-3 and corr > 0.9999, (rel, corr)
        dense = _port_from(jax_retrieved).calc_wavefield()
        np.testing.assert_allclose(got, dense, rtol=0,
                                   atol=1e-6 * np.abs(dense).max())

class TestRejectedInputs:
    def test_device_none_raises_without_a_card(self, arc):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        from scintools_tpu_torch import multi_chunk_search, secondary_spectrum

        dyn, times, freqs = arc
        bd = tdyn.BasicDyn(dyn, times=times, freqs=freqs)
        with pytest.raises(RuntimeError):
            tdyn.Dynspec(dyn=bd, verbose=False)
        with pytest.raises(RuntimeError):
            secondary_spectrum(dyn, 30.0, 0.2)
        with pytest.raises(RuntimeError):
            multi_chunk_search([dyn[:, :128]], freqs, [times[:128]],
                               [0.3], np.linspace(-1, 1, 8))
        with pytest.raises(RuntimeError):
            tw.make_north_star_pipeline(64, 64, 64, 64, 1, None, None,
                                        None, None, 1)
        with pytest.raises(RuntimeError):
            tbatch.make_multi_eval_fn(None, None, None)
        with pytest.raises(RuntimeError):
            tbatch.make_fused_search_fn(None, None, None, 64, 64)
        with pytest.raises(RuntimeError):
            tdyn.Dynspec.from_reference_state(
                {k: 0 for k in tdyn._STATE_KEYS})
        # retrieve_wavefield runs on the Dynspec's device: with
        # device=None there is no Dynspec to call it on
        with pytest.raises(RuntimeError):
            tdyn.Dynspec.from_reference_state(
                dict({k: 0 for k in tdyn._STATE_KEYS}, ththeta=0.3))

    def test_unported_options_raise(self, arc, tmp_path):
        """Plotting and ``mesh`` still raise. ``process=True``,
        ``filename=``, ``fitting_proc="thin"``, the velocity rescale and
        the trapezoid spectrum now run, each held to the JAX façade on the
        same input (the velocity rescale refuses without a par file, as
        the JAX façade does)."""
        from scintools_tpu.io.psrflux import RawDynSpec, write_psrflux

        dyn, times, freqs = arc
        bd = tdyn.BasicDyn(dyn, times=times, freqs=freqs)
        jd = jdyn.BasicDyn(dyn, times=times, freqs=freqs)
        dp = tdyn.Dynspec(dyn=bd, process=True, verbose=False, device="cpu")
        dj = jdyn.Dynspec(dyn=jd, process=True, verbose=False,
                          backend="jax")
        np.testing.assert_allclose(dp.dyn, dj.dyn, rtol=1e-12, atol=0)
        np.testing.assert_allclose(dp.acf, dj.acf, rtol=0, atol=1e-5)
        path = str(tmp_path / "x.dynspec")
        write_psrflux(RawDynSpec(dyn=dyn, times=times, freqs=freqs), path)
        dp = tdyn.Dynspec(filename=path, verbose=False, device="cpu")
        dj = jdyn.Dynspec(filename=path, verbose=False, backend="jax")
        np.testing.assert_array_equal(dp.dyn, dj.dyn)
        np.testing.assert_array_equal(dp.times, dj.times)
        assert (dp.dt, dp.df, dp.mjd) == (dj.dt, dj.df, dj.mjd)
        thin = dict(fitting_proc="thin", eta_min=0.1, eta_max=0.9)
        ds = tdyn.Dynspec(dyn=bd, verbose=False, device="cpu")
        ds.prep_thetatheta(**thin)
        dj = jdyn.Dynspec(dyn=jd, verbose=False, backend="jax")
        dj.prep_thetatheta(**thin)
        np.testing.assert_array_equal(ds.edges, dj.edges)
        assert (ds.arclet_lim, ds.center_cut) == (dj.arclet_lim,
                                                  dj.center_cut)
        ds = tdyn.Dynspec(dyn=bd, verbose=False, device="cpu")
        dj = jdyn.Dynspec(dyn=jd, verbose=False, backend="jax")
        for d in (ds, dj):
            with pytest.raises(ValueError, match="par"):
                d.scale_dyn(scale="velocity")
            d.calc_sspec(trap=True)
        np.testing.assert_allclose(ds.trapdyn, dj.trapdyn, atol=1e-10)
        lin = 10 ** (dj.trapsspec / 10)
        np.testing.assert_allclose(10 ** (ds.trapsspec / 10), lin,
                                   atol=1e-5 * lin.max())
        with pytest.raises(NotImplementedError):
            ds.fit_arc(plot=True)
        with pytest.raises(NotImplementedError):
            ds.norm_sspec(eta=1.0, plot=True)
        with pytest.raises(ValueError):
            ds.prep_thetatheta(fitting_proc="bogus")
        with pytest.raises(ValueError):
            tdyn.BasicDyn(dyn)
        with pytest.raises(KeyError):
            tdyn.Dynspec.from_reference_state({"dyn": dyn}, device="cpu")

    def test_unported_scint_options_raise(self, arc):
        """The scintillation fits' options that are not ported raise (the
        sspec method, plotting for item 13); an unknown method is refused
        as in the JAX package. ``fitter(mcmc=True)`` runs the device
        sampler with no host fall-back, so a model that cannot take
        tensor parameters raises through it. The chirp-Z rows and the
        model ACF's spectrum now run, held to the JAX package."""
        from scintools_tpu_torch.fit.fitter import fitter
        from scintools_tpu_torch.fit.parameters import Parameters
        from scintools_tpu_torch.sim import acf_model

        dyn, times, freqs = arc
        ds = tdyn.Dynspec(dyn=tdyn.BasicDyn(dyn, times=times, freqs=freqs),
                          verbose=False, device="cpu")
        for kw in (dict(method="sspec"), dict(plot=True)):
            with pytest.raises(NotImplementedError):
                ds.get_scint_params(**kw)
        with pytest.raises(ValueError):
            ds.get_scint_params(method="bogus")
        with pytest.raises(NotImplementedError):
            ds.get_acf_tilt(plot=True)
        p = Parameters()
        p.add("a", 1.0)
        with pytest.raises(AttributeError):
            fitter(lambda q, x: x - q["a"].value, p, (np.ones(3),),
                   mcmc=True, device="cpu")
        from scintools_tpu.sim import acf_model as jacf

        args = (100.0, 3.0, 1.0, 0.0, 30.0, 0.0, 10.0, 0.5)
        got = acf_model.make_acf2d_model_core(
            9, 9, 2.0, 5 / 3, 0.0, 100.0, 10.0, fresnel_method="czt",
            precision="highest", device="cpu")(*args)
        ref = np.asarray(jacf.make_acf2d_model_core(
            9, 9, 2.0, 5 / 3, 0.0, 100.0, 10.0, fresnel_method="czt",
            precision="highest")(*args))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-8,
                                   atol=1e-10 * np.abs(ref).max())
        with pytest.raises(ValueError, match="fresnel_method"):
            acf_model.make_acf2d_model_core(9, 9, 2.0, 5 / 3, 0.0, 100.0,
                                            10.0, fresnel_method="fft",
                                            device="cpu")
        acf = acf_model.ACF(nt=9, nf=9, device="cpu")
        ref = jacf.ACF(nt=9, nf=9).calc_sspec()
        np.testing.assert_allclose(acf.calc_sspec(), ref, rtol=1e-8,
                                   atol=1e-8 * np.abs(ref).max())
        with pytest.raises(NotImplementedError):
            acf_model.ACF(nt=9, nf=9, plot=True, device="cpu")

    def test_unported_retrieval_options_raise(self, jax_fit, tmp_path,
                                              monkeypatch):
        """``mesh`` and ``gs_mesh`` still raise; ``memmap``, ``pool`` and
        ``method="power"`` now run (each is held to the JAX package in
        its own test)."""
        ds = tdyn.Dynspec.from_reference_state(
            dict(_state(jax_fit), ththeta=jax_fit.ththeta), device="cpu")
        with pytest.raises(NotImplementedError):
            ds.thetatheta_chunks(mesh=object())
        with pytest.raises(NotImplementedError):
            ds.calc_wavefield(mesh=object())
        with pytest.raises(NotImplementedError):
            ds.calc_wavefield(gs_mesh=object())
        with pytest.raises(NotImplementedError):
            ds.retrieve_wavefield(mesh=object())
        with pytest.raises(NotImplementedError):
            ds.gerchberg_saxton(mesh=object())
        monkeypatch.chdir(tmp_path)
        ds.thetatheta_chunks(memmap=True, pool=object())
        assert isinstance(ds.chunks, np.memmap)
        assert (tmp_path / "memmap.dat").exists()
        wf = ds.retrieve_wavefield(method="power")
        assert wf.shape == ds.dyn.shape and np.isfinite(wf).all()
        ds.gerchberg_saxton(pool=object())


class TestNorthStarWorkload:
    def test_problem_builders_are_copies(self):
        from bench import make_arc_dynspec

        a = tw.make_arc_dynspec(64, 48, 2.0, 0.05, 1400.0, 5e-4, 8, seed=3)
        b = make_arc_dynspec(64, 48, 2.0, 0.05, 1400.0, 5e-4, 8, seed=3)
        np.testing.assert_array_equal(a, b)

    def test_pipeline_recovers_curvature(self):
        """One 256² chunk (N = 256, 200 η) on the CPU: the stages run
        in order and the fitted η lands within 2% of the truth."""
        nf = nt = 256
        p = tw.make_north_star_problem(nf, nt, n_variants=1)
        args = (nf, nt, p["cf"], p["ct"], p["npad"], p["wins"], p["tau"],
                p["fd"], p["edges"], 1)
        marks = []
        sec, eigs, peak = tw.make_north_star_pipeline(
            *args, fw=0.2, device="cpu")(p["dyns"][0], p["etas"],
                                         mark=marks.append)
        assert sec.shape == (256, 512) and eigs.shape == (1, 200)
        assert marks == ["sspec", "cs", "gather", "eig", "peakfit"]
        assert abs(float(peak[0, 0]) - p["eta_true"]) < 0.02 * p["eta_true"]
