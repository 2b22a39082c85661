"""Velocity and trapezoid rescaling of the port against the JAX package
on the CPU: the par file, the orbit and the ephemeris, the velocity and
curvature models, the scintillation velocity, the rescalings and the
façade's ``scale_dyn(scale="velocity" | "trap")`` with the spectra and
fits that read them.

Each case gives the same numpy input, made from a seed, to both
packages; the tolerances are the JAX package's own
(tests/test_io.py:79-107, tests/test_ephemeris_golden.py:42-73,
tests/test_velocity_models.py:27-187, tests/test_ops.py:232-258).
"""

import json
import os

import numpy as np
import pytest
import torch

from scintools_tpu import dynspec as jdyn
from scintools_tpu.fit import models as jmodels
from scintools_tpu.io import parfile as jpar
from scintools_tpu.ops import scale as jscale
from scintools_tpu.utils import ephemeris as jeph
from scintools_tpu.utils import orbit as jorbit
from scintools_tpu.utils import velocity as jvel
from scintools_tpu_torch import dynspec as tdyn
from scintools_tpu_torch.fit import models as tmodels
from scintools_tpu_torch.io import parfile as tpar
from scintools_tpu_torch.ops import scale as tscale
from scintools_tpu_torch.utils import ephemeris as teph
from scintools_tpu_torch.utils import orbit as torbit
from scintools_tpu_torch.utils import velocity as tvel
from scintools_tpu_torch.workloads import make_arc_dynspec

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "ephemeris_golden.json")

#: J0437−4715-like elements (tests/test_io.py:79-107,
#: tests/test_velocity_models.py:17-24) and its orientation
J0437_PAR = (
    "PSRJ           J0437-4715\n"
    "RAJ            04:37:15.99744 1 0.00001\n"
    "DECJ           -47:15:09.7170 1 0.0001\n"
    "F0             173.6879458121843 1 1e-12\n"
    "PMRA           121.4385 1 0.002\n"
    "PMDEC          -71.4754 1 0.002\n"
    "PB             5.7410459 1 0.000002\n"
    "A1             3.36669157 1 0.00000014\n"
    "E              1.9180e-05 1 0.0000002\n"
    "T0             54501.0\n"
    "OM             1.20 1 0.05\n"
    "KIN            137.56\n"
    "KOM            207.0\n"
    "NTOA           1000\n"
    "# a comment\n")


@pytest.fixture(scope="module")
def parfile(tmp_path_factory):
    p = tmp_path_factory.mktemp("par") / "J0437.par"
    p.write_text(J0437_PAR)
    return str(p)


def _binary_params(**over):
    p = {"d": 0.16, "s": 0.7, "A1": 3.37, "PB": 5.74, "ECC": 0.0,
         "OM": 0.0, "T0": 54501.0, "KIN": 90.0, "KOM": 0.0,
         "PMRA": 121.0, "PMDEC": -71.0}
    p.update(over)
    return p


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


class TestParfile:
    def test_read_par_same_dict(self, parfile):
        t, j = tpar.read_par(parfile), jpar.read_par(parfile)
        assert t == j
        assert t["ECC"] == pytest.approx(1.918e-05)
        assert t["ECC_TYPE"] == "e" and t["PB_ERR"] == pytest.approx(2e-6)
        assert "NTOA" not in t and t["PSRJ"] == "J0437-4715"

    def test_pars_to_params(self, parfile):
        par = tpar.read_par(parfile)
        t = tpar.pars_to_params(par)
        j = jpar.pars_to_params(jpar.read_par(parfile))
        assert list(t) == list(j)
        for k in t:
            assert t[k].value == j[k].value and t[k].vary is False
        assert 1.1 < t["RAJ"].value < 1.3 and t["DECJ"].value < 0
        for s in ("04:37:15.9", "-00:30:01.5", "12"):
            assert tpar._hms_to_rad(s) == jpar._hms_to_rad(s)
            assert tpar._dms_to_rad(s) == jpar._dms_to_rad(s)


class TestOrbit:
    @pytest.mark.parametrize("ecc", [0.0, 1.918e-5, 0.3])
    def test_true_anomaly_and_phase(self, ecc):
        mjds = 54501.0 + np.random.default_rng(4).uniform(0, 30, 64)
        p = _binary_params(ECC=ecc, OMDOT=0.02, PBDOT=3.7)
        ref = np.asarray(jorbit.get_true_anomaly(mjds, p, backend="numpy"))
        _close(torbit.get_true_anomaly(mjds, p), ref, 1e-12)
        got = torbit.get_true_anomaly(torch.as_tensor(mjds), p)
        assert got.dtype == torch.float64
        _close(got.numpy(), ref, 1e-12)
        _close(torbit.get_binphase(mjds, p),
               jorbit.get_binphase(mjds, p, backend="numpy"), 1e-12)

    def test_ell1_and_kepler(self):
        p = {"TASC": 54500.3, "EPS1": 1e-3, "EPS2": -2e-3, "PB": 1.2}
        mjds = np.linspace(54500, 54503, 40)
        _close(torbit.get_binphase(mjds, p),
               jorbit.get_binphase(mjds, p, backend="numpy"), 1e-12)
        M = np.linspace(-3, 3, 50)
        _close(torbit.kepler_solve(M, 0.6),
               jorbit.kepler_solve(M, 0.6, backend="numpy"), 1e-12)


class TestEphemeris:
    @pytest.fixture(scope="class")
    def golden(self):
        with open(FIXTURE) as f:
            return json.load(f)

    def test_golden_velocity_and_delay(self, golden):
        """The port's ephemeris on the golden fixture: velocity within
        20 m/s, Roemer delay within 0.1 s."""
        mjds = np.array(golden["mjds"])
        for name, p in golden["pulsars"].items():
            vra, vdec, vr = teph.get_earth_velocity(mjds, p["raj"], p["decj"],
                                                    radial=True)
            dv = np.sqrt((vra - np.array(p["vearth_ra_kms"])) ** 2
                         + (vdec - np.array(p["vearth_dec_kms"])) ** 2
                         + (vr - np.array(p["vearth_r_kms"])) ** 2) * 1e3
            assert dv.max() < 20.0, name
            d = teph.get_ssb_delay(mjds, p["raj"], p["decj"])
            assert np.abs(d - np.array(p["ssb_delay_s"])).max() < 0.1, name

    def test_against_jax(self, golden):
        mjds = np.array(golden["mjds"])
        for p in golden["pulsars"].values():
            for a, b in zip(
                    teph.get_earth_velocity(mjds, p["raj"], p["decj"],
                                            radial=True),
                    jeph.get_earth_velocity(mjds, p["raj"], p["decj"],
                                            radial=True)):
                _close(a, b, 1e-12)
            _close(teph.get_ssb_delay(mjds, p["raj"], p["decj"]),
                   jeph.get_ssb_delay(mjds, p["raj"], p["decj"]), 1e-12)
        _close(teph.earth_position_bary(mjds),
               jeph.earth_position_bary(mjds), 1e-12)

    def test_galactic_helpers(self):
        ra, dec = tpar._hms_to_rad("04:37:15.9"), tpar._dms_to_rad("-47:15")
        _close(teph.icrs_to_galactic(ra, dec), jeph.icrs_to_galactic(ra, dec),
               1e-12)
        _close(teph.make_lsr(0.157, ra, dec, 121.4, -71.5),
               jeph.make_lsr(0.157, ra, dec, 121.4, -71.5), 1e-12)
        p = {"RAJ": "04:37:15.9", "DECJ": "-47:15:09", "s": 0.7, "d": 0.157}
        _close(teph.differential_velocity(p), jeph.differential_velocity(p),
               1e-12)


class TestVelocityModels:
    @pytest.fixture(scope="class")
    def inputs(self):
        rng = np.random.default_rng(11)
        nu = rng.uniform(0, 2 * np.pi, 32)
        return nu, rng.normal(0, 20, 32), rng.normal(0, 20, 32)

    @pytest.mark.parametrize("over", [
        {}, {"ECC": 0.2, "OMDOT": 1.5, "KIN": 60.0},
        {"SINI": 0.8, "sense": 0.7, "KIN": None}, {"COSI": 0.3, "KIN": None},
        {"PB": None}])
    def test_effective_velocity_annual(self, inputs, over):
        p = _binary_params(**over)
        p = {k: v for k, v in p.items() if v is not None}
        nu, vra, vdec = inputs
        mjd = 54501.0 + np.arange(32) / 10
        ref = jmodels.effective_velocity_annual(p, nu, vra, vdec, mjd=mjd,
                                                backend="numpy")
        for a, b in zip(tmodels.effective_velocity_annual(
                p, nu, vra, vdec, mjd=mjd), ref):
            _close(a, b, 1e-12, 1e-12)
        got = tmodels.effective_velocity_annual(
            p, torch.as_tensor(nu), torch.as_tensor(vra),
            torch.as_tensor(vdec), mjd=torch.as_tensor(mjd))
        for a, b in zip(got, ref):
            a = a.numpy() if isinstance(a, torch.Tensor) else a
            _close(a, b, 1e-12, 1e-12)

    @pytest.mark.parametrize("over", [
        {"nmodel": 0}, {"zeta": 30.0}, {"zeta": 77.0, "vism_zeta": 3.0},
        {"nmodel": 0, "vism_ra": 4.0, "vism_dec": -2.0}])
    def test_arc_curvature(self, inputs, over):
        p = _binary_params(**over)
        nu, vra, vdec = inputs
        y = np.random.default_rng(1).random(32)
        for mo in (False, True):
            ref = jmodels.arc_curvature(p, y, None, nu, vra, vdec,
                                        model_only=mo, return_veff=mo,
                                        backend="numpy")
            got = tmodels.arc_curvature(p, y, None, nu, vra, vdec,
                                        model_only=mo, return_veff=mo)
            for a, b in zip(np.atleast_2d(got), np.atleast_2d(ref)):
                _close(a, b, 1e-12)
        with pytest.raises(KeyError, match="zeta"):
            tmodels.arc_curvature({**p, "psi": 1.0}, y, None, nu, vra, vdec)

    @pytest.mark.parametrize("over", [{}, {"nmodel": 1, "R": 0.5,
                                           "psi": 30.0, "kappa": 1.2}])
    def test_veff_thin_screen(self, inputs, over):
        p = _binary_params(**over)
        nu, vra, vdec = inputs
        y, w = np.zeros(32), np.linspace(0.5, 1.5, 32)
        _close(tmodels.veff_thin_screen(p, y, w, nu, vra, vdec),
               jmodels.veff_thin_screen(p, y, w, nu, vra, vdec,
                                        backend="numpy"), 1e-12)

    def test_weak_arcs_and_power_curve(self):
        ftn = np.linspace(-0.95, 0.95, 41)
        for kw in ({}, {"ar": 2.0, "psi": 25.0, "alpha": 3.5}):
            _close(tmodels.arc_weak(ftn, **kw),
                   jmodels.arc_weak(ftn, backend="numpy", **kw), 1e-12)
            _close(tmodels.arc_weak(torch.as_tensor(ftn), **kw).numpy(),
                   jmodels.arc_weak(ftn, backend="numpy", **kw), 1e-12)
        fdop, tdel = np.linspace(-3, 3, 13), np.linspace(0.1, 4, 9)
        with np.errstate(invalid="ignore"):
            ref = jmodels.arc_weak_2d(fdop, tdel, eta=0.5, ar=1.5, psi=10,
                                      backend="numpy")
            got = tmodels.arc_weak_2d(fdop, tdel, eta=0.5, ar=1.5, psi=10)
        _close(got, ref, 1e-12)
        _close(tmodels.arc_weak_2d(torch.as_tensor(fdop),
                                   torch.as_tensor(tdel), eta=0.5, ar=1.5,
                                   psi=10).numpy(), ref, 1e-12)
        p = {"wn": 0.1, "amp": 2.0, "alpha": -1.5}
        x, y = np.linspace(0.2, 3, 20), np.linspace(1, 2, 20)
        _close(tmodels.arc_power_curve(p, x, y, None),
               jmodels.arc_power_curve(p, x, y, None, backend="numpy"), 1e-12)


class TestScintVelocity:
    def test_scint_velocity(self):
        params = {"d": 1.0, "s": 0.5, "derr": 0.1, "serr": 0.05}
        kw = dict(dnu=1.3, tau=100.0, freq=1000.0, dnuerr=0.1, tauerr=5.0)
        _close(tvel.scint_velocity(params, **kw),
               jvel.scint_velocity(params, **kw), 1e-12)
        _close(tvel.scint_velocity(None, 1.3, 100.0, 1400.0),
               jvel.scint_velocity(None, 1.3, 100.0, 1400.0), 1e-12)

    def test_curvature_likelihood(self):
        nfdop = np.linspace(-1, 1, 201)
        power = np.exp(-0.5 * ((nfdop - 0.3) / 0.05) ** 2)
        for m in (-0.5, 0.3, 2.0):
            assert (tvel.curvature_log_likelihood(power, nfdop, 1.0, m)
                    == jvel.curvature_log_likelihood(power, nfdop, 1.0, m))
        n2 = np.tile(nfdop, (3, 1))
        p2 = np.exp(-0.5 * ((n2 - 0.2) / 0.1) ** 2)
        m2 = np.array([0.2, -0.9, 3.0])
        assert (tvel.curvature_log_likelihood(p2, n2, 1.0, m2)
                == jvel.curvature_log_likelihood(p2, n2, 1.0, m2))
        _close(tvel.calculate_curvature_peak_probability(power, 2.0,
                                                         log=True),
               jvel.calculate_curvature_peak_probability(power, 2.0,
                                                         log=True), 1e-12)

    def test_save_curvature_data(self, tmp_path):
        class D:
            name, mjd = "x", 60000.0
            eta_array = np.arange(4.0)
            norm_sspec_avg = np.ones(4)
            noise = 0.1

        tvel.save_curvature_data(D, filename=str(tmp_path / "t"))
        jvel.save_curvature_data(D, filename=str(tmp_path / "j"))
        a = np.load(str(tmp_path / "t.npz"))
        b = np.load(str(tmp_path / "j.npz"))
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


class TestRescale:
    def test_velocity_rescale(self):
        rng = np.random.default_rng(5)
        dyn = rng.random((8, 40))
        np.testing.assert_allclose(tscale.velocity_rescale(dyn, np.ones(40)),
                                   dyn, atol=1e-10)
        veff = 20 + 5 * np.sin(np.linspace(0, 3, 40))
        _close(tscale.velocity_rescale(dyn, veff),
               jscale.velocity_rescale(dyn, veff), 1e-12, 1e-14)

    @pytest.mark.parametrize("shape,window", [((24, 32), "hanning"),
                                              ((16, 45), None),
                                              ((33, 20), "hamming")])
    def test_trapezoid(self, shape, window):
        """The device program on the CPU and the plain row loop against
        the JAX package's numpy path at atol 1e-10."""
        nf, nt = shape
        rng = np.random.default_rng(3)
        dyn = rng.normal(size=shape) ** 2
        times = np.arange(nt) * 10.0
        freqs = 1300.0 + np.arange(nf) * 9.0
        ref = jscale.trapezoid_rescale(dyn, times, freqs, window=window,
                                       backend="numpy")
        got = tscale.trapezoid_rescale(dyn, times, freqs, window=window,
                                       device="cpu")
        np.testing.assert_allclose(got, ref, atol=1e-10)
        np.testing.assert_array_equal(
            tscale.trapezoid_rescale_plain(dyn, times, freqs, window=window),
            ref)
        n_in = tscale._trapezoid_setup(dyn, times, freqs, window, 0.1)[2]
        assert n_in[0] < nt
        for r in range(nf):
            assert (got[r, n_in[r]:] == 0).all()

    def test_interp_rows_edges(self):
        """``jnp.interp``'s rules: the edges clamp, a point on the last
        node is the lerp of the last cell."""
        import jax.numpy as jnp

        xp = np.array([0.0, 0.1, 0.7, 1.3])
        fp = np.random.default_rng(2).normal(size=(3, 4))
        x = np.tile(np.array([-1.0, 0.0, 0.05, 0.7, 1.3, 2.0,
                              1.3 - 1e-12]), (3, 1))
        ref = np.stack([np.asarray(jnp.interp(x[r], xp, fp[r]))
                        for r in range(3)])
        got = tscale.interp_rows(torch.as_tensor(x), torch.as_tensor(xp),
                                 torch.as_tensor(fp)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-15, atol=1e-15)
        # outside the grid: exactly the edge values
        np.testing.assert_array_equal(got[:, 0], fp[:, 0])
        np.testing.assert_array_equal(got[:, 5], fp[:, -1])
        # on the last node: the last cell's lerp, fp[-2] + 1·(fp[-1] − fp[-2])
        np.testing.assert_array_equal(got[:, 4],
                                      fp[:, -2] + (fp[:, -1] - fp[:, -2]))


def _pair(parfile, nt=96, nf=64):
    dyn = make_arc_dynspec(nt, nf, 30.0, 0.5, 1400.0, 0.05, n_images=24,
                           seed=7)
    kw = dict(name="vel", times=30.0 * np.arange(nt),
              freqs=1400.0 + 0.5 * np.arange(nf), mjd=60123.25)
    dj = jdyn.Dynspec(dyn=jdyn.BasicDyn(dyn, **kw), verbose=False,
                      process=False, backend="jax")
    dp = tdyn.Dynspec(dyn=tdyn.BasicDyn(dyn, **kw), verbose=False,
                      process=False, device="cpu")
    return dj, dp


class TestFacade:
    @pytest.mark.parametrize("screen", [
        dict(s=0.7, d=0.157),
        dict(s=0.7, d=0.157, zeta=40.0, vism_zeta=5.0),
        dict(s=0.6, d=0.157, zeta=40.0, vism_ra=3.0, vism_dec=-1.0),
        dict(s=0.6, d=0.157, vism_ra=3.0)])
    def test_scale_dyn_velocity(self, parfile, screen):
        dj, dp = _pair(parfile)
        for d in (dj, dp):
            d.scale_dyn(scale="lambda")
            d.scale_dyn(scale="velocity", parfile=parfile, **screen)
        _close(dp.veff_ra, dj.veff_ra, 1e-12)
        _close(dp.veff_dec, dj.veff_dec, 1e-12)
        _close(dp.vdyn, dj.vdyn, 1e-12, 1e-12)
        _close(dp.vlamdyn, dj.vlamdyn, 1e-12, 1e-12)

    def test_velocity_needs_pars(self, parfile):
        _, dp = _pair(parfile)
        with pytest.raises(ValueError, match="parameters"):
            dp.scale_dyn(scale="velocity")
        with pytest.raises(ValueError, match="screen distance"):
            dp.scale_dyn(scale="velocity", parfile=parfile)
        with pytest.raises(ValueError, match="scale_dyn"):
            dp.correct_dyn(velocity=True)

    def test_spectra_fits_and_corrections(self, parfile):
        """calc_sspec(velocity=, trap=), fit_arc(velocity=True),
        norm_sspec(velocity=True) and correct_dyn(velocity=True) against
        the JAX façade: spectra linearly relative to the peak at the
        float32 tier (the port's FFT runs in float32), η at rel 1e-5 and
        the normalised profile at rel 1e-4 (the façade's arc-fit gates in
        tests/test_torch_dynspec.py)."""
        dj, dp = _pair(parfile)
        for d in (dj, dp):
            d.scale_dyn(scale="lambda,velocity,trap", parfile=parfile, s=0.7,
                        d=0.157)
            d.calc_sspec(velocity=True)
            d.calc_sspec(trap=True)
            d.calc_sspec(lamsteps=True, velocity=True)
        np.testing.assert_allclose(dp.trapdyn, dj.trapdyn, atol=1e-10)
        for name in ("vsspec", "trapsspec", "vlamsspec"):
            a, b = 10 ** (getattr(dp, name) / 10), 10 ** (getattr(dj, name)
                                                          / 10)
            np.testing.assert_allclose(a, b, atol=1e-5 * b.max(),
                                       err_msg=name)
        fp = dp.fit_arc(velocity=True, numsteps=2000)[0]
        fj = dj.fit_arc(velocity=True, numsteps=2000)[0]
        assert fp.eta == pytest.approx(fj.eta, rel=1e-5)
        np_, nj = (d.norm_sspec(velocity=True, lamsteps=False, eta=0.05,
                                numsteps=200) for d in (dp, dj))
        np.testing.assert_array_equal(np_.mask, nj.mask)
        np.testing.assert_allclose(np_.normsspecavg, nj.normsspecavg,
                                   rtol=1e-4)
        for d in (dj, dp):
            d.correct_dyn(velocity=True, svd=False, nsmooth=5)
            d.correct_dyn(velocity=True, lamsteps=True)
        _close(dp.vdyn, dj.vdyn, 1e-10, 1e-12)
        _close(dp.vlamdyn, dj.vlamdyn, 1e-10, 1e-12)

    def test_select_builds_what_it_needs(self, parfile):
        """A trapezoid spectrum asked for before any rescale builds the
        rescale (the façade's ``_select_dyn``)."""
        dj, dp = _pair(parfile)
        sj, tj = dj._select_sspec(trap=True)
        sp, tp = dp._select_sspec(trap=True)
        np.testing.assert_array_equal(tp, tj)
        np.testing.assert_allclose(10 ** (sp / 10), 10 ** (sj / 10),
                                   atol=1e-5 * (10 ** (sj / 10)).max())
        assert hasattr(dp, "trapdyn") and not hasattr(dp, "vdyn")
