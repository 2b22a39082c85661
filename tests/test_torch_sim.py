"""The port's simulator (scintools_tpu_torch/sim/simulation.py and
brightness.py), its FITS reader and writer (io/fitsio.py), the column
projection of ops/xfft.py and the façade's SimDyn and HoloDyn, against
the JAX package on the CPU.

The JAX side runs under tier-1's x64. Its default numpy backend draws
the screen from numpy's legacy generator, which the port draws from an
explicit ``RandomState`` of the same seed, so a seeded ``Simulation`` is
compared value by value: the screen, the field, the dynspec, the pulse
and the dispersion column at rel 1e-10 (float64 on both sides; only FFT
rounding differs), the curvature oracles exactly. The port's
``propagate`` on the JAX backend's own screen is held to that object's
field at 1e-8. ``Brightness`` against the JAX numpy backend at rtol
1e-8 with NaN where NaN (tests/test_sim.py's tolerance). The column
projection within 1e-12 of the dense transform (complex128) and of the
JAX function. FITS bytes are compared exactly.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scintools_tpu import dynspec as jdyn
from scintools_tpu.io import fitsio as jfits
from scintools_tpu.ops import xfft as jxfft
from scintools_tpu.sim import brightness as jbright
from scintools_tpu.sim import simulation as jsim
from scintools_tpu_torch import dynspec as tdyn
from scintools_tpu_torch.io import fitsio as tfits
from scintools_tpu_torch.io.psrflux import MalformedInputError
from scintools_tpu_torch.ops import xfft as txfft
from scintools_tpu_torch.sim import brightness as tbright
from scintools_tpu_torch.sim import simulation as tsim

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # one intra-op thread: the suite runs in parallel workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


class TestColumnProjection:
    def _inputs(self, seed=3, G=3, nx=16, ny=12, col=5):
        rng = np.random.default_rng(seed)
        E = rng.normal(size=(G, nx, ny)) + 1j * rng.normal(size=(G, nx, ny))
        fx = np.exp(-1j * rng.uniform(0, 3, nx))
        fy = np.exp(-1j * rng.uniform(0, 3, ny))
        return E, fx, fy, col

    def test_matches_dense_transform(self):
        E, fx, fy, col = self._inputs()
        gph = txfft.column_phase(E.shape[-1], col)
        got = txfft.separable_filter_column(
            torch.as_tensor(E), torch.as_tensor(fx), torch.as_tensor(fy),
            torch.as_tensor(gph)).numpy()
        dense = np.fft.ifft2(np.fft.fft2(E) * np.outer(fx, fy))[..., col]
        assert rel(got, dense) < 1e-12

    def test_matches_jax(self):
        E, fx, fy, col = self._inputs(seed=4)
        gph = jxfft.column_phase(E.shape[-1], col)
        np.testing.assert_array_equal(txfft.column_phase(E.shape[-1], col),
                                      gph)
        want = np.asarray(jxfft.separable_filter_column(
            jnp.asarray(E), jnp.asarray(fx), jnp.asarray(fy),
            jnp.asarray(gph), xp=jnp))
        got = txfft.separable_filter_column(
            torch.as_tensor(E), torch.as_tensor(fx), torch.as_tensor(fy),
            torch.as_tensor(gph)).numpy()
        assert rel(got, want) < 1e-12


SIM_CASES = {
    "default": dict(ns=64, nf=16, seed=7),
    "lamsteps": dict(ns=64, nf=16, seed=8, lamsteps=True),
    "efield_nsub": dict(ns=64, nf=16, seed=9, efield=True, nsub=40,
                        mb2=8, ar=1.5, psi=30),
    "rect": dict(nx=48, ny=32, nf=12, seed=10, dx=0.02, dlam=0.1),
}


class TestSimulation:
    @pytest.fixture(scope="class", params=sorted(SIM_CASES))
    def pair(self, request):
        kw = SIM_CASES[request.param]
        return (jsim.Simulation(**kw),
                tsim.Simulation(device=CPU, **kw))

    @pytest.mark.parametrize("name", ["xyp", "spe", "spi", "dyn",
                                      "pulsewin", "dm"])
    def test_arrays_match_numpy_backend(self, pair, name):
        j, t = pair
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        assert a.shape == b.shape
        assert rel(a, b) < 1e-10

    def test_packaging_matches(self, pair):
        j, t = pair
        assert t.eta == j.eta and t.betaeta == j.betaeta
        assert t.seed_used == j.seed_used
        for k in ("name", "header", "nsub", "nchan", "dt", "df", "bw",
                  "tobs", "mjd", "freq", "s0", "consp", "ffconx"):
            assert getattr(t, k) == getattr(j, k), k
        for k in ("freqs", "times", "lams", "x", "w"):
            np.testing.assert_array_equal(getattr(t, k), getattr(j, k))

    def test_xyi_and_filters(self, pair):
        j, t = pair
        assert rel(t.xyi, j.xyi) < 1e-10
        np.testing.assert_array_equal(t.frequency_scales(),
                                      j.frequency_scales())
        xye = np.ones((t.nx, t.ny), dtype=complex)
        np.testing.assert_array_equal(t.frfilt3(xye.copy(), 0.9),
                                      j.frfilt3(xye.copy(), 0.9))

    def test_propagate_on_jax_backend_screen(self):
        j = jsim.Simulation(ns=64, nf=16, seed=5, backend="jax")
        q2 = tsim.fresnel_filter_q2(j.nx, j.ny, j.ffconx, j.ffcony)
        spe = tsim.propagate(j.xyp, q2, j.frequency_scales(), j.ny // 2,
                             device=CPU)
        assert spe.dtype == torch.complex128
        assert rel(spe.numpy(), j.spe) < 1e-8

    def test_propagate_groups_the_frequency_axis(self, monkeypatch):
        j = jsim.Simulation(ns=32, nf=10, seed=6)
        q2 = tsim.fresnel_filter_q2(j.nx, j.ny, j.ffconx, j.ffcony)
        args = (j.xyp, q2, j.frequency_scales(), j.ny // 2)
        whole = tsim.propagate(*args, device=CPU).numpy()
        monkeypatch.setattr(tsim, "PROP_GROUP_ELEMENTS", 3 * 32 * 32)
        np.testing.assert_array_equal(
            tsim.propagate(*args, device=CPU).numpy(), whole)

    def test_host_helpers_are_the_reference(self):
        args = (16, 24, 0.01, 0.02, 30, 1.5, 5 / 3, 1e-3, 0.7)
        np.testing.assert_array_equal(tsim.screen_weights(*args),
                                      jsim.screen_weights(*args))
        np.testing.assert_array_equal(
            tsim.fresnel_filter_q2(8, 6, 0.3, 0.7),
            jsim.fresnel_filter_q2(8, 6, 0.3, 0.7))

    def test_seed_contract(self):
        a = tsim.Simulation(ns=32, nf=4, device=CPU)
        b = tsim.Simulation(ns=32, nf=4, seed=-1, device=CPU)
        assert a.seed_used != b.seed_used
        assert not np.array_equal(a.xyp, b.xyp)
        c = tsim.Simulation(ns=32, nf=4, seed=a.seed_used, device=CPU)
        np.testing.assert_array_equal(c.xyp, a.xyp)
        # the draw leaves numpy's global generator alone
        np.random.seed(123)
        x = np.random.rand()
        np.random.seed(123)
        tsim.Simulation(ns=16, nf=2, seed=4, device=CPU)
        assert np.random.rand() == x

    def test_rejected_options(self):
        with pytest.raises(NotImplementedError):
            tsim.Simulation(ns=16, nf=2, seed=1, plot=True, device=CPU)
        with pytest.raises(NotImplementedError):
            tsim.Simulation(ns=16, nf=2, seed=1, backend="numpy",
                            device=CPU)
        sim = tsim.Simulation(ns=16, nf=2, seed=1, device=CPU)
        for name in ("plot_screen", "plot_intensity", "plot_dynspec",
                     "plot_efield", "plot_delay", "plot_pulse",
                     "plot_all"):
            with pytest.raises(NotImplementedError):
                getattr(sim, name)()

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: device=None is valid here")
        with pytest.raises(RuntimeError):
            tsim.Simulation(ns=16, nf=2, seed=1)
        with pytest.raises(RuntimeError):
            tbright.Brightness(nf=2, nt=4, nx=4, df=0.5, dt=1, dx=0.5)


BRIGHT_CASES = {
    "small": dict(nf=4, nt=16, nx=8, df=0.1, dt=0.4, dx=0.2),
    "aniso_offset": dict(ar=2.0, psi=30, alpha=1.67, thetagx=0.3,
                         thetagy=-0.2, thetarx=0.1, thetary=0.05, nf=4,
                         nt=12, nx=6, df=0.1, dt=0.3, dx=0.25),
    # delays past the grid's reach: θy = √τ leaves the brightness grid
    "beyond_grid": dict(nf=4, nt=60, nx=5, df=0.2, dt=0.5, dx=0.25),
}


class TestBrightness:
    @pytest.fixture(scope="class", params=sorted(BRIGHT_CASES))
    def pair(self, request):
        kw = BRIGHT_CASES[request.param]
        return (jbright.Brightness(backend="numpy", **kw),
                tbright.Brightness(device=CPU, **kw))

    @pytest.mark.parametrize("name", ["B", "acf_efield", "thetax",
                                      "thetay", "jacobian", "SS", "LSS",
                                      "acf"])
    def test_matches_numpy_backend(self, pair, name):
        j, t = pair
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        assert a.shape == b.shape
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   rtol=1e-8, atol=1e-10)

    def test_out_of_grid_queries_are_nan(self):
        t = tbright.Brightness(device=CPU, **BRIGHT_CASES["beyond_grid"])
        assert np.isnan(t.SS).any() and np.isfinite(t.SS).any()

    def test_sspec_and_acf_optional(self):
        t = tbright.Brightness(nf=2, nt=4, nx=4, df=0.5, dt=1, dx=0.5,
                               calc_sspec=False, calc_acf=False,
                               device=CPU)
        assert not hasattr(t, "SS") and not hasattr(t, "acf")
        with pytest.raises(NotImplementedError):
            t.plot_sspec()


class TestFits:
    def test_bytes_and_round_trip_both_ways(self, tmp_path):
        data = np.random.default_rng(5).normal(size=(17, 23))
        pj, pt = str(tmp_path / "j.fits"), str(tmp_path / "t.fits")
        jfits.write_fits_image(pj, data)
        tfits.write_fits_image(pt, data)
        with open(pj, "rb") as a, open(pt, "rb") as b:
            assert a.read() == b.read()
        np.testing.assert_array_equal(tfits.read_fits_image(pj), data)
        np.testing.assert_array_equal(jfits.read_fits_image(pt), data)

    def test_save_fits_orientation(self, tmp_path):
        class FakeDyn:
            dyn = np.arange(12.0).reshape(3, 4)

        pj, pt = str(tmp_path / "j.fits"), str(tmp_path / "t.fits")
        jfits.save_fits(pj, FakeDyn())
        tfits.save_fits(pt, FakeDyn())
        with open(pj, "rb") as a, open(pt, "rb") as b:
            assert a.read() == b.read()

    @pytest.mark.parametrize("bitpix,dtype", [(16, ">i2"), (-32, ">f4")])
    def test_other_bitpix_with_scaling(self, tmp_path, bitpix, dtype):
        data = np.arange(6, dtype=dtype).reshape(2, 3)
        cards = [tfits._card("SIMPLE", True), tfits._card("BITPIX", bitpix),
                 tfits._card("NAXIS", 2), tfits._card("NAXIS1", 3),
                 tfits._card("NAXIS2", 2), tfits._card("BSCALE", 0.5),
                 tfits._card("BZERO", 1.0), "END".ljust(80)]
        head = "".join(cards).ljust(2880).encode("ascii")
        path = str(tmp_path / "s.fits")
        with open(path, "wb") as fh:
            fh.write(head + data.tobytes())
        np.testing.assert_array_equal(tfits.read_fits_image(path),
                                      jfits.read_fits_image(path))

    def test_truncated_file_is_malformed_in_survey_mode(self, tmp_path):
        path = str(tmp_path / "bad.fits")
        with open(path, "wb") as fh:
            fh.write(b"SIMPLE  =                    T" + b" " * 50)
        with pytest.raises(ValueError):
            tfits.read_fits_image(path)
        with pytest.raises(MalformedInputError):
            tfits.read_fits_image(path, survey=True)


class TestAdapters:
    FIELDS = ("name", "header", "nchan", "nsub", "bw", "df", "freq", "dt",
              "tobs", "mjd")

    def _same(self, dj, dt_):
        for k in self.FIELDS:
            assert getattr(dt_, k) == getattr(dj, k), k
        for k in ("dyn", "freqs", "times"):
            np.testing.assert_array_equal(getattr(dt_, k), getattr(dj, k))

    def test_simdyn_facade(self):
        kw = dict(ns=48, nf=24, seed=12, dt=8, freq=1100, dlam=0.05)
        sj, st = jsim.Simulation(**kw), tsim.Simulation(device=CPU, **kw)
        aj, at = jdyn.SimDyn(sj), tdyn.SimDyn(st)
        assert at.name == aj.name
        assert rel(at.dyn, aj.dyn) < 1e-10
        dj = jdyn.Dynspec(dyn=aj, verbose=False, process=False)
        dt_ = tdyn.Dynspec(dyn=tdyn.SimDyn(sj), verbose=False,
                           process=False, device=CPU)
        self._same(dj, dt_)

    def test_simulation_loads_directly(self):
        kw = dict(ns=32, nf=16, seed=13, lamsteps=True)
        sj = jsim.Simulation(**kw)
        dj = jdyn.Dynspec(dyn=sj, verbose=False, process=False)
        dt_ = tdyn.Dynspec(dyn=tsim.Simulation(device=CPU, **kw),
                           verbose=False, process=False, device=CPU)
        for k in self.FIELDS:
            assert getattr(dt_, k) == getattr(dj, k), k
        assert rel(dt_.dyn, dj.dyn) < 1e-10

    def test_holodyn_facade(self, tmp_path):
        rng = np.random.default_rng(8)
        re_, im_ = rng.normal(size=(2, 20, 30))
        pr, pi = str(tmp_path / "re.fits"), str(tmp_path / "im.fits")
        jfits.write_fits_image(pr, re_)
        jfits.write_fits_image(pi, im_)
        for args in ((pr,), (pr, pi)):
            kw = dict(df=0.5, dt=4, fmin=1300, mjd=58000)
            aj, at = jdyn.HoloDyn(*args, **kw), tdyn.HoloDyn(*args, **kw)
            self._same(aj, at)
            dj = jdyn.Dynspec(dyn=aj, verbose=False, process=False)
            dt_ = tdyn.Dynspec(dyn=at, verbose=False, process=False,
                               device=CPU)
            self._same(dj, dt_)
            assert os.path.basename(pr) == at.name
