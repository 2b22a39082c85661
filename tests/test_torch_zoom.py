"""The zoom and chirp-Z family, the scattered image and the slice as a
whole against the JAX package on the CPU: ``ops/xfft.py``'s band-limited
and off-grid transforms, ``secondary_spectrum_power(zoom=)``,
``ops/scatim.py``, the chirp-Z Fresnel rows of the acf2d model and fit,
``ACF.calc_sspec``, and the façade from a par file to the scattered
image.

Each case gives the same numpy input, made from a seed, to both
packages, at the JAX package's own tolerances (tests/test_xfft.py:
318-560, tests/test_scatim.py:40-62, tests/test_acf2d_batch.py:219-246).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_scint import (N_ITER, _acf2d_epochs,  # noqa: E402
                              _acf2d_params, _hold_fit)
from test_torch_velocity import J0437_PAR, _pair  # noqa: E402

from scintools_tpu.fit import acf2d as jacf2d  # noqa: E402
from scintools_tpu.fit import parameters as jparameters  # noqa: E402
from scintools_tpu.ops import scatim as jscatim  # noqa: E402
from scintools_tpu.ops import sspec as jsspec  # noqa: E402
from scintools_tpu.ops import xfft as jxfft  # noqa: E402
from scintools_tpu.ops.windows import get_window  # noqa: E402
from scintools_tpu.fit import models as jmodels  # noqa: E402
from scintools_tpu.sim import acf_model as jacf  # noqa: E402
from scintools_tpu_torch.fit import acf2d as tacf2d  # noqa: E402
from scintools_tpu_torch.fit import models as tmodels  # noqa: E402
from scintools_tpu_torch.fit import parameters as tparameters  # noqa: E402
from scintools_tpu_torch.ops import scatim as tscatim  # noqa: E402
from scintools_tpu_torch.ops import sspec as tsspec  # noqa: E402
from scintools_tpu_torch.ops import xfft as txfft  # noqa: E402
from scintools_tpu_torch.sim import acf_model as tacf  # noqa: E402

CPU = "cpu"
TParameters = tparameters.Parameters
JParameters = jparameters.Parameters


def _rel_close(a, b, rtol):
    """tests/test_xfft.py's check: rtol, and atol rtol·max|b|."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * np.max(np.abs(b)))


def _t(x):
    return torch.as_tensor(x)


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)


class TestCzt:
    def test_czt_on_grid_matches_jax_and_fft(self, rng):
        for M in (16, 13):
            x = rng.standard_normal((3, M)) + 1j * rng.standard_normal((3, M))
            L = txfft.czt_fft_length(M, M)
            assert L == jxfft.czt_fft_length(M, M)
            got = txfft.czt_1d(_t(x), 2 * np.pi / M, 0.0, L)
            _rel_close(got, jxfft.czt_1d(x, 2 * np.pi / M, 0.0, L), 1e-12)
            _rel_close(got, np.fft.fft(x, axis=-1), 1e-12)

    def test_czt_tensor_rates_broadcast(self, rng):
        """A rate and phase per leading row, as the acf2d rows pass them."""
        x = rng.standard_normal((4, 3, 21)) + 0j
        a, phi = rng.uniform(0.01, 0.2, 4), rng.uniform(-1, 1, 4)
        L = txfft.czt_fft_length(21, 9)
        got = txfft.czt_1d(_t(x), _t(a)[:, None], _t(phi)[:, None], L)
        want = np.stack([jxfft.czt_1d(x[i], a[i], phi[i], L)
                         for i in range(4)])
        _rel_close(got, want, 1e-10)

    @pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10),
                                            (np.float32, 2e-4)])
    @pytest.mark.parametrize("M,n_out", [(16, 8), (13, 11)])
    def test_zoom_dft_vs_jax_and_dense(self, rng, dtype, rtol, M, n_out):
        x = rng.standard_normal((2, 3, M)).astype(dtype)
        for f0, df in [(-2.25, 0.125), (3.7, 0.03), (0.0, 1.0)]:
            ref = jxfft.zoom_dft_1d(x.astype(np.float64), M, f0, df, n_out,
                                    variant="dense")
            for v in ("czt", "dense"):
                got = txfft.zoom_dft_1d(_t(x), M, f0, df, n_out, variant=v)
                assert got.dtype == (torch.complex128 if dtype == np.float64
                                     else torch.complex64)
                _rel_close(got, ref, rtol)

    def test_zoom_on_grid_band_is_fft_subset(self, rng):
        M = 24
        x = rng.standard_normal((M,))
        F = np.fft.fft(x)
        for f0, n_out in [(0, 8), (5, 10), (-4, 9)]:
            got = txfft.zoom_dft_1d(_t(x), M, float(f0), 1.0, n_out).numpy()
            want = F[(f0 + np.arange(n_out)) % M]
            np.testing.assert_allclose(got, want, rtol=1e-10,
                                       atol=1e-10 * np.abs(F).max())

    def test_zoom_power_16x_matches_padded_fft_crop(self, rng):
        nf, nt, z = 12, 10, 16
        x = rng.standard_normal((nf, nt))
        big = np.abs(np.fft.fft2(x, s=(z * 16, z * 16))) ** 2
        n_r, n_c, r0, c0 = 24, 20, 3.0, -2.5
        band = ((r0, r0 + n_r / z, n_r), (c0, c0 + n_c / z, n_c))
        got = txfft.zoom_power_2d(_t(x), (16, 16), *band)
        rows = (int(round(r0 * z)) + np.arange(n_r)) % (z * 16)
        cols = (int(round(c0 * z)) + np.arange(n_c)) % (z * 16)
        _rel_close(got, big[np.ix_(rows, cols)], 1e-9)
        _rel_close(got, jxfft.zoom_power_2d(x, (16, 16), *band), 1e-10)

    def test_zoom_power_batched_tensor_edges(self, rng):
        """Band edges as float32 tensors, a batch of float32 spectra: the
        JAX program's case (tests/test_xfft.py:392-405)."""
        d = rng.standard_normal((2, 12, 10)).astype(np.float32)
        br = torch.tensor([2.0, 5.0], dtype=torch.float32)
        bc = torch.tensor([-3.0, 1.0], dtype=torch.float32)
        for v in ("czt", "dense"):
            got = txfft.zoom_power_2d(_t(d), (16, 16), (br[0], br[1], 6),
                                      (bc[0], bc[1], 8), variant=v)
            want = jxfft.zoom_power_2d(d.astype(np.float64), (16, 16),
                                       (2.0, 5.0, 6), (-3.0, 1.0, 8))
            _rel_close(got, want, 2e-4)


class TestOffgrid:
    def test_bound_and_order(self, rng):
        M = 48
        x = rng.standard_normal((M,))
        pts = np.sort(rng.uniform(0, M, 64))
        exact = jxfft.offgrid_dft_1d(x, pts, M, variant="dense")
        scale = np.sum(np.abs(x))
        last = np.inf
        for order in (4, 6, 8):
            assert (txfft.offgrid_taylor_bound(order, 4)
                    == jxfft.offgrid_taylor_bound(order, 4))
            got = txfft.offgrid_taylor(_t(x), _t(pts), M, order=order,
                                       oversample=4).numpy()
            _rel_close(got, jxfft.offgrid_taylor(x, pts, M, order=order,
                                                 oversample=4), 1e-10)
            err = np.max(np.abs(got - exact))
            assert err <= txfft.offgrid_taylor_bound(order, 4) * scale
            assert err < last
            last = err

    @pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-5),
                                            (np.float32, 2e-4)])
    def test_taylor_and_dense_vs_jax(self, rng, dtype, rtol):
        M = 33
        x = rng.standard_normal((2, 3, M)).astype(dtype)
        pts = rng.uniform(-M / 2, M / 2, 17)
        want = jxfft.offgrid_dft_1d(x.astype(np.float64), pts, M,
                                    variant="dense")
        _rel_close(txfft.offgrid_dft_1d(_t(x), _t(pts), M), want, rtol)
        dense = txfft.offgrid_dft_1d(_t(x), _t(pts), M, variant="dense")
        _rel_close(dense, want, 1e-10 if dtype == np.float64 else 2e-4)


class TestRealSpectrum:
    def test_profile_spectrum(self, rng):
        L = 17
        prof = rng.standard_normal((2 * L - 1,))
        want = np.real(np.fft.fft(prof))[:L]
        for x in (prof, _t(prof)):
            for v in ("real", "dense"):
                got = txfft.real_spectrum_1d(x, L, variant=v)
                _rel_close(got, jxfft.real_spectrum_1d(prof, L, variant=v),
                           1e-10)
                _rel_close(got, want, 1e-10)

    def test_sspec_1d_models(self, rng):
        """The secondary-spectrum 1-D models over real_spectrum_1d, on
        numpy and on tensors."""
        p = {"amp": 1.3, "tau": 40.0, "alpha": 5 / 3, "dnu": 0.6}
        xt, xf = np.linspace(0, 300, 25), np.linspace(0, 4, 19)
        yt, yf = rng.random(25), rng.random(19)
        for name in ("tau_sspec_model", "dnu_sspec_model"):
            x, y = (xt, yt) if name.startswith("tau") else (xf, yf)
            ref = getattr(jmodels, name)(p, x, y, backend="numpy")
            _rel_close(getattr(tmodels, name)(p, x, y), ref, 1e-12)
            _rel_close(getattr(tmodels, name)(p, _t(x), _t(y)), ref, 1e-12)
        ref = jmodels.scint_sspec_model(p, (xt, xf), (yt, yf),
                                        backend="numpy")
        _rel_close(tmodels.scint_sspec_model(p, (xt, xf), (yt, yf)), ref,
                   1e-12)


class TestSspecZoom:
    @pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-9),
                                            (np.float32, 2e-4)])
    def test_on_grid_band_matches_half_frame(self, rng, dtype, rtol):
        nf, nt = 12, 10
        nrfft, ncfft = tsspec.fft_shapes(nf, nt)
        d = rng.standard_normal((nf, nt))
        wins = get_window(nt, nf, window="hanning", frac=0.1)
        want = np.asarray(jsspec.secondary_spectrum_power(
            d, window_arrays=wins, backend="numpy", variant="half"))
        band = ((0.0, nrfft / 2, nrfft // 2), (-ncfft / 2, ncfft / 2, ncfft))
        got = tsspec.secondary_spectrum_power(_t(d.astype(dtype)),
                                              window_arrays=wins, zoom=band)
        _rel_close(got, want, rtol)
        ref = jsspec.secondary_spectrum_power(d, window_arrays=wins,
                                              backend="numpy", zoom=band)
        _rel_close(got, ref, rtol)
        dense = tsspec.secondary_spectrum_power(
            _t(d), window_arrays=wins, zoom=band, variant="dense")
        _rel_close(dense, want, 1e-9)

    def test_zoom_band_and_dense_zoom(self, rng):
        nf, nt, dt, df = 24, 20, 8.0, 0.25
        band = tsspec.zoom_band(nf, nt, dt, df, (0.1, 0.9), (-20.0, 25.0),
                                16, 24)
        assert band == jsspec.zoom_band(nf, nt, dt, df, (0.1, 0.9),
                                        (-20.0, 25.0), 16, 24)
        d = rng.standard_normal((nf, nt))
        ref = jsspec.secondary_spectrum_power(d, backend="numpy", zoom=band,
                                              variant="dense")
        for v in ("czt", "dense"):
            _rel_close(tsspec.secondary_spectrum_power(_t(d), zoom=band,
                                                       variant=v), ref, 1e-10)

    def test_zoom_refuses_prewhite(self, rng):
        with pytest.raises(RuntimeError):
            tsspec.secondary_spectrum_power(
                _t(rng.standard_normal((12, 10))), prewhite=True,
                zoom=((0.0, 4.0, 4), (0.0, 4.0, 4)))


@pytest.fixture()
def smooth_grid():
    """tests/test_scatim.py's grid."""
    rng = np.random.default_rng(9)
    tdel = np.linspace(0.0, 10.0, 48)
    fdop = np.linspace(-20.0, 20.0, 64)
    T, F = np.meshgrid(tdel, fdop, indexing="ij")
    lin = (np.exp(-0.5 * (T - 4) ** 2 - 0.02 * F ** 2)
           + 0.05 * np.sin(F / 3) + 0.01 * rng.standard_normal(T.shape))
    return lin, tdel, fdop


class TestScatim:
    @pytest.mark.parametrize("seed", [31, 57, 83])
    def test_both_formulations_vs_jax(self, seed):
        """Random grids, partly out-of-grid queries: ``"gather"`` against
        the JAX numpy stencil at atol 1e-12, ``"matmul"`` against
        ``"gather"`` at rtol 2e-4 / atol 2e-5."""
        rng = np.random.default_rng(seed)
        nr, nc = int(rng.integers(17, 200)), int(rng.integers(17, 200))
        tdel = np.linspace(0.0, float(rng.uniform(5, 40)), nr)
        fdop = np.linspace(-float(rng.uniform(10, 50)),
                           float(rng.uniform(10, 50)), nc)
        lin = rng.standard_normal((nr, nc))
        ny, nx = int(rng.integers(3, 40)), int(rng.integers(3, 40))
        tq = rng.uniform(tdel[0] - 2, tdel[-1] + 2, (ny, nx))
        fq = rng.uniform(fdop[0] - 2, fdop[-1] + 2, (ny, nx))
        ref = jscatim.scattered_image_interp(lin, tdel, fdop, tq, fq,
                                             backend="numpy")
        g = tscatim.scattered_image_interp(lin, tdel, fdop, tq, fq,
                                           method="gather", device=CPU)
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-12)
        m = tscatim.scattered_image_interp(lin, tdel, fdop, tq, fq,
                                           method="matmul", device=CPU)
        np.testing.assert_allclose(m.numpy(), g.numpy(), rtol=2e-4,
                                   atol=2e-5)

    def test_matmul_row_slabs(self, smooth_grid, monkeypatch):
        """The matmul form's row blocks do not change its values."""
        lin, _, _ = smooth_grid
        rng = np.random.default_rng(2)
        tp = rng.uniform(0, 47, (9, 11))
        fp = rng.uniform(0, 63, (9, 11))
        whole = tscatim.cubic_interp2d(lin, tp, fp, method="matmul",
                                       device=CPU)
        monkeypatch.setattr(tscatim, "_SLAB_ELEMS", 1)
        rows = tscatim.cubic_interp2d(lin, tp, fp, method="matmul",
                                      device=CPU)
        np.testing.assert_array_equal(rows.numpy(), whole.numpy())
        ref = jscatim.cubic_interp2d(lin, tp, fp, backend="numpy")
        np.testing.assert_allclose(rows.numpy(), ref, atol=1e-12)

    def test_nodes_spline_and_clamp(self, smooth_grid):
        from scipy.interpolate import RectBivariateSpline

        lin, tdel, fdop = smooth_grid
        T, F = np.meshgrid(tdel[5:12], fdop[8:20], indexing="ij")
        got = tscatim.scattered_image_interp(lin, tdel, fdop, T, F,
                                             device=CPU)
        np.testing.assert_allclose(got.numpy(), lin[5:12, 8:20], atol=1e-12)
        tdel2 = np.linspace(0.0, 10.0, 64)
        fdop2 = np.linspace(-20.0, 20.0, 96)
        T, F = np.meshgrid(tdel2, fdop2, indexing="ij")
        smooth = np.exp(-0.5 * (T - 4) ** 2 - 0.02 * F ** 2)
        rng = np.random.default_rng(5)
        tq, fq = rng.uniform(1, 9, (25, 25)), rng.uniform(-15, 15, (25, 25))
        ours = tscatim.scattered_image_interp(smooth, tdel2, fdop2, tq, fq,
                                              device=CPU).numpy()
        ref = RectBivariateSpline(tdel2, fdop2, smooth).ev(tq, fq)
        np.testing.assert_allclose(ours, ref, atol=2e-3 * smooth.max())
        out = tscatim.scattered_image_interp(
            lin, tdel, fdop, np.array([[tdel[-1] + 5.0]]),
            np.array([[fdop[0] - 5.0]]), device=CPU)
        assert out.item() == pytest.approx(lin[-1, 0], abs=1e-9)
        bad = tdel.copy()
        bad[3] += 0.05
        assert not tscatim.is_uniform(bad)
        with pytest.raises(ValueError, match="non-uniform"):
            tscatim.scattered_image_interp(lin, bad, fdop, np.zeros((2, 2)),
                                           np.zeros((2, 2)), device=CPU)
        with pytest.raises(ValueError, match="method"):
            tscatim.cubic_interp2d(lin, tq, fq, method="bogus", device=CPU)


class TestCztAcf2d:
    @pytest.fixture(scope="class")
    def grid(self):
        n, nsn = 41, 17
        snp = np.linspace(-12.0, 12.0, n)
        SX, SY = np.meshgrid(snp, snp)
        gammes = np.exp(-0.5 * ((SX / np.sqrt(2)) ** 2
                                + (SY * np.sqrt(2)) ** 2) ** (5 / 6))
        snx = np.cos(0.5) * np.linspace(-4.0, 4.0, nsn)
        sny = np.sin(0.5) * np.linspace(-4.0, 4.0, nsn)
        return gammes, snp, snx, sny

    def test_czt_row_vs_jax_and_gemm(self, grid):
        """tests/test_acf2d_batch.py:219-238 at rtol 1e-8."""
        gammes, snp, snx, sny = grid
        f64 = dict(dtype=torch.float64)
        for dnun in (0.7, 2.3):
            ref = jacf._fresnel_row(gammes, snp, snx, sny, dnun,
                                    snp[1] - snp[0], np)
            jc = jacf._fresnel_row_czt(gammes, snp, snx, sny, dnun,
                                       snp[1] - snp[0], np)
            got = tacf._fresnel_row_czt(
                torch.tensor(gammes, **f64), torch.tensor(snp, **f64),
                torch.tensor(snx, **f64), torch.tensor(sny, **f64),
                torch.tensor(dnun, **f64), snp[1] - snp[0])[0].numpy()
            for want in (jc, ref):
                np.testing.assert_allclose(got, want, rtol=1e-8,
                                           atol=1e-10 * np.max(np.abs(ref)))

    @pytest.mark.parametrize("alpha_varies", [False, True])
    def test_czt_model_and_derivative_vs_gemm(self, alpha_varies):
        """The czt model core and its written-out forward-mode
        derivative against the GEMM rows (float64) and against
        ``torch.func.jacfwd`` of the czt model itself."""
        kw = dict(precision="highest", alpha_varies=alpha_varies,
                  device=CPU)
        mg = tacf.make_acf2d_model_core(17, 15, 2.0, 5 / 3, 0.0, 100.0, 10.0,
                                        fresnel_method="gemm", **kw)
        mc = tacf.make_acf2d_model_core(17, 15, 2.0, 5 / 3, 0.0, 100.0, 10.0,
                                        fresnel_method="czt", **kw)
        args = (110.0, 3.0, 1.0, 0.1, 30.0, 0.01, 10.0, 0.5)
        tang = torch.eye(7, dtype=torch.float64)[[0, 1, 2, 3, 4, 5, 6]]
        g, g_t = mg.jvp(*args, tangents=tang)
        c, c_t = mc.jvp(*args, tangents=tang)
        np.testing.assert_allclose(c.numpy(), g.numpy(), rtol=1e-8,
                                   atol=1e-10 * g.abs().max().item())
        np.testing.assert_allclose(c_t.numpy(), g_t.numpy(), rtol=1e-8,
                                   atol=1e-10 * g_t.abs().max().item())
        x = torch.tensor([110.0, 3.0, 1.0, 0.1, 30.0, 0.01, 5 / 3],
                         dtype=torch.float64)

        def f(v):
            return mc(v[0], v[1], v[2], v[3], v[4], v[5], 10.0, 0.5,
                      alpha=v[6] if alpha_varies else 5 / 3)

        J = torch.func.jacfwd(f)(x).movedim(-1, 0)
        keep = slice(None) if alpha_varies else slice(0, 6)
        np.testing.assert_allclose(c_t[keep].numpy(), J[keep].numpy(),
                                   rtol=1e-10,
                                   atol=1e-12 * J.abs().max().item())

    def test_czt_model_vs_jax(self):
        """The czt model core against the JAX package's, both policies."""
        for prec, rtol in (("highest", 1e-8), ("default", 2e-4)):
            jm = jacf.make_acf2d_model_core(17, 15, 2.0, 5 / 3, 0.0, 100.0,
                                            10.0, precision=prec,
                                            fresnel_method="czt")
            tm = tacf.make_acf2d_model_core(17, 15, 2.0, 5 / 3, 0.0, 100.0,
                                            10.0, precision=prec,
                                            fresnel_method="czt", device=CPU)
            args = (110.0, 3.0, 1.0, 0.1, 30.0, 0.01, 10.0, 0.5)
            _rel_close(tm(*args), np.asarray(jm(*args)), rtol)

    @pytest.mark.parametrize("precision, rel", [("highest", 1e-6),
                                                ("default", 1e-4)])
    def test_czt_fit_vs_jax(self, precision, rel):
        """``fresnel_method="czt"`` through ``fit_acf2d_batch`` against
        the JAX package's czt fit, at the port's acf2d tiers
        (tests/test_torch_scint.py)."""
        ys = _acf2d_epochs(2, seed=60)
        kw = dict(precision=precision, fresnel_method="czt")
        rj, okj = jacf2d.fit_acf2d_batch(
            _acf2d_params(JParameters, tau=900.0, dnu=5.0), ys, None,
            n_iter=N_ITER, **kw)
        rt, okt = tacf2d.fit_acf2d_batch(
            _acf2d_params(TParameters, tau=900.0, dnu=5.0), ys, None,
            n_iter=N_ITER, device=CPU, **kw)
        assert list(okt) == list(okj) == [0, 0]
        for a, b in zip(rt, rj):
            _hold_fit(a, b, rel)
        one = tacf2d.fit_acf2d(_acf2d_params(TParameters, tau=900.0,
                                             dnu=5.0), ys[0], None,
                               n_iter=N_ITER, device=CPU, **kw)
        assert one.params["tau"].value == pytest.approx(
            rt[0].params["tau"].value, rel=rel)


class TestAcfSspec:
    @pytest.mark.parametrize("kw", [
        dict(psi=30.0, phasegrad=0.1, theta=0.5, ar=1.5, taumax=2.0,
             dnumax=2.0, nt=16, nf=14),
        dict(ar=2.0, nt=21, nf=17)])
    def test_calc_sspec(self, kw):
        t = tacf.ACF(device=CPU, **kw)
        j = jacf.ACF(**kw)
        got = t.calc_sspec()
        assert got is t.sspec
        _rel_close(got, j.calc_sspec(), 1e-8)
        _rel_close(t.calc_sspec(window="hamming", window_frac=0.5),
                   j.calc_sspec(window="hamming", window_frac=0.5), 1e-8)


class TestSlice:
    def test_par_file_to_scattered_image(self, tmp_path):
        """The slice end to end on both façades: ``scale_dyn`` (velocity,
        from a par file) → ``calc_sspec(velocity=True)`` →
        ``fit_arc(velocity=True)`` → ``calc_scattered_image()``, then
        images at a given η, of the trapezoid spectrum, and on a
        non-uniform delay axis (the host spline in both)."""
        path = tmp_path / "J0437.par"
        path.write_text(J0437_PAR)
        dj, dp = _pair(str(path))
        for d in (dj, dp):
            d.scale_dyn(scale="velocity", parfile=str(path), s=0.7, d=0.157)
            d.calc_sspec(velocity=True)
        a, b = 10 ** (dp.vsspec / 10), 10 ** (dj.vsspec / 10)
        np.testing.assert_allclose(a, b, atol=1e-5 * b.max())
        fp = dp.fit_arc(velocity=True, numsteps=2000)[0]
        fj = dj.fit_arc(velocity=True, numsteps=2000)[0]
        assert fp.eta == pytest.approx(fj.eta, rel=1e-5)
        # the image is the interpolated power times f_D, so the spectra's
        # float32 tier (1e-5 of the peak power) carries over scaled by
        # max f_D. ``clean`` refills bins below 1e-22: the float64 spectrum
        # has one (1.5e-26, next to DC after the mean subtraction), where
        # float32 rounding leaves ~1e-9, so the default images are held on
        # the same spectrum (then to 1e-12), and the façades' own spectra
        # without ``clean``
        tier = 1e-5 * b.max() * np.abs(dj.fdop).max()
        imp = dp.calc_scattered_image(sampling=24)
        assert imp.shape == (49, 49) and np.isfinite(imp).all()
        np.testing.assert_array_equal(imp, imp[::-1])
        imj = dj.calc_scattered_image(sampling=24)
        np.testing.assert_array_equal(dp.scattered_image_ax,
                                      dj.scattered_image_ax)
        np.testing.assert_allclose(dp.calc_scattered_image(sampling=24,
                                                           clean=False),
                                   dj.calc_scattered_image(sampling=24,
                                                           clean=False),
                                   rtol=0, atol=tier)
        same = dict(input_sspec=dj.vsspec, input_fdop=dj.fdop,
                    input_tdel=dj.tdel, input_eta=dj.eta, sampling=24)
        np.testing.assert_allclose(dp.calc_scattered_image(**same),
                                   dj.calc_scattered_image(**same),
                                   rtol=1e-12, atol=1e-12 * np.abs(imj).max())
        for kw in (dict(input_eta=0.05, sampling=16, clean=False),
                   dict(fit_arc=False, sampling=16, clean=False),
                   dict(trap=True, input_eta=0.05, sampling=16,
                        clean=False),
                   dict(input_sspec=dj.vsspec, input_fdop=dj.fdop,
                        input_tdel=dj.tdel * (1 + 0.01 * dj.tdel
                                              / dj.tdel.max()),
                        input_eta=0.05, sampling=16)):
            gp, gj = dp.calc_scattered_image(**kw), \
                dj.calc_scattered_image(**kw)
            np.testing.assert_allclose(gp, gj, rtol=0, atol=tier,
                                       err_msg=str(kw))
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.close("all")
        dp.calc_scattered_image(plot=True)
        assert len(plt.get_fignums()) == 1
        plt.close("all")
