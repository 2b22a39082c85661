"""Loading and processing psrflux files with the port
(scintools_tpu_torch/io/psrflux.py, ops/acf.py, ops/inpaint.py,
ops/interp.py, utils/misc.py and the ``Dynspec`` façade's processing
methods) against the JAX package on the CPU.

One known-curvature arc spectrum carries the faults a telescope file
has: a short leading subint, zeroed channels at both band edges, zeroed
RFI channels inside the band, 1% NaN pixels and a few 50σ spikes. Both
packages read the same file. The steps that are host numpy in both
packages (parsing, trimming, the biharmonic and ``griddata`` refills,
the SVD flux model) hold at rtol 1e-12; the median refill sorts on the
device in float64 and holds exactly; the FFT steps run in float32 on the
port and float64 in the JAX package under tier-1 x64, and hold within
1e-5 of the peak, the tolerance of the port's spectra.
"""

import os

import numpy as np
import pytest
import torch

from scintools_tpu import dynspec as jdyn
from scintools_tpu.io import psrflux as jio
from scintools_tpu.ops import acf as jacf
from scintools_tpu.ops import inpaint as jinpaint
from scintools_tpu_torch import dynspec as tdyn
from scintools_tpu_torch import workloads as tw
from scintools_tpu_torch.io import psrflux as tio
from scintools_tpu_torch.ops import acf as tacf
from scintools_tpu_torch.ops import inpaint as tinpaint
from scintools_tpu_torch.ops import xfft as txfft
from scintools_tpu_torch.utils import misc as tmisc

NCHAN, NSUB = 72, 80            # the file's shape before trimming
EDGE, RFI = (4, 3), (30, 31)    # zeroed edge channels (low, high), RFI
SPIKES = ((40, 20), (50, 60), (25, 45))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def faulty_spectrum(seed=5, descending=False):
    """``(dyn[NCHAN, NSUB + 1], times, freqs)`` of an arc spectrum with
    the faults of the module docstring; subint 0 is 1 s long, the rest
    2 s."""
    rng = np.random.default_rng(seed)
    dyn = tw.make_arc_dynspec(NSUB, NCHAN, 2.0, 0.05, 1400.0, 5e-4, 24,
                              seed=seed)
    dyn = np.concatenate([0.5 * dyn[:, :1], dyn], axis=1)
    times = np.concatenate([[0.0], 1.0 + 2.0 * np.arange(NSUB)])
    freqs = 1400.0 + 0.05 * np.arange(NCHAN)
    dyn[:EDGE[0]] = 0
    dyn[NCHAN - EDGE[1]:] = 0
    dyn[list(RFI)] = 0
    nan = rng.random(dyn.shape) < 0.01
    dyn[nan] = np.nan
    sd = np.nanstd(dyn)
    for f, t in SPIKES:
        dyn[f, t] = np.nanmedian(dyn) + 50 * sd
    if descending:
        return dyn[::-1].copy(), times, freqs[::-1].copy()
    return dyn, times, freqs


def _write_jax(path, dyn, times, freqs, mjd=60000.0, header=(), note=None):
    raw = jio.RawDynSpec(dyn=dyn, times=times, freqs=freqs, mjd=mjd,
                         name=os.path.basename(path), header=list(header))
    jio.write_psrflux(raw, str(path), note=note)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("psrflux")
    dyn, times, freqs = faulty_spectrum()
    out = {"asc": _write_jax(d / "obs.dynspec", dyn, times, freqs,
                             header=["MJD0: 60000.0", "telescope test"])}
    ddyn, _, dfreqs = faulty_spectrum(descending=True)
    out["desc"] = _write_jax(d / "desc.dynspec", ddyn, times, dfreqs)
    later = faulty_spectrum(seed=6)[0]
    out["later"] = _write_jax(d / "later.dynspec", later, times, freqs,
                              mjd=60000.0 + 200.0 / 86400)
    text = open(out["asc"]).read().splitlines()
    with open(d / "cut.dynspec", "w") as fh:
        fh.write("\n".join(text[:len(text) // 2]) + "\n1 2 3\n")
    out["cut"] = str(d / "cut.dynspec")
    out["dir"] = str(d)
    return out


def _pair(path, **kw):
    dj = jdyn.Dynspec(filename=path, verbose=False, backend="jax", **kw)
    dp = tdyn.Dynspec(filename=path, verbose=False, device="cpu", **kw)
    return dj, dp


_FIELDS = ("times", "freqs", "nchan", "nsub", "bw", "df", "freq", "dt",
           "tobs", "mjd", "header", "name")


def assert_same_state(dp, dj, rtol=1e-12):
    np.testing.assert_allclose(dp.dyn, dj.dyn, rtol=rtol, atol=0,
                               equal_nan=True)
    for k in _FIELDS:
        a, b = getattr(dp, k), getattr(dj, k)
        if isinstance(b, (str, list)):
            assert a == b, k
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0,
                                       err_msg=k)


def assert_near_peak(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.nanmax(np.abs(want)))


def assert_db_near_peak(got, want):
    """Spectra in dB, compared as linear power within 1e-5 of the
    peak."""
    assert_near_peak(10 ** (np.asarray(got) / 10),
                     10 ** (np.asarray(want) / 10))


class TestPsrfluxIO:
    @pytest.mark.parametrize("note, header", [
        (None, ()), ("refilled", ("MJD0: 1", "isub ichan time freq flux"))])
    def test_writer_bytes_equal_jax(self, tmp_path, note, header):
        dyn, times, freqs = faulty_spectrum()
        want = _write_jax(tmp_path / "j.dynspec", dyn, times, freqs,
                          mjd=60001.25, header=header, note=note)
        raw = tio.RawDynSpec(dyn=dyn, times=times, freqs=freqs,
                             mjd=60001.25, header=list(header))
        got = str(tmp_path / "t.dynspec")
        tio.write_psrflux(raw, got, note=note)
        assert open(got, "rb").read() == open(want, "rb").read()
        assert sorted(os.listdir(tmp_path)) == ["j.dynspec", "t.dynspec"]

    @pytest.mark.parametrize("which", ["asc", "desc"])
    def test_loader_matches_jax(self, files, which):
        want = jio.load_psrflux(files[which])
        got = tio.load_psrflux(files[which])
        np.testing.assert_array_equal(got.dyn, want.dyn)
        for k in ("times", "freqs", "mjd", "dt", "df", "bw", "freq",
                  "tobs", "name", "header", "filename", "nchan", "nsub"):
            assert np.array_equal(getattr(got, k), getattr(want, k)), k
        assert np.all(np.diff(got.freqs) > 0)
        dyn, times, _ = faulty_spectrum()
        np.testing.assert_array_equal(got.dyn, dyn)
        np.testing.assert_allclose(got.times, times, rtol=0, atol=1e-9)

    def test_truncated_file_is_malformed_in_survey_mode(self, files):
        with pytest.raises(jio.MalformedInputError):
            jio.load_psrflux(files["cut"], survey=True)
        with pytest.raises(tio.MalformedInputError) as err:
            tio.load_psrflux(files["cut"], survey=True)
        assert err.value.filename == files["cut"]
        assert isinstance(err.value, ValueError)
        with pytest.raises(ValueError):
            tio.load_psrflux(files["cut"])

    def test_concatenate_time(self, files):
        a, b = (tio.load_psrflux(files[k]) for k in ("asc", "later"))
        ja, jb = (jio.load_psrflux(files[k]) for k in ("asc", "later"))
        got, want = tio.concatenate_time(a, b), jio.concatenate_time(ja, jb)
        np.testing.assert_array_equal(got.dyn, want.dyn)
        np.testing.assert_array_equal(got.times, want.times)
        assert (got.name, got.tobs, got.mjd) == (want.name, want.tobs,
                                                 want.mjd)


class TestHostHelpers:
    def test_is_valid_and_svd_model(self):
        from scintools_tpu.utils import misc as jmisc

        rng = np.random.default_rng(1)
        a = rng.random((12, 9)) + 1
        b = np.array([1.0, np.nan, np.inf, -np.inf])
        np.testing.assert_array_equal(tmisc.is_valid(b), jmisc.is_valid(b))
        for nm in (1, 2):
            got, want = tmisc.svd_model(a, nmodes=nm), \
                jmisc.svd_model(a, nmodes=nm)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)

    def test_inpaint_biharmonic(self):
        dyn = faulty_spectrum()[0][EDGE[0]:NCHAN - EDGE[1], 1:]
        mask = ~np.isfinite(dyn) | (dyn == 0)
        np.testing.assert_allclose(
            tinpaint.inpaint_biharmonic(np.nan_to_num(dyn), mask),
            jinpaint.inpaint_biharmonic(np.nan_to_num(dyn), mask),
            rtol=1e-12, atol=0)

    @pytest.mark.parametrize("k", [3, 5, (3, 5)])
    def test_median_filter_2d(self, k):
        a = np.random.default_rng(2).normal(size=(17, 23))
        got = tinpaint.median_filter_2d(a, k, device="cpu")
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jinpaint.median_filter_2d(
                a, k, backend="numpy")))
        with pytest.raises(ValueError):
            tinpaint.median_filter_2d(a, 4, device="cpu")

    @pytest.mark.parametrize("variant", ["real", "dense"])
    def test_autocovariance(self, variant):
        dyn = faulty_spectrum()[0][EDGE[0]:NCHAN - EDGE[1], 1:]
        got = tacf.autocovariance(dyn, variant=variant, device="cpu")
        want = np.asarray(jacf.autocovariance(dyn, backend="numpy",
                                              variant="dense"))
        assert got.shape == (2 * dyn.shape[0], 2 * dyn.shape[1])
        assert_near_peak(got.numpy(), want)

    def test_wiener_khinchin_real_matches_dense(self):
        x = torch.as_tensor(np.random.default_rng(3).normal(size=(2, 9, 14)))
        np.testing.assert_allclose(
            txfft.wiener_khinchin(x, (18, 28), variant="real").numpy(),
            txfft.wiener_khinchin(x, (18, 28), variant="dense").numpy(),
            rtol=0, atol=1e-9)

    @pytest.mark.parametrize("variant", ["real", "dense"])
    def test_acf_from_sspec(self, variant):
        from scintools_tpu.ops.sspec import secondary_spectrum

        dyn = np.nan_to_num(faulty_spectrum()[0][EDGE[0]:NCHAN - EDGE[1],
                                                 1:])
        _, _, ss = secondary_spectrum(dyn, 2.0, 0.05, halve=False,
                                      backend="numpy")
        got = tacf.acf_from_sspec(np.asarray(ss), variant=variant,
                                  device="cpu")
        want = np.asarray(jacf.acf_from_sspec(np.asarray(ss),
                                              backend="numpy"))
        assert_near_peak(got.numpy(), want)


class TestFacadeProcessing:
    def test_load_file_removes_short_subs(self, files):
        dj, dp = _pair(files["asc"])
        assert dp.dyn.shape == (NCHAN, NSUB)
        assert_same_state(dp, dj)
        assert dp.filename == dj.filename == files["asc"]
        assert not hasattr(dp, "sspec")

    def test_trim_edges(self, files):
        dj, dp = _pair(files["asc"])
        for d in (dj, dp):
            d.trim_edges()
        assert dp.dyn.shape == (NCHAN - sum(EDGE), NSUB)
        assert_same_state(dp, dj)

    def test_crop_dyn(self, files):
        dj, dp = _pair(files["asc"])
        for d in (dj, dp):
            d.crop_dyn(fmin=1400.5, fmax=1403.0, tmin=0.5, tmax=2.0)
        assert_same_state(dp, dj)

    def test_zap(self, files):
        dj, dp = _pair(files["asc"])
        for d in (dj, dp):
            d.trim_edges()
            d.refill()
            d.zap()
        assert_same_state(dp, dj)
        for f, t in SPIKES:
            assert np.isnan(dp.dyn[f - EDGE[0], t - 1])

    @pytest.mark.parametrize("method", ["biharmonic", "median", "linear",
                                        "cubic", "nearest"])
    def test_refill(self, files, method):
        dj, dp = _pair(files["asc"])
        for d in (dj, dp):
            d.trim_edges()
            d.refill(method=method)
        assert np.isfinite(dp.dyn).all()
        assert_same_state(dp, dj)

    @pytest.mark.parametrize("kw", [dict(), dict(svd=False),
                                    dict(svd=False, nsmooth=5),
                                    dict(lamsteps=True)])
    def test_correct_dyn(self, files, kw):
        dj, dp = _pair(files["asc"])
        for d in (dj, dp):
            d.trim_edges()
            d.refill()
            d.correct_dyn(**kw)
        assert_same_state(dp, dj)
        if kw.get("lamsteps"):
            np.testing.assert_allclose(dp.lamdyn, dj.lamdyn, rtol=1e-12)
        if kw.get("svd", True):
            np.testing.assert_allclose(dp.svd_model_arr, dj.svd_model_arr,
                                       rtol=1e-12)
        if kw.get("svd") is False:
            np.testing.assert_allclose(dp.bandpass, dj.bandpass,
                                       rtol=1e-12)

    @pytest.mark.parametrize("method", ["direct", "sspec"])
    def test_calc_acf(self, files, method):
        dj, dp = _pair(files["asc"])
        for d in (dj, dp):
            d.trim_edges()
            d.refill()
            d.calc_acf(method=method)
        assert_near_peak(dp.acf, dj.acf)
        if method == "direct":
            nf, nt = dp.dyn.shape
            assert dp.acf[nf, nt] == pytest.approx(1.0)
        tile = dp.dyn[:16, :24]
        assert_near_peak(dp.calc_acf(input_dyn=tile),
                         dj.calc_acf(input_dyn=tile))
        with pytest.raises(ValueError):
            dp.calc_acf(method="bogus")

    @pytest.mark.parametrize("lamsteps", [False, True])
    def test_calc_sspec_input_dyn_and_return(self, files, lamsteps):
        dj, dp = _pair(files["asc"])
        for d in (dj, dp):
            d.trim_edges()
            d.refill()
            if lamsteps:
                d.scale_dyn()
        tile = dp.dyn[:32, :40]
        for kw in (dict(input_dyn=tile), dict(return_sspec=True)):
            got = dp.calc_sspec(lamsteps=lamsteps, **kw)
            want = dj.calc_sspec(lamsteps=lamsteps, **kw)
            for g, w in zip(got[:2], want[:2]):
                np.testing.assert_array_equal(g, w)
            assert_db_near_peak(got[2], want[2])
        assert not hasattr(dp, "sspec") and not hasattr(dp, "lamsspec")

    def test_cut_dyn(self, files):
        dj, dp = _pair(files["asc"])
        for d in (dj, dp):
            d.trim_edges()
            d.refill()
            d.cut_dyn(tcuts=1, fcuts=2)
        np.testing.assert_array_equal(dp.cutdyn, dj.cutdyn)
        assert dp.cutsspec.shape == dj.cutsspec.shape
        for ii in range(3):
            for jj in range(2):
                assert_db_near_peak(dp.cutsspec[ii, jj], dj.cutsspec[ii, jj])
                assert_near_peak(dp.cutacf[ii, jj], dj.cutacf[ii, jj])
        for k in ("cut_sspec_x", "cut_sspec_y"):
            np.testing.assert_array_equal(getattr(dp, k), getattr(dj, k))
        for a, b in zip(dp.cut_times + dp.cut_freqs,
                        dj.cut_times + dj.cut_freqs):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("which", ["auto", "default"])
    def test_processing_pipelines(self, files, which):
        if which == "auto":
            dj, dp = _pair(files["asc"], process=True)
        else:
            dj, dp = _pair(files["asc"])
            for d in (dj, dp):
                d.default_processing()
        assert_same_state(dp, dj)
        assert np.isfinite(dp.dyn).all()
        assert_near_peak(dp.acf, dj.acf)
        assert_db_near_peak(dp.sspec, dj.sspec)
        np.testing.assert_array_equal(dp.fdop, dj.fdop)
        np.testing.assert_array_equal(dp.tdel, dj.tdel)

    def test_auto_processing_lamsteps(self, files):
        dj, dp = _pair(files["asc"], process=True, lamsteps=True)
        assert_same_state(dp, dj)
        np.testing.assert_allclose(dp.lamdyn, dj.lamdyn, rtol=1e-12)
        assert_db_near_peak(dp.lamsspec, dj.lamsspec)
        np.testing.assert_array_equal(dp.beta, dj.beta)

    def test_add(self, files):
        aj, ap = _pair(files["asc"])
        bj, bp = _pair(files["later"])
        got, want = ap + bp, aj + bj
        assert_same_state(got, want)
        assert got.device == ap.device

    def test_write_file_round_trip(self, files, tmp_path):
        dj, dp = _pair(files["asc"])
        for d in (dj, dp):
            d.trim_edges()
            d.refill()
        dj.write_file(str(tmp_path / "j.dynspec"), verbose=False,
                      note="refilled")
        dp.write_file(str(tmp_path / "t.dynspec"), verbose=False,
                      note="refilled")
        assert (open(tmp_path / "t.dynspec", "rb").read()
                == open(tmp_path / "j.dynspec", "rb").read())
        back = tdyn.Dynspec(filename=str(tmp_path / "t.dynspec"),
                            verbose=False, device="cpu")
        np.testing.assert_array_equal(back.dyn, dp.dyn)
        np.testing.assert_allclose(back.times, dp.times, rtol=0, atol=1e-9)
        np.testing.assert_array_equal(back.freqs, dp.freqs)

    def test_write_file_default_name(self, files, tmp_path):
        import shutil

        path = str(tmp_path / "obs.dynspec")
        shutil.copy(files["asc"], path)
        dp = tdyn.Dynspec(filename=path, verbose=False, device="cpu")
        dp.write_file(verbose=False)
        assert os.path.exists(str(tmp_path / "obs.processed.dynspec"))

    def test_info_and_verbose_load(self, files, capsys):
        dj = jdyn.Dynspec(filename=files["asc"], backend="jax")
        want = capsys.readouterr().out
        tdyn.Dynspec(filename=files["asc"], device="cpu")
        assert capsys.readouterr().out == want
        assert "OBSERVATION PROPERTIES" in want
        bd = dict(times=dj.times, freqs=dj.freqs)
        jdyn.Dynspec(dyn=jdyn.BasicDyn(np.nan_to_num(dj.dyn), **bd),
                     process=False, backend="jax")
        want = capsys.readouterr().out
        tdyn.Dynspec(dyn=tdyn.BasicDyn(np.nan_to_num(dj.dyn), **bd),
                     process=False, device="cpu")
        assert capsys.readouterr().out == want


class TestSortAndMatlab:
    def test_sort_dyn_lists_equal_jax(self, files, tmp_path):
        short = _write_jax(tmp_path / "short.dynspec",
                           *faulty_spectrum(seed=7)[:1],
                           np.arange(3) * 2.0, 1400.0 + 0.05 * np.arange(NCHAN))
        paths = [files["asc"], files["cut"], short, files["desc"]]
        for name, fn, kw in (("jax", jdyn.sort_dyn, {}),
                             ("port", tdyn.sort_dyn, dict(device="cpu"))):
            (tmp_path / name).mkdir()
            fn(paths, outdir=str(tmp_path / name), verbose=False,
               min_nchan=20, min_tsub=1, **kw)
        for f in ("good_files.txt", "bad_files.txt"):
            got = open(tmp_path / "port" / f).read()
            assert got == open(tmp_path / "jax" / f).read(), f
        good = open(tmp_path / "port" / "good_files.txt").read().split()
        assert good == [files["asc"], files["desc"]]
        bad = open(tmp_path / "port" / "bad_files.txt").read()
        assert "malformed" in bad and "nsub<10" in bad

    def test_sort_dyn_takes_the_reference_parameters_first(self):
        import inspect

        ref = list(inspect.signature(jdyn.sort_dyn).parameters.values())
        ours = list(inspect.signature(tdyn.sort_dyn).parameters.values())
        assert [(p.name, p.default) for p in ours[:len(ref)]] \
            == [(p.name, p.default) for p in ref]
        assert [p.name for p in ours[len(ref):]] == ["device"]

    def test_matlab_dyn(self, tmp_path):
        from scipy.io import savemat

        rng = np.random.default_rng(4)
        spi = rng.random((40, 24)) + 0.5
        path = str(tmp_path / "obs.mat")
        savemat(path, {"spi": spi, "dlam": 0.05})
        mj, mp = jdyn.MatlabDyn(path), tdyn.MatlabDyn(path)
        for k in ("dyn", "freqs", "times", "bw", "df", "tobs", "dt",
                  "nsub", "nchan", "name", "mjd"):
            assert np.array_equal(getattr(mp, k), getattr(mj, k)), k
        dp = tdyn.Dynspec(dyn=mp, process=False, verbose=False,
                          device="cpu")
        assert dp.dyn.shape == (24, 40)
        savemat(str(tmp_path / "bad.mat"), {"spi": spi})
        with pytest.raises(NameError):
            tdyn.MatlabDyn(str(tmp_path / "bad.mat"))
