"""The plain references against the port on the CPU at a tiny size, and
their pieces against numpy and scipy."""

import numpy as np
import pytest
import torch
from scipy.signal import savgol_filter

from portbench import generate
from portbench.reference import arcfit as ref_arc
from portbench.reference import common
from portbench.reference import thth as ref_thth

CPU = torch.device("cpu")


def test_precision_rounds_to_the_kept_mantissa():
    x = torch.randn(10000, dtype=torch.float64)
    bf = common.Precision("bfloat16")(x)
    assert torch.equal(bf, x.float().to(torch.bfloat16).float())
    tf = common.Precision("tf32")(x)
    assert bool(((tf.view(torch.int32) & 0x1FFF) == 0).all())
    rel = ((tf.double() - x.float().double()).abs() / x.abs()).max()
    assert rel <= 2.0 ** -11
    z = torch.complex(x, -x)
    assert torch.equal(common.Precision("tf32")(z).real, tf)
    assert common.Precision("float64")(x) is not None
    assert torch.equal(common.Precision("float64")(x), x)


def test_lanczos_top_is_the_largest_eigenvalue():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(6, 40, 40)) + 1j * rng.normal(size=(6, 40, 40))
    a = a + np.conj(np.transpose(a, (0, 2, 1)))
    a[0] = 0                                     # a zero matrix: λ = 0
    lam, bound = common.lanczos_top(torch.as_tensor(a),
                                    common.Precision("float64"), steps=40)
    want = np.linalg.eigvalsh(a)[:, -1]
    assert np.allclose(lam, want, rtol=1e-10, atol=1e-10)
    assert np.all(bound < 1e-6)


def test_savgol_linear_is_scipys():
    y = np.random.default_rng(2).normal(size=57).cumsum()
    assert np.allclose(ref_arc.savgol_linear(y, 5), savgol_filter(y, 5, 1),
                       rtol=1e-12, atol=1e-12)


def test_generator_repeats_from_the_seed():
    ss = generate.seed_sequence(2 ** 70 + 3, 1, 0)
    a = generate.arc_dynspecs(2, 16, 24, 2.0, 0.05, 5e-4, 8, 80.0, 0.02,
                              ss, CPU)
    b = generate.arc_dynspecs(2, 16, 24, 2.0, 0.05, 5e-4, 8, 80.0, 0.02,
                              generate.seed_sequence(2 ** 70 + 3, 1, 0), CPU)
    c = generate.arc_dynspecs(2, 16, 24, 2.0, 0.05, 5e-4, 8, 80.0, 0.02,
                              generate.seed_sequence(-5, 1, 0), CPU)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 16, 24) and a.dtype == torch.float64


def test_secondary_spectrum_is_the_ports():
    from scintools_tpu_torch.ops.sspec import secondary_spectrum

    d = generate.arc_dynspecs(1, 96, 64, 2.0, 0.05, 5e-4, 12, 80.0, 0.02,
                              generate.seed_sequence(4), CPU)[0]
    fdop, tdel, got = secondary_spectrum(d.numpy(), 2.0, 0.05, device="cpu")
    _, _, fd2, td2 = common.sspec_axes(96, 64, 2.0, 0.05)
    want = common.sspec_db(d, common.Precision("float64"))
    assert np.allclose(fdop, fd2) and np.allclose(tdel, td2)
    assert got.shape == want.shape
    lin_g, lin_w = 10 ** (got.double() / 10), 10 ** (want / 10)
    assert float((lin_g - lin_w).abs().max() / lin_w.max()) < 1e-5


@pytest.mark.parametrize("proc", ["standard", "thin"])
def test_thth_observation_is_the_facades(proc, shrink):
    from scintools_tpu_torch import BasicDyn, Dynspec

    cfg, _, _ = shrink("thth_4096." + proc)
    obs, p = cfg["observation"], cfg["prep"]
    freqs = obs["f0"] + obs["df"] * np.arange(obs["nf"])
    times = obs["dt"] * np.arange(obs["nt"])
    dyn = generate.arc_dynspecs(
        1, obs["nf"], obs["nt"], obs["dt"], obs["df"], obs["eta_true"],
        obs["n_images"], obs["fd_max"], obs["noise"],
        generate.seed_sequence(7), CPU)[0].numpy()
    prep = dict(cwf=p["cwf"], cwt=p["cwt"], npad=p["npad"], fw=p["fw"],
                eta_min=p["eta_min_frac"] * obs["eta_true"],
                eta_max=p["eta_max_frac"] * obs["eta_true"],
                neta=p["neta"], nedge=p["nedge"], edges_lim=p["edges_lim"],
                fitting_proc=proc)
    ds = Dynspec(dyn=BasicDyn(dyn, freqs=freqs, times=times), process=False,
                 verbose=False, device="cpu")
    ds.calc_sspec()
    ds.prep_thetatheta(**prep)
    ds.fit_thetatheta()
    want = ref_thth.observation(dyn, freqs, times, prep, device="cpu")
    assert np.array_equal(ds.eta_evo_ok, want["eta_evo_ok"])
    assert np.allclose(ds.eta_evo, want["eta_evo"], rtol=1e-4,
                       equal_nan=True)
    assert np.allclose(ds.eta_evo_err, want["eta_evo_err"], rtol=1e-2,
                       equal_nan=True)
    assert ds.ththeta == pytest.approx(want["ththeta"], rel=1e-4)
    assert ds.ththetaerr == pytest.approx(want["ththetaerr"], rel=1e-3)
    assert np.allclose(ds.f0s, want["f0s"])
    assert want["lanczos_bound"] < 1e-8


def test_arc_fit_is_the_ports(shrink):
    from scintools_tpu_torch.ops.fitarc import fit_arc_batch
    from scintools_tpu_torch.ops.sspec import secondary_spectrum

    cfg, _, _ = shrink("arcfit_256.b1024")
    ep, f = cfg["epochs"], cfg["fit"]
    d = generate.arc_dynspecs(8, ep["nf"], ep["nt"], ep["dt"], ep["df"],
                              ep["eta_true"], ep["n_images"], ep["fd_max"],
                              ep["noise"], generate.seed_sequence(8), CPU)
    secs = [secondary_spectrum(x, ep["dt"], ep["df"], device="cpu")
            for x in d]
    fdop, tdel = secs[0][0], secs[0][1]
    s = torch.stack([x[2] for x in secs])
    fits = fit_arc_batch(None, tdel, fdop, numsteps=f["numsteps"],
                         sspecs_device=s, full_output=False, device="cpu")
    got = np.array([[a.eta, a.etaerr, a.etaerr2] for a in fits])
    # on the port's own spectra the reference's fit is the port's
    same = np.stack(ref_arc.fit_batch(s.double(), tdel, fdop,
                                      numsteps=f["numsteps"]), axis=1)
    assert np.array_equal(np.isnan(got), np.isnan(same))
    assert np.allclose(got, same, rtol=1e-4, equal_nan=True)
    # and from the dynamic spectra it is near it
    fd2, td2, sec = ref_arc.spectra(d, ep["dt"], ep["df"])
    assert np.allclose(fd2, fdop) and np.allclose(td2, tdel)
    full = np.stack(ref_arc.fit_batch(sec, td2, fd2, numsteps=f["numsteps"]),
                    axis=1)
    assert np.allclose(got[:, 0], full[:, 0], rtol=1e-3, equal_nan=True)


def test_arc_fit_driver_agrees_with_its_reference(shrink):
    from portbench import harness
    from portbench.drivers import arcfit_batch

    cfg, tr, _ = shrink("arcfit_256.b1024")
    cell = arcfit_batch.Cell(cfg, tr, 2 ** 40 + 1, CPU, harness.Spans(False))
    cell.setup()
    assert sum(cell.step(i) for i in range(3)) == 3 * tr["batch"]
    cell.release()
    r = cell.readings()
    assert r["nan_mismatch"] == 0 and r["eta_gap"] < 1e-4
    # 128² epochs: 128 delays (rows 3 … 126 read), 256 Doppler bins
    assert cell.shapes() == {"epochs": 8, "rows": 124, "doppler": 256,
                             "queries": 2000}
