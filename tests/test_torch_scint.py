"""The port's scintillation-parameter slice (scintools_tpu_torch/fit/
parameters.py, models.py, fitter.py, lm.py, batch.py, acf2d.py,
sim/acf_model.py and the façade's get_scint_params and get_acf_tilt)
against the JAX package on the CPU.

Inputs are made with numpy from fixed seeds, or simulated by the JAX
package's ``sim/`` inside the test, and handed to both sides. The JAX
side runs under tier-1's x64, so its "highest" acf2d policy and its 1-D
survey LM iterate in float64, as the port's do. Tolerances: the host
models and fits at rel 1e-8 (the same float64 numpy on both sides); the
analytic ACF within 1e-9 of its peak at "highest" and 1e-5 at "default"
(float32); the LM on a toy residual at rtol 1e-8 with equal iteration
counts; the 1-D survey fit's values at rel 1e-4 and errors at rel 1e-3;
the acf2d fit at rel 1e-6 ("highest") and 1e-4 ("default", float32);
the façade at rel 1e-6 on a shared ACF and rel 1e-3 end to end.
"""

import sys

import numpy as np
import pytest
import torch

from scintools_tpu import dynspec as jdyn
from scintools_tpu.fit import acf2d as jacf2d
from scintools_tpu.fit import batch as jbatch
from scintools_tpu.fit.fitter import fitter as jfitter_fn
from scintools_tpu.fit.fitter import minimize_leastsq as jminimize
from scintools_tpu.fit import lm_jax as jlm
from scintools_tpu.fit import models as jmodels
from scintools_tpu.fit.parameters import Parameters as JParameters
from scintools_tpu.robust import guards as jguards
from scintools_tpu.sim import acf_model as jacf
from scintools_tpu.sim.simulation import simulate_dynspec_batch
from scintools_tpu_torch import dynspec as tdyn
from scintools_tpu_torch.fit import acf2d as tacf2d
from scintools_tpu_torch.fit import batch as tbatch
import scintools_tpu_torch.fit.fitter  # noqa: E402,F401 (the module)
from scintools_tpu_torch.fit import lm as tlm
from scintools_tpu_torch.fit import models as tmodels
from scintools_tpu_torch.fit.parameters import Parameters as TParameters
from scintools_tpu_torch.obs.retrace import compile_counts
from scintools_tpu_torch.robust import guards as tguards
from scintools_tpu_torch.sim import acf_model as tacf

# the package attribute ``fit.fitter`` is the function ``fitter`` (the JAX
# package's namespace); the module itself comes from sys.modules
tfitter = sys.modules["scintools_tpu_torch.fit.fitter"]

CPU = "cpu"
NC = 17          # the JAX package's own acf2d test crop and budget
N_ITER = 12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(p):
    return {k: (v.value, v.vary, v.min, v.max, v.stderr)
            for k, v in p.items()}


def _acf2d_params(P, nc=NC, tau=1200.0, dnu=4.0, amp=1.0, phasegrad=0.0,
                  psi=60.0, tobs=3600.0, bw=32.0):
    """tests/test_acf2d_batch.py's parameter set, in either package."""
    p = P()
    p.add("tau", value=tau, vary=True, min=0, max=np.inf)
    p.add("dnu", value=dnu, vary=True, min=0, max=np.inf)
    p.add("amp", value=amp, vary=True, min=0, max=np.inf)
    p.add("alpha", value=5 / 3, vary=False)
    p.add("nt", value=2 * nc - 1, vary=False)
    p.add("nf", value=2 * nc - 1, vary=False)
    p.add("phasegrad", value=phasegrad, vary=True)
    p.add("tobs", value=tobs, vary=False)
    p.add("bw", value=bw, vary=False)
    p.add("ar", value=2.0, vary=False)
    p.add("theta", value=0, vary=False)
    p.add("psi", value=psi, vary=True)
    return p


def _acf2d_epochs(B, nc=NC, noise=0.01, seed=8):
    """tests/test_acf2d_batch.py's epochs: the JAX model plus noise."""
    rng = np.random.default_rng(seed)
    model = -jmodels.scint_acf_model_2d(_acf2d_params(JParameters, nc),
                                        np.zeros((nc, nc)),
                                        np.ones((nc, nc)))
    return np.stack([model + noise * np.max(model)
                     * rng.normal(size=(nc, nc)) for _ in range(B)])


@pytest.fixture(scope="module")
def epochs1d():
    """Six simulated 96 × 64 epochs (dt 2 s, df 0.05 MHz)."""
    d = np.asarray(simulate_dynspec_batch(6, ns=64, nf=96, seed=77))
    return np.transpose(d, (0, 2, 1)).astype(np.float64)


@pytest.fixture(scope="module")
def cuts(epochs1d):
    """One epoch's one-sided ACF cuts, Bartlett weights and guesses,
    as the survey bench's serial recipe makes them (host numpy)."""
    nt, nf, dt, df = 64, 96, 2.0, 0.05
    tc, fc = jbatch.acf_cuts_batch(epochs1d[:1], backend="numpy")
    yt, yf = np.asarray(tc[0], float), np.asarray(fc[0], float)
    wt, wf = jbatch.bartlett_weights(yt, nt), jbatch.bartlett_weights(yf, nf)
    tau0, dnu0, amp0, _ = jbatch.initial_guesses_batch(
        yt, yf, dt, df, nt * dt, nf * df, np)
    xt, xf = dt * np.arange(nt), df * np.arange(nf)
    return dict(xt=xt, xf=xf, yt=yt, yf=yf, wt=wt, wf=wf,
                x0=(float(tau0), float(dnu0), float(amp0)))


def _close(got, ref, rel, what=""):
    assert got == pytest.approx(ref, rel=rel, nan_ok=True), what


class TestParameters:
    def test_round_trip(self):
        """A JAX set carried across as plain data keeps every field and
        its order; the helpers agree."""
        j = _acf2d_params(JParameters)
        j["tau"].stderr = 12.5
        t = TParameters.from_state(_state(j))
        assert list(t) == list(j)
        assert _state(t) == _state(j)
        assert t.valuesdict() == j.valuesdict()
        assert t.varying_names() == j.varying_names()
        np.testing.assert_array_equal(t.varying_values(), j.varying_values())
        for a, b in zip(t.varying_bounds(), j.varying_bounds()):
            np.testing.assert_array_equal(a, b)
        x = np.arange(5.0) + 0.5
        assert _state(t.with_values(x)) == _state(j.with_values(x))
        c = t.copy()
        c["tau"].value = -1
        assert t["tau"].value == 1200.0


class TestHostModels:
    """The host models are the same float64 numpy on both sides."""

    def test_1d_models(self, cuts):
        p = {"tau": 30.0, "dnu": 0.2, "amp": 0.9, "alpha": 5 / 3}
        c = cuts
        for name in ("tau_acf_model", "dnu_acf_model"):
            x, y, w = ((c["xt"], c["yt"], c["wt"]) if name[0] == "t"
                       else (c["xf"], c["yf"], c["wf"]))
            for weights in (w, None):
                np.testing.assert_allclose(
                    getattr(tmodels, name)(p, x, y, weights),
                    getattr(jmodels, name)(p, x, y, weights), rtol=1e-8)
            np.testing.assert_allclose(
                getattr(tmodels, name + "_values")(p, x),
                getattr(jmodels, name + "_values")(p, x), rtol=1e-8)
        args = ((c["xt"], c["xf"]), (c["yt"], c["yf"]), (c["wt"], c["wf"]))
        np.testing.assert_allclose(tmodels.scint_acf_model(p, *args),
                                   jmodels.scint_acf_model(p, *args),
                                   rtol=1e-8)

    def test_1d_model_on_tensors_matches_numpy(self, cuts):
        """The LM's tensor route is the same formula as the host route."""
        c = cuts
        p = {"tau": torch.tensor(30.0, dtype=torch.float64),
             "dnu": torch.tensor(0.2, dtype=torch.float64),
             "amp": torch.tensor(0.9, dtype=torch.float64), "alpha": 5 / 3}
        got = tmodels.scint_acf_model(
            p, *[tuple(torch.as_tensor(c[k + s]) for s in "tf")
                 for k in ("x", "y", "w")])
        ref = jmodels.scint_acf_model({k: float(v) for k, v in p.items()},
                                      (c["xt"], c["xf"]), (c["yt"], c["yf"]),
                                      (c["wt"], c["wf"]))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)

    def test_2d_models(self):
        p = _acf2d_params(JParameters, phasegrad=0.05, psi=45.0).valuesdict()
        tdata = np.linspace(-600, 600, NC)
        fdata = np.linspace(-4, 4, NC)
        y = np.random.default_rng(3).normal(size=(NC, NC))
        w = np.random.default_rng(4).random((NC, NC))
        for weights in (w, None):
            np.testing.assert_allclose(
                tmodels.scint_acf_model_2d_approx(p, tdata, fdata, y,
                                                  weights),
                jmodels.scint_acf_model_2d_approx(p, tdata, fdata, y,
                                                  weights), rtol=1e-8)
            ref = jmodels.scint_acf_model_2d(p, y, weights)
            got = tmodels.scint_acf_model_2d(p, y, weights, CPU)
            np.testing.assert_allclose(got, ref, rtol=1e-8,
                                       atol=1e-12 * np.abs(ref).max())
        x = np.linspace(1, 30, 40)
        q = {"wn": 0.3, "amp": 2.0, "alpha": -11 / 3}
        np.testing.assert_allclose(tmodels.powerspectrum_model(q, x, x),
                                   jmodels.powerspectrum_model(q, x, x),
                                   rtol=1e-8)

    def test_minimize_leastsq_and_report(self, cuts):
        """The acf1d scipy fit of the survey bench's serial recipe:
        values, stderrs, covariance and the report with its
        correlations table."""
        c = cuts
        args = ((c["xt"], c["xf"]), (c["yt"], c["yf"]), (c["wt"], c["wf"]))
        res = []
        for P, mod, fit in ((JParameters, jmodels, jminimize),
                            (TParameters, tmodels, tfitter.minimize_leastsq)):
            p = P()
            for name, v in zip(("tau", "dnu", "amp"), c["x0"]):
                p.add(name, value=v, vary=True, min=0, max=np.inf)
            p.add("alpha", value=5 / 3, vary=False)
            res.append(fit(mod.scint_acf_model, p, args=args))
        j, t = res
        for k in ("tau", "dnu", "amp"):
            _close(t.params[k].value, j.params[k].value, 1e-8, k)
            _close(t.params[k].stderr, j.params[k].stderr, 1e-8, k)
        np.testing.assert_allclose(t.covar, j.covar, rtol=1e-8)
        _close(t.chisqr, j.chisqr, 1e-8)
        assert (t.nfev, t.nfree, t.success) == (j.nfev, j.nfree, j.success)
        assert "[[Correlations]]" in t.fit_report()
        assert t.fit_report() == j.fit_report()
        assert t.fit_report(min_correl=0.99) == j.fit_report(min_correl=0.99)

    def test_fitter_least_squares_and_bounds(self):
        """``fitter`` drives least squares with bounds and
        ``nan_policy="omit"`` the same way."""
        x = np.linspace(1, 30, 40)
        y = 0.4 + 3.0 * x ** -1.5 + 0.01 * np.sin(x)
        y[5] = np.nan
        out = []
        for P, mod, fit in ((JParameters, jmodels, jfitter_fn),
                            (TParameters, tmodels, tfitter.fitter)):
            p = P()
            p.add("wn", value=0.5, vary=True, min=0.2, max=np.inf)
            p.add("alpha", value=-1.0, vary=True, min=-np.inf, max=0)
            p.add("amp", value=1.0, vary=True, min=0.0, max=np.inf)
            out.append(fit(mod.powerspectrum_model, p, (x, y),
                           nan_policy="omit"))
        for k in ("wn", "alpha", "amp"):
            _close(out[1].params[k].value, out[0].params[k].value, 1e-8, k)
            _close(out[1].params[k].stderr, out[0].params[k].stderr, 1e-8, k)


class TestAnalyticAcf:
    @pytest.mark.parametrize("kw", [
        dict(),
        dict(phasegrad=0.3, psi=40, ar=2.0, wn=0.1, amp=1.2, theta=10,
             taumax=3, dnumax=5, nt=32, nf=25),
        dict(ar=1.5, alpha=1.4, auto_sampling=False, spatial_factor=3,
             resolution_factor=1.5, core_factor=3, nt=21, nf=21)])
    def test_acf_class(self, kw):
        """The ``ACF`` class in float64 on the device against the JAX
        package's numpy class, within 1e-9 of the peak."""
        ref = jacf.ACF(**kw)
        got = tacf.ACF(device=CPU, **kw)
        assert got.acf.shape == ref.acf.shape
        peak = np.abs(ref.acf).max()
        np.testing.assert_allclose(got.acf, ref.acf, rtol=0, atol=1e-9 * peak)
        for k in ("fn", "tn", "sn", "snp"):
            np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
        np.testing.assert_allclose(got.acf_efield, ref.acf_efield, rtol=0,
                                   atol=1e-12)
        assert got.ddnun == ref.ddnun

    @pytest.mark.parametrize("precision, tol", [("highest", 1e-9),
                                                ("default", 1e-5)])
    @pytest.mark.parametrize("alpha_varies", [False, True])
    def test_model_core(self, precision, tol, alpha_varies):
        """``make_acf2d_model_core`` at both policies (the varying-alpha
        build takes the dense rows at either), with the lag steps and
        alpha as inputs."""
        nc, nf = NC, 13
        dt, df = 2 * 3600 / 33, 2 * 32 / 33
        kw = dict(precision=precision, alpha_varies=alpha_varies)
        ref = jacf.make_acf2d_model_core(nc, nf, 2.0, 5 / 3, 10.0, 1200.0,
                                         dt, **kw)
        got = tacf.make_acf2d_model_core(nc, nf, 2.0, 5 / 3, 10.0, 1200.0,
                                         dt, device=CPU, **kw)
        for args in ((1200.0, 4.0, 1.0, 0.2, 60.0, 0.05, dt, df),
                     (-900.0, 6.0, 0.7, -0.1, 20.0, 0.0, 0.9 * dt, df)):
            extra = dict(alpha=1.5) if alpha_varies else {}
            a = np.asarray(ref(*args, **extra))
            b = got(*args, **extra).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape == (nf, nc)
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=tol * np.abs(a).max())

    def test_model_fn_and_lowrank_rank(self):
        nc = NC
        dt, df = 2 * 3600 / 33, 2 * 32 / 33
        args = (1200.0, 4.0, 1.0, 0.2, 60.0, 0.0)
        for precision, tol in (("highest", 1e-9), ("default", 1e-5)):
            a = np.asarray(jacf.make_acf2d_model_fn(
                nc, nc, dt, df, 2.0, 5 / 3, 0.0, tau0=1200.0,
                precision=precision)(*args))
            b = tacf.make_acf2d_model_fn(
                nc, nc, dt, df, 2.0, 5 / 3, 0.0, tau0=1200.0,
                precision=precision, device=CPU)(*args).numpy()
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=tol * np.abs(a).max())
        snp = np.linspace(-12, 12, 155).astype(np.float32)
        for alph2 in (5 / 6, 0.7):
            uj, vj = jacf.lowrank_gammes(snp, np.sqrt(2), alph2,
                                         dtype=np.float32)
            ut, vt = tacf.lowrank_gammes(snp, np.sqrt(2), alph2,
                                         dtype=np.float32)
            assert ut.shape == uj.shape and vt.shape == vj.shape
            np.testing.assert_array_equal(ut @ vt.T, uj @ vj.T)
        assert tacf.acf2d_grid_sizes(65, 111.6, 2.0, 1400.0) == \
            jacf.acf2d_grid_sizes(65, 111.6, 2.0, 1400.0)

    @pytest.mark.parametrize("precision", ["highest", "default"])
    @pytest.mark.parametrize("alpha_varies", [False, True])
    def test_written_out_derivative_matches_autodiff(self, precision,
                                                     alpha_varies):
        """``model.jvp`` (the forward mode written out) against
        ``torch.func.jacfwd`` of the model, every parameter's column,
        within 1e-12 (float64) or 1e-5 (float32) of the column's peak."""
        dt, df = 2 * 3600 / 33, 2 * 32 / 33
        dtype = torch.float64 if precision == "highest" else torch.float32
        model = tacf.make_acf2d_model_core(
            NC, 13, 2.0, 5 / 3, 10.0, 1200.0, dt, precision=precision,
            alpha_varies=alpha_varies, device=CPU)
        x = torch.tensor([1200.0, 4.0, 1.1, 0.2, 60.0, 0.05, 1.6],
                         dtype=dtype)

        def f(v):
            return model(*v[:6], dt, df,
                         alpha=v[6] if alpha_varies else 5 / 3)

        J = torch.func.jacfwd(f)(x).permute(2, 0, 1)
        out, out_t = model.jvp(*x[:6], dt, df,
                               alpha=x[6] if alpha_varies else 5 / 3,
                               tangents=torch.eye(7, dtype=dtype))
        assert torch.equal(out, f(x))
        tol = 1e-12 if precision == "highest" else 1e-5
        for k in range(7 if alpha_varies else 6):
            peak = J[k].abs().max()
            assert (out_t[k] - J[k]).abs().max() <= tol * peak, k

    def test_derivatives_finite_at_the_spike(self):
        """The double ``where`` keeps forward-mode derivatives finite
        where the e-field ACF's base is 0 (the centre lag)."""
        dt, df = 2 * 3600 / 33, 2 * 32 / 33
        model = tacf.make_acf2d_model_core(NC, NC, 2.0, 5 / 3, 0.0, 1200.0,
                                           dt, precision="highest",
                                           alpha_varies=True, device=CPU)
        x = torch.tensor([1200.0, 4.0, 5 / 3], dtype=torch.float64)
        J = torch.func.jacfwd(lambda v: model(v[0], v[1], 1.0, 0.1, 60.0,
                                              0.0, dt, df, alpha=v[2]))(x)
        assert torch.isfinite(J).all()


def _toy_residual_jax():
    import jax.numpy as jnp

    def residual(x, t, y):
        tau, amp = x
        return amp * jnp.exp(-(t / tau) ** (5 / 3)) - y
    return residual


def _toy_residual_torch(x, t, y):
    tau, amp = x[0], x[1]
    return amp * torch.exp(-(t / tau) ** (5 / 3)) - y


@pytest.fixture(scope="module")
def toy():
    """tests/test_lm_jax.py's four toy fits (one lane each)."""
    rng = np.random.default_rng(1)
    t = np.linspace(0.1, 300, 60)
    taus = np.array([40.0, 75.0, 120.0, 200.0])
    amps = np.array([0.8, 1.0, 1.2, 1.5])
    ys = np.stack([a * np.exp(-(t / tt) ** (5 / 3))
                   + 0.005 * rng.normal(size=60)
                   for tt, a in zip(taus, amps)])
    x0 = np.tile([50.0, 1.0], (4, 1))
    return x0, np.tile(t, (4, 1)), ys


class TestLevenbergMarquardt:
    @pytest.mark.parametrize("bounds", [None, ([5.0, 0.1], [100.0, 2.0])])
    def test_solver(self, toy, bounds):
        import jax
        import jax.numpy as jnp

        x0, t, ys = toy
        js = jlm.make_lm_solver(_toy_residual_jax(), n_iter=30,
                                bounds=bounds)
        xj, cj = jax.vmap(js)(jnp.asarray(x0), jnp.asarray(t),
                              jnp.asarray(ys))
        ts = tlm.make_lm_solver(_toy_residual_torch, n_iter=30,
                                bounds=bounds)
        xt, ct = ts(*(torch.as_tensor(a) for a in (x0, t, ys)))
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-8)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-8)
        covj = jax.vmap(lambda x, a, b: jlm.lm_covariance(
            _toy_residual_jax(), x, (a, b)))(xj, jnp.asarray(t),
                                             jnp.asarray(ys))
        covt = tlm.lm_covariance(_toy_residual_torch, xt,
                                 (torch.as_tensor(t), torch.as_tensor(ys)))
        np.testing.assert_allclose(covt.numpy(), np.asarray(covj), rtol=1e-8)

    @pytest.mark.parametrize("xtol", [1e-6, 0.0])
    def test_fit_fn(self, toy, xtol):
        """The early-exit fit: x, cost and cov at rtol 1e-8, the residual
        within 1e-8 of the data's scale, and with the ``xtol`` exit each
        lane stops at the same iteration as under JAX's
        ``vmap(while_loop)``."""
        import jax
        import jax.numpy as jnp

        x0, t, ys = toy
        bounds = ([1.0, 0.01], [500.0, 5.0])
        jf = jlm.make_lm_fit_fn(_toy_residual_jax(), n_iter=40,
                                bounds=bounds, xtol=xtol)
        oj = jax.vmap(jf)(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(ys))
        tf = tlm.make_lm_fit_fn(_toy_residual_torch, n_iter=40,
                                bounds=bounds, xtol=xtol)
        ot = tf(*(torch.as_tensor(a) for a in (x0, t, ys)))
        if xtol:
            np.testing.assert_array_equal(ot["niter"].numpy(),
                                          np.asarray(oj["niter"]))
            assert len(set(ot["niter"].tolist())) > 1
        else:
            # only the λ-saturation exit: it fires once the cost stops
            # falling at rounding level, an iteration that summation
            # order decides; the outputs it leaves are the converged ones
            assert (ot["niter"] <= 40).all()
        np.testing.assert_array_equal(ot["ok"].numpy(), np.asarray(oj["ok"]))
        for k in ("x", "cost", "cov"):
            np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                       rtol=1e-8, err_msg=k)
        np.testing.assert_allclose(ot["residual"].numpy(),
                                   np.asarray(oj["residual"]), rtol=0,
                                   atol=1e-8 * np.abs(ys).max())

    def test_singular_lane_is_flagged_not_raised(self, toy):
        """A lane whose normal equations cannot be solved (all-NaN data)
        is flagged and leaves its neighbours bit for bit unchanged."""
        x0, t, ys = toy
        tf = tlm.make_lm_fit_fn(_toy_residual_torch, n_iter=40)
        clean = tf(*(torch.as_tensor(a) for a in (x0, t, ys)))
        bad = ys.copy()
        bad[1] = np.nan
        out = tf(*(torch.as_tensor(a) for a in (x0, t, bad)))
        assert out["ok"].tolist() == [True, False, True, True]
        for k in ("x", "cost", "cov", "niter"):
            for lane in (0, 2, 3):
                assert out[k][lane].numpy().tobytes() == \
                    clean[k][lane].numpy().tobytes(), (k, lane)
        A = torch.zeros(2, 3, 3, dtype=torch.float64)
        A[0] = torch.eye(3)
        x = tlm._solve(A, torch.ones(2, 3, dtype=torch.float64))
        assert torch.isfinite(x[0]).all() and torch.isnan(x[1]).all()


class TestSurvey1d:
    def test_scint_params_batch(self, epochs1d):
        ref = jbatch.scint_params_batch(epochs1d, 2.0, 0.05)
        got = tbatch.scint_params_batch(epochs1d, 2.0, 0.05, device=CPU)
        assert set(got) == set(ref)
        for k in ("tau", "dnu", "amp", "chisqr", "redchi"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
        for k in ("tauerr", "dnuerr", "amperr"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, err_msg=k)
        # a repeated geometry builds nothing
        before = compile_counts().get("fit.acf1d_batch", 0)
        again = tbatch.scint_params_batch(torch.as_tensor(epochs1d), 2.0,
                                          0.05, device_out=True, device=CPU)
        assert compile_counts().get("fit.acf1d_batch", 0) == before
        np.testing.assert_array_equal(again["tau"].numpy(), got["tau"])

    @pytest.mark.parametrize("bartlett, weighted", [(False, True),
                                                    (False, False)])
    def test_weighting_options(self, epochs1d, bartlett, weighted):
        kw = dict(bartlett=bartlett, weighted=weighted, n_iter=40)
        ref = jbatch.scint_params_batch(epochs1d[:3], 2.0, 0.05, **kw)
        got = tbatch.scint_params_batch(epochs1d[:3], 2.0, 0.05, device=CPU,
                                        **kw)
        for k in ("tau", "dnu", "amp"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)

    def test_pieces(self, epochs1d):
        """Cuts, weights and guesses against the JAX package's."""
        tc, fc = jbatch.acf_cuts_batch(epochs1d, backend="jax")
        tt, ft = tbatch.acf_cuts_batch(epochs1d, device=CPU)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tc), atol=1e-6)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fc), atol=1e-6)
        import jax.numpy as jnp

        for c_t, c_j, n in ((tt, tc, 64), (ft, fc, 96)):
            np.testing.assert_allclose(
                tbatch.bartlett_weights(c_t, n).numpy(),
                np.asarray(jbatch.bartlett_weights(c_j, n, xp=jnp)),
                rtol=1e-5)
        gj = jbatch.initial_guesses_batch(tc, fc, 2.0, 0.05, 128.0, 4.8, jnp)
        gt = tbatch.initial_guesses_batch(tt, ft, 2.0, 0.05, 128.0, 4.8)
        for a, b in zip(gt, gj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
        # an epoch with no lag below the threshold takes the fallbacks
        flat = torch.ones(2, 8, dtype=torch.float32)
        flat[1, 1] = -0.5
        tau, dnu, _, _ = tbatch.initial_guesses_batch(flat, flat, 2.0, 0.05,
                                                      16.0, 0.4)
        jt, jd, _, _ = jbatch.initial_guesses_batch(
            jnp.asarray(flat.numpy()), jnp.asarray(flat.numpy()), 2.0, 0.05,
            16.0, 0.4, jnp)
        np.testing.assert_array_equal(tau.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(dnu.numpy(), np.asarray(jd))

    def test_serve_quarantines_nan_lane(self, epochs1d):
        """``BAD_INPUT`` and NaN results for the poisoned lane; its
        neighbours bit for bit the clean run's, and within the 1-D
        tolerances of the JAX program's."""
        B, nf, nt = epochs1d.shape
        bad = epochs1d.copy()
        bad[2, 5, 7] = np.nan
        jp = jbatch.make_scint_params_serve(B, nf, nt, 2.0, 0.05)
        tp = tbatch.make_scint_params_serve(B, nf, nt, 2.0, 0.05, device=CPU)
        builds = compile_counts().get("fit.scint_params_serve", 0)
        assert tbatch.make_scint_params_serve(
            B, nf, nt, 2.0, 0.05, device=CPU) is tp
        assert compile_counts().get("fit.scint_params_serve", 0) == builds
        oj = {k: np.asarray(v) for k, v in jp(bad).items()}
        ot = {k: v.numpy() for k, v in tp(bad).items()}
        oc = {k: v.numpy() for k, v in tp(epochs1d).items()}
        assert ot["ok"].tolist() == oj["ok"].tolist() == [0, 0, 1, 0, 0, 0]
        assert oc["ok"].tolist() == [0] * B
        assert tguards.describe_health(ot["ok"][2]) == ["input_nonfinite"]
        for k in ot:
            if k == "ok":
                continue
            assert np.isnan(ot[k][2]), k
            for lane in (0, 1, 3, 4, 5):
                assert ot[k][lane].tobytes() == oc[k][lane].tobytes(), k
            rel = 1e-3 if k.endswith("err") else 1e-4
            np.testing.assert_allclose(ot[k], oj[k], rtol=rel, err_msg=k)
        with pytest.raises(ValueError):
            tp(epochs1d[:2])


def _fit_both(start_j, start_t, ys, **kw):
    rj, okj = jacf2d.fit_acf2d_batch(start_j, ys, None, n_iter=N_ITER, **kw)
    rt, okt = tacf2d.fit_acf2d_batch(start_t, ys, None, n_iter=N_ITER,
                                     device=CPU, **kw)
    return rj, okj, rt, okt


def _hold_fit(rt, rj, rel, names=("tau", "dnu", "amp", "phasegrad", "psi")):
    """Values at ``rel`` and stderrs at 10·``rel`` (a float32 covariance
    at "default"); phasegrad, which crosses zero and is smaller than its
    stderr on these epochs, within 10·``rel`` of that stderr."""
    for k in names:
        a, b = rj.params[k], rt.params[k]
        if np.isnan(a.value):
            assert np.isnan(b.value) and np.isnan(b.stderr), k
            continue
        tol = (10 * rel * max(abs(a.value), a.stderr) if k == "phasegrad"
               else rel * abs(a.value))
        assert abs(b.value - a.value) <= tol, (k, a.value, b.value)
        assert b.stderr == pytest.approx(a.stderr, rel=10 * rel), k
    if np.isfinite(rj.chisqr):
        assert rt.chisqr == pytest.approx(rj.chisqr, rel=rel)
    assert rt.nfree == rj.nfree
    if "highest" in rt.message:
        # the xtol exit of "default" decides on steps near float32's
        # resolution, so only "highest"'s iteration counts must agree
        assert rt.nfev == rj.nfev


class TestAcf2dFit:
    @pytest.mark.parametrize("precision, rel", [("highest", 1e-6),
                                                ("default", 1e-4)])
    def test_batch_with_quarantined_lanes(self, precision, rel):
        """Three epochs, one NaN and one +inf: equal ``ok`` codes
        (BAD_INPUT, and BAD_FIT for the lane whose steps go
        non-finite), NaN results there, the rest at the policy's
        tolerance."""
        ys = _acf2d_epochs(4, seed=30)
        ys[1] = np.nan
        ys[3] = np.inf
        kw = dict(tau=900.0, dnu=5.0, amp=0.8, psi=55.0)
        rj, okj, rt, okt = _fit_both(_acf2d_params(JParameters, **kw),
                                     _acf2d_params(TParameters, **kw), ys,
                                     precision=precision)
        assert okt.tolist() == okj.tolist()
        assert okt[0] == okt[2] == 0
        assert okt[1] & tguards.BAD_INPUT and okt[3] & tguards.BAD_FIT
        assert tguards.BAD_FIT == jguards.BAD_FIT
        assert "peakfit_refused" in tguards.describe_health(okt[3])
        for b in range(4):
            _hold_fit(rt[b], rj[b], rel)
            assert rt[b].ok == rj[b].ok
            np.testing.assert_allclose(rt[b].residual, rj[b].residual,
                                       rtol=0, atol=rel * 1e2)

    def test_single_fit_and_cache(self):
        """``fit_acf2d`` is the B = 1 lane and shares the batch's cache;
        a repeat of a configuration builds nothing."""
        ys = _acf2d_epochs(2, seed=22)
        kw = dict(tau=900.0, dnu=5.0)
        tstart = _acf2d_params(TParameters, **kw)
        tacf2d.fit_acf2d_batch(tstart, ys, None, n_iter=N_ITER, device=CPU)
        before = compile_counts().get("fit.acf2d_batch", 0)
        got = tacf2d.fit_acf2d(tstart, ys[0], None, n_iter=N_ITER, device=CPU)
        tacf2d.fit_acf2d_batch(tstart, ys + 1e-6, None, n_iter=N_ITER,
                               device=CPU)
        assert compile_counts().get("fit.acf2d_batch", 0) == before
        ref = jacf2d.fit_acf2d_tpu(_acf2d_params(JParameters, **kw), ys[0],
                                   None, n_iter=N_ITER)
        _hold_fit(got, ref, 1e-4)
        assert got.ok == 0

    def test_bucketed_crop_equals_exact_shape(self):
        """A 19² crop padded into the 25² bucket (zero-weight border,
        rescaled lag steps) gives the exact-shape fit's values; both at
        the JAX package's own."""
        ys17 = _acf2d_epochs(1, nc=17, seed=40)[0]
        ys19 = _acf2d_epochs(1, nc=19, seed=41)[0]
        kw = dict(tau=900.0, dnu=5.0)
        tp = [_acf2d_params(TParameters, nc=n, **kw) for n in (17, 19)]
        jp = [_acf2d_params(JParameters, nc=n, **kw) for n in (17, 19)]
        rt, okt = tacf2d.fit_acf2d_batch(tp, [ys17, ys19], None,
                                         n_iter=N_ITER, precision="highest",
                                         device=CPU)
        rj, _ = jacf2d.fit_acf2d_batch(jp, [ys17, ys19], None, n_iter=N_ITER,
                                       precision="highest")
        exact, _ = tacf2d.fit_acf2d_batch(tp[1:], [ys19], None,
                                          n_iter=N_ITER, precision="highest",
                                          bucket=False, device=CPU)
        assert okt.tolist() == [0, 0]
        for k in ("tau", "dnu", "psi"):
            assert rt[1].params[k].value == pytest.approx(
                exact[0].params[k].value, rel=1e-6), k
        assert rt[1].nfree == exact[0].nfree
        for b in range(2):
            _hold_fit(rt[b], rj[b], 1e-6)
        assert tacf2d.bucket_crop_size(19) == 25
        assert tacf2d.bucket_crop_size(301) == 301
        with pytest.raises(ValueError, match="static fit config"):
            p_b = _acf2d_params(TParameters)
            p_b["ar"].value = 3.0
            tacf2d.fit_acf2d_batch([_acf2d_params(TParameters), p_b],
                                   list(_acf2d_epochs(2)), device=CPU)

    def test_alpha_varies_and_dict_view(self):
        p_t = _acf2d_params(TParameters, tau=900.0, dnu=5.0)
        p_j = _acf2d_params(JParameters, tau=900.0, dnu=5.0)
        p_t["alpha"].vary = p_j["alpha"].vary = True
        ys = _acf2d_epochs(1, seed=50)
        rj, okj, rt, okt = _fit_both(p_j, p_t, ys)
        assert okt.tolist() == okj.tolist() == [0]
        _hold_fit(rt[0], rj[0], 1e-4, names=("tau", "dnu", "alpha"))
        ys2 = _acf2d_epochs(2, seed=70)
        ref = jbatch.scint_params_acf2d_batch(
            _acf2d_params(JParameters, tau=900.0, dnu=5.0), ys2,
            n_iter=N_ITER)
        got = tbatch.scint_params_acf2d_batch(
            _acf2d_params(TParameters, tau=900.0, dnu=5.0), ys2,
            n_iter=N_ITER, device=CPU)
        assert set(got) == set(ref)
        np.testing.assert_array_equal(got["ok"], ref["ok"])
        for k in ("tau", "dnu", "amp", "psi", "chisqr", "redchi"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)


def _simulated_dynspec():
    """One 48 × 48 spectrum from the JAX package's simulator, with
    times (10 s) and frequencies (0.5 MHz from 1400 MHz)."""
    d = np.asarray(simulate_dynspec_batch(1, ns=48, nf=48, seed=5))[0]
    return d.T.astype(float), 10.0 * np.arange(48), 1400 + 0.5 * np.arange(48)


_FACADE_KEYS = ("tau", "dnu", "amp", "wn", "tauerr", "dnuerr", "amperr",
                "tscat", "nscint", "dnu_est", "dnu_esterr", "tscat_est",
                "modulation_index")
_FIT_KEYS = ("talpha", "fse_tau", "fse_dnu")
_FACADE_2D_KEYS = ("phasegrad", "phasegraderr", "fse_phasegrad")


@pytest.fixture(scope="module")
def facades():
    dyn, times, freqs = _simulated_dynspec()
    jd = jdyn.Dynspec(dyn=jdyn.BasicDyn(dyn, times=times, freqs=freqs),
                      process=False, verbose=False, backend="jax")
    jd.calc_acf()
    jd.prep_thetatheta(cwf=48, cwt=48, eta_min=0.1, eta_max=0.9, npad=1)
    return dyn, times, freqs, jd


def _hold_facade(dt, dj, method, rel):
    keys = _FACADE_KEYS + (_FIT_KEYS if method != "nofit" else ())
    if method.startswith("acf2d"):
        keys += _FACADE_2D_KEYS
    if method == "acf2d":
        keys += ("ar", "theta", "psi", "psierr")
    for k in keys:
        a, b = getattr(dj, k), getattr(dt, k)
        # wn = 1 − amp after a fit: held on amp's scale
        tol = rel * abs(dj.amp) if k == "wn" and method != "nofit" else 1e-12
        assert b == pytest.approx(a, rel=rel, abs=tol), (method, k, a, b)
    assert dt.scint_param_method == dj.scint_param_method
    if method.startswith("acf2d"):
        assert dt.acf_model.shape == dj.acf_model.shape
        np.testing.assert_allclose(dt.acf_model, dj.acf_model, rtol=0,
                                   atol=rel * np.abs(dj.acf_model).max())


def _recorder(calls, side, fit):
    """Wrap a façade's acf2d fit so its inputs and result are kept."""
    def call(params, ydata, weights, **kw):
        res = fit(params, ydata, weights, **kw)
        calls[side] = (_state(params), np.array(ydata), np.array(weights),
                       res)
        return res
    return call


class TestFacade:
    """On these simulated spectra the façade's acf2d fit is degenerate in
    both packages: the reference's recipe puts a weight of 1e10 one cell
    off the white-noise spike of an odd crop (fftshift → [0][0] →
    ifftshift), so χ² is that cell's, ψ wanders over many turns and the
    trajectory follows rounding. So the acf2d fit itself
    is held to JAX in TestAcf2dFit, and here the façade's part: the crop,
    weights and start it hands the fit, and everything it derives from a
    result."""

    METHODS = ("nofit", "acf1d", "acf2d_approx")

    def test_shared_acf(self, facades, monkeypatch):
        """Both façades on the JAX side's ACF (``from_reference_state``):
        every stored value at rel 1e-6. For acf2d the port's fit returns
        the JAX fit's result, so what the façade derives from it (errors,
        ``acf_model`` on the device, ``ar``/``theta``/``psi``) is held
        too, and the fit's inputs must be the JAX façade's."""
        _, _, _, jd = facades
        state = {k: getattr(jd, k) for k in tdyn._STATE_KEYS
                 + tdyn._OBS_KEYS + ("acf", "name")}
        td = tdyn.Dynspec.from_reference_state(state, device=CPU)
        for m in self.METHODS:
            rj = jd.get_scint_params(method=m)
            rt = td.get_scint_params(method=m)
            assert (rt is None) == (rj is None)
            _hold_facade(td, jd, m, 1e-6)
            if rt is not None:
                assert td.report == jd.report
        calls = {}
        monkeypatch.setattr(jacf2d, "fit_acf2d_tpu", _recorder(
            calls, "jax", jacf2d.fit_acf2d_tpu))

        def carried(params, ydata, weights, **kw):
            r = calls["jax"][3]
            out = tfitter.MinimizerResult(
                TParameters.from_state(_state(r.params)),
                residual=r.residual, nfev=r.nfev)
            out.ok = r.ok
            return out
        monkeypatch.setattr(tdyn, "fit_acf2d",
                            _recorder(calls, "port", carried))
        jd.get_scint_params(method="acf2d")
        td.get_scint_params(method="acf2d")
        (pj, yj, wj, _), (pt, yt, wt, _) = calls["jax"], calls["port"]
        assert pt == pj
        np.testing.assert_array_equal(yt, yj)
        np.testing.assert_array_equal(wt, wj)
        _hold_facade(td, jd, "acf2d", 1e-6)
        jd.get_acf_tilt()
        td.get_acf_tilt()
        for k in ("acf_tilt", "acf_tilt_err", "fse_tilt"):
            _close(getattr(td, k), getattr(jd, k), 1e-6, k)
        # the tilt now seeds phasegrad of the 2-D fits
        jd.get_scint_params(method="acf2d_approx")
        td.get_scint_params(method="acf2d_approx")
        _hold_facade(td, jd, "acf2d_approx", 1e-6)
        state.update(acf_tilt=jd.acf_tilt, acf_tilt_err=jd.acf_tilt_err)
        td2 = tdyn.Dynspec.from_reference_state(state, device=CPU)
        assert (td2.acf_tilt, td2.acf_tilt_err) == (jd.acf_tilt,
                                                    jd.acf_tilt_err)

    def test_end_to_end(self, facades, monkeypatch):
        """Each package computes its own ACF: the tilt (which runs acf1d
        first), nofit, acf1d and acf2d_approx at rel 1e-3, and
        ``norm_sspec(fit_spectrum=True)``'s ``ps_*``; acf2d runs its own
        fit on each side, from inputs within the ACFs' float32 gap."""
        dyn, times, freqs, _ = facades
        jd = jdyn.Dynspec(dyn=jdyn.BasicDyn(dyn, times=times, freqs=freqs),
                          process=False, verbose=False, backend="jax")
        td = tdyn.Dynspec(dyn=tdyn.BasicDyn(dyn, times=times, freqs=freqs),
                          process=False, verbose=False, device=CPU)
        jd.get_acf_tilt()
        td.get_acf_tilt()
        assert td.scint_param_method == "acf1d"
        for k in ("acf_tilt", "acf_tilt_err"):
            _close(getattr(td, k), getattr(jd, k), 1e-3, k)
        for m in self.METHODS:
            jd.get_scint_params(method=m)
            td.get_scint_params(method=m)
            _hold_facade(td, jd, m, 1e-3)
        calls = {}
        monkeypatch.setattr(jacf2d, "fit_acf2d_tpu", _recorder(
            calls, "jax", jacf2d.fit_acf2d_tpu))
        monkeypatch.setattr(tdyn, "fit_acf2d", _recorder(
            calls, "port", tacf2d.fit_acf2d))
        jd.get_scint_params(method="acf2d")
        res = td.get_scint_params(method="acf2d")
        (pj, yj, wj, _), (pt, yt, wt, _) = calls["jax"], calls["port"]
        assert list(pt) == list(pj)
        for k in pj:
            _close(pt[k][0], pj[k][0], 1e-3, k)        # value
            assert pt[k][1:4] == pj[k][1:4], k         # vary, min, max
            _close(pt[k][4], pj[k][4], 1e-3, k)        # stderr
        np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(wt == 0, wj == 0)
        np.testing.assert_allclose(wt, wj, rtol=1e-5)
        assert res.ok == 0 and res is calls["port"][3]
        assert np.isfinite([td.tau, td.dnu, td.psi, td.phasegrad]).all()
        assert td.acf_model.shape == yt.shape
        for d in (jd, td):
            d.norm_sspec(eta=1.0, lamsteps=False, fit_spectrum=True,
                         numsteps=200)
        for k in ("ps_wn", "ps_amp", "ps_alpha", "ps_wn_err", "ps_amp_err",
                  "ps_alpha_err"):
            _close(getattr(td, k), getattr(jd, k), 1e-3, k)

    def test_scipy_route_of_the_2d_fit(self):
        """The acf2d scipy route (the façade's even-crop and restart
        path): ``minimize_leastsq`` over the analytic model, with the
        ACF built on the device each residual, at rel 1e-6."""
        ys = _acf2d_epochs(1, nc=9, seed=3)[0]
        out = []
        for P, mod, fit, args in (
                (JParameters, jmodels, jminimize, (ys, None)),
                (TParameters, tmodels, tfitter.minimize_leastsq,
                 (ys, None, CPU))):
            p = _acf2d_params(P, nc=9, tau=1000.0, dnu=4.5, amp=0.9,
                              psi=55.0)
            out.append(fit(mod.scint_acf_model_2d, p, args, max_nfev=60))
        for k in ("tau", "dnu", "amp", "psi"):
            _close(out[1].params[k].value, out[0].params[k].value, 1e-6, k)
        assert out[1].nfev == out[0].nfev
