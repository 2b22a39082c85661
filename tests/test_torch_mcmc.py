"""The port's posterior engine (``scintools_tpu_torch/mcmc``,
``fit/ensemble.py`` and ``fit.fitter.sample_emcee``) against the JAX
package's on the CPU: each likelihood kernel at the same point and data,
the walker init and the stretch-move chain fed the JAX package's own
normals and draws, the chain reductions, the host sampler bit for bit,
the façade's MCMC method, the posterior survey's stage on the JAX
factory's epochs, and the survey through the runner.

JAX runs under 64-bit mode (``tests/conftest.py``); the port's walkers
are float64 there too. Tolerances are stated per test."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scintools_tpu.mcmc import likelihood as jlik
from scintools_tpu.mcmc import posterior as jpost
from scintools_tpu.mcmc import sampler as jsamp
from scintools_tpu_torch.mcmc import likelihood as tlik
from scintools_tpu_torch.mcmc import posterior as tpost
from scintools_tpu_torch.mcmc import sampler as tsamp
from scintools_tpu_torch.robust import guards as tguards

CPU = "cpu"

REGIMES_2 = (
    {"name": "weak", "mb2": 0.5, "ar": 1.0, "psi": 0.0, "alpha": 5 / 3},
    {"name": "strong", "mb2": 16.0, "ar": 1.0, "psi": 0.0,
     "alpha": 5 / 3},
)


def _jax_lanes(build, x, data):
    """The JAX kernel over walkers and lanes: ``x[B, n, nd]``."""
    ll = build()
    return np.asarray(jax.vmap(jax.vmap(ll, in_axes=(0, None)))(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, data)))


def _port_lanes(build, x, data):
    ll = build(torch.device(CPU))
    data = tlik.tree_map(lambda v: torch.as_tensor(np.asarray(v)), data)
    return ll(torch.as_tensor(x), data).numpy()


def _acf1d_data(B=3, nt=32, nf=16, dt=8.0, df=0.4, seed=0):
    """Synthetic ACF cuts (the JAX bench's recipe) with their Bartlett-
    scale weights, float64."""
    tl, fl = dt * np.arange(nt), df * np.arange(nf)
    r = np.random.default_rng(seed)
    yts, yfs = [], []
    for _ in range(B):
        tau = 160.0 * (1 + 0.2 * r.random())
        dnu = 4.0 * (1 + 0.2 * r.random())
        yts.append(np.exp(-(tl / tau) ** (5 / 3)) * (1 - tl / tl.max())
                   + 0.02 * r.normal(size=nt))
        yfs.append(np.exp(-fl / (dnu / np.log(2))) * (1 - fl / fl.max())
                   + 0.02 * r.normal(size=nf))
    wt = np.full((B, nt), np.sqrt(nt / 2))
    wf = np.full((B, nf), np.sqrt(nf / 2))
    return (np.stack(yts), np.stack(yfs), wt, wf)


def _points(rng, B, n, x0, scale):
    return x0 + scale * rng.standard_normal((B, n, len(x0)))


class TestLikelihoods:
    """Each kernel's value at the same ``x`` and data, float64: rtol
    1e-10 where the model is closed-form."""

    @pytest.mark.parametrize("is_weighted", [False, True])
    def test_acf1d(self, is_weighted):
        args = (32, 16, 8.0, 0.4)
        jb, jn, jlo, jhi, jkey = jlik.make_acf1d_loglike(
            *args, is_weighted=is_weighted)
        tb, tn, tlo, thi, tkey = tlik.make_acf1d_loglike(
            *args, is_weighted=is_weighted)
        assert (jn, jkey) == (tn, tkey)
        np.testing.assert_array_equal(jlo, tlo)
        np.testing.assert_array_equal(jhi, thi)
        x0 = np.array([150.0, 4.0, 1.0, np.log(0.05)])[:len(tn)]
        x = _points(np.random.default_rng(1), 3, 8, x0,
                    np.abs(x0) * 0.2 + 0.1)
        data = _acf1d_data()
        np.testing.assert_allclose(_port_lanes(tb, x, data),
                                   _jax_lanes(jb, x, data), rtol=1e-10)

    def test_acf2d(self):
        """The analytic-ACF kernel at the ``"highest"`` policy (the model
        held at 1e-9 of its peak in test_torch_scint.py): the
        log-likelihood within rtol 1e-6."""
        nc, nf = 9, 7
        dt, df = 2 * 3600 / 33, 2 * 32 / 33
        args = (nc, nf, 2.0, 5 / 3, 10.0, 1200.0, dt)
        jb, jn, _, _, jkey = jlik.make_acf2d_loglike(*args,
                                                     precision="highest")
        tb, tn, _, _, tkey = tlik.make_acf2d_loglike(*args,
                                                     precision="highest")
        assert (jn, jkey) == (tn, tkey)
        rng = np.random.default_rng(2)
        truth = np.array([1200.0, 4.0, 1.0, 0.2, 60.0, 0.05])
        from scintools_tpu.sim.acf_model import make_acf2d_model_core

        core = make_acf2d_model_core(*args, precision="highest")
        y = np.asarray(core(*truth, dt, df))
        y = np.stack([y + 0.01 * rng.standard_normal(y.shape)
                      for _ in range(2)])
        w = np.ones_like(y)
        data = (y, w, np.full(2, dt), np.full(2, df))
        x = _points(rng, 2, 4, truth, np.abs(truth) * 0.05 + 0.01)
        np.testing.assert_allclose(_port_lanes(tb, x, data),
                                   _jax_lanes(jb, x, data), rtol=1e-6)

    def test_eta_profile(self):
        """The per-lane interpolation keeps ``jnp.interp``'s rules: a
        point on the last node, points outside the grid (edge values)
        and between nodes."""
        H = 12
        rng = np.random.default_rng(3)
        eta_row = np.sort(rng.uniform(0.2, 5.0, (3, H)), axis=1)
        profile = rng.normal(size=(3, H)).astype(np.float32)
        eta_row = eta_row.astype(np.float32)
        pmax = profile.max(axis=1)
        noise = np.array([0.3, 0.5, 0.7], np.float32)
        x = rng.uniform(0.0, 6.0, (3, 9, 1))
        x[:, 0, 0] = eta_row[:, -1]
        x[:, 1, 0] = eta_row[:, 0]
        x[:, 2, 0] = eta_row[:, 4]
        jb, jn, _, _, jkey = jlik.make_eta_profile_loglike(H)
        tb, tn, _, _, tkey = tlik.make_eta_profile_loglike(H)
        assert (jn, jkey) == (tn, tkey)
        data = (profile, eta_row, pmax, noise)
        np.testing.assert_allclose(_port_lanes(tb, x, data),
                                   _jax_lanes(jb, x, data), rtol=1e-10)

    @pytest.mark.parametrize("is_weighted", [True, False])
    def test_model_loglike_scint_acf(self, is_weighted):
        from scintools_tpu.fit import models as jm
        from scintools_tpu.fit.parameters import Parameters as JP
        from scintools_tpu_torch.fit import models as tm
        from scintools_tpu_torch.fit.parameters import Parameters as TP

        def params(P):
            p = P()
            p.add("tau", 150.0, True, 0, np.inf)
            p.add("dnu", 4.0, True, 0, np.inf)
            p.add("amp", 1.0, True, 0, np.inf)
            p.add("alpha", 5 / 3, False)
            return p

        yt, yf, wt, wf = (a[:2] for a in _acf1d_data(B=2))
        data = ((np.tile(8.0 * np.arange(32), (2, 1)),
                 np.tile(0.4 * np.arange(16), (2, 1))), (yt, yf), (wt, wf))
        jb, jn, jlo, jhi, _ = jlik.make_model_loglike(
            jm.scint_acf_model, params(JP), is_weighted=is_weighted)
        tb, tn, tlo, thi, _ = tlik.make_model_loglike(
            tm.scint_acf_model, params(TP), is_weighted=is_weighted)
        assert jn == tn
        np.testing.assert_array_equal(jlo, tlo)
        x0 = np.array([150.0, 4.0, 1.0, np.log(0.05)])[:len(tn)]
        x = _points(np.random.default_rng(4), 2, 6, x0,
                    np.abs(x0) * 0.2 + 0.1)
        np.testing.assert_allclose(_port_lanes(tb, x, data),
                                   _jax_lanes(jb, x, data), rtol=1e-10)

    @staticmethod
    def _velocity_params(P, name, vary):
        p = P()
        for k, v in (("d", 0.157), ("s", 0.7), ("KIN", 137.6),
                     ("KOM", 207.0), ("PB", 5.741), ("A1", 3.3667),
                     ("ECC", 1.9e-5), ("OM", 1.2), ("T0", 55000.0),
                     ("PMRA", 121.4), ("PMDEC", -71.5)):
            p.add(k, v, k in vary)
        if name == "arc_curvature":
            p.add("zeta", 30.0, "zeta" in vary)
        else:
            p.add("R", 0.4, "R" in vary, 0, 1)
            p.add("psi", 40.0, "psi" in vary)
            p.add("vism_ra", 5.0, "vism_ra" in vary)
            p.add("vism_dec", -3.0, "vism_dec" in vary)
        return p

    @staticmethod
    def _velocity_data(rng, n=20):
        return tuple(np.tile(v, (2, 1)) for v in (
            rng.uniform(0.5, 2.0, n), np.full(n, 3.0),
            rng.uniform(0, 2 * np.pi, n), rng.uniform(-30, 30, n),
            rng.uniform(-30, 30, n), 55000 + np.arange(n, dtype=float)))

    @pytest.mark.parametrize("name, vary", [
        ("arc_curvature", ("d", "s", "KIN", "zeta")),
        ("veff_thin_screen", ("KIN", "vism_ra", "vism_dec"))])
    def test_velocity_models(self, name, vary):
        """Against the JAX kernel, over the parameters its models take as
        traced values (it applies numpy to KOM, R, psi and the thin
        screen's d and s, so those stay fixed here)."""
        from scintools_tpu.fit.parameters import Parameters as JP
        from scintools_tpu_torch.fit.parameters import Parameters as TP

        rng = np.random.default_rng(5)
        data = self._velocity_data(rng)
        jb, jn, _, _, _ = jlik.velocity_model_loglike(
            name, self._velocity_params(JP, name, vary))
        tb, tn, _, _, _ = tlik.velocity_model_loglike(
            name, self._velocity_params(TP, name, vary))
        assert jn == tn
        x0 = np.array([self._velocity_params(TP, name, vary)[k].value
                       for k in tn])
        x = _points(rng, 2, 5, x0, np.abs(x0) * 0.01)
        np.testing.assert_allclose(_port_lanes(tb, x, data),
                                   _jax_lanes(jb, x, data), rtol=1e-10)
        with pytest.raises(ValueError, match="model_name"):
            tlik.velocity_model_loglike("veff", self._velocity_params(
                TP, name, vary))

    @pytest.mark.parametrize("name, vary", [
        ("arc_curvature", ("d", "s", "KIN", "KOM", "zeta")),
        ("veff_thin_screen", ("d", "s", "KIN", "KOM", "R", "psi"))])
    def test_velocity_models_every_parameter(self, name, vary):
        """Every parameter may vary under the port's sampler: the kernel
        at each walker equals the float64 host model at that walker's
        values (rtol 1e-12)."""
        from scintools_tpu_torch.fit import models as tm
        from scintools_tpu_torch.fit.parameters import Parameters as TP

        rng = np.random.default_rng(8)
        data = self._velocity_data(rng)
        p = self._velocity_params(TP, name, vary)
        tb, tn, _, _, _ = tlik.velocity_model_loglike(name, p)
        x0 = np.array([p[k].value for k in tn])
        x = _points(rng, 2, 3, x0, np.abs(x0) * 0.01)
        got = _port_lanes(tb, x, data)
        for b in range(2):
            for w in range(3):
                r = getattr(tm, name)(p.with_values(x[b, w]),
                                      *(d[b] for d in data))
                assert got[b, w] == pytest.approx(-0.5 * np.sum(r * r),
                                                  rel=1e-12)

    def test_inclination_sense_branch(self):
        """``_inclination``'s ``sense`` flip as ``torch.where`` on tensors:
        the host float branch's value on each side of π/2."""
        from scintools_tpu_torch.fit.models import _inclination

        for kin in (60.0, 120.0):
            for sense in (0.2, 0.8):
                host = _inclination({"KIN": kin, "sense": sense})
                dev = _inclination({"KIN": torch.tensor(
                    [kin], dtype=torch.float64), "sense": sense})
                assert float(dev[0]) == pytest.approx(host, rel=1e-15)

    def test_model_data_key(self):
        key = tlik.model_data_key(("m",), ((np.zeros((1, 3)), None),))
        assert key == tlik.model_data_key(("m",), ((np.ones((1, 3)), None),))
        assert key != tlik.model_data_key(("m",), ((np.ones((1, 4)), None),))


def _jax_draws(seeds, steps, half, a=2.0):
    """The JAX package's stretch draws (sampler.py:85-104) in the port's
    layout: per lane ``split(key, steps)``, per step ``split(k)`` →
    (k1, k2), each ``split(·, 3)`` → uniform, randint, uniform."""
    keys = jsamp.lane_keys(seeds, salt=2)

    def half_draws(k):
        ku, kp, ka = jax.random.split(k, 3)
        return (jax.random.uniform(ku, (half,)),
                jax.random.randint(kp, (half,), 0, half),
                jax.random.uniform(ka, (half,)))

    def lane(key):
        def step(k):
            k1, k2 = jax.random.split(k)
            d1, d2 = half_draws(k1), half_draws(k2)
            return tuple(jnp.stack([u, v]) for u, v in zip(d1, d2))

        return jax.vmap(step)(jax.random.split(key, steps))

    u_z, partners, u_acc = (np.asarray(v) for v in jax.vmap(lane)(keys))
    return {"z": torch.tensor(((a - 1.0) * u_z + 1.0) ** 2 / a),
            "partners": torch.tensor(partners.astype(np.int64)),
            "u_acc": torch.tensor(u_acc)}


@pytest.fixture(scope="module")
def fed_chain():
    """One B = 3 acf1d run, lane 1 NaN, 16 walkers × 100 steps, float64,
    through both packages from the same walkers and draws."""
    nt, nf, dt, df = 32, 16, 8.0, 0.4
    nw, steps, seeds = 16, 100, [5, 6, 7]
    data = _acf1d_data(nt=nt, nf=nf, dt=dt, df=df)
    data[0][1, 3] = np.nan
    x0 = np.tile(np.array([100.0, 3.0, 1.0, np.log(0.1)]), (3, 1))
    jb, _, lo, hi, key = jlik.make_acf1d_loglike(nt, nf, dt, df)
    tb, _, _, _, _ = tlik.make_acf1d_loglike(nt, nf, dt, df)
    pos0 = np.asarray(jsamp.walker_init(
        jsamp.lane_keys(seeds, salt=1), jnp.asarray(x0), lo, hi, nw))
    jrun = jsamp.ensemble_program(jb, key, nw, 4)
    jout = jrun(jsamp.lane_keys(seeds, salt=2), jnp.asarray(pos0),
                jnp.asarray(lo), jnp.asarray(hi), jnp.ones((3,)),
                tuple(jnp.asarray(d) for d in data), steps)
    trun = tsamp.ensemble_program(tb, key, nw, 4, device=CPU)
    tout = trun(_jax_draws(seeds, steps, nw // 2), torch.tensor(pos0),
                lo, hi, torch.ones(3, dtype=torch.float64),
                tsamp.to_lanes(data, CPU), steps)
    return jout, tout


class TestSampler:
    def test_walker_init_from_jax_normals(self):
        """rtol 1e-12 from the same normals."""
        seeds, nw = [3, 4], 10
        x0 = np.array([[100.0, 3.0, 1.0, -2.0], [50.0, 0.0, 1e-9, 0.5]])
        lo = np.array([0.008, 4e-4, 1e-8, -np.inf])
        hi = np.array([np.inf, np.inf, np.inf, np.inf])
        keys = jsamp.lane_keys(seeds, salt=1)
        want = np.asarray(jsamp.walker_init(keys, jnp.asarray(x0), lo, hi,
                                            nw, rel_jitter=0.05))
        normals = np.asarray(jax.vmap(
            lambda k: jax.random.normal(k, (nw, 4)))(keys))
        got = tsamp.walker_init(torch.tensor(normals), x0, lo, hi,
                                rel_jitter=0.05).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12)

    def test_chain_fed_jax_draws(self, fed_chain):
        """Positions rtol 1e-9, identical acceptance counts and health
        bits; the NaN lane is condemned and frozen."""
        jout, tout = fed_chain
        np.testing.assert_allclose(tout["chain"].numpy(),
                                   np.asarray(jout["chain"]), rtol=1e-9)
        np.testing.assert_array_equal(tout["acc_frac"].numpy(),
                                      np.asarray(jout["acc_frac"]))
        ok = tout["ok"].numpy()
        np.testing.assert_array_equal(ok, np.asarray(jout["ok"]))
        assert ok[1] & tguards.BAD_INPUT and ok[1] & tguards.BAD_FIT
        assert ok[0] == ok[2] == 0
        np.testing.assert_allclose(tout["loglike"].numpy()[[0, 2]],
                                   np.asarray(jout["loglike"])[[0, 2]],
                                   rtol=1e-9)

    def test_summarize_posterior_on_a_jax_chain(self, fed_chain):
        """Quantiles, mean and std rtol 1e-10; ESS and R̂ rtol 1e-8 on the
        healthy lanes (the NaN lane's chain is frozen, so its
        autocorrelation is rounding noise in either package); ranks
        exact; the evidence integral the same."""
        jout, _ = fed_chain
        truths = np.tile([150.0, 4.0, 1.0, np.nan], (3, 1))
        want = jpost.summarize_posterior(jout, burn=0.3, truths=truths)
        tin = {k: torch.tensor(np.asarray(v)) for k, v in jout.items()}
        got = tpost.summarize_posterior(tin, burn=0.3, truths=truths)
        assert set(got) == set(want)
        for k in ("q025", "q16", "q50", "q84", "q975", "mean", "std",
                  "mean_loglike"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-10,
                                       err_msg=k)
        for k in ("ess", "rhat"):
            np.testing.assert_allclose(got[k][[0, 2]], want[k][[0, 2]],
                                       rtol=1e-8, err_msg=k)
        # JAX takes the mean of a bool mask in float32: compare the counts
        n = 70 * 16
        np.testing.assert_array_equal(np.round(got["rank"] * n),
                                      np.round(want["rank"] * n))
        ll = np.array([[0.0, -1.0, -2.0], [-3.0, -1.5, -0.2]])
        betas = np.array([1.0, 0.5, 0.0])
        np.testing.assert_array_equal(tpost.log_evidence(ll, betas),
                                      jpost.log_evidence(ll, betas))
        flat = np.asarray(jout["chain"])[0].reshape(-1, 4)
        np.testing.assert_array_equal(
            json.dumps(tpost.flatchain_summary(flat, list("abcd"),
                                               {"a": 120.0}), default=str),
            json.dumps(jpost.flatchain_summary(flat, list("abcd"),
                                               {"a": 120.0}), default=str))

    def test_quantiles_chunked_over_lanes(self, monkeypatch):
        """Lanes past ``torch.quantile``'s size limit reduce in chunks,
        every sample kept: the same quantiles as one call."""
        rng = np.random.default_rng(6)
        out = {"chain": torch.as_tensor(rng.normal(size=(5, 20, 4, 2))),
               "loglike": torch.zeros((5, 20, 4), dtype=torch.float64),
               "acc_frac": torch.zeros(5), "ok": torch.zeros(5)}
        whole = tpost.summarize_posterior(out, burn=0.0)
        monkeypatch.setattr(tpost, "QUANTILE_MAX_ELEMENTS", 2 * 20 * 4 * 2)
        monkeypatch.setattr(tpost, "_POSTERIOR_CACHE", {})
        parts = tpost.summarize_posterior(out, burn=0.0)
        np.testing.assert_array_equal(parts["q50"], whole["q50"])

    def test_batched_lane_bitwise_its_b1_run(self):
        """A batched lane's chain and log-probabilities bitwise equal its
        B = 1 run with the same seed (port only)."""
        nt, nf, dt, df = 32, 16, 8.0, 0.4
        tb, _, lo, hi, key = tlik.make_acf1d_loglike(nt, nf, dt, df)
        data = _acf1d_data(nt=nt, nf=nf, dt=dt, df=df)
        x0 = np.tile(np.array([100.0, 3.0, 1.0, np.log(0.1)]), (3, 1))
        kw = dict(nwalkers=8, steps=60, device=CPU)
        out = tsamp.run_ensemble_batched(tb, key, data, x0, lo, hi,
                                         seeds=[5, 6, 7], **kw)
        one = tsamp.run_ensemble_batched(
            tb, key, tuple(d[1:2] for d in data), x0[1:2], lo, hi,
            seeds=[6], **kw)
        assert torch.equal(out["chain"][1], one["chain"][0])
        assert torch.equal(out["logp"][1], one["logp"][0])

    def test_nwalkers_must_be_even(self):
        tb, _, lo, hi, key = tlik.make_acf1d_loglike(8, 8, 1.0, 1.0)
        with pytest.raises(ValueError, match="even"):
            tsamp.run_ensemble_batched(
                tb, ("odd", key), _acf1d_data(B=1, nt=8, nf=8), np.ones(
                    (1, 4)), lo, hi, nwalkers=7, steps=2, device=CPU)

    def test_draws_independent_of_grouping(self):
        a = tsamp.draw_stretch([4, 9], 5, 3, device=CPU)
        b = tsamp.draw_stretch([9], 5, 3, device=CPU)
        for k in a:
            assert torch.equal(a[k][1], b[k][0])

    def test_evidence_tempered_lanes_analytic(self):
        """ln Z of a 1-D Gaussian under a uniform box within 0.2 of the
        analytic value (the JAX test's gate)."""
        from scintools_tpu_torch.mcmc.survey import model_evidence_batched

        def build(dev):
            def loglike(x, data):
                mu, sig = data
                return -0.5 * (((x - mu[:, None]) / sig[:, None]) ** 2
                               ).sum(-1)
            return loglike

        a = 4.0
        sig = np.array([0.3, 0.5])
        logz, mean_ll, _ = model_evidence_batched(
            build, ("gauss", 1), (np.zeros((2, 1)), sig[:, None]),
            x0=np.zeros((2, 1)), lo=np.array([-a]), hi=np.array([a]),
            betas=np.linspace(0, 1, 16) ** 3, nwalkers=16, steps=400,
            burn=0.5, seeds=[3, 4], device=CPU)
        expect = np.log(np.sqrt(2 * np.pi) * sig / (2 * a))
        assert mean_ll.shape == (2, 16)
        assert np.allclose(logz, expect, atol=0.2), (logz, expect)
        with pytest.raises(ValueError, match="finite"):
            model_evidence_batched(build, ("gauss", 1), (np.zeros((1, 1)),
                                                         np.ones((1, 1))),
                                   x0=np.zeros((1, 1)),
                                   lo=np.array([-np.inf]),
                                   hi=np.array([np.inf]), device=CPU)


class TestSamplers:
    def _fit_args(self):
        data = _acf1d_data(B=1)
        return ((8.0 * np.arange(32), 0.4 * np.arange(16)),
                (data[0][0], data[1][0]), (data[2][0], data[3][0]))

    def _params(self, P):
        p = P()
        p.add("tau", 150.0, True, 1e-3, np.inf)
        p.add("dnu", 4.0, True, 1e-3, np.inf)
        p.add("amp", 1.0, True, 1e-8, np.inf)
        p.add("alpha", 5 / 3, False)
        return p

    @pytest.mark.parametrize("is_weighted", [True, False])
    def test_sample_emcee_bitwise(self, is_weighted):
        import importlib

        from scintools_tpu.fit import models as jm
        from scintools_tpu.fit.parameters import Parameters as JP
        from scintools_tpu_torch.fit import models as tm
        from scintools_tpu_torch.fit.parameters import Parameters as TP

        # ``fit.fitter`` is the function in both namespaces
        jf = importlib.import_module("scintools_tpu.fit.fitter")
        tf = importlib.import_module("scintools_tpu_torch.fit.fitter")

        kw = dict(nwalkers=10, steps=40, burn=0.2, thin=2, seed=7,
                  is_weighted=is_weighted)
        want = jf.sample_emcee(jm.scint_acf_model, self._params(JP),
                               self._fit_args(), **kw)
        got = tf.sample_emcee(tm.scint_acf_model, self._params(TP),
                              self._fit_args(), **kw)
        np.testing.assert_array_equal(got.flatchain, want.flatchain)
        assert got.var_names == want.var_names
        assert got.chisqr == want.chisqr and got.redchi == want.redchi
        np.testing.assert_array_equal(got.covar, want.covar)

    def test_host_sampler_lets_kernel_errors_through(self):
        """A model that raises scores −inf on the host sampler, as in the
        JAX package, unless the error is a kernel error or a device
        fault, which propagates."""
        import importlib

        from scintools_tpu_torch.backend import KernelError
        from scintools_tpu_torch.fit.parameters import Parameters as TP

        tf = importlib.import_module("scintools_tpu_torch.fit.fitter")
        p = TP()
        p.add("a", 1.0, True, 0.0, 2.0)
        lo, hi = p.varying_bounds()

        def raising(exc):
            def model(params, x):
                raise exc
            return model

        assert tf._log_prob(raising(ValueError("bad")), p, (np.ones(3),),
                            np.array([1.0]), lo, hi) == -np.inf
        with pytest.raises(KernelError):
            tf.sample_emcee(raising(KernelError("no card")), p,
                            (np.ones(3),), nwalkers=4, steps=2)

    def test_sample_emcee_jax_is_the_device_lane(self):
        """The device sampler's walkers are the JAX package's recipe bit
        for bit (``pos``); its result has the sampler contract, and two
        same-shaped epochs share one built sampler."""
        from scintools_tpu_torch.fit import ensemble as te
        from scintools_tpu_torch.fit import models as tm
        from scintools_tpu_torch.fit.fitter import initial_walkers
        from scintools_tpu_torch.fit.parameters import Parameters as TP
        from scintools_tpu_torch.obs import retrace

        res = te.sample_emcee_jax(tm.scint_acf_model, self._params(TP),
                                  self._fit_args(), nwalkers=12, steps=80,
                                  seed=3, device=CPU)
        assert res.flatchain.shape == (((80 - 16) + 9) // 10 * 12, 3)
        assert 0 < res.acceptance_fraction < 1
        assert res.var_names == ["tau", "dnu", "amp"]
        args2 = list(self._fit_args())
        args2[1] = (args2[1][0] * 0.9, args2[1][1])
        with retrace.retrace_guard(sites=["mcmc.sampler"]):
            te.sample_emcee_jax(tm.scint_acf_model, self._params(TP),
                                tuple(args2), nwalkers=12, steps=80,
                                seed=4, device=CPU)
        from scintools_tpu.fit.parameters import Parameters as JP

        rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
        pj = self._params(JP)
        lo, hi = pj.varying_bounds()
        x0 = pj.varying_values()
        scale = np.where(np.isfinite(hi - lo), (hi - lo) * 1e-2,
                         1e-4 * np.maximum(np.abs(x0), 1.0))
        want = np.clip(x0 + scale * rng_j.standard_normal((12, 3)), lo, hi)
        got = initial_walkers(rng_t, self._params(TP), 12)[0]
        np.testing.assert_array_equal(got, want)
        with pytest.raises(ValueError, match="even"):
            te.sample_emcee_jax(tm.scint_acf_model, self._params(TP),
                                self._fit_args(), nwalkers=11, steps=2,
                                device=CPU)

    def test_make_ensemble_sampler_and_logp(self):
        from scintools_tpu_torch.fit import ensemble as te
        from scintools_tpu_torch.fit import models as tm
        from scintools_tpu_torch.fit.parameters import Parameters as TP

        mu = torch.tensor([1.0, -2.0], dtype=torch.float64)

        def logp(x):
            return -0.5 * ((x - mu) ** 2).sum(-1)

        run = te.make_ensemble_sampler(logp, nwalkers=12, ndim=2,
                                       device=CPU)
        pos0 = mu + 0.1 * torch.as_tensor(
            np.random.default_rng(0).standard_normal((12, 2)))
        chain, logps, acc = run(7, pos0, 200)
        assert chain.shape == (200, 12, 2) and logps.shape == (200, 12)
        chain2, _, _ = te.make_ensemble_sampler(
            logp, nwalkers=12, ndim=2, device=CPU)(7, pos0, 200)
        assert torch.equal(chain, chain2)
        lp, names = te.make_logp(tm.scint_acf_model, self._params(TP),
                                 self._fit_args(), device=CPU)
        assert names == ["tau", "dnu", "amp"]
        vals = lp(torch.tensor([[150.0, 4.0, 1.0], [150.0, 4.0, -1.0]],
                               dtype=torch.float64))
        assert torch.isfinite(vals[0]) and vals[1] == -np.inf


class TestFacade:
    def test_get_scint_params_method_mcmc(self):
        """``tests/test_mcmc.py``'s epoch through both façades: the same
        asserts, and each q50 of the port inside the JAX run's q16–q84."""
        from scintools_tpu.dynspec import BasicDyn as JB
        from scintools_tpu.dynspec import Dynspec as JD
        from scintools_tpu.sim.factory import simulate_scenarios
        from scintools_tpu_torch.dynspec import BasicDyn as TB
        from scintools_tpu_torch.dynspec import Dynspec as TD

        dyn = np.asarray(simulate_scenarios(
            1, mb2=16.0, ns=64, nf=32, dlam=0.05, rf=1.0, ds=0.02,
            seed=11))[0].T
        times = 30.0 * np.arange(dyn.shape[1])
        freqs = np.linspace(1400, 1400 * 1.05, dyn.shape[0])
        kw = dict(method="mcmc", nwalkers=16, steps=150, burn=0.3,
                  progress=False)
        j = JD(dyn=JB(dyn, name="mcmc_t", times=times, freqs=freqs,
                      mjd=60000), verbose=False, process=False,
               backend="jax")
        j.get_scint_params(**kw)
        t = TD(dyn=TB(dyn, name="mcmc_t", times=times, freqs=freqs,
                      mjd=60000), verbose=False, process=False, device=CPU)
        res = t.get_scint_params(**kw)
        assert t.scint_param_method == "mcmc"
        assert hasattr(res, "flatchain")
        for name in ("tau", "dnu", "amp"):
            rec = t.mcmc_summary[name]
            assert rec["q16"] <= rec["q50"] <= rec["q84"]
            ref = j.mcmc_summary[name]
            assert ref["q16"] <= rec["q50"] <= ref["q84"], (name, rec, ref)
        assert np.isfinite(t.tau) and np.isfinite(t.dnu)
        assert t.tau > 0 and t.dnu > 0

    def test_mcmc_2d_routes(self):
        """``mcmc=True`` samples the 2-D fits too (the ``__lnsigma`` term
        by default); the acf2d route samples the analytic model, not the
        LM."""
        from scintools_tpu.sim.factory import simulate_scenarios
        from scintools_tpu_torch.dynspec import BasicDyn as TB
        from scintools_tpu_torch.dynspec import Dynspec as TD

        dyn = np.asarray(simulate_scenarios(
            1, mb2=16.0, ns=64, nf=32, dlam=0.05, rf=1.0, ds=0.02,
            seed=11))[0].T
        t = TD(dyn=TB(dyn, times=30.0 * np.arange(64),
                      freqs=np.linspace(1400, 1470, 32)), verbose=False,
               process=False, device=CPU)
        res = t.get_scint_params(method="acf2d_approx", mcmc=True,
                                 nwalkers=8, steps=30, progress=False)
        assert res.var_names[-1] == "__lnsigma"
        res = t.get_scint_params(method="acf2d", mcmc=True, nwalkers=8,
                                 steps=6, progress=False)
        assert "psi" in res.var_names and res.flatchain is not None
        assert np.isfinite(t.tau) and t.tau > 0


@pytest.fixture(scope="module")
def survey_pair():
    """The JAX workload's rows and the port's stage on the JAX factory's
    epochs: 2 regimes × 2 epochs of 64 × 32, 16 walkers × 200 steps."""
    from scintools_tpu.mcmc.survey import mcmc_scenario_workload as jwl
    from scintools_tpu.sim.factory import (lane_keys_from_seeds,
                                           simulate_scenarios)
    from scintools_tpu_torch.mcmc.survey import mcmc_scenario_workload

    kw = dict(regimes=REGIMES_2, epochs_per_regime=2, ns=64, nf=32,
              nwalkers=16, steps=200, numsteps=600)
    jw = jwl(**kw)
    payloads = [p for _, p in jw["epochs"]]
    rows = jw["process_batch"](payloads)
    dyn, _ = simulate_scenarios(
        4, mb2=[p["mb2"] for p in payloads],
        ar=[p["ar"] for p in payloads], psi=[p["psi"] for p in payloads],
        alpha=[p["alpha"] for p in payloads], ns=64, nf=32, dlam=0.05,
        rf=1.0, ds=0.02, inner=0.001,
        keys=lane_keys_from_seeds([p["seed"] for p in payloads]),
        with_ok=True, device_out=True)
    dyns = np.asarray(jnp.transpose(dyn, (0, 2, 1)))
    tw = mcmc_scenario_workload(device=CPU, **kw)
    return jw, tw, payloads, rows, dyns


class TestSurvey:
    def test_stage_inputs_against_jax(self, survey_pair):
        """The sampler's inputs from the JAX factory's epochs: cuts,
        Bartlett weights and start points rtol 1e-5; the arc fits'
        profiles within 1e-5 of their span, η rtol 1e-4."""
        from scintools_tpu.fit.batch import (acf_cuts_batch as jcuts,
                                             bartlett_weights as jbw,
                                             initial_guesses_batch as jig)
        from scintools_tpu.ops.fitarc import fit_arc_batch as jfab
        from scintools_tpu.ops.sspec import sspec_axes
        from scintools_tpu.sim.scenario import make_sspec_db_batch
        from scintools_tpu_torch.fit.batch import (acf_cuts_batch,
                                                   bartlett_weights,
                                                   initial_guesses_batch)
        from scintools_tpu_torch.mcmc.survey import _truths

        _, tw, payloads, _, dyns = survey_pair
        nt, nf, dt = 64, 32, 30.0
        df = 1400.0 * 0.05 / (nf - 1)
        jt, jf = jcuts(jnp.asarray(dyns))
        tt, tf_ = acf_cuts_batch(dyns, device=CPU)
        for a, b, n in ((jt, tt, nt), (jf, tf_, nf)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(bartlett_weights(b, n).numpy(),
                                       np.asarray(jbw(a, n, xp=jnp)),
                                       rtol=1e-5)
        jx = jig(jt, jf, dt, df, nt * dt, nf * df, jnp)
        tx = initial_guesses_batch(tt, tf_, dt, df, nt * dt, nf * df)
        for a, b in zip(jx[:3], tx[:3]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5)
        etas = np.array([_truths(p, 1.0, 0.02, dt, 1400.0, 0.05)["eta"]
                         for p in payloads])
        fdop, tdel, _ = sspec_axes(nf, nt, dt, df)
        sec = make_sspec_db_batch(nt, nf)(jnp.asarray(dyns))
        want = jfab(np.asarray(sec), tdel, fdop, numsteps=600,
                    etamin=0.2 * etas, etamax=5.0 * etas,
                    sspecs_device=sec, full_output=True)
        got = tw["fit_stack"](torch.as_tensor(dyns), etas)
        for a, b in zip(want, got):
            assert b.eta == pytest.approx(a.eta, rel=1e-4)
            np.testing.assert_array_equal(b.eta_array, a.eta_array)
            span = np.ptp(a.profile)
            np.testing.assert_allclose(b.profile, a.profile, rtol=0,
                                       atol=1e-5 * span)
            assert b.noise == pytest.approx(a.noise, rel=1e-5)

    def test_posteriors_against_jax(self, survey_pair):
        """On the JAX factory's epochs the port's medians of τ, Δν and η
        lie within half the JAX lane's q84 − q16 on at least 90% of the
        lanes (two independent samplers: statistical agreement)."""
        _, tw, payloads, rows, dyns = survey_pair
        summ, summ_eta, truths, etas_ref = tw["sample_stack"](
            torch.as_tensor(dyns), payloads, [p["seed"] for p in payloads])
        assert np.all(summ["ok"] == 0) and np.all(summ_eta["ok"] == 0)
        close = []
        for i, row in enumerate(rows):
            got = (summ["q50"][i, 0], summ["q50"][i, 1],
                   summ_eta["q50"][i, 0] * etas_ref[i])
            for name, g in zip(("tau", "dnu", "eta"), got):
                half = 0.5 * (row[f"{name}_q84"] - row[f"{name}_q16"])
                close.append(abs(g - row[f"{name}_q50"]) <= half)
                assert row[f"{name}_true"] == pytest.approx(
                    truths[i][name], rel=1e-12)
        assert np.mean(close) >= 0.9, close

    def test_flagged_lane_against_jax(self):
        """The default workload's lane strong/00001: on the JAX factory's
        epoch its arc fit finds no η, so the JAX fused batch flags it with
        the η sampler's BAD_INPUT|BAD_FIT and nothing else. The port's
        stages on the same epochs give the same bits (ACF sampler 0, arc η
        NaN, η sampler BAD_INPUT|BAD_FIT) and leave strong/00000 clean."""
        from scintools_tpu.mcmc.survey import mcmc_scenario_workload as jwl
        from scintools_tpu.sim.factory import (lane_keys_from_seeds,
                                               simulate_scenarios)
        from scintools_tpu_torch.mcmc.survey import mcmc_scenario_workload

        kw = dict(epochs_per_regime=2, nwalkers=8, steps=40)
        jw = jwl(**kw)
        ids = [e for e, _ in jw["epochs"]][2:4]
        payloads = [p for _, p in jw["epochs"]][2:4]
        assert ids == ["strong/00000", "strong/00001"]
        flagged = tguards.BAD_INPUT | tguards.BAD_FIT
        assert [r["ok"] for r in jw["process_batch"](payloads)] == [
            0, flagged]
        dyn, _ = simulate_scenarios(
            2, mb2=[p["mb2"] for p in payloads],
            ar=[p["ar"] for p in payloads], psi=[p["psi"] for p in payloads],
            alpha=[p["alpha"] for p in payloads], ns=128, nf=64, dlam=0.05,
            rf=1.0, ds=0.02, inner=0.001,
            keys=lane_keys_from_seeds([p["seed"] for p in payloads]),
            with_ok=True, device_out=True)
        dyns = torch.as_tensor(np.array(jnp.transpose(dyn, (0, 2, 1))))
        tw = mcmc_scenario_workload(device=CPU, **kw)
        summ, summ_eta, _, etas_ref = tw["sample_stack"](
            dyns, payloads, [p["seed"] for p in payloads])
        assert summ["ok"].tolist() == [0, 0]
        assert summ_eta["ok"].tolist() == [0, flagged]
        arcs = tw["fit_stack"](dyns, etas_ref)
        assert np.isfinite(arcs[0].eta) and np.isnan(arcs[1].eta)

    def test_survey_runs_resumes_and_reports(self, tmp_path):
        from scintools_tpu_torch.mcmc.survey import (coverage_summary,
                                                     run_mcmc_fleet,
                                                     run_mcmc_survey)

        kw = dict(regimes=REGIMES_2, epochs_per_regime=4, ns=32, nf=16,
                  nwalkers=8, steps=40, numsteps=400, device=CPU)
        out = run_mcmc_survey(tmp_path, batch_size=8, **kw)
        s = out["summary"]
        assert s["n_epochs"] == 8
        assert s["n_ok"] + s["n_quarantined"] == 8
        row = next(iter(out["results"].values()))
        for k in ("tau_q50", "tau_rank", "dnu_ess", "eta_rhat",
                  "tau_cov95", "eta_true", "acc_frac"):
            assert k in row, row.keys()
        with open(os.path.join(tmp_path, "run_report.json")) as fh:
            rep = json.load(fh)
        assert set(rep["mcmc_coverage"]) == {"weak", "strong"}
        assert out["coverage"] == coverage_summary(out["results"])
        journal1 = (tmp_path / "journal.jsonl").read_bytes()
        out2 = run_mcmc_survey(tmp_path, batch_size=8, report=False, **kw)
        assert out2["summary"]["n_resumed"] == 8
        assert out2["results"] == out["results"]
        assert (tmp_path / "journal.jsonl").read_bytes() == journal1
        with pytest.raises(NotImplementedError, match="item 12"):
            run_mcmc_fleet(tmp_path)

    def test_numpy_tier_launches_the_b1_fit(self, monkeypatch):
        """The numpy tier samples on the host and fits the arc through
        the batch fit at B = 1 (the arc-profile wrapper, which launches
        the kernel on the card), never the serial host ``fit_arc``."""
        from scintools_tpu_torch.mcmc.survey import mcmc_scenario_workload
        from scintools_tpu_torch.ops import fitarc
        from scintools_tpu_torch.ops import normsspec
        from scintools_tpu_torch.robust.ladder import TIER_NUMPY

        calls = []
        orig = normsspec.arc_profile

        def counting(*args, **kwargs):
            calls.append(args[0].shape[0])
            return orig(*args, **kwargs)

        def refuse(*args, **kwargs):
            raise AssertionError("the serial host fit_arc ran")

        monkeypatch.setattr(normsspec, "arc_profile", counting)
        monkeypatch.setattr(fitarc, "fit_arc", refuse)
        wl = mcmc_scenario_workload(regimes=REGIMES_2[1:],
                                    epochs_per_regime=1, ns=32, nf=16,
                                    nwalkers=8, steps=30, numsteps=400,
                                    device=CPU)
        row = wl["process"](wl["epochs"][0][1], tier=TIER_NUMPY)
        assert calls == [1]
        assert row["ok"] == 0 and np.isfinite(row["eta_q50"])
        assert row["acc_frac"] == -1.0
