"""The port's batched scenario factory (scintools_tpu_torch/sim/
factory.py) and the closed generate → search → fit workload
(sim/scenario.py) against the JAX package on the CPU.

Torch cannot reproduce ``jax.random``, so the factory is compared stage
by stage from the JAX package's own draws: the test draws the normals
with the JAX factory's recipe (``jax.random.split`` of each lane key,
two ``normal`` planes, ``fold_in(key, 7)`` for the compensator's (M, 2)
modes), hands them to the port's ``screens_from_normals`` and holds the
screens to ``simulate_screens(keys=…)`` for all three formulations, at
1e-10 of the maximum at "highest" (float64 on both sides) and 1e-5 in
float32; the port's ``propagate_group`` on those screens is held to the
JAX dynspec at 1e-8 of the maximum at "highest" (every propagation),
and in float32 at 1e-4 (tests/test_sim_factory.py's phasor-vs-column
tolerance). The port's
own properties (quarantine codes with bitwise neighbours, grouping and
padding independence, one build for a regime sweep, the formulations
against each other, the compensated structure function) are checked at
the JAX tests' tolerances. The workload's search-and-fit stage on a
JAX-generated stack is held to the JAX stage at the port's fit_arc_batch
(η 1e-4) and scint_params_batch (values 1e-4, errors 1e-3) tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scintools_tpu.fit.batch import scint_params_batch as j_scint_batch
from scintools_tpu.ops.fitarc import fit_arc_batch as j_fit_arc_batch
from scintools_tpu.ops.sspec import sspec_axes as j_sspec_axes
from scintools_tpu.sim import factory as jf
from scintools_tpu.sim import scenario as jsc
from scintools_tpu_torch.io.psrflux import MalformedInputError
from scintools_tpu_torch.obs.retrace import compile_counts
from scintools_tpu_torch.sim import factory as tf
from scintools_tpu_torch.sim import scenario as tsc
from scintools_tpu_torch.sim import simulation as tsim

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # one intra-op thread: the suite runs in parallel workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
SEEDS = [11, 12, 13, 14]
LANES = dict(mb2=np.array([2.0, 0.5, 16.0, 4.0]),
             ar=np.array([1.0, 2.0, 1.5, 1.0]),
             psi=np.array([0.0, 30.0, 60.0, 5.0]),
             alpha=np.array([5 / 3, 5 / 3, 1.4, 5 / 3]))


def relmax(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def jax_normals(keys, shape, n_modes, dtype):
    """The JAX factory's per-lane draws (sim/factory.py draw_screens)."""
    re, im, zm = [], [], []
    for key in keys:
        k1, k2 = jax.random.split(key)
        re.append(np.asarray(jax.random.normal(k1, shape, dtype=dtype)))
        im.append(np.asarray(jax.random.normal(k2, shape, dtype=dtype)))
        if n_modes:
            zm.append(np.asarray(jax.random.normal(
                jax.random.fold_in(key, 7), (n_modes, 2), dtype=dtype)))
    return np.stack(re), np.stack(im), (np.stack(zm) if n_modes else None)


FORMS = [(prec, scr) for prec in (None, "highest")
         for scr in ("compensated", "oversized", "plain")]


class TestFactoryAgainstJax:
    NS, NF = 32, 8

    @pytest.fixture(scope="class", params=FORMS,
                    ids=[f"{p or 'f32'}-{s}" for p, s in FORMS])
    def screens(self, request):
        prec, scr = request.param
        keys = jf.lane_keys_from_seeds(SEEDS)
        shape = (2 * self.NS,) * 2 if scr == "oversized" else (self.NS,) * 2
        n_modes = 16 if scr == "compensated" else 0
        dtype = jnp.float64 if prec == "highest" else jnp.float32
        normals = jax_normals(keys, shape, n_modes, dtype)
        want = jf.simulate_screens(4, ns=self.NS, nf=self.NF, keys=keys,
                                   precision=prec, screen=scr,
                                   group_size=4, **LANES)
        fn = tf.make_scenario_factory(ns=self.NS, nf=self.NF, nscreens=4,
                                      group_size=4, precision=prec,
                                      screen=scr, device=CPU)
        got = fn.screens_from_normals(*normals, **LANES)
        return prec, scr, keys, got, want

    def test_screens(self, screens):
        prec, _, _, got, want = screens
        assert got.dtype == (torch.float64 if prec else torch.float32)
        assert relmax(got.numpy(), want) < (1e-10 if prec else 1e-5)

    @pytest.mark.parametrize("prop", ["phasor", "column", "dense"])
    def test_propagation(self, screens, prop):
        prec, scr, keys, got, _ = screens
        nf = 40 if prop == "phasor" else self.NF     # crosses two resyncs
        want = jf.simulate_scenarios(4, ns=self.NS, nf=nf, keys=keys,
                                     precision=prec, screen=scr,
                                     propagate=prop, group_size=4, **LANES)
        fn = tf.make_scenario_factory(ns=self.NS, nf=nf, nscreens=4,
                                      group_size=4, precision=prec,
                                      screen=scr, propagate=prop,
                                      device=CPU)
        spe = fn.propagate_group(got)
        assert spe.shape == (4, self.NS, nf)
        spi = (spe.real ** 2 + spe.imag ** 2).numpy()
        assert relmax(spi, want) < (1e-8 if prec else 1e-4)


class TestGeometryHelpers:
    def test_effective_wavenumbers_and_modes_are_the_reference(self):
        args = (16, 32, 2 * np.pi / 0.16, 2 * np.pi / 0.64)
        for a, b in zip(tf.effective_wavenumbers(*args),
                        jf.effective_wavenumbers(*args)):
            np.testing.assert_array_equal(a, b)
        for lev in (1, 2):
            for a, b in zip(tf.compensator_modes(3.0, 2.0, levels=lev),
                            jf.compensator_modes(3.0, 2.0, levels=lev)):
                np.testing.assert_array_equal(a, b)
        for lam in (False, True):
            np.testing.assert_array_equal(
                tf.frequency_scale_grid(24, 0.1, lamsteps=lam),
                jf.frequency_scale_grid(24, 0.1, lamsteps=lam))

    def test_column_phase_is_the_jax_vector(self):
        from scintools_tpu.ops import xfft as jxfft
        from scintools_tpu_torch.ops import xfft as txfft

        np.testing.assert_array_equal(txfft.column_phase(12, 6),
                                      jxfft.column_phase(12, 6))


class TestFactoryProperties:
    KW = dict(ns=32, nf=8, device=CPU)

    def test_shapes_stats_and_health(self):
        dyn, ok = tf.simulate_scenarios(6, ns=64, nf=16, seed=3,
                                        with_ok=True, group_size=2,
                                        device=CPU)
        assert dyn.shape == (6, 64, 16) and ok.shape == (6,)
        assert np.all(ok == 0)
        assert np.isfinite(dyn).all() and np.all(dyn >= 0)
        assert 0.5 < dyn.mean() < 2.0

    def test_nan_lane_quarantined_neighbours_bitwise(self):
        keys = tf.lane_keys_from_seeds([1, 2, 3, 4])
        kw = dict(group_size=2, with_ok=True, keys=keys, **self.KW)
        clean, ok_c = tf.simulate_scenarios(4, mb2=[2.0] * 4, **kw)
        dirty, ok_d = tf.simulate_scenarios(
            4, mb2=[2.0, np.nan, 2.0, -1.0], alpha=[5 / 3, 5 / 3, 5 / 3, 1.5],
            **kw)
        assert list(ok_c) == [0, 0, 0, 0]
        assert list(ok_d) == [0, tf.BAD_INPUT, 0, tf.BAD_INPUT]
        assert np.isnan(dirty[1]).all() and np.isnan(dirty[3]).all()
        for lane in (0, 2):
            np.testing.assert_array_equal(dirty[lane], clean[lane])
        _, ok_a = tf.simulate_scenarios(3, alpha=[2.0, 0.0, 1.9], **dict(
            kw, keys=keys[:3], group_size=3))
        assert list(ok_a) == [tf.BAD_INPUT, tf.BAD_INPUT, 0]

    def test_non_finite_output_is_bad_output(self):
        """mb2 = 1e38 is a valid parameter whose float32 spectrum
        overflows: the lane is BAD_OUTPUT and NaN, its neighbours as in
        a clean run."""
        kw = dict(group_size=3, with_ok=True, keys=[5, 6, 7], **self.KW)
        clean, _ = tf.simulate_scenarios(3, mb2=2.0, **kw)
        dirty, ok = tf.simulate_scenarios(3, mb2=[2.0, 1e38, 2.0], **kw)
        assert list(ok) == [0, tf.BAD_OUTPUT, 0]
        assert np.isnan(dirty[1]).all()
        for lane in (0, 2):
            np.testing.assert_array_equal(dirty[lane], clean[lane])

    @pytest.mark.parametrize("screen", ["compensated", "oversized"])
    def test_lane_independent_of_grouping_and_padding(self, screen):
        kw = dict(screen=screen, **self.KW)
        a = tf.simulate_scenarios(4, keys=[11, 12, 13, 14], group_size=2,
                                  **kw)
        b = tf.simulate_scenarios(5, keys=[99, 12, 98, 97, 96],
                                  group_size=4, **kw)
        c = tf.simulate_scenarios(1, keys=[12], group_size=1, **kw)
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[1], c[0])
        assert b.shape == (5, 32, 8)

    def test_seeded_lanes_do_not_depend_on_padding(self):
        a = tf.simulate_scenarios(5, seed=4, group_size=4, **self.KW)
        b = tf.simulate_scenarios(8, seed=4, group_size=8, **self.KW)
        np.testing.assert_array_equal(a, b[:5])
        c = tf.simulate_scenarios(5, seed=5, group_size=4, **self.KW)
        assert not np.array_equal(a, c)

    def test_one_build_serves_a_regime_sweep(self):
        kw = dict(group_size=4, device_out=True, **self.KW)
        tf.simulate_scenarios(4, mb2=[1, 2, 4, 8], seed=0, **kw)
        n = compile_counts().get("sim.factory", 0)
        out = tf.simulate_scenarios(4, mb2=[0.5, 16, 2, 3],
                                    ar=[1, 2, 1.5, 1], psi=[0, 30, 60, 5],
                                    seed=9, **kw)
        assert compile_counts().get("sim.factory", 0) == n
        assert isinstance(out, torch.Tensor)
        tf.simulate_scenarios(4, seed=0, dlam=0.125, **kw)
        assert compile_counts().get("sim.factory", 0) == n + 1

    def test_lane_draw_order(self):
        """A lane's normals come from one generator seeded by its key:
        the real plane, the imaginary plane, then the (M, 2) modes."""
        fn = tf.build_scenario_fn(nscreens=2, group_size=2, **self.KW)
        re, im, zm = fn.normals(1234)
        g = torch.Generator(device=CPU)
        g.manual_seed(1234)
        for got, shape in ((re, (32, 32)), (im, (32, 32)), (zm, (16, 2))):
            np.testing.assert_array_equal(
                got.numpy(), torch.randn(shape, generator=g).numpy())
        fn = tf.build_scenario_fn(nscreens=2, group_size=2,
                                  screen="oversized", **self.KW)
        re, _, zm = fn.normals(1234)
        assert re.shape == (64, 64) and zm is None

    def test_unknown_formulation_and_group_refused(self):
        with pytest.raises(ValueError):
            tf.build_scenario_fn(screen="tiled", **self.KW)
        with pytest.raises(ValueError):
            tf.build_scenario_fn(propagate="fast", **self.KW)
        with pytest.raises(ValueError):
            tf.build_scenario_fn(nscreens=6, group_size=4, **self.KW)

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: device=None is valid here")
        with pytest.raises(RuntimeError):
            tf.simulate_scenarios(2, ns=16, nf=4)
        with pytest.raises(RuntimeError):
            tsc.scenario_workload(epochs_per_regime=1)


class TestFormulations:
    """The port's formulations against each other, at
    tests/test_sim_factory.py's tolerances."""

    KW = dict(ns=64, nf=16, seed=7, group_size=4, screen="plain",
              device=CPU)

    def test_column_matches_dense(self):
        b = tf.simulate_scenarios(4, propagate="column", **self.KW)
        c = tf.simulate_scenarios(4, propagate="dense", **self.KW)
        assert relmax(b, c) < 1e-3

    def test_phasor_matches_column(self):
        a = tf.simulate_scenarios(4, propagate="phasor", **self.KW)
        b = tf.simulate_scenarios(4, propagate="column", **self.KW)
        assert relmax(a, b) < 1e-4

    def test_phasor_strong_regime_bounded_drift(self):
        kw = dict(self.KW, nf=48, seed=3, mb2=32.0)
        a = tf.simulate_scenarios(4, propagate="phasor", **kw)
        b = tf.simulate_scenarios(4, propagate="column", **kw)
        assert relmax(a, b) < 1e-3

    def test_highest_matches_simulation_class(self):
        """A plain-screen lane at "highest" is the Simulation class's
        propagation of that lane's screen."""
        kw = dict(ns=32, nf=8, precision="highest", screen="plain",
                  device=CPU)
        scr = tf.simulate_screens(2, keys=[3, 4], **kw)
        dyn = tf.simulate_scenarios(2, keys=[3, 4], **kw)
        sim = tsim.Simulation(ns=32, nf=8, seed=0, device=CPU)
        for i in range(2):
            spe = tsim.propagate(scr[i], sim._q2, sim.frequency_scales(),
                                 16, device=CPU).numpy()
            assert relmax(dyn[i], np.abs(spe) ** 2) < 1e-10


def _structure_function(screens):
    _, n, _ = screens.shape
    lags = np.arange(1, n // 2)
    out = np.zeros(len(lags))
    for ax in (1, 2):
        s = np.moveaxis(screens, ax, -1)
        for i, lag in enumerate(lags):
            diff = s[..., lag:] - s[..., :-lag]
            out[i] += 0.5 * np.mean(diff ** 2)
    return out


class TestCompensator:
    def test_compensated_matches_oversized_oracle(self):
        def sf(screen, seed):
            return _structure_function(tf.simulate_screens(
                96, ns=64, nf=2, seed=seed, screen=screen, device=CPU))

        d_comp, d_over, d_plain = (sf("compensated", 5), sf("oversized", 99),
                                   sf("plain", 5))
        rel_comp = np.median(np.abs(d_comp - d_over) / d_over)
        rel_plain = np.median(np.abs(d_plain - d_over) / d_over)
        assert rel_comp < 0.08, rel_comp
        assert rel_plain > 0.15, rel_plain
        assert rel_plain / rel_comp > 2.5

    def test_compensated_variance_exceeds_plain(self):
        kw = dict(ns=32, nf=2, seed=3, device=CPU)
        comp = tf.simulate_screens(16, screen="compensated", **kw)
        plain = tf.simulate_screens(16, screen="plain", **kw)
        assert comp.var() > plain.var() * 1.05


class TestScenario:
    KW = dict(epochs_per_regime=8, seed=2, numsteps=800, n_iter=30)

    @pytest.fixture(scope="class")
    def workload(self):
        return tsc.scenario_workload(device=CPU, **self.KW)

    def test_truths_pinned(self):
        """tests/test_sim_factory.py:280-287's regression pin, and the
        same numbers as the JAX function."""
        t = tsc.scenario_truths(16.0, 1.0, 0.0, 5 / 3, rf=1.0, ds=0.02,
                                dt=30.0, freq=1400.0, dlam=0.05)
        assert t["eta"] == pytest.approx(0.0050490, rel=1e-3)
        assert t["tau"] == pytest.approx(211.81, rel=1e-2)
        assert t["dnu"] == pytest.approx(19.922, rel=1e-2)
        lanes = (LANES["mb2"], LANES["ar"], LANES["psi"], LANES["alpha"])
        tj, tt = jsc.scenario_truths(*lanes), tsc.scenario_truths(*lanes)
        for k in ("eta", "tau", "dnu"):
            np.testing.assert_array_equal(tt[k], tj[k])

    def test_tables_are_the_jax_tables(self, workload):
        jw = jsc._lane_table(jsc.DEFAULT_REGIMES, 8, 2)
        assert workload["epochs"] == jw
        assert tsc.DEFAULT_REGIMES == jsc.DEFAULT_REGIMES
        from scintools_tpu.robust import ladder

        assert (tsc.TIER_FUSED, tsc.TIER_STAGED, tsc.TIER_NUMPY) == (
            ladder.TIER_FUSED, ladder.TIER_STAGED, ladder.TIER_NUMPY)

    def test_sspec_db_matches_jax(self):
        dyns = np.random.default_rng(4).gamma(
            1.0, size=(3, 64, 128)).astype(np.float32)
        want = np.asarray(jsc.make_sspec_db_batch(128, 64)(
            jnp.asarray(dyns)))
        fn = tsc.make_sspec_db_batch(128, 64, device=CPU)
        got = fn(torch.as_tensor(dyns)).numpy()
        lin_w, lin_g = 10 ** (want / 10), 10 ** (got / 10)
        assert relmax(lin_g, lin_w) < 1e-5
        n = compile_counts().get("sim.scenario_sspec", 0)
        tsc.make_sspec_db_batch(128, 64, device=CPU)
        assert compile_counts().get("sim.scenario_sspec", 0) == n

    def test_fit_stage_on_jax_stack(self, workload):
        pay = [p for _, p in workload["epochs"]][4:12]
        keys = jf.lane_keys_from_seeds([p["seed"] for p in pay])
        dyn = jf.simulate_scenarios(
            8, mb2=[p["mb2"] for p in pay], ar=[p["ar"] for p in pay],
            psi=[p["psi"] for p in pay], alpha=[p["alpha"] for p in pay],
            ns=128, nf=64, dlam=0.05, rf=1.0, ds=0.02, keys=keys)
        dyns = np.ascontiguousarray(np.transpose(dyn, (0, 2, 1)))
        arcs, fits = workload["fit_stack"](dyns, pay)
        df = 1400.0 * 0.05 / 63
        fdop, tdel, _ = j_sspec_axes(64, 128, 30.0, df)
        sec = jsc.make_sspec_db_batch(128, 64)(jnp.asarray(dyns))
        eta_t = np.array([jsc.scenario_truths(
            p["mb2"], p["ar"], p["psi"], p["alpha"])["eta"] for p in pay])
        jarcs = j_fit_arc_batch(np.asarray(sec), tdel, fdop, numsteps=800,
                                etamin=0.2 * eta_t, etamax=5 * eta_t,
                                sspecs_device=sec, full_output=False)
        jfits = j_scint_batch(jnp.asarray(dyns), 30.0, df, n_iter=30)
        eta_p = np.array([a.eta for a in arcs])
        eta_j = np.array([a.eta for a in jarcs])
        np.testing.assert_array_equal(np.isfinite(eta_p),
                                      np.isfinite(eta_j))
        fin = np.isfinite(eta_j)
        assert fin.sum() >= 6
        np.testing.assert_allclose(eta_p[fin], eta_j[fin], rtol=1e-4)
        for k, tol in (("tau", 1e-4), ("dnu", 1e-4), ("tauerr", 1e-3),
                       ("dnuerr", 1e-3)):
            np.testing.assert_allclose(fits[k], np.asarray(jfits[k]),
                                       rtol=tol, err_msg=k)

    def test_closed_loop_smoke(self, workload):
        """Three regimes × 8 epochs in batches of 8 meet the smoke gates
        of tests/test_sim_factory.py:320-325; a lane whose fit the batch
        refuses descends to the staged tier, as the survey runner does."""
        results, descended = {}, 0
        epochs = workload["epochs"]
        for b in range(0, len(epochs), 8):
            group = epochs[b:b + 8]
            out = workload["process_batch"]([p for _, p in group])
            for (eid, p), r in zip(group, out):
                if r["ok"] != 0:
                    descended += 1
                    r = workload["process"](p, tier=tsc.TIER_STAGED)
                results[eid] = r
        rec = tsc.recovery_summary(results)
        assert set(rec) == {r["name"] for r in tsc.DEFAULT_REGIMES}
        assert descended <= 2
        for regime, d in rec.items():
            assert d["n_ok"] == 8, (regime, d)
            assert d["eta_med_rel"] < 0.35, (regime, d)
            assert d["tau_med_rel"] < 0.5, (regime, d)
            assert d["dnu_med_rel"] < 0.7, (regime, d)
        assert {"eta", "tau", "dnu", "eta_true", "tau_true", "dnu_true",
                "regime", "ok"} <= set(next(iter(results.values())))

    def test_fallback_tiers_and_malformed_lane(self, workload):
        p = workload["epochs"][0][1]
        for tier in (tsc.TIER_STAGED, tsc.TIER_NUMPY):
            r = workload["process"](p, tier=tier)
            assert r["ok"] == 0
            assert np.isfinite([r["eta"], r["tau"], r["dnu"]]).all(), tier
            assert abs(r["eta"] / r["eta_true"] - 1) < 0.35
        with pytest.raises(MalformedInputError):
            workload["process"](dict(p, mb2=float("nan")))
        with pytest.raises(MalformedInputError):
            workload["process"](dict(p, alpha=2.5), tier=tsc.TIER_NUMPY)

    def test_poisoned_lane_in_a_batch(self, workload):
        pay = [dict(p) for _, p in workload["epochs"][:4]]
        clean = workload["process_batch"](pay)
        pay[2]["mb2"] = float("nan")
        dirty = workload["process_batch"](pay)
        assert dirty[2]["ok"] == tf.BAD_INPUT
        assert np.isnan(dirty[2]["eta"])
        for i in (0, 1, 3):
            assert dirty[i] == clean[i]

    def test_runners_wait_for_their_items(self):
        # the survey engine is ported: run_scenario_survey takes the JAX
        # signature plus device=; the fleet runner (ported with fleet/,
        # run by tests/test_torch_fleet.py) the JAX signature plus the
        # workload target before the workload's parameters
        import inspect

        from scintools_tpu.sim import scenario as jsc

        want = list(inspect.signature(jsc.run_scenario_survey).parameters)
        got = list(inspect.signature(tsc.run_scenario_survey).parameters)
        assert got == want + ["device"]
        want = list(inspect.signature(jsc.run_scenario_fleet).parameters)
        got = list(inspect.signature(tsc.run_scenario_fleet).parameters)
        assert got == want[:-1] + ["target", want[-1]]

    def test_batch_wrappers(self):
        from scintools_tpu_torch.sim.simulation import (
            make_dynspec_batch_fn, simulate_dynspec_batch)

        fn = make_dynspec_batch_fn(ns=16, nf=4, device=CPU)
        out = fn(tf.lane_keys_from_seeds([1, 2, 3]))
        assert out.shape == (3, 16, 4) and torch.isfinite(out).all()
        b = simulate_dynspec_batch(3, ns=16, nf=4, seed=1, device=CPU)
        np.testing.assert_array_equal(
            b.numpy(), tf.simulate_scenarios(3, ns=16, nf=4, seed=1,
                                             device=CPU))
