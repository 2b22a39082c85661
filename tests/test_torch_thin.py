"""The port's thin-screen and traced-geometry θ-θ searches
(scintools_tpu_torch/thth: core.two_curve_map, core.singularvalue_calc,
the thin and grid evaluators of batch.py, search.single_search_thin and
search.multi_chunk_search_thin, the façade's ``fitting_proc="thin"`` and
``time_avg``) against the JAX package on the CPU.

Both packages take the same numpy input. The host two-curve map and its
SVD are float64 in both (rtol 1e-10). The evaluators build θ-θ in
complex64 on the port and complex128 in the JAX package under tier-1
x64, then run the same cold power iteration: σ and |λ| curves hold at
rtol 1e-4, and the grid evaluators hold to the per-row evaluators at
the JAX package's own 2e-3 (tests/test_thth_batch.py). Fitted η holds
at rel 1e-2, the JAX package's gate between its search routes.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_fused_search import _arc_chunks  # noqa: E402
from test_thth import make_arc_wavefield  # noqa: E402
from test_thth_batch import _workload  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from scintools_tpu import dynspec as jdyn  # noqa: E402
from scintools_tpu.thth import batch as jbatch  # noqa: E402
from scintools_tpu.thth import core as jcore  # noqa: E402
from scintools_tpu.thth import search as jsearch  # noqa: E402
from scintools_tpu_torch import dynspec as tdyn  # noqa: E402
from scintools_tpu_torch.thth import batch as tbatch  # noqa: E402
from scintools_tpu_torch.thth import core as tcore  # noqa: E402
from scintools_tpu_torch.thth import search as tsearch  # noqa: E402
from scintools_tpu_torch.obs.retrace import compile_counts  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def thin_workload(nchunk=2, neta=10, seed=3):
    """tests/test_thth_batch.py's thin workload: random chunks' spectra,
    arclet edges within 0.7 of the edges' span, centre cut 0.1 of it."""
    CS_list, tau, fd, etas, edges = _workload(nchunk=nchunk, neta=neta,
                                              seed=seed)
    arclet = edges[np.abs(edges) < 0.7 * edges.max()]
    return CS_list, tau, fd, etas, edges, arclet, 0.1 * edges.max()


def _ri(CS_list):
    return np.stack([jcore.cs_to_ri(c).astype(np.float32) for c in CS_list])


class TestHostTwoCurve:
    @pytest.mark.parametrize("ratio", [1.0, 0.7, 1.4])
    def test_two_curve_map(self, ratio):
        CS_list, tau, fd, etas, edges, arclet, _ = thin_workload()
        for eta in etas[::3]:
            got = tcore.two_curve_map(CS_list[0], tau, fd, eta, edges,
                                      ratio * eta, arclet)
            want = jcore.two_curve_map(CS_list[0], tau, fd, eta, edges,
                                       ratio * eta, arclet)
            for g, w in zip(got, want):
                assert g.shape == w.shape
                np.testing.assert_allclose(g, w, rtol=1e-10, atol=0)

    def test_singularvalue_calc(self):
        CS_list, tau, fd, etas, edges, arclet, cut = thin_workload()
        for CS in CS_list:
            got = [tcore.singularvalue_calc(CS, tau, fd, e, edges, e, arclet,
                                            cut) for e in etas]
            want = [jcore.singularvalue_calc(CS, tau, fd, e, edges, e,
                                             arclet, cut) for e in etas]
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


class TestThinEval:
    def test_matches_jax(self):
        CS_list, tau, fd, etas, edges, arclet, cut = thin_workload()
        batch = _ri(CS_list)
        want = np.asarray(jbatch.make_thin_eval_fn(
            tau, fd, edges, arclet, cut)(jnp.asarray(batch),
                                         jnp.asarray(etas)))
        fn = tbatch.make_thin_eval_fn(tau, fd, edges, arclet, cut,
                                      device="cpu")
        got = fn(torch.as_tensor(batch), etas).numpy()
        assert got.shape == (len(CS_list), len(etas))
        np.testing.assert_allclose(got, want, rtol=1e-4)
        # the stages compose to the same curve
        a = fn.build(torch.as_tensor(batch), etas)
        assert a.shape == (len(CS_list), len(etas), fn.n2, fn.n1)
        np.testing.assert_array_equal(fn.solve(*fn.gram(a)).numpy(), got)

    def test_matches_host_svd(self):
        """At 600 steps within rtol 5e-3 of the float64 host SVD, the
        gate of tests/test_thth_batch.py."""
        CS_list, tau, fd, etas, edges, arclet, cut = thin_workload()
        got = tbatch.make_thin_eval_fn(tau, fd, edges, arclet, cut,
                                       iters=600, device="cpu")(
            torch.as_tensor(_ri(CS_list)), etas).numpy()
        for b, CS in enumerate(CS_list):
            ref = [tcore.singularvalue_calc(CS, tau, fd, e, edges, e, arclet,
                                            cut) for e in etas]
            np.testing.assert_allclose(got[b], ref, rtol=5e-3)

    def test_scale_normalisation_keeps_float32_finite(self):
        """A spectrum near float32's largest value: the Gram product of
        the scaled matrices stays finite and σ scales back."""
        CS_list, tau, fd, etas, edges, arclet, cut = thin_workload(nchunk=1)
        batch = _ri(CS_list)
        fn = tbatch.make_thin_eval_fn(tau, fd, edges, arclet, cut,
                                      device="cpu")
        base = fn(torch.as_tensor(batch), etas).numpy()
        big = 1e30 / np.abs(batch).max()
        got = fn(torch.as_tensor(batch * np.float32(big)), etas).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got / big, base, rtol=1e-4)

    @pytest.mark.parametrize("coher, mask", [(True, 0.0), (False, 0.0),
                                             (True, 1.5)])
    def test_fused_thin_search_matches_jax(self, coher, mask):
        chunks, tlist, freqs, etas, edges, _, npad = _arc_chunks(
            nchunk=2, seed=13)
        arclet = edges[np.abs(edges) < 0.7 * np.abs(edges).max()]
        cut = 0.05 * np.abs(edges).max()
        fd = tcore.fft_axis(tlist[0], pad=npad, scale=1e3)
        tau = tcore.fft_axis(freqs, pad=npad, scale=1.0)
        tau_mask = mask * (tau[1] - tau[0])
        stack = np.stack(chunks).astype(np.float32)
        nf, nt = stack.shape[1:]
        kw = dict(npad=npad, coher=coher, tau_mask=tau_mask, fw=0.3)
        want = jbatch.make_fused_thin_search_fn(
            tau, fd, edges, arclet, cut, nf, nt, **kw)(
            jnp.asarray(stack), jnp.asarray(etas))
        got = tbatch.make_fused_thin_search_fn(
            tau, fd, edges, arclet, cut, nf, nt, device="cpu", **kw)(
            torch.as_tensor(stack), etas)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-4)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-4)
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


class TestGridEval:
    def _rows(self):
        CS_list, tau, fd, etas, edges = _workload(nchunk=4)
        scales = np.array([1.0, 1.0, 1.05, 1.05])
        return (CS_list, tau, fd, edges, np.stack([edges * s for s in scales]),
                np.stack([etas / s ** 2 for s in scales]), scales)

    def test_grid_matches_jax_and_per_row(self):
        CS_list, tau, fd, edges, edges_b, etas_b, _ = self._rows()
        batch = _ri(CS_list)
        want = np.asarray(jbatch.make_grid_eval_fn(tau, fd, len(edges),
                                                   iters=400)(
            jnp.asarray(batch), jnp.asarray(edges_b), jnp.asarray(etas_b)))
        got = tbatch.make_grid_eval_fn(tau, fd, len(edges), iters=400,
                                       device="cpu")(
            torch.as_tensor(batch), edges_b, etas_b).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4)
        for b in range(len(CS_list)):
            row = tbatch.make_multi_eval_fn(tau, fd, edges_b[b], iters=400,
                                            method="power", device="cpu")
            ref = row(torch.as_tensor(batch[b:b + 1]), etas_b[b]).numpy()[0]
            np.testing.assert_allclose(got[b], ref, rtol=2e-3)

    def test_thin_grid_matches_jax_and_per_row(self):
        CS_list, tau, fd, edges, edges_b, etas_b, scales = self._rows()
        batch = _ri(CS_list)
        lim = 0.7 * edges.max()
        rows = [e[np.abs(e) < lim] for e in edges_b]
        arclet_b = tbatch.pad_arclet_edges(rows, edges.max())
        assert len({len(r) for r in rows}) == 2       # the padding is used
        cut = 0.1 * edges.max()
        want = np.asarray(jbatch.make_thin_grid_eval_fn(
            tau, fd, len(edges), arclet_b.shape[1], cut)(
            jnp.asarray(batch), jnp.asarray(edges_b), jnp.asarray(arclet_b),
            jnp.asarray(etas_b)))
        fn = tbatch.make_thin_grid_eval_fn(tau, fd, len(edges),
                                           arclet_b.shape[1], cut,
                                           device="cpu")
        got = fn(torch.as_tensor(batch), edges_b, arclet_b, etas_b).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4)
        for b in range(len(CS_list)):
            row = tbatch.make_thin_eval_fn(tau, fd, edges_b[b], rows[b], cut,
                                           device="cpu")
            ref = row(torch.as_tensor(batch[b:b + 1]), etas_b[b]).numpy()[0]
            np.testing.assert_allclose(got[b], ref, rtol=2e-3)

    def test_fused_grid_matches_jax_and_per_row(self):
        chunks, tlist, freqs, etas, edges, _, npad = _arc_chunks(
            nchunk=4, seed=19)
        fd = tcore.fft_axis(tlist[0], pad=npad, scale=1e3)
        tau = tcore.fft_axis(freqs, pad=npad, scale=1.0)
        scales = np.array([1.0, 1.0, 1.03, 1.03])
        edges_b = np.stack([edges * s for s in scales])
        etas_b = np.stack([etas / s ** 2 for s in scales])
        stack = np.stack(chunks).astype(np.float32)
        nf, nt = stack.shape[1:]
        want = jbatch.make_fused_grid_eval_fn(tau, fd, len(edges), nf, nt,
                                              npad=npad, fw=0.3)(
            jnp.asarray(stack), jnp.asarray(edges_b), jnp.asarray(etas_b))
        got = tbatch.make_fused_grid_eval_fn(tau, fd, len(edges), nf, nt,
                                             npad=npad, fw=0.3,
                                             device="cpu")(
            torch.as_tensor(stack), edges_b, etas_b)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-4)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-4)
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
        for b in range(len(chunks)):
            multi = tbatch.make_multi_eval_fn(tau, fd, edges_b[b],
                                              method="power", device="cpu")
            cs_ri = tbatch._chunk_cs_to_ri(torch.as_tensor(stack[b:b + 1]),
                                           npad, None, True)[0]
            ref = multi(cs_ri, etas_b[b]).numpy()[0]
            np.testing.assert_allclose(got[0][b].numpy(), ref, rtol=2e-3)


class TestThinSearch:
    def _problem(self, seed=13):
        chunks, tlist, freqs, etas, edges, eta_true, npad = _arc_chunks(
            nchunk=2, seed=seed)
        arclet = edges[np.abs(edges) < 0.7 * np.abs(edges).max()]
        return (chunks, freqs, tlist, etas, edges, arclet,
                0.05 * np.abs(edges).max(), npad)

    @pytest.mark.parametrize("route", ["fused", "staged", "svd"])
    def test_multi_chunk_search_thin(self, route):
        chunks, freqs, tlist, etas, edges, arclet, cut, npad = \
            self._problem()
        kw = dict(fw=0.3, npad=npad)
        want = jsearch.multi_chunk_search_thin(
            chunks, freqs, tlist, etas, edges, arclet, cut,
            backend="numpy" if route == "svd" else "jax",
            fused=route == "fused", **kw)
        got = tsearch.multi_chunk_search_thin(
            chunks, freqs, tlist, etas, edges, arclet, cut, device="cpu",
            fused=route == "fused",
            eig="svd" if route == "svd" else "power", **kw)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.ok == w.ok
            assert np.isfinite(g.eta) == np.isfinite(w.eta)
            if np.isfinite(w.eta):
                assert g.eta == pytest.approx(w.eta, rel=1e-2)
            assert g.time_mean == w.time_mean
            assert g.freq_mean == w.freq_mean
            np.testing.assert_allclose(g.eigs, w.eigs, rtol=2e-3)

    def test_routes_agree(self):
        """Fused against staged at the JAX package's gate
        (tests/test_fused_search.py): curves rtol 2e-3, η rel 2e-3."""
        chunks, freqs, tlist, etas, edges, arclet, cut, npad = \
            self._problem()
        args = (chunks, freqs, tlist, etas, edges, arclet, cut)
        fused = tsearch.multi_chunk_search_thin(*args, fw=0.3, npad=npad,
                                                device="cpu")
        staged = tsearch.multi_chunk_search_thin(*args, fw=0.3, npad=npad,
                                                 device="cpu", fused=False)
        assert any(np.isfinite(s.eta) for s in staged)
        for f, s in zip(fused, staged):
            np.testing.assert_allclose(f.eigs, s.eigs, rtol=2e-3)
            if np.isfinite(s.eta):
                assert f.eta == pytest.approx(s.eta, rel=2e-3)
        with pytest.raises(ValueError):
            tsearch.multi_chunk_search_thin(*args, device="cpu", eig="plain")

    @pytest.mark.parametrize("eig", ["power", "svd"])
    def test_single_search_thin(self, eig):
        chunks, freqs, tlist, etas, edges, arclet, cut, npad = \
            self._problem(seed=5)
        want = jsearch.single_search_thin(
            chunks[0], freqs, tlist[0], etas, edges, arclet, cut, fw=0.3,
            npad=npad, backend="numpy" if eig == "svd" else "jax")
        got = tsearch.single_search_thin(
            chunks[0], freqs, tlist[0], etas, edges, arclet, cut, fw=0.3,
            npad=npad, device="cpu", eig=eig)
        assert np.isfinite(got.eta) and got.ok == want.ok
        assert got.eta == pytest.approx(want.eta, rel=1e-2)

    def test_repeat_builds_nothing(self):
        chunks, freqs, tlist, etas, edges, arclet, cut, npad = \
            self._problem(seed=17)
        args = (chunks, freqs, tlist, etas, edges, arclet, cut)
        first = tsearch.multi_chunk_search_thin(*args, npad=npad,
                                                device="cpu")
        built = compile_counts().get("thth.fused_thin", 0)
        again = tsearch.multi_chunk_search_thin(*args, npad=npad,
                                                device="cpu")
        assert compile_counts().get("thth.fused_thin", 0) == built
        for a, b in zip(first, again):
            np.testing.assert_array_equal(a.eigs, b.eigs)
        tsearch.multi_chunk_search_thin(*args, npad=npad, device="cpu",
                                        fw=0.2)
        assert compile_counts().get("thth.fused_thin", 0) == built + 1


_THIN_PREP = dict(fitting_proc="thin", cwf=128, cwt=128, eta_min=0.1,
                  eta_max=0.9, nedge=64, edges_lim=2.6, npad=1,
                  arclet_lim=1.8, center_cut=0.1)


@pytest.fixture(scope="module")
def arc():
    E, times, freqs = make_arc_wavefield(nt=256, nf=128)
    return np.abs(E) ** 2, times, freqs


def _facades(arc, **prep):
    dyn, times, freqs = arc
    kw = dict(name="arcsim", times=times, freqs=freqs)
    dj = jdyn.Dynspec(dyn=jdyn.BasicDyn(dyn, **kw), verbose=False,
                      process=False, backend="jax")
    dp = tdyn.Dynspec(dyn=tdyn.BasicDyn(dyn, **kw), verbose=False,
                      process=False, device="cpu")
    for d in (dj, dp):
        d.prep_thetatheta(**prep)
    return dj, dp


class TestThinFacade:
    def test_prep_matches_jax(self, arc):
        dj, dp = _facades(arc, **dict(_THIN_PREP, arclet_lim=None,
                                      center_cut=None))
        for k in tdyn._STATE_KEYS[1:]:
            np.testing.assert_array_equal(getattr(dp, k), getattr(dj, k),
                                          err_msg=k)
        dj, dp = _facades(arc, fitting_proc="thin", cwf=128, cwt=128,
                          eta_min=0.1, eta_max=0.9, npad=1)
        for k in ("edges", "arclet_lim", "center_cut"):
            np.testing.assert_array_equal(getattr(dp, k), getattr(dj, k),
                                          err_msg=k)

    @pytest.mark.parametrize("time_avg", [False, True])
    def test_fit_thetatheta_batched_rows(self, arc, time_avg):
        dj, dp = _facades(arc, **_THIN_PREP)
        assert dp.nct_fit == 2
        dj.fit_thetatheta(time_avg=time_avg)
        dp.fit_thetatheta(time_avg=time_avg)
        np.testing.assert_array_equal(dp.eta_evo_ok, dj.eta_evo_ok)
        np.testing.assert_allclose(dp.eta_evo, dj.eta_evo, rtol=1e-3)
        np.testing.assert_allclose(dp.eta_evo_err, dj.eta_evo_err,
                                   rtol=1e-2)
        assert np.isfinite(dp.ththeta)
        assert dp.ththeta == pytest.approx(dj.ththeta, rel=1e-3)
        assert dp.ththetaerr == pytest.approx(dj.ththetaerr, rel=1e-2)

    def test_time_avg_is_the_host_formula(self, arc):
        """``time_avg`` on the port's own ``eta_evo`` is the float64
        formula of the JAX façade (scintools_tpu/dynspec.py:1558-1569),
        bit for bit."""
        _, dp = _facades(arc, **_THIN_PREP)
        dp.fit_thetatheta(time_avg=True)
        eta_avg = np.nanmean(dp.eta_evo, 1)
        count = np.nansum(dp.eta_evo, 1) / eta_avg
        err = np.nanstd(dp.eta_evo, 1) / np.sqrt(count - 1)
        ok = np.isfinite(eta_avg) & np.isfinite(err)
        A = (np.sum(eta_avg[ok] / (dp.f0s * err)[ok] ** 2)
             / np.sum(1 / (dp.f0s ** 2 * err)[ok] ** 2))
        A_err = np.sqrt(1 / np.sum(2 / ((dp.f0s ** 2) * err)[ok] ** 2))
        assert dp.ththeta == A / dp.fref ** 2
        assert dp.ththetaerr == A_err / dp.fref ** 2
        assert tdyn.global_eta_fit(dp.eta_evo, dp.eta_evo_err, dp.f0s,
                                   dp.fref, time_avg=True) \
            == (dp.ththeta, dp.ththetaerr)

    def test_one_chunk_per_row_and_single(self, arc):
        prep = dict(_THIN_PREP)
        prep.pop("cwt")
        dj, dp = _facades(arc, **prep)
        assert dp.nct_fit == 1
        dj.fit_thetatheta()
        dp.fit_thetatheta()
        np.testing.assert_array_equal(dp.eta_evo_ok, dj.eta_evo_ok)
        np.testing.assert_allclose(dp.eta_evo, dj.eta_evo, rtol=1e-3)
        assert dp.ththeta == pytest.approx(dj.ththeta, rel=1e-3)
        got = dp.thetatheta_single(0, 0)
        want = dj.thetatheta_single(0, 0)
        assert got.eta == pytest.approx(want.eta, rel=1e-3)
        etas, eigs, popt = dp.thetatheta_single(0, 0, arrays=True)
        assert len(etas) == len(eigs) and len(popt) == 3

    def test_from_reference_state(self, arc):
        dj, _ = _facades(arc, **_THIN_PREP)
        state = {k: getattr(dj, k) for k in tdyn._STATE_KEYS}
        with pytest.raises(KeyError):
            tdyn.Dynspec.from_reference_state(state, device="cpu")
        state.update(arclet_lim=dj.arclet_lim, center_cut=dj.center_cut)
        dp = tdyn.Dynspec.from_reference_state(state, device="cpu")
        dj.fit_thetatheta()
        dp.fit_thetatheta()
        np.testing.assert_allclose(dp.eta_evo, dj.eta_evo, rtol=1e-3)
        assert dp.ththeta == pytest.approx(dj.ththeta, rel=1e-3)
