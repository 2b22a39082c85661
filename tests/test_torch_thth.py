"""The port's θ-θ search (scintools_tpu_torch/thth: batch, peakfit,
search, robust/guards) against the JAX package on the CPU.

The JAX side runs its Pallas kernel in interpret mode; the port runs
the plain PyTorch eigensolver. Inputs come from numpy with fixed seeds.
Tolerances: the θ-θ is built in complex64 on the port and in
complex128 (cast to float32 at the kernel) on the JAX side, ≲1e-6
relative before the eigensolve; eigen curves agree to rtol 2e-3 as the
JAX package's own warm-start-vs-power gate.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_fused_search import _arc_chunks  # noqa: E402
from test_thth_batch import _workload  # noqa: E402

from scintools_tpu.robust import faults  # noqa: E402
from scintools_tpu.robust import guards as jguards  # noqa: E402
from scintools_tpu.thth import batch as jbatch  # noqa: E402
from scintools_tpu.thth import peakfit as jpeak  # noqa: E402
from scintools_tpu.thth import search as jsearch  # noqa: E402
from scintools_tpu.thth.core import cs_to_ri  # noqa: E402
from scintools_tpu_torch.robust import guards as tguards  # noqa: E402
from scintools_tpu_torch.thth import batch as tbatch  # noqa: E402
from scintools_tpu_torch.thth import core as tcore  # noqa: E402
from scintools_tpu_torch.thth import peakfit as tpeak  # noqa: E402
from scintools_tpu_torch.thth import search as tsearch  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestGeometryCopies:
    def test_host_helpers_match(self):
        from scintools_tpu.thth import core as jcore

        x = 1400.0 + 0.05 * np.arange(40)
        for pad in (0, 1, 3):
            np.testing.assert_array_equal(tcore.fft_axis(x, pad=pad),
                                          jcore.fft_axis(x, pad=pad))
        edges = np.linspace(-3.1, 2.7, 33)
        np.testing.assert_array_equal(tcore.th_cents_from_edges(edges),
                                      jcore.th_cents_from_edges(edges))
        fd = jcore.fft_axis(np.arange(64) * 2.0, scale=1e3)
        tau = jcore.fft_axis(x, scale=1.0)
        np.testing.assert_array_equal(tcore.min_edges(100.0, fd, tau, 1e-3),
                                      jcore.min_edges(100.0, fd, tau, 1e-3))
        cs = np.random.default_rng(0).normal(size=(4, 5)) * (1 + 2j)
        np.testing.assert_array_equal(tcore.cs_to_ri(cs), cs_to_ri(cs))


class TestMultiEval:
    def test_matches_jax_pallas_interpret(self):
        import jax.numpy as jnp

        CS_list, tau, fd, etas, edges = _workload()
        batch = np.stack([cs_to_ri(c) for c in CS_list])
        ref = np.asarray(jbatch.make_multi_eval_fn(
            tau, fd, edges, method="pallas", interpret=True)(
                jnp.asarray(batch), jnp.asarray(etas)))
        fn = tbatch.make_multi_eval_fn(tau, fd, edges, device="cpu")
        ours = fn(torch.from_numpy(batch.astype(np.float32)), etas).numpy()
        assert ours.shape == ref.shape == (len(CS_list), len(etas))
        np.testing.assert_allclose(ours, ref, rtol=2e-3)
        assert fn.n_th == len(edges) - 1 and fn.n_pad == 128

    def test_plain_route_equals_kernel_route_on_cpu(self):
        CS_list, tau, fd, etas, edges = _workload(nchunk=2, neta=6)
        batch = torch.from_numpy(np.stack(
            [cs_to_ri(c) for c in CS_list]).astype(np.float32))
        a = tbatch.make_multi_eval_fn(tau, fd, edges, device="cpu")(batch,
                                                                    etas)
        b = tbatch.make_multi_eval_fn(tau, fd, edges, eig="plain",
                                      device="cpu")(batch, etas)
        assert torch.equal(a, b)
        with pytest.raises(ValueError):
            tbatch.make_multi_eval_fn(tau, fd, edges, eig="dense")


class TestPeakFit:
    def _curves(self, B=6, neta=40, seed=3, nan_frac=0.0):
        rng = np.random.default_rng(seed)
        etas = np.linspace(5e-4, 2e-3, neta)
        x0 = rng.uniform(0.8e-3, 1.6e-3, B)
        A = -rng.uniform(1e9, 5e9, B)
        C = rng.uniform(50.0, 200.0, B)
        eigs = jsearch.chi_par(etas[None, :], A[:, None], x0[:, None],
                               C[:, None])
        eigs = eigs + 0.05 * rng.standard_normal(eigs.shape)
        if nan_frac:
            mask = rng.random(eigs.shape) < nan_frac
            mask[np.arange(B), np.argmax(eigs, axis=1)] = False
            eigs = np.where(mask, np.nan, eigs)
        return etas, eigs

    @pytest.mark.parametrize("nan_frac", [0.0, 0.15])
    def test_matches_jax_float64(self, nan_frac):
        """rel 1e-5: the same closed form in float64 on both sides."""
        etas, eigs = self._curves(nan_frac=nan_frac)
        ref = [np.asarray(x) for x in jpeak.fit_eig_peak_batch_device(
            etas, eigs, fw=0.3, with_ok=True)]
        ours = [x.numpy() for x in tpeak.fit_eig_peak_batch_device(
            etas, torch.from_numpy(eigs), fw=0.3, with_ok=True)]
        for o, r in zip(ours[:3], ref[:3]):
            np.testing.assert_allclose(o, r, rtol=1e-5)
        np.testing.assert_array_equal(ours[3], ref[3])

    def test_float32_gates_vs_scipy(self):
        """tests/test_fused_search.py:101-116: the production path
        fits float32 curves; η to rel 1e-4 of the scipy oracle, η_sig
        (an O(noise) residual std against O(100) eigenvalues) to 5e-2."""
        etas, eigs = self._curves(seed=11)
        eta_d, sig_d, _ = [x.numpy() for x in
                           tpeak.fit_eig_peak_batch_device(
                               etas, torch.from_numpy(
                                   eigs.astype(np.float32)), fw=0.3)]
        for b in range(len(eigs)):
            eta_h, sig_h = tsearch.fit_eig_peak(etas, eigs[b], fw=0.3)
            assert eta_d[b] == pytest.approx(eta_h, rel=1e-4)
            assert sig_d[b] == pytest.approx(sig_h, rel=5e-2)

    def test_refusals_match(self):
        etas = np.linspace(5e-4, 2e-3, 30)
        all_nan = np.full(30, np.nan)
        two_pts = np.full(30, np.nan)
        two_pts[3], two_pts[4] = 1.0, 2.0
        flat = np.full(30, 5.0)                   # singular → refuse
        curves = np.stack([all_nan, two_pts, flat])
        eta, sig, popt, ok = [x.numpy() for x in
                              tpeak.fit_eig_peak_batch_device(
                                  etas, torch.from_numpy(curves), fw=0.3,
                                  with_ok=True)]
        ref_ok = np.asarray(jpeak.fit_eig_peak_batch_device(
            etas, curves, fw=0.3, with_ok=True)[3])
        np.testing.assert_array_equal(ok, ref_ok)
        assert not ok.any()
        assert not np.isfinite(eta).any() and not np.isfinite(sig).any()
        assert not np.isfinite(popt).any()
        for b in range(2):
            assert not np.isfinite(tsearch.fit_eig_peak(etas, curves[b],
                                                        fw=0.3)[0])

    def test_narrow_window_and_per_chunk_etas(self):
        etas = np.linspace(5e-4, 2e-3, 30)
        eigs = jsearch.chi_par(etas, -2e9, 1.2e-3, 100.0)[None]
        eta, _, _ = tpeak.fit_eig_peak_batch_device(
            etas, torch.from_numpy(eigs), fw=1e-4)
        assert not np.isfinite(eta.numpy()[0])
        # per-chunk (B, neta) η grids, as the JAX vmap over both
        e1, g2 = self._curves(B=2, seed=5)
        e2 = np.stack([e1, e1 * 1.1])
        ours = tpeak.fit_eig_peak_batch_device(torch.from_numpy(e2),
                                               torch.from_numpy(g2), fw=0.3)
        ref = jpeak.fit_eig_peak_batch_device(e2, g2, fw=0.3)
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5)
        single = tpeak.fit_eig_peak_device(etas, torch.from_numpy(eigs[0]),
                                           fw=0.3)
        assert float(single[0]) == pytest.approx(1.2e-3, rel=1e-6)


class TestGuards:
    def test_flags_match_jax(self):
        rng = np.random.default_rng(4)
        arr = rng.normal(size=(4, 5, 6))
        arr[1, 2, 3] = np.nan
        arr[3, 0, 0] = -np.inf
        np.testing.assert_array_equal(
            tguards.chunk_finite_ok(torch.from_numpy(arr)).numpy(),
            jguards.chunk_finite_ok(arr))
        np.testing.assert_array_equal(
            tguards.sanitize_chunks(torch.from_numpy(arr)).numpy(),
            jguards.sanitize_chunks(arr))
        curves = np.stack([np.arange(5.0), np.full(5, 2.0),
                           [np.nan, np.nan, 1, 2, np.nan]])
        np.testing.assert_array_equal(
            tguards.curve_health(torch.from_numpy(curves)).numpy(),
            jguards.curve_health(curves))
        flags = [np.array([True, False, True]), np.array([True, True, False]),
                 np.array([False, True, True]), np.array([True, False, False])]
        np.testing.assert_array_equal(
            tguards.health_code(*[torch.from_numpy(f) for f in flags])
            .numpy(), jguards.health_code(*flags))
        assert tguards.describe_health(5) == jguards.describe_health(5)
        with pytest.raises(ValueError):
            tguards.health_code()


class TestMultiChunkSearch:
    def test_matches_jax_fused(self):
        """η rel 1e-2 as tests/test_fused_search.py:179-192 (the JAX
        side's CPU default is its XLA η-scan, not the warm-start
        squaring algorithm, so only the fitted peak is compared)."""
        chunks, tlist, freqs, etas, edges, _, npad = _arc_chunks(seed=19)
        ref = jsearch.multi_chunk_search(chunks, freqs, tlist, etas, edges,
                                         fw=0.3, npad=npad, backend="jax")
        ours = tsearch.multi_chunk_search(chunks, freqs, tlist, etas,
                                          edges, fw=0.3, npad=npad,
                                          device="cpu")
        for r, o in zip(ref, ours):
            assert np.isfinite(o.eta) and o.ok == r.ok == 0
            assert o.eta == pytest.approx(r.eta, rel=1e-2)
            assert o.time_mean == r.time_mean
            assert o.freq_mean == r.freq_mean
            assert o.healthy and o.health == ["ok"]

    def test_single_chunk_runs_fused(self):
        chunks, tlist, freqs, etas, edges, eta_true, npad = _arc_chunks(
            nchunk=1)
        res = tsearch.multi_chunk_search(chunks, freqs, tlist, etas, edges,
                                         fw=0.3, npad=npad, device="cpu")
        assert len(res) == 1
        assert res[0].eta == pytest.approx(eta_true, rel=0.5)

    def test_nan_lane_quarantined_neighbours_bitwise(self):
        chunks, tlist, freqs, etas, edges, _, npad = _arc_chunks(
            nchunk=4, seed=11)
        clean = tsearch.multi_chunk_search(chunks, freqs, tlist, etas,
                                           edges, npad=npad, device="cpu")
        bad = [c.copy() for c in chunks]
        bad[2] = faults.inject_nan_pixels(bad[2], frac=0.05, seed=2)
        res = tsearch.multi_chunk_search(bad, freqs, tlist, etas, edges,
                                         npad=npad, device="cpu")
        for b in (0, 1, 3):
            assert res[b].ok == tguards.OK
            assert np.array_equal(res[b].eigs, clean[b].eigs)
            assert res[b].eta == clean[b].eta
            assert res[b].eta_sig == clean[b].eta_sig
        assert res[2].ok & tguards.BAD_INPUT
        assert not np.isfinite(res[2].eta)
        assert not np.isfinite(res[2].eta_sig)
        assert res[2].popt is None

    def test_geometry_cache_reuses_the_built_search(self):
        chunks, tlist, freqs, etas, edges, _, npad = _arc_chunks(nchunk=2)
        tsearch.multi_chunk_search(chunks, freqs, tlist, etas, edges,
                                   npad=npad, device="cpu")
        n = len(tsearch._FUSED_CACHE)
        tsearch.multi_chunk_search(chunks, freqs, tlist, etas, edges,
                                   npad=npad, device="cpu")
        assert len(tsearch._FUSED_CACHE) == n

    def test_tau_length_mismatch_raises(self):
        chunks, tlist, freqs, etas, edges, _, npad = _arc_chunks(nchunk=1)
        tau = tcore.fft_axis(freqs, pad=npad)
        fd = tcore.fft_axis(tlist[0], pad=npad, scale=1e3)
        with pytest.raises(ValueError):
            tbatch.make_fused_search_fn(tau, fd, edges, 32, 32, npad=3,
                                        device="cpu")
