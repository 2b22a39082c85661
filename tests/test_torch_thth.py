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
        """A single chunk leaves the fused route for ``single_search``,
        as in the JAX package (its float64 host FFT, then the η chain):
        held to JAX ``single_search`` at the fused test's rel 1e-2, the
        health code, curve grid and means equal."""
        chunks, tlist, freqs, etas, edges, eta_true, npad = _arc_chunks(
            nchunk=1)
        ref = jsearch.single_search(chunks[0], freqs, tlist[0], etas,
                                    edges, fw=0.3, npad=npad, backend="jax")
        res = tsearch.multi_chunk_search(chunks, freqs, tlist, etas, edges,
                                         fw=0.3, npad=npad, device="cpu")
        assert len(res) == 1
        assert np.isfinite(ref.eta) and res[0].ok == ref.ok == 0
        assert res[0].eta == pytest.approx(ref.eta, rel=1e-2)
        assert res[0].eta == pytest.approx(eta_true, rel=0.05)
        np.testing.assert_array_equal(res[0].etas, ref.etas)
        assert res[0].time_mean == ref.time_mean
        assert res[0].freq_mean == ref.freq_mean

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


# ---------------------------------------------------------------------
# the host θ-θ core and the single-chunk search
# ---------------------------------------------------------------------

def _one_chunk(seed=7, nchunk=1):
    chunks, tlist, freqs, etas, edges, eta_true, npad = _arc_chunks(
        nchunk=nchunk, seed=seed)
    CS, tau, fd = jsearch.chunk_conjugate_spectrum(chunks[0], tlist[0],
                                                   freqs, npad=npad)
    return chunks, tlist, freqs, etas, edges, eta_true, npad, CS, tau, fd


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    """max |a − b| over max |b|."""
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / np.abs(b).max()


class TestCoreVsJax:
    """``thth/core.py`` and the single-chunk search against the JAX
    package (x64 on the CPU). The index maps are the same float64
    floors, so masks, reduced edges and bins are equal; values differ by
    the port's complex64."""

    @pytest.mark.parametrize("scale", [0.5, 1.0, 1.7])
    @pytest.mark.parametrize("hermetian", [True, False])
    def test_thth_map_redmap_and_mask(self, scale, hermetian):
        from scintools_tpu.thth import core as jcore

        *_, edges, eta_true, _, CS, tau, fd = _one_chunk()
        eta = scale * eta_true
        np.testing.assert_array_equal(
            tcore.redmap_mask(tau, fd, eta, edges),
            jcore.redmap_mask(tau, fd, eta, edges))
        want = np.asarray(jcore.thth_map(CS, tau, fd, eta, edges,
                                         hermetian=hermetian,
                                         backend="jax"))
        got = tcore.thth_map(CS, tau, fd, eta, edges, hermetian=hermetian,
                             device="cpu")
        assert got.dtype == torch.complex64
        np.testing.assert_array_equal(_np(got) != 0, want != 0)
        assert _rel(got, want) < 1e-6
        want_r, e_want = jcore.thth_redmap(CS, tau, fd, eta, edges,
                                           hermetian=hermetian,
                                           backend="jax")
        got_r, e_got = tcore.thth_redmap(CS, tau, fd, eta, edges,
                                         hermetian=hermetian, device="cpu")
        np.testing.assert_array_equal(e_got, e_want)
        assert got_r.shape == np.shape(want_r)
        assert _rel(got_r, want_r) < 1e-6

    def test_thth_redmap_raises_without_a_valid_square(self):
        *_, edges, _, _, CS, tau, fd = _one_chunk()
        for eta in (np.nan, 1e9):
            with pytest.raises(ValueError):
                tcore.thth_redmap(CS, tau, fd, eta, edges, device="cpu")
        assert not tcore.thth_map(CS, tau, fd, np.nan, edges,
                                  device="cpu").any()

    @pytest.mark.parametrize("hermetian", [True, False])
    def test_rev_map(self, hermetian):
        """rel 1e-5 of the largest bin on a θ-θ with a zero diagonal
        (the hermitian map's), so no bin divides a value by f_D = 0."""
        from scintools_tpu.thth import core as jcore

        *_, edges, eta_true, _, CS, tau, fd = _one_chunk()
        thth, e_red = jcore.thth_redmap(CS, tau, fd, eta_true, edges,
                                        backend="jax")
        thth = np.asarray(thth)
        want = np.asarray(jcore.rev_map(thth, tau, fd, eta_true, e_red,
                                        hermetian=hermetian, backend="jax"))
        got = tcore.rev_map(thth, tau, fd, eta_true, e_red,
                            hermetian=hermetian, device="cpu")
        assert got.shape == want.shape == (len(tau), len(fd))
        assert _rel(got, want) < 1e-5

    def test_dominant_eig_power(self):
        from scintools_tpu.thth import core as jcore

        *_, edges, eta_true, _, CS, tau, fd = _one_chunk()
        thth = np.asarray(jcore.thth_redmap(CS, tau, fd, eta_true, edges,
                                            backend="jax")[0])
        lam_j, v_j = jcore.dominant_eig_power(thth, backend="jax")
        lam_t, v_t = tcore.dominant_eig_power(thth, device="cpu")
        assert float(lam_t) == pytest.approx(float(lam_j), rel=1e-5)
        v_j = np.asarray(v_j)
        corr = np.abs(np.vdot(v_j, _np(v_t))) / (
            np.linalg.norm(v_j) * np.linalg.norm(_np(v_t)))
        assert corr > 1 - 1e-5
        # a batch iterates together: each matrix as alone
        lam_b, _ = tcore.dominant_eig_power(
            torch.as_tensor(np.stack([thth, 2 * thth])))
        np.testing.assert_allclose(_np(lam_b), [float(lam_t),
                                                2 * float(lam_t)],
                                   rtol=1e-6)
        assert tcore.eval_calc(CS, tau, fd, eta_true, edges,
                               device="cpu") == pytest.approx(
            jcore.eval_calc(CS, tau, fd, eta_true, edges, backend="jax"),
            rel=1e-5)

    def test_eval_calc_batch_power(self):
        from scintools_tpu.thth import core as jcore

        *_, etas, edges, _, _, CS, tau, fd = _one_chunk()
        want = jcore.eval_calc_batch(CS, tau, fd, etas, edges,
                                     backend="jax", method="power")
        got = tcore.eval_calc_batch(CS, tau, fd, etas, edges, device="cpu",
                                    method="power")
        assert got.shape == want.shape == etas.shape
        np.testing.assert_allclose(got, want, rtol=1e-4)

    def test_eval_calc_batch_auto_is_the_warm_start(self):
        """``"auto"`` walks the η grid as one warm-start chain (the plain
        version on the CPU): held to the JAX Pallas kernel in interpret
        mode at rel 1e-4; ``make_eval_fn`` is its B = 1 wrapper, and a
        repeated call reuses the built function."""
        import jax.numpy as jnp
        from scintools_tpu.thth import core as jcore

        *_, etas, edges, _, _, CS, tau, fd = _one_chunk()
        want = np.asarray(jcore.make_eval_fn(
            tau, fd, edges, method="pallas", interpret=True)(
                jnp.asarray(jcore.cs_to_ri(CS)), jnp.asarray(etas)))
        got = tcore.eval_calc_batch(CS, tau, fd, etas, edges, device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-4)
        n = len(tcore._EVAL_CACHE)
        again = tcore.eval_calc_batch(CS, tau, fd, etas, edges,
                                      device="cpu")
        assert len(tcore._EVAL_CACHE) == n
        np.testing.assert_array_equal(again, got)
        fn = tcore.make_eval_fn(tau, fd, edges, method="auto",
                                device="cpu")
        one = fn(torch.as_tensor(tcore.cs_to_ri(CS), dtype=torch.float32),
                 etas)
        np.testing.assert_array_equal(_np(one), got.astype(np.float32))
        # "square" is the JAX package's cold squaring start per η
        # (rtol 1e-5, as tests/test_torch_eig.py holds the cold start);
        # a name neither package knows raises
        want_sq = np.asarray(jcore.make_eval_fn(
            tau, fd, edges, method="square")(
                jnp.asarray(jcore.cs_to_ri(CS)), jnp.asarray(etas)))
        sq = tcore.make_eval_fn(tau, fd, edges, method="square",
                                device="cpu")
        np.testing.assert_allclose(
            _np(sq(torch.as_tensor(tcore.cs_to_ri(CS), dtype=torch.float32),
                   etas)), want_sq, rtol=1e-5)
        with pytest.raises(ValueError, match="unknown method"):
            tcore.make_eval_fn(tau, fd, edges, method="bogus",
                               device="cpu")

    @pytest.mark.parametrize("hermetian", [True, False])
    def test_modeler_and_chisq(self, hermetian):
        """rel 1e-4. The reference's rank-1 model keeps its diagonal,
        whose ``rev_map`` weight divides by f_D = 0: its f_D = τ = 0 bin
        holds the dtype's largest value after ``nan_to_num`` (float64's
        there, float32's here), so ``model`` is that value over the bin
        count everywhere and χ² is inf in both packages. Every other bin
        of ``recov`` is held at rel 1e-4; ``model`` over its dtype's
        largest value likewise."""
        from scintools_tpu.thth import core as jcore

        chunks, *_, edges, eta_true, _, CS, tau, fd = _one_chunk()
        want = jcore.modeler(CS, tau, fd, eta_true, edges,
                             hermetian=hermetian, backend="jax")
        got = tcore.modeler(CS, tau, fd, eta_true, edges,
                            hermetian=hermetian, device="cpu")
        assert len(got) == len(want) == 8 - hermetian
        for k in (0, 1):
            assert _rel(got[k], want[k]) < 1e-4
        np.testing.assert_array_equal(got[4], want[4])
        r_j, r_t = np.asarray(want[2]), _np(got[2])
        huge = np.abs(r_j) > 1e300
        np.testing.assert_array_equal(np.abs(r_t) > 1e38, huge)
        assert huge.sum() == 1
        assert _rel(np.where(huge, 0, r_t), np.where(huge, 0, r_j)) < 1e-4
        m_j = np.asarray(want[3]) / np.finfo(np.float64).max
        m_t = _np(got[3]) / np.finfo(np.float32).max
        assert _rel(m_t, m_j) < 1e-4
        if hermetian:
            assert got[5] == pytest.approx(want[5], rel=1e-4)
            dspec = chunks[0] - chunks[0].mean()
            with np.errstate(over="ignore"):
                want_c = jcore.chisq_calc(dspec, CS, tau, fd, eta_true,
                                          edges, 1.0, backend="jax")
            got_c = tcore.chisq_calc(dspec, CS, tau, fd, eta_true, edges,
                                     1.0, device="cpu")
            assert got_c == want_c == np.inf
        else:
            assert got[6] == pytest.approx(want[6], rel=1e-4)

    def test_arc_geometry_helpers(self):
        from scintools_tpu.thth import core as jcore

        x = np.linspace(-3, 3, 11)
        np.testing.assert_array_equal(tcore.len_arc(x, 0.3),
                                      jcore.len_arc(x, 0.3))
        for n in (16, 33):
            np.testing.assert_array_equal(
                tcore.arc_edges(0.3, 0.5, 0.2, 7.0, n),
                jcore.arc_edges(0.3, 0.5, 0.2, 7.0, n))
        y = np.linspace(0, 2, 5)
        assert tcore.ext_find(x, y) == jcore.ext_find(x, y)

    def test_pad_chunk_and_conjugate_spectrum(self):
        """``pad_chunk`` equal; the float64 host spectrum to rel 1e-12
        (both numpy)."""
        chunks, tlist, freqs, *_ = _one_chunk()
        for fill in ("mean", "zero"):
            np.testing.assert_array_equal(
                tsearch.pad_chunk(chunks[0], 2, fill=fill),
                jsearch.pad_chunk(chunks[0], 2, fill=fill))
        for tau_mask in (0.0, 0.5):
            want = jsearch.chunk_conjugate_spectrum(
                chunks[0], tlist[0], freqs, npad=1, tau_mask=tau_mask)
            got = tsearch.chunk_conjugate_spectrum(
                chunks[0], tlist[0], freqs, npad=1, tau_mask=tau_mask)
            assert got[0].dtype == np.complex128
            assert _rel(got[0], want[0]) < 1e-12
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])

    @pytest.mark.parametrize("coher", [True, False])
    def test_single_search(self, coher):
        """η rel 1e-2 against JAX ``single_search`` (whose CPU route is
        its power iteration; the port's the warm-start chain)."""
        chunks, tlist, freqs, etas, edges, eta_true, npad, *_ = \
            _one_chunk(seed=19)
        want = jsearch.single_search(chunks[0], freqs, tlist[0], etas,
                                     edges, fw=0.3, npad=npad, coher=coher,
                                     backend="jax")
        got = tsearch.single_search(chunks[0], freqs, tlist[0], etas, edges,
                                    fw=0.3, npad=npad, coher=coher,
                                    device="cpu")
        assert got.ok == want.ok
        assert np.isfinite(got.eta)
        assert got.eta == pytest.approx(want.eta, rel=1e-2)
        assert got.popt is not None and len(got.eigs) == len(got.etas)

    def test_single_search_quarantines_a_corrupt_chunk(self):
        chunks, tlist, freqs, etas, edges, _, npad, *_ = _one_chunk()
        bad = faults.inject_nan_pixels(chunks[0], frac=0.05, seed=2)
        want = jsearch.single_search(bad, freqs, tlist[0], etas, edges,
                                     npad=npad, backend="jax")
        got = tsearch.single_search(bad, freqs, tlist[0], etas, edges,
                                    npad=npad, device="cpu")
        assert got.ok == want.ok and got.ok & tguards.BAD_INPUT
        assert not np.isfinite(got.eta) and got.popt is None
