"""The port's warm-start eigensolver (scintools_tpu_torch/thth/eig.py)
against the JAX package's Pallas kernel (interpret mode) and dense
``eigvalsh``, on the CPU through the plain PyTorch version.

Inputs are made with numpy from fixed seeds and handed to both sides.
"""

import numpy as np
import pytest
import torch

from scintools_tpu.thth import pallas_eig as jeig
from scintools_tpu.thth.search import fit_eig_peak
from scintools_tpu_torch.thth import eig as teig


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)       # tier-1 runs under xdist workers
    yield
    torch.set_num_threads(n)


def _random_hermitian(rng, n, batch):
    a = (rng.normal(size=(batch, n, n))
         + 1j * rng.normal(size=(batch, n, n)))
    return (a + np.conj(np.transpose(a, (0, 2, 1)))) / 2


def _top(mats):
    return np.array([np.linalg.eigvalsh(m)[-1] for m in mats])


def _drift(seed=5, n=32, B=2, neta=12):
    rng = np.random.default_rng(seed)
    base = _random_hermitian(rng, n, B)
    drift = _random_hermitian(rng, n, B) * 0.01
    return np.stack([base + k * drift for k in range(neta)], axis=1)


def _crossing_batch(n=32, nsteps=24, eps=0.02, seed=13):
    """The avoided crossing of tests/test_pallas_eig.py:136-153."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n))
                        + 1j * rng.normal(size=(n, n)))
    u, w = q[:, 0:1], q[:, 1:2]
    junk = _random_hermitian(rng, n, 1)[0] * 0.02
    mats = []
    for t in np.linspace(0.0, 1.0, nsteps):
        lam_a, lam_b = 2.0 - t, 1.2 + t
        A = (lam_a * (u @ np.conj(u.T)) + lam_b * (w @ np.conj(w.T))
             + eps * (u @ np.conj(w.T) + w @ np.conj(u.T)) + junk)
        mats.append((A + np.conj(A.T)) / 2)
    return np.array(mats)


def _port(mats, n, **kw):
    a = torch.from_numpy(teig.pack_padded(mats, n))
    return teig.batched_eig_warmstart(a, n // 2, **kw).numpy()


class TestPackAndPad:
    def test_pack_matches_jax_wire_format(self):
        mats = _random_hermitian(np.random.default_rng(1), 30, 3)
        ours = teig.pack_padded(mats, 30)
        np.testing.assert_array_equal(ours, jeig.pack_padded(mats, 30))
        assert ours.flags.c_contiguous
        assert teig.pad_to_multiple(255) == jeig.pad_to_multiple(255) == 256


class TestPlainVsPallas:
    def test_smooth_drift_matches_interpret_kernel(self):
        """rtol 1e-4: both run the same float32 algorithm; only the
        summation order of the matrix products differs."""
        import jax.numpy as jnp

        mats = _drift()
        n = mats.shape[-1]
        a = teig.pack_padded(mats, n)
        ref = np.asarray(jeig.batched_eig_warmstart(
            jnp.asarray(a), n // 2, interpret=True))
        ours = _port(mats, n)
        assert ours.shape == ref.shape == mats.shape[:2]
        np.testing.assert_allclose(ours, ref, rtol=1e-4)
        # and both track the dense eigenvalue (rtol 1e-3 as the
        # TPU kernel's own smooth-drift gate)
        exact = _top(mats.reshape(-1, n, n)).reshape(mats.shape[:2])
        np.testing.assert_allclose(ours, exact, rtol=1e-3)

    def test_cpu_path_launches_no_kernel(self):
        before = teig.batched_eig_warmstart.launches
        _port(_drift(B=1, neta=3), 32)
        assert teig.batched_eig_warmstart.launches == before


class TestWarmStartCrossing:
    """tests/test_pallas_eig.py:155-255 re-run on the port."""

    def test_warm_tracks_through_crossing(self):
        mats = _crossing_batch()
        eigv = np.sort(np.linalg.eigvalsh(mats), axis=1)
        lam1, lam2 = eigv[:, -1], eigv[:, -2]
        lam = _port(mats[None], mats.shape[-1])[0]
        near = (lam1 - lam2) < 0.05 * lam1
        np.testing.assert_allclose(lam[~near], lam1[~near], rtol=5e-3)
        assert np.all(lam[near] > lam2[near] * (1 - 5e-3))
        assert np.all(lam[near] < lam1[near] * (1 + 5e-3))
        tail = slice(2 * len(lam) // 3, None)
        np.testing.assert_allclose(lam[tail], lam1[tail], rtol=5e-3)

    def test_crossing_inside_peak_window_eta_fit_tolerance(self):
        n, neta = 32, 41
        etas = np.linspace(0.85, 1.15, neta)
        rng = np.random.default_rng(17)
        q, _ = np.linalg.qr(rng.normal(size=(n, n))
                            + 1j * rng.normal(size=(n, n)))
        u, w = q[:, 0:1], q[:, 1:2]
        junk = _random_hermitian(rng, n, 1)[0] * 0.01
        mats = []
        for e in etas:
            lam_a = 2.0 - 3.0 * (e - 1.0) ** 2
            lam_b = 2.05 - 200.0 * (e - 1.02) ** 2
            A = (lam_a * (u @ np.conj(u.T)) + lam_b * (w @ np.conj(w.T))
                 + 0.02 * (u @ np.conj(w.T) + w @ np.conj(u.T)) + junk)
            mats.append((A + np.conj(A.T)) / 2)
        mats = np.array(mats)
        eigv = np.sort(np.linalg.eigvalsh(mats), axis=1)
        lam1, lam2 = eigv[:, -1], eigv[:, -2]
        lam = _port(mats[None], n)[0]
        assert np.all(lam <= lam1 * (1 + 5e-3))
        assert np.all(lam >= lam2 * (1 - 5e-3))
        eta_dense, sig_dense = fit_eig_peak(etas, lam1, fw=0.1)
        eta_port, sig_port = fit_eig_peak(etas, lam, fw=0.1)
        assert np.isfinite(eta_port)
        assert abs(eta_port - eta_dense) < 0.01 * eta_dense
        if np.isfinite(sig_dense) and sig_dense > 0:
            assert abs(eta_port - eta_dense) < 3 * max(sig_dense, sig_port)


class TestColdBranch:
    @pytest.mark.parametrize("n, batch", [(48, 6), (30, 3)])
    def test_matches_dense_eigh(self, n, batch):
        """neta=1 runs only the cold squaring start; rtol 2e-4 as the
        TPU kernel's own gate (15 float32 squarings)."""
        mats = _random_hermitian(np.random.default_rng(n), n, batch)
        lam = _port(mats[:, None], n)[:, 0]
        np.testing.assert_allclose(lam, _top(mats), rtol=2e-4)

    def test_cold_stats_count(self):
        stats = {}
        a = torch.from_numpy(teig.pack_padded(_drift(B=2, neta=4), 32))
        teig.batched_eig_warmstart_plain(a, 16, stats=stats)
        assert stats["cold"] >= 2      # one cold start per chunk at η=0

    def test_zero_matrix_gives_zero(self):
        a = torch.zeros((2, 3, 2, 128, 128), dtype=torch.float32)
        lam = teig.batched_eig_warmstart(a, 64).numpy()
        np.testing.assert_allclose(lam, 0.0, atol=1e-6)


class TestColdOnlyVsPallas:
    """``batched_eig_cold_plain`` (the counterpart of JAX's
    ``batched_eig_squaring_xla``) against the cold-only Pallas kernel in
    interpret mode and its XLA twin, on tests/test_pallas_eig.py's
    fixtures: rtol 1e-5 against both (the same float32 squarings; only
    the summation order differs), 2e-4 against ``eigvalsh`` (the JAX
    kernel's own gate)."""

    @pytest.mark.parametrize("n, batch", [(40, 4), (48, 6), (30, 3)])
    def test_matches_pallas_interpret_and_xla(self, rng, n, batch):
        import jax.numpy as jnp

        mats = _random_hermitian(rng, n, batch)
        a = teig.pack_padded(mats, n)
        ref_p = np.asarray(jeig.batched_eig_pallas(jnp.asarray(a), n // 2,
                                                   interpret=True))
        ref_x = np.asarray(jeig.batched_eig_squaring_xla(jnp.asarray(a),
                                                         n // 2))
        before = teig.batched_eig_cold.launches
        got = teig.batched_eig_cold(torch.from_numpy(a), n // 2).numpy()
        assert teig.batched_eig_cold.launches == before    # CPU: no kernel
        assert got.shape == (batch,)
        np.testing.assert_allclose(got, ref_p, rtol=1e-5)
        np.testing.assert_allclose(got, ref_x, rtol=1e-5)
        np.testing.assert_allclose(got, _top(mats), rtol=2e-4)

    def test_equals_the_warm_solvers_first_step(self):
        """The cold start is the first step of every warm chain."""
        mats = _drift(B=3, neta=2)
        a = torch.from_numpy(teig.pack_padded(mats, 32))
        cold = teig.batched_eig_cold_plain(a[:, 0].contiguous(), 16)
        warm = teig.batched_eig_warmstart_plain(a, 16)[:, 0]
        assert torch.equal(cold, warm)

    def test_zero_matrix_and_squarings(self):
        z = torch.zeros((2, 2, 128, 128))
        np.testing.assert_allclose(teig.batched_eig_cold(z, 64).numpy(), 0.0,
                                   atol=1e-6)
        import jax.numpy as jnp

        mats = _random_hermitian(np.random.default_rng(2), 40, 2)
        a = teig.pack_padded(mats, 40)
        for sq in (0, 3):
            np.testing.assert_allclose(
                teig.batched_eig_cold(torch.from_numpy(a), 20, sq).numpy(),
                np.asarray(jeig.batched_eig_squaring_xla(jnp.asarray(a), 20,
                                                         sq)), rtol=1e-5)
        with pytest.raises(ValueError):
            teig.batched_eig_cold_plain(torch.zeros((2, 128, 128)), 64)


class TestKernelDispatch:
    def test_unsupported_device_raises(self):
        a = torch.zeros((1, 1, 2, 128, 128), device="meta")
        with pytest.raises(ValueError):
            teig.batched_eig_warmstart(a, 64)
        with pytest.raises(ValueError):
            teig.batched_eig_cold(a[0], 64)

    def test_kernel_matches_plain_on_card(self):
        """On a CUDA card: the hand-written kernel against its plain
        version on the same device, rtol 1e-4 on the smooth-drift
        batch (different float32 summation order only)."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        mats = _drift(n=200, B=3, neta=6)
        a = torch.from_numpy(teig.pack_padded(mats, 200)).cuda()
        before = teig.batched_eig_warmstart.launches
        kern = teig.batched_eig_warmstart(a, 100)
        plain = teig.batched_eig_warmstart_plain(a, 100)
        torch.cuda.synchronize()
        assert teig.batched_eig_warmstart.launches == before + 1
        np.testing.assert_allclose(kern.cpu().numpy(), plain.cpu().numpy(),
                                   rtol=1e-4)
