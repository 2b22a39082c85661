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

    def test_stats_count_one_cold_start_a_matrix(self):
        a = torch.from_numpy(teig.pack_padded(_drift(B=3, neta=1)[:, 0], 32))
        stats = {"cold": 2}
        teig.batched_eig_cold(a, 16, stats=stats)
        assert stats["cold"] == 5

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


_SMEM_MAX = 232448     # the dynamic shared memory an H100 block can use


def _h100_smem(n, c, nbuf):
    """A stand-in for the kernel's layout on an H100: ``nbuf`` bands of
    N/c rows × N × (re, im) float32 beside ≈ 90 kB of squaring stage,
    vectors and mailbox; 0 where a block cannot have that much."""
    need = 90_000 + nbuf * 2 * (n // c) * n * 4
    return need if need <= _SMEM_MAX else 0


def _h100_resident(c, smem):
    """Clusters resident at once on a card of 132 SMs that holds one CTA
    of this kernel per SM and seats every cluster size evenly."""
    return 132 // c if 0 < smem <= _SMEM_MAX else 0


class TestClusterPlan:
    """``_cluster_plan``: the largest C ≤ 16 whose band fits in shared
    memory and whose G clusters are all resident; where none seats all
    G, the smallest C that fits takes what it seats and the rest is
    planned again; where no C holds the band, it is read from L2
    (nbuf 0). The card's answers are stand-ins here."""

    @pytest.mark.parametrize("G, n, want", [
        (32, 256, (4, 1)),       # the north-star group: 128 SMs
        (8, 256, (16, 2)),       # a façade row of 8 chunks
        (9, 256, (8, 2)),        # the 4096² retrieval's 9 chains
        (32, 128, (4, 2)),
        (8, 128, (16, 2)),       # 8 rows per CTA
        (8, 384, (16, 1)),       # only C = 16's band fits, and only one
        (8, 768, (16, 0)),       # no C holds the band: read from L2
        (32, 768, (4, 0)),
        (0, 256, (16, 2)),
    ])
    def test_one_launch(self, G, n, want):
        (g, c, nbuf, smem), = teig._cluster_plan(G, n, _h100_smem,
                                                 _h100_resident)
        assert (g, c, nbuf) == (G, *want)
        assert smem == _h100_smem(n, c, nbuf) > 0
        assert n % (8 * c) == 0

    @pytest.mark.parametrize("G, n, resident, want", [
        # the H100 seats 30 clusters of 4, 15 of 8, 7 of 16
        (32, 256, {4: 30, 8: 15, 16: 7}, [(30, 4), (2, 16)]),
        (16, 256, {4: 30, 8: 15, 16: 7}, [(16, 4)]),
        (64, 256, {4: 30, 8: 15, 16: 7}, [(30, 4), (30, 4), (4, 16)]),
        (32, 384, {4: 30, 8: 15, 16: 7}, [(7, 16)] * 4 + [(4, 16)]),
        (32, 256, {4: 0, 8: 0, 16: 0}, [(32, 4)]),      # none resident
    ])
    def test_too_few_resident_clusters(self, G, n, resident, want):
        plan = teig._cluster_plan(G, n, _h100_smem, lambda c, s: resident[c])
        assert [(g, c) for g, c, _, _ in plan] == want
        assert sum(g for g, *_ in plan) == G

    def test_the_layout_is_the_cards(self):
        """The plan takes its sizes from the card's answer alone: with
        room for every band it double-buffers at the largest C; with room
        for none it reads the band from L2 at the size the card gives for
        that, whatever it is."""
        roomy = teig._cluster_plan(8, 256, lambda n, c, b: 1000 + b,
                                   _h100_resident)
        assert roomy == [(8, 16, 2, 1002)]
        tight = teig._cluster_plan(8, 256, lambda n, c, b: 0 if b else 7,
                                   lambda c, s: 132 // c)
        assert tight == [(8, 16, 0, 7)]


def _tf32(x):
    """Round float32 to TF32 (10 explicit mantissa bits): round to
    nearest, ties away from zero, then clear the low 13 bits — the
    card's ``cvt.rna.tf32.f32``."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_mm(x, y):
    """x @ y as split TF32: hi·hi + hi·lo + lo·hi in float32, each part
    rounded to TF32 (the products of two TF32 values are exact in f32)."""
    xh, yh = _tf32(x), _tf32(y)
    xl, yl = _tf32(x - xh), _tf32(y - yh)
    return xh @ yl + xl @ yh + xh @ yh


def _split_cold(ar, ai, mid, squarings=10, mm=_split_mm):
    """The cold start (``teig._eig_body``) with every squaring's products
    in split TF32, as the card kernel runs them on the tensor cores; the
    mat-vecs stay float32 (``mm``: the matrix product). Returns (λ, vr,
    vi, residual)."""
    def sq(br, bi):
        cr = mm(br, br) - mm(bi, bi)
        ci = mm(br, bi) + mm(bi, br)
        nrm = torch.sqrt((cr * cr + ci * ci).sum(dim=(-2, -1)))[:, None,
                                                                None] + 1e-30
        return cr / nrm, ci / nrm

    cr, ci = sq(ar, ai)
    for _ in range(4):
        cr, ci = sq(cr, ci)
    vr, vi = cr[:, :, mid:mid + 1], ci[:, :, mid:mid + 1]
    ur, ui = teig._complex_mv(ar, ai, vr, vi)
    rho = torch.sqrt((teig._sum(ur * ur + ui * ui) + 1e-30)
                     / (teig._sum(vr * vr + vi * vi) + 1e-30))
    n = ar.shape[-1]
    br = ar + 1.05 * rho[:, None, None] * torch.eye(n)
    bi = ai
    for _ in range(squarings):
        br, bi = sq(br, bi)
    vr, vi = teig._complex_mv(br, bi, ar[:, :, mid:mid + 1],
                              ai[:, :, mid:mid + 1])
    nrm = torch.sqrt(teig._sum(vr * vr + vi * vi))[:, None, None] + 1e-30
    return teig._rayleigh(ar, ai, vr / nrm, vi / nrm)


class TestSplitTf32Emulation:
    """The card kernel runs the cold start's squarings on the tensor
    cores as split TF32. Emulated here in plain PyTorch on N = 256
    batches, λ agrees with the float32 cold start and with the JAX
    cold-only kernel (interpret mode) to 2e-5 relative where the top
    eigenvalue has a 5% gap and to 2e-4 (the cold start's own gate
    against ``eigvalsh``) everywhere. λ is a Rayleigh quotient, second
    order in the vector's error, so the vector is held too: the unit
    vector lies within 1e-5 (L2) of the float32 cold start's, where
    plain TF32 (one product) lands 1e-4 or more away."""

    @staticmethod
    def _batch(kind):
        n = 256
        if kind == "random":
            mats = _random_hermitian(np.random.default_rng(256), n, 3)
        elif kind == "drift":
            rng = np.random.default_rng(8)
            u = rng.normal(size=(3, n, 1)) + 1j * rng.normal(size=(3, n, 1))
            u /= np.linalg.norm(u, axis=1, keepdims=True)
            mats = (_random_hermitian(rng, n, 3) / np.sqrt(n)
                    + 3.0 * u @ np.conj(np.transpose(u, (0, 2, 1))))
        else:
            mats = _crossing_batch(n=n, nsteps=4)
        return mats

    @pytest.mark.parametrize("kind", ["random", "drift", "crossing"])
    def test_split_tf32_cold_start(self, kind):
        import jax.numpy as jnp

        mats = self._batch(kind)
        n = mats.shape[-1]
        a = teig.pack_padded(mats, n)
        t = torch.from_numpy(a)
        lam_s, vr_s, vi_s, _ = _split_cold(t[:, 0], t[:, 1], n // 2)
        lam_p, vr_p, vi_p, _ = teig._eig_body(t[:, 0], t[:, 1], n // 2, 10)
        split, plain = lam_s.numpy(), lam_p.numpy()
        ref = np.asarray(jeig.batched_eig_pallas(jnp.asarray(a), n // 2,
                                                 interpret=True))
        ev = np.sort(np.linalg.eigvalsh(mats), axis=-1)
        gapped = (ev[:, -1] - ev[:, -2]) >= 0.05 * np.abs(ev[:, -1])
        for other in (plain, ref):
            np.testing.assert_allclose(split, other, rtol=2e-4)
            np.testing.assert_allclose(split[gapped], other[gapped],
                                       rtol=2e-5)
        np.testing.assert_allclose(split, ev[:, -1], rtol=2e-4)

        def gap_v(vr, vi):
            return torch.sqrt(teig._sum((vr - vr_p) ** 2 + (vi - vi_p) ** 2))

        assert gap_v(vr_s, vi_s).max() < 1e-5
        one = _tf32    # plain TF32: one product per matrix product
        _, vr_1, vi_1, _ = _split_cold(t[:, 0], t[:, 1], n // 2,
                                       mm=lambda x, y: one(x) @ one(y))
        assert gap_v(vr_1, vi_1).min() > 1e-4
