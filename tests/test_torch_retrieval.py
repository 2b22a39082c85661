"""The port's wavefield retrieval (scintools_tpu_torch/thth/retrieval.py
and the chunk-chained eigensolver of thth/eig.py) against the JAX
package on the CPU.

Inputs are made with numpy from fixed seeds (the arc chunks of
tests/test_retrieval_batch.py: 64² chunks, 22 edges so N = 128, npad 1,
η 0.3) and handed to both sides. The JAX side runs under x64 and its
Pallas kernel in interpret mode; the port computes in float32 /
complex64, so most gates are the JAX package's own cross-precision
ones. Eigenvector phase is arbitrary: wavefield chunks are compared by
phase-aligned correlation |⟨a, b⟩| / (‖a‖‖b‖), stitched wavefields by
intensity |E|².
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scintools_tpu.robust import guards as jguards
from scintools_tpu.thth import pallas_eig as jeig
from scintools_tpu.thth import retrieval as jret
from scintools_tpu_torch.robust import guards
from scintools_tpu_torch.thth import eig as teig
from scintools_tpu_torch.thth import retrieval as tret

ETA = 0.3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)       # tier-1 runs under xdist workers
    yield
    torch.set_num_threads(n)


def make_arc_chunks(n_chunks=3, nt=64, nf=64, dt=30.0, df=0.2, f0=1400.0,
                    npix=8, seed=2):
    """tests/test_retrieval_batch.py:34-60: chunks carrying a
    known-curvature arc, each a tiny perturbation of the first."""
    rng = np.random.default_rng(seed)
    times = np.arange(nt) * dt
    freqs = f0 + np.arange(nf) * df
    dfd_pad = 1e3 / (2 * nt * dt)
    fd_k = np.arange(-npix, npix + 1) * dfd_pad
    tau_k = ETA * fd_k ** 2
    amps = ((0.05 + 0.3 * rng.random(len(fd_k))
             * np.exp(-(fd_k / 1.2) ** 2))
            * np.exp(2j * np.pi * rng.random(len(fd_k))))
    amps[len(fd_k) // 2] = 3.0
    F, T = np.meshgrid(freqs - f0, times, indexing="ij")
    E = np.zeros((nf, nt), dtype=complex)
    for a, td, fdk in zip(amps, tau_k, fd_k):
        E += a * np.exp(2j * np.pi * (td * F + fdk * 1e-3 * T))
    dspec0 = np.abs(E) ** 2
    chunks = np.stack([dspec0 + 1e-9 * i * rng.standard_normal(
        dspec0.shape) for i in range(n_chunks)])
    edges = np.arange(-10.5, 11.5) * dfd_pad
    return chunks, times, freqs, edges


@pytest.fixture(scope="module")
def arc():
    chunks, times, freqs, edges = make_arc_chunks(n_chunks=6)
    return chunks, edges, times[1] - times[0], freqs[1] - freqs[0]


def _corr(a, b):
    """Phase-aligned correlation of two complex arrays."""
    a, b = np.ravel(a), np.ravel(b)
    return np.abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b)
                                    + 1e-300)


def _intensity_gap(a, b):
    """(rel L2, Pearson corr) of the intensities |a|², |b|²."""
    Ia, Ib = np.abs(a) ** 2, np.abs(b) ** 2
    return (np.linalg.norm(Ia - Ib) / np.linalg.norm(Ib),
            np.corrcoef(Ia.ravel(), Ib.ravel())[0, 1])


def _jax_E(E_ri):
    E_ri = np.asarray(E_ri)
    return E_ri[:, 0] + 1j * E_ri[:, 1]


# ---------------------------------------------------------------------
# 1. the chunk-chained eigensolver
# ---------------------------------------------------------------------

def _random_hermitian(rng, n, batch):
    a = rng.normal(size=(batch, n, n)) + 1j * rng.normal(size=(batch, n, n))
    return (a + np.conj(np.transpose(a, (0, 2, 1)))) / 2


def _drift_chain(n=48, L=10, seed=3):
    """A dominant rank-1 part plus a random background, drifting along
    the chain."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 1)) + 1j * rng.normal(size=(n, 1))
    u /= np.linalg.norm(u)
    base = (_random_hermitian(rng, n, 1)[0] / np.sqrt(n)
            + 3.0 * u @ np.conj(u.T))
    drift = _random_hermitian(rng, n, 1)[0] / np.sqrt(n) * 0.02
    return np.stack([base + k * drift for k in range(L)])


def _crossing_chain(n=48, nsteps=16, eps=0.02, seed=13):
    """The avoided crossing of tests/test_pallas_eig.py:136-153."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n))
                        + 1j * rng.normal(size=(n, n)))
    u, w = q[:, 0:1], q[:, 1:2]
    junk = _random_hermitian(rng, n, 1)[0] * 0.02
    mats = []
    for t in np.linspace(0.0, 1.0, nsteps):
        A = ((2.0 - t) * (u @ np.conj(u.T)) + (1.2 + t) * (w @ np.conj(w.T))
             + eps * (u @ np.conj(w.T) + w @ np.conj(u.T)) + junk)
        mats.append((A + np.conj(A.T)) / 2)
    return np.array(mats)


class TestEigvecPlainVsPallas:
    @pytest.mark.parametrize("make", [_drift_chain, _crossing_chain],
                             ids=["drift", "crossing"])
    def test_matches_interpret_kernel(self, make):
        """λ within rtol 1e-4 and v phase-aligned correlation > 0.9999
        where λ₁−λ₂ ≥ 5%·λ₁ (both run the same float32 algorithm; only
        the summation order differs). At near-degenerate points the
        restart test may branch differently (T3): there λ lies within
        [λ₂, λ₁] (5e-3 slack, the TPU kernel's own)."""
        mats = make()
        n = mats.shape[-1]
        a = teig.pack_padded(mats, n)
        assert a.shape[-1] == 128
        lam_j, v_j = map(np.asarray, jeig.batched_eigvec_warmstart(
            jnp.asarray(a), n // 2, interpret=True))
        lam_t, v_t = (x.numpy() for x in teig.batched_eigvec_warmstart(
            torch.from_numpy(a), n // 2))
        assert lam_t.shape == lam_j.shape == (len(mats),)
        assert v_t.shape == v_j.shape == (len(mats), 2, 128)
        ev = np.linalg.eigvalsh(mats)
        l1, l2 = ev[:, -1], ev[:, -2]
        gapped = (l1 - l2) >= 0.05 * np.abs(l1)
        assert gapped.sum() >= len(mats) // 2
        np.testing.assert_allclose(lam_t[gapped], lam_j[gapped], rtol=1e-4)
        vt = v_t[:, 0] + 1j * v_t[:, 1]
        vj = v_j[:, 0] + 1j * v_j[:, 1]
        for k in np.flatnonzero(gapped):
            assert _corr(vt[k], vj[k]) > 0.9999, k
        assert np.all(lam_t[~gapped] > l2[~gapped] * (1 - 5e-3))
        assert np.all(lam_t[~gapped] < l1[~gapped] * (1 + 5e-3))
        # the unit vector, zero in the padding
        np.testing.assert_allclose(np.linalg.norm(vt, axis=1), 1.0,
                                   rtol=1e-5)
        assert not np.any(vt[:, n:])

    def test_small_gap_underconverges_as_the_jax_kernel_does(self):
        """A 3% gap whose top two eigenvectors rotate by 0.2 rad per
        step: 64 shifted steps contract the warm error only by
        ((λ₂+1.05λ₁)/(2.05λ₁))⁶⁴ ≈ 0.39, and the 3% residual test never
        fires, so the warm start lags the dense eigenvector. The port
        lags exactly as the JAX kernel does (aligned corr > 0.9999
        between the two) while both stay below 0.999 against eigh: the
        warm routes differ from the dense route by the algorithm, not by
        the port."""
        n, L = 48, 8
        rng = np.random.default_rng(11)
        q, _ = np.linalg.qr(rng.normal(size=(n, n))
                            + 1j * rng.normal(size=(n, n)))
        junk = _random_hermitian(rng, n, 1)[0] * 0.002
        mats = []
        for k in range(L):
            c, s = np.cos(0.2 * k), np.sin(0.2 * k)
            u = c * q[:, :1] + s * q[:, 1:2]
            w = -s * q[:, :1] + c * q[:, 1:2]
            A = 2.0 * u @ np.conj(u.T) + 1.94 * w @ np.conj(w.T) + junk
            mats.append((A + np.conj(A.T)) / 2)
        mats = np.array(mats)
        a = teig.pack_padded(mats, n)
        _, v_j = jeig.batched_eigvec_warmstart(jnp.asarray(a), n // 2,
                                               iters=64, interpret=True)
        stats = {}
        _, v_t = teig.batched_eigvec_warmstart_plain(
            torch.from_numpy(a), n // 2, iters=64, stats=stats)
        assert stats["cold"] == 1                   # no restart fired
        vj = np.asarray(v_j)[:, 0, :n] + 1j * np.asarray(v_j)[:, 1, :n]
        vt = v_t.numpy()[:, 0, :n] + 1j * v_t.numpy()[:, 1, :n]
        exact = np.linalg.eigh(mats)[1][:, :, -1]
        for k in range(L):
            assert _corr(vt[k], vj[k]) > 0.9999, k
        lag_t = [_corr(vt[k], exact[k]) for k in range(L)]
        lag_j = [_corr(vj[k], exact[k]) for k in range(L)]
        assert max(lag_t[1:]) < 0.999 and max(lag_j[1:]) < 0.999
        np.testing.assert_allclose(lag_t, lag_j, rtol=1e-4)

    def test_zero_matrix_stalls_its_chain_as_the_jax_kernel_does(self):
        """A zero matrix (an all-zero chunk, or a non-finite η) zeroes
        the carried vector, and a zero vector's warm step has a zero
        residual, so the rest of the chain stays at λ = 0, v = 0 — in
        the JAX kernel and in the port alike."""
        mats = _drift_chain(L=5)
        mats[2] = 0
        a = teig.pack_padded(mats, 48)
        lam_j, v_j = map(np.asarray, jeig.batched_eigvec_warmstart(
            jnp.asarray(a), 24, iters=64, interpret=True))
        lam_t, v_t = (x.numpy() for x in teig.batched_eigvec_warmstart(
            torch.from_numpy(a), 24, iters=64))
        np.testing.assert_allclose(lam_t[:2], lam_j[:2], rtol=1e-4)
        assert not lam_t[2:].any() and not lam_j[2:].any()
        assert not v_t[2:].any() and not v_j[2:].any()

    def test_grouped_call_equals_single_chains(self):
        """G chains of L in one call against G one-chain calls. On the
        CPU a batched and a single matrix product take different BLAS
        paths that round differently in the last bit, so rtol 1e-6 here
        (the kernel, one CTA per chain, is held to equal bits on the
        card in tests/test_torch_cuda.py)."""
        chains = np.stack([_drift_chain(seed=s, L=5) for s in (3, 4, 5)])
        a = torch.from_numpy(teig.pack_padded(chains, 48))
        lam, v = teig.batched_eigvec_warmstart(a, 24)
        assert lam.shape == (3, 5) and v.shape == (3, 5, 2, 128)
        for g in range(3):
            lg, vg = teig.batched_eigvec_warmstart(a[g], 24)
            np.testing.assert_allclose(lam[g].numpy(), lg.numpy(), rtol=1e-6)
            np.testing.assert_allclose(v[g].numpy(), vg.numpy(), rtol=0,
                                       atol=1e-6)

    def test_first_of_each_chain_starts_cold(self):
        stats = {}
        chains = np.stack([_drift_chain(seed=s, L=4) for s in (3, 4)])
        teig.batched_eigvec_warmstart_plain(
            torch.from_numpy(teig.pack_padded(chains, 48)), 24, stats=stats)
        assert stats["cold"] >= 2

    def test_cpu_path_launches_no_kernel(self):
        before = teig.batched_eigvec_warmstart.launches
        a = torch.from_numpy(teig.pack_padded(_drift_chain(L=2), 48))
        teig.batched_eigvec_warmstart(a, 24)
        assert teig.batched_eigvec_warmstart.launches == before

    def test_rejects_other_ranks(self):
        with pytest.raises(ValueError):
            teig.batched_eigvec_warmstart(torch.zeros((2, 128, 128)), 64)


# ---------------------------------------------------------------------
# 2. the batched retrieval function
# ---------------------------------------------------------------------

def _port_fn(arc, method, warm_iters=64):
    chunks, edges, dt, df = arc
    return tret.make_chunk_retrieval_fn(
        64, 64, dt, df, len(edges), npad=1, method=method,
        warm_iters=warm_iters, device="cpu")


def _port_call(fn, chunks, edges_b, etas_b, tau_mask=0.0, group=None):
    E, ok = fn(torch.as_tensor(chunks, dtype=torch.float32),
               torch.as_tensor(edges_b, dtype=torch.float64),
               torch.as_tensor(etas_b, dtype=torch.float64), tau_mask,
               group=group)
    return E.numpy(), ok.numpy()


def _jax_call(arc, method, chunks, edges_b, etas_b, warm_iters=64):
    _, edges, dt, df = arc
    fn = jret.make_chunk_retrieval_fn(
        64, 64, dt, df, len(edges), npad=1, method=method,
        warm_iters=warm_iters, interpret=True)
    E_ri, ok = fn(jnp.asarray(chunks), jnp.asarray(edges_b),
                  jnp.asarray(etas_b), 0.0)
    return _jax_E(E_ri), np.asarray(ok)


class TestChunkRetrievalVsJax:
    @pytest.mark.parametrize("method, jax_method, floor", [
        ("kernel", "pallas", 0.999), ("eigh", "eigh", 0.999),
        ("kernel", "eigh", 0.99)])
    def test_per_chunk_correlation(self, arc, method, jax_method, floor):
        """Same formulation: aligned corr > 0.999 (T2: complex64 against
        x64). The kernel route against the dense solve: > 0.99, the JAX
        test's own floor (tests/test_retrieval_batch.py:163)."""
        chunks, edges, _, _ = arc
        B = 4
        edges_b, etas_b = np.tile(edges, (B, 1)), np.full(B, ETA)
        want, ok_j = _jax_call(arc, jax_method, chunks[:B], edges_b, etas_b,
                               warm_iters=24)
        got, ok_t = _port_call(_port_fn(arc, method, warm_iters=24),
                               chunks[:B], edges_b, etas_b)
        assert got.dtype == np.complex64 and got.shape == (B, 64, 64)
        np.testing.assert_array_equal(ok_t, ok_j)
        assert ok_t.tolist() == [guards.OK] * B
        for b in range(B):
            assert _corr(got[b], want[b]) > floor, b

    def test_method_names(self):
        assert tret.resolve_retrieval_method(None) == "kernel"
        for m in ("kernel", "plain", "eigh", "power"):
            assert tret.resolve_retrieval_method(m) == m
        # the JAX package's names of the chained route are the kernel's
        for m in ("auto", "pallas", "warm"):
            assert tret.resolve_retrieval_method(m, 22) == "kernel"
        with pytest.raises(ValueError):
            tret.resolve_retrieval_method("bogus")

    def test_kernel_route_is_plain_on_cpu(self, arc):
        chunks, edges, _, _ = arc
        args = (chunks[:3], np.tile(edges, (3, 1)), np.full(3, ETA))
        before = teig.batched_eigvec_warmstart.launches
        a, _ = _port_call(_port_fn(arc, "kernel"), *args)
        b, _ = _port_call(_port_fn(arc, "plain"), *args)
        np.testing.assert_array_equal(a, b)
        assert teig.batched_eigvec_warmstart.launches == before

    def test_group_must_divide_batch(self, arc):
        chunks, edges, _, _ = arc
        with pytest.raises(ValueError):
            _port_call(_port_fn(arc, "plain"), chunks[:3],
                       np.tile(edges, (3, 1)), np.full(3, ETA), group=2)


class TestGridRetrievalVsJax:
    def test_two_rows_scaled_geometry_and_tau_mask(self, arc):
        """Two frequency rows of 3 chunks with their own η and scaled
        edges, and a delay mask, against the JAX chunk-scan warm route
        at the same chains (group 3): aligned corr > 0.999 (T2; the JAX
        'warm' scan also revisits each chain's first chunk warm, R6)."""
        chunks, edges, dt, df = arc
        scale = np.repeat([1.0, 0.97], 3)
        edges_per = edges[None, :] * scale[:, None]
        etas_per = ETA / scale ** 2
        kw = dict(npad=1, tau_mask=0.5, group=3, with_ok=True)
        want, ok_j = jret.grid_retrieval_batch(
            chunks, edges_per, etas_per, dt, df, method="warm", **kw)
        got, ok_t = tret.grid_retrieval_batch(
            chunks, edges_per, etas_per, dt, df, method="kernel",
            device="cpu", **kw)
        np.testing.assert_array_equal(ok_t, ok_j)
        assert ok_t.tolist() == [0] * 6
        for b in range(6):
            assert _corr(got[b], want[b]) > 0.999, b
        # the mask changes the answer
        free = tret.grid_retrieval_batch(
            chunks, edges_per, etas_per, dt, df, method="kernel", npad=1,
            group=3, device="cpu")
        assert not np.array_equal(free, got)

    def test_hbm_group_rule(self):
        """The JAX package's rule (thth/retrieval.py:822-843) on one
        device: 225 chunks (the 4096² façade) → 9 chains of 25."""
        assert [tret.hbm_group(n) for n in (1, 20, 32, 37, 49, 64, 225,
                                            1000)] \
            == [1, 20, 32, 19, 25, 32, 25, 25]

    def test_device_out_and_padding(self, arc):
        chunks, edges, dt, df = arc
        B = 5
        args = (chunks[:B], np.tile(edges, (B, 1)), np.full(B, ETA), dt, df)
        host = tret.grid_retrieval_batch(*args, npad=1, method="plain",
                                         group=3, device="cpu")
        dev, ok = tret.grid_retrieval_batch(
            *args, npad=1, method="plain", group=3, with_ok=True,
            device_out=True, device="cpu")
        assert isinstance(dev, torch.Tensor) and dev.shape == (B, 64, 64)
        assert ok.shape == (B,)
        np.testing.assert_array_equal(dev.numpy(), host)
        one = tret.chunk_retrieval_batch(chunks[:B], edges, ETA, dt, df,
                                         npad=1, device="cpu")
        eigh = tret.grid_retrieval_batch(*args, npad=1, device="cpu")
        np.testing.assert_array_equal(one, eigh)

    def test_mesh_is_not_ported(self, arc):
        """The mesh route (ported now) walks whole chains on each shard,
        so every chunk is the unsharded retrieval's up to the last bits
        that a batched product of another size rounds (on the CPU the
        plain solver's; as in ``test_grouped_call_equals_single_chains``:
        aligned corr > 1 − 1e-6)."""
        from scintools_tpu_torch.parallel import make_mesh

        chunks, edges, dt, df = arc
        args = (chunks, np.tile(edges, (6, 1)), np.full(6, ETA), dt, df)
        want = tret.grid_retrieval_batch(*args, npad=1, method="plain",
                                         group=2, device="cpu")
        got = tret.grid_retrieval_batch(
            *args, npad=1, method="plain", group=2,
            mesh=make_mesh(4, devices=["cpu"] * 4))
        assert got.shape == want.shape
        for b in range(6):
            assert _corr(got[b], want[b]) > 1 - 1e-6, b


# ---------------------------------------------------------------------
# 4. quarantine
# ---------------------------------------------------------------------

class TestQuarantine:
    @pytest.mark.parametrize("poison", [np.nan, -np.inf])
    def test_bad_chunk_isolated(self, arc, poison):
        """A corrupt chunk comes back zero with BAD_INPUT. On the dense
        route every other chunk is bitwise the clean run's; on the
        chained route so is every chunk of another chain and every
        earlier chunk of its own, while the later ones, warm-started
        from its sanitised matrix (R3), keep corr > 0.999."""
        chunks, edges, dt, df = arc
        bad = chunks.copy()
        bad[1, 5, 7] = poison
        args = (np.tile(edges, (6, 1)), np.full(6, ETA), dt, df)
        for method, same in (("eigh", [0, 2, 3, 4, 5]),
                             ("kernel", [0, 3, 4, 5])):
            kw = dict(npad=1, method=method, group=3, with_ok=True,
                      device="cpu")
            clean, ok0 = tret.grid_retrieval_batch(chunks, *args, **kw)
            got, ok = tret.grid_retrieval_batch(bad, *args, **kw)
            assert ok0.tolist() == [guards.OK] * 6
            assert ok[1] & guards.BAD_INPUT and ok[1] == jguards.BAD_INPUT
            assert np.all(got[1] == 0)
            for b in same:
                assert ok[b] == guards.OK
                assert np.array_equal(got[b], clean[b]), (method, b)
            if method == "kernel":
                assert _corr(got[2], clean[2]) > 0.999

    def test_nonfinite_eta_flagged_not_fatal(self, arc):
        chunks, edges, dt, df = arc
        etas = np.full(3, ETA)
        etas[2] = np.nan
        E, ok = tret.grid_retrieval_batch(
            chunks[:3], np.tile(edges, (3, 1)), etas, dt, df, npad=1,
            with_ok=True, device="cpu")
        assert ok[2] & guards.BAD_CURVE
        assert np.all(E[2] == 0)
        assert ok[0] == ok[1] == guards.OK
        assert np.any(E[0] != 0)


# ---------------------------------------------------------------------
# 5-7. mosaic, campaign, Gerchberg–Saxton
# ---------------------------------------------------------------------

def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


class TestMosaic:
    @pytest.mark.parametrize("shape", [(3, 4, 16, 16), (1, 3, 8, 8),
                                       (3, 1, 8, 8), (1, 1, 8, 8)])
    def test_matches_numpy_and_jax_device(self, shape):
        """complex64 stitching against the float64 oracle: rel L2
        < 1e-5."""
        rng = np.random.default_rng(sum(shape))
        chunks = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        got = tret.mosaic_device(chunks, device="cpu")
        assert got.dtype == np.complex64
        assert got.shape == tret.mosaic_shape(*shape)
        assert _rel(got, jret.mosaic(chunks)) < 1e-5
        assert _rel(got, jret.mosaic_device(chunks)) < 1e-5
        np.testing.assert_array_equal(tret.mosaic(chunks),
                                      jret.mosaic(chunks))

    def test_epoch_axis(self):
        rng = np.random.default_rng(4)
        ncf, nct, cwf, cwt = 2, 3, 8, 8
        eps = (rng.normal(size=(2, ncf, nct, cwf, cwt))
               + 1j * rng.normal(size=(2, ncf, nct, cwf, cwt)))
        got = tret.mosaic_device(
            torch.as_tensor(eps.reshape(2, ncf * nct, cwf, cwt)),
            grid_shape=(ncf, nct), device="cpu")
        ri = np.stack([eps.real, eps.imag], axis=3).reshape(
            2, ncf * nct, 2, cwf, cwt)
        want = jret.mosaic_device(jnp.asarray(ri), grid_shape=(ncf, nct))
        assert got.shape == want.shape == (2, 12, 16)
        for e in range(2):
            assert _rel(got[e], jret.mosaic(eps[e])) < 1e-5
            assert _rel(got[e], want[e]) < 1e-5
        single = tret.mosaic_device(
            torch.as_tensor(eps[0].reshape(ncf * nct, cwf, cwt)),
            grid_shape=(ncf, nct), device="cpu")
        np.testing.assert_array_equal(single, got[0])
        with pytest.raises(ValueError):
            tret.mosaic_device(torch.as_tensor(eps[0].reshape(6, 8, 8)),
                               grid_shape=(2, 2), device="cpu")


class TestCampaign:
    def test_two_epochs_match_jax(self, arc):
        """2 epochs of a 2×2 grid with per-row geometry, kernel route
        against the JAX chunk-scan warm route at the same chains: the
        stitched intensities agree to rel L2 < 5e-3 and corr > 0.9999
        (tools/tpu_smoke.py's cross-backend gates), with equal ok."""
        chunks, edges, dt, df = arc
        rng = np.random.default_rng(9)
        ep0 = chunks[:4].reshape(2, 2, 64, 64)
        camp = np.stack([ep0, ep0 + 0.01 * rng.standard_normal(ep0.shape)])
        camp[1, 1, 0, 3, 3] = np.nan                  # one quarantined chunk
        edges_rows = edges[None, :] * np.array([[1.0], [0.98]])
        etas_rows = ETA / np.array([1.0, 0.98]) ** 2
        kw = dict(npad=1, group=4)
        want, ok_j = jret.campaign_retrieval_batch(
            camp, edges_rows, etas_rows, dt, df, method="warm", **kw)
        got, ok_t = tret.campaign_retrieval_batch(
            camp, edges_rows, etas_rows, dt, df, device="cpu", **kw)
        assert got.shape == want.shape == (2, 96, 96)
        np.testing.assert_array_equal(ok_t, ok_j)
        assert ok_t[1, 1, 0] == guards.BAD_INPUT and ok_t.sum() == 1
        for e in range(2):
            rel, corr = _intensity_gap(got[e], want[e])
            assert rel < 5e-3 and corr > 0.9999, (e, rel, corr)
        chunks_t, ok_c = tret.campaign_retrieval_batch(
            camp, edges_rows, etas_rows, dt, df, stitch=False, device="cpu",
            **kw)
        assert chunks_t.shape == (2, 2, 2, 64, 64)
        np.testing.assert_array_equal(ok_c, ok_t)
        assert _rel(tret.mosaic(chunks_t[0]), got[0]) < 1e-5


class TestGerchbergSaxton:
    @pytest.mark.parametrize("niter, rescale, with_freqs", [
        (1, True, False), (3, True, True), (3, False, True)])
    def test_matches_jax_numpy_path(self, niter, rescale, with_freqs):
        """complex64 FFTs against the float64 numpy loop: rel L2
        < 1e-3."""
        rng = np.random.default_rng(niter)
        nf, nt = 48, 40
        wf = rng.normal(size=(nf, nt)) + 1j * rng.normal(size=(nf, nt))
        dyn = np.abs(rng.normal(size=(nf + 2, nt))) * 3
        dyn[5, 7] = np.nan
        dyn[9, 1] = -1.0
        freqs = 1400 + 0.2 * np.arange(nf) if with_freqs else None
        want = jret.gerchberg_saxton(wf, dyn, freqs=freqs, niter=niter,
                                     rescale=rescale, backend="numpy")
        got = tret.gerchberg_saxton(wf, dyn, freqs=freqs, niter=niter,
                                    rescale=rescale, device="cpu")
        assert got.shape == (nf, nt) and got.dtype == np.complex64
        assert _rel(got, want) < 1e-3
        good = np.isfinite(dyn[:nf]) & (dyn[:nf] > 0)
        np.testing.assert_allclose(np.abs(got[good]),
                                   np.sqrt(dyn[:nf][good]), rtol=1e-5)

    def test_zero_wavefield_keeps_its_scale(self):
        dyn = np.ones((8, 8))
        got = tret.gerchberg_saxton(np.zeros((8, 8)), dyn, device="cpu")
        np.testing.assert_allclose(np.abs(got), 1.0, rtol=1e-6)


# ---------------------------------------------------------------------
# 7b. the rest of retrieval: one chunk, 'power', VLBI, refinement
# ---------------------------------------------------------------------

def _axes(arc, b=0):
    chunks, edges, dt, df = arc
    times = np.arange(64) * dt
    freqs = 1400.0 + np.arange(64) * df
    return chunks[b], edges, times, freqs


class TestRestOfRetrievalVsJax:
    def test_single_chunk_retrieval(self, arc):
        """Phase-aligned corr > 0.9999 and |E|² rel L2 < 5e-3 against
        the JAX host route; a NaN η (no valid θ-θ square) gives the
        zero chunk in both."""
        dspec, edges, times, freqs = _axes(arc)
        want, f_j, t_j = jret.single_chunk_retrieval(
            dspec, edges, times, freqs, ETA, idx_t=2, idx_f=1, npad=1,
            backend="jax")
        got, f_t, t_t = tret.single_chunk_retrieval(
            dspec, edges, times, freqs, ETA, idx_t=2, idx_f=1, npad=1,
            device="cpu")
        assert (f_t, t_t) == (f_j, t_j) == (1, 2)
        assert got.shape == want.shape == dspec.shape
        assert _corr(got, want) > 0.9999
        assert _intensity_gap(got, want)[0] < 5e-3
        zero_j = jret.single_chunk_retrieval(dspec, edges, times, freqs,
                                             np.nan, npad=1,
                                             backend="jax")[0]
        zero_t = tret.single_chunk_retrieval(dspec, edges, times, freqs,
                                             np.nan, npad=1,
                                             device="cpu")[0]
        assert not np.any(zero_j) and not np.any(zero_t)
        assert zero_t.shape == dspec.shape

    def test_power_method(self, arc):
        """``method="power"`` (1024 cold power steps per chunk) against
        JAX ``chunk_retrieval_batch(method="power")``: corr > 0.9999."""
        chunks, edges, dt, df = arc
        want = jret.chunk_retrieval_batch(chunks[:3], edges, ETA, dt, df,
                                          npad=1, method="power")
        got, ok = tret.chunk_retrieval_batch(chunks[:3], edges, ETA, dt, df,
                                             npad=1, method="power",
                                             with_ok=True, device="cpu")
        assert ok.tolist() == [guards.OK] * 3
        for b in range(3):
            assert _corr(got[b], want[b]) > 0.9999, b

    @staticmethod
    def _vlbi(arc, B=2):
        """Two identical stations: I1 = I2 = V12 = the chunk."""
        chunks, *_ = arc
        return np.stack([np.stack([c, c.astype(complex), c])
                         for c in chunks[:B]])

    def test_vlbi_batch(self, arc):
        """Per dish corr > 0.9999 against JAX ``vlbi_retrieval_batch``;
        the two identical dishes agree with each other."""
        _, edges, dt, df = arc
        ds = self._vlbi(arc)
        want = jret.vlbi_retrieval_batch(ds, edges, ETA, dt, df, 2, npad=1)
        got = tret.vlbi_retrieval_batch(ds, edges, ETA, dt, df, 2, npad=1,
                                        device="cpu")
        assert got.shape == want.shape == (2, 2, 64, 64)
        for b in range(2):
            for d in range(2):
                assert _corr(got[b, d], want[b, d]) > 0.9999, (b, d)
            assert _corr(got[b, 0], got[b, 1]) > 0.9999
        with pytest.raises(ValueError):
            tret.vlbi_retrieval_batch(ds[:, :2], edges, ETA, dt, df, 2,
                                      device="cpu")

    def test_vlbi_chunk_retrieval(self, arc):
        """The host composite route against JAX's, and against the batch
        on the same chunk: per dish corr > 0.9999."""
        dspec, edges, times, freqs = _axes(arc)
        lst = [dspec, dspec.astype(complex), dspec]
        want, *_ = jret.vlbi_chunk_retrieval(lst, edges, times, freqs, ETA,
                                             npad=1, backend="jax")
        got, f, t = tret.vlbi_chunk_retrieval(lst, edges, times, freqs, ETA,
                                              idx_t=3, npad=1, device="cpu")
        assert (f, t) == (0, 3) and len(got) == len(want) == 2
        _, _, dt, df = arc
        batch = tret.vlbi_retrieval_batch(self._vlbi(arc, B=1), edges, ETA,
                                          dt, df, 2, npad=1, device="cpu")
        for d in range(2):
            assert _corr(got[d], want[d]) > 0.9999, d
            assert _corr(got[d], batch[0, d]) > 0.9999, d
        assert tret.vlbi_auto_positions(3).tolist() == \
            jret.vlbi_auto_positions(3).tolist()
        assert [tret.vlbi_pair_index(3, a, b) for a in range(3)
                for b in range(3 - a)] == [jret.vlbi_pair_index(3, a, b)
                                           for a in range(3)
                                           for b in range(3 - a)]

    def test_asymmetry_and_err_string(self, arc):
        """``calc_asymmetry`` abs 1e-4 on the JAX modeler's own
        eigenvector, and on the port's; ``err_string`` equal."""
        from scintools_tpu.thth import core as jcore
        from scintools_tpu.thth import search as jsearch
        from scintools_tpu_torch.thth import core as tcore

        dspec, edges, times, freqs = _axes(arc)
        CS, tau, fd = jsearch.chunk_conjugate_spectrum(dspec, times, freqs,
                                                       npad=1)
        out = jcore.modeler(CS, tau, fd, ETA, edges, backend="jax")
        want = jret.calc_asymmetry(out[6], out[4])
        assert tret.calc_asymmetry(out[6], out[4]) == pytest.approx(
            want, abs=1e-12)
        got = tcore.modeler(CS, tau, fd, ETA, edges, device="cpu")
        assert tret.calc_asymmetry(got[6], got[4]) == pytest.approx(
            want, abs=1e-4)
        for v, e in ((1.2345e-3, 6.7e-6), (5.0, 0.0), (np.nan, 1.0),
                     (-42.0, 3.1), (0.0, 0.25)):
            assert tret.err_string(v, e) == jret.err_string(v, e)


class TestRefineMosaicVsJax:
    @staticmethod
    def _chunks(shape=(3, 3, 16, 16), seed=0):
        rng = np.random.default_rng(seed)
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    def test_rot_init_and_rot_mos(self):
        """rel 1e-6 (both numpy float64)."""
        ch = self._chunks()
        x = jret.rot_init(ch)
        np.testing.assert_allclose(tret.rot_init(ch), x, rtol=1e-6,
                                   atol=1e-12)
        assert _rel(tret.rot_mos(ch, x), jret.rot_mos(ch, x)) < 1e-6

    @pytest.mark.parametrize("mode", ["rot", "full"])
    def test_objective_and_gradient_at_x0(self, mode):
        """``torch.autograd`` against ``jax.value_and_grad`` of the JAX
        package's overlap-add: rel 1e-4."""
        import jax

        ch = self._chunks()
        masks = jnp.asarray(jret._masks_array(3, 3, 16, 16))
        x0 = jret.rot_init(ch)
        dspec = np.abs(jret.rot_mos(ch, x0)) ** 2 + 0.1
        dspec[3, 4] = np.nan
        if mode == "rot":
            p0 = x0

            def obj(x):
                E = jret._jax_stack(jnp.asarray(ch), masks, x, jnp.ones(9),
                                    jnp)
                return -jnp.sum(jnp.abs(E) ** 2)
        else:
            p0 = np.concatenate([x0, np.linspace(0.8, 1.2, 9)])
            d = jnp.asarray(np.nan_to_num(dspec))
            w = jnp.asarray(np.isfinite(dspec).astype(float))

            def obj(p):
                E = jret._jax_stack(jnp.asarray(ch), masks, p[:8], p[8:],
                                    jnp)
                return jnp.sum(((jnp.abs(E) ** 2 - d) * w) ** 2)
        v_j, g_j = jax.value_and_grad(obj)(jnp.asarray(p0))
        v_t, g_t = tret.mosaic_objective(ch, dspec=dspec, mode=mode,
                                         device="cpu")(p0)
        assert v_t == pytest.approx(float(v_j), rel=1e-4)
        assert _rel(g_t, np.asarray(g_j)) < 1e-4

    @pytest.mark.parametrize("mode", ["rot", "full"])
    def test_refine_mosaic(self, mode):
        """The final objective of both L-BFGS runs at rel 1e-3, and no
        worse than at x0."""
        ch = self._chunks(seed=1)
        dspec = np.abs(jret.rot_mos(ch, jret.rot_init(ch))) ** 2 + 0.1
        E_j, res_j = jret.refine_mosaic(ch, dspec=dspec, mode=mode,
                                        maxiter=20)
        E_t, res_t = tret.refine_mosaic(ch, dspec=dspec, mode=mode,
                                        maxiter=20, device="cpu")
        assert E_t.shape == E_j.shape == tret.mosaic_shape(3, 3, 16, 16)
        assert res_t.fun == pytest.approx(res_j.fun, rel=1e-3)
        f = tret.mosaic_objective(ch, dspec=dspec, mode=mode, device="cpu")
        x0 = tret.rot_init(ch)
        if mode == "full":
            x0 = np.concatenate([x0, np.ones(9)])
        assert res_t.fun <= f(x0)[0]
        with pytest.raises(ValueError):
            tret.refine_mosaic(ch, mode="bogus", device="cpu")
        with pytest.raises(ValueError):
            tret.refine_mosaic(ch, mode="full", device="cpu")

# ---------------------------------------------------------------------
# 8. the card by default
# ---------------------------------------------------------------------

def test_device_none_raises_without_a_card(arc):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    chunks, edges, dt, df = arc
    with pytest.raises(RuntimeError):
        tret.grid_retrieval_batch(chunks, np.tile(edges, (6, 1)),
                                  np.full(6, ETA), dt, df)
    with pytest.raises(RuntimeError):
        tret.campaign_retrieval_batch(chunks[:4].reshape(1, 2, 2, 64, 64),
                                      edges, ETA, dt, df)
    with pytest.raises(RuntimeError):
        tret.mosaic_device(np.zeros((2, 2, 8, 8), dtype=complex))
    with pytest.raises(RuntimeError):
        tret.gerchberg_saxton(np.zeros((8, 8)), np.ones((8, 8)))
    with pytest.raises(RuntimeError):
        tret.make_chunk_retrieval_fn(64, 64, dt, df, len(edges))
