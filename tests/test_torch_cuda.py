"""Card-only checks of the PyTorch/CUDA port: the hand-written kernels
(the eigensolver's three entries and the arc profile) against their
plain PyTorch versions on the same CUDA tensors, and the search (one
chunk, a batch, and the ``"square"`` method on ``eig_cold``), the
wavefield retrieval, the survey arc fit, the acf2d fit, the trapezoid
rescale, the zoom and off-grid transforms and the scattered image's
interpolation run on the card
against the same calls on the CPU, the scintillation fits' NaN lanes
leave their neighbours bit for bit unchanged on the card, the serving
daemon fits a spool there as on the CPU, and a fleet's workers launch
the arc-profile kernel.

Every test skips without a CUDA card. The file imports only the port,
so on a machine with a card and no JAX it runs on its own:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from scintools_tpu_torch import grid_retrieval_batch, multi_chunk_search
from scintools_tpu_torch.fit import acf2d as tacf2d
from scintools_tpu_torch.fit import batch as tbatch
from scintools_tpu_torch.fit import models as tmodels
from scintools_tpu_torch.fit.parameters import Parameters
from scintools_tpu_torch.ops import arc_profile as tap
from scintools_tpu_torch.ops import fitarc as tfa
from scintools_tpu_torch.robust import guards as tguards
from scintools_tpu_torch.thth import batch as tthb
from scintools_tpu_torch.thth import eig as teig
from scintools_tpu_torch.thth import retrieval as tret
from scintools_tpu_torch.thth.core import fft_axis
from scintools_tpu_torch.thth.search import chunk_geometry
from scintools_tpu_torch.workloads import (make_arc_dynspec,
                                           make_survey_arc_problem)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _hermitian(rng, n, batch):
    a = rng.normal(size=(batch, n, n)) + 1j * rng.normal(size=(batch, n, n))
    return (a + np.conj(np.transpose(a, (0, 2, 1)))) / 2


def _drift(n=256, B=3, neta=10, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, n, 1)) + 1j * rng.normal(size=(B, n, 1))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    base = _hermitian(rng, n, B) / np.sqrt(n) + 3.0 * u @ np.conj(
        np.transpose(u, (0, 2, 1)))
    drift = _hermitian(rng, n, B) / np.sqrt(n) * 0.01
    return np.stack([base + k * drift for k in range(neta)], axis=1)


@pytest.mark.parametrize("n, squarings, iters", [(256, 10, 24),
                                                 (130, 10, 24),
                                                 (384, 0, 5)])
def test_kernel_matches_plain(cuda, n, squarings, iters):
    """rtol 1e-4 on a batch with a clear dominant eigenvalue: the two
    differ only in float32 summation order. Covers padding (130 → 256),
    N = 384 and ``squarings=0``."""
    a = torch.from_numpy(teig.pack_padded(_drift(n=n), n)).to(cuda)
    before = teig.batched_eig_warmstart.launches
    kern = teig.batched_eig_warmstart(a, n // 2, squarings, iters)
    plain = teig.batched_eig_warmstart_plain(a, n // 2, squarings, iters)
    torch.cuda.synchronize()
    assert teig.batched_eig_warmstart.launches == before + 1
    np.testing.assert_allclose(kern.cpu().numpy(), plain.cpu().numpy(),
                               rtol=1e-4)


def test_kernel_is_deterministic_and_lane_independent(cuda):
    a = torch.from_numpy(teig.pack_padded(_drift(B=4), 256)).to(cuda)
    first = teig.batched_eig_warmstart(a, 128)
    assert torch.equal(first, teig.batched_eig_warmstart(a, 128))
    bad = a.clone()
    bad[2] = 0.0
    other = teig.batched_eig_warmstart(bad, 128)
    keep = [0, 1, 3]
    assert torch.equal(other[keep], first[keep])
    assert torch.all(other[2] == 0)


def test_kernel_refuses_what_it_cannot_take(cuda):
    a = torch.zeros((1, 2, 2, 128, 128), device=cuda)
    with pytest.raises(ValueError):
        teig.batched_eig_warmstart(a.double(), 64)
    with pytest.raises(ValueError):
        teig.batched_eig_warmstart(a[..., :100, :100], 50)
    with pytest.raises(ValueError):
        teig.batched_eig_warmstart(a.transpose(-1, -2), 64)
    with pytest.raises(ValueError):
        teig.batched_eig_warmstart(a, 128)


def _search_inputs():
    """Three 32² arc chunks, their times and frequencies, the η grid and
    the θ edges (npad 1)."""
    rng = np.random.default_rng(7)
    nf = nt = 32
    dt, df = 2.0, 0.05
    freqs = 1400.0 + np.arange(nf) * df
    fd = fft_axis(np.arange(nt) * dt, pad=1, scale=1e3)
    tau = fft_axis(freqs, pad=1)
    eta_true = tau.max() / (fd.max() / 3) ** 2
    chunks, tlist = [], []
    for b in range(3):
        fd_k = np.concatenate([[0.0], rng.uniform(-fd.max() / 3,
                                                  fd.max() / 3, 10)])
        amp = np.concatenate([[1.0], 0.3 * np.exp(
            1j * rng.uniform(0, 2 * np.pi, 10))])
        times = (b * nt + np.arange(nt)) * dt
        E = (amp[None] * np.exp(2j * np.pi * np.outer(
            np.arange(nf) * df, eta_true * fd_k ** 2))) @ np.exp(
                2j * np.pi * 1e-3 * np.outer(fd_k, times))
        chunks.append(np.abs(E) ** 2)
        tlist.append(times)
    etas = np.linspace(0.5 * eta_true, 2 * eta_true, 24)
    edges = np.linspace(-fd.max() / 2.2, fd.max() / 2.2, 32)
    return chunks, tlist, freqs, etas, edges


def test_search_on_card_matches_cpu(cuda):
    chunks, tlist, freqs, etas, edges = _search_inputs()
    on_card = multi_chunk_search(chunks, freqs, tlist, etas, edges, fw=0.3,
                                 npad=1, device=cuda)
    on_cpu = multi_chunk_search(chunks, freqs, tlist, etas, edges, fw=0.3,
                                npad=1, device="cpu")
    for g, c in zip(on_card, on_cpu):
        assert g.ok == c.ok == 0
        # cuFFT vs pocketfft and kernel vs plain: η to rel 1e-3
        assert g.eta == pytest.approx(c.eta, rel=1e-3)



def test_square_route_launches_eig_cold(cuda):
    """``method="square"`` on CUDA tensors launches ``eig_cold`` (no
    fallback; a call of more matrices than the card seats at once runs
    as several launches), within rtol 2e-4 (the kernel's gate) of
    ``batched_eig_cold_plain`` on the same gathered stack; the search
    through it launches too and lands within rel 1e-3 of the CPU's η."""
    chunks, tlist, freqs, etas, edges = _search_inputs()
    fd = fft_axis(tlist[0], pad=1, scale=1e3)
    tau = fft_axis(freqs, pad=1)
    fn = tthb.make_multi_eval_fn(tau, fd, edges, method="square",
                                 device=cuda)
    cs, _, _ = tthb._chunk_cs_to_ri(
        torch.as_tensor(np.stack(chunks), dtype=torch.float32,
                        device=cuda), 1, None, True)
    a = fn.gather(cs, etas)
    before = teig.batched_eig_cold.launches
    kern = fn.solve(a)
    torch.cuda.synchronize()
    assert teig.batched_eig_cold.launches > before
    plain = teig.batched_eig_cold_plain(
        a.reshape(-1, *a.shape[2:]), fn.n_th // 2).reshape(a.shape[:2]).abs()
    np.testing.assert_allclose(kern.cpu().numpy(), plain.cpu().numpy(),
                               rtol=2e-4)
    before = teig.batched_eig_cold.launches
    on_card = multi_chunk_search(chunks, freqs, tlist, etas, edges, fw=0.3,
                                 npad=1, method="square", device=cuda)
    torch.cuda.synchronize()
    assert teig.batched_eig_cold.launches > before
    on_cpu = multi_chunk_search(chunks, freqs, tlist, etas, edges, fw=0.3,
                                npad=1, method="square", device="cpu")
    for g, c in zip(on_card, on_cpu):
        assert g.ok == c.ok == 0
        assert g.eta == pytest.approx(c.eta, rel=1e-3)


@pytest.mark.parametrize("n, neta", [(256, 200), (100, 24)])
def test_one_chain_matches_plain(cuda, n, neta):
    """B = 1, the single-chunk search's shape: one chain of ``neta`` η
    (200 at N = 256; 24 at N = 100, padded to 128) in one launch at a
    cluster size the card seats, within rtol 1e-4 of plain, with the
    cold starts the kernel counted for its one chain."""
    a = torch.from_numpy(teig.pack_padded(_drift(n=n, B=1, neta=neta),
                                          n)).to(cuda)
    before = teig.batched_eig_warmstart.launches
    stats = {}
    kern = teig.batched_eig_warmstart(a, n // 2, stats=stats)
    torch.cuda.synchronize()
    assert teig.batched_eig_warmstart.launches == before + 1
    (plan,) = stats["plan"]
    assert plan["chains"] == 1 and plan["cluster"] in teig.CLUSTERS
    assert plan["resident"] >= 1
    assert int(stats["cold_per_chain"][0]) == stats["cold"] >= 1
    plain = teig.batched_eig_warmstart_plain(a, n // 2)
    np.testing.assert_allclose(kern.cpu().numpy(), plain.cpu().numpy(),
                               rtol=1e-4)


def test_single_search_kernel_matches_plain(cuda):
    """``single_search`` on the card walks the η grid with the kernel
    (one launch) and lands where the plain eigensolver does: the curve
    within rtol 1e-4, η within rel 1e-3."""
    from scintools_tpu_torch.thth.search import single_search

    rng = np.random.default_rng(5)
    nf = nt = 64
    dt, df = 2.0, 0.05
    freqs = 1400.0 + np.arange(nf) * df
    times = np.arange(nt) * dt
    fd = fft_axis(times, pad=1, scale=1e3)
    tau = fft_axis(freqs, pad=1)
    eta_true = tau.max() / (fd.max() / 3) ** 2
    fd_k = np.concatenate([[0.0], rng.uniform(-fd.max() / 3, fd.max() / 3,
                                              12)])
    amp = np.concatenate([[1.0], 0.3 * np.exp(1j * rng.uniform(
        0, 2 * np.pi, 12))])
    E = (amp[None] * np.exp(2j * np.pi * np.outer(
        np.arange(nf) * df, eta_true * fd_k ** 2))) @ np.exp(
            2j * np.pi * 1e-3 * np.outer(fd_k, times))
    etas = np.linspace(0.5 * eta_true, 2 * eta_true, 40)
    edges = np.linspace(-fd.max() / 2.2, fd.max() / 2.2, 64)
    before = teig.batched_eig_warmstart.launches
    kern = single_search(np.abs(E) ** 2, freqs, times, etas, edges, fw=0.3,
                         npad=1, device=cuda)
    assert teig.batched_eig_warmstart.launches == before + 1
    plain = single_search(np.abs(E) ** 2, freqs, times, etas, edges, fw=0.3,
                          npad=1, device=cuda, eig="plain")
    assert kern.ok == plain.ok == 0
    np.testing.assert_allclose(kern.eigs, plain.eigs, rtol=1e-4)
    assert kern.eta == pytest.approx(plain.eta, rel=1e-3)
    assert kern.eta == pytest.approx(eta_true, rel=0.05)

def _aligned_corr(a, b):
    """Per-row |⟨a, b⟩| / (‖a‖‖b‖) of complex (M, n) arrays."""
    num = np.abs(np.sum(np.conj(a) * b, axis=-1))
    return num / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _vec(v):
    v = v.cpu().numpy()
    return v[..., 0, :] + 1j * v[..., 1, :]


@pytest.mark.parametrize("n, squarings, iters", [(256, 10, 64),
                                                 (130, 10, 24),
                                                 (384, 0, 5)])
def test_eigvec_kernel_matches_plain(cuda, n, squarings, iters):
    """3 chains of 8: λ within rtol 1e-4 and v phase-aligned correlation
    > 0.9999 on a batch with a clear dominant eigenvalue (float32
    summation order only)."""
    a = torch.from_numpy(teig.pack_padded(_drift(n=n, neta=8), n)).to(cuda)
    before = teig.batched_eigvec_warmstart.launches
    lam_k, v_k = teig.batched_eigvec_warmstart(a, n // 2, squarings, iters)
    lam_p, v_p = teig.batched_eigvec_warmstart_plain(a, n // 2, squarings,
                                                     iters)
    torch.cuda.synchronize()
    assert teig.batched_eigvec_warmstart.launches == before + 1
    assert lam_k.shape == (3, 8) and v_k.shape == v_p.shape
    np.testing.assert_allclose(lam_k.cpu().numpy(), lam_p.cpu().numpy(),
                               rtol=1e-4)
    corr = _aligned_corr(_vec(v_k), _vec(v_p))
    assert corr.min() > 0.9999, corr.min()


def test_eigvec_chains_are_independent_and_deterministic(cuda):
    """One cluster per chain, fixed-order reductions: a grouped call
    equals its one-chain calls and a rerun, bit for bit."""
    a = torch.from_numpy(teig.pack_padded(_drift(n=256, neta=6), 256)).to(
        cuda)
    lam, v = teig.batched_eigvec_warmstart(a, 128, iters=64)
    lam2, v2 = teig.batched_eigvec_warmstart(a, 128, iters=64)
    assert torch.equal(lam, lam2) and torch.equal(v, v2)
    for g in range(a.shape[0]):
        lg, vg = teig.batched_eigvec_warmstart(a[g], 128, iters=64)
        assert torch.equal(lg, lam[g]) and torch.equal(vg, v[g])


def _crossing(n=256, nsteps=24, eps=0.02, seed=13):
    """The avoided crossing of chip_smoke.py (tests/test_pallas_eig.py's,
    background scaled to keep its spectral radius as at n = 32)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n))
                        + 1j * rng.normal(size=(n, n)))
    u, w = q[:, 0:1], q[:, 1:2]
    junk = _hermitian(rng, n, 1)[0] * 0.02 * np.sqrt(32 / n)
    mats = []
    for t in np.linspace(0.0, 1.0, nsteps):
        A = ((2.0 - t) * (u @ np.conj(u.T)) + (1.2 + t) * (w @ np.conj(w.T))
             + eps * (u @ np.conj(w.T) + w @ np.conj(u.T)) + junk)
        mats.append((A + np.conj(A.T)) / 2)
    return np.array(mats)[None]


def test_bits_do_not_depend_on_the_launch_plan(cuda):
    """The same chains inside calls of G = 1, 8, 9 and 32, which the plan
    runs at different cluster sizes (one cluster of 16; 8 of 8; and 32
    as 30 chains at C = 4 then 2 at C = 16 on an H100), give the same
    bits for λ, and for the eigenvector entry for λ and v: the kernel's
    arithmetic order depends on N alone."""
    a = torch.from_numpy(teig.pack_padded(_drift(n=256, B=32, neta=4,
                                                 seed=3), 256)).to(cuda)
    plans = {}
    stats = {}
    lam = teig.batched_eig_warmstart(a, 128, stats=stats)
    plans[32] = stats["plan"]
    lam_v, v = teig.batched_eigvec_warmstart(a, 128, iters=16)
    for G in (1, 8, 9):
        sub = a[:G].contiguous()
        stats = {}
        assert torch.equal(teig.batched_eig_warmstart(sub, 128, stats=stats),
                           lam[:G]), G
        plans[G] = stats["plan"]
        lg, vg = teig.batched_eigvec_warmstart(sub, 128, iters=16)
        assert torch.equal(lg, lam_v[:G]) and torch.equal(vg, v[:G]), G
    last = a[31:].contiguous()
    assert torch.equal(teig.batched_eig_warmstart(last, 128), lam[31:])
    clusters = {tuple((p["chains"], p["cluster"]) for p in plan)
                for plan in plans.values()}
    assert len(clusters) >= 2, plans


def test_cold_restart_mid_chain_matches_plain(cuda):
    """The crossing batch restarts cold in the middle of its chain (the
    kernel's per-chain count says so); where the gap λ₁ − λ₂ is ≥ 5% of
    λ₁ the kernel equals the plain version to rtol 1e-4, and at the
    near-degenerate points it equals plain or lies within [λ₂, λ₁]
    (1e-4·λ₁ slack), as chip_smoke.py's gate."""
    mats = _crossing()
    a = torch.from_numpy(teig.pack_padded(mats, 256)).to(cuda)
    stats, pstats = {}, {}
    kern = teig.batched_eig_warmstart(a, 128, stats=stats)[0].cpu().numpy()
    plain = teig.batched_eig_warmstart_plain(a, 128,
                                             stats=pstats)[0].cpu().numpy()
    assert int(stats["cold_per_chain"][0]) == stats["cold"] >= 2
    assert pstats["cold"] >= 2
    ev = np.sort(np.linalg.eigvalsh(mats[0]), axis=-1)
    l1, l2 = ev[:, -1], ev[:, -2]
    near = (l1 - l2) < 0.05 * np.abs(l1)
    np.testing.assert_allclose(kern[~near], plain[~near], rtol=1e-4)
    slack = 1e-4 * np.abs(l1)
    inside = (kern >= l2 - slack) & (kern <= l1 + slack)
    same = np.abs(kern - plain) <= 1e-4 * np.abs(plain)
    assert np.all((inside | same)[near])


@pytest.mark.parametrize("n", [128, 384, 768])
def test_plans_match_plain(cuda, n):
    """N = 128 (8 rows per CTA at C = 16), N = 384 and N = 768, where no
    cluster size holds the band and the kernel reads it from L2: λ of
    both warm entries within rtol 1e-4 of plain, v correlated > 0.9999."""
    a = torch.from_numpy(teig.pack_padded(_drift(n=n, B=3, neta=5), n)).to(
        cuda)
    stats = {}
    kern = teig.batched_eig_warmstart(a, n // 2, stats=stats)
    assert (stats["plan"][0]["nbuf"] == 0) == (n == 768)
    plain = teig.batched_eig_warmstart_plain(a, n // 2)
    np.testing.assert_allclose(kern.cpu().numpy(), plain.cpu().numpy(),
                               rtol=1e-4)
    lam_k, v_k = teig.batched_eigvec_warmstart(a, n // 2, iters=24)
    lam_p, v_p = teig.batched_eigvec_warmstart_plain(a, n // 2, iters=24)
    np.testing.assert_allclose(lam_k.cpu().numpy(), lam_p.cpu().numpy(),
                               rtol=1e-4)
    assert _aligned_corr(_vec(v_k), _vec(v_p)).min() > 0.9999


def test_cold_start_vector_is_split_tf32_accurate(cuda):
    """Chains of one at N = 256: v is the cold start's vector itself, not
    refined by warm steps. On matrices whose top eigenvalue has a clear
    gap, split TF32 keeps it within 1e-5 (L2) of the plain float32 cold
    start's, where plain TF32 (one product) lands 1e-4 or more away
    (tests/test_torch_eig.py::TestSplitTf32Emulation); λ cannot tell the
    two apart, the vector can. (Where the gap is a few percent, as in a
    random hermitian matrix, float32 summation order alone moves the
    vector by a few 1e-5.)"""
    n = 256
    mats = _drift(n=n, B=4, neta=2, seed=11).reshape(8, 1, n, n)
    a = torch.from_numpy(teig.pack_padded(mats, n)).to(cuda)
    stats = {}
    lam_k, v_k = teig.batched_eigvec_warmstart(a, n // 2, stats=stats)
    lam_p, v_p = teig.batched_eigvec_warmstart_plain(a, n // 2)
    assert stats["cold"] == len(mats)
    gap = (v_k - v_p).double().pow(2).sum(dim=(-2, -1)).sqrt()
    assert gap.max().item() <= 1e-5, gap
    np.testing.assert_allclose(lam_k.cpu().numpy(), lam_p.cpu().numpy(),
                               rtol=1e-4)


def test_eig_cold_counts_its_cold_starts(cuda):
    """The cold-only entry writes one cold start per matrix into the
    kernel's per-chain count, and its plan into ``stats``."""
    a = torch.from_numpy(teig.pack_padded(
        _hermitian(np.random.default_rng(5), 128, 40), 128)).to(cuda)
    stats = {}
    teig.batched_eig_cold(a, 64, stats=stats)
    assert stats["cold"] == 40
    assert stats["cold_per_chain"].cpu().tolist() == [1] * 40
    assert sum(p["chains"] for p in stats["plan"]) == 40


def test_retrieval_on_card_matches_cpu(cuda):
    """Six 128² chunks of a synthetic arc in 2 chains of 3: the kernel
    route on the card against the plain route on the CPU (cuFFT vs
    pocketfft, kernel vs plain): equal health, aligned corr > 0.999
    wherever the chunk's θ-θ has a 5% gap, and one launch."""
    dyn = make_arc_dynspec(256, 256, 2.0, 0.05, 1400.0, 5e-4, 96, seed=21)
    chunks = np.stack([dyn[64 * i:64 * i + 128, 64 * j:64 * j + 128]
                       for i in range(2) for j in range(3)])
    chunks -= chunks.mean(axis=(1, 2), keepdims=True)
    _, _, _, _, edges = chunk_geometry(nf=128, nt=128, npad=1, eta_max=1e-3,
                                       n_edges=128)
    args = (chunks, np.tile(edges, (6, 1)), np.full(6, 5e-4), 2.0, 0.05)
    kw = dict(npad=1, group=3, with_ok=True)
    before = teig.batched_eigvec_warmstart.launches
    on_card, ok_card = grid_retrieval_batch(*args, method="kernel",
                                            device=cuda, **kw)
    assert teig.batched_eigvec_warmstart.launches == before + 1
    on_cpu, ok_cpu = grid_retrieval_batch(*args, method="plain",
                                          device="cpu", **kw)
    np.testing.assert_array_equal(ok_card, ok_cpu)
    fn = tret.make_chunk_retrieval_fn(128, 128, 2.0, 0.05, 128, npad=1,
                                      device="cpu")
    thth = fn.front(torch.as_tensor(chunks, dtype=torch.float32),
                    torch.as_tensor(args[1]), torch.as_tensor(args[2]),
                    0.0)[0]
    ev = torch.linalg.eigvalsh(thth).numpy()
    gapped = (ev[:, -1] - ev[:, -2]) >= 0.05 * np.abs(ev[:, -1])
    assert gapped.sum() >= 3
    corr = _aligned_corr(on_card.reshape(6, -1), on_cpu.reshape(6, -1))
    assert corr[gapped].min() > 0.999, corr


@pytest.mark.parametrize("n, batch, squarings", [(256, 5, 10), (130, 3, 10),
                                                 (384, 2, 0)])
def test_eig_cold_kernel_matches_plain(cuda, n, batch, squarings):
    """rtol 2e-4 against the plain version, the cold start's gate
    against eigvalsh (15 float32 squarings in another summation
    order); one launch."""
    mats = _hermitian(np.random.default_rng(n), n, batch)
    a = torch.from_numpy(teig.pack_padded(mats, n)).to(cuda)
    before = teig.batched_eig_cold.launches
    kern = teig.batched_eig_cold(a, n // 2, squarings)
    plain = teig.batched_eig_cold_plain(a, n // 2, squarings)
    torch.cuda.synchronize()
    assert teig.batched_eig_cold.launches == before + 1
    assert kern.shape == (batch,)
    np.testing.assert_allclose(kern.cpu().numpy(), plain.cpu().numpy(),
                               rtol=2e-4)
    if squarings:
        top = np.array([np.linalg.eigvalsh(m)[-1] for m in mats])
        np.testing.assert_allclose(kern.cpu().numpy(), top, rtol=2e-4)


def test_eig_cold_refuses_what_it_cannot_take(cuda):
    a = torch.zeros((2, 2, 128, 128), device=cuda)
    before = teig.batched_eig_cold.launches
    with pytest.raises(ValueError):
        teig.batched_eig_cold(a.double(), 64)
    with pytest.raises(ValueError):
        teig.batched_eig_cold(a.transpose(-1, -2), 64)
    with pytest.raises(ValueError):
        teig.batched_eig_cold(a[:, :, :100, :100], 50)
    assert teig.batched_eig_cold.launches == before


def _arc_inputs(rng, B, ntdel, nc, startbin, R, Q, device, pad=0):
    """The kernel's surface on ``device``: dB spectra (B, ntdel, nc)
    with NaN stripes and pixels, a +inf pixel mid-row and a −inf pixel
    on the first column of the last row (where out-of-support queries
    clip), a cut of 3 central columns, scales, the query grid and the
    float32 constants. ``pad`` extra rows per epoch make the spectra a
    view with a larger epoch stride."""
    s = 20.0 + 5.0 * rng.standard_normal((B, ntdel + pad, nc))
    s[:, :, nc // 4:nc // 4 + 2] = np.nan
    s[0, startbin + 3, 10:14] = np.nan
    s[-1, startbin + R // 2, nc // 3] = np.inf
    s[0, startbin + R - 1, 0] = -np.inf
    fdop = np.linspace(-30.0, 30.0, nc)
    # the far rows leave |fq| > 0.6 outside the support
    tdel = np.linspace(0.5, 48.0, R)
    scales = np.sqrt(tdel[None] / rng.uniform(0.005, 0.02, B)[:, None])

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    spectra = t(s)[:, :ntdel]
    cut = (nc // 2 - 1, nc // 2 + 2)
    return (spectra, t(scales), t(np.linspace(-1, 1, Q)), startbin, cut,
            float(fdop[0]), float(np.mean(np.diff(fdop))),
            float(np.max(np.abs(fdop))))


def _same_bits(a, b):
    """Equal bit for bit, NaN where the other is NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        a[~na].view(torch.int32), b[~nb].view(torch.int32))


@pytest.mark.parametrize("B, ntdel, nc, startbin, R, Q", [
    (3, 44, 96, 2, 39, 300),       # R not a multiple of the rows a copy
    (2, 26, 128, 1, 23, 130),
    (5, 256, 512, 3, 252, 1999),   # Q not a multiple of the threads
    (1, 256, 510, 3, 252, 2000),   # nc % 4 != 0: ordinary loads; B = 1
    (4, 40, 61, 0, 40, 517)])
def test_arc_profile_kernel_matches_plain(cuda, B, ntdel, nc, startbin, R,
                                          Q):
    """Bit for bit the plain version (both round every operation once in
    the same order and sum each query in row order), with NaN pixels,
    the cut, and ±inf pixels; a rerun is bitwise equal; the plan's
    launches are counted."""
    args = _arc_inputs(np.random.default_rng(Q), B, ntdel, nc, startbin, R,
                       Q, cuda)
    before = tap.arc_profile.launches
    stats = {}
    kern = tap.arc_profile(*args, stats=stats)
    again = tap.arc_profile(*args)
    plain = tap.arc_profile_rows_plain(*args)
    torch.cuda.synchronize()
    assert tap.arc_profile.launches == before + 2 * len(stats["plan"])
    assert [p["bulk"] for p in stats["plan"]] == [nc % 4 == 0]
    assert _same_bits(kern, again)
    assert _same_bits(kern, plain)
    assert bool(torch.isnan(kern).any()) and bool(torch.isinf(kern).any())


@pytest.mark.parametrize("nc, pad", [(512, 0), (510, 0), (512, 3)],
                         ids=["bulk", "loads", "stride"])
def test_arc_profile_bits_do_not_depend_on_the_cluster(cuda, nc, pad):
    """Forced C = 1, 2, 4 and 8 (multicast where rows arrive by bulk
    copy) give the same bits as the default plan and the plain version:
    each query is summed by one thread in row order whatever C. Also on
    a view whose epoch stride is not the epoch's size."""
    args = _arc_inputs(np.random.default_rng(nc), 12, 256, nc, 3, 252, 2000,
                       cuda, pad=pad)
    assert args[0].stride(0) == (256 + pad) * nc
    want = tap.arc_profile_rows_plain(*args)
    for c in (None, 1, 2, 4, 8):
        stats = {}
        got = tap.arc_profile(*args, cluster=c, stats=stats)
        assert _same_bits(got, want), c
        if c is not None:
            assert {p["cluster"] for p in stats["plan"]} == {c}


def test_arc_profile_query_passes(cuda):
    """5000 queries at C = 1 and 2 need 3 and 2 work units per epoch
    (2048 query slots a CTA): the same bits as the plain version."""
    args = _arc_inputs(np.random.default_rng(4), 3, 30, 64, 2, 27, 5000,
                       cuda)
    want = tap.arc_profile_rows_plain(*args)
    for c, passes in ((1, 3), (2, 2)):
        stats = {}
        assert _same_bits(tap.arc_profile(*args, cluster=c, stats=stats),
                          want)
        assert stats["plan"][0]["passes"] == passes


def test_arc_profile_refuses_what_it_cannot_take(cuda):
    s, scales, fq, startbin, cut, *consts = _arc_inputs(
        np.random.default_rng(1), 2, 12, 64, 1, 8, 50, cuda)
    before = tap.arc_profile.launches
    bad = [
        (s.double(), scales, fq, startbin, cut),            # dtype
        (s, scales.cpu(), fq, startbin, cut),                # device
        (s, scales[:1], fq, startbin, cut),                  # B differs
        (s.transpose(1, 2).contiguous().transpose(1, 2), scales, fq,
         startbin, cut),                                     # strided rows
        (s, scales, fq[None], startbin, cut),                # fq not (Q,)
        (s, scales, fq, 5, cut),                             # rows past end
        (s, scales, fq, startbin, (40, 70)),                 # cut past end
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tap.arc_profile(*args, *consts)
    with pytest.raises(ValueError):
        tap.arc_profile(s, scales, fq, startbin, cut, *consts, cluster=3)
    assert tap.arc_profile.launches == before


def test_survey_arc_fit_on_card_matches_cpu(cuda):
    """Eight epochs of the survey configuration: the device fit on the
    card (kernel) against the same fit on the CPU (plain version):
    η rel 1e-4, etaerr rel 1e-3, and the kernel was launched."""
    prob = make_survey_arc_problem(B=8, device=cuda)
    s_dev = prob["sspecs"]
    args = (prob["tdel"], prob["fdop"])
    before = tap.arc_profile.launches
    on_card = tfa.fit_arc_batch(s_dev, *args, numsteps=prob["numsteps"],
                                full_output=False, device=cuda)
    assert tap.arc_profile.launches == before + 1
    on_cpu = tfa.fit_arc_batch(s_dev, *args, numsteps=prob["numsteps"],
                               full_output=False, device="cpu")
    for g, c in zip(on_card, on_cpu):
        assert np.isfinite(g.eta) == np.isfinite(c.eta)
        if np.isfinite(c.eta):
            assert g.eta == pytest.approx(c.eta, rel=1e-4)
            assert g.etaerr == pytest.approx(c.etaerr, rel=1e-3)


def _acf2d_start(nc, tau=1400.0, dnu=7.5, amp=0.8, psi=50.0):
    """The survey acf2d configuration (nt = nf = 2·nc − 1, tobs 7200 s,
    bw 64 MHz, ar 2, α 5/3 fixed) at a start of τ, Δν, amp and ψ."""
    p = Parameters()
    p.add("tau", value=tau, vary=True, min=0, max=np.inf)
    p.add("dnu", value=dnu, vary=True, min=0, max=np.inf)
    p.add("amp", value=amp, vary=True, min=0, max=np.inf)
    p.add("alpha", value=5 / 3, vary=False)
    p.add("nt", value=2 * nc - 1, vary=False)
    p.add("nf", value=2 * nc - 1, vary=False)
    p.add("phasegrad", value=0.0, vary=True)
    p.add("tobs", value=7200.0, vary=False)
    p.add("bw", value=64.0, vary=False)
    p.add("ar", value=2.0, vary=False)
    p.add("theta", value=0, vary=False)
    p.add("psi", value=psi, vary=True)
    return p


def _acf2d_crops(nc, n, device, seed=13):
    rng = np.random.default_rng(seed)
    truth = _acf2d_start(nc, 1800.0, 6.0, 1.0, 60.0)
    clean = -tmodels.scint_acf_model_2d(truth, np.zeros((nc, nc)),
                                        np.ones((nc, nc)), device)
    return np.stack([clean + 0.01 * clean.max()
                     * rng.standard_normal((nc, nc)) for _ in range(n)])


def test_acf2d_policies_on_card(cuda):
    """A crop of 33 of the survey acf2d configuration: the analytic ACF on
    the card within 1e-12 of its peak of the CPU's, the "highest" fit on
    the card at rel 1e-6 of the CPU's, and the "default" fit within
    max(1%, stderr) of "highest" in τ and Δν."""
    nc = 33
    ys = _acf2d_crops(nc, 1, cuda)
    ref = _acf2d_crops(nc, 1, "cpu")
    np.testing.assert_allclose(ys, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    hi = tacf2d.fit_acf2d(_acf2d_start(nc), ys[0], None,
                          precision="highest", device=cuda)
    hi_cpu = tacf2d.fit_acf2d(_acf2d_start(nc), ys[0], None,
                              precision="highest", device="cpu")
    lo = tacf2d.fit_acf2d(_acf2d_start(nc), ys[0], None, device=cuda)
    assert hi.ok == lo.ok == hi_cpu.ok == 0
    for k in ("tau", "dnu", "amp", "psi"):
        assert hi.params[k].value == pytest.approx(hi_cpu.params[k].value,
                                                   rel=1e-6), k
    for k in ("tau", "dnu"):
        tol = max(0.01 * abs(hi.params[k].value), hi.params[k].stderr)
        assert abs(lo.params[k].value - hi.params[k].value) <= tol, k


def test_scint_nan_lanes_bitwise_on_card(cuda):
    """A NaN-poisoned lane on the card: ``BAD_INPUT`` and NaN results, and
    every other lane bit for bit the clean run's, through the guarded 1-D
    program and through the batched acf2d fit."""
    rng = np.random.default_rng(4)
    B, nf, nt = 6, 96, 64
    dyns = torch.as_tensor(np.stack([
        make_arc_dynspec(nt, nf, 2.0, 0.05, 1400.0, 5e-4, 96, seed=s)
        for s in range(B)]), dtype=torch.float32, device=cuda)
    serve = tbatch.make_scint_params_serve(B, nf, nt, 2.0, 0.05, device=cuda)
    clean = {k: v.cpu().numpy() for k, v in serve(dyns).items()}
    bad = dyns.clone()
    bad[2, 7, 3] = float("nan")
    out = {k: v.cpu().numpy() for k, v in serve(bad).items()}
    assert out["ok"].tolist() == [0, 0, tguards.BAD_INPUT, 0, 0, 0]
    for k in out:
        if k == "ok":
            continue
        assert np.isnan(out[k][2]), k
        for lane in (0, 1, 3, 4, 5):
            assert out[k][lane].tobytes() == clean[k][lane].tobytes(), k
    ys = _acf2d_crops(17, 3, cuda) * (1 + 0.01 * rng.random((3, 1, 1)))
    start = _acf2d_start(17)
    res_c, ok_c = tacf2d.fit_acf2d_batch(start, ys, None, n_iter=12,
                                         device=cuda)
    ys[1] = np.nan
    res_b, ok_b = tacf2d.fit_acf2d_batch(start, ys, None, n_iter=12,
                                         device=cuda)
    assert ok_c.tolist() == [0, 0, 0] and ok_b[1] & tguards.BAD_INPUT
    assert np.isnan(res_b[1].params["tau"].value)
    for b in (0, 2):
        for k in ("tau", "dnu", "amp", "phasegrad", "psi"):
            assert res_b[b].params[k].value == res_c[b].params[k].value, k
            assert res_b[b].params[k].stderr == res_c[b].params[k].stderr, k


def test_trapezoid_on_card_matches_cpu(cuda):
    """The trapezoid's masked row interpolation (float64) on the card
    against the CPU and the plain row loop."""
    from scintools_tpu_torch.ops import scale as tscale

    rng = np.random.default_rng(3)
    dyn = rng.normal(size=(96, 200)) ** 2
    times = np.arange(200) * 8.0
    freqs = 1300.0 + np.arange(96) * 2.5
    card = tscale.trapezoid_rescale(dyn, times, freqs, device=cuda)
    cpu = tscale.trapezoid_rescale(dyn, times, freqs, device="cpu")
    plain = tscale.trapezoid_rescale_plain(dyn, times, freqs)
    np.testing.assert_allclose(card, cpu, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(card, plain, atol=1e-10)
    # samples kept per row, from the geometry (the edge windows zero the
    # first row and column, so non-zeros undercount)
    n_in = tscale._trapezoid_setup(dyn, times, freqs, "hanning", 0.1)[2]
    assert n_in.min() < 200
    for r in (0, 40, 95):
        assert (card[r, n_in[r]:] == 0).all()


@pytest.mark.parametrize("variant", ["czt", "dense"])
def test_zoom_and_offgrid_on_card_match_cpu(cuda, variant):
    """The zoom power and the off-grid DFT (float32) on the card against
    the same calls on the CPU in float64, at the float32 tier 2e-4."""
    from scintools_tpu_torch.ops import sspec as tsspec
    from scintools_tpu_torch.ops import xfft as txfft

    rng = np.random.default_rng(5)
    d = rng.standard_normal((3, 200, 160))
    nrfft, ncfft = tsspec.fft_shapes(200, 160)
    band = ((10.0, 18.0, 128), (-12.0, 4.0, 256))
    got = tsspec.secondary_spectrum_power(
        torch.as_tensor(d, dtype=torch.float32, device=cuda), zoom=band,
        variant=variant).cpu().numpy()
    ref = tsspec.secondary_spectrum_power(torch.as_tensor(d), zoom=band,
                                          variant=variant).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4 * ref.max())
    pts = rng.uniform(-80, 80, 300)
    v = "taylor" if variant == "czt" else "dense"
    got = txfft.offgrid_dft_1d(torch.as_tensor(d[0], dtype=torch.float32,
                                               device=cuda),
                               torch.as_tensor(pts, device=cuda), 160,
                               variant=v).cpu().numpy()
    ref = txfft.offgrid_dft_1d(torch.as_tensor(d[0]), torch.as_tensor(pts),
                               160, variant="dense").numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4,
                               atol=2e-4 * np.abs(ref).max())


@pytest.mark.parametrize("method", ["gather", "matmul"])
def test_scatim_on_card_matches_cpu(cuda, method):
    from scintools_tpu_torch.ops import scatim as tscatim

    rng = np.random.default_rng(7)
    lin = rng.standard_normal((150, 230))
    tp = rng.uniform(-3, 153, (40, 70))
    fp = rng.uniform(-3, 233, (40, 70))
    card = tscatim.cubic_interp2d(lin, tp, fp, method=method,
                                  device=cuda).cpu().numpy()
    cpu = tscatim.cubic_interp2d(lin, tp, fp, method="gather",
                                 device="cpu").numpy()
    np.testing.assert_allclose(card, cpu, rtol=1e-12, atol=1e-12)


def _arc_epoch(nt=64, nf=64, dt=30.0, df=0.2, f0=1400.0, npix=8, eta=0.3,
               seed=2):
    """One dynspec carrying a known-curvature arc, with its times,
    frequencies and θ edges (tests/test_torch_retrieval.py's chunk)."""
    rng = np.random.default_rng(seed)
    times = np.arange(nt) * dt
    freqs = f0 + np.arange(nf) * df
    dfd = 1e3 / (2 * nt * dt)
    fd_k = np.arange(-npix, npix + 1) * dfd
    amps = ((0.05 + 0.3 * rng.random(len(fd_k)) * np.exp(-(fd_k / 1.2) ** 2))
            * np.exp(2j * np.pi * rng.random(len(fd_k))))
    amps[len(fd_k) // 2] = 3.0
    F, T = np.meshgrid(freqs - f0, times, indexing="ij")
    E = sum(a * np.exp(2j * np.pi * (eta * fd ** 2 * F + fd * 1e-3 * T))
            for a, fd in zip(amps, fd_k))
    return np.abs(E) ** 2, times, freqs, np.arange(-10.5, 11.5) * dfd


def test_numpy_tiers_launch_the_kernels(cuda, tmp_path):
    """With the fused and staged tiers made to fail, the numpy tiers of
    the wavefield survey and of the closed loop still launch their
    kernels: eigvec_warmstart once per retrieved chunk, arc_profile once
    per lane. No epoch is journaled under "numpy" without a launch."""
    from scintools_tpu_torch.dynspec import run_wavefield_survey
    from scintools_tpu_torch.robust import (TIER_FUSED, TIER_NUMPY,
                                            TIER_STAGED)
    from scintools_tpu_torch.robust import faults
    from scintools_tpu_torch.sim import scenario as tsc

    dyn, times, freqs, edges = _arc_epoch()
    teig.batched_eigvec_warmstart.launches = 0
    with faults.tier_failure_hook([TIER_FUSED, TIER_STAGED]):
        out = run_wavefield_survey([("w0", (dyn, times, freqs))],
                                   str(tmp_path / "wf"), edges, 0.3,
                                   cwf=32, cwt=32, npad=1, retries=0,
                                   device=cuda)
    rec = out["results"]["w0"]
    assert out["outcomes"][0].tier == TIER_NUMPY
    assert rec["n_chunks"] == 9
    assert teig.batched_eigvec_warmstart.launches == (
        rec["n_chunks"] - rec["n_quarantined"]) > 0

    tap.arc_profile.launches = 0
    with faults.tier_failure_hook([TIER_FUSED, TIER_STAGED]):
        out = tsc.run_scenario_survey(
            str(tmp_path / "sc"), regimes=({"name": "good", "mb2": 2.0},),
            epochs_per_regime=2, ns=32, nf=16, ds=0.04, batch_size=2,
            seed=4, numsteps=600, n_iter=20, retries=0, device=cuda)
    assert out["summary"]["tier_counts"][TIER_NUMPY] == 2
    assert tap.arc_profile.launches == 2


def test_sampler_and_correlator_stay_on_the_card(cuda):
    """``run_ensemble_batched`` and ``correlate_bank`` keep their tensors
    on the card, and a NaN lane leaves its neighbours' chains bitwise as
    they were there too."""
    from scintools_tpu_torch import detect as tdet
    from scintools_tpu_torch.mcmc import likelihood as tlik
    from scintools_tpu_torch.mcmc import sampler as tsamp

    nt, nf, dt, df = 32, 16, 8.0, 0.4
    build, _, lo, hi, key = tlik.make_acf1d_loglike(nt, nf, dt, df)
    rng = np.random.default_rng(0)
    tl, fl = dt * np.arange(nt), df * np.arange(nf)
    yt = np.exp(-(tl / 150.0) ** (5 / 3)) + 0.02 * rng.normal(size=(3, nt))
    yf = np.exp(-fl / 5.0) + 0.02 * rng.normal(size=(3, nf))
    data = (yt, yf, np.full((3, nt), 4.0), np.full((3, nf), 2.8))
    x0 = np.tile([100.0, 3.0, 1.0, np.log(0.1)], (3, 1))
    out = tsamp.run_ensemble_batched(build, key, data, x0, lo, hi,
                                     nwalkers=8, steps=40, seeds=[1, 2, 3],
                                     device=cuda)
    for v in out.values():
        assert v.device.type == "cuda"
    assert (out["ok"] == 0).all()
    bad = tuple(d.copy() for d in data)
    bad[0][1, 2] = np.nan
    out_bad = tsamp.run_ensemble_batched(build, key, bad, x0, lo, hi,
                                         nwalkers=8, steps=40,
                                         seeds=[1, 2, 3], device=cuda)
    assert int(out_bad["ok"][1]) & tguards.BAD_INPUT
    assert torch.equal(out_bad["chain"][0], out["chain"][0])
    assert torch.equal(out_bad["chain"][2], out["chain"][2])

    bank = tdet.build_bank(64, 128, 30.0, 1.1, 1e-3, 3e-2, n_templates=8,
                           device=cuda)
    assert bank.templates.device.type == "cuda"
    scores, ok = tdet.correlate_bank(
        rng.normal(50.0, 3.0, (2, 64, 128)).astype(np.float32), bank)
    assert scores.device.type == ok.device.type == "cuda"
    assert scores.shape == (2, 8) and torch.isfinite(scores).all()


def test_cuda_graphed_replays_the_function(cuda):
    """``backend.cuda_graphed`` on the card: every replay equals the
    function run eagerly bit for bit, a later replay leaves an earlier
    result alone, and a new signature captures a second graph."""
    from scintools_tpu_torch.backend import cuda_graphed

    def fn(x, w):
        s = torch.fft.rfft2(x).abs().square().reshape(x.shape[0], -1)
        med = torch.nanquantile(s, 0.5, dim=1, keepdim=True)
        return s @ w - med, (s > 0).all(dim=1)

    g = cuda_graphed(fn)
    rng = np.random.default_rng(3)
    xs = [torch.as_tensor(rng.normal(size=(4, 32, 32)), dtype=torch.float32,
                          device=cuda) for _ in range(3)]
    w = torch.as_tensor(rng.normal(size=(32 * 17, 8)), dtype=torch.float32,
                        device=cuda)
    first = g(xs[0], w)
    second = g(xs[1], w)
    for got, x in ((first, xs[0]), (second, xs[1])):
        assert all(torch.equal(a, b) for a, b in zip(got, fn(x, w)))
    assert len(g.graphs) == 1
    third = g(xs[2][:2], w)
    assert all(torch.equal(a, b) for a, b in zip(third, fn(xs[2][:2], w)))
    assert len(g.graphs) == 2


def test_detector_graphs_keep_the_records(cuda):
    """The detector's CUDA-graphed correlation, trigger and refinement
    give the records that the same functions give run eagerly (each
    cached wrapper swapped for the function it captured)."""
    from scintools_tpu_torch import detect as tdet
    from scintools_tpu_torch.detect import correlate as tcor
    from scintools_tpu_torch.detect import refine as tref
    from scintools_tpu_torch.detect import trigger as ttrig

    dyn, times, freqs, _ = _arc_epoch()
    det = tdet.ArcDetector(nf=64, nt=64, dt=30.0, df=0.2,
                           eta_range=(0.05, 2.0), n_templates=16,
                           device=cuda)
    rng = np.random.default_rng(5)
    epochs = [dyn + 0.05 * rng.normal(size=dyn.shape) for _ in range(3)]
    graphed = [det.examine(f"e{i}", d) for i, d in enumerate(epochs)]
    caches = (tcor._CORRELATE_CACHE, tref._REFINE_CACHE,
              ttrig._TRIGGER_CACHE)
    saved = [dict(c) for c in caches]
    assert any(fn.graphs for c in saved for fn in c.values())
    for c in caches:
        c.update({k: fn.fn for k, fn in c.items()})
    try:
        eager = [det.examine(f"e{i}", d) for i, d in enumerate(epochs)]
    finally:
        for c, kept in zip(caches, saved):
            c.clear()
            c.update(kept)
    assert graphed == eager
    assert graphed[0]["triggered"]


def test_serve_on_card_matches_cpu(cuda, tmp_path):
    """The daemon fits the same spool on the card as on the CPU (rel
    1e-4, the tolerance the survey fit is held to), single and batched,
    and its store journals numbers only."""
    import os
    import time

    from scintools_tpu_torch.dynspec import serve_psrflux_survey
    from scintools_tpu_torch.io.psrflux import RawDynSpec, write_psrflux

    spool = tmp_path / "spool"
    spool.mkdir()
    for i in range(6):
        dyn = make_arc_dynspec(64, 96, 2.0, 0.05, 1400.0, 5e-4, 24, 11 + i)
        write_psrflux(RawDynSpec(dyn=dyn, times=2.0 * np.arange(64),
                                 freqs=1400.0 + 0.05 * np.arange(96)),
                      tmp_path / "e.tmp")
        os.replace(tmp_path / "e.tmp", spool / f"e{i}.dynspec")

    def served(workdir, **kw):
        svc = serve_psrflux_survey(spool, tmp_path / workdir, n_iter=30,
                                   poll_s=0.02, heartbeat=False,
                                   http=False, **kw)
        deadline = time.monotonic() + 120
        while len(svc.results()) < 6 and time.monotonic() < deadline:
            time.sleep(0.02)
        svc.stop()
        return {k: v["result"] for k, v in svc.results().items()}

    ref = served("cpu", device="cpu")
    for kw in ({"device": cuda}, {"device": None, "max_batch": 4}):
        got = served(f"card{len(kw)}", **kw)
        assert set(got) == set(ref)
        for e in ref:
            for k in ("tau", "dnu", "amp"):
                assert isinstance(got[e][k], float)
                np.testing.assert_allclose(got[e][k], ref[e][k], rtol=1e-4)


def test_thread_fleet_on_card_launches_arc_profile(cuda, tmp_path):
    """A thread-mode scenario fleet on the card launches the arc-profile
    kernel and merges to the card's own single-process survey."""
    from scintools_tpu_torch.parallel.checkpoint import EpochJournal
    from scintools_tpu_torch.sim import scenario as tsc

    kw = dict(epochs_per_regime=4, ns=64, nf=32, seed=3, numsteps=600,
              n_iter=20, device="cuda")
    tap.arc_profile.launches = 0
    out = tsc.run_scenario_fleet(str(tmp_path / "fleet"), n_workers=2,
                                 batch_size=4, timeout=300.0,
                                 pod_options={"mode": "thread"}, **kw)
    assert tap.arc_profile.launches > 0
    assert out["summary"]["n_epochs"] == 12
    tsc.run_scenario_survey(str(tmp_path / "ref"), batch_size=4,
                            report=False, **kw)
    assert EpochJournal(out["journal"]).valid_lines() == EpochJournal(
        str(tmp_path / "ref" / "journal.jsonl")).valid_lines()
