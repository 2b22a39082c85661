"""Card-only checks of the PyTorch/CUDA port: the hand-written kernel
against its plain PyTorch version on the same CUDA tensors, and the
search run on the card against the same search on the CPU.

Every test skips without a CUDA card. The file imports only the port,
so on a machine with a card and no JAX it runs on its own:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from scintools_tpu_torch import multi_chunk_search
from scintools_tpu_torch.thth import eig as teig
from scintools_tpu_torch.thth.core import fft_axis


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


def test_search_on_card_matches_cpu(cuda):
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
    on_card = multi_chunk_search(chunks, freqs, tlist, etas, edges, fw=0.3,
                                 npad=1, device=cuda)
    on_cpu = multi_chunk_search(chunks, freqs, tlist, etas, edges, fw=0.3,
                                npad=1, device="cpu")
    for g, c in zip(on_card, on_cpu):
        assert g.ok == c.ok == 0
        # cuFFT vs pocketfft and kernel vs plain: η to rel 1e-3
        assert g.eta == pytest.approx(c.eta, rel=1e-3)
