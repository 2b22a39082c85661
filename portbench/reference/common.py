"""Pieces the plain references share: the precision a reference computes
in, the Fourier axes, the edge-taper window, the secondary spectrum in
dB and the largest eigenvalue of a batch of hermitian matrices.

Plain PyTorch and NumPy: nothing here imports the program. A reference
runs in ``Precision("float64")``; the control runs the same code in a
lower precision, where every array a stage keeps is rounded to that
precision's mantissa (TF32: 10 bits, bfloat16: 7) and the arithmetic is
float32, as a tensor-core or mixed-precision version of the stage would
hold its operands.
"""

from __future__ import annotations

import numpy as np
import torch

_MANTISSA = {"float64": None, "tf32": 10, "bfloat16": 7}


class Precision:
    """The precision a reference computes in: ``name`` is one of
    ``float64``, ``tf32`` or ``bfloat16``."""

    def __init__(self, name):
        if name not in _MANTISSA:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.bits = _MANTISSA[name]
        wide = name == "float64"
        self.real = torch.float64 if wide else torch.float32
        self.complex = torch.complex128 if wide else torch.complex64

    def __call__(self, x):
        """``x`` held in this precision: cast, then for TF32 and bfloat16
        each float32 rounded to nearest (ties to even) on the kept
        mantissa bits."""
        if x.is_complex():
            x = x.to(self.complex)
            if self.bits is None:
                return x
            return torch.complex(self._round(x.real), self._round(x.imag))
        x = x.to(self.real)
        return x if self.bits is None else self._round(x)

    def _round(self, x):
        drop = 23 - self.bits
        i = x.contiguous().view(torch.int32)
        lsb = (i >> drop) & 1
        i = (i + ((1 << (drop - 1)) - 1) + lsb) & ~((1 << drop) - 1)
        return i.view(torch.float32)


def fft_axis(x, pad=0, scale=1.0):
    """Fourier-conjugate coordinates of the uniform axis ``x`` padded
    with ``pad`` extra copies: time [s] → Doppler [mHz] with ``scale``
    1e3, frequency [MHz] → delay [µs] with 1."""
    x = np.asarray(x, dtype=float)
    return np.fft.fftshift(
        np.fft.fftfreq((pad + 1) * x.shape[0], x[1] - x[0])) * scale


def edge_taper(n, frac=0.1):
    """Hanning edge taper of length ``n``: a Hanning window of
    ``floor(frac·n)`` points split at its middle, its halves at the two
    ends and ones between."""
    w = np.hanning(int(np.floor(frac * n)))
    return np.insert(w, int(np.ceil(len(w) / 2)), np.ones(n - len(w)))


def sspec_axes(nf, nt, dt, df):
    """FFT lengths and axes of the secondary spectrum of an (nf, nt)
    spectrum: ``(nr, nc, fdop [mHz], tdel [µs])``; the lengths are twice
    the next power of two."""
    nr = int(2 ** (np.ceil(np.log2(nf)) + 1))
    nc = int(2 ** (np.ceil(np.log2(nt)) + 1))
    fdop = np.arange(-nc // 2, nc // 2) * 1e3 / (nc * dt)
    tdel = np.arange(nr // 2) / (nr * df)
    return nr, nc, fdop, tdel


def sspec_db(dyn, P, frac=0.1):
    """Secondary spectrum in dB of ``dyn[..., nf, nt]`` (a tensor):
    mean removed, edge-tapered on both axes, mean removed again,
    zero-padded to (nr, nc), |fft2|², centred, positive delays kept,
    10·log10. Every stage held in ``P``."""
    nf, nt = dyn.shape[-2:]
    nr, nc, _, _ = sspec_axes(nf, nt, 1.0, 1.0)
    x = P(dyn)
    x = x - x.mean(dim=(-2, -1), keepdim=True)
    wt = torch.as_tensor(edge_taper(nt, frac), dtype=P.real, device=x.device)
    wf = torch.as_tensor(edge_taper(nf, frac), dtype=P.real, device=x.device)
    x = P(x * wt * wf[:, None])
    x = P(x - x.mean(dim=(-2, -1), keepdim=True))
    power = torch.fft.fft2(x, s=(nr, nc)).abs() ** 2
    power = torch.fft.fftshift(P(power), dim=(-2, -1))[..., nr // 2:, :]
    return P(10 * torch.log10(power))


def lanczos_top(A, P, steps=80, seed=12345):
    """Largest eigenvalue of each hermitian ``A[m, n, n]``: ``steps``
    Lanczos steps (at most n) with full reorthogonalisation, from one
    fixed random start, then the tridiagonal matrix's eigenvalues in
    float64 on the host. Returns ``(λ[m], bound[m])`` as numpy float64,
    ``bound`` the residual norm of the top Ritz pair, which bounds
    |λ − λ_true| for a hermitian matrix."""
    m, n = A.shape[0], A.shape[-1]
    k = min(int(steps), n)
    g = torch.Generator(device=A.device)
    g.manual_seed(seed)
    q = torch.complex(torch.randn(n, generator=g, dtype=P.real,
                                  device=A.device),
                      torch.randn(n, generator=g, dtype=P.real,
                                  device=A.device))
    q = (q / torch.linalg.vector_norm(q)).expand(m, n).contiguous()
    Q = torch.zeros((m, k, n), dtype=A.dtype, device=A.device)
    alpha = torch.zeros((m, k), dtype=P.real, device=A.device)
    beta = torch.zeros((m, k), dtype=P.real, device=A.device)
    floor = 1e-12 * A.abs().amax(dim=(-2, -1)) * n
    for j in range(k):
        Q[:, j] = q
        w = (A @ q[..., None])[..., 0]
        alpha[:, j] = (q.conj() * w).sum(dim=-1).real
        Qj = Q[:, :j + 1]
        for _ in range(2):
            c = torch.einsum("mjn,mn->mj", Qj.conj(), w)
            w = w - torch.einsum("mj,mjn->mn", c, Qj)
        b = torch.linalg.vector_norm(w, dim=-1)
        live = b > floor
        beta[:, j] = torch.where(live, b, 0.0)
        q = torch.where(live[:, None], w / torch.where(live, b, 1.0)[:, None],
                        0.0)
    a = alpha.double().cpu().numpy()
    b = beta.double().cpu().numpy()
    T = np.zeros((m, k, k))
    idx = np.arange(k)
    T[:, idx, idx] = a
    T[:, idx[:-1], idx[1:]] = b[:, :-1]
    T[:, idx[1:], idx[:-1]] = b[:, :-1]
    evals, evecs = np.linalg.eigh(T)
    return evals[:, -1], np.abs(b[:, -1] * evecs[:, -1, -1])
