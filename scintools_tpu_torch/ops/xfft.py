"""Real-input 2-D transforms on ``torch.fft`` (cuFFT on the card).

Counterpart of ``scintools_tpu/ops/xfft.py``: ``hermitian_full_from_half``
(:111), ``fft2_full`` (:141, ``rfft`` and ``fft2`` variants),
``halfrow_power`` (:262) and the dense branch of ``Plan.power``
(:548-559). The JAX package routes these through a declarative plan and
a formulation registry; the port has no registry in this slice, so the
variant is an explicit argument.
"""

from __future__ import annotations

import torch


def hermitian_full_from_half(H, n2):
    """Full 2-D spectrum of a real input from its ``rfft2`` half
    ``H[..., n1, n2//2+1]``: ``F[k1, k2] = conj(F[(-k1) % n1, n2 - k2])``
    for the missing columns ``k2 = n2//2+1 .. n2-1``."""
    n1 = H.shape[-2]
    m = H.shape[-1]                       # n2 // 2 + 1
    idx1 = (-torch.arange(n1, device=H.device)) % n1
    tail = torch.conj(H[..., idx1, 1:n2 - m + 1].flip(-1))
    return torch.cat([H, tail], dim=-1)


def fft2_full(x, variant="fft2"):
    """Full complex 2-D spectrum of the trailing axes. ``'rfft'`` takes
    the half spectrum of a real input plus the Hermitian completion;
    ``'fft2'`` is the dense complex transform (complex inputs always
    take it)."""
    if variant not in ("rfft", "fft2"):
        raise ValueError(f"unknown variant {variant!r} "
                         "(want 'rfft' or 'fft2')")
    if variant == "rfft" and not x.is_complex():
        return hermitian_full_from_half(torch.fft.rfft2(x), x.shape[-1])
    return torch.fft.fft2(x)


def halfrow_power(x, pad_to):
    """``fftshift(|fft2(x, s=pad_to)|²)[N1//2:]`` of a real ``x`` with
    the row crop folded into the transform: rfft over the halved
    (delay) axis, crop, then the second-axis transform on half the
    rows. Rows come back in raw order (= the kept half of the shifted
    frame), the column axis fftshifted."""
    N1, N2 = pad_to
    S = torch.fft.rfft(x, n=N1, dim=-2)
    S = torch.fft.fft(S[..., :N1 // 2, :], n=N2, dim=-1)
    p = (S * torch.conj(S)).real
    return torch.fft.fftshift(p, dim=-1)


def dense_power(x, pad_to, halved):
    """The dense oracle of ``Plan.power``: full complex fft2, power,
    fftshift, and the ``[N1//2:]`` crop when ``halved``."""
    N1, N2 = pad_to
    simf = torch.fft.fft2(x, s=(N1, N2))
    sec = torch.fft.fftshift((simf * torch.conj(simf)).real,
                             dim=(-2, -1))
    return sec[..., N1 // 2:, :] if halved else sec
