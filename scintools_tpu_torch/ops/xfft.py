"""Real-input 2-D transforms on ``torch.fft`` (cuFFT on the card).

Counterpart of ``scintools_tpu/ops/xfft.py``: ``hermitian_full_from_half``
(:111), ``hermitian_half_gather`` (:125), ``fft2_full`` (:141, ``rfft``
and ``fft2`` variants), ``ifft2_cropped`` (:186), ``wiener_khinchin``
(:236), ``halfrow_power`` (:262) and the dense branch of ``Plan.power``
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


def hermitian_half_gather(H, n2, rows, cols):
    """Point-gather full-spectrum entries of real inputs from their
    ``rfft2`` halves ``H[B, n1, n2//2+1]``: ``rows``/``cols`` (int64,
    leading axis B) index the RAW full ``(n1, n2)`` spectrum of each
    input, and entries in the missing columns (``cols > n2//2``) read
    the conjugate of the mirrored half-plane entry, so the full complex
    spectrum never materialises."""
    n1, m = H.shape[-2:]
    tail = cols >= m
    r = torch.where(tail, (n1 - rows) % n1, rows)
    c = torch.where(tail, n2 - cols, cols)
    b = torch.arange(H.shape[0], device=H.device).view(
        (-1,) + (1,) * (rows.ndim - 1))
    v = H[b, r, c]
    return torch.where(tail, torch.conj(v), v)


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


def ifft2_cropped(X, crop):
    """``ifft2(X)[..., :rows, :cols]`` over the trailing axes, with the
    row crop folded between the per-axis transforms (the JAX package's
    ``'split'`` variant): only ``rows`` of the axis-0 outputs reach the
    axis-1 transform. Exact: the crop commutes with the per-row
    transform."""
    r, c = crop
    Y = torch.fft.ifft(X, dim=-2)[..., :r, :]
    return torch.fft.ifft(Y, dim=-1)[..., :c]


def wiener_khinchin(x, pad_to, variant="real"):
    """Circular autocovariance ``F⁻¹|F x|²`` of ``x`` over the trailing
    axes zero-padded to ``pad_to``, in raw layout. ``'real'`` (a real
    ``x``): the axis-1 rfft of the data rows, the axis-0 fft, |·|², then
    the real inverse ``irfft2``, so the discarded Hermitian half is
    never computed; ``'dense'`` is the complex ``fft2 → |·|² → ifft2``
    oracle (complex inputs always take it)."""
    if variant not in ("real", "dense"):
        raise ValueError(f"unknown variant {variant!r} "
                         "(want 'real' or 'dense')")
    N1, N2 = pad_to
    if variant == "real" and not x.is_complex():
        H = torch.fft.rfft(x, n=N2, dim=-1)        # data rows only
        H = torch.fft.fft(H, n=N1, dim=-2)
        P = (H * torch.conj(H)).real
        return torch.fft.irfft2(P, s=(N1, N2))
    arr = torch.fft.fft2(x, s=(N1, N2))
    return torch.fft.ifft2(arr.abs() ** 2).real


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
