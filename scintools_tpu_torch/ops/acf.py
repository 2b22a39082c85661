"""2-D autocovariance on the device (cuFFT through ``torch.fft``).

Counterpart of ``scintools_tpu/ops/acf.py``: ``autocovariance`` (:25)
and ``acf_from_sspec`` (:56). The mean over the finite pixels is taken
in float64 and the invalid pixels then contribute zero; the transforms
run in float32 / complex64. ``variant="real"`` is the real-input
Wiener–Khinchin round trip (``xfft.wiener_khinchin``), ``"dense"`` the
complex oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import REAL, resolve_device
from . import xfft


def _on(x, dev):
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
    return torch.as_tensor(x, device=dev)


def autocovariance(dyn, normalise=True, mean_sub=True, variant="real",
                   device=None):
    """ACF of ``dyn[..., nf, nt]`` (numpy or tensor) → a float32 tensor
    ``(..., 2nf, 2nt)`` on ``device`` (``None``: the CUDA card), zero
    lag at ``[nf, nt]``, each slice divided by its peak when
    ``normalise``."""
    dev = resolve_device(device)
    x = _on(dyn, dev).to(torch.float64)
    nf, nt = x.shape[-2:]
    if mean_sub:
        finite = torch.isfinite(x)
        x0 = torch.where(finite, x, 0.0)
        nvalid = finite.sum(dim=(-2, -1), keepdim=True)
        mean = x0.sum(dim=(-2, -1), keepdim=True) / nvalid
        x = torch.where(finite, x - mean, 0.0)
    arr = xfft.wiener_khinchin(x.to(REAL), (2 * nf, 2 * nt),
                               variant=variant)
    arr = torch.fft.fftshift(arr, dim=(-2, -1))
    if normalise:
        arr = arr / arr.amax(dim=(-2, -1), keepdim=True)
    return arr


def acf_from_sspec(sspec_db, normalise=True, variant="real", device=None):
    """ACF from the full-frame (not halved) secondary spectrum in dB:
    the forward transform of its linear power (``'real'``: the
    half-spectrum ``rfft2`` plus the Hermitian completion; ``'dense'``:
    the complex ``fft2``), shifted, real part. A float32 tensor on
    ``device`` (``None``: the CUDA card)."""
    if variant not in ("real", "dense"):
        raise ValueError(f"unknown variant {variant!r} "
                         "(want 'real' or 'dense')")
    dev = resolve_device(device)
    s = torch.fft.fftshift(_on(sspec_db, dev).to(REAL), dim=(-2, -1))
    lin = 10 ** (s / 10)
    F = xfft.fft2_full(lin, variant="rfft" if variant == "real" else "fft2")
    arr = torch.fft.fftshift(F, dim=(-2, -1)).real
    if normalise:
        arr = arr / arr.max()
    return arr
