"""2-D autocovariance on the device (cuFFT through ``torch.fft``).

Counterpart of ``scintools_tpu/ops/acf.py``: ``autocovariance`` (:25)
and ``acf_from_sspec`` (:56). The mean over the finite pixels is taken
in float64 and the invalid pixels then contribute zero; the transforms
run in float32 / complex64. Both go through a declared ``xfft.plan``
as the JAX functions do; ``variant=None`` resolves the registry op
(``xfft.acf``, ``xfft.acf_sspec``) on the device: ``"real"`` is the
real-input transform, ``"dense"`` the complex oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import REAL, formulation, resolve_device
from . import xfft


def _on(x, dev):
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
    return torch.as_tensor(x, device=dev)


def autocovariance(dyn, normalise=True, mean_sub=True, variant=None,
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
    p = xfft.plan((nf, nt), (2 * nf, 2 * nt), real_input=True,
                  layout="shifted", op="xfft.acf")
    arr = p.acf(x.to(REAL), variant=variant)
    if normalise:
        arr = arr / arr.amax(dim=(-2, -1), keepdim=True)
    return arr


def acf_from_sspec(sspec_db, normalise=True, variant=None, device=None):
    """ACF from the full-frame (not halved) secondary spectrum in dB:
    the forward transform of its linear power (``'real'``: the
    half-spectrum ``rfft2`` plus the Hermitian completion; ``'dense'``:
    the complex ``fft2``; ``None``: the ``xfft.acf_sspec`` formulation),
    shifted, real part. A float32 tensor on ``device`` (``None``: the
    CUDA card)."""
    dev = resolve_device(device)
    if variant is None:
        variant = formulation("xfft.acf_sspec", dev.type)
    if variant not in ("real", "dense"):
        raise ValueError(f"unknown variant {variant!r} "
                         "(want 'real' or 'dense')")
    s = torch.fft.fftshift(_on(sspec_db, dev).to(REAL), dim=(-2, -1))
    lin = 10 ** (s / 10)
    p = xfft.plan(lin.shape[-2:], real_input=True, layout="shifted")
    arr = p.forward(lin, variant="rfft" if variant == "real"
                    else "fft2").real
    if normalise:
        arr = arr / arr.max()
    return arr


def autocorr_direct(arr, mask=None):
    """Slow masked O(N⁴) 2-D autocorrelation on the host — the test
    oracle of the reference's ``autocorr`` (numpy only, as in the JAX
    package). A masked-array input keeps its mask."""
    in_mask = np.ma.getmaskarray(arr) if np.ma.isMaskedArray(arr) \
        else None
    arr = np.ma.masked_invalid(np.asarray(arr, dtype=float))
    if in_mask is not None:
        arr = np.ma.masked_array(arr, mask=arr.mask | in_mask)
    if mask is not None:
        arr = np.ma.masked_array(arr, mask=mask)
    mean = np.ma.mean(arr)
    std = np.ma.std(arr)
    nr, nc = arr.shape
    out = np.zeros((2 * nr, 2 * nc))
    for x in range(-nr, nr):
        for y in range(-nc, nc):
            seg = (arr[max(0, x):min(x + nr, nr), max(0, y):min(y + nc, nc)]
                   - mean) * (arr[max(0, -x):min(-x + nr, nr),
                                  max(0, -y):min(-y + nc, nc)] - mean)
            out[x + nr][y + nc] = np.ma.sum(seg) / (std ** 2)
    out /= np.nanmax(out)
    return out
