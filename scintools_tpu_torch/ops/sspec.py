"""Secondary spectrum and chunk conjugate spectra in PyTorch.

Counterpart of ``scintools_tpu/ops/sspec.py``: ``fft_shapes`` (:34),
``sspec_axes`` (:41), ``_prewhite_diff`` (:52),
``zoom_band`` (:58), ``secondary_spectrum_power`` (:74, ``zoom=``
included),
``pad_chunk_batch`` (:150), ``chunk_conjugate_spectrum_batch`` (:175)
and ``secondary_spectrum`` (:235). Mean-subtract → edge-taper window →
zero-pad to next-pow2 ×2 → fft2 → power → fftshift → keep positive
delays → optional prewhiten / post-darken → 10·log10. Works in
float32 / complex64 on the caller's device. The transforms go through a
declared ``xfft.plan`` as the JAX functions do, and ``ops.cs`` (:28, the
chunk conjugate spectrum's ``rfft`` against ``fft2``) is registered
here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import REAL, as_tensor, formulation, register_formulation
from ..backend import resolve_device
from . import xfft
from .windows import apply_window, get_window


register_formulation(
    "ops.cs", default="rfft", choices=("rfft", "fft2"),
    platforms={"cpu": "rfft", "cuda": "rfft"},
    doc="chunk conjugate spectrum: rfft2 + Hermitian completion vs the "
        "complex fft2")


def fft_shapes(nf, nt):
    """FFT lengths used by the reference: next power of two, doubled."""
    nrfft = int(2 ** (np.ceil(np.log2(nf)) + 1))
    ncfft = int(2 ** (np.ceil(np.log2(nt)) + 1))
    return nrfft, ncfft


def sspec_axes(nf, nt, dt, df, halve=True, dlam=None):
    """(fdop [mHz], tdel [us], beta [m^-1] or None) axes for the sspec."""
    nrfft, ncfft = fft_shapes(nf, nt)
    td = np.arange(nrfft // 2 if halve else nrfft)
    fd = np.arange(-ncfft // 2, ncfft // 2)
    fdop = fd * 1e3 / (ncfft * dt)
    tdel = td / (nrfft * df)
    beta = td / (nrfft * dlam) if dlam is not None else None
    return fdop, tdel, beta


def _prewhite_diff(dyn):
    """2-D first-difference prewhitening: 'valid' convolution with
    [[1,-1],[-1,1]]."""
    return (dyn[..., 1:, 1:] - dyn[..., 1:, :-1] - dyn[..., :-1, 1:]
            + dyn[..., :-1, :-1])


def zoom_band(nf, nt, dt, df, tdel_band, fdop_band, n_tdel, n_fdop):
    """A physical window of the secondary spectrum as the ``zoom=`` pair
    of :func:`secondary_spectrum_power`: ``tdel_band`` [µs] and
    ``fdop_band`` [mHz, signed] → ``((r0, r1, n_tdel), (c0, c1,
    n_fdop))`` in the (fractional, signed) bin units of the padded frame
    (:func:`sspec_axes` inverted: td = tdel·nrfft·df, fd =
    fdop·ncfft·dt/1e3)."""
    nrfft, ncfft = fft_shapes(nf, nt)
    r = (float(tdel_band[0]) * nrfft * df,
         float(tdel_band[1]) * nrfft * df, int(n_tdel))
    c = (float(fdop_band[0]) * ncfft * dt / 1e3,
         float(fdop_band[1]) * ncfft * dt / 1e3, int(n_fdop))
    return r, c


def secondary_spectrum_power(dyn, window_arrays=None, prewhite=False,
                             halve=True, variant=None, zoom=None):
    """Linear-power secondary spectrum of the tensor ``dyn[..., nf, nt]``
    → ``(..., nrfft//2 if halve else nrfft, ncfft)``.

    ``variant='half'`` folds the ``halve`` row crop into the transform
    (:func:`xfft.halfrow_power`); ``'dense'`` is the full complex-fft2
    oracle; ``None`` resolves ``xfft.sspec`` on ``dyn``'s device. The
    full frame (``halve=False``) always takes dense.

    ``zoom``: a ``(band_rows, band_cols)`` pair of ``(f0, f1, n_out)``
    triples in (fractional, signed) bin units of the padded frame
    (:func:`zoom_band` converts µs/mHz windows; the edges may be
    tensors). Only those band pixels are computed, at any density,
    through :func:`xfft.zoom_power_2d`; the result runs f0 → f1 on each
    axis (no fftshift; ``halve`` does not apply, ``prewhite`` is
    refused), and ``variant`` is ``'czt'`` or ``'dense'`` (``None``:
    ``xfft.zoom``)."""
    if zoom is not None:
        if prewhite:
            raise RuntimeError("prewhite post-darkening is defined on the "
                               "native frame, not with zoom=")
    else:
        if variant is None:
            variant = formulation("xfft.sspec", dyn.device.type)
        if variant not in ("half", "dense"):
            raise ValueError(f"unknown variant {variant!r} "
                             "(want 'half' or 'dense')")
    nf, nt = dyn.shape[-2:]
    nrfft, ncfft = fft_shapes(nf, nt)

    dyn = dyn - dyn.mean(dim=(-2, -1), keepdim=True)
    if window_arrays is not None:
        dyn = apply_window(dyn, window_arrays[0], window_arrays[1])
    dyn = dyn - dyn.mean(dim=(-2, -1), keepdim=True)

    if zoom is not None:
        p = xfft.plan((nf, nt), (nrfft, ncfft), real_input=True, band=zoom,
                      op="xfft.zoom")
        return p.power(dyn, variant=variant)

    if prewhite:
        if not halve:
            raise RuntimeError("Cannot apply prewhite to full frame")
        dyn = _prewhite_diff(dyn)

    p = xfft.plan((nf, nt), (nrfft, ncfft), real_input=True,
                  crop=(nrfft // 2, None) if halve else None,
                  layout="shifted", op="xfft.sspec")
    sec = p.power(dyn, variant=variant)

    if prewhite:  # post-darken
        fd = np.arange(-ncfft // 2, ncfft // 2)
        td = np.arange(nrfft // 2)
        postdark = np.outer(np.sin(np.pi / nrfft * td) ** 2,
                            np.sin(np.pi / ncfft * fd) ** 2)
        postdark[:, ncfft // 2] = 1
        postdark[0, :] = 1
        sec = sec / torch.as_tensor(postdark, dtype=sec.dtype,
                                    device=sec.device)
    return sec


def pad_chunk_batch(dspecs, npad):
    """Mean-pad a batch of θ-θ chunks: ``(B, nf, nt) →
    (B, (1+npad)·nf, (1+npad)·nt)``, each chunk padded with its own
    mean (zero-pad the mean-subtracted chunk and add the mean back)."""
    _, nf, nt = dspecs.shape
    mu = dspecs.mean(dim=(1, 2), keepdim=True)
    return torch.nn.functional.pad(dspecs - mu,
                                   (0, npad * nt, 0, npad * nf)) + mu


def chunk_conjugate_spectrum_batch(dspecs, npad=3, tau_keep=None,
                                   method=None, shift=True):
    """Per-chunk mean pad → fft2 → fftshift of a same-geometry chunk
    stack: ``dspecs[B, nf, nt]`` real → ``CS[B, (1+npad)nf,
    (1+npad)nt]`` complex. ``tau_keep`` is an optional host bool mask
    over the (shifted) delay axis; rows outside it are zeroed.
    ``method='rfft'`` takes the half spectrum plus the Hermitian
    completion, ``'fft2'`` the dense complex transform; ``None``
    resolves ``ops.cs`` on the stack's device.
    ``shift=False`` skips the final ``fftshift`` and returns the raw
    fft layout (a consumer that gathers folds the shift into its
    index map); ``tau_keep`` indexes the shifted axis and is refused
    then."""
    if not shift and tau_keep is not None:
        raise ValueError("tau_keep indexes the SHIFTED delay axis — "
                         "fold the mask into the consumer's gather "
                         "when shift=False")
    if method is None:
        method = formulation("ops.cs", dspecs.device.type)
    if method not in ("rfft", "fft2"):
        raise ValueError(f"unknown conjugate-spectrum method {method!r} "
                         "(want 'rfft' or 'fft2')")
    padded = pad_chunk_batch(dspecs, npad)
    CS = xfft.fft2_full(padded, variant=method)
    if not shift:
        return CS
    CS = torch.fft.fftshift(CS, dim=(-2, -1))
    if tau_keep is not None:
        keep = torch.as_tensor(np.asarray(tau_keep), device=CS.device)
        CS = CS.masked_fill(~keep[None, :, None], 0)
    return CS


def secondary_spectrum(dyn, dt, df, window="hanning", window_frac=0.1,
                       prewhite=False, halve=True, dlam=None, db=True,
                       variant=None, device=None):
    """Full sspec pipeline → (fdop [mHz], yaxis, sec) with ``sec`` a
    float32 tensor on ``device`` (dB when ``db``). yaxis is beta
    [m^-1] when ``dlam`` is given, else tdel [us]."""
    dev = resolve_device(device)
    if isinstance(dyn, torch.Tensor):
        dyn = dyn.to(device=dev, dtype=REAL)
    else:
        dyn = as_tensor(np.asarray(dyn), dev)
    nf, nt = dyn.shape
    wins = None
    if window is not None:
        wins = get_window(nt, nf, window=window, frac=window_frac)
    sec = secondary_spectrum_power(dyn, window_arrays=wins,
                                   prewhite=prewhite, halve=halve,
                                   variant=variant)
    if db:
        sec = 10 * torch.log10(sec)
    fdop, tdel, beta = sspec_axes(nf, nt, dt, df, halve=halve, dlam=dlam)
    return fdop, (beta if dlam is not None else tdel), sec
