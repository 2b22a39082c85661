"""Overlap-save whole-bank correlation, on a torch device.

Counterpart of ``scintools_tpu/detect/correlate.py``:
:func:`time_blocks` (:59), :func:`extract_blocks` (:77),
:func:`correlate_program` (:95) and :func:`correlate_bank` (:164). Each
epoch (or 50 %-overlapping time block of a longer one) is transformed
once and matched against the whole bank in one batched call:

1. per-lane health (``robust/guards.py``): non-finite input pixels set
   ``BAD_INPUT`` and are zeroed before the batched FFT, so a corrupt
   lane cannot reach its neighbours, whose bits stay as they were;
2. the halved secondary-spectrum power per lane (cuFFT through
   ``ops.sspec.secondary_spectrum_power``: ``variant="half"``, the
   real-input transform with the row crop folded, or ``"dense"``, the
   complex fft2 oracle; ``None`` resolves the ``detect.correlate``
   formulation, registered here as in the JAX package's :55);
3. dB relative to the lane's peak and a robust standardisation over the
   bank's valid region: the median and the MAD as
   ``torch.nanquantile(·, 0.5)``, which averages the two middle values
   of an even count as ``jnp.nanmedian`` does (``torch.nanmedian`` would
   return the lower one);
4. one product of the standardised spectra with the whole bank,
   ``scores[B, K] = x̂[B, P] @ T[K, P]ᵀ`` (``torch.matmul``, TF32 off as
   everywhere in the port; the JAX package computes it outside any
   Pallas kernel).

A longer epoch is cut into overlapping blocks that ride the batch axis
of the same call, and the trigger stage keeps the best block: an arc
split by one block's edge is whole in its neighbour.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import (cuda_graphed, fifo_cached, formulation,
                       register_formulation, resolve_device)
from ..obs import retrace as _retrace

VARIANTS = ("half", "dense")

register_formulation(
    "detect.correlate", default="half", choices=VARIANTS,
    platforms={"cpu": "half", "cuda": "half"},
    doc="template-bank correlation front transform: the halved-spectrum "
        "real-input lowering vs the full complex-fft2 oracle")


def time_blocks(nt_epoch, nt_block, hop=None):
    """Overlap-save block starts for an ``nt_epoch``-long time axis cut
    into ``nt_block`` frames at ``hop`` (default 50 % overlap). The last
    block is right-aligned, so the epoch's tail is always covered by a
    whole frame."""
    nt_epoch, nt_block = int(nt_epoch), int(nt_block)
    if nt_epoch < nt_block:
        raise ValueError(f"epoch shorter than the bank frame "
                         f"({nt_epoch} < {nt_block})")
    hop = int(hop) if hop else max(1, nt_block // 2)
    starts = list(range(0, nt_epoch - nt_block + 1, hop))
    if starts[-1] != nt_epoch - nt_block:
        starts.append(nt_epoch - nt_block)
    return starts


def extract_blocks(dyn, nt_block, hop=None):
    """Cut ``dyn[nf, nt]`` into the overlap-save block stack ``[n_blocks,
    nf, nt_block]`` (host numpy)."""
    dyn = np.asarray(dyn)
    starts = time_blocks(dyn.shape[-1], nt_block, hop)
    return np.stack([dyn[..., s:s + int(nt_block)] for s in starts])


_CORRELATE_CACHE = {}
_MAX_CACHED = 16


def correlate_program(nf, nt, n_batch, n_templates, *, variant=None,
                      window="hanning", window_frac=0.1, device=None):
    """The cached whole-bank correlation ``fn(dyns[B, nf, nt], T[K, P],
    valid[P]) → (scores[B, K], ok[B] int32)`` on ``device`` (``None``:
    the card), one build per (geometry, batch, K, variant, window),
    site ``detect.correlate``; ``variant=None`` resolves the
    ``detect.correlate`` formulation on ``device``."""
    dev = resolve_device(device)
    if variant is None:
        variant = formulation("detect.correlate", dev.type)
    if variant not in VARIANTS:
        raise ValueError(f"unknown detect.correlate variant {variant!r} "
                         "(want 'half' or 'dense')")
    key = (int(nf), int(nt), int(n_batch), int(n_templates), variant,
           window, float(window_frac), str(dev))

    def make():
        from ..ops.sspec import secondary_spectrum_power
        from ..ops.windows import get_window
        from ..robust import guards

        _retrace.record_build("detect.correlate", key)
        wins = None
        if window is not None:
            wins = tuple(torch.as_tensor(w, dtype=torch.float32, device=dev)
                         for w in get_window(int(nt), int(nf), window=window,
                                             frac=window_frac))

        def run(dyns, T, valid):
            in_ok = guards.chunk_finite_ok(dyns)
            d = guards.sanitize_chunks(dyns.to(torch.float32))
            sec = secondary_spectrum_power(d, window_arrays=wins,
                                           variant=variant)
            cs_ok = guards.chunk_finite_ok(sec)
            # dB relative to the lane peak (scale-free), floored so a
            # blanked lane stays finite end to end
            smax = sec.amax(dim=(1, 2), keepdim=True)
            smax = torch.where(smax > 0, smax, torch.ones_like(smax))
            x = 10.0 * torch.log10(sec / smax + 1e-12)
            x = x.reshape(x.shape[0], -1)
            # robust standardisation over the valid region
            xv = torch.where(valid > 0, x, torch.full_like(x, np.nan))
            med = torch.nanquantile(xv, 0.5, dim=1, keepdim=True)
            mad = torch.nanquantile((xv - med).abs(), 0.5, dim=1,
                                    keepdim=True)
            xhat = (x - med) / (1.4826 * mad + 1e-6)
            xhat = xhat * valid[None]
            scores = xhat @ T.T
            ok = guards.health_code(input_ok=in_ok, cs_ok=cs_ok)
            return scores, ok

        return cuda_graphed(run)

    return fifo_cached(_CORRELATE_CACHE, key, make, _MAX_CACHED)


def correlate_bank(dyns, bank, *, variant=None, window="hanning",
                   window_frac=0.1):
    """Correlate a block or epoch stack ``dyns[B, nf, nt]`` (numpy or a
    tensor) against the whole ``bank`` on the bank's device. Returns
    device ``(scores[B, K], ok[B])``, to hand to the trigger stage."""
    dev = bank.device
    dyns = torch.as_tensor(dyns, device=dev)
    if dyns.ndim == 2:
        dyns = dyns[None]
    B, nf, nt = dyns.shape
    gnf, gnt = bank.geometry[0], bank.geometry[1]
    if (nf, nt) != (gnf, gnt):
        raise ValueError(
            f"stack geometry ({nf}, {nt}) does not match the bank's "
            f"({gnf}, {gnt}) — rebuild the bank or re-block the epoch "
            f"(detect.correlate.extract_blocks)")
    fn = correlate_program(nf, nt, B, bank.n_templates, variant=variant,
                           window=window, window_frac=window_frac,
                           device=dev)
    return fn(dyns, bank.templates, bank.valid)
