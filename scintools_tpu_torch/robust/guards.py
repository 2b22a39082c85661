"""Per-chunk health flags for the fused θ-θ search, on torch tensors.

Counterpart of ``scintools_tpu/robust/guards.py:44-116``. Every fused
search returns an ``ok[B]`` int32 bitmask per chunk (0 = healthy):

====================  =====  ==============================================
flag                  bit    meaning
====================  =====  ==============================================
``BAD_INPUT``         1      raw chunk had non-finite pixels (NaN / ±inf)
``BAD_CS``            2      conjugate-spectrum power went non-finite
``BAD_CURVE``         4      eigen curve degenerate (<3 finite, or flat)
``BAD_PEAKFIT``       8      peak fit refused (``BAD_FIT``: the acf2d
                             LM's damped step was singular or non-finite)
====================  =====  ==============================================

Lanes with ``BAD_INPUT`` or ``BAD_CS`` get their fitted outputs forced
to NaN (thth/batch.py:_health_and_quarantine). Every reduction here is
per lane, so a corrupt lane never changes a neighbour's bits.
"""

from __future__ import annotations

import torch

OK = 0
BAD_INPUT = 1
BAD_CS = 2
BAD_CURVE = 4
BAD_PEAKFIT = 8
# the batched acf2d fit flags a singular or non-finite damped step with
# the same bit (the same failure class as the θ-θ peak fit's)
BAD_FIT = BAD_PEAKFIT

_NAMES = {BAD_INPUT: "input_nonfinite", BAD_CS: "cs_nonfinite",
          BAD_CURVE: "curve_degenerate", BAD_PEAKFIT: "peakfit_refused"}


def describe_health(code):
    """Readable decode of an ``ok`` bitmask: ``0 → ['ok']``."""
    code = int(code)
    if code == OK:
        return ["ok"]
    return [name for bit, name in sorted(_NAMES.items()) if code & bit]


def chunk_finite_ok(arrs):
    """Per-chunk all-finite reduction: ``arrs[B, ...] → ok[B]`` bool."""
    return torch.isfinite(arrs).flatten(1).all(dim=1)


def sanitize_chunks(arrs):
    """Zero non-finite pixels so one corrupt lane cannot blow up its
    own FFT (the lane is already condemned by its ``BAD_INPUT`` bit)."""
    return torch.where(torch.isfinite(arrs), arrs,
                       torch.zeros((), dtype=arrs.dtype, device=arrs.device))


def curve_health(eigs):
    """``eigs[B, neta] → ok[B]``: at least 3 finite points and not flat
    (max > min over the finite points)."""
    finite = torch.isfinite(eigs)
    n_fin = finite.sum(dim=1)
    inf = torch.tensor(float("inf"), dtype=eigs.dtype, device=eigs.device)
    hi = torch.where(finite, eigs, -inf).amax(dim=1)
    lo = torch.where(finite, eigs, inf).amin(dim=1)
    return (n_fin >= 3) & (hi > lo)


def health_code(input_ok=None, cs_ok=None, curve_ok=None, fit_ok=None):
    """Combine per-chunk ``[B]`` bool flags into the int32 bitmask
    (``None`` stages contribute nothing)."""
    code = None
    for ok, bit in ((input_ok, BAD_INPUT), (cs_ok, BAD_CS),
                    (curve_ok, BAD_CURVE), (fit_ok, BAD_PEAKFIT)):
        if ok is None:
            continue
        term = torch.where(ok, 0, bit).to(torch.int32)
        code = term if code is None else code | term
    if code is None:
        raise ValueError("health_code needs at least one stage flag")
    return code
