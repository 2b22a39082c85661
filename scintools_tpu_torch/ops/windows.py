"""Edge-taper windows for spectral analysis (numpy, host side).

The port's own copy of ``scintools_tpu/ops/windows.py:25-53``: a
window of ``floor(frac*n)`` points is split at its midpoint and the two
halves are placed at the array edges with ones in between, so only the
outer ``frac`` fraction of pixels is tapered. Built once in numpy and
handed to the device as constants.
"""

from __future__ import annotations

import numpy as np
import torch

_WINDOW_FUNCS = {
    "hanning": np.hanning,
    "hamming": np.hamming,
    "blackman": np.blackman,
    "bartlett": np.bartlett,
}


def edge_taper(n, window="hanning", frac=0.1):
    """1-D edge-taper window of length ``n``: the first ceil(m/2)
    window samples, then ones, then the remaining floor(m/2)."""
    if window is None:
        return np.ones(n)
    try:
        wfunc = _WINDOW_FUNCS[window.lower()]
    except KeyError:
        raise ValueError(
            f"Window {window!r} unknown; options: {sorted(_WINDOW_FUNCS)}"
        )
    m = int(np.floor(frac * n))
    w = wfunc(m)
    return np.insert(w, int(np.ceil(len(w) / 2)), np.ones(n - len(w)))


def get_window(nt, nf, window="hanning", frac=0.1):
    """(chan_window[nt], subint_window[nf]) pair."""
    return edge_taper(nt, window, frac), edge_taper(nf, window, frac)


def apply_window(dyn, chan_window, subint_window):
    """Apply time (last-axis) and frequency (first-axis) tapers to a
    ``dyn[..., nf, nt]`` tensor; the windows may be numpy arrays."""
    cw = torch.as_tensor(chan_window, dtype=dyn.dtype, device=dyn.device)
    sw = torch.as_tensor(subint_window, dtype=dyn.dtype, device=dyn.device)
    return dyn * cw * sw[..., :, None]

