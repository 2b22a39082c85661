"""Cubic resampling along one axis (scipy, host side).

The port's own copy of ``columnwise_cubic_interp`` of
``scintools_tpu/ops/interp.py:28``: the reference's per-column
``interp1d`` loop of ``scale_dyn``, vectorised through scipy's axis
support, in float64. ``interp_nan_2d`` is not ported yet.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import interp1d


def columnwise_cubic_interp(arr, x_src, x_new, axis=0):
    """Cubic interpolation of each 1-D slice of ``arr`` along ``axis``
    from coordinates ``x_src`` onto ``x_new`` (clipped into the source
    range)."""
    f = interp1d(x_src, arr, kind="cubic", axis=axis)
    x_new = np.clip(x_new, np.min(x_src), np.max(x_src))
    return f(x_new)
