"""Interpolation on the host with scipy: NaN infill and cubic resampling
along one axis.

The port's own copies of ``interp_nan_2d`` and ``columnwise_cubic_interp``
of ``scintools_tpu/ops/interp.py:14-37``, in float64. ``interp_nan_2d``
(the ``linear``, ``cubic`` and ``nearest`` refills) triangulates every
valid pixel, so its cost grows fast with the spectrum's size.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import griddata, interp1d


def interp_nan_2d(array, method="linear"):
    """Fill the NaNs of a 2-D array by ``griddata`` interpolation from
    its valid pixels."""
    array = np.array(array, dtype=float).squeeze()
    x = np.arange(array.shape[1])
    y = np.arange(array.shape[0])
    marr = np.ma.masked_invalid(array)
    xx, yy = np.meshgrid(x, y)
    x1 = xx[~marr.mask]
    y1 = yy[~marr.mask]
    newarr = np.ravel(array[~marr.mask])
    return griddata((x1, y1), newarr, (xx, yy), method=method)


def columnwise_cubic_interp(arr, x_src, x_new, axis=0):
    """Cubic interpolation of each 1-D slice of ``arr`` along ``axis``
    from coordinates ``x_src`` onto ``x_new`` (clipped into the source
    range)."""
    f = interp1d(x_src, arr, kind="cubic", axis=axis)
    x_new = np.clip(x_new, np.min(x_src), np.max(x_src))
    return f(x_new)
