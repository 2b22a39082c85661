"""General host helpers: the port's own copies of ``is_valid`` and
``svd_model`` of ``scintools_tpu/utils/misc.py:12-26``, host numpy in
float64 as there.
"""

from __future__ import annotations

import numpy as np


def is_valid(array):
    """Finite-and-not-NaN boolean mask."""
    return np.isfinite(array) & ~np.isnan(array)


def svd_model(arr, nmodes=1):
    """Divide out the rank-``nmodes`` SVD model: ``(arr / |model|,
    model)``."""
    u, s, w = np.linalg.svd(arr)
    s = np.array(s)
    s[nmodes:] = 0.0
    S = np.zeros((len(u), len(w)), dtype=complex)
    S[: len(s), : len(s)] = np.diag(s)
    model = u @ S @ w
    return arr / np.abs(model), model
