"""One driver per kind of traffic: ``<name>.Cell``, and the gap they
read between an answer and its reference."""

import numpy as np


def rel_gap(a, b):
    """Elementwise |a − b|/|b|: 0 where both are NaN, inf where one is."""
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.abs(a - b) / np.abs(b)
    both = np.isnan(a) & np.isnan(b)
    one = np.isnan(a) ^ np.isnan(b)
    return np.where(both, 0.0, np.where(one, np.inf, r))
