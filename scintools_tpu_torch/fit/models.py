"""Parabola peak fitters of the arc fit (numpy, host side).

The port's own copies of ``fit_parabola`` and ``fit_log_parabola`` of
``scintools_tpu/fit/models.py:227-250``: a degree-2 ``np.polyfit``
with covariance on x scaled by 1000/ptp, and the same in log x.
"""

from __future__ import annotations

import numpy as np


def fit_parabola(x, y):
    """Deg-2 polyfit with covariance → (yfit, peak, peak_error)."""
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    ptp = np.ptp(x)
    xs = x * (1000 / ptp)
    params, pcov = np.polyfit(xs, y, 2, cov=True)
    yfit = params[0] * xs ** 2 + params[1] * xs + params[2]
    errors = np.sqrt(np.abs(np.diag(pcov)))
    peak = -params[1] / (2 * params[0])
    peak_error = np.sqrt((errors[1] ** 2) * ((1 / (2 * params[0])) ** 2)
                         + (errors[0] ** 2) * ((params[1] / 2) ** 2))
    return yfit, peak * (ptp / 1000), peak_error * (ptp / 1000)


def fit_log_parabola(x, y):
    """Parabola fit in log x → (yfit, peak, peak_error)."""
    logx = np.log(np.asarray(x, dtype=float))
    ptp = np.ptp(logx)
    xs = logx * (1000 / ptp)
    yfit, peak, peak_error = fit_parabola(xs, y)
    frac_error = peak_error / peak
    peak = np.e ** (peak * ptp / 1000)
    return yfit, peak, frac_error * peak
