"""Least-squares fitting with an lmfit-like result object (host side).

Counterpart of ``scintools_tpu/fit/fitter.py:22-278``:
:class:`MinimizerResult` (with ``fit_report`` and its correlations
table), :func:`minimize_leastsq` (scipy's trust-region-reflective
``least_squares``, stderr from the Jacobian's covariance, as lmfit's
``Minimizer.minimize``) and :func:`fitter`. Residual functions are
``f(params, *args) → residuals``; the outer loop runs on the host, and a
residual may evaluate its model on a torch device (the analytic 2-D ACF
of ``sim/acf_model.py`` does).

The ensemble sampler (``mcmc=True``) is not ported yet: ``fitter``
raises for it.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import least_squares


class MinimizerResult:
    """The lmfit fields the fits read: params (with stderr), residual,
    chisqr, redchi, nfree, nfev, success, message."""

    def __init__(self, params, residual=None, success=True, nfev=0,
                 message=""):
        self.params = params
        self.residual = residual
        self.success = success
        self.nfev = nfev
        self.message = message
        if residual is not None:
            self.chisqr = float(np.sum(np.square(residual)))
            nvary = len(params.varying_names())
            self.nfree = max(len(np.ravel(residual)) - nvary, 1)
            self.redchi = self.chisqr / self.nfree

    def fit_report(self, min_correl=0.1):
        """lmfit-style text report: the fit line, χ², each parameter
        with its stderr, and the correlations from the covariance,
        largest first, pairs below ``min_correl`` unreported."""
        lines = [f"[[Fit]] success={self.success} nfev={self.nfev}"]
        if hasattr(self, "chisqr"):
            lines.append(f"chi-square={self.chisqr:.6g} "
                         f"redchi={self.redchi:.6g}")
        for name, par in self.params.items():
            err = "None" if par.stderr is None else f"{par.stderr:.4g}"
            lines.append(f"  {name}: {par.value:.6g} +/- {err}"
                         f" ({'vary' if par.vary else 'fixed'})")
        covar = getattr(self, "covar", None)
        names = self.params.varying_names()
        if covar is not None and len(names) == np.shape(covar)[0] > 1:
            sig = np.sqrt(np.abs(np.diagonal(covar)))
            pairs = []
            for i in range(len(names)):
                for j in range(i + 1, len(names)):
                    denom = sig[i] * sig[j]
                    if denom > 0:
                        c = float(covar[i, j] / denom)
                        if abs(c) >= min_correl:
                            pairs.append((abs(c), names[i], names[j], c))
            if pairs:
                lines.append("[[Correlations]] (unreported "
                             f"correlations are < {min_correl:.3f})")
                for _, n1, n2, c in sorted(pairs, reverse=True):
                    lines.append(f"  C({n1}, {n2}) = {c:+.4f}")
        return "\n".join(lines)


def _residual_vector(model, params, args):
    res = model(params, *args)
    return np.asarray(np.ravel(res), dtype=float)


def minimize_leastsq(model, params, args=(), max_nfev=None,
                     nan_policy="raise"):
    """Trust-region-reflective least squares with stderr from the
    Jacobian's covariance (lmfit ``Minimizer.minimize()``)."""
    params = params.copy()
    names = params.varying_names()
    if not names:
        res = _residual_vector(model, params, args)
        return MinimizerResult(params, residual=res, nfev=1)
    x0 = params.varying_values()
    lo, hi = params.varying_bounds()
    # keep x0 strictly inside any finite bounds
    with np.errstate(invalid="ignore"):
        lo_in = np.where(np.isfinite(lo),
                         lo + 1e-12 * np.maximum(1, np.abs(lo)), lo)
        hi_in = np.where(np.isfinite(hi),
                         hi - 1e-12 * np.maximum(1, np.abs(hi)), hi)
    x0 = np.clip(x0, lo_in, hi_in)

    nfev = 0

    def fun(x):
        nonlocal nfev
        nfev += 1
        r = _residual_vector(model, params.with_values(x), args)
        if nan_policy == "omit":
            r = np.where(np.isfinite(r), r, 0.0)
        elif not np.all(np.isfinite(r)):
            if nan_policy == "raise":
                raise ValueError("NaN in residuals with nan_policy='raise'")
        return r

    sol = least_squares(fun, x0, bounds=(lo, hi), max_nfev=max_nfev)
    params = params.with_values(sol.x)
    result = MinimizerResult(params, residual=sol.fun, success=sol.success,
                             nfev=nfev, message=sol.message)
    # covariance from JᵀJ (Gauss–Newton), lmfit-style; a Jacobian the
    # SVD cannot take leaves the stderrs None
    J = sol.jac
    try:
        _, s, VT = np.linalg.svd(J, full_matrices=False)
    except np.linalg.LinAlgError:
        result.covar = None
        return result
    tol = np.finfo(float).eps * max(J.shape) * (s[0] if len(s) else 0)
    s = s[s > tol]
    VT = VT[: s.size]
    cov = VT.T / s ** 2 @ VT
    cov = cov * result.redchi
    for i, name in enumerate(names):
        result.params[name].stderr = float(np.sqrt(np.abs(cov[i, i])))
    result.covar = cov
    return result


def fitter(model, params, args, mcmc=False, pos=None, nwalkers=100,
           steps=1000, burn=0.2, progress=True, workers=1,
           nan_policy="raise", max_nfev=None, thin=10, is_weighted=True,
           seed=0):
    """The reference ``fitter`` signature: least squares by
    :func:`minimize_leastsq`. ``mcmc=True`` (the ensemble sampler)
    raises ``NotImplementedError`` until the MCMC layer is ported
    (ROADMAP §1 item 11); its options (``pos``, ``nwalkers``, ``steps``,
    ``burn``, ``progress``, ``workers``, ``thin``, ``is_weighted``,
    ``seed``) configure it."""
    if mcmc:
        raise NotImplementedError(
            "fitter(mcmc=True) is not ported yet (ROADMAP item 11)")
    return minimize_leastsq(model, params, args, max_nfev=max_nfev,
                            nan_policy=nan_policy)
