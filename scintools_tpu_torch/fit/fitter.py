"""Least-squares fitting with an lmfit-like result object (host side).

Counterpart of ``scintools_tpu/fit/fitter.py:22-278``:
:class:`MinimizerResult` (with ``fit_report`` and its correlations
table), :func:`minimize_leastsq` (scipy's trust-region-reflective
``least_squares``, stderr from the Jacobian's covariance, as lmfit's
``Minimizer.minimize``) and :func:`fitter`. Residual functions are
``f(params, *args) → residuals``; the outer loop runs on the host, and a
residual may evaluate its model on a torch device (the analytic 2-D ACF
of ``sim/acf_model.py`` does).

:func:`sample_emcee` is the JAX package's numpy stretch move (:147-245),
copied: the same ``seed`` gives the same chain bit for bit. ``fitter(
mcmc=True)`` runs the device sampler instead
(:func:`~.ensemble.sample_emcee_jax`, the B = 1 lane of
``mcmc/sampler.py``), with no fall-back: an error of the model or of the
device propagates (the JAX ``fitter`` drops to the host sampler on any
exception, :261-271).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import least_squares

from ..backend import is_kernel_error


class MinimizerResult:
    """The lmfit fields the fits read: params (with stderr), residual,
    chisqr, redchi, nfree, nfev, success, message."""

    def __init__(self, params, residual=None, success=True, nfev=0,
                 message="", nextra_vary=0):
        self.params = params
        self.residual = residual
        self.success = success
        self.nfev = nfev
        self.message = message
        if residual is not None:
            self.chisqr = float(np.sum(np.square(residual)))
            # nextra_vary counts sampled parameters outside ``params``
            # (the __lnsigma noise term), so redchi has lmfit's dof
            nvary = len(params.varying_names()) + nextra_vary
            self.nfree = max(len(np.ravel(residual)) - nvary, 1)
            self.redchi = self.chisqr / self.nfree
        self.flatchain = None

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


def _attach_chain_covar(result, flat, params):
    """The chain's covariance over the model parameters (any trailing
    __lnsigma column left out), so ``fit_report`` prints correlations
    for a sampled fit too, as lmfit's emcee result does."""
    nmodel = len(params.varying_names())
    if nmodel > 1 and flat.shape[0] > 1:
        result.covar = np.cov(flat[:, :nmodel], rowvar=False)


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


def _log_prob(model, params, args, x, lo, hi, is_weighted=True):
    """lmfit ``Minimizer.emcee`` likelihood: with ``is_weighted`` the
    residuals are pre-scaled by 1/σ and lnL = −½Σr²; otherwise the last
    element of ``x`` is the ``__lnsigma`` noise parameter. A model that
    raises scores −inf, unless it is a kernel error or a device fault
    (``backend.is_kernel_error``), which propagates."""
    if np.any(x < lo) or np.any(x > hi):
        return -np.inf
    if not is_weighted:
        x, lnsigma = x[:-1], x[-1]
    try:
        r = _residual_vector(model, params.with_values(x), args)
    except Exception as exc:
        if is_kernel_error(exc):
            raise
        return -np.inf
    if not np.all(np.isfinite(r)):
        return -np.inf
    if is_weighted:
        return -0.5 * float(np.sum(r * r))
    s2 = np.exp(2.0 * lnsigma)
    return -0.5 * float(np.sum(r * r / s2 + np.log(2 * np.pi * s2)))


def initial_walkers(rng, params, nwalkers, pos=None, is_weighted=True):
    """``(pos, names, lo, hi)`` of the samplers: the varying parameters
    (and ``__lnsigma`` when not ``is_weighted``) with their bounds, and
    the walkers, scattered around the start by 1% of a finite range (else
    1e-4 of the value) from ``rng``, or ``pos`` with a ``__lnsigma``
    column appended when it lacks one."""
    names = params.varying_names()
    lo, hi = params.varying_bounds()
    x0 = params.varying_values()
    if not is_weighted:
        names = names + ["__lnsigma"]
        lo = np.append(lo, -np.inf)
        hi = np.append(hi, np.inf)
        x0 = np.append(x0, np.log(0.1))
    ndim = len(names)
    if pos is None:
        scale = np.where(np.isfinite(hi - lo), (hi - lo) * 1e-2,
                         1e-4 * np.maximum(np.abs(x0), 1.0))
        pos = x0 + scale * rng.standard_normal((nwalkers, ndim))
        pos = np.clip(pos, lo, hi)
    else:
        pos = np.array(pos, dtype=float)
        if not is_weighted and pos.shape[1] == ndim - 1:
            lns = np.log(0.1) + 1e-4 * rng.standard_normal((pos.shape[0],
                                                            1))
            pos = np.concatenate([pos, lns], axis=1)
        if pos.shape[1] != ndim:
            raise ValueError(f"pos has {pos.shape[1]} columns, expected "
                             f"{ndim} ({names})")
    return pos, names, lo, hi


def chain_result(model, params, args, flat, names, nfev, is_weighted):
    """The samplers' result: each parameter's median and std over the
    flat chain ``flat[N, ndim]``, the residual there, ``flatchain``,
    ``var_names`` and the chain's covariance."""
    for i, name in enumerate(names):
        if name == "__lnsigma":
            continue
        params[name].value = float(np.median(flat[:, i]))
        params[name].stderr = float(np.std(flat[:, i]))
    res = _residual_vector(model, params, args)
    result = MinimizerResult(params, residual=res, nfev=nfev,
                             nextra_vary=0 if is_weighted else 1)
    result.flatchain = flat
    result.var_names = list(names)
    _attach_chain_covar(result, flat, params)
    return result


def sample_emcee(model, params, args=(), nwalkers=100, steps=1000,
                 burn=0.2, thin=10, pos=None, seed=0, progress=False,
                 is_weighted=True):
    """Affine-invariant ensemble sampler (stretch move, a = 2), numpy on
    the host: the JAX package's recipe step for step, so one ``seed``
    gives its chain bit for bit. Returns a :class:`MinimizerResult`
    with ``flatchain`` and median/std estimates, like lmfit's
    ``Minimizer.emcee``."""
    rng = np.random.default_rng(None if seed is None else seed)
    params = params.copy()
    pos, names, lo, hi = initial_walkers(rng, params, nwalkers, pos,
                                         is_weighted)
    nwalkers, ndim = pos.shape

    def logps(ps):
        return np.array([_log_prob(model, params, args, p, lo, hi,
                                   is_weighted=is_weighted) for p in ps])

    logp = logps(pos)
    nburn = int(burn * steps) if burn < 1 else int(burn)
    chain = []
    a = 2.0
    half = nwalkers // 2
    for step in range(steps):
        for first in (True, False):
            idx = np.arange(0, half) if first else np.arange(half, nwalkers)
            other = np.arange(half, nwalkers) if first else np.arange(0, half)
            z = ((a - 1.0) * rng.random(len(idx)) + 1) ** 2 / a
            partners = rng.choice(other, size=len(idx))
            prop = pos[partners] + z[:, None] * (pos[idx] - pos[partners])
            logp_prop = logps(prop)
            log_accept = (ndim - 1) * np.log(z) + logp_prop - logp[idx]
            accept = np.log(rng.random(len(idx))) < log_accept
            pos[idx[accept]] = prop[accept]
            logp[idx[accept]] = logp_prop[accept]
        if step >= nburn and step % thin == 0:
            chain.append(pos.copy())
        if progress and steps >= 10 and step % (steps // 10) == 0:
            print(f"  emcee step {step}/{steps}")

    flat = (np.array(chain).reshape(-1, ndim) if chain
            else pos.reshape(-1, ndim))
    return chain_result(model, params, args, flat, names, nwalkers * steps,
                        is_weighted)


def fitter(model, params, args, mcmc=False, pos=None, nwalkers=100,
           steps=1000, burn=0.2, progress=True, workers=1,
           nan_policy="raise", max_nfev=None, thin=10, is_weighted=True,
           seed=0, device=None):
    """The reference ``fitter`` signature: least squares by
    :func:`minimize_leastsq`, or with ``mcmc=True`` the ensemble sampler
    on ``device`` (``None``: the card; :func:`~.ensemble.sample_emcee_jax`
    over the B = 1 lane of the batched engine). ``workers`` is kept for
    the signature: the walkers run as one batch. There is no host
    fall-back: an error of the model or of the device propagates."""
    if mcmc:
        from .ensemble import sample_emcee_jax

        return sample_emcee_jax(model, params, args, nwalkers=nwalkers,
                                steps=steps, burn=burn, thin=thin, pos=pos,
                                progress=progress, seed=seed,
                                is_weighted=is_weighted, device=device)
    return minimize_leastsq(model, params, args, max_nfev=max_nfev,
                            nan_policy=nan_policy)
