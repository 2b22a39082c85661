"""Batched Levenberg–Marquardt over a leading lane axis.

Counterpart of ``scintools_tpu/fit/lm_jax.py``: ``make_lm_solver``
(:28-77, a fixed iteration budget), ``make_lm_fit_fn`` (:80-195, the
early-exit fit with health flag, covariance, final residual and
iteration count) and ``lm_covariance`` (:198-210).

``residual_fn(x, *args)`` is written for ONE fit (``x`` of shape (P,));
the built functions take ``x0`` of shape (L, P) and ``args`` with the
same leading lane axis, and return per-lane tensors. The Jacobian is
forward mode, ``torch.func.vmap`` over lanes of ``torch.func.jacfwd``
(the JAX package's ``jacfwd``, or ``linearize`` plus a ``vmap`` of
``jvp``). The early-exit loop runs over all lanes with a per-lane
``done`` mask: a finished lane's ``x``, ``λ``, cost, residual, health and
iteration count stay frozen, and the loop ends when every lane is done,
which is what the JAX package's ``vmap`` of a ``while_loop`` computes
(every lane runs until the slowest exits, finished lanes unchanged). No
operation mixes lanes, so a lane's bits do not depend on its
neighbours'.

Two differences from ``jax.numpy`` are handled here:
``torch.linalg.solve`` raises on a singular matrix, so the damped step
comes from ``solve_ex`` and a lane whose factorisation failed gets a NaN
step (what ``jnp.linalg.solve`` returns there); and ``pinv`` takes the
JAX default cut, 10·max(m, n)·eps of the largest singular value, with a
non-finite matrix giving a NaN covariance instead of an SVD error.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap


def _solve(A, b):
    """``A⁻¹b`` per lane; a lane whose LU factorisation fails is NaN."""
    x, info = torch.linalg.solve_ex(A, b.unsqueeze(-1))
    x = x.squeeze(-1)
    return torch.where((info == 0)[..., None], x,
                       torch.full_like(x, float("nan")))


def _pinv(H):
    """``jnp.linalg.pinv`` per lane: singular values ≤ 10·max(m, n)·eps
    of the largest are dropped; a non-finite lane gives NaN."""
    finite = torch.isfinite(H).flatten(-2).all(-1)[..., None, None]
    rtol = 10.0 * max(H.shape[-2:]) * torch.finfo(H.dtype).eps
    inv = torch.linalg.pinv(torch.where(finite, H, torch.zeros_like(H)),
                            rtol=rtol)
    return torch.where(finite, inv, torch.full_like(inv, float("nan")))


def _as_float(x0):
    x0 = torch.as_tensor(x0)
    return x0 if x0.is_floating_point() else x0.to(torch.float64)


def _bounds(bounds, like):
    if bounds is None:
        return None, None
    return tuple(torch.as_tensor(np.asarray(b, dtype=float), dtype=like.dtype,
                                 device=like.device) for b in bounds)


def _normal_equations(J, r, lam, eps):
    """The damped Gauss–Newton step −(JᵀJ + λ·diag(JᵀJ + eps))⁻¹Jᵀr."""
    g = (J.mT @ r[..., None]).squeeze(-1)
    H = J.mT @ J
    damp = lam[:, None] * (torch.diagonal(H, dim1=-2, dim2=-1) + eps)
    return _solve(H + torch.diag_embed(damp), -g)


def _with_residual(residual_fn):
    """``f(x, *args) → (r, r)``, so ``jacfwd(·, has_aux=True)`` gives the
    Jacobian and the residual in one pass."""
    def f(x, *args):
        r = residual_fn(x, *args)
        return r, r
    return f


def make_lm_solver(residual_fn, n_iter=40, lam0=1e-3, lam_up=4.0,
                   lam_down=0.5, lam_min=1e-9, lam_max=1e9, bounds=None,
                   eps=1e-12):
    """Build ``solver(x0[L, P], *args) → (x[L, P], cost[L])`` minimising
    ``0.5·Σ residual_fn(x, *args)²`` per lane by damped Gauss–Newton
    steps over a fixed budget of ``n_iter`` iterations: an accepted step
    shrinks λ, a rejected one grows it and keeps the old iterate;
    ``bounds=(lo, hi)`` clips each iterate (projected LM)."""
    res_l = vmap(residual_fn)
    jac_l = vmap(jacfwd(_with_residual(residual_fn), has_aux=True))

    def cost_of(x, args):
        r = res_l(x, *args)
        return 0.5 * (r * r).sum(-1)

    def solver(x0, *args):
        x = _as_float(x0)
        lo, hi = _bounds(bounds, x)
        lam = torch.full(x.shape[:1], lam0, dtype=x.dtype, device=x.device)
        cost = cost_of(x, args)
        for _ in range(n_iter):
            J, r = jac_l(x, *args)
            x_new = x + _normal_equations(J, r, lam, eps)
            if lo is not None:
                x_new = torch.clamp(x_new, lo, hi)
            cost_new = cost_of(x_new, args)
            ok = torch.isfinite(cost_new) & (cost_new < cost)
            x = torch.where(ok[:, None], x_new, x)
            cost = torch.where(ok, cost_new, cost)
            lam = torch.clamp(torch.where(ok, lam * lam_down, lam * lam_up),
                              lam_min, lam_max)
        return x, cost

    return solver


def make_lm_fit_fn(residual_fn, n_iter=40, lam0=1e-3, lam_up=4.0,
                   lam_down=0.5, lam_min=1e-9, lam_max=1e9, bounds=None,
                   eps=1e-12, jac_fn=None, with_cov=True, xtol=1e-6):
    """Build the survey fit ``fit(x0[L, P], *args) → dict`` with per-lane
    ``x, cost, ok, residual, niter`` and, ``with_cov``, ``cov`` (the
    Gauss–Newton covariance at the solution, :func:`lm_covariance`'s).

    The accepted step's residual is carried, not re-evaluated;
    ``jac_fn(x, r, *args) → J[M, P]`` (one lane) may replace the
    forward-mode Jacobian. ``ok`` is False where a damped step was ever
    non-finite or the final cost or iterate is non-finite. A lane stops
    after ``n_iter`` iterations, when its proposed step is below ``xtol``
    relative (accepted or not; ``xtol=0`` turns this off), or when a trial
    is rejected with λ already at ``lam_max`` (every later iteration
    would repeat it)."""
    if jac_fn is None:
        def jac_fn(x, r, *args):
            return jacfwd(residual_fn)(x, *args)
    res_l = vmap(residual_fn)
    jac_l = vmap(jac_fn)

    def fit(x0, *args):
        x = _as_float(x0)
        lo, hi = _bounds(bounds, x)
        L = x.shape[0]
        dev = x.device
        r = res_l(x, *args)
        cost = 0.5 * (r * r).sum(-1)
        lam = torch.full((L,), lam0, dtype=x.dtype, device=dev)
        bad = torch.zeros(L, dtype=torch.bool, device=dev)
        done = torch.zeros(L, dtype=torch.bool, device=dev)
        it = torch.zeros(L, dtype=torch.int32, device=dev)
        while True:
            active = (it < n_iter) & ~done
            if not bool(active.any()):
                break
            J = jac_l(x, r, *args)
            delta = _normal_equations(J, r, lam, eps)
            step_bad = ~torch.isfinite(delta).all(-1)
            x_new = x + delta
            if lo is not None:
                x_new = torch.clamp(x_new, lo, hi)
            r_new = res_l(x_new, *args)
            cost_new = 0.5 * (r_new * r_new).sum(-1)
            ok = torch.isfinite(cost_new) & (cost_new < cost)
            stop = ~ok & (lam >= lam_max)
            if xtol:
                rel = (delta.abs() / torch.clamp(x.abs(), min=eps)).amax(-1)
                stop = stop | (torch.isfinite(rel) & (rel < xtol))
            take = active & ok
            x = torch.where(take[:, None], x_new, x)
            r = torch.where(take[:, None], r_new, r)
            cost = torch.where(take, cost_new, cost)
            lam = torch.where(active, torch.clamp(
                torch.where(ok, lam * lam_down, lam * lam_up),
                lam_min, lam_max), lam)
            bad = bad | (active & step_bad)
            done = done | (active & stop)
            it = it + active.to(torch.int32)
        ok = torch.isfinite(cost) & torch.isfinite(x).all(-1) & ~bad
        out = {"x": x, "cost": cost, "ok": ok, "residual": r, "niter": it}
        if with_cov:
            J = jac_l(x, r, *args)
            out["cov"] = _covariance(J, r, x.shape[-1])
        return out

    return fit


def _covariance(J, r, n_par):
    """(JᵀJ)⁺ · redχ² per lane."""
    nfree = max(r.shape[-1] - n_par, 1)
    redchi = (r * r).sum(-1) / nfree
    return _pinv(J.mT @ J) * redchi[:, None, None]


def lm_covariance(residual_fn, x, args=()):
    """Gauss–Newton parameter covariance at the solution per lane,
    (JᵀJ)⁻¹·redχ² (the stderr convention of ``minimize_leastsq`` and
    lmfit): ``x[L, P]``, ``args`` with the lane axis → ``cov[L, P, P]``."""
    J, r = vmap(jacfwd(_with_residual(residual_fn), has_aux=True))(x, *args)
    return _covariance(J, r, x.shape[-1])
