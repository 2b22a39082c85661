"""Batched scintillation-parameter fits: many epochs, one device program.

Counterpart of ``scintools_tpu/fit/batch.py``: ``acf_cuts_batch``
(:26), ``bartlett_weights`` (:45), ``initial_guesses_batch`` (:62),
``make_acf1d_fit_one`` (:90), ``make_acf1d_batch`` (:155, with its
per-configuration cache), ``scint_params_acf2d_batch`` (:184),
``scint_params_batch`` (:216) and ``make_scint_params_serve`` (:255).
The epoch axis is the lane axis of the batched Levenberg–Marquardt
(``fit/lm.py``): ACF → one-sided cuts → Bartlett weights → initial
guesses → log-parameter LM → covariance, all on the device, with no
host round trip between them. Cuts are the full one-sided ACF cuts, so
one built function serves every epoch of a survey.

As in the JAX package under 64-bit mode, the cuts are float32 and the
fit iterates in float64 (three parameters per lane cost nothing).
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import fifo_cached, resolve_device
from ..obs import retrace as _retrace
from ..ops.acf import autocovariance
from ..robust import guards
from .lm import lm_covariance, make_lm_solver
from .models import scint_acf_model

F64 = torch.float64

# built 1-D fitters and serve programs, keyed on the static
# configuration and the device (FIFO of 16 each); every miss counts one
# build at its ``obs.retrace`` site
_ACF1D_CACHE = {}
_SERVE_CACHE = {}
_CACHE_SIZE = 16


def acf_cuts_batch(dyns, device=None):
    """One-sided central cuts of each epoch's ACF: ``dyns[B, nf, nt]``
    (numpy or tensor) → float32 tensors ``(tcuts[B, nt], fcuts[B, nf])``
    on ``device``, the ``acf[nf2//2, nt2//2:]`` and ``acf[nf2//2:,
    nt2//2]`` cuts of the 2N-padded, peak-normalised autocovariance.
    Lag 0 (value 1) is included; the models zero its weight."""
    acf = autocovariance(dyns, device=device)         # (B, 2nf, 2nt)
    nf2, nt2 = acf.shape[-2:]
    return acf[..., nf2 // 2, nt2 // 2:], acf[..., nf2 // 2:, nt2 // 2]


def bartlett_weights(cuts, n):
    """Bartlett-formula ACF sample-error weights over the last axis of
    ``cuts[..., nlag]`` (float64): the variance of lag k grows with the
    power in the earlier lags; lag 0 gets a tiny error (its weight is
    zeroed by the model anyway)."""
    nlag = cuts.shape[-1]
    var = torch.ones(cuts.shape, dtype=F64, device=cuts.device) / (n / 2)
    if nlag > 2:
        grow = 1 + 2 * torch.cumsum(cuts[..., 1:-1] ** 2, dim=-1)
        var = torch.cat([torch.full(cuts.shape[:-1] + (1,), 1e-10, dtype=F64,
                                    device=cuts.device),
                         var[..., 1:2], var[..., 2:] * grow], dim=-1)
    return 1.0 / torch.sqrt(var)


def initial_guesses_batch(tcuts, fcuts, dt, df, tobs, bw):
    """The reference's initial guesses per epoch:

    wn   = min(yf[0]−yf[1], yt[0]−yt[1])
    amp  = max(yf[0]−wn, yt[0]−wn)
    tau  = first time lag with yt < amp/e (else dt or tobs)
    dnu  = first frequency lag with yf < amp/2 (else df or bw)

    ``tau`` and ``dnu`` come back in float64, ``amp`` and ``wn`` in the
    cuts' dtype."""
    yt, yf = tcuts, fcuts
    dev = yt.device
    xt = dt * torch.arange(yt.shape[-1], dtype=F64, device=dev)
    xf = df * torch.arange(yf.shape[-1], dtype=F64, device=dev)
    wn = torch.minimum(yf[..., 0] - yf[..., 1], yt[..., 0] - yt[..., 1])
    amp = torch.maximum(yf[..., 0] - wn, yt[..., 0] - wn)

    def first_lag(below, lags, one_lag, whole, y1):
        # argmax of an integer mask: the first True, as jnp.argmax
        idx = torch.argmax(below.to(torch.int32), dim=-1)
        fallback = torch.where(y1 < 0, one_lag, whole).to(F64)
        return torch.where(below.any(-1), lags[idx], fallback)

    tau = first_lag(yt < (amp[..., None] / np.e), xt,
                    torch.tensor(dt, dtype=F64, device=dev),
                    torch.tensor(tobs, dtype=F64, device=dev), yt[..., 1])
    dnu = first_lag(yf < (amp[..., None] / 2), xf,
                    torch.tensor(df, dtype=F64, device=dev),
                    torch.tensor(bw, dtype=F64, device=dev), yf[..., 1])
    return tau, dnu, amp, wn


def make_acf1d_fit_one(nt, nf, dt, df, alpha=5 / 3, n_iter=100,
                       bartlett=True, weighted=True, device=None):
    """The acf1d fit over a leading epoch axis, ``fit(yt[B, nt],
    yf[B, nf]) → dict`` of per-epoch tensors ``tau, dnu, amp, tauerr,
    dnuerr, amperr, chisqr, redchi`` (the lmfit result's conventions).

    The LM solves in log-parameter space (positivity by construction,
    scale-free steps) over ``n_iter`` fixed iterations; the covariance is
    taken on the linear residual at the solution, so stderr keeps the
    lmfit convention."""
    dev = resolve_device(device)
    tlags = dt * torch.arange(nt, dtype=F64, device=dev)
    flags = df * torch.arange(nf, dtype=F64, device=dev)
    tobs, bw = nt * dt, nf * df

    def residual(x, yt, yf, wt, wf):
        p = {"tau": x[0], "dnu": x[1], "amp": x[2], "alpha": alpha}
        return scint_acf_model(p, (tlags, flags), (yt, yf), (wt, wf))

    def residual_log(z, yt, yf, wt, wf):
        return residual(torch.exp(z), yt, yf, wt, wf)

    lo = (1e-3 * dt, 1e-3 * df, 1e-8)
    solver = make_lm_solver(residual_log, n_iter=n_iter)

    def fit(yt, yf):
        if weighted and bartlett:
            wt = bartlett_weights(yt, nt)
            wf = bartlett_weights(yf, nf)
        elif weighted:
            wt = torch.full(yt.shape, np.sqrt(nt / 2), dtype=F64, device=dev)
            wf = torch.full(yf.shape, np.sqrt(nf / 2), dtype=F64, device=dev)
        else:
            wt = torch.ones(yt.shape, dtype=F64, device=dev)
            wf = torch.ones(yf.shape, dtype=F64, device=dev)
        tau0, dnu0, amp0, _ = initial_guesses_batch(yt, yf, dt, df, tobs, bw)
        z0 = torch.log(torch.stack([torch.clamp(v.to(F64), min=m)
                                    for v, m in zip((tau0, dnu0, amp0), lo)],
                                   dim=-1))
        z, cost = solver(z0, yt, yf, wt, wf)
        x = torch.exp(z)
        cov = lm_covariance(residual, x, args=(yt, yf, wt, wf))
        err = torch.sqrt(torch.abs(torch.diagonal(cov, dim1=-2, dim2=-1)))
        chisqr = 2.0 * cost
        nfree = (nt + nf) - 3
        return {"tau": x[:, 0], "dnu": x[:, 1], "amp": x[:, 2],
                "tauerr": err[:, 0], "dnuerr": err[:, 1],
                "amperr": err[:, 2], "chisqr": chisqr,
                "redchi": chisqr / nfree}

    return fit


def make_acf1d_batch(nt, nf, dt, df, alpha=5 / 3, n_iter=100,
                     bartlett=True, weighted=True, device=None):
    """:func:`make_acf1d_fit_one`, built once per static configuration and
    device and cached (``obs.retrace`` counts builds at site
    ``fit.acf1d_batch``),
    so a survey's repeated geometry builds nothing."""
    dev = resolve_device(device)
    key = (int(nt), int(nf), float(dt), float(df), float(alpha),
           int(n_iter), bool(bartlett), bool(weighted), str(dev))

    def build():
        _retrace.record_build("fit.acf1d_batch", key)
        return make_acf1d_fit_one(nt, nf, dt, df, alpha=alpha, n_iter=n_iter,
                                  bartlett=bartlett, weighted=weighted,
                                  device=dev)

    return fifo_cached(_ACF1D_CACHE, key, build, _CACHE_SIZE)


def scint_params_acf2d_batch(params, ydatas, weights=None, n_iter=60,
                             precision=None, device=None):
    """Dict-of-arrays view of :func:`~.acf2d.fit_acf2d_batch`, the 2-D
    companion of :func:`scint_params_batch`: per-epoch numpy arrays for
    every varying parameter with its ``<name>err``, ``chisqr``,
    ``redchi`` and the int32 ``ok`` health bitmask."""
    from .acf2d import fit_acf2d_batch

    results, ok = fit_acf2d_batch(params, ydatas, weights, n_iter=n_iter,
                                  precision=precision, device=device)
    out = {"ok": ok}
    for n in results[0].params.varying_names():
        out[n] = np.array([r.params[n].value for r in results])
        out[n + "err"] = np.array(
            [r.params[n].stderr if r.params[n].stderr is not None
             else np.nan for r in results])
    out["chisqr"] = np.array([r.chisqr for r in results])
    out["redchi"] = np.array([r.redchi for r in results])
    return out


def scint_params_batch(dyns, dt, df, alpha=5 / 3, n_iter=100, bartlett=True,
                       weighted=True, device_out=False, device=None):
    """Fit (τ_d, Δν_d, amp) on a batch of epochs ``dyns[B, nf, nt]``:
    ACF → one-sided cuts → batched LM, on ``device`` (``None``: the CUDA
    card). A stack already on the device is used in place (no host round
    trip on entry); ``device_out`` keeps the results there too, else
    they come back as a dict of numpy arrays."""
    dev = resolve_device(device)
    if isinstance(dyns, torch.Tensor):
        dyns = dyns.to(dev, torch.float32)
    else:
        dyns = torch.as_tensor(np.asarray(dyns), dtype=torch.float32,
                               device=dev)
    _, nf, nt = dyns.shape
    tcuts, fcuts = acf_cuts_batch(dyns, device=dev)
    fit = make_acf1d_batch(nt, nf, dt, df, alpha=alpha, n_iter=n_iter,
                           bartlett=bartlett, weighted=weighted, device=dev)
    out = fit(tcuts, fcuts)
    if device_out:
        return out
    return {k: v.cpu().numpy() for k, v in out.items()}


def make_scint_params_serve(B, nf, nt, dt, df, alpha=5 / 3, n_iter=100,
                            bartlett=True, weighted=True, device=None):
    """The guarded batch program ``program(dyns[B, nf, nt]) → dict`` of
    per-lane device tensors (``tau, dnu, amp, *err, chisqr, redchi``) and
    the int32 ``ok`` bitmask. A lane with a non-finite pixel gets
    ``BAD_INPUT``, is computed on zeros (so the batched ACF and LM stay
    finite) and comes back as NaN results, while every healthy lane is
    bitwise what it would be beside any other lane content: nothing in
    the program mixes lanes. Cached per static key and device
    (builds counted at site ``fit.scint_params_serve``)."""
    dev = resolve_device(device)
    key = (int(B), int(nf), int(nt), float(dt), float(df), float(alpha),
           int(n_iter), bool(bartlett), bool(weighted), str(dev))

    def build():
        _retrace.record_build("fit.scint_params_serve", key)
        fit_one = make_acf1d_fit_one(nt, nf, dt, df, alpha=alpha,
                                     n_iter=n_iter, bartlett=bartlett,
                                     weighted=weighted, device=dev)

        def program(dyns):
            dyns = torch.as_tensor(dyns, device=dev).to(torch.float32)
            if dyns.shape != (B, nf, nt):
                raise ValueError(f"program built for {(B, nf, nt)}, got "
                                 f"{tuple(dyns.shape)}")
            finite = guards.chunk_finite_ok(dyns)
            clean = torch.where(finite[:, None, None], dyns,
                                torch.zeros((), device=dev))
            tcuts, fcuts = acf_cuts_batch(clean, device=dev)
            out = fit_one(tcuts, fcuts)
            out = {k: torch.where(finite, v, torch.full_like(v, np.nan))
                   for k, v in out.items()}
            out["ok"] = guards.health_code(input_ok=finite)
            return out

        return program

    return fifo_cached(_SERVE_CACHE, key, build, _CACHE_SIZE)
