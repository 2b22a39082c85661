"""The acf2d fit on a torch device: the analytic-ACF model and the
Levenberg–Marquardt loop together, one epoch or a survey batch.

Counterpart of ``scintools_tpu/fit/acf2d.py``: ``SHAPE_BUCKETS``,
``bucket_crop_size``, ``_spike_zero_weights``, ``make_acf2d_fit_one``
(:96-188), ``_batch_program`` (:191), ``_epoch_config`` (:209),
``fit_acf2d_batch`` (:234-400) and the B = 1 entry ``fit_acf2d_tpu``
(:403-431), here :func:`fit_acf2d`. The residual, its forward-mode
Jacobian over the varying parameters (with the exact ``amp`` column),
the damped normal equations and the Gauss–Newton covariance all run on
the device, over a lane axis of epochs (``fit/lm.py``), with a
per-epoch ``ok`` health bitmask (``robust/guards.py``): ``BAD_INPUT``
lanes (non-finite crop or weight pixels) come back NaN, ``BAD_FIT``
marks a non-finite or singular damped step.

Nothing is rebuilt per epoch: the lag steps ``dt``/``df`` are inputs of
the built model, crops are padded to ``SHAPE_BUCKETS`` with zero-weight
borders and per-epoch rescaled lag steps that keep the original lag
positions exact, and the built fits are cached on the static
configuration (a FIFO of 16; ``obs.retrace`` counts builds at site
``fit.acf2d_batch``).

Precision: ``"default"`` runs float32/complex64 rows with the static
e-field kernel SVD-factorised and the ``xtol`` step exit;
``"highest"`` is the dense float64/complex128 oracle with only the
λ-saturation exit, which leaves its outputs those of the fixed budget.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import fifo_cached, resolve_device
from ..obs import retrace as _retrace
from ..robust import guards
from ..sim.acf_model import acf2d_grid_sizes, make_acf2d_model_core
from .fitter import MinimizerResult
from .lm import make_lm_fit_fn

MODEL_ARGS = ("tau", "dnu", "amp", "phasegrad", "psi", "wn", "alpha")

#: bucketed static crop sizes (odd): a mixed-size survey maps every crop
#: to the smallest bucket that holds it, so the number of built fits is
#: bounded by the ladder's length, not by the number of crop shapes
SHAPE_BUCKETS = (9, 17, 25, 33, 49, 65, 97, 129, 193, 257)

DEFAULT_PRECISION = "default"

#: epochs per call of a built fit: the early-exit LM runs each call
#: until its slowest lane stops, so narrow groups waste fewer
#: lane-iterations
ACF2D_GROUP_SIZE = 8

_SOLVER_CACHE = {}
_SOLVER_CACHE_SIZE = 16


def _resolve_precision(precision):
    p = DEFAULT_PRECISION if precision is None else precision
    if p not in ("default", "highest"):
        raise ValueError(f"precision must be 'default' or 'highest' "
                         f"(or None), got {precision!r}")
    return p


def _spike_zero_weights(weights, shape):
    """The white-noise spike is not fitted."""
    w = (np.ones(shape) if weights is None
         else np.array(weights, dtype=float))
    w = np.fft.fftshift(w)
    w[-1, -1] = 0
    return np.fft.ifftshift(w)


def bucket_crop_size(n):
    """Smallest shape bucket holding an odd crop size ``n``."""
    for b in SHAPE_BUCKETS:
        if b >= n:
            return b
    return n


def make_acf2d_fit_one(nt_crop, nf_crop, ar, alpha, theta, tau0, dt0, vary,
                       lo, hi, n_iter=60, precision=None, fresnel_method=None,
                       alpha_varies=False, device=None):
    """The acf2d fit over a leading epoch axis: ``fit(x0, y, w, tri,
    fixed_vec, dtdf) → dict(x, cost, ok, cov, residual, niter)`` of
    per-epoch tensors, ``ok`` the int32 health bitmask. Lanes with
    ``BAD_INPUT`` have their outputs set to NaN."""
    precision = _resolve_precision(precision)
    dev = resolve_device(device)
    model = make_acf2d_model_core(nt_crop, nf_crop, ar, alpha, theta, tau0,
                                  dt0, precision=precision,
                                  alpha_varies=alpha_varies,
                                  fresnel_method=fresnel_method or "gemm",
                                  device=dev)
    vary_idx = {n: i for i, n in enumerate(vary)}

    def values(x, fixed_vec):
        return [x[vary_idx[n]] if n in vary_idx else fixed_vec[j]
                for j, n in enumerate(MODEL_ARGS)]

    def residual(x, y, w, tri, fixed_vec, dtdf):
        v = values(x, fixed_vec)
        m = model(*v[:6], dtdf[0], dtdf[1], alpha=v[6]) * tri
        return ((y - m) * w).reshape(-1)

    # the residual is linear in amp away from the white-noise spike,
    # whose weight is always zeroed, so amp's column is exact from the
    # primal: ∂r/∂amp = −(m/amp)·w = (r − y·w)/amp, one tangent fewer;
    # the other columns come from the model's forward-mode derivative
    # along one-hot tangents of the varying parameters
    amp_i = vary_idx.get("amp")
    others = [i for i, n in enumerate(vary) if n != "amp"]
    basis = np.zeros((len(others), len(MODEL_ARGS)))
    for k, i in enumerate(others):
        basis[k, MODEL_ARGS.index(vary[i])] = 1.0

    def jac_fn(x, r, y, w, tri, fixed_vec, dtdf):
        v = values(x, fixed_vec)
        cols = [None] * len(vary)
        if others:
            tang = torch.as_tensor(basis, dtype=x.dtype, device=x.device)
            _, m_t = model.jvp(*v[:6], dtdf[0], dtdf[1], alpha=v[6],
                               tangents=tang)
            r_t = (-(m_t * tri) * w).reshape(len(others), -1)
            for k, i in enumerate(others):
                cols[i] = r_t[k]
        if amp_i is not None:
            amp = x[amp_i]
            denom = torch.where(amp == 0, torch.full_like(amp, 1e-30), amp)
            cols[amp_i] = (r - (y * w).reshape(-1)) / denom
        return torch.stack(cols, dim=1)

    # the throughput policy takes the xtol step exit (outputs move at
    # the 1e-5 level, inside its tier); the "highest" oracle keeps the
    # fixed-budget algorithm with only the output-identical λ stall exit
    lm_fit = make_lm_fit_fn(residual, n_iter=n_iter, bounds=(lo, hi),
                            jac_fn=jac_fn,
                            xtol=1e-6 if precision == "default" else 0.0)

    def fit(x0, y, w, tri, fixed_vec, dtdf):
        input_ok = (guards.chunk_finite_ok(y) & guards.chunk_finite_ok(w)
                    & guards.chunk_finite_ok(tri))
        out = lm_fit(x0, y, w, tri, fixed_vec, dtdf)
        code = guards.health_code(input_ok=input_ok, fit_ok=out["ok"])

        def quar(a):
            keep = input_ok.view((-1,) + (1,) * (a.ndim - 1))
            return torch.where(keep, a, torch.full_like(a, float("nan")))

        return {"x": quar(out["x"]), "cost": quar(out["cost"]), "ok": code,
                "cov": quar(out["cov"]), "residual": quar(out["residual"]),
                "niter": out["niter"]}

    return fit


def _batch_program(key, make_fit):
    """The built fit for ``key`` from a FIFO of 16; each miss calls
    ``make_fit`` and counts one build at site ``fit.acf2d_batch``."""
    def build():
        _retrace.record_build("fit.acf2d_batch", key)
        return make_fit()

    return fifo_cached(_SOLVER_CACHE, key, build, _SOLVER_CACHE_SIZE)


def _epoch_config(params, ydata):
    """Per-epoch fit pieces from one Parameters set and crop."""
    ydata = np.asarray(ydata, dtype=float)
    nf_crop, nt_crop = ydata.shape
    if nt_crop % 2 == 0 or nf_crop % 2 == 0:
        raise ValueError("acf2d crop must be odd-sized (the ACF is "
                         "centred on its white-noise spike)")
    p = {k: v.value for k, v in params.items()}
    dt = 2 * p["tobs"] / p["nt"]
    df = 2 * p["bw"] / p["nf"]
    vary = tuple(n for n in MODEL_ARGS if n in params and params[n].vary)
    lo = np.array([params[n].min for n in vary], dtype=float)
    hi = np.array([params[n].max for n in vary], dtype=float)
    return ydata, p, dt, df, vary, lo, hi


def fit_acf2d_batch(params, ydatas, weights=None, n_iter=60, precision=None,
                    fresnel_method=None, bucket=True, group_size=None,
                    device=None):
    """Fit a stack of epoch crops on ``device`` (``None``: the CUDA card).

    ``params`` is one Parameters set for every epoch or a sequence of
    per-epoch sets (the static configuration, meaning the vary set,
    bounds and ar/theta/alpha, must match; values may differ).
    ``ydatas`` is a ``[B, nf, nt]`` stack or a list of odd-sized crops
    (mixed sizes pad to ``SHAPE_BUCKETS`` with zero-weight borders and
    exactly rescaled lag steps, one built fit per bucket); ``weights`` a
    matching stack or list, or None. Epochs run ``group_size`` (default
    ``ACF2D_GROUP_SIZE``) to a call.

    Returns ``(results, ok)``: B :class:`~.fitter.MinimizerResult` (each
    with ``.ok``) and the int32 health bitmask array."""
    precision = _resolve_precision(precision)
    fresnel_method = fresnel_method or "gemm"
    dev = resolve_device(device)
    if getattr(ydatas, "ndim", 0) == 3:
        ydatas = [np.asarray(y) for y in ydatas]
    B = len(ydatas)
    if weights is None:
        weights = [None] * B
    params_list = [params] * B if hasattr(params, "items") else list(params)
    if len(params_list) != B or len(weights) != B:
        raise ValueError(f"got {B} crops, {len(params_list)} params, "
                         f"{len(weights)} weights")

    epochs = [_epoch_config(pr, y) for pr, y in zip(params_list, ydatas)]
    vary = epochs[0][4]
    lo, hi = epochs[0][5], epochs[0][6]
    ar = abs(epochs[0][1]["ar"])
    theta = epochs[0][1]["theta"]
    alpha_varies = "alpha" in vary
    alpha0 = epochs[0][1]["alpha"]
    for _, p_, _, _, v_, lo_, hi_ in epochs[1:]:
        if (v_ != vary or not np.array_equal(lo_, lo)
                or not np.array_equal(hi_, hi)
                or abs(p_["ar"]) != ar or p_["theta"] != theta
                or (not alpha_varies and p_["alpha"] != alpha0)):
            raise ValueError(
                "fit_acf2d_batch needs one static fit configuration "
                "(vary set, bounds, ar/theta/alpha) across the epoch "
                "batch — per-epoch VALUES may differ, statics may not")

    groups = {}
    for b, (y, *_rest) in enumerate(epochs):
        nf0, nt0 = y.shape
        shape = ((bucket_crop_size(nf0), bucket_crop_size(nt0)) if bucket
                 else (nf0, nt0))
        groups.setdefault(shape, []).append(b)

    fdtype = np.float32 if precision == "default" else np.float64
    results = [None] * B
    ok_arr = np.zeros(B, dtype=np.int32)
    for (nfb, ntb), idxs in groups.items():
        n = len(idxs)
        ys = np.zeros((n, nfb, ntb), dtype=fdtype)
        ws = np.zeros((n, nfb, ntb), dtype=fdtype)
        tris = np.zeros((n, nfb, ntb), dtype=fdtype)
        x0s = np.zeros((n, len(vary)), dtype=fdtype)
        fixed = np.zeros((n, len(MODEL_ARGS)), dtype=fdtype)
        dtdf = np.zeros((n, 2), dtype=fdtype)
        crops = []
        for g, b in enumerate(idxs):
            y, p, dt, df, _, _, _ = epochs[b]
            nf0, nt0 = y.shape
            # exact-lag rescale: the padded grid linspace(−ntb·dt_eff/τ,
            # ·, ntb) keeps the original lag step and centre, so the
            # central nf0 × nt0 cells see the same model values and the
            # zero-weight border adds nothing
            dt_eff = dt * (nt0 * (ntb - 1)) / (ntb * (nt0 - 1))
            df_eff = df * (nf0 * (nfb - 1)) / (nfb * (nf0 - 1))
            of = (nfb - nf0) // 2
            ot = (ntb - nt0) // 2
            w = _spike_zero_weights(weights[b], y.shape)
            tri_t = 1 - np.abs(np.linspace(-nt0 * dt, nt0 * dt,
                                           nt0)) / p["tobs"]
            tri_f = 1 - np.abs(np.linspace(-nf0 * df, nf0 * df,
                                           nf0)) / p["bw"]
            ys[g, of:of + nf0, ot:ot + nt0] = y
            ws[g, of:of + nf0, ot:ot + nt0] = w
            tris[g, of:of + nf0, ot:ot + nt0] = np.outer(tri_f, tri_t)
            x0s[g] = [p[n_] for n_ in vary]
            fixed[g] = [float(p.get(n_, 0.0)) for n_ in MODEL_ARGS]
            dtdf[g] = (dt_eff, df_eff)
            crops.append((of, ot, nf0, nt0))

        # the grids are sized from the group's median τ and dt (the only
        # way either enters a built fit)
        tau0 = float(np.median([abs(epochs[b][1]["tau"]) for b in idxs]))
        dt0 = float(np.median(dtdf[:, 0]))
        grid_key = acf2d_grid_sizes(ntb, dt0, ar, tau0)
        key = (ntb, nfb, ar, None if alpha_varies else alpha0, theta,
               grid_key, vary, lo.tobytes(), hi.tobytes(), n_iter,
               precision, fresnel_method, str(dev))
        fn = _batch_program(key, lambda: make_acf2d_fit_one(
            ntb, nfb, ar, alpha0, theta, tau0, dt0, vary, lo, hi,
            n_iter=n_iter, precision=precision,
            fresnel_method=fresnel_method, alpha_varies=alpha_varies,
            device=dev))

        gs = int(ACF2D_GROUP_SIZE if group_size is None else group_size)
        outs = []
        for s in range(0, n, gs):
            sl = slice(s, min(s + gs, n))
            outs.append(fn(*(torch.as_tensor(a[sl], device=dev)
                             for a in (x0s, ys, ws, tris, fixed, dtdf))))
        out = {k: np.concatenate([o[k].cpu().numpy() for o in outs])
               for k in outs[0]}
        xs = out["x"].astype(float)
        covs = out["cov"].astype(float)
        res = out["residual"].astype(float)

        for g, b in enumerate(idxs):
            of, ot, nf0, nt0 = crops[g]
            out_params = params_list[b].copy()
            for i, n_ in enumerate(vary):
                out_params[n_].value = float(
                    abs(xs[g, i]) if n_ in ("tau", "dnu") else xs[g, i])
                out_params[n_].stderr = float(np.sqrt(np.abs(covs[g, i, i])))
            # the residual trimmed to the epoch's own cells, so chisqr
            # and redchi equal an unpadded fit's
            r2d = res[g].reshape(nfb, ntb)[of:of + nf0, ot:ot + nt0]
            result = MinimizerResult(
                out_params, residual=r2d.ravel(),
                nfev=int(out["niter"][g]),
                message=f"batched LM on {dev} (fit/acf2d.py, "
                        f"precision={precision})")
            result.ok = int(out["ok"][g])
            results[b] = result
            ok_arr[b] = out["ok"][g]
    return results, ok_arr


def fit_acf2d(params, ydata, weights, n_iter=60, precision=None,
              fresnel_method=None, device=None):
    """One acf2d fit on ``device``: the B = 1 lane of
    :func:`fit_acf2d_batch` (the counterpart of the JAX package's
    ``fit_acf2d_tpu``), so a single fit and a survey share one cache.
    ``params`` carries the reference's parameter set (tau, dnu, amp,
    phasegrad, psi varying as configured; ar, theta, nt, nf, tobs, bw
    fixed; alpha fixed or varying). Returns a
    :class:`~.fitter.MinimizerResult` with lmfit-convention stderr and
    the ``.ok`` health code."""
    results, _ = fit_acf2d_batch(params, [np.asarray(ydata)], [weights],
                                 n_iter=n_iter, precision=precision,
                                 fresnel_method=fresnel_method, device=device)
    return results[0]


#: the JAX package's name of the single-fit entry
#: (``scintools_tpu/fit/acf2d.py``); the port calls it ``fit_acf2d``.
fit_acf2d_tpu = fit_acf2d
