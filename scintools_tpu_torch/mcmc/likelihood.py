"""Log-likelihood kernels and uniform-box priors of the batched ensemble
sampler, on a torch device.

Counterpart of ``scintools_tpu/mcmc/likelihood.py``: ``_hashable`` and
``_leaf_sig`` (:52-70), :func:`make_model_loglike` (:73), the survey
kernels :func:`make_acf1d_loglike` (:136), :func:`make_acf2d_loglike`
(:193), :func:`make_eta_profile_loglike` (:232), the named velocity
models :func:`velocity_model_loglike` (:277) and :func:`model_data_key`
(:295).

Every kernel is built as ``build(device) → loglike(x, data)``: ``x[B, n,
ndim]`` holds ``n`` walkers of each of ``B`` lanes, every leaf of
``data`` carries the lane axis ``B`` first, and the result is ``[B,
n]``. The JAX package writes each kernel for one walker of one lane and
``vmap``s it twice; here the closed-form kernels (acf1d, η profile) do
their arithmetic batched by broadcasting, and ``torch.func.vmap`` serves
only what broadcasting cannot (a residual model written for one
parameter set, the analytic 2-D ACF). A lane's sums are pairwise sums of
fixed order (:func:`lane_sum`), so a lane's value does not depend on the
batch around it.

Priors are uniform boxes from the bounds (``lo``/``hi``), which the
sampler enforces (out of bounds → log-probability −inf).
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def _hashable(v):
    """Cache-key form of a fixed-parameter value."""
    if isinstance(v, (str, bytes, int, float, bool, type(None))):
        return v
    arr = np.asarray(v)
    return (str(arr.dtype), arr.shape, arr.tobytes())


def tree_flatten(tree):
    """``(leaves, rebuild)`` of a nest of tuples, lists and dicts: the
    array leaves in order, and ``rebuild(leaves)`` putting a list of the
    same length back into the nest. None, strings and devices are not
    leaves: they stay in place."""
    leaves = []

    def walk(t):
        if isinstance(t, (tuple, list)):
            parts = [walk(v) for v in t]
            return lambda it: type(t)(p(it) for p in parts)
        if isinstance(t, dict):
            parts = {k: walk(v) for k, v in t.items()}
            return lambda it: {k: p(it) for k, p in parts.items()}
        if t is None or isinstance(t, (str, torch.device)):
            return lambda it: t
        leaves.append(t)
        return lambda it: next(it)

    build = walk(tree)
    return leaves, lambda new: build(iter(new))


def tree_map(fn, tree):
    """``fn`` over every non-None leaf of the nest ``tree``."""
    leaves, rebuild = tree_flatten(tree)
    return rebuild([fn(v) for v in leaves])


def _leaf_sig(tree):
    """Hashable (structure, leaf shape/dtype) signature of a data nest:
    the part of a built sampler's identity the data contributes."""
    leaves, _ = tree_flatten(tree)
    sig = tuple((tuple(np.shape(v)), str(getattr(v, "dtype", type(v))))
                for v in leaves)
    return (repr(tree_map(lambda v: 0, tree)), sig)


def lane_sum(v):
    """Sum over the last axis in a fixed pairwise order (zero-padded to a
    power of two, then halved by elementwise adds): the same bits for a
    lane whatever the batch shape, where a library reduction may split
    its sum by the number of outputs."""
    n = v.shape[-1]
    m = 1 << max(n - 1, 0).bit_length()
    if m != n:
        v = torch.nn.functional.pad(v, (0, m - n))
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _noise_loglike(r, x, is_weighted):
    """lmfit ``Minimizer.emcee`` noise semantics over residuals
    ``r[..., L]``: −½Σr² pre-weighted, else −½Σ(r²/s² + ln 2πs²) with
    ``ln s = x[..., -1]``."""
    if is_weighted:
        return -0.5 * lane_sum(r * r)
    s2 = torch.exp(2.0 * x[..., -1:])
    return -0.5 * lane_sum(r * r / s2 + torch.log(2 * np.pi * s2))


def vmap_walkers(single, n_leaves):
    """``single(x[ndim], *leaves) → scalar`` lifted to ``(x[B, n, ndim],
    *leaves[B, ...]) → [B, n]``: ``torch.func.vmap`` over the lanes and
    then the walkers, for kernels that broadcasting cannot batch."""
    inner = torch.func.vmap(single, in_dims=(0,) + (None,) * n_leaves)
    return torch.func.vmap(inner, in_dims=(0,) * (1 + n_leaves))


def make_model_loglike(model, params, is_weighted=True):
    """Any residual model ``model(valuesdict, *args)`` of ``fit/models.py``
    as a sampler kernel.

    Returns ``(build, names, lo, hi, key_base)``: ``build(device)`` makes
    ``loglike(x, data)`` with ``data`` the model's ``args`` (lane axis
    added by the caller); ``names``/``lo``/``hi`` the sampled vector (with
    ``__lnsigma`` appended when not ``is_weighted``); ``key_base`` the
    hashable identity (model, names, fixed values, weighting), to which
    :func:`model_data_key` adds the data's signature.

    The model runs under ``torch.func.vmap`` over lanes and walkers, one
    parameter set at a time, so it must be written for tensors
    (``fit/models.py`` dispatches by type); the analytic 2-D ACF
    (``scint_acf_model_2d``, which builds a host ``ACF`` per call) runs
    on the built static-grid model instead (:func:`_acf2d_model_build`).
    """
    from ..fit import models as _models

    params = params.copy()
    names = list(params.varying_names())
    lo, hi = params.varying_bounds()
    fixed = {k: v.value for k, v in params.items() if not v.vary}
    n_model = len(names)

    if not is_weighted:
        names = names + ["__lnsigma"]
        lo = np.append(lo, -np.inf)
        hi = np.append(hi, np.inf)

    if model is _models.scint_acf_model_2d:
        build = _acf2d_model_build(params, n_model, is_weighted)
    else:
        def build(device):
            def loglike(x, data):
                leaves, rebuild = tree_flatten(data)

                def single(xw, *lv):
                    pd = dict(fixed)
                    for i, name in enumerate(names[:n_model]):
                        pd[name] = xw[i]
                    r = torch.ravel(model(pd, *rebuild(list(lv))))
                    return _noise_loglike(r, xw, is_weighted)

                return vmap_walkers(single, len(leaves))(x, *leaves)

            return loglike

    key_base = ("model", getattr(model, "__module__", ""),
                getattr(model, "__qualname__", repr(model)),
                tuple(names),
                tuple(sorted((k, _hashable(v)) for k, v in fixed.items())),
                bool(is_weighted))
    return build, names, np.asarray(lo, float), np.asarray(hi, float), \
        key_base


def _acf2d_model_build(params, n_model, is_weighted):
    """The kernel of ``scint_acf_model_2d`` with ``data = (ydata,
    weights)``: the static-grid analytic ACF of ``sim/acf_model.py``
    (the batched acf2d fit's model, grids sized from the start τ) times
    the lag triangles, the white-noise spike unweighted. ``ar`` and
    ``theta`` size the grids and must be fixed; ``alpha`` may vary."""
    from ..fit.acf2d import MODEL_ARGS
    from ..fit.models import _spike_weights
    from ..sim.acf_model import make_acf2d_model_core

    p = params.valuesdict()
    varying = params.varying_names()
    for name in ("ar", "theta", "tobs", "bw", "nt", "nf"):
        if name in varying:
            raise ValueError(f"the sampled acf2d model needs {name!r} "
                             "fixed: it sizes the model's static grids")
    dt, df = 2 * p["tobs"] / p["nt"], 2 * p["bw"] / p["nf"]
    alpha_varies = "alpha" in varying

    def build(device):
        cores = {}

        def loglike(x, data):
            y, w = data[:2]
            nf_crop, nt_crop = y.shape[-2:]
            key = (nf_crop, nt_crop)
            if key not in cores:
                tri_t = 1 - np.abs(np.linspace(-nt_crop * dt, nt_crop * dt,
                                               nt_crop)) / p["tobs"]
                tri_f = 1 - np.abs(np.linspace(-nf_crop * df, nf_crop * df,
                                               nf_crop)) / p["bw"]
                cores[key] = (make_acf2d_model_core(
                    nt_crop, nf_crop, abs(p["ar"]), p["alpha"], p["theta"],
                    abs(p["tau"]), dt, alpha_varies=alpha_varies,
                    device=device),
                    torch.as_tensor(np.outer(tri_f, tri_t), device=device))
            core, tri = cores[key]

            def single(xw, yl, wl):
                v = dict(p)
                for i, name in enumerate(varying):
                    v[name] = xw[i]
                m = core(*(v.get(n, 0.0) for n in MODEL_ARGS[:6]), dt, df,
                         alpha=v["alpha"]) * tri
                r = ((yl - m) * _spike_weights(wl, yl.shape)).reshape(-1)
                return _noise_loglike(r, xw, is_weighted)

            return vmap_walkers(single, 2)(x, y, w)

        return loglike

    return build


def make_acf1d_loglike(nt, nf, dt, df, alpha=5 / 3, is_weighted=False):
    """The survey acf1d kernel: the joint (time, frequency) one-sided
    ACF-cut likelihood (``fit/models.py:scint_acf_model``) over ``x =
    (tau, dnu, amp[, __lnsigma])`` with ``data = (tcut[nt], fcut[nf],
    wt[nt], wf[nf])`` (Bartlett weights as data), batched by
    broadcasting. ``is_weighted=False`` (the default) samples the noise
    scale ``__lnsigma``, which lets the posterior width absorb the
    scatter the Bartlett formula underestimates on simulated epochs.

    Returns ``(build, names, lo, hi, key)``."""
    from ..fit.models import dnu_acf_model_values, tau_acf_model_values

    names = ["tau", "dnu", "amp"]
    lo = np.array([1e-3 * dt, 1e-3 * df, 1e-8])
    hi = np.array([np.inf, np.inf, np.inf])
    if not is_weighted:
        names = names + ["__lnsigma"]
        lo = np.append(lo, -np.inf)
        hi = np.append(hi, np.inf)

    def build(device):
        tl = float(dt) * torch.arange(int(nt), dtype=F64, device=device)
        fl = float(df) * torch.arange(int(nf), dtype=F64, device=device)

        def lag0_zeroed(w):
            return torch.cat([torch.zeros_like(w[..., :1]), w[..., 1:]], -1)

        def loglike(x, data):
            yt, yf, wt, wf = data
            p = {"tau": x[..., 0:1], "dnu": x[..., 1:2],
                 "amp": x[..., 2:3], "alpha": alpha}
            rt = ((yt[:, None] - tau_acf_model_values(p, tl))
                  * lag0_zeroed(wt)[:, None])
            rf = ((yf[:, None] - dnu_acf_model_values(p, fl))
                  * lag0_zeroed(wf)[:, None])
            return _noise_loglike(torch.cat((rt, rf), -1), x, is_weighted)

        return loglike

    key = ("acf1d", int(nt), int(nf), float(dt), float(df), float(alpha),
           bool(is_weighted))
    return build, names, lo, hi, key


def make_acf2d_loglike(nt_crop, nf_crop, ar, alpha, theta, tau0, dt0,
                       precision="default"):
    """The analytic-ACF surface (``sim/acf_model.py:make_acf2d_model_core``)
    as a 2-D image likelihood over ``x = (tau, dnu, amp, phasegrad, psi,
    wn)`` with ``data = (ydata[nf_crop, nt_crop], weights[nf_crop,
    nt_crop], dt, df)``: the lag steps ride as data, so one built kernel
    serves a mixed-geometry survey.

    Returns ``(build, names, lo, hi, key)``."""
    from ..sim.acf_model import make_acf2d_model_core

    names = ["tau", "dnu", "amp", "phasegrad", "psi", "wn"]
    lo = np.array([1e-6, 1e-6, 1e-8, -10.0, -180.0, 0.0])
    hi = np.array([np.inf, np.inf, np.inf, 10.0, 180.0, np.inf])

    def build(device):
        core = make_acf2d_model_core(
            int(nt_crop), int(nf_crop), float(ar), float(alpha),
            float(theta), float(tau0), float(dt0), precision=precision,
            device=device)

        def single(xw, y, w, dt, df):
            m = core(xw[0], xw[1], xw[2], xw[3], xw[4], xw[5], dt, df)
            r = ((y - m) * w).reshape(-1)
            return -0.5 * lane_sum(r * r)

        def loglike(x, data):
            return vmap_walkers(single, 4)(x, *data)

        return loglike

    key = ("acf2d", int(nt_crop), int(nf_crop), float(ar), float(alpha),
           float(theta), float(tau0), float(dt0), str(precision))
    return build, names, lo, hi, key


def interp_lanes(x, xp, fp):
    """``jnp.interp`` per lane: ``x[B, n]`` on each lane's ascending grid
    ``xp[B, H]`` with values ``fp[B, H]``, in the promoted dtype of ``x``
    and ``xp`` (a cell's rise ``fp[i] − fp[i−1]`` in ``fp``'s, as JAX
    does). A point on the last node is a lerp of the last cell; points
    outside the grid take the edge values."""
    dt = torch.promote_types(x.dtype, xp.dtype)
    x, xp = x.to(dt).contiguous(), xp.to(dt).contiguous()
    H = xp.shape[-1]
    i = torch.searchsorted(xp, x, right=True).clamp(1, H - 1)
    x0, x1 = torch.gather(xp, 1, i - 1), torch.gather(xp, 1, i)
    f0, f1 = torch.gather(fp, 1, i - 1), torch.gather(fp, 1, i)
    dx = x1 - x0
    eps = float(np.spacing(np.finfo(
        np.float32 if dt == torch.float32 else np.float64).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, f0.to(dt),
                    f0 + ((x - x0) / torch.where(dx0, torch.ones_like(dx),
                                                 dx)) * (f1 - f0))
    f = torch.where(x < xp[:, :1], fp[:, :1].to(dt), f)
    return torch.where(x > xp[:, -1:], fp[:, -1:].to(dt), f)


def make_eta_profile_loglike(nprof):
    """Arc-curvature kernel: the reference's Gaussian peak-probability of
    the folded, arc-normalised Doppler profile over ``x = (eta,)``, with
    ``data = (profile[nprof], eta_row[nprof], pmax, noise)`` (the lane's
    ascending η grid, its in-window maximum and the spectrum's noise):
    ``loglike(η) = −½·((P(η) − Pmax)/noise)²``, P interpolated on the
    lane's grid and clamped to its edge values outside it.

    Returns ``(build, names, lo, hi, key)``; per-lane bounds come with
    the walker init and the profile crop."""
    names = ["eta"]
    lo = np.array([0.0])
    hi = np.array([np.inf])

    def build(device):
        def loglike(x, data):
            profile, eta_row, pmax, noise = data
            p = interp_lanes(x[..., 0], eta_row, profile)
            return -0.5 * ((p - pmax[:, None]) / noise[:, None]) ** 2

        return loglike

    key = ("eta_profile", int(nprof))
    return build, names, lo, hi, key


#: the velocity and orbit models exposed by name: arc curvature against
#: MJD through the Kepler solve, and the thin-screen scintillation
#: velocity of Rickett et al. 2014
VELOCITY_MODELS = ("arc_curvature", "veff_thin_screen")


def velocity_model_loglike(model_name, params, is_weighted=True):
    """:func:`make_model_loglike` over ``fit.models.arc_curvature`` or
    ``fit.models.veff_thin_screen`` with ``data = (ydata, weights,
    true_anomaly, vearth_ra, vearth_dec, mjd)``."""
    from ..fit import models as _models

    if model_name not in VELOCITY_MODELS:
        raise ValueError(f"model_name must be one of {VELOCITY_MODELS}, "
                         f"got {model_name!r}")
    return make_model_loglike(getattr(_models, model_name), params,
                              is_weighted=is_weighted)


def model_data_key(key_base, data):
    """The full identity of a :func:`make_model_loglike` kernel: its
    ``key_base`` and the data nest's structure, shapes and dtypes."""
    return key_base + (_leaf_sig(data),)
