"""Sharded survey paths: the reference's pool fan-out over the mesh.

Counterpart of ``scintools_tpu/parallel/survey.py``:
``make_thth_grid_search_sharded`` (:34), ``make_fused_grid_search_sharded``
(:61), ``make_thth_thin_grid_search_sharded`` (:112) with the port's own
fused thin grid ``make_fused_thin_grid_search_sharded`` beside it,
``make_arc_profile_sharded`` (:141), ``make_arc_fit_sharded`` (:174),
``make_acf2d_fit_sharded`` (:214), ``make_retrieval_sharded`` (:253),
``make_eta_search_sharded`` (:300), ``_acf_cuts_fn`` (:323),
``make_survey_step`` (:352) and ``make_scenario_factory_sharded`` (:418).

Each wraps the port's batched function for its path: the lane axis
(epochs, chunks, η or screens) is split over every device of the mesh in
contiguous runs, in shard order (:func:`.mesh.run_lanes`), each shard
runs the function built for its device, and the results are gathered on
the mesh's first device. Where the JAX package asks the caller to pad
the batch to a device multiple, these functions take any batch: the
runs are as even as the lanes allow, and no dummy lane is computed. The
functions are built once per geometry and device and kept, so a mesh
that names one device four times builds once. Every kernel of a path
launches on every shard that has lanes; nothing falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs import retrace as _retrace
from .fft import make_fft2_sharded, make_sspec_power_sharded
from .mesh import DATA_AXIS, SEQ_AXIS, per_device, run_lanes

_SHARD_FNS = {}


def _lane_fn(site, mesh, key, build):
    """The sharded function of one path: ``fn(*lane_args)`` runs
    ``build(device)`` (kept per key and device) on each shard's lanes."""
    _retrace.record_build(site, key + (mesh.key,))

    def fn(*lane_args):
        return run_lanes(mesh, lambda dev, n: per_device(
            _SHARD_FNS, (site,) + key, dev, lambda: build(dev)), lane_args)

    fn.n_devices = mesh.size
    return fn


def _geom(*arrays):
    return tuple(np.asarray(a, dtype=float).tobytes() for a in arrays)


def make_thth_grid_search_sharded(mesh, tau, fd, n_edges, iters=64,
                                  method="power"):
    """The θ-θ chunk grid over the mesh: ``fn(CS_ri[B, 2, ntau, nfd],
    edges[B, n], etas[B, neta]) → |λ|[B, neta]`` with the chunk axis
    split over every device (:func:`~..thth.batch.make_grid_eval_fn`,
    per-chunk geometry; ``method="auto"`` the warm-start eigensolver)."""
    from ..thth.batch import make_grid_eval_fn

    return _lane_fn(
        "parallel.grid_search_sharded", mesh,
        _geom(tau, fd) + (int(n_edges), int(iters), method),
        lambda dev: make_grid_eval_fn(tau, fd, n_edges, iters=iters,
                                      method=method, device=dev))


def make_fused_grid_search_sharded(mesh, tau, fd, n_edges, nf, nt, npad=3,
                                   coher=True, tau_mask=0.0, fw=0.1,
                                   iters=64, method="power", eig="kernel"):
    """The fused θ-θ chunk grid over the mesh: ``fn(dspecs[B, nf, nt],
    edges[B, n_edges], etas[B, neta]) → (|λ|[B, neta], eta[B],
    eta_sig[B], popt[B, 3], ok[B])`` — raw chunks in; mean-pad, rfft2,
    θ-θ gather, eigen curve, closed-form peak fit and the health bitmask
    on each shard (:func:`~..thth.batch.make_fused_grid_eval_fn`).
    ``method="auto"`` walks each chunk's η row with the warm-start
    eigensolver (the kernel on a card, ``eig="plain"`` its plain
    version): the route of ``Dynspec.fit_thetatheta(mesh=...)``, whose
    chunks then get the η of the per-row search."""
    from ..thth.batch import make_fused_grid_eval_fn

    return _lane_fn(
        "parallel.fused_grid_search_sharded", mesh,
        _geom(tau, fd) + (int(n_edges), int(nf), int(nt), int(npad),
                          bool(coher), float(tau_mask), float(fw),
                          int(iters), method, eig),
        lambda dev: make_fused_grid_eval_fn(
            tau, fd, n_edges, nf, nt, npad=npad, coher=coher,
            tau_mask=tau_mask, fw=fw, iters=iters, method=method, eig=eig,
            device=dev))


def make_thth_thin_grid_search_sharded(mesh, tau, fd, n_edges,
                                       n_arclet_edges, center_cut,
                                       iters=64):
    """The thin-screen chunk grid over the mesh: ``fn(CS_ri[B, 2, ntau,
    nfd], edges[B, n_edges], edges_arclet[B, n_arclet_edges],
    etas[B, neta]) → σ[B, neta]`` (:func:`~..thth.batch.
    make_thin_grid_eval_fn`; rows of fewer arclet edges padded by
    :func:`~..thth.batch.pad_arclet_edges`)."""
    from ..thth.batch import make_thin_grid_eval_fn

    return _lane_fn(
        "parallel.thin_grid_search_sharded", mesh,
        _geom(tau, fd) + (int(n_edges), int(n_arclet_edges),
                          float(center_cut), int(iters)),
        lambda dev: make_thin_grid_eval_fn(
            tau, fd, n_edges, n_arclet_edges, center_cut, iters=iters,
            device=dev))


def make_fused_thin_grid_search_sharded(mesh, tau, fd, n_edges,
                                        n_arclet_edges, center_cut, nf, nt,
                                        npad=3, coher=True, tau_mask=0.0,
                                        fw=0.1, iters=200):
    """The fused thin-screen chunk grid over the mesh (the port's own):
    ``fn(dspecs[B, nf, nt], edges[B, n_edges], edges_arclet[B,
    n_arclet_edges], etas[B, neta]) → (σ[B, neta], eta[B], eta_sig[B],
    popt[B, 3], ok[B])`` (:func:`~..thth.batch.
    make_fused_thin_grid_eval_fn`), the route of the thin proc's
    ``Dynspec.fit_thetatheta(mesh=...)``: raw chunks in, each chunk with
    the spectrum, power iteration and closed-form peak fit of the per-row
    thin search."""
    from ..thth.batch import make_fused_thin_grid_eval_fn

    return _lane_fn(
        "parallel.fused_thin_grid_search_sharded", mesh,
        _geom(tau, fd) + (int(n_edges), int(n_arclet_edges),
                          float(center_cut), int(nf), int(nt), int(npad),
                          bool(coher), float(tau_mask), float(fw),
                          int(iters)),
        lambda dev: make_fused_thin_grid_eval_fn(
            tau, fd, n_edges, n_arclet_edges, center_cut, nf, nt,
            npad=npad, coher=coher, tau_mask=tau_mask, fw=fw, iters=iters,
            device=dev))


def make_arc_profile_sharded(mesh, tdel, fdop, delmax=None, startbin=3,
                             cutmid=3, numsteps=10000, fold=False):
    """The survey arc profile over the mesh: ``fn(sspecs[B, ntdel,
    nfdop], etas[B]) → profiles`` (:func:`~..ops.normsspec.
    make_arc_profile_batch_fn`: one arc-profile kernel launch per shard
    on a card), epochs split over every device. Returns ``(fn,
    n_devices)``, as the JAX package does."""
    from ..ops.normsspec import make_arc_profile_batch_fn

    fn = _lane_fn(
        "parallel.arc_profile_sharded", mesh,
        _geom(tdel, fdop) + (None if delmax is None else float(delmax),
                             int(startbin), int(cutmid), int(numsteps),
                             bool(fold)),
        lambda dev: make_arc_profile_batch_fn(
            tdel, fdop, delmax=delmax, startbin=startbin, cutmid=cutmid,
            numsteps=numsteps, fold=fold, device=dev))
    return fn, mesh.size


def make_arc_fit_sharded(mesh, tdel, fdop, delmax=None, startbin=3,
                         cutmid=3, numsteps=10000, nsmooth=5,
                         low_power_diff=-1.0, high_power_diff=-0.5,
                         constraint=(0.0, float("inf")), noise_error=True):
    """The whole survey arc fit over the mesh: ``fn(sspecs[B, ntdel,
    nfdop], etamins[B], Ls[B]) → (out[B, 10], folded[B, numsteps//2])``
    (:func:`~..ops.fitarc_device.make_arc_fit_batch_fn`), epochs split
    over every device. Returns ``(fn, n_devices)``."""
    from ..ops.fitarc_device import make_arc_fit_batch_fn

    fn = _lane_fn(
        "parallel.arc_fit_sharded", mesh,
        _geom(tdel, fdop) + (None if delmax is None else float(delmax),
                             int(startbin), int(cutmid), int(numsteps),
                             int(nsmooth), float(low_power_diff),
                             float(high_power_diff),
                             tuple(map(float, constraint)),
                             bool(noise_error)),
        lambda dev: make_arc_fit_batch_fn(
            tdel, fdop, delmax=delmax, startbin=startbin, cutmid=cutmid,
            numsteps=numsteps, nsmooth=nsmooth,
            low_power_diff=low_power_diff, high_power_diff=high_power_diff,
            constraint=constraint, noise_error=noise_error, device=dev))
    return fn, mesh.size


def make_acf2d_fit_sharded(mesh, nt_crop, nf_crop, ar, alpha, theta, tau0,
                           dt0, vary, lo, hi, n_iter=60, precision=None,
                           fresnel_method=None, alpha_varies=False):
    """The batched acf2d fit over the mesh: ``fn(x0s[B, k], ys[B, nf,
    nt], ws[B, nf, nt], tris[B, nf, nt], fixed[B, 7], dtdf[B, 2]) →
    dict(x, cost, ok, cov, residual, niter)`` (the fit of
    :func:`~..fit.acf2d.fit_acf2d_batch`, :func:`~..fit.acf2d.
    make_acf2d_fit_one`), epochs split over every device. Returns
    ``(fn, n_devices)``."""
    from ..fit.acf2d import make_acf2d_fit_one

    lo = np.asarray(lo, dtype=float)
    hi = np.asarray(hi, dtype=float)
    fn = _lane_fn(
        "parallel.acf2d_fit_sharded", mesh,
        (int(nt_crop), int(nf_crop), float(ar), float(alpha), float(theta),
         float(tau0), float(dt0), tuple(vary), lo.tobytes(), hi.tobytes(),
         int(n_iter), precision, fresnel_method, bool(alpha_varies)),
        lambda dev: make_acf2d_fit_one(
            nt_crop, nf_crop, ar, alpha, theta, tau0, dt0, vary, lo, hi,
            n_iter=n_iter, precision=precision,
            fresnel_method=fresnel_method, alpha_varies=alpha_varies,
            device=dev))
    return fn, mesh.size


def make_retrieval_sharded(mesh, nf_chunk, nt_chunk, dt, df, n_edges,
                           npad=3, method=None, iters=1024, warm_iters=64):
    """Chunk retrieval over the mesh: ``fn(chunks[B, nf, nt], edges[B,
    n_edges], etas[B], tau_mask=0.0, group=None) → (E[B, nf, nt]
    complex64, ok[B])`` (:func:`~..thth.retrieval.make_chunk_retrieval_fn`;
    ``method=None`` the kernel route). The chunks are walked in chains
    of ``group`` (default :func:`~..thth.retrieval.hbm_group` of B; B
    must be a multiple of it), and whole chains go to the shards, so
    every chunk is computed as it is without the mesh: a chain is never
    cut across devices."""
    from ..thth.retrieval import (_retrieval_fn, hbm_group,
                                  resolve_retrieval_method)

    method = resolve_retrieval_method(method)
    key = (int(nf_chunk), int(nt_chunk), float(dt), float(df), int(n_edges),
           int(npad), method, int(iters), int(warm_iters))
    _retrace.record_build("parallel.retrieval_sharded", key + (mesh.key,))

    def fn(chunks, edges, etas, tau_mask=0.0, group=None):
        B = len(chunks)
        group = hbm_group(B) if group is None else int(group)
        if B % group:
            raise ValueError(f"group={group} must divide the batch {B}")

        def fn_of(dev, n):
            base = _retrieval_fn(nf_chunk, nt_chunk, dt, df, n_edges, npad,
                                 method, iters, warm_iters, dev)
            return lambda c, e, t: base(c, e, t, float(tau_mask),
                                        group=group)

        return run_lanes(mesh, fn_of, (chunks, edges, etas), unit=group)

    fn.n_devices = mesh.size
    return fn


def make_eta_search_sharded(mesh, tau, fd, edges, iters=64):
    """The θ-θ eigenvalue curve of one conjugate spectrum with the η grid
    split over the mesh: ``fn(CS_ri[2, ntau, nfd], etas[neta]) →
    |λ|[neta]`` (:func:`~..thth.core.make_eval_fn`, ``iters`` cold power
    steps per η, so the split changes nothing). ``CS_ri`` goes whole to
    every device."""
    from ..thth.core import make_eval_fn

    site = "parallel.eta_search_sharded"
    key = _geom(tau, fd, edges) + (int(iters),)
    _retrace.record_build(site, key + (mesh.key,))

    def fn(CS_ri, etas):
        CS_ri = torch.as_tensor(CS_ri)
        etas = np.asarray(etas, dtype=float)

        def fn_of(dev, n):
            ev = per_device(_SHARD_FNS, (site,) + key, dev,
                            lambda: make_eval_fn(tau, fd, edges, iters=iters,
                                                 device=dev))
            cs = CS_ri.to(dev, torch.float32)
            return lambda e: ev(cs, e)

        return run_lanes(mesh, fn_of, (etas,))

    fn.n_devices = mesh.size
    return fn


def _acf_cuts_fn(mesh, nf, nt):
    """Batched ACF on the sharded FFT → the zero-lag cuts: zero-pad the
    mean-subtracted epochs to (2nf, 2nt), fft2, |·|², ifft2, real part,
    normalised at lag 0; row 0 and column 0 of the unshifted ACF are the
    1-D fits' cuts (``tcut[B, nt]``, ``fcut[B, nf]``)."""
    fft2 = make_fft2_sharded(mesh)
    ifft2 = make_fft2_sharded(mesh, inverse=True)

    def fn(dyns):
        dyns = torch.as_tensor(dyns)
        d = dyns - dyns.mean(dim=(1, 2), keepdim=True)
        d = torch.nn.functional.pad(d, (0, nt, 0, nf))
        spec = fft2(d)
        acf = ifft2(spec * torch.conj(spec)).real
        norm = acf[:, 0:1, 0:1]
        acf = acf / torch.where(norm == 0, torch.ones_like(norm), norm)
        return acf[:, 0, 0:nt], acf[:, 0:nf, 0]

    return fn


def make_survey_step(mesh, nf, nt, dt=1.0, df=1.0, alpha=5 / 3, n_iter=100,
                     bartlett=True, weighted=True, window="hanning",
                     window_frac=0.1):
    """The end-to-end survey step over the mesh: ``fn(dyns[B, nf, nt]) →
    (params, chisq, power, tcut, fcut)``, ``params`` the per-epoch
    ``tau, dnu, amp, tauerr, dnuerr, amperr, redchi`` of the 1-D ACF
    fits (:func:`~..fit.batch.make_acf1d_fit_one`, epochs split over
    every device), ``chisq[B]`` their chi-square, ``power`` the sharded
    secondary spectrum of every epoch (:func:`.fft.
    make_sspec_power_sharded`) and ``tcut``/``fcut`` the ACF cuts from
    the sharded FFT. B must divide over the data axis, and the ACF's
    (2nf, 2nt) over the seq axis."""
    from ..fit.batch import make_acf1d_batch
    from ..ops.windows import get_window

    k = mesh.shape[SEQ_AXIS]
    if (2 * nf) % k or (2 * nt) % k:
        raise ValueError(f"seq axis {k} must divide the ACF FFT shape "
                         f"({2 * nf}, {2 * nt})")
    wins = None
    if window is not None:
        wins = get_window(nt, nf, window=window, frac=window_frac)
    sspec_fn = make_sspec_power_sharded(mesh, nf, nt, window_arrays=wins)
    acf_fn = _acf_cuts_fn(mesh, nf, nt)
    key = (int(nf), int(nt), float(dt), float(df), float(alpha),
           int(n_iter), bool(bartlett), bool(weighted), window,
           float(window_frac))
    _retrace.record_build("parallel.survey_step", key + (mesh.key,))

    def step(dyns):
        dyns = torch.as_tensor(np.asarray(dyns) if not isinstance(
            dyns, torch.Tensor) else dyns).to(mesh.first, torch.float32)
        if dyns.shape[0] % mesh.shape[DATA_AXIS]:
            raise ValueError(f"{dyns.shape[0]} epochs do not split over "
                             f"the data axis of {mesh.shape[DATA_AXIS]}")
        power = sspec_fn(dyns)
        tcut, fcut = acf_fn(dyns)
        out = run_lanes(mesh, lambda dev, n: make_acf1d_batch(
            nt, nf, dt, df, alpha=alpha, n_iter=n_iter, bartlett=bartlett,
            weighted=weighted, device=dev), (tcut, fcut))
        chisq = out.pop("chisqr")
        return out, chisq, power, tcut, fcut

    return step


def make_scenario_factory_sharded(mesh, ns=128, nf=64, dlam=0.25, rf=1.0,
                                  ds=0.01, inner=0.001, nscreens=64,
                                  precision=None, screen=None,
                                  propagate=None, levels=1, lamsteps=False):
    """The scenario factory over the mesh: ``fn(keys[B], mb2[B], ar[B],
    psi[B], alpha[B]) → (dynspec[B, ns, nf], ok[B])`` with the lanes
    split over every device (:func:`~..sim.factory.make_scenario_factory`,
    one group per shard). A lane's screen comes from its own key, so
    every lane is what the unsharded factory makes of it. ``nscreens``
    is the JAX package's batch size and is not needed here: each shard
    builds for its own lane count."""
    from ..sim.factory import make_scenario_factory

    key = (int(ns), int(nf), float(dlam), float(rf), float(ds),
           float(inner), precision, screen, propagate, int(levels),
           bool(lamsteps))
    _retrace.record_build("parallel.scenario_sharded", key + (mesh.key,))

    def fn(keys, mb2, ar, psi, alpha):
        keys = np.asarray(keys, dtype=np.int64).reshape(-1)
        B = len(keys)
        lanes = [np.array(np.broadcast_to(np.asarray(v, dtype=float), (B,)))
                 for v in (mb2, ar, psi, alpha)]
        return run_lanes(mesh, lambda dev, n: make_scenario_factory(
            ns=ns, nf=nf, dlam=dlam, rf=rf, ds=ds, inner=inner,
            nscreens=n, group_size=n, precision=precision, screen=screen,
            propagate=propagate, levels=levels, lamsteps=lamsteps,
            device=dev), [keys] + lanes)

    fn.n_devices = mesh.size
    return fn


__all__ = ["make_acf2d_fit_sharded", "make_arc_fit_sharded",
           "make_arc_profile_sharded", "make_eta_search_sharded",
           "make_fused_grid_search_sharded",
           "make_fused_thin_grid_search_sharded", "make_retrieval_sharded",
           "make_scenario_factory_sharded", "make_survey_step",
           "make_thth_grid_search_sharded",
           "make_thth_thin_grid_search_sharded"]
