"""Chunked θ-θ curvature search: the single-chunk and fused routes in
PyTorch.

Counterpart of ``scintools_tpu/thth/search.py``: ``chi_par``/``err_calc``
(:33-48), ``ChunkSearchResult`` (:50), ``_host_health`` (:74),
``chunk_geometry`` (:93), ``pad_chunk`` (:108),
``chunk_conjugate_spectrum`` (:117), ``fit_eig_peak`` (:130, the scipy
host oracle), ``_quarantine_host`` (:170), ``single_search`` (:182),
``_jitted_fused_eval`` (:234, here a plain dict of built search
functions keyed on the geometry bytes), ``_fused_results`` (:273) and
``multi_chunk_search`` (:304). A single chunk goes to
:func:`single_search`, as in the JAX package: a float64 host FFT, the
eigenvalue curve as one chain of the warm-start eigensolver on the
device, then the scipy peak fit; two or more chunks run the fused
search of thth/batch.py, or with ``fused=False`` the staged route of
the JAX package (:356-396): the float64 host FFT per chunk, the device
gather and eigen curve of all chunks in one call, then the scipy peak
fit per chunk. Both routes take the JAX package's eigensolver
``method`` (:data:`.batch.METHODS`), and the fused searches are cached
per method as well as per geometry.

The thin-screen search (:func:`single_search_thin`,
:func:`multi_chunk_search_thin`; :412-551) has three routes: the fused device search
(``thth/batch.py:make_fused_thin_search_fn``, built once per geometry
and counted by ``obs.retrace.record_build``), the staged route
``fused=False`` (the float64 host FFT, the device thin evaluator, the
scipy peak fit) and ``eig="svd"``, the per-η float64 host SVD loop that the JAX package
runs on its numpy backend: the oracle, taken only when asked for.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy.optimize import curve_fit

from ..backend import as_tensor, fifo_cached, formulation, resolve_device
from ..obs import retrace as _retrace
from ..obs import trace as _trace
from ..robust import guards
from .batch import check_method
from .core import (cs_to_ri, eval_calc_batch, fft_axis,
                   singularvalue_calc, unit_checks)


def chi_par(x, A, x0, C):
    """Parabola for peak fitting."""
    return A * (x - x0) ** 2 + C


def err_calc(etas, eigs, fit_pars):
    """Peak-position error of the parabola fit from the residual
    scatter."""
    etas = np.asarray(unit_checks(etas, "etas"), dtype=float)
    eigs = np.asarray(eigs, dtype=float)
    M = chi_par(etas, *fit_pars)
    sig_estimate = np.std(eigs - M)
    A, x0 = fit_pars[0], fit_pars[1]
    denom = np.sum(4 * A * (2 * A * (x0 - etas) ** 2 + M - eigs))
    return np.sqrt(2 / denom) * sig_estimate


@dataclass
class ChunkSearchResult:
    eta: float          # fitted curvature (s³ ≡ us/mHz²)
    eta_sig: float      # fit error
    freq_mean: float    # mean frequency of chunk (MHz)
    time_mean: float    # mean time of chunk (s)
    eigs: np.ndarray    # eigenvalue-vs-η curve (NaN entries stripped)
    etas: np.ndarray    # η grid matching ``eigs``
    popt: np.ndarray = None  # parabola-fit coefficients (A, x0, C)
    ok: int = 0         # health bitmask (robust/guards.py; 0=healthy)

    @property
    def healthy(self):
        return int(self.ok) == 0

    @property
    def health(self):
        from ..robust.guards import describe_health

        return describe_health(self.ok)


def chunk_geometry(nf=64, nt=64, npad=3, dt=2.0, df=0.05, f0=1400.0,
                   eta_max=4e-3, n_edges=64):
    """Static axes for one θ-θ chunk: (freqs MHz, times s, tau µs,
    fd mHz, edges mHz), with the θ edges sized so the reduced θ-θ
    stays inside the conjugate spectrum at the largest curvature."""
    freqs = f0 + np.arange(nf) * df
    times = np.arange(nt) * dt
    fd = fft_axis(times, pad=npad, scale=1e3)
    tau = fft_axis(freqs, pad=npad, scale=1.0)
    th_lim = 0.95 * min(np.sqrt(tau.max() / eta_max), fd.max() / 2)
    edges = np.linspace(-th_lim, th_lim, n_edges)
    return freqs, times, tau, fd, edges


def _host_health(dspec, eigs, eta_fit, popt):
    """The health bitmask of one chunk searched on the host route, as
    the fused search computes it per lane: input finite, curve
    non-degenerate, peak fit accepted."""
    fit_ok = (popt is not None and np.all(np.isfinite(popt))
              and np.isfinite(eta_fit))
    in_ok = bool(np.isfinite(np.asarray(dspec)).all())
    curve = torch.as_tensor(np.asarray(eigs, dtype=float)[None])
    return int(guards.health_code(
        input_ok=torch.tensor([in_ok]),
        curve_ok=guards.curve_health(curve),
        fit_ok=torch.tensor([bool(fit_ok)]))[0])


def pad_chunk(dspec, npad, fill="mean"):
    """Pad a dynamic-spectrum chunk with ``npad`` extra copies of its
    mean (``fill="mean"``) or of zero."""
    value = dspec.mean() if fill == "mean" else 0.0
    return np.pad(dspec,
                  ((0, npad * dspec.shape[0]), (0, npad * dspec.shape[1])),
                  mode="constant", constant_values=value)


def chunk_conjugate_spectrum(dspec, time, freq, npad=3, tau_mask=0.0):
    """``(CS, tau, fd)`` of a padded chunk: the fftshifted complex
    conjugate spectrum in numpy float64, as the reference computes it,
    with the rows |τ| < ``tau_mask`` zeroed."""
    time = np.asarray(unit_checks(time, "time"), dtype=float)
    freq = np.asarray(unit_checks(freq, "freq"), dtype=float)
    fd = fft_axis(time, pad=npad, scale=1e3)
    tau = fft_axis(freq, pad=npad, scale=1.0)
    dspec_pad = pad_chunk(np.asarray(dspec), npad)
    CS = np.fft.fftshift(np.fft.fft2(dspec_pad))
    if tau_mask:
        CS[np.abs(tau) < float(unit_checks(tau_mask))] = 0
    return CS, tau, fd


def fit_eig_peak(etas, eigs, fw=0.1, full=False):
    """Parabola fit around the eigenvalue peak with scipy (the host
    oracle of thth/peakfit.py). With ``full=True`` also returns
    (popt, etas_clean, eigs_clean) with NaN eigenvalues stripped."""
    etas = np.asarray(etas, dtype=float)
    eigs = np.asarray(eigs, dtype=float)
    ok = np.isfinite(eigs)
    etas, eigs = etas[ok], eigs[ok]

    def out(eta_fit, eta_sig, popt):
        if full:
            return eta_fit, eta_sig, popt, etas, eigs
        return eta_fit, eta_sig

    if len(etas) < 3:
        return out(np.nan, np.nan, None)
    e_pk = etas[eigs == eigs.max()][0]
    sel = np.abs(etas - e_pk) < fw * e_pk
    etas_fit, eigs_fit = etas[sel], eigs[sel]
    if len(etas_fit) < 3:
        return out(np.nan, np.nan, None)
    C = eigs_fit.max()
    x0 = etas_fit[eigs_fit == C][0]
    if x0 == etas_fit[0]:
        A = (eigs_fit[-1] - C) / ((etas_fit[-1] - x0) ** 2)
    else:
        A = (eigs_fit[0] - C) / ((etas_fit[0] - x0) ** 2)
    try:
        popt, _ = curve_fit(chi_par, etas_fit, eigs_fit,
                            p0=np.array([A, x0, C]))
    except Exception:
        return out(np.nan, np.nan, None)
    eta_fit = popt[1]
    eta_sig = np.sqrt((eigs_fit - chi_par(etas_fit, *popt)).std()
                      / np.abs(popt[0]))
    return out(eta_fit, eta_sig, popt)


def _quarantine_host(ok, eta_fit, eta_sig, popt):
    """NaN the fit of an input- or spectrum-corrupt chunk, as the fused
    search does per lane."""
    if int(ok) & (guards.BAD_INPUT | guards.BAD_CS):
        return np.nan, np.nan, None
    return eta_fit, eta_sig, popt


def single_search(dspec, freq, time, etas, edges, fw=0.1, npad=3,
                  coher=True, tau_mask=0.0, verbose=False, device=None,
                  eig="kernel"):
    """Curvature search on one chunk: the float64 host conjugate
    spectrum (its magnitude with ``coher=False``) → the eigenvalue curve
    over ``etas`` as one chain of the warm-start eigensolver on
    ``device`` (:func:`.core.eval_calc_batch`; ``eig`` as there) → the
    scipy parabola fit → the health bitmask. Returns a
    :class:`ChunkSearchResult`."""
    etas = np.asarray(unit_checks(etas, "etas"), dtype=float)
    CS, tau, fd = chunk_conjugate_spectrum(dspec, time, freq, npad=npad,
                                           tau_mask=tau_mask)
    base = CS if coher else np.abs(CS)
    eigs = eval_calc_batch(base, tau, fd, etas, edges, device=device,
                           eig=eig)
    res = _host_fit_result(dspec, eigs, etas, fw, freq, time)
    if verbose:
        print(f"single_search: f={res.freq_mean:.1f} MHz "
              f"t={res.time_mean:.0f} s → eta={res.eta:.4g} "
              f"+/- {res.eta_sig:.2g}")
    return res


def _host_fit_result(dspec, eigs, etas, fw, freq, time):
    """The scipy peak fit of one chunk's curve, its health bitmask and
    quarantine, as a :class:`ChunkSearchResult`."""
    eta_fit, eta_sig, popt, etas_c, eigs_c = fit_eig_peak(
        etas, eigs, fw=fw, full=True)
    ok = _host_health(dspec, eigs, eta_fit, popt)
    eta_fit, eta_sig, popt = _quarantine_host(ok, eta_fit, eta_sig, popt)
    return ChunkSearchResult(
        eta=eta_fit, eta_sig=eta_sig,
        freq_mean=float(np.asarray(unit_checks(freq, "freq"),
                                   dtype=float).mean()),
        time_mean=float(np.asarray(unit_checks(time, "time"),
                                   dtype=float).mean()),
        eigs=eigs_c, etas=etas_c, popt=popt, ok=ok)


_FUSED_CACHE = {}
_CACHE_SIZE = 16


def _fused_eval(tau, fd, edges, shape, npad, coher, tau_mask, fw, method,
                eig, device):
    """The fused search function for one geometry and eigensolver
    method, built once and kept in a FIFO-bounded dict keyed on the
    geometry's bytes and the method."""
    from .batch import make_fused_search_fn, resolve_fused_method

    nf, nt = shape
    method = resolve_fused_method(method, len(edges), device.type)
    key = ("fused", tau.tobytes(), fd.tobytes(), edges.tobytes(),
           (int(nf), int(nt)), int(npad), bool(coher), float(tau_mask),
           float(fw), method, formulation("ops.cs", device.type), eig,
           str(device))

    def build():
        _retrace.record_build("thth.fused", key)
        return make_fused_search_fn(
            tau, fd, edges, nf, nt, npad=npad, coher=coher,
            tau_mask=tau_mask, fw=fw, method=method, eig=eig, device=device)

    return fifo_cached(_FUSED_CACHE, key, build, _CACHE_SIZE)


def _fused_thin_eval(tau, fd, edges, edges_arclet, center_cut, shape, npad,
                     coher, tau_mask, fw, device):
    """The fused thin-screen search function for one geometry, keyed as
    :func:`_fused_eval` plus the arclet edges and the centre cut."""
    from .batch import make_fused_thin_search_fn

    nf, nt = shape
    key = ("fused_thin", tau.tobytes(), fd.tobytes(), edges.tobytes(),
           edges_arclet.tobytes(), float(center_cut), (int(nf), int(nt)),
           int(npad), bool(coher), float(tau_mask), float(fw),
           formulation("ops.cs", device.type), str(device))

    def build():
        _retrace.record_build("thth.fused_thin", key)
        return make_fused_thin_search_fn(
            tau, fd, edges, edges_arclet, center_cut, nf, nt, npad=npad,
            coher=coher, tau_mask=tau_mask, fw=fw, device=device)

    return fifo_cached(_FUSED_CACHE, key, build, _CACHE_SIZE)


def _thin_eval(tau, fd, edges, edges_arclet, center_cut, device):
    """The staged route's thin evaluator for one geometry, cached as
    :func:`_fused_thin_eval`."""
    from .batch import make_thin_eval_fn

    key = ("thin", tau.tobytes(), fd.tobytes(), edges.tobytes(),
           edges_arclet.tobytes(), float(center_cut), str(device))
    return fifo_cached(_FUSED_CACHE, key, lambda: make_thin_eval_fn(
        tau, fd, edges, edges_arclet, center_cut, device=device),
        _CACHE_SIZE)


def _host_chunks(dspecs):
    """``dspecs`` as a list of host arrays: a tensor stack fetched, a
    list as it is (the routes that take host chunks)."""
    if isinstance(dspecs, torch.Tensor):
        return list(dspecs.cpu().numpy())
    return dspecs


def _stack_chunks(dspecs):
    """The chunks as one float32 (B, nf, nt) stack: a tensor stack (a
    row of the façade's chunk grid, on the device already) as it is, a
    list of host arrays stacked on the host."""
    if isinstance(dspecs, torch.Tensor):
        return dspecs
    with _trace.span("thth.row.chunk"):
        return np.stack([np.asarray(unit_checks(d), dtype=np.float32)
                         for d in dspecs])


def _fused_results(fn, stack, etas, freq, times, device):
    """Upload the chunk ``stack``, run a fused search on ``device`` and
    unpack its outputs into per-chunk :class:`ChunkSearchResult` (NaN
    strip and popt gating on host), each stage in its program span."""
    with _trace.span("thth.row.upload"):
        stack = as_tensor(stack, device)
    with _trace.span("thth.row.search"):
        outs = fn(stack, etas)
    with _trace.span("thth.row.fetch"):
        eigs, eta, sig, popt, ok = (t.cpu().numpy() for t in outs)
    with _trace.span("thth.row.results"):
        freq_m = float(np.asarray(unit_checks(freq, "freq"),
                                  dtype=float).mean())
        etas = np.asarray(etas, dtype=float)
        out = []
        for b, t in enumerate(times):
            fin = np.isfinite(eigs[b])
            t_a = np.asarray(unit_checks(t, "time"), dtype=float)
            out.append(ChunkSearchResult(
                eta=float(eta[b]), eta_sig=float(sig[b]),
                freq_mean=freq_m, time_mean=float(t_a.mean()),
                eigs=eigs[b][fin].astype(float), etas=etas[fin],
                popt=(popt[b].astype(float) if np.isfinite(eta[b])
                      else None),
                ok=int(ok[b])))
    return out


def multi_chunk_search(dspecs, freq, times, etas, edges, fw=0.1, npad=3,
                       coher=True, tau_mask=0.0, method="auto", eig="kernel",
                       device=None, fused=True):
    """Curvature search on a batch of same-geometry chunks (e.g. all
    time-chunks of one frequency row) in one fused pass on ``device``:
    mean-pad → conjugate spectrum → masked θ-θ gather → eigen curve →
    closed-form parabola peak fit. A single chunk takes
    :func:`single_search` instead, whatever the method, as in the JAX
    package.

    dspecs : list of (nf, nt) chunk arrays, or a float32 (B, nf, nt)
    tensor stack of them (the fused route searches it where it lies;
    the others fetch it); times : list of per-chunk time axes (same
    spacing). ``method`` is the JAX package's
    eigensolver name (:data:`.batch.METHODS`): ``"auto"`` and
    ``"pallas"`` the warm-start eigensolver, ``"square"`` the cold
    squaring start per (chunk, η), ``"warm"`` the η-scan, ``"power"``
    200 cold power steps (:func:`.batch.make_multi_eval_fn`). ``eig``
    is ``"kernel"`` (the card's kernel on a CUDA device) or ``"plain"``
    (its plain PyTorch version everywhere), as there.
    ``fused=False`` takes the staged route (the fused search's parity
    oracle and the float64-FFT fallback tier of
    ``robust.ladder.thth_search_ladder``): per chunk the float64 host
    conjugate spectrum, then the eigen curves of all chunks in one
    device call (the same eigensolver), then the scipy peak fit and
    the health bitmask per chunk. Returns a list of
    ChunkSearchResult."""
    check_method(method)
    dev = resolve_device(device)
    etas = np.asarray(unit_checks(etas, "etas"), dtype=float)
    if len(dspecs) == 1 or not fused:
        dspecs = _host_chunks(dspecs)
    if len(dspecs) == 1:
        return [single_search(dspecs[0], freq, times[0], etas, edges,
                              fw=fw, npad=npad, coher=coher,
                              tau_mask=tau_mask, device=dev, eig=eig)]
    if not fused:
        return _multi_chunk_search_staged(dspecs, freq, times, etas, edges,
                                          fw, npad, coher, tau_mask, method,
                                          eig, dev)
    stack = _stack_chunks(dspecs)
    _, nf, nt = stack.shape
    time0 = np.asarray(unit_checks(times[0], "time"), dtype=float)
    freq_a = np.asarray(unit_checks(freq, "freq"), dtype=float)
    fd = fft_axis(time0, pad=npad, scale=1e3)
    tau = fft_axis(freq_a, pad=npad, scale=1.0)
    edges_a = np.asarray(unit_checks(edges, "edges"), dtype=float)
    fn = _fused_eval(tau, fd, edges_a, (nf, nt), npad, coher,
                     float(unit_checks(tau_mask) or 0.0), fw, method, eig,
                     dev)
    return _fused_results(fn, stack, etas, freq, times, dev)


def _multi_chunk_search_staged(dspecs, freq, times, etas, edges, fw, npad,
                               coher, tau_mask, method, eig, dev):
    """The staged route of :func:`multi_chunk_search`."""
    from .core import _eval_fn

    cs_ri = []
    tau = fd = None
    for d, t in zip(dspecs, times):
        CS, tau, fd = chunk_conjugate_spectrum(d, t, freq, npad=npad,
                                               tau_mask=tau_mask)
        cs_ri.append(cs_to_ri(CS if coher else np.abs(CS)))
    edges_a = np.asarray(unit_checks(edges, "edges"), dtype=float)
    fn = _eval_fn(tau, fd, edges_a, 200, method, eig, dev)
    eigs_all = fn.multi(as_tensor(np.stack(cs_ri), dev),
                        etas).cpu().numpy().astype(float)
    return [_host_fit_result(d, eigs_all[b], etas, fw, freq, t)
            for b, (d, t) in enumerate(zip(dspecs, times))]


def single_search_thin(dspec, freq, time, etas, edges, edgesArclet,
                       centerCut, fw=0.1, npad=3, coher=True, tau_mask=0.0,
                       verbose=False, device=None, eig="power"):
    """Two-curvature (thin-screen) search on one chunk: the largest
    singular value of the two-curve θ-θ per η, then the peak fit. The
    one-chunk case of :func:`multi_chunk_search_thin` (``eig`` as
    there)."""
    res = multi_chunk_search_thin(
        [dspec], freq, [time], etas, edges, edgesArclet, centerCut, fw=fw,
        npad=npad, coher=coher, tau_mask=tau_mask, device=device,
        eig=eig)[0]
    if verbose:
        print(f"single_search_thin: f={res.freq_mean:.1f} MHz → "
              f"eta={res.eta:.4g} +/- {res.eta_sig:.2g}")
    return res


def multi_chunk_search_thin(dspecs, freq, times, etas, edges, edgesArclet,
                            centerCut, fw=0.1, npad=3, coher=True,
                            tau_mask=0.0, device=None, fused=True,
                            eig="power"):
    """Thin-screen search on a batch of same-geometry chunks on
    ``device`` (``None``: the CUDA card). ``eig="power"`` (the default)
    takes the device evaluator, :func:`.batch.make_thin_eval_fn`: with
    ``fused=True`` raw chunks in, the whole search as one chained device
    function (built once per geometry); with ``fused=False`` the staged
    route, the float64 host FFT, the device evaluator and the scipy
    peak fit. ``eig="svd"`` is the host oracle: per chunk and η, the
    float64 SVD of the cropped two-curve θ-θ
    (:func:`.core.singularvalue_calc`), then the scipy fit. The
    conjugate-spectrum base is |CS|² with ``coher=False``. ``dspecs``
    may be a tensor stack, as in :func:`multi_chunk_search`. Returns a
    list of :class:`ChunkSearchResult`."""
    if eig not in ("power", "svd"):
        raise ValueError(f"unknown eig {eig!r} (want 'power' or 'svd')")
    dev = resolve_device(device)
    etas = np.asarray(unit_checks(etas, "etas"), dtype=float)
    edges_a = np.asarray(unit_checks(edges, "edges"), dtype=float)
    arclet_a = np.asarray(unit_checks(edgesArclet, "edges_arclet"),
                          dtype=float)
    cut = float(unit_checks(centerCut, "center_cut"))
    if eig == "power" and fused:
        stack = _stack_chunks(dspecs)
        _, nf, nt = stack.shape
        time0 = np.asarray(unit_checks(times[0], "time"), dtype=float)
        freq_a = np.asarray(unit_checks(freq, "freq"), dtype=float)
        fd = fft_axis(time0, pad=npad, scale=1e3)
        tau = fft_axis(freq_a, pad=npad, scale=1.0)
        fn = _fused_thin_eval(tau, fd, edges_a, arclet_a, cut, (nf, nt),
                              npad, coher,
                              float(unit_checks(tau_mask) or 0.0), fw, dev)
        return _fused_results(fn, stack, etas, freq, times, dev)

    dspecs = _host_chunks(dspecs)
    bases = []
    for dspec, time in zip(dspecs, times):
        CS, tau, fd = chunk_conjugate_spectrum(dspec, time, freq, npad=npad,
                                               tau_mask=tau_mask)
        bases.append(CS if coher else np.abs(CS) ** 2)
    if eig == "svd":
        curves = []
        for base in bases:
            curve = np.empty(len(etas))
            for i, eta in enumerate(etas):
                try:
                    curve[i] = singularvalue_calc(base, tau, fd, eta,
                                                  edges_a, eta, arclet_a,
                                                  cut)
                except (ValueError, IndexError):
                    # an η whose crop leaves no valid θ (ValueError, which
                    # LinAlgError is) or whose Doppler index falls below
                    # -len (IndexError): NaN, as the JAX package's loop
                    curve[i] = np.nan
            curves.append(curve)
    else:
        fn = _thin_eval(tau, fd, edges_a, arclet_a, cut, dev)
        cs_ri = torch.as_tensor(np.stack([cs_to_ri(b) for b in bases]),
                                dtype=torch.float32, device=dev)
        curves = fn(cs_ri, etas).cpu().numpy().astype(float)
    return [_host_fit_result(d, c, etas, fw, freq, t)
            for d, c, t in zip(dspecs, curves, times)]


__all__ = ["ChunkSearchResult", "chi_par", "chunk_conjugate_spectrum",
           "chunk_geometry", "err_calc", "fit_eig_peak",
           "multi_chunk_search", "multi_chunk_search_thin", "pad_chunk",
           "single_search", "single_search_thin"]
