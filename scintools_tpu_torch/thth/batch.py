"""Chunk-batched θ-θ curvature search in PyTorch.

Counterpart of ``scintools_tpu/thth/batch.py``: ``_geometry`` (:47),
``make_multi_eval_fn`` (:55; the ``build_batch`` gather :92-127, the
``'power'`` route :129-142, the ``'warm'`` η-scan :146-187, then the
``'pallas'`` and ``'square'`` routes :189-217),
``make_grid_eval_fn`` (:220), ``make_thin_grid_eval_fn`` (:292),
``make_thin_eval_fn`` (:368), ``_chunk_cs_to_ri`` (:478),
``_tau_keep_mask`` (:506), ``_health_and_quarantine`` (:513),
``make_fused_search_fn`` (:538), ``make_fused_thin_search_fn`` (:598)
and ``make_fused_grid_eval_fn`` (:632), with the port's own
``make_fused_thin_grid_eval_fn`` beside them.

All chunks of one frequency row share (tau, fd, edges, η grid), so the
θ-θ gather indices depend only on the geometry and η: they are built
once per call in float64 (a near-integer argument floored in float32
lands in the neighbouring bin and changes the matrix) and one gather
with the chunk as the minor axis fetches every chunk's value. The
matrices are then laid out chunk-major as (B, neta, 2, N, N) float32
for the warm-start eigensolver (thth/eig.py), which walks η in order
within each chunk.

The eigensolver ``method`` takes the JAX package's names (:data:`METHODS`):
``"auto"`` and ``"pallas"`` walk each chunk's η grid with the warm-start
eigensolver (the ``eig_warmstart`` kernel on the card, as JAX
``'pallas'`` runs its Pallas kernel); ``"square"`` gives every
(chunk, η) matrix the cold squaring start alone (the ``eig_cold`` kernel
on the card; JAX ``batched_eig_squaring_xla``); ``"warm"`` is the JAX
package's η-scan in plain PyTorch (a Gershgorin-shifted power iteration
that carries each chunk's vector from η to η: ``iters`` steps on the
first η, ``warm_iters`` on every η, then the Rayleigh quotient), which
is XLA code there and not a kernel; ``"power"`` runs ``iters`` cold
shifted power steps on every matrix.

The thin-screen evaluators take the cold ``iters``-step power iteration
(:func:`.core.dominant_eig_power`) in both packages, never the
warm-start eigensolver, whose chained warm start is another algorithm;
so do the traced-geometry grid evaluators unless asked for the
warm-start route (``method="auto"``, the port's own, which the sharded
façade fit takes so that a chunk gets the per-row search's curve).
The thin search takes the largest singular value of the two-curve θ-θ
as √λ_max(AᴴA): each (chunk, η) matrix is scaled by its largest modulus
before the complex Gram product (float32 squaring would overflow
otherwise) and σ scaled back. The grid
evaluators give every chunk its own edges and η, so their index maps
are built per chunk on the device in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import formulation, register_formulation, resolve_device
from ..obs import trace as _trace
from ..ops.sspec import chunk_conjugate_spectrum_batch
from ..robust import guards
from .core import _EPS, dominant_eig_power, th_cents_from_edges, unit_checks
from .eig import (batched_eig_cold, batched_eig_cold_plain,
                  batched_eig_warmstart, batched_eig_warmstart_plain,
                  pad_to_multiple)
from .peakfit import fit_eig_peak_batch_device

# the eigensolver methods of the JAX package's θ-θ entry points
METHODS = ("auto", "pallas", "warm", "square", "power")

# the search's eigensolver as a registry op (the JAX package's :39): the
# card's kernel takes every matrix size, so "pallas" (the warm-start
# eigensolver) is the entry on both devices
register_formulation(
    "thth.eig", default="warm", choices=("warm", "power", "square", "pallas"),
    platforms={"cpu": "pallas", "cuda": "pallas"},
    doc="θ-θ search eigensolver: the warm-start eigensolver (eig_warmstart "
        "kernel) vs the η-scan warm start vs cold power iteration vs the "
        "cold squaring start (eig_cold kernel)")


def check_method(method):
    """Raise ``ValueError`` unless ``method`` is one of :data:`METHODS`."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r} (want one of "
                         f"{METHODS})")


def resolve_fused_method(method, n_edges=None, platform=None):
    """The concrete eigensolver of ``method``: ``"auto"`` resolves the
    ``thth.eig`` formulation on ``platform`` (a device type; ``None``:
    ``backend.formulation_platform()``), any other name of
    :data:`METHODS` is itself and anything else raises ``ValueError``.
    ``n_edges`` is the JAX package's second argument (its VMEM guard,
    which falls back to ``"warm"``); the card's kernel takes every size,
    so it is unused and no choice becomes another."""
    check_method(method)
    if method == "auto":
        method = formulation("thth.eig", platform)
    return method


def _geometry(tau, fd, edges):
    tau_a = np.asarray(unit_checks(tau, "tau"), dtype=float)
    fd_a = np.asarray(unit_checks(fd, "fd"), dtype=float)
    edges_a = np.asarray(unit_checks(edges, "edges"), dtype=float)
    return tau_a, fd_a, th_cents_from_edges(edges_a)


def make_multi_eval_fn(tau, fd, edges, iters=200, method="auto",
                       squarings=10, warm_iters=24, eig="kernel",
                       device=None):
    """Build ``fn(CS_ri[B, 2, ntau, nfd], etas[neta]) → |λ|[B, neta]``
    for conjugate spectra sharing one geometry, on ``device`` (``None``:
    the CUDA card, see :func:`backend.resolve_device`).

    ``method`` is one of :data:`METHODS` (see the module docstring).
    Every method exposes its two stages, ``fn(CS_ri, etas) ==
    fn.solve(fn.gather(CS_ri, etas))``: ``fn.gather`` is the masked θ-θ
    gather and ``fn.solve`` the eigensolver on its output. For
    ``"auto"``/``"pallas"`` (the warm-start eigensolver) and
    ``"square"`` (the cold squaring start alone, per matrix) the gather
    returns the padded (B, neta, 2, N, N) float32 batch; for ``"power"``
    the (B, neta, n, n) and for ``"warm"`` the (neta, B, n, n) complex64
    matrices. ``eig='kernel'`` dispatches by device
    (:func:`batched_eig_warmstart`, :func:`batched_eig_cold`: the kernel
    on a CUDA tensor, which launches or raises); ``eig='plain'`` always
    runs the plain PyTorch version (the reference the kernel is held
    to). ``"warm"`` and ``"power"``
    run in plain PyTorch on any device, as the JAX package runs them in
    XLA."""
    if eig not in ("kernel", "plain"):
        raise ValueError(f"unknown eig {eig!r} (want 'kernel' or 'plain')")
    check_method(method)
    dev = resolve_device(device)
    method = resolve_fused_method(method, len(edges), dev.type)
    tau_a, fd_a, th_cents = _geometry(tau, fd, edges)
    n_th = len(th_cents)
    n_pad = pad_to_multiple(n_th)
    ntau, nfd = len(tau_a), len(fd_a)
    th1 = th_cents[None, :] * np.ones((n_th, 1))
    th2 = th1.T
    dtau = np.diff(tau_a).mean()
    dfd = np.diff(fd_a).mean()
    fd_inv = np.floor(((th1 - th2) - fd_a[0] + dfd / 2)
                      / dfd).astype(int)

    def on(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    dth2 = on(th1 ** 2 - th2 ** 2, torch.float64)
    fd_ok = on((fd_inv < nfd) & (fd_inv >= -nfd))
    # negative fd_inv wraps (floor-mod, as numpy's and torch's `%`)
    fd_wrap = on(fd_inv % nfd, torch.int64)
    w_th = on(np.sqrt(np.abs(2 * (th2 - th1))), torch.float64)
    tril = on(np.tril(np.ones((n_th, n_th))) > 0)
    anti = on(np.eye(n_th)[::-1] > 0)
    cents2 = on(th_cents ** 2, torch.float64)
    # |θ| < fd_max/2 is η-independent; θ²η < τ_max is applied per η
    half_valid = on(np.abs(th_cents) < np.abs(fd_a.max()) / 2)
    tau_max = float(np.abs(tau_a.max()))

    def build_batch(CS_ri, etas):
        """(B, 2, ntau, nfd), (neta,) → θ-θ batch (neta, n, n, B)
        complex64, built with one chunk-minor gather."""
        e = torch.as_tensor(etas, dtype=torch.float64, device=dev)
        CS_c = torch.complex(CS_ri[:, 0], CS_ri[:, 1])
        CS_c = CS_c.permute(1, 2, 0).reshape(ntau * nfd, -1)
        tau_inv = torch.floor((e[:, None, None] * dth2 - tau_a[0]
                               + dtau / 2) / dtau).to(torch.int64)
        pnts = (tau_inv > 0) & (tau_inv < ntau) & fd_ok[None]
        idx = torch.where(pnts, tau_inv, 0) * nfd + fd_wrap[None]
        thth = CS_c[idx.reshape(-1)].reshape(idx.shape + (-1,))
        thth.masked_fill_(~pnts[..., None], 0)
        w = w_th[None] * torch.sqrt(e.abs())[:, None, None]
        thth.mul_(w.to(torch.float32)[..., None])
        # hermitian symmetrisation
        thth.masked_fill_(tril[None, ..., None], 0)
        thth = thth + torch.conj(thth.transpose(1, 2))
        thth.masked_fill_(anti[None, ..., None], 0)
        thth = torch.nan_to_num(thth)
        valid = (cents2[None, :] * e[:, None] < tau_max) & half_valid[None]
        thth.mul_(valid[:, None, :, None] & valid[:, :, None, None])
        return thth

    def gather(CS_ri, etas):
        thth = build_batch(CS_ri, etas).permute(3, 0, 1, 2)
        B, neta = thth.shape[:2]
        a_ri = torch.zeros((B, neta, 2, n_pad, n_pad), dtype=torch.float32,
                           device=dev)
        a_ri[:, :, 0, :n_th, :n_th] = thth.real
        a_ri[:, :, 1, :n_th, :n_th] = thth.imag
        return a_ri

    if method == "power":
        def gather(CS_ri, etas):
            # chunk-major and contiguous: each power step's batched
            # product would otherwise copy the permuted stack
            return build_batch(CS_ri, etas).permute(3, 0, 1, 2).contiguous()

        def solve(thth):
            lam, _ = dominant_eig_power(thth, iters=iters)
            return lam.abs()
    elif method == "warm":
        def gather(CS_ri, etas):
            # (neta, B, n, n): the scan walks η, every chunk at once
            return build_batch(CS_ri, etas).permute(0, 3, 1, 2).contiguous()

        def solve(A):
            return _eta_scan(A, iters, warm_iters).T
    elif method == "square":
        cold = batched_eig_cold if eig == "kernel" else batched_eig_cold_plain

        def solve(a_ri):
            # every (chunk, η) matrix on its own: (B·neta, 2, N, N)
            B = a_ri.shape[0]
            flat = a_ri.reshape((-1,) + a_ri.shape[2:])
            return cold(flat, n_th // 2, squarings=squarings).reshape(
                B, -1).abs()
    else:
        solver = (batched_eig_warmstart if eig == "kernel"
                  else batched_eig_warmstart_plain)

        def solve(a_ri):
            return solver(a_ri, n_th // 2, squarings=squarings,
                          iters=warm_iters).abs()

    def fn(CS_ri, etas):
        return solve(gather(CS_ri, etas))

    fn.build_batch, fn.gather, fn.solve = build_batch, gather, solve
    fn.n_th, fn.n_pad = n_th, n_pad
    return fn


def _eta_scan(A, iters, warm_iters):
    """The JAX package's ``'warm'`` η-scan on ``A[neta, B, n, n]``
    (hermitian): a Gershgorin-shifted power iteration per chunk, started
    cold from ``A[0]``'s middle row with ``iters`` steps, then
    ``warm_iters`` steps on every η (the first one again) carrying the
    vector from η to η, and the Rayleigh quotient. Returns |λ|[neta, B]."""
    n = A.shape[-1]
    shift = A.abs().sum(dim=-1).amax(dim=-1)            # (neta, B)

    def steps(a, v, s, k):
        for _ in range(int(k)):
            w = (a @ v[..., None])[..., 0] + s[:, None] * v
            v = w / (torch.sqrt((w.abs() ** 2).sum(dim=1, keepdim=True))
                     + _EPS)
        return v

    v = A[0, :, n // 2, :]
    nrm = torch.sqrt((v.abs() ** 2).sum(dim=1, keepdim=True))
    v = torch.where(nrm > 0, v / (nrm + _EPS),
                    torch.ones_like(v) / np.sqrt(n))
    v = steps(A[0], v, shift[0], iters)
    lam = []
    for a, s in zip(A, shift):
        v = steps(a, v, s, warm_iters)
        Av = (a @ v[..., None])[..., 0]
        num = (torch.conj(v) * Av).sum(dim=1).real
        den = (torch.conj(v) * v).sum(dim=1).real
        lam.append((num / (den + _EPS)).abs())
    return torch.stack(lam)


def _recentred_cents(edges):
    """Bin centres of each row of ``edges[..., n + 1]`` re-centred on the
    bin nearest zero (first on a tie), on the device: the traced form of
    :func:`.core.th_cents_from_edges`."""
    cents = (edges[..., 1:] + edges[..., :-1]) / 2
    i0 = cents.abs().argmin(dim=-1, keepdim=True)
    return cents - cents.gather(-1, i0)


def _grid_inputs(CS_ri, etas_b, dev, *edges_b):
    """The traced-geometry evaluators' inputs on ``dev``: complex chunk
    spectra flattened to (B, ntau·nfd), float64 η rows and edge rows."""
    CS_c = torch.complex(CS_ri[:, 0], CS_ri[:, 1]).reshape(
        CS_ri.shape[0], -1)
    f64 = [torch.as_tensor(x, dtype=torch.float64, device=dev)
           for x in (etas_b,) + edges_b]
    return (CS_c,) + tuple(f64)


def make_grid_eval_fn(tau, fd, n_edges, iters=200, method="power",
                      eig="kernel", device=None):
    """Whole-chunk-grid η search with per-chunk geometry:
    ``fn(CS_ri[B, 2, ntau, nfd], edges[B, n_edges], etas[B, neta]) →
    |λ|[B, neta]`` on ``device`` (``None``: the CUDA card).

    The façade scales edges and η per frequency row (η ∝ f⁻², θ ∝ f), so
    chunks of different rows have different geometry: each chunk's θ-θ
    is built from its own edge and η rows with the standard map's
    formulas (index maps in float64 on the device). With
    ``method="power"`` (the JAX package's only route) every (chunk, η)
    matrix then takes ``iters`` cold power steps; ``method="auto"``
    walks each chunk's η row with the warm-start eigensolver instead, as
    :func:`make_multi_eval_fn` does at its default steps (``eig`` as
    there), so a chunk gets the |λ| curve of the per-row
    search. ``fn.build(CS_ri, edges, etas)`` is the gather alone,
    (B, neta, n, n) complex64."""
    if method not in ("auto", "power"):
        raise ValueError(f"unknown method {method!r} (want 'auto' or "
                         "'power')")
    dev = resolve_device(device)
    tau_a = np.asarray(unit_checks(tau, "tau"), dtype=float)
    fd_a = np.asarray(unit_checks(fd, "fd"), dtype=float)
    dtau = np.diff(tau_a).mean()
    dfd = np.diff(fd_a).mean()
    ntau, nfd = len(tau_a), len(fd_a)
    n_th = int(n_edges) - 1
    tril = torch.as_tensor(np.tril(np.ones((n_th, n_th))) > 0, device=dev)
    anti = torch.as_tensor(np.eye(n_th)[::-1] > 0, device=dev)
    tau_max = float(np.abs(tau_a.max()))
    fd_half = float(np.abs(fd_a.max()) / 2)

    def build(CS_ri, edges_b, etas_b):
        CS_c, etas_b, edges_b = _grid_inputs(CS_ri, etas_b, dev, edges_b)
        cents = _recentred_cents(edges_b)
        B, neta = etas_b.shape
        out = torch.empty((B, neta, n_th, n_th), dtype=torch.complex64,
                          device=dev)
        for b in range(B):
            c, e = cents[b], etas_b[b]
            th1 = c[None, :].expand(n_th, n_th)
            th2 = th1.T
            tau_inv = torch.floor((e[:, None, None] * (th1 ** 2 - th2 ** 2)
                                   - tau_a[0] + dtau / 2) / dtau).long()
            fd_inv = torch.floor(((th1 - th2) - fd_a[0] + dfd / 2)
                                 / dfd).long()
            pnts = ((tau_inv > 0) & (tau_inv < ntau)
                    & ((fd_inv < nfd) & (fd_inv >= -nfd))[None])
            idx = torch.where(pnts, tau_inv, 0) * nfd + (fd_inv % nfd)[None]
            thth = CS_c[b][idx]
            thth.masked_fill_(~pnts, 0)
            w = (torch.sqrt(e.abs())[:, None, None]
                 * torch.sqrt((2 * (th2 - th1)).abs())[None])
            thth.mul_(w.to(torch.float32))
            thth.masked_fill_(tril[None], 0)
            thth = thth + torch.conj(thth.transpose(1, 2))
            thth.masked_fill_(anti[None], 0)
            thth = torch.nan_to_num(thth)
            valid = ((c[None, :] ** 2 * e[:, None] < tau_max)
                     & (c.abs() < fd_half)[None])
            out[b] = thth * (valid[:, None, :] & valid[:, :, None])
        return out

    if method == "auto":
        solver = (batched_eig_warmstart if eig == "kernel"
                  else batched_eig_warmstart_plain)
        n_pad = pad_to_multiple(n_th)

        def fn(CS_ri, edges_b, etas_b):
            thth = build(CS_ri, edges_b, etas_b)
            B, neta = thth.shape[:2]
            a_ri = torch.zeros((B, neta, 2, n_pad, n_pad),
                               dtype=torch.float32, device=dev)
            a_ri[:, :, 0, :n_th, :n_th] = thth.real
            a_ri[:, :, 1, :n_th, :n_th] = thth.imag
            del thth
            return solver(a_ri, n_th // 2).abs()
    else:
        def fn(CS_ri, edges_b, etas_b):
            lam, _ = dominant_eig_power(build(CS_ri, edges_b, etas_b),
                                        iters=iters)
            return lam.abs()

    fn.build = build
    return fn


def _thin_gram(a):
    """Two-curve stack ``a[..., n2, n1]`` → ``(AᴴA[..., n1, n1],
    scale[...])`` with each matrix first divided by its largest modulus
    (floored at 1e-30), so the float32 product cannot overflow."""
    scale = a.abs().amax(dim=(-2, -1)).clamp(min=1e-30)
    an = a / scale[..., None, None]
    return torch.matmul(an.conj().transpose(-2, -1), an), scale


def _thin_sigma(gram, scale, iters):
    """Largest singular value σ = √|λ_max(AᴴA)|, scaled back."""
    lam, _ = dominant_eig_power(gram, iters=iters)
    return torch.sqrt(lam.abs()) * scale


def pad_arclet_edges(rows, edges_max):
    """Arclet edge rows of different lengths → one (rows, widest) array:
    each row padded with large ascending values (10⁶·max(1, ``edges_max``)
    times 1, 2, …), whose bin centres fail every η's validity mask in
    :func:`make_thin_grid_eval_fn` and so leave σ unchanged."""
    n = max(len(r) for r in rows)
    big = 1e6 * max(1.0, float(edges_max))
    return np.stack([np.concatenate([np.asarray(r, dtype=float),
                                     big * (1 + np.arange(n - len(r)))])
                     for r in rows])


def make_thin_grid_eval_fn(tau, fd, n_edges, n_arclet_edges, center_cut,
                           iters=200, device=None):
    """Whole-chunk-grid thin-screen η search with per-chunk geometry:
    ``fn(CS_ri[B, 2, ntau, nfd], edges[B, n_edges],
    edges_arclet[B, n_arclet_edges], etas[B, neta]) → σ[B, neta]`` on
    ``device`` (``None``: the CUDA card); the thin counterpart of
    :func:`make_grid_eval_fn`, with the math of
    :func:`make_thin_eval_fn`. Rows whose arclet edges are fewer than
    ``n_arclet_edges`` come padded by :func:`pad_arclet_edges`.
    ``fn.build(CS_ri, edges, edges_arclet, etas)`` is the gather alone,
    (B, neta, n2, n1) complex64."""
    dev = resolve_device(device)
    tau_a = np.asarray(unit_checks(tau, "tau"), dtype=float)
    fd_a = np.asarray(unit_checks(fd, "fd"), dtype=float)
    dtau = np.diff(tau_a).mean()
    dfd = np.diff(fd_a).mean()
    ntau, nfd = len(tau_a), len(fd_a)
    n1, n2 = int(n_edges) - 1, int(n_arclet_edges) - 1
    center_cut = float(unit_checks(center_cut, "center_cut"))
    tau_max = float(np.abs(tau_a.max()))

    def build(CS_ri, edges_b, arclet_b, etas_b):
        CS_c, etas_b, edges_b, arclet_b = _grid_inputs(
            CS_ri, etas_b, dev, edges_b, arclet_b)
        c1s, c2s = _recentred_cents(edges_b), _recentred_cents(arclet_b)
        B, neta = etas_b.shape
        out = torch.empty((B, neta, n2, n1), dtype=torch.complex64,
                          device=dev)
        for b in range(B):
            c1, c2, e = c1s[b], c2s[b], etas_b[b]
            th1 = c1[None, :].expand(n2, n1)
            th2 = c2[:, None].expand(n2, n1)
            tau_inv = torch.floor((e[:, None, None] * (th1 ** 2 - th2 ** 2)
                                   - tau_a[1] + dtau / 2) / dtau).long()
            fd_inv = torch.floor((th1 - th2 - fd_a[1] + dfd / 2)
                                 / dfd).long()
            fd_ok = (fd_inv < nfd - 1) & (fd_inv >= -nfd)
            pnts = (tau_inv > 0) & (tau_inv < ntau - 1) & fd_ok[None]
            idx = torch.where(pnts, tau_inv, 0) * nfd + (fd_inv % nfd)[None]
            thth = CS_c[b][idx]
            thth.masked_fill_(~pnts, 0)
            w = (torch.sqrt(2.0 * e.abs())[:, None, None]
                 * torch.sqrt((th1 - th2).abs())[None])
            thth = torch.nan_to_num(thth * w.to(torch.float32))
            lim = torch.sqrt(tau_max / e)
            ok1 = ((c1.abs()[None, :] < lim[:, None])
                   & (c1.abs() >= center_cut)[None, :])
            ok2 = c2.abs()[None, :] < lim[:, None]
            out[b] = thth * (ok2[:, :, None] & ok1[:, None, :])
        return out

    def fn(CS_ri, edges_b, arclet_b, etas_b):
        return _thin_sigma(*_thin_gram(build(CS_ri, edges_b, arclet_b,
                                             etas_b)), iters)

    fn.build = build
    return fn


def make_thin_eval_fn(tau, fd, edges, edges_arclet, center_cut, iters=200,
                      device=None):
    """Build ``fn(CS_ri[B, 2, ntau, nfd], etas[neta]) → σ[B, neta]`` for
    the two-curvature (thin-screen) search on ``device`` (``None``: the
    CUDA card): the largest singular value of the two-curve θ-θ (main
    arc and arclets at the same η) per (chunk, η).

    The reference crops the two-curve θ-θ to the valid θ of each η; here
    the invalid rows and columns are zeroed instead (zero rows and
    columns leave the singular values unchanged), so every η has one
    fixed shape. σ is √λ_max(AᴴA) by ``iters`` cold power steps on the
    (n1 × n1) Gram matrix. The stages are ``fn.build(CS_ri, etas)``
    (the masked gather, (B, neta, n2, n1) complex64), ``fn.gram(a)`` →
    ``(gram, scale)`` and ``fn.solve(gram, scale)`` → σ."""
    dev = resolve_device(device)
    tau_a, fd_a, c1 = _geometry(tau, fd, edges)
    c2 = th_cents_from_edges(np.asarray(
        unit_checks(edges_arclet, "edges_arclet"), dtype=float))
    center_cut = float(unit_checks(center_cut, "center_cut"))
    n1, n2 = len(c1), len(c2)
    ntau, nfd = len(tau_a), len(fd_a)
    th1 = np.ones((n2, n1)) * c1[None, :]
    th2 = np.ones((n2, n1)) * c2[:, None]
    dtau = np.diff(tau_a).mean()
    dfd = np.diff(fd_a).mean()
    # fd_inv does not depend on η; the two-curve map's offsets are
    # tau[1] and fd[1] and its bounds len - 1 (core.two_curve_map)
    fd_inv = np.floor((th1 - th2 - fd_a[1] + dfd / 2) / dfd).astype(int)

    def on(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    dth2 = on(th1 ** 2 - th2 ** 2, torch.float64)
    fd_ok = on((fd_inv < nfd - 1) & (fd_inv >= -nfd))
    fd_wrap = on(fd_inv % nfd, torch.int64)
    w_th = on(np.sqrt(np.abs(th1 - th2)), torch.float64)
    abs_c1 = on(np.abs(c1), torch.float64)
    abs_c2 = on(np.abs(c2), torch.float64)
    cut = on(np.abs(c1) >= center_cut)
    tau_max = float(np.abs(tau_a.max()))

    def build(CS_ri, etas):
        e = torch.as_tensor(etas, dtype=torch.float64, device=dev)
        CS_c = torch.complex(CS_ri[:, 0], CS_ri[:, 1]).reshape(
            CS_ri.shape[0], -1)
        tau_inv = torch.floor((e[:, None, None] * dth2 - tau_a[1]
                               + dtau / 2) / dtau).to(torch.int64)
        pnts = (tau_inv > 0) & (tau_inv < ntau - 1) & fd_ok[None]
        idx = torch.where(pnts, tau_inv, 0) * nfd + fd_wrap[None]
        thth = CS_c[:, idx]                             # (B, neta, n2, n1)
        thth.masked_fill_(~pnts[None], 0)
        w = torch.sqrt(2.0 * e.abs())[:, None, None] * w_th[None]
        thth.mul_(w.to(torch.float32)[None])
        thth = torch.nan_to_num(thth)
        # the per-η valid-θ masks replace the reference's crop
        lim = torch.sqrt(tau_max / e)
        ok1 = (abs_c1[None, :] < lim[:, None]) & cut[None, :]
        ok2 = abs_c2[None, :] < lim[:, None]
        thth.mul_((ok2[:, :, None] & ok1[:, None, :])[None])
        return thth

    def solve(gram, scale):
        return _thin_sigma(gram, scale, iters)

    def fn(CS_ri, etas):
        return solve(*_thin_gram(build(CS_ri, etas)))

    fn.build, fn.gram, fn.solve = build, _thin_gram, solve
    fn.n1, fn.n2 = n1, n2
    return fn


def _chunk_cs_to_ri(dspecs, npad, tau_keep, coher, power=False,
                    cs_method="rfft"):
    """Raw chunk stack → packed (real, imag) float32 conjugate spectra
    plus the per-chunk input / CS health flags. Non-finite input pixels
    are flagged and zeroed before the FFT so a corrupt chunk stays
    bounded to its own lane. ``power`` selects the incoherent base:
    |CS| for the single-curve search, |CS|² for the thin-screen search;
    ``cs_method`` the ``ops.cs`` choice. Returns ``(cs_ri[B, 2, ntau,
    nfd], in_ok[B], cs_ok[B])``."""
    in_ok = guards.chunk_finite_ok(dspecs)
    dspecs = guards.sanitize_chunks(dspecs)
    CS = chunk_conjugate_spectrum_batch(dspecs, npad=npad,
                                        tau_keep=tau_keep, method=cs_method)
    if not coher:
        CS = CS.abs() ** 2 if power else CS.abs()
    imag = CS.imag if CS.is_complex() else torch.zeros_like(CS)
    cs_ri = torch.stack([CS.real, imag], dim=1).to(torch.float32)
    return cs_ri, in_ok, guards.chunk_finite_ok(cs_ri)


def _tau_keep_mask(tau, tau_mask):
    tau_a = np.asarray(unit_checks(tau, "tau"), dtype=float)
    if not tau_mask:
        return tau_a, None
    return tau_a, np.abs(tau_a) >= float(unit_checks(tau_mask))


def _health_and_quarantine(curves, in_ok, cs_ok, fit_ok, eta, sig, popt):
    """Per-chunk ``ok[B]`` int32 bitmask; NaN the fitted outputs of
    input-corrupt lanes (a finite-looking η of a sanitised corrupt
    chunk must never reach the global η(f) fit)."""
    ok = guards.health_code(input_ok=in_ok, cs_ok=cs_ok,
                            curve_ok=guards.curve_health(curves),
                            fit_ok=fit_ok)
    healthy_in = in_ok & cs_ok
    nan = torch.tensor(float("nan"), dtype=eta.dtype, device=eta.device)
    eta = torch.where(healthy_in, eta, nan)
    sig = torch.where(healthy_in, sig, nan)
    popt = torch.where(healthy_in[:, None], popt, nan)
    return eta, sig, popt, ok


def make_fused_search_fn(tau, fd, edges, nf, nt, npad=3, coher=True,
                         tau_mask=0.0, fw=0.1, iters=200, method="auto",
                         squarings=10, warm_iters=None, eig="kernel",
                         device=None):
    """The whole per-row curvature search as chained functions on
    ``device`` (``None``: the CUDA card): ``fn(dspecs[B, nf, nt]
    float32, etas[neta]) → (eigs[B, neta], eta[B], eta_sig[B],
    popt[B, 3], ok[B])``.

    mean-pad → rfft2 conjugate spectrum (+ health guards) → masked
    θ-θ gather → eigen curve (:func:`make_multi_eval_fn` with ``method``,
    ``iters``, ``squarings``, ``warm_iters`` and ``eig``) → closed-form
    parabola peak fit → health bitmask and quarantine, the four stages
    in the program spans ``thth.cs``, ``thth.gather``, ``thth.eig`` and
    ``thth.peak``, each timed on the device too while a profiler runs
    (``obs.trace.span``). The geometry is
    baked in on the host; the raw chunk stack is the only host→device
    copy. ``warm_iters=None`` takes the JAX package's per-method
    default: 64 for the ``"warm"`` η-scan (it has no restarts), 24
    otherwise. ``"auto"`` and the conjugate spectrum resolve the
    ``thth.eig`` and ``ops.cs`` formulations on ``device`` when the
    function is built."""
    check_method(method)
    device = resolve_device(device)
    method = resolve_fused_method(method, len(edges), device.type)
    cs_method = formulation("ops.cs", device.type)
    tau_a, tau_keep = _tau_keep_mask(tau, tau_mask)
    if len(tau_a) != (npad + 1) * nf:
        raise ValueError(
            f"tau length {len(tau_a)} != (npad+1)*nf = "
            f"{(npad + 1) * nf} — tau/fd must be the fft_axis of the "
            "chunk axes at this npad")
    if warm_iters is None:
        warm_iters = 64 if method == "warm" else 24
    multi = make_multi_eval_fn(tau, fd, edges, iters=iters, method=method,
                               squarings=squarings, warm_iters=warm_iters,
                               eig=eig, device=device)

    def fn(dspecs, etas):
        with _trace.span("thth.cs", device=device):
            cs_ri, in_ok, cs_ok = _chunk_cs_to_ri(dspecs, npad, tau_keep,
                                                  coher, cs_method=cs_method)
        with _trace.span("thth.gather", device=device):
            a = multi.gather(cs_ri, etas)
        with _trace.span("thth.eig", device=device):
            eigs = multi.solve(a)
        with _trace.span("thth.peak", device=device):
            eta, sig, popt, fit_ok = fit_eig_peak_batch_device(
                etas, eigs, fw=fw, with_ok=True)
            eta, sig, popt, ok = _health_and_quarantine(
                eigs, in_ok, cs_ok, fit_ok, eta, sig, popt)
        return eigs, eta, sig, popt, ok

    return fn


def make_fused_thin_search_fn(tau, fd, edges, edges_arclet, center_cut, nf,
                              nt, npad=3, coher=True, tau_mask=0.0, fw=0.1,
                              iters=200, device=None):
    """Thin-screen counterpart of :func:`make_fused_search_fn` on
    ``device`` (``None``: the CUDA card): ``fn(dspecs[B, nf, nt],
    etas[neta]) → (σ[B, neta], eta[B], eta_sig[B], popt[B, 3], ok[B])``.
    Raw chunks in; mean-pad → rfft2 conjugate spectrum (|CS|² with
    ``coher=False``) → :func:`make_thin_eval_fn` → closed-form peak fit
    → health bitmask out; the spans are the standard search's, with the
    two-curve θ-θ and its Gram as ``thth.gather`` and the power steps
    as ``thth.eig``. ``fn.thin`` is the evaluator, for timing its
    stages."""
    device = resolve_device(device)
    tau_a, tau_keep = _tau_keep_mask(tau, tau_mask)
    if len(tau_a) != (npad + 1) * nf:
        raise ValueError(
            f"tau length {len(tau_a)} != (npad+1)*nf = "
            f"{(npad + 1) * nf}")
    thin = make_thin_eval_fn(tau, fd, edges, edges_arclet, center_cut,
                             iters=iters, device=device)
    cs_method = formulation("ops.cs", device.type)

    def fn(dspecs, etas):
        with _trace.span("thth.cs", device=device):
            cs_ri, in_ok, cs_ok = _chunk_cs_to_ri(
                dspecs, npad, tau_keep, coher, power=True,
                cs_method=cs_method)
        with _trace.span("thth.gather", device=device):
            gram, scale = thin.gram(thin.build(cs_ri, etas))
        with _trace.span("thth.eig", device=device):
            sigs = thin.solve(gram, scale)
        with _trace.span("thth.peak", device=device):
            eta, sig, popt, fit_ok = fit_eig_peak_batch_device(
                etas, sigs, fw=fw, with_ok=True)
            eta, sig, popt, ok = _health_and_quarantine(
                sigs, in_ok, cs_ok, fit_ok, eta, sig, popt)
        return sigs, eta, sig, popt, ok

    fn.thin = thin
    return fn


def make_fused_grid_eval_fn(tau, fd, n_edges, nf, nt, npad=3, coher=True,
                            tau_mask=0.0, fw=0.1, iters=200, method="power",
                            eig="kernel", device=None):
    """Fused whole-chunk-grid search with per-chunk geometry on
    ``device`` (``None``: the CUDA card): ``fn(dspecs[B, nf, nt],
    edges[B, n_edges], etas[B, neta]) → (|λ|[B, neta], eta[B],
    eta_sig[B], popt[B, 3], ok[B])``; the per-chunk-geometry counterpart
    of :func:`make_fused_search_fn` over :func:`make_grid_eval_fn`
    (``method`` and ``eig`` as there)."""
    device = resolve_device(device)
    tau_a, tau_keep = _tau_keep_mask(tau, tau_mask)
    if len(tau_a) != (npad + 1) * nf:
        raise ValueError(
            f"tau length {len(tau_a)} != (npad+1)*nf = "
            f"{(npad + 1) * nf}")
    grid = make_grid_eval_fn(tau, fd, n_edges, iters=iters, method=method,
                             eig=eig, device=device)
    cs_method = formulation("ops.cs", device.type)

    def fn(dspecs, edges_b, etas_b):
        cs_ri, in_ok, cs_ok = _chunk_cs_to_ri(dspecs, npad, tau_keep,
                                              coher, cs_method=cs_method)
        eigs = grid(cs_ri, edges_b, etas_b)
        eta, sig, popt, fit_ok = fit_eig_peak_batch_device(
            etas_b, eigs, fw=fw, with_ok=True)
        eta, sig, popt, ok = _health_and_quarantine(
            eigs, in_ok, cs_ok, fit_ok, eta, sig, popt)
        return eigs, eta, sig, popt, ok

    fn.grid = grid
    return fn


def make_fused_thin_grid_eval_fn(tau, fd, n_edges, n_arclet_edges,
                                 center_cut, nf, nt, npad=3, coher=True,
                                 tau_mask=0.0, fw=0.1, iters=200,
                                 device=None):
    """Fused whole-chunk-grid thin-screen search with per-chunk geometry
    on ``device`` (``None``: the CUDA card): ``fn(dspecs[B, nf, nt],
    edges[B, n_edges], edges_arclet[B, n_arclet_edges], etas[B, neta])
    → (σ[B, neta], eta[B], eta_sig[B], popt[B, 3], ok[B])``; the
    per-chunk-geometry counterpart of :func:`make_fused_thin_search_fn`
    over :func:`make_thin_grid_eval_fn` (the port's own: the sharded
    façade's thin fit, whose chunks then get the row search's η)."""
    device = resolve_device(device)
    tau_a, tau_keep = _tau_keep_mask(tau, tau_mask)
    if len(tau_a) != (npad + 1) * nf:
        raise ValueError(
            f"tau length {len(tau_a)} != (npad+1)*nf = "
            f"{(npad + 1) * nf}")
    thin = make_thin_grid_eval_fn(tau, fd, n_edges, n_arclet_edges,
                                  center_cut, iters=iters, device=device)
    cs_method = formulation("ops.cs", device.type)

    def fn(dspecs, edges_b, arclet_b, etas_b):
        cs_ri, in_ok, cs_ok = _chunk_cs_to_ri(dspecs, npad, tau_keep, coher,
                                              power=True, cs_method=cs_method)
        sigs = thin(cs_ri, edges_b, arclet_b, etas_b)
        eta, sig, popt, fit_ok = fit_eig_peak_batch_device(
            etas_b, sigs, fw=fw, with_ok=True)
        eta, sig, popt, ok = _health_and_quarantine(
            sigs, in_ok, cs_ok, fit_ok, eta, sig, popt)
        return sigs, eta, sig, popt, ok

    fn.thin = thin
    return fn
