"""Chunk-batched θ-θ curvature search in PyTorch.

Counterpart of ``scintools_tpu/thth/batch.py``: ``_geometry`` (:47),
``make_multi_eval_fn`` (:55; the ``build_batch`` gather :92-127, the
``'power'`` route :129-142, then the kernel route :189-217),
``_chunk_cs_to_ri`` (:478), ``_tau_keep_mask`` (:506),
``_health_and_quarantine`` (:513) and ``make_fused_search_fn`` (:538).

All chunks of one frequency row share (tau, fd, edges, η grid), so the
θ-θ gather indices depend only on the geometry and η: they are built
once per call in float64 (a near-integer argument floored in float32
lands in the neighbouring bin and changes the matrix) and one gather
with the chunk as the minor axis fetches every chunk's value. The
matrices are then laid out chunk-major as (B, neta, 2, N, N) float32
for the warm-start eigensolver (thth/eig.py), which walks η in order
within each chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import resolve_device
from ..ops.sspec import chunk_conjugate_spectrum_batch
from ..robust import guards
from .core import dominant_eig_power, th_cents_from_edges, unit_checks
from .eig import (batched_eig_warmstart, batched_eig_warmstart_plain,
                  pad_to_multiple)
from .peakfit import fit_eig_peak_batch_device


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

    ``method="auto"`` walks each chunk's η grid with the warm-start
    eigensolver: ``fn.gather(CS_ri, etas)`` is the masked θ-θ gather,
    returning the padded (B, neta, 2, N, N) float32 batch;
    ``fn.solve(a_ri)`` the eigensolver on it. ``eig='kernel'``
    dispatches by device (:func:`batched_eig_warmstart`); ``eig='plain'``
    always runs the plain PyTorch version (the reference the kernel is
    held to). ``method="power"`` runs ``iters`` cold shifted power steps
    on every (chunk, η) matrix instead (JAX ``'power'``)."""
    if eig not in ("kernel", "plain"):
        raise ValueError(f"unknown eig {eig!r} (want 'kernel' or 'plain')")
    if method not in ("auto", "power"):
        raise ValueError(f"unknown method {method!r} (want 'auto' or "
                         "'power')")
    dev = resolve_device(device)
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
        def fn(CS_ri, etas):
            thth = build_batch(CS_ri, etas).permute(3, 0, 1, 2)
            lam, _ = dominant_eig_power(thth, iters=iters)
            return lam.abs()

        fn.build_batch, fn.n_th = build_batch, n_th
        return fn

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


def _chunk_cs_to_ri(dspecs, npad, tau_keep, coher):
    """Raw chunk stack → packed (real, imag) float32 conjugate spectra
    plus the per-chunk input / CS health flags. Non-finite input pixels
    are flagged and zeroed before the FFT so a corrupt chunk stays
    bounded to its own lane. Returns ``(cs_ri[B, 2, ntau, nfd],
    in_ok[B], cs_ok[B])``."""
    in_ok = guards.chunk_finite_ok(dspecs)
    dspecs = guards.sanitize_chunks(dspecs)
    CS = chunk_conjugate_spectrum_batch(dspecs, npad=npad,
                                        tau_keep=tau_keep, method="rfft")
    if not coher:
        CS = CS.abs()
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
                         tau_mask=0.0, fw=0.1, squarings=10, warm_iters=24,
                         eig="kernel", device=None):
    """The whole per-row curvature search as chained functions on
    ``device`` (``None``: the CUDA card): ``fn(dspecs[B, nf, nt]
    float32, etas[neta]) → (eigs[B, neta], eta[B], eta_sig[B],
    popt[B, 3], ok[B])``.

    mean-pad → rfft2 conjugate spectrum (+ health guards) → masked
    θ-θ gather → warm-start eigensolver → closed-form parabola peak fit
    → health bitmask and quarantine. The geometry is baked in on the
    host; the raw chunk stack is the only host→device copy. ``eig`` as
    in :func:`make_multi_eval_fn`."""
    device = resolve_device(device)
    tau_a, tau_keep = _tau_keep_mask(tau, tau_mask)
    if len(tau_a) != (npad + 1) * nf:
        raise ValueError(
            f"tau length {len(tau_a)} != (npad+1)*nf = "
            f"{(npad + 1) * nf} — tau/fd must be the fft_axis of the "
            "chunk axes at this npad")
    multi = make_multi_eval_fn(tau, fd, edges, squarings=squarings,
                               warm_iters=warm_iters, eig=eig, device=device)

    def fn(dspecs, etas):
        cs_ri, in_ok, cs_ok = _chunk_cs_to_ri(dspecs, npad, tau_keep,
                                              coher)
        eigs = multi(cs_ri, etas)
        eta, sig, popt, fit_ok = fit_eig_peak_batch_device(
            etas, eigs, fw=fw, with_ok=True)
        eta, sig, popt, ok = _health_and_quarantine(
            eigs, in_ok, cs_ok, fit_ok, eta, sig, popt)
        return eigs, eta, sig, popt, ok

    return fn
