"""Plain reference of a θ-θ curvature observation: what
``Dynspec.calc_sspec → prep_thetatheta → fit_thetatheta`` computes, in
float64 (or, for the control, in a lower :class:`~.common.Precision`).

The method is the one of upstream scintools (``dynspec.py``
``prep_thetatheta`` / ``fit_thetatheta``, ``ththmod.py``): the
dynamic spectrum is cut into chunks of ``cwf × cwt``; each chunk, less
its mean and padded with ``npad`` copies of it, gives the conjugate
spectrum; for every trial curvature η of its frequency row (a
log-spaced grid scaled by η ∝ f⁻²) the θ-θ matrix is gathered from it
over θ bins from ``edges`` scaled by θ ∝ f; its largest eigenvalue
(standard screen) or the largest singular value of the two-curve θ-θ
(thin screen) traces a curve over η whose peak, fitted by a parabola
within ``fw`` of the highest point, is the chunk's η and error. The
per-chunk η, weighted by their errors, fit η ∝ f⁻² at the mean
frequency: ``ththeta`` and ``ththetaerr``.

Two choices are the port's, kept so that the same observation gives
the same answer: the θ-θ of an η is held at one fixed size with the
rows and columns outside its valid square set to zero (the upstream
code crops them; a zero row adds a zero eigenvalue, and the largest
eigenvalue of a matrix with a zero trace is never below zero, so the
value is the same), and the parabola is the least-squares fit of the
points in the window (upstream fits the same model by ``curve_fit``).
The health bits are those of the program's ``robust/guards.py``
(1 input not finite, 2 conjugate spectrum not finite, 4 curve flat or
under three points, 8 peak fit refused). The eigenvalues come from
Lanczos with full reorthogonalisation (:func:`.common.lanczos_top`),
not from the program's power iterations.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import Precision, fft_axis, lanczos_top, sspec_db

BAD_INPUT, BAD_CS, BAD_CURVE, BAD_PEAKFIT = 1, 2, 4, 8


def th_cents(edges):
    """θ bin centres of ``edges``, re-centred on the bin nearest zero."""
    edges = np.asarray(edges, dtype=float)
    c = (edges[1:] + edges[:-1]) / 2
    return c - c[np.argmin(np.abs(c))]


def chunk_spectra(chunks, npad, P):
    """Conjugate spectra ``(B, (1+npad)·cf, (1+npad)·ct)`` of the chunk
    stack ``chunks[B, cf, ct]``: each padded with its own mean, fft2,
    centred."""
    x = P(chunks)
    mu = x.mean(dim=(1, 2), keepdim=True)
    cf, ct = x.shape[1:]
    padded = torch.nn.functional.pad(x - mu, (0, npad * ct, 0, npad * cf)) + mu
    return P(torch.fft.fftshift(torch.fft.fft2(padded), dim=(1, 2)))


def _gather(CS, tau_inv, fd_inv, pnts):
    nfd = CS.shape[-1]
    idx = torch.where(pnts, tau_inv, 0) * nfd + torch.remainder(fd_inv, nfd)
    flat = CS.reshape(CS.shape[0], -1)
    out = flat[:, idx.reshape(-1)].reshape((CS.shape[0],) + idx.shape)
    return torch.where(pnts, out, 0)


def thth_stack(CS, tau, fd, etas, edges, P):
    """Standard-screen θ-θ matrices ``(B, neta, n, n)`` of the conjugate
    spectra ``CS[B, ntau, nfd]`` at every η of ``etas``: hermitian, zero
    diagonal and anti-diagonal, zero outside the valid square."""
    dev = CS.device
    c = th_cents(edges)
    n = len(c)
    ntau, nfd = len(tau), len(fd)
    dtau, dfd = np.diff(tau).mean(), np.diff(fd).mean()
    th1 = torch.as_tensor(np.broadcast_to(c[None, :], (n, n)).copy(),
                          device=dev)
    th2 = th1.T
    e = torch.as_tensor(np.asarray(etas, dtype=float), device=dev)
    tau_inv = torch.floor((e[:, None, None] * (th1 ** 2 - th2 ** 2)
                           - tau[0] + dtau / 2) / dtau).long()
    fd_inv = torch.floor(((th1 - th2) - fd[0] + dfd / 2) / dfd).long()
    pnts = ((tau_inv > 0) & (tau_inv < ntau)
            & ((fd_inv < nfd) & (fd_inv >= -nfd))[None])
    a = _gather(CS, tau_inv, fd_inv.expand_as(tau_inv), pnts)
    w = torch.sqrt((2 * e[:, None, None] * (th2 - th1)[None]).abs())
    a = P(a * w.to(P.real))
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool, device=dev), 1)
    a = torch.where(upper, a, 0)
    a = a + a.conj().transpose(-2, -1)
    anti = torch.as_tensor(np.eye(n)[::-1] > 0, device=dev)
    a = torch.nan_to_num(torch.where(anti, 0, a))
    ct = torch.as_tensor(c, device=dev)
    valid = ((ct[None, :] ** 2 * e[:, None] < np.abs(tau.max()))
             & (ct.abs() < np.abs(fd.max()) / 2)[None])
    return P(a * (valid[:, :, None] & valid[:, None, :])[None])


def thin_stack(CS, tau, fd, etas, edges, edges_arclet, center_cut, P):
    """Two-curve (thin-screen) θ-θ ``(B, neta, n2, n1)`` of the main arc
    over ``edges`` and the arclets over ``edges_arclet`` at the same η,
    the rows and columns outside each η's valid θ set to zero."""
    dev = CS.device
    c1, c2 = th_cents(edges), th_cents(edges_arclet)
    n1, n2 = len(c1), len(c2)
    ntau, nfd = len(tau), len(fd)
    dtau, dfd = np.diff(tau).mean(), np.diff(fd).mean()
    th1 = torch.as_tensor(np.broadcast_to(c1[None, :], (n2, n1)).copy(),
                          device=dev)
    th2 = torch.as_tensor(np.broadcast_to(c2[:, None], (n2, n1)).copy(),
                          device=dev)
    e = torch.as_tensor(np.asarray(etas, dtype=float), device=dev)
    tau_inv = torch.floor((e[:, None, None] * (th1 ** 2 - th2 ** 2)
                           - tau[1] + dtau / 2) / dtau).long()
    fd_inv = torch.floor((th1 - th2 - fd[1] + dfd / 2) / dfd).long()
    pnts = ((tau_inv > 0) & (tau_inv < ntau - 1)
            & ((fd_inv < nfd - 1) & (fd_inv >= -nfd))[None])
    a = _gather(CS, tau_inv, fd_inv.expand_as(tau_inv), pnts)
    w = (torch.sqrt(2 * e.abs())[:, None, None]
         * torch.sqrt((th1 - th2).abs())[None])
    a = torch.nan_to_num(P(a * w.to(P.real)))
    lim = torch.sqrt(np.abs(tau.max()) / e)
    a1 = torch.as_tensor(np.abs(c1), device=dev)
    a2 = torch.as_tensor(np.abs(c2), device=dev)
    ok1 = (a1[None, :] < lim[:, None]) & (a1 >= center_cut)[None, :]
    ok2 = a2[None, :] < lim[:, None]
    return P(a * (ok2[:, :, None] & ok1[:, None, :])[None])


def peak_fit(etas, curves, fw):
    """Parabola fit of each curve ``curves[B, neta]`` over ``etas``:
    the points within ``fw``·η of the curve's first highest finite point,
    least squares of A(η − η₀)² + C. Returns ``(eta[B], sig[B], ok[B])``:
    η₀, √(std(residual)/|A|), and whether the fit stands (three finite
    points and three in the window, finite, vertex within twice the
    window's half-width of the peak)."""
    etas = np.asarray(etas, dtype=float)
    B = curves.shape[0]
    eta = np.full(B, np.nan)
    sig = np.full(B, np.nan)
    ok = np.zeros(B, dtype=bool)
    for b in range(B):
        y = np.asarray(curves[b], dtype=float)
        fin = np.isfinite(y)
        if fin.sum() < 3:
            continue
        pk = int(np.argmax(np.where(fin, y, -np.inf)))
        e_pk = etas[pk]
        s = fw * e_pk
        sel = fin & (np.abs(etas - e_pk) < s)
        if sel.sum() < 3:
            continue
        u = (etas[sel] - e_pk) / s
        c2, c1, c0 = np.polyfit(u, y[sel], 2)
        A = c2 / s ** 2
        x0 = e_pk - s * c1 / (2 * c2)
        res = y[sel] - (c2 * u ** 2 + c1 * u + c0)
        if not (np.isfinite(x0) and np.isfinite(A)
                and abs(x0 - e_pk) < 2 * s):
            continue
        eta[b], sig[b], ok[b] = x0, np.sqrt(np.std(res) / abs(A)), True
    return eta, sig, ok


def health(in_ok, cs_ok, curves, fit_ok):
    """The health bitmask of each chunk."""
    fin = np.isfinite(curves)
    hi = np.where(fin, curves, -np.inf).max(axis=1)
    lo = np.where(fin, curves, np.inf).min(axis=1)
    curve_ok = (fin.sum(axis=1) >= 3) & (hi > lo)
    return (np.where(in_ok, 0, BAD_INPUT) | np.where(cs_ok, 0, BAD_CS)
            | np.where(curve_ok, 0, BAD_CURVE)
            | np.where(fit_ok, 0, BAD_PEAKFIT))


def global_fit(eta_evo, eta_evo_err, f0s, fref):
    """The error-weighted fit of η ∝ f⁻² over every chunk with a finite
    η and error: ``(ththeta, ththetaerr)`` at ``fref``."""
    f = np.asarray(f0s, dtype=float)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        use = np.isfinite(eta_evo) & np.isfinite(eta_evo_err)
        A = (np.sum(eta_evo[use] / (f * eta_evo_err)[use] ** 2)
             / np.sum(1 / ((f ** 2) * eta_evo_err)[use] ** 2))
        A_err = np.sqrt(1 / np.sum(2 / ((f ** 2) * eta_evo_err)[use] ** 2))
    return A / fref ** 2, A_err / fref ** 2


def _held(P, x):
    """Numpy ``x`` as ``P`` holds it, back in float64."""
    return P(torch.as_tensor(np.asarray(x, dtype=float))).double().numpy()


def row_curves(chunks, freq, time, etas, edges, prep, P, steps=48):
    """Curves ``[B, neta]`` of the chunks of one frequency row, with the
    input and conjugate-spectrum health flags and the largest Lanczos
    bound relative to its eigenvalue."""
    npad = int(prep["npad"])
    in_ok = torch.isfinite(chunks).flatten(1).all(dim=1)
    chunks = torch.where(torch.isfinite(chunks), chunks, 0)
    CS = chunk_spectra(chunks, npad, P)
    cs_ok = torch.isfinite(torch.view_as_real(CS)).flatten(1).all(dim=1)
    tau = fft_axis(freq, pad=npad, scale=1.0)
    fd = fft_axis(time, pad=npad, scale=1e3)
    B, neta = chunks.shape[0], len(etas)
    if prep.get("fitting_proc", "standard") == "thin":
        lim = float(prep.get("arclet_lim", prep["edges_lim"]))
        a = thin_stack(CS, tau, fd, etas, edges,
                       edges[np.abs(edges) < lim],
                       float(prep.get("center_cut", 0.0)), P)
        a = P(a.conj().transpose(-2, -1) @ a)
    else:
        a = thth_stack(CS, tau, fd, etas, edges, P)
    a = a.reshape((B * neta,) + a.shape[2:])
    lam, bound = lanczos_top(a, P, steps)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.nanmax(bound / np.abs(lam)) if np.any(lam) else 0.0
    while rel > 1e-7 and steps < a.shape[-1]:
        # far from converged: twice the steps, up to the matrices' size
        steps = min(2 * steps, a.shape[-1])
        lam, bound = lanczos_top(a, P, steps)
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.nanmax(bound / np.abs(lam)) if np.any(lam) else 0.0
    if prep.get("fitting_proc", "standard") == "thin":
        lam = np.sqrt(np.abs(lam))
    curves = _held(P, np.abs(lam).reshape(B, neta))
    return curves, in_ok.cpu().numpy(), cs_ok.cpu().numpy(), rel


def observation(dyn, freqs, times, prep, precision="float64", device=None,
                with_sspec=True):
    """Everything the façade's observation yields, from the dynamic
    spectrum ``dyn[nf, nt]`` (numpy float64) with axes ``freqs`` [MHz]
    and ``times`` [s], under the ``prep`` parameters (``cwf``, ``cwt``,
    ``npad``, ``eta_min``, ``eta_max``, ``neta``, ``nedge``,
    ``edges_lim``, ``fw``, ``fitting_proc`` and for the thin screen
    ``arclet_lim``, ``center_cut``). Returns a dict: ``sspec`` (a tensor
    on ``device``, dB), ``eta_evo``, ``eta_evo_err``, ``eta_evo_ok``,
    ``f0s``, ``fref``, ``ththeta``, ``ththetaerr`` and
    ``lanczos_bound``, the largest Lanczos residual bound relative to its
    eigenvalue. In a lower precision every array kept (the curves, the
    per-chunk η and errors, the global fit) is held in it too."""
    P = Precision(precision)
    dev = torch.device(device) if device is not None else torch.device("cpu")
    freqs = np.asarray(freqs, dtype=float)
    times = np.asarray(times, dtype=float)
    d = torch.as_tensor(np.asarray(dyn, dtype=float), device=dev)
    out = {}
    if with_sspec:
        out["sspec"] = sspec_db(d, P)
    cwf, cwt = 2 * (int(prep["cwf"]) // 2), 2 * (int(prep["cwt"]) // 2)
    ncf, nct = d.shape[0] // cwf, d.shape[1] // cwt
    fref = float(freqs.mean())
    fw = float(prep.get("fw", 0.1))
    base_etas = np.logspace(np.log10(prep["eta_min"]),
                            np.log10(prep["eta_max"]), int(prep["neta"]))
    edges = np.linspace(-prep["edges_lim"], prep["edges_lim"],
                        int(prep["nedge"]))
    eta_evo = np.zeros((ncf, nct))
    eta_err = np.zeros((ncf, nct))
    eta_ok = np.zeros((ncf, nct), dtype=int)
    f0s = np.zeros(ncf)
    worst = 0.0
    for cf in range(ncf):
        fs = slice(cf * cwf, (cf + 1) * cwf)
        chunks = []
        for ct in range(nct):
            c = d[fs, ct * cwt:(ct + 1) * cwt]
            chunks.append(torch.nan_to_num(c - c.nanmean()))
        chunks = torch.stack(chunks)
        freq2 = freqs[fs]
        f0s[cf] = freq2.mean()
        etas = base_etas * (fref / f0s[cf]) ** 2
        row_edges = edges * (f0s[cf] / fref)
        curves, in_ok, cs_ok, rel = row_curves(
            chunks, freq2, times[:cwt], etas, row_edges, prep, P)
        worst = max(worst, float(rel))
        eta, sig, fit_ok = peak_fit(etas, curves, fw)
        ok = health(in_ok, cs_ok, curves, fit_ok)
        bad_in = (ok & (BAD_INPUT | BAD_CS)) != 0
        eta_evo[cf] = _held(P, np.where(bad_in, np.nan, eta))
        eta_err[cf] = _held(P, np.where(bad_in, np.nan, sig))
        eta_ok[cf] = ok
    th, th_err = _held(P, global_fit(eta_evo, eta_err, f0s, fref))
    out.update(eta_evo=eta_evo, eta_evo_err=eta_err, eta_evo_ok=eta_ok,
               f0s=f0s, fref=fref, ththeta=float(th), ththetaerr=float(th_err),
               lanczos_bound=worst)
    return out
