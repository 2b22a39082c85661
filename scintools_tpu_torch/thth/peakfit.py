"""Closed-form batched parabola peak fit of the η-curvature search.

Counterpart of ``scintools_tpu/thth/peakfit.py:41``
(``fit_eig_peak_device``) and ``:123`` (``fit_eig_peak_batch_device``),
written batched over the chunk axis. The model ``A·(x-x0)² + C`` is a
quadratic that is linear in its coefficients, so the least-squares fit
is one NaN-masked 3×3 normal-equation solve per chunk, in scaled and
centred coordinates ``u = (η - η_pk)/(fw·η_pk)`` so it stays
conditioned in float32. Peak = first argmax over the finite values,
window ``|η - η_pk| < fw·η_pk``; NaN out when fewer than 3 finite or 3
window points, when the normal equations are singular, or when the
vertex lies farther than 2× the window half-width from the peak.

``torch.linalg.solve`` raises on a singular system where
``jnp.linalg.solve`` returns non-finite values, and the refusal gate
depends on the latter: the port uses ``solve_ex`` and sets the
coefficients of a singular lane to NaN.
"""

from __future__ import annotations

import torch


def fit_eig_peak_batch_device(etas, eigs, fw=0.1, with_ok=False):
    """``eigs[B, neta]`` with ``etas`` shared ``(neta,)`` or per-chunk
    ``(B, neta)`` → ``(eta[B], eta_sig[B], popt[B, 3])`` with
    ``popt = (A, x0, C)``, plus ``ok[B]`` bool with ``with_ok=True``.
    Works in the dtype of ``eigs``."""
    dt = eigs.dtype
    etas = torch.as_tensor(etas, dtype=dt, device=eigs.device)
    if etas.ndim == 1:
        etas = etas.expand_as(eigs)
    finite = torch.isfinite(eigs)
    n_fin = finite.sum(dim=1)
    inf = torch.tensor(float("inf"), dtype=dt, device=eigs.device)

    # first index of the max over the finite entries
    pk = torch.argmax(torch.where(finite, eigs, -inf), dim=1)
    e_pk = etas.gather(1, pk[:, None])                     # (B, 1)
    sel = finite & ((etas - e_pk).abs() < fw * e_pk)
    n_sel = sel.sum(dim=1)
    nf_ = n_sel.clamp(min=1).to(dt)

    zero = torch.zeros((), dtype=dt, device=eigs.device)
    s = fw * e_pk                                          # (B, 1)
    u = torch.where(sel, (etas - e_pk) / s, zero)
    ym = torch.where(sel, eigs, zero).sum(dim=1) / nf_
    y = torch.where(sel, eigs - ym[:, None], zero)
    u2 = u * u
    S1, S2 = u.sum(dim=1), u2.sum(dim=1)
    S3, S4 = (u2 * u).sum(dim=1), (u2 * u2).sum(dim=1)
    G = torch.stack([torch.stack([S4, S3, S2], dim=1),
                     torch.stack([S3, S2, S1], dim=1),
                     torch.stack([S2, S1, nf_], dim=1)], dim=1)
    r = torch.stack([(u2 * y).sum(dim=1), (u * y).sum(dim=1),
                     y.sum(dim=1)], dim=1)
    c, info = torch.linalg.solve_ex(G, r, check_errors=False)
    c = torch.where((info != 0)[:, None], torch.nan, c)
    c2, c1, c0 = c[:, 0], c[:, 1], c[:, 2]

    s = s[:, 0]
    e_pk = e_pk[:, 0]
    A = c2 / (s * s)
    x0 = e_pk - s * c1 / (2.0 * c2)
    C = ym + c0 - c1 * c1 / (4.0 * c2)

    fitv = c2[:, None] * u2 + c1[:, None] * u + c0[:, None]
    res = torch.where(sel, y - fitv, zero)
    r_mu = res.sum(dim=1) / nf_
    r_var = torch.where(sel, (res - r_mu[:, None]) ** 2,
                        zero).sum(dim=1) / nf_
    sig = torch.sqrt(torch.sqrt(r_var) / A.abs())

    ok = ((n_fin >= 3) & (n_sel >= 3) & torch.isfinite(x0)
          & torch.isfinite(A) & ((x0 - e_pk).abs() < 2.0 * s))
    nan = torch.tensor(float("nan"), dtype=dt, device=eigs.device)
    popt = torch.where(ok[:, None], torch.stack([A, x0, C], dim=1), nan)
    out = (torch.where(ok, x0, nan), torch.where(ok, sig, nan), popt)
    return out + (ok,) if with_ok else out


def fit_eig_peak_device(etas, eigs, fw=0.1, with_ok=False):
    """Single-curve form: ``(etas[neta], eigs[neta]) → (eta, eta_sig,
    popt[3])`` (plus ``ok``), as 0-d / 1-d tensors."""
    out = fit_eig_peak_batch_device(etas, eigs[None], fw=fw,
                                    with_ok=with_ok)
    return tuple(o[0] for o in out)
