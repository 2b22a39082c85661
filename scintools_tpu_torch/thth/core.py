"""θ-θ transform core: forward and inverse maps, the eigenvalue
curvature metric and the geometry helpers.

Counterpart of ``scintools_tpu/thth/core.py``: ``unit_checks`` (:32,
plain floats only — no astropy), ``fft_axis`` (:47),
``th_cents_from_edges`` (:59), ``thth_map`` (:67), ``redmap_mask``
(:117), ``thth_redmap`` (:128), ``rev_map`` (:151),
``dominant_eig_power`` (:225), ``eval_calc`` (:258), ``cs_to_ri``
(:274), ``make_eval_fn`` (:283), ``eval_calc_batch`` (:410),
``modeler`` (:440), ``chisq_calc`` (:468), ``two_curve_map`` (:480),
``singularvalue_calc`` (:520), ``min_edges`` (:532), ``len_arc``
(:546), ``arc_edges`` (:553) and ``ext_find`` (:570). The two-curve
map and its singular value stay host numpy in float64/complex128, as
in the JAX package: they are the oracle of the thin-screen search.
Units: tau µs, fd mHz, eta s³ (µs/mHz²), edges mHz.

The index maps and masks are built in float64 on the host with the
reference's formulas, so every bin matches; the gathers, scatters and
eigen-solves run in complex64 on the device. ``eval_calc_batch`` walks
the η grid as one chain of the warm-start eigensolver
(:func:`.eig.batched_eig_warmstart`, the hand-written kernel on a CUDA
device), as the JAX package's ``'pallas'`` route does on its TPU, unless
another ``method`` of :data:`.batch.METHODS` is asked for.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import fifo_cached, resolve_device

_EPS = 1e-30


def unit_checks(var, name=None, desired=None):
    """Coerce to a plain float/ndarray. A quantity with ``to_value``
    is converted to the ``desired`` unit when one is given; other
    objects with a ``.value`` give their value; plain numbers are
    assumed to be in canonical units."""
    if hasattr(var, "to_value") and desired is not None:
        try:
            return np.asarray(var.to_value(desired))
        except Exception:  # noqa: BLE001 — an inconvertible unit
            # keeps its bare value, as the JAX package does
            return np.asarray(getattr(var, "value", var))
    if hasattr(var, "value") and not isinstance(var, (int, float, complex,
                                                      np.ndarray)):
        return np.asarray(var.value)
    return var


def fft_axis(x, pad=0, scale=1.0):
    """Fourier-conjugate coordinates of a uniform axis ``x`` with
    ``pad`` extra copies of padding. ``scale`` converts units:
    time[s] → fd[mHz] uses 1e3; freq[MHz] → tau[us] uses 1.0."""
    x = np.asarray(x, dtype=float)
    return np.fft.fftshift(
        np.fft.fftfreq((pad + 1) * x.shape[0], x[1] - x[0])) * scale


def th_cents_from_edges(edges):
    """Bin centres, re-centred on the bin nearest zero."""
    edges = np.asarray(edges, dtype=float)
    cents = (edges[1:] + edges[:-1]) / 2
    return cents - cents[np.argmin(np.abs(cents))]


def cs_to_ri(CS):
    """Stack a complex conjugate spectrum into the (real, imag) float
    wire format, real part first."""
    CS = np.asarray(CS)
    return np.stack([CS.real, CS.imag])


def min_edges(fd_lim, fd, tau, eta, factor=2):
    """Minimum edges array oversampling the CS everywhere."""
    fd = np.asarray(unit_checks(fd, "fd"), dtype=float)
    tau = np.asarray(unit_checks(tau, "tau"), dtype=float)
    eta = float(unit_checks(eta, "eta"))
    fd_lim = float(unit_checks(fd_lim, "fd_lim"))
    dtau_lim = (tau[1] - tau[0]) / factor / (2 * eta * fd_lim)
    dfd_lim = (fd[1] - fd[0]) / factor
    npoints = int((2 * fd_lim) // min(dfd_lim, dtau_lim))
    npoints += npoints % 2
    return np.linspace(-fd_lim, fd_lim, npoints)


def _complex(x, device):
    """``x`` as a complex64 tensor: a tensor stays on its own device when
    ``device`` is None; anything else goes to ``device`` (None: the
    card, see :func:`backend.resolve_device`)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x.to(torch.complex64)
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
    return torch.as_tensor(x, dtype=torch.complex64,
                           device=resolve_device(device))


def thth_map(CS, tau, fd, eta, edges, hermetian=True, device=None):
    """Conjugate spectrum ``CS[ntau, nfd]`` → θ-θ matrix, complex64 on
    ``device`` (a tensor ``CS`` stays on its own device when ``device``
    is None). The index maps are the reference's float64 floors on the
    host; the gather runs on the device."""
    CS = _complex(CS, device)
    tau = np.asarray(unit_checks(tau, "tau"), dtype=float)
    fd = np.asarray(unit_checks(fd, "fd"), dtype=float)
    eta = float(unit_checks(eta, "eta"))
    th_cents = th_cents_from_edges(unit_checks(edges, "edges"))
    n = len(th_cents)
    if not np.isfinite(eta):
        return torch.zeros((n, n), dtype=CS.dtype, device=CS.device)
    th1 = th_cents[None, :] * np.ones((n, 1))
    th2 = th1.T
    dtau = np.diff(tau).mean()
    dfd = np.diff(fd).mean()
    tau_inv = ((eta * (th1 ** 2 - th2 ** 2) - tau[0] + dtau / 2)
               // dtau).astype(int)
    fd_inv = (((th1 - th2) - fd[0] + dfd / 2) // dfd).astype(int)
    pnts = ((tau_inv > 0) & (tau_inv < tau.shape[0])
            & (fd_inv < fd.shape[0]) & (fd_inv >= -fd.shape[0]))

    def on(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=CS.device)

    ti = on(np.where(pnts, tau_inv, 0), torch.int64)
    # a negative fd_inv wraps, as numpy's negative index
    fi = on(np.where(pnts, fd_inv, 0) % fd.shape[0], torch.int64)
    thth = torch.where(on(pnts, torch.bool), CS[ti, fi], 0)
    thth = thth * on(np.sqrt(np.abs(2 * eta * (th2 - th1))), torch.float32)
    if hermetian:
        thth = thth - torch.tril(thth)
        thth = thth + torch.conj(torch.triu(thth).T)
        thth = thth - torch.diag(torch.diag(thth))
        thth = thth - torch.diag(torch.diag(thth.flip(0))).flip(0)
        thth = torch.nan_to_num(thth)
    return thth


def redmap_mask(tau, fd, eta, edges):
    """Valid-square membership for the reduced θ-θ, host side."""
    tau = np.asarray(unit_checks(tau, "tau"), dtype=float)
    fd = np.asarray(unit_checks(fd, "fd"), dtype=float)
    eta = float(unit_checks(eta, "eta"))
    th_cents = th_cents_from_edges(unit_checks(edges, "edges"))
    return ((th_cents ** 2 * eta < np.abs(tau.max()))
            & (np.abs(th_cents) < np.abs(fd.max()) / 2))


def thth_redmap(CS, tau, fd, eta, edges, hermetian=True, device=None):
    """θ-θ cropped to the largest filled square (a tensor) and its
    reduced edges (numpy). Raises ``ValueError`` when fewer than 3 θ
    bins are valid (a non-finite or out-of-range η)."""
    thth = thth_map(CS, tau, fd, eta, edges, hermetian=hermetian,
                    device=device)
    th_pnts = redmap_mask(tau, fd, eta, edges)
    if np.count_nonzero(th_pnts) < 3:
        raise ValueError(
            f"thth_redmap: no valid theta-theta region for eta={eta}")
    th_cents = th_cents_from_edges(unit_checks(edges, "edges"))
    keep = torch.as_tensor(np.flatnonzero(th_pnts), device=thth.device)
    thth_red = thth[keep][:, keep]
    cents_red = th_cents[th_pnts]
    inner = (cents_red[:-1] + cents_red[1:]) / 2
    step = np.diff(inner).mean()
    edges_red = np.concatenate(([inner[0] - step], inner,
                                [inner[-1] + step]))
    return thth_red, edges_red


def rev_map(thth, tau, fd, eta, edges, hermetian=True, device=None):
    """θ-θ → conjugate spectrum ``CS[ntau, nfd]`` (complex64) by the
    weighted histogram scatter: each bin holds the sum of the θ-θ values
    that land in it, each over √|2η·f_D|, divided by how many land in
    it. Bins and counts are the reference's float64 floors on the host;
    the sums are taken on the device. A value over f_D = 0 is ±inf or
    NaN in its real and imaginary parts apart, as numpy's division of a
    complex by a real zero, and poisons its bin, which the final
    ``nan_to_num`` maps to 0 or the largest float32."""
    thth = _complex(thth, device)
    tau = np.asarray(unit_checks(tau, "tau"), dtype=float)
    fd = np.asarray(unit_checks(fd, "fd"), dtype=float)
    eta = float(unit_checks(eta, "eta"))
    th_cents = th_cents_from_edges(unit_checks(edges, "edges"))
    fd_map = th_cents[None, :] - th_cents[:, None]
    tau_map = eta * (th_cents[None, :] ** 2 - th_cents[:, None] ** 2)
    dfd = fd[1] - fd[0]
    dtau = tau[1] - tau[0]
    nfd, ntau = fd.shape[0], tau.shape[0]
    dev = thth.device
    s = torch.as_tensor(np.sqrt(np.abs(2 * eta * fd_map.T)),
                        dtype=torch.float32, device=dev)
    w = torch.complex(thth.real / s, thth.imag / s)

    def scatter(fm, tm, weights):
        ix = np.floor((fm - (fd[0] - dfd / 2)) / dfd).astype(int)
        iy = np.floor((tm - (tau[0] - dtau / 2)) / dtau).astype(int)
        ok = (ix >= 0) & (ix < nfd) & (iy >= 0) & (iy < ntau)
        flat = (np.where(ok, ix, 0) * ntau + np.where(ok, iy, 0)).ravel()
        cnt = np.bincount(flat, weights=ok.ravel().astype(float),
                          minlength=nfd * ntau)
        keep = np.flatnonzero(ok.ravel())
        acc = torch.zeros((nfd * ntau, 2), dtype=torch.float32, device=dev)
        acc.index_add_(0, torch.as_tensor(flat[keep], device=dev),
                       torch.view_as_real(weights.reshape(-1)[
                           torch.as_tensor(keep, device=dev)]))
        return acc, cnt

    acc, norm = scatter(fd_map, tau_map, w)
    if hermetian:
        a2, n2 = scatter(-fd_map, -tau_map, torch.conj(w))
        acc, norm = acc + a2, norm + n2
    norm = torch.as_tensor(norm, dtype=torch.float32, device=dev)
    recov = torch.view_as_complex(acc / norm[:, None])
    recov = torch.nan_to_num(recov).reshape(nfd, ntau)
    return recov.T


def dominant_eig_power(A, iters=200, device=None):
    """Gershgorin-shifted power iteration for the largest *algebraic*
    eigenvalue of hermitian ``A[..., n, n]`` (a batch iterates
    together): ``(λ[...], v[..., n])``, starting from A's middle row.
    Plain PyTorch (the JAX package runs it outside any kernel); a
    tensor ``A`` stays on its own device when ``device`` is None."""
    A = _complex(A, device)
    n = A.shape[-1]
    shift = A.abs().sum(dim=-1).amax(dim=-1)[..., None]
    v = A[..., n // 2, :]
    nrm = torch.sqrt((v.abs() ** 2).sum(dim=-1, keepdim=True))
    v = torch.where(nrm > 0, v / (nrm + _EPS),
                    torch.ones_like(v) / np.sqrt(n))
    # eps added after the sqrt: it must survive float32
    for _ in range(int(iters)):
        w = (A @ v[..., None])[..., 0] + shift * v
        v = w / (torch.sqrt((w.abs() ** 2).sum(dim=-1, keepdim=True))
                 + _EPS)
    Av = (A @ v[..., None])[..., 0]
    lam = ((torch.conj(v) * Av).sum(dim=-1)
           / ((torch.conj(v) * v).sum(dim=-1) + _EPS)).real
    return lam, v


def eval_calc(CS, tau, fd, eta, edges, device=None):
    """Dominant |λ| of the reduced θ-θ at curvature η."""
    thth_red, _ = thth_redmap(CS, tau, fd, eta, edges, device=device)
    lam, _ = dominant_eig_power(thth_red)
    return abs(float(lam))


def make_eval_fn(tau, fd, edges, iters=200, method="power", squarings=10,
                 eig="kernel", device=None):
    """``fn(CS_ri[2, ntau, nfd], etas[neta]) → |λ|[neta]``: the B = 1
    wrapper over :func:`.batch.make_multi_eval_fn` (``method`` — one of
    the JAX package's ``"power"``, ``"warm"``, ``"square"``,
    ``"pallas"``, ``"auto"`` — and ``eig`` as there)."""
    from .batch import make_multi_eval_fn

    multi = make_multi_eval_fn(tau, fd, edges, squarings=squarings,
                               eig=eig, device=device, iters=iters,
                               method=method)

    def fn(CS_ri, etas):
        return multi(CS_ri[None], etas)[0]

    fn.multi = multi
    return fn


_EVAL_CACHE = {}
_EVAL_CACHE_SIZE = 32


def _eval_fn(tau, fd, edges, iters, method, eig, dev):
    """:func:`make_eval_fn` of one geometry, built once and kept in a
    FIFO-bounded dict keyed on the geometry's bytes."""
    from .batch import resolve_fused_method

    method = resolve_fused_method(method, len(edges), dev.type)
    key = (tau.tobytes(), fd.tobytes(), edges.tobytes(), int(iters), method,
           eig, str(dev))
    return fifo_cached(_EVAL_CACHE, key, lambda: make_eval_fn(
        tau, fd, edges, iters=iters, method=method, eig=eig, device=dev),
        _EVAL_CACHE_SIZE)


def eval_calc_batch(CS, tau, fd, etas, edges, iters=200, device=None,
                    method="auto", eig="kernel"):
    """Eigenvalue-vs-η curve of one conjugate spectrum over the η grid
    on ``device``: ``method="auto"`` (or ``"pallas"``) walks the grid as
    one chain of the warm-start eigensolver (the hand-written kernel on a
    CUDA device with ``eig="kernel"``, its plain version on the CPU or
    with ``eig="plain"``); ``"square"`` takes the cold squaring start per
    η (the ``eig_cold`` kernel on a CUDA device); ``"warm"`` the JAX
    package's η-scan; ``"power"`` ``iters`` cold power steps per η.
    Returns numpy |λ|[neta]."""
    dev = resolve_device(device)
    etas = np.asarray(unit_checks(etas, "etas"), dtype=float)
    tau_a = np.asarray(unit_checks(tau, "tau"), dtype=float)
    fd_a = np.asarray(unit_checks(fd, "fd"), dtype=float)
    edges_a = np.asarray(unit_checks(edges, "edges"), dtype=float)
    fn = _eval_fn(tau_a, fd_a, edges_a, iters, method, eig, dev)
    cs_ri = torch.as_tensor(cs_to_ri(CS), dtype=torch.float32, device=dev)
    return fn(cs_ri, etas).cpu().numpy().astype(float)


def modeler(CS, tau, fd, eta, edges, hermetian=True, device=None):
    """Rank-1 θ-θ model → CS model → dynspec model: ``(thth_red,
    thth2_red, recov, model, edges_red, w, V)`` (``hermetian=False``:
    ``(…, edges_red, U₀, S₀, W₀)`` of the SVD), tensors on ``device``
    but ``edges_red`` (numpy) and ``w``, ``S₀`` (floats). The rank-1
    matrix keeps its diagonal, whose weight in :func:`rev_map` divides
    by f_D = 0, so ``recov``'s f_D = τ = 0 bin holds the largest float32
    and ``model`` is dominated by it, as the reference's is by the
    largest float64."""
    thth_red, edges_red = thth_redmap(CS, tau, fd, eta, edges,
                                      hermetian=hermetian, device=device)
    if hermetian:
        lam, V = dominant_eig_power(thth_red)
        w = abs(float(lam))
        thth2_red = torch.outer(V, torch.conj(V)) * w
        extras = (w, V)
    else:
        U, S, Wh = torch.linalg.svd(thth_red)
        thth2_red = torch.outer(U[:, 0], Wh[0, :]) * S[0]
        extras = (U[:, 0], float(S[0]), Wh[0, :])
    recov = rev_map(thth2_red, tau, fd, eta, edges_red, hermetian=hermetian)
    model = torch.fft.ifft2(torch.fft.ifftshift(recov))
    if hermetian:
        model = model.real
    return (thth_red, thth2_red, recov, model, edges_red) + extras


def chisq_calc(dspec, CS, tau, fd, eta, edges, N, mask=None, device=None):
    """χ² of the rank-1 θ-θ dynspec model against ``dspec``."""
    dspec = np.asarray(dspec, dtype=float)
    if mask is None:
        mask = np.isfinite(dspec)
    model = modeler(CS, tau, fd, eta, edges, device=device)[3]
    model = model[: dspec.shape[0], : dspec.shape[1]]
    d = torch.as_tensor(np.nan_to_num(dspec), dtype=model.dtype,
                        device=model.device)
    m = torch.as_tensor(mask, device=model.device)
    return float(((model - d)[m] ** 2).sum()) / N


def two_curve_map(CS, tau, fd, eta1, edges1, eta2, edges2):
    """θ-θ with distinct main-arc (``eta1``, ``edges1``) and arclet
    (``eta2``, ``edges2``) curvatures, cropped to the valid θ of each:
    ``(thth[n2, n1], edges1_red, edges2_red)``. Host numpy in
    complex128; the device route is :func:`.batch.make_thin_eval_fn`."""
    tau = np.asarray(unit_checks(tau, "tau"), dtype=float)
    fd = np.asarray(unit_checks(fd, "fd"), dtype=float)
    eta1 = float(unit_checks(eta1, "eta1"))
    eta2 = float(unit_checks(eta2, "eta2"))
    edges1 = np.asarray(unit_checks(edges1, "edges1"), dtype=float)
    edges2 = np.asarray(unit_checks(edges2, "edges2"), dtype=float)

    c1 = (edges1[1:] + edges1[:-1]) / 2
    c2 = (edges2[1:] + edges2[:-1]) / 2
    th1 = np.ones((len(c2), len(c1))) * c1
    th2 = np.ones((len(c2), len(c1))) * c2[:, None]
    dtau = np.diff(tau).mean()
    dfd = np.diff(fd).mean()
    # the offsets are tau[1] and fd[1], and the bounds len - 1, as in
    # the reference's two-curve map (the standard map uses [0] and len)
    tau_inv = ((eta1 * th1 ** 2 - eta2 * th2 ** 2 - tau[1] + dtau / 2)
               // dtau).astype(int)
    fd_inv = ((th1 - th2 - fd[1] + dfd / 2) // dfd).astype(int)
    thth = np.zeros(tau_inv.shape, dtype=complex)
    pnts = ((tau_inv > 0) & (tau_inv < tau.shape[0] - 1)
            & (fd_inv < fd.shape[0] - 1))
    thth[pnts] = np.asarray(CS)[tau_inv[pnts], fd_inv[pnts]]
    thth *= np.sqrt(np.abs(2 * eta1 * th1 - 2 * eta2 * th2))

    th2_max = np.sqrt(tau.max() / eta2)
    th1_max = np.sqrt(tau.max() / eta1)
    p1 = np.abs(c1) < th1_max
    p2 = np.abs(c2) < th2_max
    e1 = np.zeros(p1.sum() + 1)
    e1[:-1] = edges1[:-1][p1]
    e1[-1] = edges1[1:][p1].max()
    e2 = np.zeros(p2.sum() + 1)
    e2[:-1] = edges2[:-1][p2]
    e2[-1] = edges2[1:][p2].max()
    return thth[p2, :][:, p1], e1, e2


def singularvalue_calc(CS, tau, fd, eta, edges, etaArclet, edgesArclet,
                       centerCut):
    """Largest singular value of the two-curvature θ-θ with the main-arc
    columns |θ| < ``centerCut`` zeroed (host numpy SVD, float64)."""
    thth_red, e1, _ = two_curve_map(CS, tau, fd, eta, edges, etaArclet,
                                    edgesArclet)
    cents1 = (e1[1:] + e1[:-1]) / 2
    thth_red = np.array(thth_red)
    thth_red[:, np.abs(cents1) < float(unit_checks(centerCut))] = 0
    return np.linalg.svd(thth_red, compute_uv=False)[0]


def len_arc(x, eta):
    """Arc length along the parabola."""
    a = 2 * eta
    return (a * x * np.sqrt((a * x) ** 2 + 1)
            + np.arcsinh(a * x)) / (2.0 * a)


def arc_edges(eta, dfd, dtau, fd_max, n):
    """Equal-arc-length edges array."""
    dfd = float(unit_checks(dfd))
    dtau = float(unit_checks(dtau))
    fd_max = float(unit_checks(fd_max))
    eta = float(unit_checks(eta))
    x_max = fd_max / dfd
    eta_ul = dfd ** 2 * eta / dtau
    l_max = len_arc(x_max, eta_ul)
    dl = l_max / (n // 2 - 0.5)
    x = np.zeros(int(n // 2))
    x[0] = dl / 2
    for i in range(x.shape[0] - 1):
        x[i + 1] = x[i] + dl / np.sqrt(1 + (2 * eta_ul * x[i]) ** 2)
    return np.concatenate((-x[::-1], x)) * dfd


def ext_find(x, y):
    """imshow extent of the axes ``x``, ``y``."""
    x = np.asarray(unit_checks(x), dtype=float)
    y = np.asarray(unit_checks(y), dtype=float)
    dx = np.diff(x).mean()
    dy = np.diff(y).mean()
    return [x[0] - dx / 2, x[-1] + dx / 2, y[0] - dy / 2, y[-1] + dy / 2]
