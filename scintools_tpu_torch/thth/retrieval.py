"""Chunked phase retrieval, wavefield mosaic and Gerchberg–Saxton.

Counterpart of ``scintools_tpu/thth/retrieval.py``:
``resolve_retrieval_method`` (:60), ``_hermitian_sym`` (:220),
``_row_hot`` (:231), ``_scatter_inverse`` (:240), ``_eig_stage``
(:277), ``make_chunk_retrieval_fn`` (:381 — ``front_one`` :449,
``back_one`` :502, ``_retrieval_body`` :535), ``chunk_retrieval_batch``
(:739), ``grid_retrieval_batch`` (:767, the ``"hbm"`` group rule
:822-843), the mosaic helpers and numpy oracle (:905-951),
``make_mosaic_fn``/``mosaic_device`` (:954-1043),
``campaign_retrieval_batch`` (:1046) and ``gerchberg_saxton`` with its
iteration body ``make_gs_kernel`` (:1238, :1338).

One retrieval takes a stack of chunks with per-chunk η and θ edges
(both ride the batch axis, so one built function serves every frequency
row of a grid and every epoch of a campaign): mean-pad → rfft2 → θ-θ
gather from the half spectrum → dominant eigenpair → wavefield row at
the cropped path's middle θ bin → inverse-map scatter → cropped ifft2.
Index maps are built in float64 from the per-chunk geometry; the
compute is float32 / complex64.

The eigenpair ``method`` (:data:`METHODS`): ``"kernel"`` dispatches by
device to the hand-written chunk-chained solver
(:func:`~.eig.batched_eigvec_warmstart`: the kernel on a CUDA tensor),
``"plain"`` runs its plain PyTorch version on either device (the
reference the kernel is held to), ``"eigh"`` is the dense
``torch.linalg.eigh`` solve and ``"power"`` ``iters`` cold power steps.
The JAX package's names are taken too (:data:`JAX_ALIASES`): ``None``
and ``"auto"`` resolve the ``thth.retrieval_eig`` formulation (:41,
registered here, "pallas" on both devices); ``"pallas"`` and ``"warm"``
mean ``"kernel"``. JAX ``'warm'`` runs the Pallas kernel's own bodies
in XLA, so on the card it takes the hand-written kernel; it revisits a
chain's first chunk, which the port's chained solver, as JAX
``'pallas'``, does not.

The group size is the ``thth.retrieval_group`` formulation (:53):
``"hbm"`` (:func:`hbm_group`, both devices) or ``"cache"``, groups of 8.
The front's conjugate spectrum follows ``ops.cs``: ``"rfft"`` gathers
from the half spectrum, ``"fft2"`` from the full complex one.

On the chained routes the chunks are walked in chains of ``group`` (the
first chunk of each chain starts cold), exactly the JAX package's
``lax.map`` groups; the whole grid is one kernel launch with one CTA
per chain. The front and back ends walk the same groups, so their
working set is one group's spectra.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..backend import (as_tensor, fifo_cached, formulation,
                       register_formulation, resolve_device)
from ..ops import xfft
from ..ops.sspec import chunk_conjugate_spectrum_batch, pad_chunk_batch
from ..robust import guards
from ..utils import slog
from .core import (dominant_eig_power, fft_axis, rev_map, th_cents_from_edges,
                   thth_redmap, unit_checks)
from .search import chunk_conjugate_spectrum, pad_chunk
from .eig import (batched_eigvec_warmstart, batched_eigvec_warmstart_plain,
                  pad_to_multiple)

METHODS = ("kernel", "plain", "eigh", "power")
# the JAX package's names: None and "auto" resolve the registry, the
# others are the kernel route
JAX_ALIASES = (None, "auto", "pallas", "warm")

register_formulation(
    "thth.retrieval_eig", default="eigh",
    choices=("eigh", "power", "warm", "pallas"),
    platforms={"cpu": "pallas", "cuda": "pallas"},
    doc="batched retrieval eigenpair: dense eigh vs cold power iteration "
        "vs the chunk-chained warm start (eigvec_warmstart kernel; 'warm' "
        "and 'pallas' both take it)")
register_formulation(
    "thth.retrieval_group", default="hbm", choices=("hbm", "cache"),
    platforms={"cpu": "hbm", "cuda": "hbm"},
    doc="retrieval chain length: the largest group of at most 32 "
        "(hbm_group) vs groups of 8 whose spectra stay in cache")

#: the chain length of the ``"cache"`` group formulation
CACHE_GROUP = 8


def resolve_retrieval_method(method, n_edges=None, platform=None):
    """The port's name of a retrieval ``method``: ``None`` and ``"auto"``
    resolve the ``thth.retrieval_eig`` formulation on ``platform`` (a
    device type; ``None``: ``backend.formulation_platform()``);
    ``"pallas"`` and ``"warm"`` → ``"kernel"``; one of :data:`METHODS`
    as it is; anything else raises ``ValueError``. ``n_edges`` is the
    JAX package's second argument (its VMEM guard, which falls back to
    ``"warm"``); the card's kernel takes every size, so it is unused."""
    if method in (None, "auto"):
        method = formulation("thth.retrieval_eig", platform)
    if method in JAX_ALIASES:
        return "kernel"
    if method not in METHODS:
        raise ValueError(f"unknown retrieval method {method!r} (want one "
                         f"of {METHODS} or {JAX_ALIASES})")
    return method


def default_group(n, platform=None):
    """The chain length of a retrieval of ``n`` chunks under the
    ``thth.retrieval_group`` formulation on ``platform``:
    :func:`hbm_group` or :data:`CACHE_GROUP`, at most ``n``."""
    if formulation("thth.retrieval_group", platform) == "cache":
        return min(CACHE_GROUP, max(int(n), 1))
    return hbm_group(n)


def _numpy(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def single_chunk_retrieval(dspec, edges, time, freq, eta, idx_t=0, idx_f=0,
                           npad=3, tau_mask=0.0, verbose=False, device=None):
    """Phase retrieval of one chunk on ``device``: the float64 host
    conjugate spectrum → reduced θ-θ → dominant eigenpair (the
    chunk-chained solver of :func:`.eig.batched_eigvec_warmstart` on a
    chain of one: the kernel on the card) → wavefield row at the middle
    θ bin → inverse map → cropped ifft2. Returns ``(E[nf, nt] complex64
    numpy, idx_f, idx_t)``. A chunk whose θ-θ has no valid square (a
    non-finite or out-of-range η: the ``ValueError`` of
    :func:`.core.thth_redmap`) comes back as zeros, so one bad chunk does
    not end a retrieval; any other error propagates."""
    dspec = np.asarray(dspec)
    CS, tau, fd = chunk_conjugate_spectrum(dspec, time, freq, npad=npad,
                                           tau_mask=tau_mask)
    try:
        thth_red, edges_red = thth_redmap(CS, tau, fd, eta, edges,
                                          device=device)
    except ValueError as e:
        if verbose:
            print(f"single_chunk_retrieval: chunk ({idx_f}, {idx_t}) "
                  f"quarantined: {e}")
        slog.log_failure("thth.retrieval_error", epoch=None,
                         stage="retrieval", error=e, tier=None, retry=0,
                         idx_f=int(idx_f), idx_t=int(idx_t))
        return np.zeros(dspec.shape, dtype=np.complex64), idx_f, idx_t
    lam, V = _eigpair_one(thth_red)
    ththE = torch.zeros_like(thth_red)
    ththE[ththE.shape[0] // 2, :] = torch.conj(V) * torch.sqrt(lam.abs())
    recov_E = rev_map(ththE, tau, fd, eta, edges_red, hermetian=False)
    model_E = torch.fft.ifft2(torch.fft.ifftshift(recov_E))[
        : dspec.shape[0], : dspec.shape[1]]
    model_E = model_E * (dspec.shape[0] * dspec.shape[1] / 4)
    return model_E.cpu().numpy(), idx_f, idx_t


def vlbi_auto_positions(n_dish):
    """Indices of the auto-spectra in the VLBI pair ordering [I1, V12,
    …, V1N, I2, V23, …, IN]."""
    return ((n_dish * (n_dish + 1)) / 2
            - np.cumsum(np.linspace(1, n_dish, n_dish)))


def vlbi_pair_index(n_dish, d1, d2):
    """Pair-list index of the (d1, d1+d2) station block of the composite
    matrix."""
    return int(((n_dish * (n_dish + 1)) // 2)
               - (((n_dish - d1) * (n_dish - d1 + 1)) // 2) + d2)


def vlbi_chunk_retrieval(dspec_list, edges, time, freq, eta, idx_t=0,
                         idx_f=0, npad=3, n_dish=2, tau_mask=0.0,
                         verbose=False, device=None):
    """Multi-station composite θ-θ retrieval of one chunk:
    ``dspec_list`` in the order [I1, V12, …, V1N, I2, V23, …, IN] →
    per-dish wavefields ``([E_d[nf, nt] complex64 numpy], idx_f,
    idx_t)``. The reduced θ-θ of each spectrum and the inverse maps run
    on ``device``; the composite block-hermitian matrix's top eigenpair is
    scipy's ``eigsh`` on the host, as in the JAX package."""
    from scipy.sparse.linalg import eigsh

    time = np.asarray(unit_checks(time, "time"), dtype=float)
    freq = np.asarray(unit_checks(freq, "freq"), dtype=float)
    eta = float(unit_checks(eta, "eta"))
    slog.log_event("thth.retrieval_chunk", idx_f=int(idx_f),
                   idx_t=int(idx_t), n_dish=int(n_dish), eta=eta,
                   path="vlbi")
    if verbose:
        print(f"vlbi_chunk_retrieval: chunk ({idx_f}, {idx_t}), "
              f"{n_dish} dishes, eta={eta:.4g}")
    fd = fft_axis(time, pad=npad, scale=1e3)
    tau = fft_axis(freq, pad=npad, scale=1.0)
    autos = vlbi_auto_positions(n_dish)
    thth_red, edges_red = [], None
    for i, ds in enumerate(dspec_list):
        is_dspec = bool(np.isin(i, autos))
        pad = pad_chunk(np.asarray(ds), npad,
                        fill="mean" if is_dspec else "zero")
        CS = np.fft.fftshift(np.fft.fft2(pad))
        if tau_mask:
            CS[np.abs(tau) < tau_mask] = 0
        t_single, edges_red = thth_redmap(CS, tau, fd, eta, edges,
                                          hermetian=is_dspec, device=device)
        thth_red.append(t_single)
    dev = thth_red[0].device
    blocks = [_numpy(t).astype(complex) for t in thth_red]
    size = blocks[0].shape[0]
    comp = np.zeros((size * n_dish, size * n_dish), dtype=complex)
    for d1 in range(n_dish):
        for d2 in range(n_dish - d1):
            blk = blocks[vlbi_pair_index(n_dish, d1, d2)]
            s1 = slice(d1 * size, (d1 + 1) * size)
            s2 = slice((d1 + d2) * size, (d1 + d2 + 1) * size)
            comp[s1, s2] = np.conj(blk.T)
            comp[s2, s1] = blk
    w, V = eigsh(comp, 1, which="LA")
    w, V = w[0], V[:, 0]
    nf, nt = np.shape(dspec_list[0])
    model_E = []
    for d in range(n_dish):
        ththE = torch.zeros((size, size), dtype=torch.complex64, device=dev)
        ththE[size // 2, :] = torch.as_tensor(
            np.conj(V[d * size:(d + 1) * size]) * np.sqrt(w),
            dtype=torch.complex64, device=dev)
        recov_E = rev_map(ththE, tau, fd, eta, edges_red, hermetian=False)
        mE = torch.fft.ifft2(torch.fft.ifftshift(recov_E))[:nf, :nt]
        model_E.append((mE * (nf * nt / 4)).cpu().numpy())
    return model_E, idx_f, idx_t


def _hermitian_sym(thth, tril, anti):
    """Hermitian θ-θ symmetrisation over the two trailing axes."""
    sym = thth.masked_fill(tril, 0)
    sym = sym + torch.conj(sym.transpose(-1, -2))
    return sym.masked_fill(anti, 0)


def _row_hot(valid):
    """``valid[B, n] →`` one-hot of index ``n_red//2`` of each chunk's
    valid set (the cropped path's middle θ bin), located via the
    running valid count."""
    n_red = valid.sum(-1, keepdim=True)
    return valid & (valid.cumsum(-1) == n_red // 2 + 1)


def _cents(edges_b):
    """θ bin centres per chunk, re-centred on the bin nearest zero
    (first one on a tie, as ``argmin``), float64."""
    c = (edges_b[:, 1:] + edges_b[:, :-1]) / 2
    return c - c.gather(1, c.abs().argmin(-1, keepdim=True))


def _bins(fd_map, tau_map, valid_pair, g):
    """Inverse-map destinations of θ-θ points: ``(flat index into the
    RAW (ntau, nfd) fft layout, in range and valid)``. The shifted-frame
    bin is floored in float64, then sent through the inverse
    ``ifftshift`` permutations, so the recovered spectrum needs no
    ``ifftshift`` pass."""
    ix = torch.floor((fd_map - (g.fd0 - g.dfd / 2)) / g.dfd)
    iy = torch.floor((tau_map - (g.tau0 - g.dtau / 2)) / g.dtau)
    ok = ((ix >= 0) & (ix < g.nfd) & (iy >= 0) & (iy < g.ntau)
          & valid_pair)
    ix = torch.where(ok, ix, 0).long()
    iy = torch.where(ok, iy, 0).long()
    return g.unshift_tau[iy] * g.nfd + g.unshift_fd[ix], ok


def _scatter_inverse(row, hot, cents, etas, valid, g):
    """The cropped inverse map (``rev_map``, hermetian=False) of a θ-θ
    wavefield whose only non-zero row is the hot one: ``row[B, n]`` is
    that row, ``hot[B, n]`` its one-hot. Returns the recovered spectrum
    ``[B, ntau, nfd]`` complex64 in raw fft layout.

    Each destination bin holds the sum of the weighted θ-θ values that
    land in it over the count of valid×valid θ pairs that land in it,
    NaN read as 0. The counts are integers (sorted keys and
    ``searchsorted``, exact in any order). The sums are taken per
    destination with a 0/1 matrix product and written once per bin, so
    no two writes meet and a rerun gives the same bits. Only the hot row
    carries values, so it is all that is summed, except for one bin: the
    θ-θ diagonal (f_D = τ = 0). There every valid non-hot row divides
    its zero by a zero weight, so with two or more valid θ the bin is
    NaN and reads 0; with one it holds the hot row's own diagonal term."""
    B, n = valid.shape
    has = hot.any(-1)
    r = hot.long().argmax(-1, keepdim=True)
    cr = cents.gather(1, r)
    eta = etas[:, None]
    fd_row = cents - cr
    dest, ok = _bins(fd_row, eta * (cents ** 2 - cr ** 2),
                     has[:, None] & valid, g)
    wgt = row / torch.sqrt(torch.abs(2 * eta * fd_row)).to(row.real.dtype)

    # integer count of valid×valid pairs per destination
    fd_all = cents[:, None, :] - cents[:, :, None]
    tau_all = eta[..., None] * (cents[:, None, :] ** 2
                                - cents[:, :, None] ** 2)
    d_all, ok_all = _bins(fd_all, tau_all,
                          valid[:, None, :] & valid[:, :, None], g)
    keys = torch.where(ok_all, d_all, -1).flatten(1).sort(-1).values
    cnt = (torch.searchsorted(keys, dest, right=True)
           - torch.searchsorted(keys, dest))

    diag = torch.arange(n, device=valid.device)[None, :] == r
    live = ok & ~diag
    same = (dest[:, :, None] == dest[:, None, :]) & live[:, None, :]
    w_ri = torch.view_as_real(torch.where(live, wgt, 0))
    sums = torch.view_as_complex(
        torch.bmm(same.to(w_ri.dtype), w_ri).contiguous())
    first = live & ~(same & torch.ones((n, n), dtype=torch.bool,
                                       device=valid.device).tril(-1)).any(-1)
    vals = torch.nan_to_num(sums / cnt)

    canvas = torch.zeros((B, g.ntau * g.nfd), dtype=row.dtype,
                         device=row.device)
    b, j = first.nonzero(as_tuple=True)
    canvas[b, dest[b, j]] = vals[b, j]
    d_val = torch.where(valid.sum(-1) >= 2, 0,
                        torch.nan_to_num(wgt.gather(1, r)[:, 0]))
    (b,) = has.nonzero(as_tuple=True)
    canvas[b, dest.gather(1, r)[b, 0]] = d_val[b]
    return canvas.view(B, g.ntau, g.nfd)


def _geometry(nf_chunk, nt_chunk, dt, df, npad, dev):
    """Axes of one chunk shape and the index-space shifts, as floats and
    device index tensors."""
    fd = fft_axis(np.arange(nt_chunk) * dt, pad=npad, scale=1e3)
    tau = fft_axis(np.arange(nf_chunk) * df, pad=npad, scale=1.0)
    ntau, nfd = len(tau), len(fd)

    def idx(x):
        return torch.as_tensor(x, dtype=torch.int64, device=dev)

    return SimpleNamespace(
        ntau=ntau, nfd=nfd, tau0=float(tau[0]), fd0=float(fd[0]),
        dtau=float(np.diff(tau).mean()), dfd=float(np.diff(fd).mean()),
        tau_max=float(np.abs(tau).max()), fd_max=float(np.abs(fd).max()),
        abs_tau=torch.as_tensor(np.abs(tau), dtype=torch.float64,
                                device=dev),
        # the conjugate spectrum's fftshift (shifted → raw index) and the
        # pre-ifft2 ifftshift (shifted index → raw destination), folded
        # into the gather and scatter index maps
        shift_tau=idx(np.fft.fftshift(np.arange(ntau))),
        shift_fd=idx(np.fft.fftshift(np.arange(nfd))),
        unshift_tau=idx(np.argsort(np.fft.ifftshift(np.arange(ntau)))),
        unshift_fd=idx(np.argsort(np.fft.ifftshift(np.arange(nfd)))))


def _pack_chains(thth, n_pad, group):
    """θ-θ stack ``[B, n, n]`` → zero-padded ``(B/group, group, 2, n_pad,
    n_pad)`` float32 chains, the chained eigensolvers' input."""
    B, n = thth.shape[:2]
    a = torch.zeros((B, 2, n_pad, n_pad), dtype=torch.float32,
                    device=thth.device)
    a[:, 0, :n, :n] = thth.real
    a[:, 1, :n, :n] = thth.imag
    return a.view(B // group, group, 2, n_pad, n_pad)


def _eigpair_one(thth):
    """Dominant eigenpair ``(λ, v[n])`` of one hermitian θ-θ matrix:
    :func:`.eig.batched_eigvec_warmstart` on a chain of one (its cold
    start)."""
    n = thth.shape[-1]
    lam, v = batched_eigvec_warmstart(
        _pack_chains(thth[None], pad_to_multiple(n), 1), n // 2)
    V = torch.complex(v[0, 0, 0, :n], v[0, 0, 1, :n]).to(thth.dtype)
    return lam[0, 0].to(thth.real.dtype), V


def make_chunk_retrieval_fn(nf_chunk, nt_chunk, dt, df, n_edges, npad=3,
                            method="kernel", iters=1024, warm_iters=64,
                            device=None, cs_method=None):
    """Build the batched retrieval on ``device`` (``None``: the card):
    ``fn(chunks[B, nf, nt], edges[B, n_edges], etas[B], tau_mask=0.0,
    group=None, mark=None) → (E[B, nf, nt] complex64, ok[B] int32)``,
    with ``chunks`` float32 and ``edges``/``etas`` float64 tensors on
    ``device``.

    ``group`` (default: the whole batch) is the chain length of the
    chained eigensolvers and the step of the front and back ends; B must
    be a multiple of it. ``mark(name)``, when given, is called after the
    ``front``, ``eig`` and ``back`` stages.

    The reduced θ-θ map is reproduced with masked fixed shapes: invalid
    rows and columns are zeroed (their eigenvalues are null), the
    wavefield row goes to index ``n_red//2`` of the valid set, and the
    inverse map counts only valid×valid pairs. Health: ``ok`` carries
    ``BAD_INPUT`` (non-finite pixels, zeroed before the FFT), ``BAD_CS``
    (non-finite spectrum) and ``BAD_CURVE`` (non-finite η or fewer than
    3 valid θ); input- or spectrum-corrupt chunks come back as zeros.
    On the chained routes a corrupt chunk's sanitised matrix still
    warm-starts the next chunk of its chain, as in the JAX package.

    ``fn.front`` (chunks → θ-θ stack) and ``fn.pack`` (θ-θ stack →
    padded float32 chains) are the stages before the eigensolver.
    ``cs_method`` is the ``ops.cs`` choice of the front (``None``:
    resolved on ``device``).
    """
    dev = resolve_device(device)
    method = resolve_retrieval_method(method, n_edges, dev.type)
    if cs_method is None:
        cs_method = formulation("ops.cs", dev.type)
    if cs_method not in ("rfft", "fft2"):
        raise ValueError(f"unknown conjugate-spectrum method {cs_method!r} "
                         "(want 'rfft' or 'fft2')")
    g = _geometry(nf_chunk, nt_chunk, dt, df, npad, dev)
    n_th = n_edges - 1
    n_pad = pad_to_multiple(n_th)
    tril = torch.ones((n_th, n_th), dtype=torch.bool, device=dev).tril()
    anti = torch.eye(n_th, dtype=torch.bool, device=dev).flip(0)
    scale = nf_chunk * nt_chunk / 4

    def front(chunks, edges_b, etas_b, tau_mask):
        """Chunks → masked θ-θ matrices ``[B, n, n]`` complex64, with
        ``valid[B, n]``, ``cents[B, n]`` float64 and the input and
        spectrum health flags."""
        in_ok = guards.chunk_finite_ok(chunks)
        chunks = guards.sanitize_chunks(chunks)
        if cs_method == "rfft":
            H = torch.fft.rfft2(pad_chunk_batch(chunks, npad))
        else:
            H = chunk_conjugate_spectrum_batch(chunks, npad=npad,
                                               method="fft2", shift=False)
        cs_ok = guards.chunk_finite_ok(torch.view_as_real(H))
        cents = _cents(edges_b)
        eta = etas_b[:, None, None]
        th1, th2 = cents[:, None, :], cents[:, :, None]
        tau_inv = torch.floor((eta * (th1 ** 2 - th2 ** 2) - g.tau0
                               + g.dtau / 2) / g.dtau)
        fd_inv = torch.floor(((th1 - th2) - g.fd0 + g.dfd / 2) / g.dfd)
        pnts = ((tau_inv > 0) & (tau_inv < g.ntau) & (fd_inv < g.nfd)
                & (fd_inv >= -g.nfd))
        ti = torch.where(pnts, tau_inv, 0).long()
        # |tau| >= tau_mask, applied per gathered row
        pnts &= g.abs_tau[ti] >= tau_mask
        # negative fd_inv wraps by floor-mod (torch's `%` on integers)
        cc = g.shift_fd[torch.where(pnts, fd_inv, 0).long() % g.nfd]
        if cs_method == "rfft":
            vals = xfft.hermitian_half_gather(H, g.nfd, g.shift_tau[ti], cc)
        else:
            b = torch.arange(H.shape[0], device=dev)[:, None, None]
            vals = H[b, g.shift_tau[ti], cc]
        w = torch.sqrt(torch.abs(2 * eta * (th2 - th1)))
        thth = torch.where(pnts, vals, 0) * w.to(torch.float32)
        thth = torch.nan_to_num(_hermitian_sym(thth, tril, anti))
        # the reduced map's valid square, as a mask
        valid = ((cents ** 2 * etas_b[:, None] < g.tau_max)
                 & (cents.abs() < g.fd_max / 2))
        thth = thth * (valid[:, None, :] & valid[:, :, None])
        return thth, valid, cents, in_ok, cs_ok

    def pack(thth, group):
        return _pack_chains(thth, n_pad, group)

    def eig(thth, group):
        """Dominant eigenpair ``(w[B] = |λ|, V[B, n])``."""
        if method == "eigh":
            lam, V = torch.linalg.eigh(thth)
            return lam[:, -1].abs(), V[:, :, -1]
        if method == "power":
            lam, V = dominant_eig_power(thth, iters=iters)
            return lam.abs(), V
        solver = (batched_eigvec_warmstart if method == "kernel"
                  else batched_eigvec_warmstart_plain)
        lam, v = solver(pack(thth, group), n_th // 2, iters=warm_iters)
        V = torch.complex(v[..., 0, :n_th], v[..., 1, :n_th])
        return lam.reshape(-1).abs(), V.reshape(-1, n_th)

    def back(w, V, valid, cents, etas_b):
        """Eigenpair → wavefield chunks: the row at the middle valid θ
        bin → inverse map → cropped ifft2."""
        V = V * valid
        row = torch.conj(V) * torch.sqrt(w)[:, None]
        recov = _scatter_inverse(row, _row_hot(valid), cents, etas_b, valid,
                                 g)
        E = xfft.ifft2_cropped(recov, (nf_chunk, nt_chunk)) * scale
        return torch.nan_to_num(E)

    def fn(chunks, edges_b, etas_b, tau_mask=0.0, group=None, mark=None):
        mark = mark or (lambda name: None)
        B = chunks.shape[0]
        group = group or B
        if B % group:
            raise ValueError(f"group={group} must divide the batch {B}")
        steps = [slice(s, s + group) for s in range(0, B, group)]
        parts = [front(chunks[s], edges_b[s], etas_b[s], tau_mask)
                 for s in steps]
        thth, valid, cents, in_ok, cs_ok = (torch.cat(p) for p in
                                            zip(*parts))
        del parts
        mark("front")
        w, V = eig(thth, group)
        del thth
        mark("eig")
        E = torch.cat([back(w[s], V[s], valid[s], cents[s], etas_b[s])
                       for s in steps])
        mark("back")
        geom_ok = torch.isfinite(etas_b) & (valid.sum(-1) >= 3)
        ok = guards.health_code(input_ok=in_ok, cs_ok=cs_ok,
                                curve_ok=geom_ok)
        E = torch.where((in_ok & cs_ok)[:, None, None], E, 0)
        return E, ok

    fn.front, fn.pack, fn.n_th = front, pack, n_th
    return fn


_RETRIEVAL_CACHE = {}
_CACHE_SIZE = 16


def _retrieval_fn(nf, nt, dt, df, n_edges, npad, method, iters, warm_iters,
                  dev):
    """The retrieval function of one geometry, built once and kept in a
    FIFO-bounded dict keyed on the resolved formulations."""
    method = resolve_retrieval_method(method, n_edges, dev.type)
    cs_method = formulation("ops.cs", dev.type)
    key = (int(nf), int(nt), float(dt), float(df), int(n_edges), int(npad),
           method, cs_method, int(iters), int(warm_iters), str(dev))
    return fifo_cached(_RETRIEVAL_CACHE, key, lambda: make_chunk_retrieval_fn(
        nf, nt, dt, df, n_edges, npad=npad, method=method, iters=iters,
        warm_iters=warm_iters, device=dev, cs_method=cs_method), _CACHE_SIZE)


def hbm_group(n):
    """The JAX package's ``"hbm"`` group rule on one device: the whole
    batch when it is at most 32; else the largest divisor of it in
    [8, 32]; else balanced ceil-groups of at most 32."""
    n = max(int(n), 1)
    if n <= 32:
        return n
    divisors = [d for d in range(8, 33) if n % d == 0]
    if divisors:
        return divisors[-1]
    steps = -(-n // 32)
    return -(-n // steps)


def grid_retrieval_batch(chunks, edges_per, etas_per, dt, df, npad=3,
                         tau_mask=0.0, method="eigh", iters=1024,
                         warm_iters=64, mesh=None, group=None, with_ok=False,
                         device_out=False, device=None, mark=None):
    """Whole-grid retrieval: ``chunks[N, nf, nt]`` with per-chunk
    ``edges_per[N, n_edges]`` and ``etas_per[N]`` → complex wavefield
    chunks ``[N, nf, nt]`` (numpy; with ``with_ok`` also the health
    bitmask ``ok[N]``). The chunk axis is walked in chains of ``group``
    (default :func:`default_group`), padded at the end with zero chunks
    that are cropped after. ``device_out=True`` returns the complex64
    tensors on ``device`` instead, ready for :func:`mosaic_device`.
    ``method``: ``"eigh"`` (the default here, as in the JAX package),
    ``"kernel"``, ``"plain"`` or ``"power"`` (``iters`` cold power steps
    per chunk); the JAX names ``None``, ``"auto"``, ``"pallas"`` and
    ``"warm"`` resolve as :func:`resolve_retrieval_method` does. ``mark``
    gets ``upload`` once the chunks are on ``device``, then the stages
    of :func:`make_chunk_retrieval_fn`.

    ``mesh`` (:func:`~..parallel.mesh.make_mesh`) spreads the chains
    over its devices in whole chains (:func:`~..parallel.survey.
    make_retrieval_sharded`), so every chunk is computed as it is
    without the mesh; ``device`` is then the mesh's first device, where
    the results are gathered, and ``mark`` gets ``upload`` alone."""
    if mesh is not None:
        device = mesh.first
    dev = resolve_device(device)
    method = resolve_retrieval_method(method, np.shape(edges_per)[-1],
                                      dev.type)
    if isinstance(chunks, torch.Tensor):
        chunks = chunks.to(device=dev, dtype=torch.float32)
    else:
        chunks = as_tensor(np.asarray(chunks, dtype=np.float32), dev)
    N, nf, nt = chunks.shape
    edges_per = np.asarray(unit_checks(edges_per, "edges"), dtype=float)
    etas_per = np.asarray(unit_checks(etas_per, "etas"), dtype=float)
    group = min(default_group(N, dev.type) if group is None else int(group),
                max(N, 1))
    pad_n = (-N) % group
    if pad_n:
        chunks = torch.cat([chunks, chunks.new_zeros((pad_n, nf, nt))])
        edges_per = np.concatenate([edges_per,
                                    np.tile(edges_per[-1:], (pad_n, 1))])
        etas_per = np.concatenate([etas_per, np.full(pad_n, etas_per[-1])])
    if mark is not None:
        mark("upload")
    tau_mask = float(unit_checks(tau_mask) or 0.0)
    edges_t = torch.as_tensor(edges_per, dtype=torch.float64, device=dev)
    etas_t = torch.as_tensor(etas_per, dtype=torch.float64, device=dev)
    if mesh is not None:
        from ..parallel.survey import make_retrieval_sharded

        fn = make_retrieval_sharded(mesh, nf, nt, dt, df, edges_per.shape[1],
                                    npad=npad, method=method, iters=iters,
                                    warm_iters=warm_iters)
        E, ok = fn(chunks, edges_t, etas_t, tau_mask, group=group)
    else:
        fn = _retrieval_fn(nf, nt, dt, df, edges_per.shape[1], npad, method,
                           iters, warm_iters, dev)
        E, ok = fn(chunks, edges_t, etas_t, tau_mask, group=group, mark=mark)
    E, ok = E[:N], ok[:N]
    if not device_out:
        E, ok = E.cpu().numpy(), ok.cpu().numpy()
    return (E, ok) if with_ok else E


def chunk_retrieval_batch(chunks, edges, eta, dt, df, npad=3, tau_mask=0.0,
                          method="eigh", iters=1024, warm_iters=64,
                          mesh=None, with_ok=False, device=None):
    """One frequency row: ``chunks[B, nf, nt]`` sharing ``edges`` and
    ``eta`` → complex wavefield chunks (and ``ok`` with ``with_ok``);
    :func:`grid_retrieval_batch` with the row's geometry broadcast."""
    B = len(chunks)
    edges = np.asarray(unit_checks(edges, "edges"), dtype=float)
    return grid_retrieval_batch(
        chunks, np.tile(edges, (B, 1)),
        np.full(B, float(unit_checks(eta, "eta"))), dt, df, npad=npad,
        tau_mask=tau_mask, method=method, iters=iters, warm_iters=warm_iters,
        mesh=mesh, with_ok=with_ok, device=device)


def make_vlbi_retrieval_fn(nf_chunk, nt_chunk, dt, df, n_edges, n_dish,
                           npad=3, device=None):
    """Build the batched VLBI retrieval on ``device`` (``None``: the
    card): ``fn(dspecs[B, P, nf, nt] complex64, edges[n_edges], eta,
    tau_mask) → E[B, n_dish, nf, nt]`` complex64, P = n_dish(n_dish+1)/2
    spectra per chunk in the order [I1, V12, …, V1N, I2, V23, …, IN].

    One device pass: autos mean-padded, crosses zero-padded → fft2 →
    per-pair θ-θ gather (hermitian for the autos, raw for the crosses)
    on the masked fixed-shape reduced map → the composite
    block-hermitian matrix → its dominant eigenpair by
    ``torch.linalg.eigh`` (the JAX package's dense ``eigh``, outside any
    kernel) → per-dish wavefield rows at the middle valid θ bin →
    inverse map → cropped ifft2. The index maps are float64 floors on
    the host (edges and η are shared by the batch)."""
    dev = resolve_device(device)
    g = _geometry(nf_chunk, nt_chunk, dt, df, npad, dev)
    n_th = n_edges - 1
    P = (n_dish * (n_dish + 1)) // 2
    is_auto = np.isin(np.arange(P), vlbi_auto_positions(n_dish))
    auto_t = torch.as_tensor(is_auto, device=dev)
    tril = torch.ones((n_th, n_th), dtype=torch.bool, device=dev).tril()
    anti = torch.eye(n_th, dtype=torch.bool, device=dev).flip(0)
    NF, NT = (npad + 1) * nf_chunk, (npad + 1) * nt_chunk
    tau_ax = torch.as_tensor(np.abs(fft_axis(np.arange(nf_chunk) * df,
                                             pad=npad)), device=dev)
    scale = nf_chunk * nt_chunk / 4

    def fn(dspecs, edges, eta, tau_mask=0.0):
        B = dspecs.shape[0]
        edges = np.asarray(edges, dtype=float)
        eta = float(eta)
        mu = dspecs.mean(dim=(2, 3))
        fill = torch.where(auto_t[None], mu, 0)
        padded = fill[:, :, None, None].expand(B, P, NF, NT).clone()
        padded[:, :, :nf_chunk, :nt_chunk] = dspecs
        CS = torch.fft.fftshift(torch.fft.fft2(padded), dim=(-2, -1))
        CS = CS.masked_fill((tau_ax < tau_mask)[:, None], 0)

        c = (edges[1:] + edges[:-1]) / 2
        cents = c - c[np.argmin(np.abs(c))]
        th1 = cents[None, :] * np.ones((n_th, 1))
        th2 = th1.T
        tau_inv = np.floor((eta * (th1 ** 2 - th2 ** 2) - g.tau0
                            + g.dtau / 2) / g.dtau).astype(int)
        fd_inv = np.floor(((th1 - th2) - g.fd0 + g.dfd / 2)
                          / g.dfd).astype(int)
        pnts = ((tau_inv > 0) & (tau_inv < g.ntau) & (fd_inv < g.nfd)
                & (fd_inv >= -g.nfd))
        ti = torch.as_tensor(np.where(pnts, tau_inv, 0), device=dev)
        fi = torch.as_tensor(np.where(pnts, fd_inv, 0) % g.nfd, device=dev)
        w = torch.as_tensor(np.sqrt(np.abs(2 * eta * (th2 - th1))),
                            dtype=torch.float32, device=dev)
        thth = torch.where(torch.as_tensor(pnts, device=dev),
                           CS[:, :, ti, fi], 0) * w        # (B, P, n, n)
        sym = _hermitian_sym(thth, tril, anti)
        thth = torch.nan_to_num(torch.where(auto_t[None, :, None, None],
                                            sym, thth))
        valid_np = ((cents ** 2 * eta < g.tau_max)
                    & (np.abs(cents) < g.fd_max / 2))
        valid = torch.as_tensor(valid_np, device=dev)
        thth = thth * (valid[:, None] & valid[None, :])

        N = n_dish * n_th
        comp = torch.zeros((B, N, N), dtype=thth.dtype, device=dev)
        for d1 in range(n_dish):
            for d2 in range(n_dish - d1):
                blk = thth[:, vlbi_pair_index(n_dish, d1, d2)]
                s1 = slice(d1 * n_th, (d1 + 1) * n_th)
                s2 = slice((d1 + d2) * n_th, (d1 + d2 + 1) * n_th)
                comp[:, s1, s2] = torch.conj(blk.transpose(-1, -2))
                comp[:, s2, s1] = blk
        lam, V = torch.linalg.eigh(comp)
        wgt = lam[:, -1].abs()
        V = V[:, :, -1].reshape(B, n_dish, n_th) * valid
        row = (torch.conj(V) * torch.sqrt(wgt)[:, None, None]).reshape(
            B * n_dish, n_th)
        valid_b = valid.expand(B * n_dish, n_th)
        cents_b = torch.as_tensor(cents, device=dev).expand(B * n_dish, n_th)
        etas_b = torch.full((B * n_dish,), eta, dtype=torch.float64,
                            device=dev)
        recov = _scatter_inverse(row, _row_hot(valid_b), cents_b, etas_b,
                                 valid_b, g)
        E = xfft.ifft2_cropped(recov, (nf_chunk, nt_chunk)) * scale
        return torch.nan_to_num(E).reshape(B, n_dish, nf_chunk, nt_chunk)

    return fn


def vlbi_retrieval_batch(dspecs, edges, eta, dt, df, n_dish, npad=3,
                         tau_mask=0.0, mesh=None, device=None):
    """Batched VLBI retrieval on ``device``: ``dspecs[B, P, nf, nt]``
    (P = n_dish(n_dish+1)/2 spectra per chunk, complex cross-spectra)
    with shared ``edges`` and ``eta`` → per-dish wavefields
    ``[B, n_dish, nf, nt]`` (complex64 numpy), one device pass for the
    batch (:func:`make_vlbi_retrieval_fn`, built once per geometry and
    device). ``mesh`` splits the batch over its devices, gathered on
    the first (``device`` is then the mesh's)."""
    if mesh is not None:
        device = mesh.first
    dev = resolve_device(device)
    B, P, nf, nt = np.shape(dspecs)
    if P != (n_dish * (n_dish + 1)) // 2:
        raise ValueError(f"expected {(n_dish * (n_dish + 1)) // 2} "
                         f"spectra per chunk for n_dish={n_dish}, got {P}")
    edges = np.asarray(unit_checks(edges, "edges"), dtype=float)
    eta = float(unit_checks(eta, "eta"))
    tau_mask = float(unit_checks(tau_mask) or 0.0)

    def fn_of(d_dev, n=None):
        key = ("vlbi", nf, nt, float(dt), float(df), len(edges),
               int(n_dish), int(npad), str(d_dev))
        fn = fifo_cached(_RETRIEVAL_CACHE, key,
                         lambda: make_vlbi_retrieval_fn(
                             nf, nt, dt, df, len(edges), n_dish, npad=npad,
                             device=d_dev), _CACHE_SIZE)
        return lambda d: fn(d, edges, eta, tau_mask)

    d = (dspecs.to(device=dev, dtype=torch.complex64)
         if isinstance(dspecs, torch.Tensor)
         else torch.as_tensor(np.asarray(dspecs), dtype=torch.complex64,
                              device=dev))
    if mesh is not None:
        from ..parallel.mesh import run_lanes

        E = run_lanes(mesh, fn_of, (d,))
    else:
        E = fn_of(dev)(d)
    return E.cpu().numpy()


# --------------------------------------------------------------------------
# mosaic stitching
# --------------------------------------------------------------------------

def mask_func(w):
    """sin² overlap ramp."""
    x = np.linspace(0, w - 1, w)
    return np.sin((np.pi / 2) * x / w) ** 2


def chunk_mask(cf, ct, ncf, nct, cwf, cwt):
    """Overlap-add weight mask for chunk (cf, ct)."""
    mask = np.ones((cwf, cwt))
    if cf > 0:
        mask[: cwf // 2, :] *= mask_func(cwf // 2)[:, None]
    if cf < ncf - 1:
        mask[cwf // 2:, :] *= 1 - mask_func(cwf // 2)[:, None]
    if ct > 0:
        mask[:, : cwt // 2] *= mask_func(cwt // 2)
    if ct < nct - 1:
        mask[:, cwt // 2:] *= 1 - mask_func(cwt // 2)
    return mask


def mosaic_shape(ncf, nct, cwf, cwt):
    return ((ncf - 1) * (cwf // 2) + cwf, (nct - 1) * (cwt // 2) + cwt)


def mosaic(chunks):
    """Greedy phase-aligned overlap-add of half-overlapping wavefield
    chunks ``[ncf, nct, cwf, cwt]`` (numpy, complex128): the oracle of
    :func:`mosaic_device`."""
    chunks = np.asarray(chunks)
    ncf, nct, cwf, cwt = chunks.shape
    E = np.zeros(mosaic_shape(ncf, nct, cwf, cwt), dtype=complex)
    for cf in range(ncf):
        for ct in range(nct):
            new = chunks[cf, ct]
            old = E[cf * cwf // 2: cf * cwf // 2 + cwf,
                    ct * cwt // 2: ct * cwt // 2 + cwt]
            mask = chunk_mask(cf, ct, ncf, nct, cwf, cwt)
            rot = np.angle((old * np.conj(new) * mask).mean())
            E[cf * cwf // 2: cf * cwf // 2 + cwf,
              ct * cwt // 2: ct * cwt // 2 + cwt] += \
                new * mask * np.exp(1j * rot)
    return E


def _masks_array(ncf, nct, cwf, cwt):
    return np.array([[chunk_mask(cf, ct, ncf, nct, cwf, cwt)
                      for ct in range(nct)] for cf in range(ncf)])


def _ramp(i, n, w):
    """The 1-D factor of :func:`chunk_mask` along one axis, for chunk
    ``i`` of ``n`` of width ``w``: the mask is the outer product of the
    row and column factors."""
    m = np.ones(w)
    if i > 0:
        m[: w // 2] *= mask_func(w // 2)
    if i < n - 1:
        m[w // 2:] *= 1 - mask_func(w // 2)
    return m


def _stitch(flat, ncf, nct):
    """The greedy mosaic of ``flat[E, ncf·nct, cwf, cwt]`` complex chunks
    on their device → ``[E, F, T]``: chunks visited row-major, each
    phase-aligned against the canvas so far (``arg 0 = 0`` for the
    first, as numpy's). Each chunk's mask is built on the device from
    its row and column ramps, and the rotation stays a device tensor,
    so the loop never waits on the card; the canvas is updated in
    place."""
    n_ep, n, cwf, cwt = flat.shape

    def ramps(count, w):
        return torch.as_tensor(np.stack([_ramp(i, count, w)
                                         for i in range(count)]),
                               dtype=flat.real.dtype, device=flat.device)

    rows, cols = ramps(ncf, cwf), ramps(nct, cwt)
    E = torch.zeros((n_ep,) + mosaic_shape(ncf, nct, cwf, cwt),
                    dtype=flat.dtype, device=flat.device)
    for k in range(n):
        cf, ct = divmod(k, nct)
        r0, c0 = cf * (cwf // 2), ct * (cwt // 2)
        mask = rows[cf][:, None] * cols[ct][None, :]
        old = E[:, r0:r0 + cwf, c0:c0 + cwt]
        new = flat[:, k] * mask
        rot = torch.angle((old * torch.conj(flat[:, k]) * mask)
                          .mean(dim=(-2, -1)))
        old += new * torch.polar(torch.ones_like(rot), rot)[:, None, None]
    return E


def make_mosaic_fn(ncf, nct, cwf, cwt):
    """The device mosaic of one grid geometry: ``fn(chunks[E, ncf·nct,
    cwf, cwt]) → wavefields[E, F, T]``, complex tensors on the chunks'
    device — the greedy phase-aligned stitch of :func:`mosaic`, chunks
    visited row-major, each aligned against the canvas so far (the JAX
    package's scan, with complex tensors in place of its (real, imag)
    stacks). :func:`mosaic_device` is its numpy-facing entry."""
    def fn(chunks):
        chunks = torch.as_tensor(chunks)
        if tuple(chunks.shape[-3:]) != (ncf * nct, cwf, cwt):
            raise ValueError(f"chunks of shape {tuple(chunks.shape)} do not "
                             f"make a {ncf}x{nct} grid of {cwf}x{cwt}")
        return _stitch(chunks.to(torch.complex64), ncf, nct)

    return fn


def mosaic_device(chunks, grid_shape=None, device=None):
    """Device mosaic: the greedy phase-aligned overlap-add of
    :func:`mosaic` on ``device`` (``None``: the card), batched over an
    optional leading epoch axis. Takes a complex ``(ncf, nct, cwf,
    cwt)`` array or tensor, or with ``grid_shape=(ncf, nct)`` a complex
    ``(N, cwf, cwt)`` or ``(E, N, cwf, cwt)`` one, such as the
    ``device_out`` product of :func:`grid_retrieval_batch`. Returns
    complex64 numpy ``(F, T)``, or ``(E, F, T)`` with an epoch axis."""
    dev = resolve_device(device)
    chunks = torch.as_tensor(chunks, device=dev).to(torch.complex64)
    epoch_axis = False
    if grid_shape is None:
        ncf, nct, cwf, cwt = chunks.shape
        flat = chunks.reshape(1, ncf * nct, cwf, cwt)
    else:
        ncf, nct = map(int, grid_shape)
        epoch_axis = chunks.ndim == 4
        flat = chunks if epoch_axis else chunks[None]
        if flat.shape[1] != ncf * nct:
            raise ValueError(f"got {flat.shape[1]} chunks for a "
                             f"{ncf}x{nct} grid")
    E = _stitch(flat, ncf, nct).cpu().numpy()
    return E if epoch_axis else E[0]


def campaign_retrieval_batch(chunks, edges_per, etas_per, dt, df, npad=3,
                             tau_mask=0.0, method=None, iters=1024,
                             warm_iters=64, mesh=None, group=None,
                             stitch=True, device=None, mark=None):
    """A campaign's half-overlap chunk grids → per-epoch stitched
    wavefields. ``chunks[E, ncf, nct, cwf, cwt]``; ``edges_per``
    broadcastable to ``(E, ncf, n_edges)`` and ``etas_per`` to
    ``(E, ncf)``. The epochs flatten into one chunk axis for
    :func:`grid_retrieval_batch`, whose output feeds the device mosaic
    without leaving the card. Returns ``(wavefields[E, F, T] complex64,
    ok[E, ncf, nct])`` when ``stitch``, else ``(chunk wavefields[E, ncf,
    nct, cwf, cwt], ok)``. ``method=None`` is the kernel route;
    ``mark`` also gets ``mosaic`` after the stitch."""
    chunks = np.asarray(chunks, dtype=float)
    n_ep, ncf, nct, cwf, cwt = chunks.shape
    edges_per = np.asarray(edges_per, dtype=float)
    n_edges = edges_per.shape[-1]
    edges_b = np.broadcast_to(edges_per, (n_ep, ncf, n_edges))
    etas_b = np.broadcast_to(np.asarray(etas_per, dtype=float), (n_ep, ncf))
    E, ok = grid_retrieval_batch(
        chunks.reshape(n_ep * ncf * nct, cwf, cwt),
        np.repeat(edges_b.reshape(n_ep * ncf, n_edges), nct, axis=0),
        np.repeat(etas_b.reshape(n_ep * ncf), nct), dt, df, npad=npad,
        tau_mask=tau_mask, method=method, iters=iters, warm_iters=warm_iters,
        mesh=mesh, group=group, with_ok=True, device_out=stitch, device=device,
        mark=mark)
    if not stitch:
        return E.reshape(n_ep, ncf, nct, cwf, cwt), ok.reshape(n_ep, ncf, nct)
    wf = mosaic_device(E.reshape(n_ep, ncf * nct, cwf, cwt),
                       grid_shape=(ncf, nct), device=E.device)
    if mark is not None:
        mark("mosaic")
    return wf, ok.cpu().numpy().reshape(n_ep, ncf, nct)


# --------------------------------------------------------------------------
# global mosaic refinement
# --------------------------------------------------------------------------

def rot_mos(chunks, x):
    """Overlap-add of ``chunks[ncf, nct, cwf, cwt]`` with explicit
    per-chunk phases: ``x[k - 1]`` is the phase of chunk k (row-major;
    chunk 0 fixed at 0). Numpy, complex128."""
    chunks = np.asarray(chunks)
    ncf, nct, cwf, cwt = chunks.shape
    E = np.zeros(mosaic_shape(ncf, nct, cwf, cwt), dtype=complex)
    masks = _masks_array(ncf, nct, cwf, cwt)
    for cf in range(ncf):
        for ct in range(nct):
            rot = 0.0 if (cf == 0 and ct == 0) else x[nct * cf + ct - 1]
            E[cf * cwf // 2: cf * cwf // 2 + cwf,
              ct * cwt // 2: ct * cwt // 2 + cwt] += \
                chunks[cf, ct] * masks[cf, ct] * np.exp(1j * rot)
    return E


def rot_init(chunks):
    """Greedy initial phases for the global rotation fit: each chunk's
    phase against the canvas stitched so far (ncf·nct − 1 values)."""
    chunks = np.asarray(chunks)
    ncf, nct, cwf, cwt = chunks.shape
    E = np.zeros(mosaic_shape(ncf, nct, cwf, cwt), dtype=complex)
    x = np.zeros(ncf * nct - 1)
    for cf in range(ncf):
        for ct in range(nct):
            new = chunks[cf, ct]
            old = E[cf * cwf // 2: cf * cwf // 2 + cwf,
                    ct * cwt // 2: ct * cwt // 2 + cwt]
            mask = chunk_mask(cf, ct, ncf, nct, cwf, cwt)
            rot = np.angle((old * np.conj(new) * mask).mean())
            E[cf * cwf // 2: cf * cwf // 2 + cwf,
              ct * cwt // 2: ct * cwt // 2 + cwt] += \
                new * mask * np.exp(1j * rot)
            if cf > 0 or ct > 0:
                x[cf * nct + ct - 1] = rot
    return x


def _torch_stack(masked, phases, amps, shape):
    """Differentiable overlap-add: ``masked[ncf·nct, cwf, cwt]`` (the
    masked chunks, row-major) with phases ``[0, *phases]`` and amplitudes
    ``amps`` summed into the half-overlap canvas of ``shape`` by
    ``fold`` (one pass for the real part, one for the imaginary)."""
    n, cwf, cwt = masked.shape
    phi = torch.cat([phases.new_zeros(1), phases])
    c = masked * (amps * torch.exp(1j * phi))[:, None, None]

    def fold(x):
        return torch.nn.functional.fold(
            x.reshape(1, n, cwf * cwt).transpose(1, 2), shape,
            (cwf, cwt), stride=(cwf // 2, cwt // 2))[0, 0]

    return torch.complex(fold(c.real), fold(c.imag))


def mosaic_objective(chunks, dspec=None, noise=None, mode="rot",
                     device=None):
    """The objective of :func:`refine_mosaic` and its gradient by
    ``torch.autograd``, in float64 / complex128 on ``device``:
    ``f(x) → (value, gradient)`` (float, numpy). ``mode="rot"``: −Σ|E|²
    over the ncf·nct − 1 phases; ``mode="full"``: Σ((|E|² − dspec)/noise)²
    over the phases then the ncf·nct amplitudes (NaN pixels of
    ``dspec`` weigh 0)."""
    dev = resolve_device(device)
    chunks = np.asarray(chunks)
    ncf, nct, cwf, cwt = chunks.shape
    nchunk = ncf * nct
    shape = mosaic_shape(ncf, nct, cwf, cwt)
    masked = torch.as_tensor(
        (chunks * _masks_array(ncf, nct, cwf, cwt)).reshape(
            nchunk, cwf, cwt), dtype=torch.complex128, device=dev)
    if mode == "rot":
        ones = torch.ones(nchunk, dtype=torch.float64, device=dev)

        def value(x):
            E = _torch_stack(masked, x, ones, shape)
            return -(E.abs() ** 2).sum()
    elif mode == "full":
        if dspec is None:
            raise ValueError("mode='full' requires the observed dspec")
        d = np.asarray(dspec, dtype=float)[: shape[0], : shape[1]]
        N = (np.ones_like(d) if noise is None
             else np.asarray(noise, dtype=float)[: shape[0], : shape[1]])
        d_t = torch.as_tensor(np.nan_to_num(d), device=dev)
        w_t = torch.as_tensor(np.where(np.isfinite(d), 1.0 / N, 0.0),
                              device=dev)

        def value(p):
            E = _torch_stack(masked, p[: nchunk - 1], p[nchunk - 1:], shape)
            return (((E.abs() ** 2 - d_t) * w_t) ** 2).sum()
    else:
        raise ValueError("mode must be 'rot' or 'full'")

    def f(x):
        x = torch.tensor(np.asarray(x, dtype=float), device=dev,
                         requires_grad=True)
        v = value(x)
        (g,) = torch.autograd.grad(v, x)
        return float(v.detach()), g.cpu().numpy()

    f.stack = lambda phases, amps: _torch_stack(
        masked, torch.as_tensor(phases, dtype=torch.float64, device=dev),
        torch.as_tensor(amps, dtype=torch.float64, device=dev), shape)
    return f


def refine_mosaic(chunks, dspec=None, noise=None, mode="rot", maxiter=200,
                  x0=None, device=None):
    """Global mosaic refinement by L-BFGS: ``mode="rot"`` maximises
    Σ|E|² over the per-chunk phases; ``mode="full"`` fits phases and
    amplitudes so that |E|² matches the observed ``dspec`` (weighted by
    1/``noise``). The objective and its gradient
    (:func:`mosaic_objective`, ``torch.autograd`` in float64 /
    complex128 on ``device``) go to scipy's ``L-BFGS-B``; ``x0``
    overrides the greedy initial phases of :func:`rot_init`. Returns
    ``(E, res)``: the refined mosaic (complex128 numpy) and scipy's
    result."""
    from scipy.optimize import minimize

    chunks = np.asarray(chunks)
    nchunk = chunks.shape[0] * chunks.shape[1]
    fun = mosaic_objective(chunks, dspec=dspec, noise=noise, mode=mode,
                           device=device)
    x0_phase = (rot_init(chunks) if x0 is None
                else np.asarray(x0, dtype=float))
    x0 = (x0_phase if mode == "rot"
          else np.concatenate([x0_phase, np.ones(nchunk)]))
    res = minimize(fun, x0, jac=True, method="L-BFGS-B",
                   options={"maxiter": maxiter})
    if mode == "rot":
        return rot_mos(chunks, res.x), res
    E = fun.stack(res.x[: nchunk - 1], res.x[nchunk - 1:])
    return E.detach().cpu().numpy(), res


def calc_asymmetry(eigenvector, edges_red):
    """L/R eigenvector-power asymmetry A = (P₊ − P₋)/(P₊ + P₋) over the
    θ > 0 and θ < 0 components."""
    cents = th_cents_from_edges(edges_red)
    V = _numpy(eigenvector)
    p_pos = np.sum(np.abs(V[cents > 0]) ** 2)
    p_neg = np.sum(np.abs(V[cents < 0]) ** 2)
    return (p_pos - p_neg) / (p_pos + p_neg)


def err_string(value, error):
    """Scientific-notation value±error formatter."""
    if not np.isfinite(value) or not np.isfinite(error) or error <= 0:
        return f"{value}"
    exp = int(np.floor(np.log10(np.abs(value)))) if value != 0 else 0
    v = value / 10 ** exp
    e = error / 10 ** exp
    dig = max(0, 1 - int(np.floor(np.log10(e)))) if e > 0 else 2
    return f"({v:.{dig}f}±{e:.{dig}f})e{exp}"


# --------------------------------------------------------------------------
# Gerchberg–Saxton
# --------------------------------------------------------------------------

def gs_replace(E, amp, good):
    """amp·e^{i·arg E} at good pixels (arg 0 = 0, so amp there)."""
    return torch.where(good, torch.polar(amp, torch.angle(E)), E)


def _gs_iterations(E, amp, good, neg, niter):
    """The GS loop body on tensors ``[..., NF, NT]``: amplitude
    replacement, then ``niter`` rounds of fft2 → zero the τ < 0 rows
    ``neg[NF]`` → ifft2 → amplitude replacement."""
    E = gs_replace(E, amp, good)
    for _ in range(int(niter)):
        spec = torch.fft.fft2(E).masked_fill(neg[:, None], 0)
        E = gs_replace(torch.fft.ifft2(spec), amp, good)
    return E


def gerchberg_saxton(wavefield, dyn, freqs=None, niter=1, rescale=True,
                     mesh=None, device=None):
    """Gerchberg–Saxton iterations on ``device`` (``None``: the card):
    rescale |E|² to the dynspec mean, replace |E| with √dyn at finite
    positive pixels, then zero the acausal (τ < 0) components each
    iteration. The set-up is numpy float64 as in the JAX package; the
    loop runs in complex64 on ``torch.fft``. Returns complex64 numpy.

    ``mesh`` (``parallel.make_mesh(n, seq=n)``: a data axis of 1) splits
    the loop's FFTs over the mesh's ``seq`` shards
    (:func:`~..parallel.fft.make_gs_sharded`); the wavefield is built
    whole on the mesh's first device (``device`` is then the mesh's) and
    must fit there, and its shape must divide over the seq axis."""
    if mesh is not None:
        from ..parallel.mesh import DATA_AXIS, SEQ_AXIS

        if mesh.shape[DATA_AXIS] != 1:
            raise ValueError(
                "gerchberg_saxton(mesh=...) refines ONE wavefield — "
                "use a data-axis-1 mesh (make_mesh(n, seq=n)); batch "
                "fan-out belongs on the retrieval grid, not here")
        k = mesh.shape[SEQ_AXIS]
        shape = np.shape(wavefield)
        if shape[0] % k or shape[1] % k:
            raise ValueError(
                f"wavefield shape {shape} must be divisible by the "
                f"seq axis size {k} for the distributed FFT")
        device = mesh.first
    dev = resolve_device(device)
    E = np.array(wavefield, dtype=complex)
    dyn = np.asarray(dyn, dtype=float)[: E.shape[0], : E.shape[1]]
    good = np.isfinite(dyn) & (dyn > 0)
    amp = np.sqrt(np.where(good, dyn, 0.0))
    if rescale:
        den = np.abs(E[good] ** 2).mean()
        if den > 0:
            E = E * np.sqrt(dyn[good].mean() / den)
        # else: an all-zero (quarantined) wavefield keeps its scale; the
        # amplitude replacement still installs √dyn at good pixels
    if freqs is not None:
        tau = np.fft.fftshift(np.fft.fftfreq(
            E.shape[0], float(np.mean(np.diff(freqs)))))
        neg = np.fft.ifftshift(tau < 0)
    else:
        # negative-frequency rows of an unshifted axis start at (n+1)//2
        neg = np.zeros(E.shape[0], dtype=bool)
        neg[(E.shape[0] + 1) // 2:] = True
    args = (torch.as_tensor(E, dtype=torch.complex64, device=dev),
            as_tensor(amp, dev), torch.as_tensor(good, device=dev),
            torch.as_tensor(neg, device=dev))
    if mesh is not None:
        out = _gs_sharded_fn(mesh)(*(a[None] for a in args[:3]), args[3],
                                   niter)[0]
    else:
        out = _gs_iterations(*args, niter)
    return out.cpu().numpy()


_GS_SHARDED_CACHE = {}


def _gs_sharded_fn(mesh):
    """The mesh-sharded GS of :func:`gerchberg_saxton`, built once per
    mesh (keyed by its devices and shape)."""
    from ..parallel.fft import make_gs_sharded

    return fifo_cached(_GS_SHARDED_CACHE, mesh.key,
                       lambda: make_gs_sharded(mesh), 4)


__all__ = ["calc_asymmetry", "campaign_retrieval_batch", "chunk_mask",
           "chunk_retrieval_batch", "err_string", "gerchberg_saxton",
           "default_group", "grid_retrieval_batch", "hbm_group",
           "make_chunk_retrieval_fn",
           "make_mosaic_fn",
           "make_vlbi_retrieval_fn", "mask_func", "mosaic", "mosaic_device",
           "mosaic_objective", "mosaic_shape", "refine_mosaic",
           "resolve_retrieval_method", "rot_init", "rot_mos",
           "single_chunk_retrieval", "vlbi_auto_positions",
           "vlbi_chunk_retrieval", "vlbi_pair_index",
           "vlbi_retrieval_batch"]
