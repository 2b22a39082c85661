"""Batched dominant eigenvalue (and eigenvector) of θ-θ matrices: warm
started along chains, or by the cold start alone.

Counterpart of ``scintools_tpu/thth/pallas_eig.py:41-386``
(``pad_to_multiple``, ``_eig_body``, ``_warm_body``,
``batched_eig_warmstart``, ``batched_eigvec_warmstart``,
``batched_eig_pallas``, ``batched_eig_squaring_xla``,
``pack_padded``). The warm-start solvers walk a chain of matrices in
order: the first takes the cold two-phase squaring start, every later
one ``iters`` shifted power steps from its predecessor's eigenvector,
and a stale warm result (λ < 0, or a Rayleigh residual above 3%·|λ|) is
replaced by a cold restart. ``batched_eig_warmstart`` walks the η axis
of each chunk (the curvature search) and returns λ;
``batched_eigvec_warmstart`` walks the chunk axis (the wavefield
retrieval) and returns λ and v; ``batched_eig_cold`` runs the cold
start alone on every matrix of a batch.

Each wrapper dispatches on the tensor's device: a CPU tensor takes its
plain version (the same algorithm with ``torch.matmul``, one shared
walker), a CUDA tensor launches the hand-written Hopper kernel
``csrc/eig_warmstart.cu`` or raises. Complex matrices cross the
boundary as the (re, im) float32 pair wire format of
:func:`pack_padded`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

_EPS = 1e-30


def pad_to_multiple(n, m=128):
    """Smallest multiple of ``m`` that is >= n."""
    return int(-(-n // m) * m)


def pack_padded(thth_batch, n_orig):
    """Stack (..., n, n) complex θ-θ matrices into the zero-padded
    (..., 2, N, N) float32 wire format, N = ``pad_to_multiple(n_orig)``."""
    pad = pad_to_multiple(n_orig) - n_orig
    ri = np.stack([thth_batch.real, thth_batch.imag], axis=-3)
    if pad:
        ri = np.pad(ri, [(0, 0)] * (ri.ndim - 2) + [(0, pad), (0, pad)])
    return np.ascontiguousarray(ri, dtype=np.float32)


# ---------------------------------------------------------------------
# plain PyTorch version (batched over the leading axis of each stage)
# ---------------------------------------------------------------------

def _complex_sq(br, bi):
    """(br + i·bi)² as real matrix products."""
    return br @ br - bi @ bi, br @ bi + bi @ br


def _complex_mv(ar, ai, vr, vi):
    """(ar + i·ai) @ (vr + i·vi) for column vectors (..., n, 1)."""
    return ar @ vr - ai @ vi, ar @ vi + ai @ vr


def _sum(x):
    return x.sum(dim=(-2, -1))


def _eig_body(ar, ai, mid, squarings):
    """Cold two-phase squaring start on a (M, N, N) batch → (λ[M],
    vr[M, N, 1], vi, residual[M]). Phase 0 estimates the spectral
    radius ρ from C = A² squared 4× more; phase 1 squares
    B = A + 1.05ρ·I ``squarings`` times, applies it to the column
    ``mid`` of A and takes the Rayleigh quotient of A."""

    def sq(br, bi):
        cr, ci = _complex_sq(br, bi)
        nrm = torch.sqrt(_sum(cr * cr + ci * ci))[:, None, None] + _EPS
        return cr / nrm, ci / nrm

    cr, ci = sq(ar, ai)
    for _ in range(4):
        cr, ci = sq(cr, ci)
    vr = cr[:, :, mid:mid + 1]
    vi = ci[:, :, mid:mid + 1]
    ur, ui = _complex_mv(ar, ai, vr, vi)
    rho = torch.sqrt((_sum(ur * ur + ui * ui) + _EPS)
                     / (_sum(vr * vr + vi * vi) + _EPS))
    shift = (1.05 * rho)[:, None, None]

    n = ar.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=ar.device)
    br = ar + torch.where(eye, shift, torch.zeros((), dtype=ar.dtype,
                                                  device=ar.device))
    bi = ai
    for _ in range(squarings):
        br, bi = sq(br, bi)

    ur = ar[:, :, mid:mid + 1]
    ui = ai[:, :, mid:mid + 1]
    vr, vi = _complex_mv(br, bi, ur, ui)
    nrm = torch.sqrt(_sum(vr * vr + vi * vi))[:, None, None] + _EPS
    return _rayleigh(ar, ai, vr / nrm, vi / nrm)


def _rayleigh(ar, ai, vr, vi):
    wr, wi = _complex_mv(ar, ai, vr, vi)
    lam = _sum(vr * wr + vi * wi) / (_sum(vr * vr + vi * vi) + _EPS)
    lv = lam[:, None, None]
    res = torch.sqrt(_sum((wr - lv * vr) ** 2 + (wi - lv * vi) ** 2))
    return lam, vr, vi, res


def _warm_body(ar, ai, vr, vi, iters):
    """``iters`` shifted power steps from a warm vector; the shift is
    1.05·|Rayleigh(v)|."""
    wr, wi = _complex_mv(ar, ai, vr, vi)
    ray = _sum(vr * wr + vi * wi) / (_sum(vr * vr + vi * vi) + _EPS)
    shift = (1.05 * ray.abs())[:, None, None]
    for _ in range(iters):
        wr, wi = _complex_mv(ar, ai, vr, vi)
        wr = wr + shift * vr
        wi = wi + shift * vi
        nrm = torch.sqrt(_sum(wr * wr + wi * wi))[:, None, None] + _EPS
        vr, vi = wr / nrm, wi / nrm
    return _rayleigh(ar, ai, vr, vi)


def _walk(chains, mid, squarings, iters, stats, with_vec):
    """Walk axis 1 of ``chains[G, L, 2, N, N]``: position 0 takes the
    cold start, every later position ``iters`` warm steps from its
    predecessor's vector and a cold restart where that is stale; the G
    chains are batched, and the cold branch runs only for the chains
    that need it. Returns ``λ[G, L]`` and, with ``with_vec``,
    ``v[G, L, 2, N]``."""
    G, L, two, n, n2 = chains.shape
    if two != 2 or n != n2:
        raise ValueError("want (..., 2, N, N) matrices")
    mid = int(mid)
    lam_out = chains.new_empty((G, L))
    v_out = chains.new_empty((G, L, 2, n)) if with_vec else None
    vr = vi = None
    n_cold = 0
    for k in range(L):
        ar, ai = chains[:, k, 0], chains[:, k, 1]
        if k == 0:
            lam, vr, vi, _ = _eig_body(ar, ai, mid, squarings)
            n_cold += G
        else:
            lam, vr, vi, res = _warm_body(ar, ai, vr, vi, iters)
            stale = (lam < 0.0) | (res > 0.03 * lam.abs() + _EPS)
            if bool(stale.any()):
                idx = stale.nonzero()[:, 0]
                n_cold += len(idx)
                lc, vrc, vic, _ = _eig_body(ar[idx], ai[idx], mid,
                                            squarings)
                lam, vr, vi = lam.clone(), vr.clone(), vi.clone()
                lam[idx], vr[idx], vi[idx] = lc, vrc, vic
        lam_out[:, k] = lam
        if with_vec:
            v_out[:, k, 0] = vr[..., 0]
            v_out[:, k, 1] = vi[..., 0]
    if stats is not None:
        stats["cold"] = stats.get("cold", 0) + n_cold
    return lam_out, v_out


def batched_eig_warmstart_plain(a_ri, mid, squarings=10, iters=24,
                                stats=None):
    """The plain PyTorch version of :func:`batched_eig_warmstart`: a
    Python loop over η carrying the eigenvector of all B chunks, with
    the cold branch computed only for the chunks that need it. A dict
    ``stats`` gets the number of cold starts added to its ``"cold"``."""
    if a_ri.ndim != 5:
        raise ValueError("a_ri must be (B, neta, 2, N, N)")
    return _walk(a_ri, mid, squarings, iters, stats, with_vec=False)[0]


def batched_eig_cold_plain(a_ri, mid, squarings=10):
    """The plain PyTorch version of :func:`batched_eig_cold` (the
    counterpart of ``batched_eig_squaring_xla``): the cold start on the
    whole ``(batch, 2, N, N)`` batch at once."""
    if a_ri.ndim != 4 or a_ri.shape[1] != 2:
        raise ValueError("a_ri must be (batch, 2, N, N)")
    return _eig_body(a_ri[:, 0], a_ri[:, 1], int(mid), squarings)[0]


def _as_chains(a_ri):
    """``(B, 2, N, N)`` (one chain) or ``(G, L, 2, N, N)`` (G chains of
    L) → the 5-D chain view."""
    if a_ri.ndim not in (4, 5):
        raise ValueError("a_ri must be (B, 2, N, N) or (G, L, 2, N, N)")
    return a_ri if a_ri.ndim == 5 else a_ri[None]


def batched_eigvec_warmstart_plain(a_ri, mid, squarings=10, iters=24,
                                   stats=None):
    """The plain PyTorch version of :func:`batched_eigvec_warmstart`:
    the same walk as :func:`batched_eig_warmstart_plain`, along the
    chunk axis of each chain, keeping each position's vector."""
    lam, v = _walk(_as_chains(a_ri), mid, squarings, iters, stats,
                   with_vec=True)
    if a_ri.ndim == 4:
        return lam[0], v[0]
    return lam, v


# ---------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------

def _lib():
    from .. import _build

    lib = _build.load("eig_warmstart")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.eig_warmstart_launch.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.eig_warmstart_launch.restype = i
        lib.eigvec_warmstart_launch.argtypes = [p, p, p, p, i, i, i, i, i,
                                                i, p]
        lib.eigvec_warmstart_launch.restype = i
        lib.eig_cold_launch.argtypes = [p, p, p, i, i, i, i, p]
        lib.eig_cold_launch.restype = i
        lib.eig_warmstart_error_string.argtypes = [i]
        lib.eig_warmstart_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _launch(chains, mid, squarings, iters, with_vec, cold=False):
    """Check a CUDA ``chains[G, L, 2, N, N]`` tensor and launch one CTA
    per chain on the current stream: ``eig_warmstart_launch`` for λ
    alone, ``eigvec_warmstart_launch`` for λ and v, ``eig_cold_launch``
    (``cold``, chains of one) for the cold start alone. Raises on
    anything the kernel does not take and on a refused launch."""
    if chains.device.type != "cuda":
        raise ValueError(f"unsupported device {chains.device}")
    if chains.dtype != torch.float32 or not chains.is_contiguous():
        raise ValueError(f"a_ri must be a contiguous float32 tensor, got "
                         f"{chains.dtype} with strides {chains.stride()}")
    G, L, two, n, n2 = chains.shape
    if two != 2 or n != n2 or n % 128 or not 0 <= int(mid) < n:
        raise ValueError(f"a_ri shape {tuple(chains.shape)} / mid {mid}: "
                         "want (..., 2, N, N), N % 128 == 0, 0 <= mid < N")
    dev = chains.device
    lam = torch.empty((G, L), dtype=torch.float32, device=dev)
    v = (torch.empty((G, L, 2, n), dtype=torch.float32, device=dev)
         if with_vec else None)
    if G == 0 or L == 0:
        return lam, v
    scratch = torch.empty((G, 2, 2, n, n), dtype=torch.float32, device=dev)
    lib = _lib()
    args = (int(mid), int(squarings), int(iters))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if cold:
            rc = lib.eig_cold_launch(chains.data_ptr(), lam.data_ptr(),
                                     scratch.data_ptr(), G, n, int(mid),
                                     int(squarings), stream)
        elif with_vec:
            rc = lib.eigvec_warmstart_launch(
                chains.data_ptr(), lam.data_ptr(), v.data_ptr(),
                scratch.data_ptr(), G, L, n, *args, stream)
        else:
            rc = lib.eig_warmstart_launch(
                chains.data_ptr(), lam.data_ptr(), scratch.data_ptr(), G, L,
                n, *args, stream)
    if rc != 0:
        msg = lib.eig_warmstart_error_string(rc).decode()
        raise RuntimeError(f"eig_warmstart launch failed ({rc}): {msg}")
    return lam, v


def batched_eig_warmstart(a_ri, mid, squarings=10, iters=24):
    """Dominant (largest-algebraic) eigenvalues of a (B, neta, 2, N, N)
    float32 batch of hermitian matrices, warm-starting each η from its
    predecessor within the same chunk b. Returns (B, neta) float32;
    the caller takes ``abs``.

    A CPU tensor runs the plain version; a CUDA tensor launches
    ``csrc/eig_warmstart.cu`` (N a multiple of 128, contiguous float32)
    or raises. Caveat (as the TPU kernel's): at a near-degenerate point
    of a dominant-eigenvector crossing the value may be any eigenvalue
    in [λ₂, λ₁]; it re-locks to λ₁ as the gap reopens."""
    if a_ri.device.type == "cpu":
        return batched_eig_warmstart_plain(a_ri, mid, squarings, iters)
    if a_ri.ndim != 5:
        raise ValueError("a_ri must be (B, neta, 2, N, N)")
    lam, _ = _launch(a_ri, mid, squarings, iters, with_vec=False)
    batched_eig_warmstart.launches += 1
    return lam


batched_eig_warmstart.launches = 0


def batched_eigvec_warmstart(a_ri, mid, squarings=10, iters=24):
    """Dominant eigenpair of hermitian float32 matrices, warm-starting
    each matrix from its predecessor in its chain (the retrieval's
    chunk walk). ``a_ri`` is ``(B, 2, N, N)``, one chain as the TPU
    kernel takes it, → ``(λ[B], v_ri[B, 2, N])``; or ``(G, L, 2, N, N)``,
    G independent chains of L, → ``(λ[G, L], v_ri[G, L, 2, N])``. The
    first matrix of every chain starts cold. ``v`` is the unit
    eigenvector; its global phase is arbitrary.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    ``eigvec_warmstart_launch`` entry of ``csrc/eig_warmstart.cu`` (one
    CTA per chain; N a multiple of 128, contiguous float32) or raises.
    The near-degeneracy caveat of :func:`batched_eig_warmstart` holds."""
    if a_ri.device.type == "cpu":
        return batched_eigvec_warmstart_plain(a_ri, mid, squarings, iters)
    lam, v = _launch(_as_chains(a_ri), mid, squarings, iters,
                     with_vec=True)
    batched_eigvec_warmstart.launches += 1
    if a_ri.ndim == 4:
        return lam[0], v[0]
    return lam, v


batched_eigvec_warmstart.launches = 0


def batched_eig_cold(a_ri, mid, squarings=10):
    """Dominant (largest-algebraic) eigenvalues of a ``(batch, 2, N, N)``
    float32 batch of hermitian matrices by the cold two-phase squaring
    start alone, no warm start (the TPU's ``batched_eig_pallas``).
    Returns ``(batch,)`` float32.

    A CPU tensor runs :func:`batched_eig_cold_plain`; a CUDA tensor
    launches the ``eig_cold_launch`` entry of ``csrc/eig_warmstart.cu``
    (one CTA per matrix; N a multiple of 128, contiguous float32) or
    raises."""
    if a_ri.device.type == "cpu":
        return batched_eig_cold_plain(a_ri, mid, squarings)
    if a_ri.ndim != 4:
        raise ValueError("a_ri must be (batch, 2, N, N)")
    lam, _ = _launch(a_ri[:, None], mid, squarings, 0, with_vec=False,
                     cold=True)
    batched_eig_cold.launches += 1
    return lam[:, 0]


batched_eig_cold.launches = 0
