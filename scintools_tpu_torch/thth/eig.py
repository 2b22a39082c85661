"""Batched warm-started dominant eigenvalue of θ-θ matrices.

Counterpart of ``scintools_tpu/thth/pallas_eig.py:41-254`` and ``:386``
(``pad_to_multiple``, ``_eig_body``, ``_warm_body``,
``batched_eig_warmstart``, ``pack_padded``). For each chunk b the η
axis is walked in order: the first η takes the cold two-phase squaring
start, every later η takes ``iters`` shifted power steps from the
previous η's eigenvector, and a stale warm result (λ < 0, or a Rayleigh
residual above 3%·|λ|) is replaced by a cold restart.

``batched_eig_warmstart`` dispatches on the tensor's device: a CPU
tensor takes :func:`batched_eig_warmstart_plain` (the same algorithm
with ``torch.matmul``), a CUDA tensor launches the hand-written Hopper
kernel ``csrc/eig_warmstart.cu`` or raises. Complex matrices cross the
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


def batched_eig_warmstart_plain(a_ri, mid, squarings=10, iters=24,
                                stats=None):
    """The plain PyTorch version of :func:`batched_eig_warmstart`: a
    Python loop over η carrying the eigenvector of all B chunks, with
    the cold branch computed only for the chunks that need it. A dict
    ``stats`` gets the number of cold starts added to its ``"cold"``."""
    B, neta, two, n, n2 = a_ri.shape
    if two != 2 or n != n2:
        raise ValueError("a_ri must be (B, neta, 2, N, N)")
    mid = int(mid)
    out = a_ri.new_empty((B, neta))
    vr = vi = None
    n_cold = 0
    for k in range(neta):
        ar, ai = a_ri[:, k, 0], a_ri[:, k, 1]
        if k == 0:
            lam, vr, vi, _ = _eig_body(ar, ai, mid, squarings)
            n_cold += B
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
        out[:, k] = lam
    if stats is not None:
        stats["cold"] = stats.get("cold", 0) + n_cold
    return out


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
        lib.eig_warmstart_error_string.argtypes = [i]
        lib.eig_warmstart_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


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
    if a_ri.device.type != "cuda":
        raise ValueError(f"unsupported device {a_ri.device}")
    if a_ri.dtype != torch.float32 or not a_ri.is_contiguous():
        raise ValueError(f"a_ri must be a contiguous float32 tensor, got "
                         f"{a_ri.dtype} with strides {a_ri.stride()}")
    if a_ri.ndim != 5:
        raise ValueError("a_ri must be (B, neta, 2, N, N)")
    B, neta, two, n, n2 = a_ri.shape
    if two != 2 or n != n2 or n % 128 or not 0 <= int(mid) < n:
        raise ValueError(f"a_ri shape {tuple(a_ri.shape)} / mid {mid}: "
                         "want (B, neta, 2, N, N), N % 128 == 0, "
                         "0 <= mid < N")
    out = torch.empty((B, neta), dtype=torch.float32, device=a_ri.device)
    if B == 0 or neta == 0:
        return out
    scratch = torch.empty((B, 2, 2, n, n), dtype=torch.float32,
                          device=a_ri.device)
    lib = _lib()
    with torch.cuda.device(a_ri.device):
        stream = torch.cuda.current_stream(a_ri.device).cuda_stream
        rc = lib.eig_warmstart_launch(a_ri.data_ptr(), out.data_ptr(),
                                      scratch.data_ptr(), B, neta, n,
                                      int(mid), int(squarings), int(iters),
                                      stream)
    if rc != 0:
        msg = lib.eig_warmstart_error_string(rc).decode()
        raise RuntimeError(f"eig_warmstart launch failed ({rc}): {msg}")
    batched_eig_warmstart.launches += 1
    return out


batched_eig_warmstart.launches = 0
