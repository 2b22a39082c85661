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

The kernel gives each chain a thread-block cluster of C CTAs, each
owning N/C rows: its band of every matrix sits in shared memory while
the warm steps iterate, the mat-vec's rows are exchanged through
distributed shared memory with one cluster barrier per step, and the
cold start's squarings run on the tensor cores in split TF32.
:func:`_cluster_plan` picks C from the shared memory the kernel's
layout needs and the clusters the card seats at once, both asked of the
card; a call with more chains than that runs as several launches. Its
arithmetic order depends on N alone, so a chain's bits do not depend on
the plan or on the other chains in the call.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..backend import KernelError

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


def batched_eig_cold_plain(a_ri, mid, squarings=10, stats=None):
    """The plain PyTorch version of :func:`batched_eig_cold` (the
    counterpart of ``batched_eig_squaring_xla``): the cold start on the
    whole ``(batch, 2, N, N)`` batch at once. A dict ``stats`` gets the
    batch added to its ``"cold"``."""
    if a_ri.ndim != 4 or a_ri.shape[1] != 2:
        raise ValueError("a_ri must be (batch, 2, N, N)")
    if stats is not None:
        stats["cold"] = stats.get("cold", 0) + a_ri.shape[0]
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
# the kernel's launch plan and wrapper
# ---------------------------------------------------------------------

CLUSTERS = (16, 8, 4)        # cluster sizes the kernel is launched with


def _cluster_plan(G, n, smem_bytes, max_active):
    """The kernel's launch plan for G chains of N × N matrices: a list of
    launches ``(chains, C, nbuf, smem bytes)`` that run one after another
    over consecutive chains. A launch gives each chain C CTAs, each
    holding ``nbuf`` bands of its N/C rows in shared memory (2: the next
    matrix's band streams in while this one iterates; 0: the band is
    read from L2, where no C holds it).

    The card answers two questions: ``smem_bytes(n, C, nbuf)``, the bytes
    of the kernel's shared-memory layout, 0 where it cannot give a block
    that much; and ``max_active(C, smem)``, the clusters it keeps
    resident at once (``cudaOccupancyMaxActiveClusters``). C is the
    largest of :data:`CLUSTERS` whose band fits and for which all the
    launch's clusters are resident at once. When no C seats all G, the
    smallest C that fits takes as many chains as it seats, and the rest
    are planned again: on an H100 that seats 30 clusters of 4, G = 32
    runs as 30 chains at C = 4, then 2 at C = 16, not as a second wave of
    2 chains at C = 4. A chain's bits do not depend on the plan."""
    fits = {}
    for c in CLUSTERS:
        for nbuf in (2, 1):
            smem = smem_bytes(n, c, nbuf)
            if smem:
                fits[c] = (nbuf, smem)
                break
    if not fits:
        fits = {c: (0, smem_bytes(n, c, 0)) for c in CLUSTERS}
    plan = []
    while True:
        resident = [c for c in fits if max_active(c, fits[c][1]) >= G]
        if resident or G == 0:
            c = max(resident or fits)
            return plan + [(G, c, *fits[c])]
        c = min(fits)
        seated = max_active(c, fits[c][1])
        if seated < 1:
            return plan + [(G, c, *fits[c])]
        plan.append((seated, c, *fits[c]))
        G -= seated


def _lib():
    from .. import _build

    lib = _build.load("eig_warmstart")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.eig_warmstart_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                             i, i, p]
        lib.eig_warmstart_launch.restype = i
        lib.eigvec_warmstart_launch.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                                i, i, i, i, p]
        lib.eigvec_warmstart_launch.restype = i
        lib.eig_cold_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        lib.eig_cold_launch.restype = i
        lib.eig_max_active_clusters.argtypes = [i, i, p]
        lib.eig_max_active_clusters.restype = i
        lib.eig_smem_bytes.argtypes = [i, i, i, p]
        lib.eig_smem_bytes.restype = i
        lib.eig_warmstart_error_string.argtypes = [i]
        lib.eig_warmstart_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(lib, rc, what):
    if rc != 0:
        msg = lib.eig_warmstart_error_string(rc).decode()
        raise KernelError(f"eig_warmstart {what} failed ({rc}): {msg}")


_ANSWERS = {}


def _card(device):
    """The card ``device``'s answers to :func:`_cluster_plan`'s two
    questions, as its callables ``(smem_bytes, max_active)``; each
    answer is asked of the card once."""
    lib = _lib()

    def ask(fn, *args):
        key = (device.index, fn, *args)
        if key not in _ANSWERS:
            out = ctypes.c_int(0)
            with torch.cuda.device(device):
                rc = getattr(lib, fn)(*args, ctypes.byref(out))
            _check(lib, rc, fn)
            _ANSWERS[key] = out.value
        return _ANSWERS[key]

    return (lambda n, c, nbuf: ask("eig_smem_bytes", n, c, nbuf),
            lambda c, smem: ask("eig_max_active_clusters", c, smem))


def _launch(chains, mid, squarings, iters, with_vec, cold=False,
            stats=None):
    """Check a CUDA ``chains[G, L, 2, N, N]`` tensor and launch one
    cluster per chain on the current stream, in the launches
    :func:`_cluster_plan` gives: ``eig_warmstart_launch`` for λ alone,
    ``eigvec_warmstart_launch`` for λ and v, ``eig_cold_launch``
    (``cold``, chains of one) for the cold start alone. Returns λ, v and
    the number of launches. A dict ``stats`` gets the cold starts added
    to its ``"cold"``, the kernel's per-chain counts as
    ``"cold_per_chain"`` and the plan as ``"plan"`` (per launch:
    ``chains``, ``cluster``, ``nbuf``, ``smem``, and ``resident``, the
    clusters of that size the card keeps at once). Raises on anything
    the kernel does not take and on a refused launch."""
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
        return lam, v, 0
    smem_bytes, max_active = _card(dev)
    plan = _cluster_plan(G, n, smem_bytes, max_active)
    scratch = torch.empty((max(p[0] for p in plan), 2, 2, n, n),
                          dtype=torch.float32, device=dev)
    colds = (torch.empty(G, dtype=torch.int32, device=dev)
             if stats is not None else None)
    lib = _lib()
    args = (n, int(mid), int(squarings))

    def at(t, chain, per_chain):
        # address of chain `chain` of a float32/int32 tensor t
        return None if t is None else t.data_ptr() + 4 * chain * per_chain

    start = 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for g, c, nbuf, smem in plan:      # one after another on `stream`
            a_ptr = at(chains, start, L * 2 * n * n)
            lam_ptr = at(lam, start, L)
            if cold:
                rc = lib.eig_cold_launch(a_ptr, lam_ptr, at(colds, start, 1),
                                         scratch.data_ptr(), g, *args, c,
                                         nbuf, smem, stream)
            elif with_vec:
                rc = lib.eigvec_warmstart_launch(
                    a_ptr, lam_ptr, at(v, start, L * 2 * n),
                    at(colds, start, 1), scratch.data_ptr(), g, L, *args,
                    int(iters), c, nbuf, smem, stream)
            else:
                rc = lib.eig_warmstart_launch(
                    a_ptr, lam_ptr, at(colds, start, 1), scratch.data_ptr(),
                    g, L, *args, int(iters), c, nbuf, smem, stream)
            _check(lib, rc, "launch")
            start += g
    if stats is not None:
        stats["plan"] = [{"chains": g, "cluster": c, "nbuf": nbuf,
                          "smem": smem, "resident": max_active(c, smem)}
                         for g, c, nbuf, smem in plan]
        stats["cold"] = stats.get("cold", 0) + int(colds.sum())
        stats["cold_per_chain"] = colds
    return lam, v, len(plan)


def batched_eig_warmstart(a_ri, mid, squarings=10, iters=24, stats=None):
    """Dominant (largest-algebraic) eigenvalues of a (B, neta, 2, N, N)
    float32 batch of hermitian matrices, warm-starting each η from its
    predecessor within the same chunk b. Returns (B, neta) float32;
    the caller takes ``abs``. A dict ``stats`` gets the cold starts added
    to its ``"cold"`` (on the card also ``"cold_per_chain"`` and the
    launch ``"plan"``).

    A CPU tensor runs the plain version; a CUDA tensor launches
    ``csrc/eig_warmstart.cu`` (one thread-block cluster per chunk; N a
    multiple of 128, contiguous float32) or raises. Caveat (as the TPU
    kernel's): at a near-degenerate point of a dominant-eigenvector
    crossing the value may be any eigenvalue in [λ₂, λ₁]; it re-locks to
    λ₁ as the gap reopens."""
    if a_ri.device.type == "cpu":
        return batched_eig_warmstart_plain(a_ri, mid, squarings, iters,
                                           stats)
    if a_ri.ndim != 5:
        raise ValueError("a_ri must be (B, neta, 2, N, N)")
    lam, _, launched = _launch(a_ri, mid, squarings, iters, with_vec=False,
                               stats=stats)
    batched_eig_warmstart.launches += launched
    return lam


batched_eig_warmstart.launches = 0


def batched_eigvec_warmstart(a_ri, mid, squarings=10, iters=24, stats=None):
    """Dominant eigenpair of hermitian float32 matrices, warm-starting
    each matrix from its predecessor in its chain (the retrieval's
    chunk walk). ``a_ri`` is ``(B, 2, N, N)``, one chain as the TPU
    kernel takes it, → ``(λ[B], v_ri[B, 2, N])``; or ``(G, L, 2, N, N)``,
    G independent chains of L, → ``(λ[G, L], v_ri[G, L, 2, N])``. The
    first matrix of every chain starts cold. ``v`` is the unit
    eigenvector; its global phase is arbitrary. ``stats`` as in
    :func:`batched_eig_warmstart`.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    ``eigvec_warmstart_launch`` entry of ``csrc/eig_warmstart.cu`` (one
    cluster per chain; N a multiple of 128, contiguous float32) or
    raises. The near-degeneracy caveat of :func:`batched_eig_warmstart`
    holds."""
    if a_ri.device.type == "cpu":
        return batched_eigvec_warmstart_plain(a_ri, mid, squarings, iters,
                                              stats)
    lam, v, launched = _launch(_as_chains(a_ri), mid, squarings, iters,
                               with_vec=True, stats=stats)
    batched_eigvec_warmstart.launches += launched
    if a_ri.ndim == 4:
        return lam[0], v[0]
    return lam, v


batched_eigvec_warmstart.launches = 0


def batched_eig_cold(a_ri, mid, squarings=10, stats=None):
    """Dominant (largest-algebraic) eigenvalues of a ``(batch, 2, N, N)``
    float32 batch of hermitian matrices by the cold two-phase squaring
    start alone, no warm start (the TPU's ``batched_eig_pallas``).
    Returns ``(batch,)`` float32. ``stats`` as in
    :func:`batched_eig_warmstart`.

    A CPU tensor runs :func:`batched_eig_cold_plain`; a CUDA tensor
    launches the ``eig_cold_launch`` entry of ``csrc/eig_warmstart.cu``
    (one cluster per matrix; N a multiple of 128, contiguous float32) or
    raises."""
    if a_ri.device.type == "cpu":
        return batched_eig_cold_plain(a_ri, mid, squarings, stats)
    if a_ri.ndim != 4:
        raise ValueError("a_ri must be (batch, 2, N, N)")
    lam, _, launched = _launch(a_ri[:, None], mid, squarings, 0,
                               with_vec=False, cold=True, stats=stats)
    batched_eig_cold.launches += launched
    return lam[:, 0]


batched_eig_cold.launches = 0
