"""Arc-normalised Doppler profile: the hand-written Hopper kernel
``csrc/arc_profile.cu`` and its plain PyTorch versions.

Counterpart of ``scintools_tpu/ops/arc_pallas.py:50``
(``make_arc_profile_pallas_fn``) and of the preparation around it in the
JAX program (``scintools_tpu/ops/normsspec.py:269-281``): for each epoch
b and query q, the masked mean over delay rows r of the two-tap tent
interpolation of row r at ``pos = clip((fq·scale[b, r] − f0)/dfd, 0,
nc − 1)``, where a row counts when ``|fq·scale| ≤ fmax`` and no NaN bin
(a bin of the central cut counts as NaN) has positive weight; 0 where
no row counts. The TPU kernel's padding of columns and queries to
multiples of 128, its far-out sentinel query and its (8, Q) broadcast
output are TPU artefacts and are gone.

Two surfaces:

- :func:`arc_profile_plain` keeps the TPU kernel's own: the cropped
  rows pre-masked (0 at NaN) and the float ``good`` plane;
- :func:`arc_profile` (the kernel's wrapper) and
  :func:`arc_profile_rows_plain` take the spectra as they are, with the
  row range, the cut and ``scales``; the kernel crops, masks and cuts
  as it reads, so no ``good`` plane and no cropped copy exist.

:func:`arc_profile` dispatches on the tensor's device: a CPU tensor
takes :func:`arc_profile_rows_plain`, a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..backend import KernelError

# CTAs per work unit (one epoch's queries). The plan takes C = 1: on the
# H100 no C > 1 was faster at 1, 16, 64 or 128 epochs (PERF.md §6); the
# others run where a caller forces them
CLUSTERS = (1, 2, 4, 8)
RING_BYTES = 65536           # the ring's size the plan aims at
COPY_BYTES = 16384           # the bytes of one bulk copy it aims at


def _f32(x):
    """A Python float rounded to float32, as the kernel receives it."""
    return float(np.float32(x))


def arc_profile_plain(s_masked, good, scales, fq, f0, dfd, fmax, nc):
    """The plain PyTorch version at the TPU kernel's surface: ``s_masked``
    and ``good`` ``(B, R, nc)`` float32 (0 / 1 where NaN), the kernel's
    arithmetic one delay row at a time over the (B, Q) batch, summed in
    row order as the kernel sums."""
    f0, fmax = _f32(f0), _f32(fmax)
    # a tensor divisor: a CUDA division by a Python scalar multiplies by
    # its reciprocal, where the kernel divides
    dfd = torch.full((), _f32(dfd), dtype=scales.dtype, device=scales.device)
    zero = torch.zeros((), dtype=scales.dtype, device=scales.device)
    B, R, _ = s_masked.shape
    num = torch.zeros((B, fq.shape[0]), dtype=s_masked.dtype,
                      device=s_masked.device)
    den = torch.zeros_like(num)
    for r in range(R):
        row, bad = s_masked[:, r], 1.0 - good[:, r]
        xq = scales[:, r, None] * fq
        pos = ((xq - f0) / dfd).clamp(0.0, nc - 1.0)
        k0 = pos.floor()
        k1 = k0 + 1.0
        i0, i1 = k0.long(), k1.clamp_max(nc - 1).long()
        w0 = (1.0 - (pos - k0).abs()).clamp_min(0.0)
        w1 = torch.where(k1 <= nc - 1,
                         (1.0 - (pos - k1).abs()).clamp_min(0.0), zero)
        val = w0 * row.gather(1, i0) + w1 * row.gather(1, i1)
        nanw = w0 * bad.gather(1, i0) + w1 * bad.gather(1, i1)
        ok = ((xq.abs() <= fmax) & (nanw <= 0.0)).to(num.dtype)
        num = num + val * ok
        den = den + ok
    return torch.where(den > 0, num / den.clamp_min(1.0), zero)


def arc_profile_rows_plain(spectra, scales, fq, startbin, cut, f0, dfd,
                           fmax):
    """The plain version of :func:`arc_profile`: rows ``startbin …
    startbin + R − 1`` of ``spectra``, the cut columns ``[c0, c1)`` set
    to NaN, the NaN mask taken, then :func:`arc_profile_plain`."""
    R, nc = scales.shape[1], spectra.shape[2]
    s = spectra[:, startbin:startbin + R, :]
    c0, c1 = cut
    if c1 > c0:
        s = s.clone()
        s[:, :, c0:c1] = float("nan")
    good = ~torch.isnan(s)
    return arc_profile_plain(torch.where(good, s, 0.0).contiguous(),
                             good.to(torch.float32), scales, fq, f0, dfd,
                             fmax, nc)


def _stages(nc, smem_bytes, max_rows):
    """Rows per bulk copy k (at most ``max_rows``) and stages S of the
    ring for rows of nc floats: copies of about :data:`COPY_BYTES`, a
    ring of about :data:`RING_BYTES`, at least two stages; shrunk until
    the card gives a block the ring (``smem_bytes(k, S)``, 0 where it
    cannot). Returns ``(k, S, smem bytes)``."""
    row = 4 * nc
    k = max(1, min(max_rows, COPY_BYTES // row))
    S = max(2, min(8, RING_BYTES // (k * row)))
    while True:
        smem = smem_bytes(k, S)
        if smem:
            return k, S, smem
        if k > 1:
            k //= 2
        elif S > 2:
            S -= 1
        else:
            raise ValueError(f"rows of {nc} columns do not fit two stages "
                             "of the ring in shared memory")


def _plan(B, Q, nc, smem_bytes, max_active, limits, cluster=None):
    """The kernel's launch plan for B epochs of Q queries on rows of nc
    floats: a list of launches, each a dict ``epochs`` (consecutive, run
    one launch after another), ``cluster`` C, ``passes`` (work units per
    epoch; each reads the rows once), ``warps`` (consumer warps per
    CTA), ``rows`` k and ``stages`` S of the ring, ``smem`` and
    ``resident`` (the work units of this shape the card keeps at once).

    The card answers ``smem_bytes(k, S)`` (see :func:`_stages`) and
    ``max_active(C, warps, smem)`` (``cudaOccupancyMaxActiveClusters``,
    or blocks per SM times the SMs at C = 1); ``limits`` is ``(query slots
    per thread, consumer warps per CTA, rows per stage)`` at most, the
    kernel's. A work unit of C CTAs (1, or ``cluster`` where given)
    gives each CTA 1/C of an epoch's queries in ``passes`` parts. A
    launch takes as many epochs as the card seats work units; the rest
    run in further launches of the same shape. A query's bits do not
    depend on the plan."""
    qpt, max_warps, max_rows = limits
    k, S, smem = _stages(nc, smem_bytes, max_rows)
    C = cluster or 1
    passes = -(-Q // (C * max_warps * 32 * qpt))
    per_cta = -(-Q // (C * passes))
    warps = min(max_warps, -(-per_cta // 32))
    seated = max_active(C, warps, smem)
    if seated < passes:
        raise KernelError(f"the card seats no work unit of {C} CTAs "
                           f"with {smem} B of shared memory")
    plan = []
    while B > 0:
        n = min(B, seated // passes, 65535)
        plan.append({"epochs": n, "cluster": C, "passes": passes,
                     "warps": warps, "rows": k, "stages": S, "smem": smem,
                     "resident": seated})
        B -= n
    return plan


def _lib():
    from .. import _build

    lib = _build.load("arc_profile")
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.arc_profile_launch.argtypes = [
            p, p, p, p, i, i, i, i, ctypes.c_longlong, i, i, i, f, f, f,
            i, i, i, i, i, i, i, p]
        lib.arc_profile_launch.restype = i
        lib.arc_profile_max_active.argtypes = [i, i, i, p]
        lib.arc_profile_max_active.restype = i
        lib.arc_profile_smem_bytes.argtypes = [i, i, i, p]
        lib.arc_profile_smem_bytes.restype = i
        lib.arc_profile_limits.argtypes = [p, p, p]
        lib.arc_profile_limits.restype = i
        lib.arc_profile_skip.argtypes = [i, f, f, f, p]
        lib.arc_profile_skip.restype = i
        lib.arc_profile_error_string.argtypes = [i]
        lib.arc_profile_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _raise(lib, rc, what):
    if rc != 0:
        msg = lib.arc_profile_error_string(rc).decode()
        raise KernelError(f"arc_profile {what} failed ({rc}): {msg}")


_ANSWERS = {}
_PLANS = {}         # (device index, B, Q, nc, cluster) → the launch plan


def _card(device, nc):
    """The card ``device``'s answers to :func:`_plan`'s questions:
    ``(smem_bytes, max_active, limits)``; each is asked of the card
    once."""
    lib = _lib()

    def ask(fn, *args, n_out=1):
        key = (device.index, fn, *args)
        if key not in _ANSWERS:
            outs = [ctypes.c_int(0) for _ in range(n_out)]
            with torch.cuda.device(device):
                rc = getattr(lib, fn)(*args, *map(ctypes.byref, outs))
            _raise(lib, rc, fn)
            _ANSWERS[key] = tuple(o.value for o in outs)
        return _ANSWERS[key]

    return (lambda k, S: ask("arc_profile_smem_bytes", nc, k, S)[0],
            lambda c, warps, smem: ask("arc_profile_max_active", c, warps,
                                       smem)[0],
            ask("arc_profile_limits", n_out=3))


def _check(spectra, scales, fq, startbin, cut):
    """Raise on anything the kernel does not take."""
    dev = spectra.device
    for name, t in (("spectra", spectra), ("scales", scales), ("fq", fq)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, spectra on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if spectra.ndim != 3 or scales.ndim != 2 or fq.ndim != 1:
        raise ValueError(f"spectra {tuple(spectra.shape)}, scales "
                         f"{tuple(scales.shape)} and fq {tuple(fq.shape)} "
                         "must be (B, ntdel, nc), (B, R) and (Q,)")
    B, ntdel, nc = spectra.shape
    R = scales.shape[1]
    if spectra.stride(2) != 1 or (ntdel > 1 and spectra.stride(1) != nc):
        raise ValueError(f"spectra's rows must be contiguous, got strides "
                         f"{spectra.stride()}")
    if not scales.is_contiguous() or not fq.is_contiguous():
        raise ValueError("scales and fq must be contiguous")
    c0, c1 = cut
    if scales.shape[0] != B or not 0 <= startbin <= startbin + R <= ntdel \
            or not 0 <= c0 <= c1 <= nc or nc < 1:
        raise ValueError(f"scales {tuple(scales.shape)} for {B} epochs, rows "
                         f"{startbin} … {startbin + R - 1} of {ntdel}, cut "
                         f"{cut} of {nc} columns: want B equal, the rows and "
                         "the cut inside, nc >= 1")


def arc_profile(spectra, scales, fq, startbin, cut, f0, dfd, fmax,
                cluster=None, stats=None):
    """Arc-normalised profiles ``(B, Q)`` float32 of the rows ``startbin
    … startbin + R − 1`` of ``spectra`` ``(B, ntdel, nc)`` float32 (dB,
    NaN where masked), with the columns ``cut = (c0, c1)`` counted as
    NaN, ``scales`` ``(B, R)`` = √(tdel_r/η_b) and the query grid ``fq``
    ``(Q,)``; ``f0 = fdop[0]``, ``dfd`` the mean Doppler step and ``fmax =
    max|fdop|`` (rounded to float32).

    A CPU tensor runs :func:`arc_profile_rows_plain`; a CUDA tensor
    launches ``csrc/arc_profile.cu`` or raises. It reads ``spectra`` in
    place: float32 rows contiguous, any epoch stride. ``cluster`` forces
    the CTAs per work unit (1, 2, 4 or 8; the plan takes 1); a dict
    ``stats`` gets the plan (``stats["plan"]``, see :func:`_plan`, each
    launch with ``bulk``: whether rows arrive by bulk copy, and ``skip``:
    whether queries outside a row's support are skipped)."""
    if spectra.device.type == "cpu":
        return arc_profile_rows_plain(spectra, scales, fq, startbin, cut,
                                      f0, dfd, fmax)
    if spectra.device.type != "cuda":
        raise ValueError(f"unsupported device {spectra.device}")
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"cluster {cluster} not in {CLUSTERS}")
    cut = tuple(int(c) for c in cut)
    startbin = int(startbin)
    _check(spectra, scales, fq, startbin, cut)
    B, _, nc = spectra.shape
    R, Q = scales.shape[1], fq.shape[0]
    dev = spectra.device
    out = torch.empty((B, Q), dtype=torch.float32, device=dev)
    if B == 0 or Q == 0:
        return out
    key = (dev.index, B, Q, nc, cluster)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _plan(B, Q, nc, *_card(dev, nc), cluster)
    stride = spectra.stride(0)
    # rows by cp.async.bulk need 16-byte aligned rows and copies
    bulk = nc % 4 == 0 and stride % 4 == 0 and spectra.data_ptr() % 16 == 0
    lib = _lib()
    start = 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for p in plan:                    # one after another on `stream`
            rc = lib.arc_profile_launch(
                spectra.data_ptr() + 4 * start * stride,
                scales.data_ptr() + 4 * start * R, fq.data_ptr(),
                out.data_ptr() + 4 * start * Q, p["epochs"], R, nc, Q,
                stride, startbin, cut[0], cut[1], _f32(f0), _f32(dfd),
                _f32(fmax), p["cluster"], p["passes"], p["warps"],
                p["rows"], p["stages"], p["smem"], int(bulk), stream)
            _raise(lib, rc, "launch")
            arc_profile.launches += 1
            start += p["epochs"]
    if stats is not None:
        skip = ctypes.c_int(0)
        _raise(lib, lib.arc_profile_skip(nc, _f32(f0), _f32(dfd), _f32(fmax),
                                         ctypes.byref(skip)), "skip")
        stats["plan"] = [dict(p, bulk=bulk, skip=bool(skip.value))
                         for p in plan]
    return out


arc_profile.launches = 0
