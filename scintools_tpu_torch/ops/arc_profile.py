"""Arc-normalised Doppler profile: the hand-written Hopper kernel
``csrc/arc_profile.cu`` and its plain PyTorch version.

Counterpart of ``scintools_tpu/ops/arc_pallas.py:50``
(``make_arc_profile_pallas_fn``), at the kernel's own surface: for each
epoch b and query q, the masked mean over delay rows r of the two-tap
tent interpolation of row r (and of its bad mask) at
``pos = clip((fq·scale[b, r] − f0)/dfd, 0, nc − 1)``, where a row
counts when ``|fq·scale| ≤ fmax`` and no NaN bin has positive weight;
0 where no row counts. The TPU kernel's padding of columns and queries
to multiples of 128, its far-out sentinel query and its (8, Q)
broadcast output are TPU artefacts and are gone.

:func:`arc_profile` dispatches on the tensor's device: a CPU tensor
takes :func:`arc_profile_plain`, a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# the kernel stages two rows of nc floats in one block's shared memory
MAX_NC = 232448 // 8


def _f32(x):
    """A Python float rounded to float32, as the kernel receives it."""
    return float(np.float32(x))


def arc_profile_plain(s_masked, good, scales, fq, f0, dfd, fmax, nc):
    """The plain PyTorch version of :func:`arc_profile`: the kernel's
    arithmetic, one delay row at a time over the (B, Q) batch, summed in
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


def _lib():
    from .. import _build

    lib = _build.load("arc_profile")
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.arc_profile_launch.argtypes = [p, p, p, p, p, i, i, i, i, f, f, f,
                                           p]
        lib.arc_profile_launch.restype = i
        lib.arc_profile_error_string.argtypes = [i]
        lib.arc_profile_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(s_masked, good, scales, fq, nc):
    """Raise on anything the kernel does not take."""
    dev = s_masked.device
    for name, t in (("s_masked", s_masked), ("good", good),
                    ("scales", scales), ("fq", fq)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, s_masked on {dev}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor, "
                             f"got {t.dtype} with strides {t.stride()}")
    if s_masked.ndim != 3 or good.shape != s_masked.shape:
        raise ValueError(f"s_masked {tuple(s_masked.shape)} and good "
                         f"{tuple(good.shape)} must be one (B, R, nc) shape")
    B, R, n = s_masked.shape
    if scales.shape != (B, R) or fq.ndim != 1:
        raise ValueError(f"scales {tuple(scales.shape)} must be {(B, R)} and "
                         f"fq one-dimensional, got {tuple(fq.shape)}")
    if n != int(nc) or not 1 <= n <= MAX_NC or B > 65535:
        raise ValueError(f"nc {nc} vs rows of {n} columns: want them equal, "
                         f"1 <= nc <= {MAX_NC}, and at most 65535 epochs")


def arc_profile(s_masked, good, scales, fq, f0, dfd, fmax, nc):
    """Arc-normalised profiles ``(B, Q)`` float32 of ``s_masked`` and
    ``good`` ``(B, R, nc)`` float32 (``s_masked`` 0 where NaN, ``good``
    1 where finite), ``scales`` ``(B, R)`` = √(tdel_r/η_b) and the query
    grid ``fq`` ``(Q,)``; ``f0 = fdop[0]``, ``dfd`` the mean Doppler step
    and ``fmax = max|fdop|`` (rounded to float32).

    A CPU tensor runs :func:`arc_profile_plain`; a CUDA tensor launches
    ``csrc/arc_profile.cu`` (contiguous float32 on one device, nc up to
    ``MAX_NC``) or raises."""
    if s_masked.device.type == "cpu":
        return arc_profile_plain(s_masked, good, scales, fq, f0, dfd, fmax,
                                 nc)
    if s_masked.device.type != "cuda":
        raise ValueError(f"unsupported device {s_masked.device}")
    _check(s_masked, good, scales, fq, nc)
    B, R, n = s_masked.shape
    Q = fq.shape[0]
    out = torch.empty((B, Q), dtype=torch.float32, device=s_masked.device)
    if B == 0 or Q == 0:
        return out
    lib = _lib()
    with torch.cuda.device(s_masked.device):
        stream = torch.cuda.current_stream(s_masked.device).cuda_stream
        rc = lib.arc_profile_launch(
            s_masked.data_ptr(), good.data_ptr(), scales.data_ptr(),
            fq.data_ptr(), out.data_ptr(), B, R, n, Q, _f32(f0), _f32(dfd),
            _f32(fmax), stream)
    if rc != 0:
        msg = lib.arc_profile_error_string(rc).decode()
        raise RuntimeError(f"arc_profile launch failed ({rc}): {msg}")
    arc_profile.launches += 1
    return out


arc_profile.launches = 0
