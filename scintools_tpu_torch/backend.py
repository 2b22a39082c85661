"""Device and precision policy of the PyTorch/CUDA port.

Counterpart of the device/precision parts of
``scintools_tpu/backend.py:1-60`` (the JAX package picks a backend
name; here every public entry point takes ``device=``). ``None``
means the CUDA card: on a host without one that is an error, never a
silent fall-back to the CPU. The CPU is used only when a caller asks
for it (``device="cpu"``), as the tests do.

Precision: the hot path works in float32 / complex64 like the JAX
production path on its accelerator, so TF32 is switched off here for
both matrix products and cuDNN (TF32 keeps ~3 decimal digits, which
would silently loosen every parity tolerance).
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REAL = torch.float32


class KernelError(RuntimeError):
    """A hand-written kernel could not be built, loaded or launched, or
    no card is there to run it. The survey layer never descends a
    fallback tier or quarantines an epoch on it: a tier below would
    hide the broken kernel behind a slower route that launches none
    (``robust/ladder.py``, ``robust/runner.py``)."""


def is_kernel_error(exc):
    """True for a :class:`KernelError` and for a device fault: a kernel
    that faults inside its launch (an illegal address, say) surfaces
    only at the next synchronisation, as ``torch.AcceleratorError`` or a
    ``RuntimeError`` reading "CUDA error: ...". The survey layer treats
    both alike. An out-of-memory error is not one: it stays transient."""
    if isinstance(exc, KernelError):
        return True
    if (not isinstance(exc, RuntimeError)
            or isinstance(exc, torch.OutOfMemoryError)
            or "out of memory" in str(exc).lower()):
        return False
    accel = getattr(torch, "AcceleratorError", None)
    return ((accel is not None and isinstance(exc, accel))
            or str(exc).startswith("CUDA error"))


def resolve_device(device=None):
    """``None`` → ``cuda`` (raises :class:`KernelError`, a
    ``RuntimeError``, when no GPU is present); anything else is passed
    to ``torch.device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise KernelError(
                "scintools_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise KernelError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def fifo_cached(cache, key, build, maxsize):
    """``cache[key]``, made by ``build()`` on a miss; when the dict holds
    ``maxsize`` entries the oldest goes first. The port keeps its built
    functions (with their device grids) per geometry this way."""
    fn = cache.get(key)
    if fn is None:
        if len(cache) >= maxsize:
            cache.pop(next(iter(cache)))
        fn = cache[key] = build()
    return fn


def as_tensor(x, device, dtype=REAL):
    """``x`` (numpy array, scalar or tensor) as a contiguous ``dtype``
    tensor on ``device`` (a numpy view with negative strides, such as a
    flip, is copied first)."""
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
    return torch.as_tensor(x, dtype=dtype, device=device).contiguous()
