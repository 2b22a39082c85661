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


def resolve_device(device=None):
    """``None`` → ``cuda`` (raises ``RuntimeError`` when no GPU is
    present); anything else is passed to ``torch.device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "scintools_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
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
