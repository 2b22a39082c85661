"""NaN refill: biharmonic inpainting on the host, the median refill's
neighbourhood sort on the device.

Counterpart of ``scintools_tpu/ops/inpaint.py``: ``inpaint_biharmonic``
(:24, a scipy sparse solve of ∇⁴u = 0 over the masked pixels with the
observed ones as boundary values, float64 on the host as there),
``median_filter_2d`` (:68, ``scipy.signal.medfilt`` semantics as a
(k², H, W) sort in torch on ``device``) and ``refill_median`` (:102).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.linalg import spsolve

from ..backend import resolve_device

# 13-point biharmonic stencil (discrete ∇⁴)
_STENCIL = [
    ((0, 0), 20.0),
    ((-1, 0), -8.0), ((1, 0), -8.0), ((0, -1), -8.0), ((0, 1), -8.0),
    ((-1, -1), 2.0), ((-1, 1), 2.0), ((1, -1), 2.0), ((1, 1), 2.0),
    ((-2, 0), 1.0), ((2, 0), 1.0), ((0, -2), 1.0), ((0, 2), 1.0),
]


def inpaint_biharmonic(image, mask):
    """Fill the ``mask`` pixels of ``image`` by solving ∇⁴u = 0; stencil
    points that fall outside the grid are dropped (a free boundary)."""
    image = np.asarray(image, dtype=float)
    mask = np.asarray(mask, dtype=bool)
    out = np.array(image)
    if not mask.any():
        return out
    ny, nx = image.shape
    unknown = np.flatnonzero(mask.ravel())
    index_of = -np.ones(ny * nx, dtype=int)
    index_of[unknown] = np.arange(len(unknown))

    n = len(unknown)
    b = np.zeros(n)
    filled = np.where(mask, 0.0, image)
    flat_mask = mask.ravel()
    flat_img = filled.ravel()

    # one vectorised pass per stencil offset
    ys, xs = np.unravel_index(unknown, (ny, nx))
    rows_acc, cols_acc, vals_acc = [], [], []
    row_idx = np.arange(n)
    for (dy, dx), w in _STENCIL:
        yy, xx = ys + dy, xs + dx
        ok = (yy >= 0) & (yy < ny) & (xx >= 0) & (xx < nx)
        flat = yy[ok] * nx + xx[ok]
        rows = row_idx[ok]
        isunk = flat_mask[flat]
        rows_acc.append(rows[isunk])
        cols_acc.append(index_of[flat[isunk]])
        vals_acc.append(np.full(int(isunk.sum()), w))
        np.subtract.at(b, rows[~isunk], w * flat_img[flat[~isunk]])
    A = coo_matrix((np.concatenate(vals_acc),
                    (np.concatenate(rows_acc), np.concatenate(cols_acc))),
                   shape=(n, n)).tocsr()
    out[mask] = spsolve(A, b)
    return out


def median_filter_2d(arr, kernel_size=5, device=None):
    """2-D median filter with ``scipy.signal.medfilt`` semantics (zero
    padding, odd kernel; ``kernel_size`` an int or an odd (kf, kt)
    pair) on ``device`` (``None``: the CUDA card), in the input's
    dtype: the (kf·kt, H, W) neighbourhood stack sorted along its first
    axis. Returns a tensor on ``device``."""
    dev = resolve_device(device)
    if np.isscalar(kernel_size):
        kf = kt = int(kernel_size)
    else:
        kf, kt = (int(k) for k in kernel_size)
    if kf % 2 == 0 or kt % 2 == 0:
        raise ValueError("kernel_size must be odd (medfilt semantics)")
    a = torch.as_tensor(arr, device=dev)
    H, W = a.shape
    pf, pt = kf // 2, kt // 2
    pad = torch.nn.functional.pad(a, (pt, pt, pf, pf))
    stack = torch.stack([pad[i:i + H, j:j + W]
                         for i in range(kf) for j in range(kt)])
    return torch.sort(stack, dim=0).values[(kf * kt) // 2]


def refill_median(dyn, kernel_size=5, device=None):
    """Replace the NaNs of ``dyn`` by the kernel median of the array
    with its NaNs set to the mean of its finite pixels (float64; the
    sort on ``device``)."""
    arr = np.array(dyn, dtype=float)
    nanmask = np.isnan(arr)
    if not nanmask.any():
        return arr
    # finite-only mean: a stray ±inf pixel must not poison every fill
    arr[nanmask] = np.mean(arr[np.isfinite(arr)])
    med = median_filter_2d(arr, kernel_size, device=device).cpu().numpy()
    out = np.array(dyn, dtype=float)
    out[nanmask] = med[nanmask]
    return out
