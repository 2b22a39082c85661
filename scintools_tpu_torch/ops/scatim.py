"""Scattered-image interpolation: secondary-spectrum power → (θx, θy)
plane, on a torch device.

Counterpart of ``scintools_tpu/ops/scatim.py:63-205``: ``_keys_1d``,
``_keys_weights``, ``_pad_edge``, ``cubic_interp2d`` in both
formulations, ``is_uniform`` and ``scattered_image_interp``. Both
secondary-spectrum axes are uniform FFT grids, so the reference's host
bicubic spline becomes a Keys (a = −0.5) cubic-convolution interpolation
in index coordinates, clamped to the grid:

- ``"gather"``: the 16-tap stencil as flat gathers from the edge-padded
  grid, O(16) work per query;
- ``"matmul"``: per image row, dense Keys weight matrices over each
  axis, ``Σ_r Wt[q, r]·(Wf @ linᵀ)[q, r]``, O(nr·nc) work per query.

The choice is the ``ops.scatim_interp`` formulation (the JAX package's
:41, registered here). The JAX package picks ``"matmul"`` on the TPU and
``"gather"`` on the CPU; the port's entry is ``"gather"`` on both
devices: ``chip_smoke.py`` phase 11.2 times both (PERF.md §6).
Everything runs in the dtype of ``lin`` (float64 for numpy input) on
``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import formulation, register_formulation, resolve_device

register_formulation(
    "ops.scatim_interp", default="matmul", choices=("matmul", "gather"),
    platforms={"cpu": "gather", "cuda": "gather"},
    doc="scattered-image cubic interpolation: dense Keys-weight products "
        "vs the 16-tap flat gather")

#: elements of one (rows, nx, n_src) weight slab of the matmul form
_SLAB_ELEMS = 1 << 25


def _keys_1d(u):
    """The Keys (a = −0.5) cubic-convolution kernel, elementwise."""
    au = u.abs()
    au2 = au * au
    au3 = au2 * au
    near = 1.5 * au3 - 2.5 * au2 + 1.0
    far = -0.5 * au3 + 2.5 * au2 - 4.0 * au + 2.0
    return torch.where(au <= 1.0, near,
                       torch.where(au < 2.0, far, torch.zeros_like(au)))


def _keys_weights(pos, n_src):
    """Dense Keys weights ``[..., nq, n_src + 2]`` of index coordinates
    ``pos[..., nq]`` (clamped to [0, n_src − 1]) against the edge-padded
    axis."""
    src = torch.arange(n_src + 2, dtype=pos.dtype, device=pos.device)
    return _keys_1d((pos[..., None] + 1.0) - src)


def _pad_edge(lin):
    """Replicate one row and one column on each side (the clamped-query
    boundary condition)."""
    lin = torch.cat([lin[:1], lin, lin[-1:]], dim=0)
    return torch.cat([lin[:, :1], lin, lin[:, -1:]], dim=1)


def _as(x, dev, dtype=None):
    if isinstance(x, torch.Tensor):
        return x.to(dev) if dtype is None else x.to(dev, dtype)
    return torch.as_tensor(np.asarray(x, dtype=float), device=dev,
                           dtype=dtype or torch.float64)


def cubic_interp2d(lin, tpos, fpos, method=None, device=None):
    """Cubic-convolution interpolation of ``lin[nr, nc]`` at float index
    coordinates ``tpos``/``fpos`` (``[ny, nx]`` each, the delay and
    Doppler axes), clamped to the grid → ``[ny, nx]`` tensor on
    ``device`` (``None``: the CUDA card) in ``lin``'s dtype.
    ``method``: ``"gather"`` or ``"matmul"`` (``None``/``"auto"``: the
    ``ops.scatim_interp`` formulation on ``device``)."""
    dev = resolve_device(device)
    if method in (None, "auto"):
        method = formulation("ops.scatim_interp", dev.type)
    if method not in ("gather", "matmul"):
        raise ValueError(f"method must be 'auto', 'matmul' or 'gather', "
                         f"got {method!r}")
    lin = _as(lin, dev)
    tq = _as(tpos, dev, lin.dtype)
    fq = _as(fpos, dev, lin.dtype)
    nr, nc = lin.shape
    lin_p = _pad_edge(lin)
    tq = tq.clamp(0, nr - 1)
    fq = fq.clamp(0, nc - 1)
    if method == "matmul":
        ny, nx = tq.shape
        rows = max(1, _SLAB_ELEMS // max(1, nx * (max(nr, nc) + 2)))
        out = []
        for r0 in range(0, ny, rows):
            wf = _keys_weights(fq[r0:r0 + rows], nc)      # (b, nx, nc+2)
            wt = _keys_weights(tq[r0:r0 + rows], nr)      # (b, nx, nr+2)
            m = wf @ lin_p.T                              # (b, nx, nr+2)
            out.append((wt * m).sum(-1))
        return torch.cat(out, dim=0)
    # the 16-tap stencil as one flat gather: a base index per query and
    # 16 fixed offsets, with the 4 + 4 Keys weights of each query made
    # once; the base cell is clamped so the taps stay inside the padded
    # grid (on the last node the fraction is 1, where the Keys weights
    # give the node's value)
    flat = lin_p.reshape(-1)
    ncp = nc + 2
    it = torch.clamp(torch.floor(tq).to(torch.int64), 0, nr - 2)
    jf = torch.clamp(torch.floor(fq).to(torch.int64), 0, nc - 2)
    taps = torch.arange(-1, 3, device=dev)
    shape = (4,) + (1,) * tq.ndim
    wt = _keys_1d((tq - it) - taps.view(shape).to(tq.dtype))    # (4, …)
    wf = _keys_1d((fq - jf) - taps.view(shape).to(fq.dtype))    # (4, …)
    base = (it + 1) * ncp + (jf + 1)
    offs = (taps[:, None] * ncp + taps[None, :]).view((16,) + shape[1:])
    vals = flat[base + offs].view((4, 4) + tq.shape)
    return (wt * (wf[None] * vals).sum(1)).sum(0)


def is_uniform(axis, rtol=1e-6):
    """True when ``axis`` is an ascending uniform grid, the precondition
    for index-arithmetic interpolation."""
    axis = np.asarray(axis, dtype=float)
    d = np.diff(axis)
    return d.size > 0 and np.all(d > 0) and np.allclose(d, d[0], rtol=rtol)


def scattered_image_interp(linsspec, tdel, fdop, tdel_q, fdop_q, method=None,
                           device=None):
    """Interpolate the linear-power secondary spectrum at the
    ``(tdel_q, fdop_q)`` query grids (a tensor on ``device``). The axes
    must be uniform; a ValueError tells the caller to take the host
    spline instead."""
    tdel = np.asarray(tdel, dtype=float)
    fdop = np.asarray(fdop, dtype=float)
    if not (is_uniform(tdel) and is_uniform(fdop)):
        raise ValueError("non-uniform axis — host-spline territory")
    tpos = (np.asarray(tdel_q, dtype=float) - tdel[0]) / (tdel[1] - tdel[0])
    fpos = (np.asarray(fdop_q, dtype=float) - fdop[0]) / (fdop[1] - fdop[0])
    return cubic_interp2d(linsspec, tpos, fpos, method=method, device=device)
