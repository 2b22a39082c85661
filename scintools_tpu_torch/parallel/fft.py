"""Distributed 2-D FFT over the mesh's ``seq`` axis.

Counterpart of ``scintools_tpu/parallel/fft.py``: ``make_fft2_sharded``
(:36), ``make_gs_sharded`` (:66) and ``make_sspec_power_sharded``
(:103, with its halved frame and its zoom band).

A spectrum's transform is split by rows over the ``seq`` shards of its
data row of the mesh. The classic decomposition: a local
FFT along the unsplit time axis, a block transpose (each shard sends
the s-th column block of its rows to shard s: the counterpart of
``all_to_all``), a local FFT along the now whole frequency axis, and
the transpose back. Between two shards of one process a block moves by
a device copy; on a mesh whose ``seq`` row spans processes the blocks
between ranks travel in one ``torch.distributed.all_to_all_single``
of bytes per transpose. The batch axis lies over ``data``. Every
function here takes and returns whole tensors (on every rank of a mesh
across processes, each computing only its own shards' parts): the
parts live on their devices only inside the call, and the result is
gathered on the mesh's first device. So the input and the output must
each fit on one device (the first); what the split spreads over the
cards is the transform's work and its intermediate parts, not the
array.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import formulation
from ..ops.sspec import fft_shapes
from ..ops.windows import apply_window
from ..ops.xfft import zoom_dft_1d
from .mesh import (SEQ_AXIS, Shards, _bytes, _nbytes, batch_freq_sharding,
                   gather, process_group, shard)


def _rows(mesh, x):
    """``x[B, R, C]`` → parts[d][s] = the d-th batch block's s-th row
    block, on ``mesh.devices[d, s]`` (:func:`.mesh.shard` by
    :func:`.mesh.batch_freq_sharding`, one list per data row; None where
    another rank holds the shard)."""
    parts = shard(x, batch_freq_sharding(mesh))
    ns = mesh.shape[SEQ_AXIS]
    return [parts[i:i + ns] for i in range(0, len(parts), ns)]


def _all_to_all(mesh, parts, split_axis, concat_axis):
    """The tiled all-to-all of one mesh row: shard s receives block s of
    every shard's ``split_axis`` and concatenates them, in shard order,
    along ``concat_axis``. This rank cuts its own parts into blocks; a
    block for a shard of this rank is copied to that shard's device, the
    others go into one byte buffer per destination rank, in (data row,
    destination, source) order, and travel in one
    ``all_to_all_single`` (skipped when no ``seq`` row spans ranks, as
    on a single-process mesh: the choice depends on the mesh alone, so
    every rank makes it alike). The parts of one data row share a shape
    and dtype, so a receiver knows each incoming block's from its own
    part of that row."""
    ns, me = mesh.shape[SEQ_AXIS], mesh.rank
    ranks, first = mesh.ranks, mesh.first
    got, send, recv = {}, {}, {}
    for d, row in enumerate(parts):
        mine = [p for p in row if p is not None]
        if not mine:
            continue
        ref = mine[0]
        n = ref.shape[split_axis]          # tensor_split's section sizes
        sizes = [n // ns + (k < n % ns) for k in range(ns)]
        blocks = [None if p is None else p.tensor_split(ns, dim=split_axis)
                  for p in row]
        for s in range(ns):
            for src in range(ns):
                r_src, r_dst = int(ranks[d, src]), int(ranks[d, s])
                if r_src == me and r_dst == me:
                    got[d, s, src] = blocks[src][s].to(mesh.devices[d, s],
                                                      non_blocking=True)
                elif r_src == me:
                    send.setdefault(r_dst, []).append(blocks[src][s])
                elif r_dst == me:
                    shape = list(ref.shape)
                    shape[split_axis] = sizes[s]
                    recv.setdefault(r_src, []).append(
                        ((d, s, src), ref.dtype, shape))
    if mesh.crosses_ranks:
        world = process_group().get_world_size()
        in_sizes = [sum(map(_nbytes, send.get(r, ()))) for r in range(world)]
        out_sizes = [sum(int(np.prod(shape)) * dtype.itemsize
                         for _, dtype, shape in recv.get(r, ()))
                     for r in range(world)]
        inp = torch.empty(sum(in_sizes), dtype=torch.uint8, device=first)
        off = 0
        for r in range(world):
            for b in send.get(r, ()):
                inp[off:off + _nbytes(b)] = _bytes(b).to(first)
                off += _nbytes(b)
        out = torch.empty(sum(out_sizes), dtype=torch.uint8, device=first)
        process_group().all_to_all_single(out, inp, out_sizes, in_sizes)
        off = 0
        for r in range(world):
            for key, dtype, shape in recv.get(r, ()):
                n = int(np.prod(shape)) * dtype.itemsize
                got[key] = out[off:off + n].view(dtype).reshape(shape).to(
                    mesh.devices[key[0], key[1]])
                off += n
    return [[torch.cat([got[d, s, src] for src in range(ns)],
                       dim=concat_axis)
             if row[s] is not None else None
             for s in range(ns)] for d, row in enumerate(parts)]


def _map(fn, parts):
    return [[None if p is None else fn(p) for p in row] for row in parts]


def _gather_rows(mesh, parts):
    """The inverse of :func:`_rows`, on the mesh's first device."""
    return gather(Shards([p for row in parts for p in row],
                         batch_freq_sharding(mesh)))


def _fft2_parts(mesh, parts, inverse=False):
    """fft2 over the trailing two axes of row-split parts, left
    row-split."""
    f = torch.fft.ifft if inverse else torch.fft.fft
    parts = _map(lambda p: f(p, dim=-1), parts)         # time axis, local
    parts = _all_to_all(mesh, parts, -1, -2)            # → [b, R, C/k]
    parts = _map(lambda p: f(p, dim=-2), parts)         # freq axis, local
    return _all_to_all(mesh, parts, -2, -1)             # → [b, R/k, C]


def make_fft2_sharded(mesh, inverse=False):
    """``fn(x[B, NF, NT]) → fft2(x)`` over the last two axes (``ifft2``
    with ``inverse``), B over 'data' and NF split over 'seq'. B must
    divide over the data axis and NF and NT over the seq axis
    (power-of-two padding guarantees the latter)."""
    k = mesh.shape[SEQ_AXIS]

    def fn(x):
        x = torch.as_tensor(x)
        if not x.is_complex():
            x = x.to(torch.complex128 if x.dtype == torch.float64
                     else torch.complex64)
        if x.shape[-1] % k:
            raise ValueError(f"seq axis {k} must divide NT={x.shape[-1]}")
        return _gather_rows(mesh, _fft2_parts(mesh, _rows(mesh, x),
                                              inverse))

    return fn


def make_gs_sharded(mesh):
    """Mesh-sharded Gerchberg–Saxton: ``fn(E[B, NF, NT] complex,
    amp[B, NF, NT], good[B, NF, NT], neg[NF], niter) → E`` with the
    frequency axis split over 'seq' and the batch over 'data'. The
    whole ``E``, ``amp`` and ``good`` come in and ``E`` goes out on one
    device, so the wavefield must fit on the mesh's first device; the
    loop's FFTs run on the row blocks of every shard. The loop is that
    of :func:`~..thth.retrieval.gerchberg_saxton` (amplitude
    replacement, then ``niter`` rounds of fft2 → zero the τ < 0 rows →
    ifft2 → replacement) on the distributed FFT. NF and NT
    must divide over the seq axis and B over the data axis. (The JAX
    package passes (real, imag) stacks; the port's wavefield is
    complex.)"""
    from ..thth.retrieval import gs_replace

    k = mesh.shape[SEQ_AXIS]

    def fn(E, amp, good, neg, niter):
        E = torch.as_tensor(E)
        if E.shape[-1] % k:
            raise ValueError(f"seq axis {k} must divide NT={E.shape[-1]}")
        neg = torch.as_tensor(neg).reshape(1, -1, 1).expand(
            E.shape[0], -1, 1)
        Ep, ap, gp, negp = (_rows(mesh, torch.as_tensor(a))
                            for a in (E, amp, good, neg))

        def replace(parts):
            return [[None if e is None else gs_replace(e, a, g)
                     for e, a, g in zip(*rows)]
                    for rows in zip(parts, ap, gp)]

        Ep = replace(Ep)
        for _ in range(int(niter)):
            S = _fft2_parts(mesh, Ep)
            S = [[None if s is None else s.masked_fill(n, 0)
                  for s, n in zip(*rows)] for rows in zip(S, negp)]
            Ep = replace(_fft2_parts(mesh, S, inverse=True))
        return _gather_rows(mesh, Ep)

    return fn


def make_sspec_power_sharded(mesh, nf, nt, window_arrays=None, halve=True,
                             variant=None, zoom=None):
    """The distributed secondary-spectrum power ``fn(dyns[B, nf, nt]) →
    power``: the pipeline of :func:`~..ops.sspec.secondary_spectrum_power`
    (mean-subtract → window → mean-subtract → pad to the FFT frame →
    transform → |·|² → positive delays, Doppler fftshift) with the
    transform split over 'seq' and the batch over 'data'.

    ``variant="half"`` transposes the real padded input
    first, takes the delay axis as an ``rfft`` and crops the halved rows
    before the Doppler transform; ``"dense"`` is the complex fft2 on
    the sharded FFT (``None``: the ``xfft.sspec`` formulation on the
    mesh's first device). ``halve=False`` always takes dense. ``zoom``, a
    ``((r0, r1, n_r), (c0, c1, n_c))`` band in bin units of the padded
    frame, computes only the band pixels (``variant`` then ``"czt"`` or
    ``"dense"``, ``None`` the ``xfft.zoom`` formulation), the row crop folded before the second transpose;
    ``n_r`` must divide over the seq axis. Returns
    ``[B, nrfft//2 or nrfft, ncfft]`` or ``[B, n_r, n_c]`` on the mesh's
    first device."""
    nrfft, ncfft = fft_shapes(nf, nt)
    k = mesh.shape[SEQ_AXIS]
    if nrfft % k or ncfft % k:
        raise ValueError(f"seq axis {k} must divide FFT shape "
                         f"({nrfft}, {ncfft})")

    def front(dyns):
        dyns = torch.as_tensor(dyns)
        if not dyns.is_floating_point() or dyns.dtype != torch.float64:
            dyns = dyns.to(torch.float32)
        dyns = dyns - dyns.mean(dim=(-2, -1), keepdim=True)
        if window_arrays is not None:
            dyns = apply_window(dyns, window_arrays[0], window_arrays[1])
        dyns = dyns - dyns.mean(dim=(-2, -1), keepdim=True)
        return torch.nn.functional.pad(dyns, (0, ncfft - nt, 0, nrfft - nf))

    if zoom is not None:
        if variant is None:
            variant = formulation("xfft.zoom", mesh.first)
        (r0, r1, n_r), (c0, c1, n_c) = zoom
        n_r, n_c = int(n_r), int(n_c)
        if n_r % k:
            raise ValueError(f"seq axis {k} must divide the zoom row "
                             f"count {n_r}")

        def zfn(dyns):
            parts = _rows(mesh, front(dyns))
            parts = _all_to_all(mesh, parts, -1, -2)     # real, rows whole
            parts = _map(lambda p: zoom_dft_1d(
                p.transpose(-1, -2), nrfft, r0, (r1 - r0) / n_r, n_r,
                variant=variant).transpose(-1, -2), parts)
            parts = _all_to_all(mesh, parts, -2, -1)     # [b, n_r/k, ncfft]
            parts = _map(lambda p: zoom_dft_1d(
                p, ncfft, c0, (c1 - c0) / n_c, n_c, variant=variant), parts)
            parts = _map(lambda F: (F * torch.conj(F)).real, parts)
            return _gather_rows(mesh, parts)

        return zfn

    if variant is None:
        variant = formulation("xfft.sspec", mesh.first)
    if variant not in ("half", "dense"):
        raise ValueError(f"unknown variant {variant!r} (want 'half' or "
                         "'dense')")
    if halve and variant == "half" and (nrfft // 2) % k == 0:
        def half_fn(dyns):
            parts = _rows(mesh, front(dyns))
            parts = _all_to_all(mesh, parts, -1, -2)     # real, rows whole
            parts = _map(lambda p: torch.fft.rfft(p, dim=-2)[
                ..., :nrfft // 2, :], parts)
            parts = _all_to_all(mesh, parts, -2, -1)
            parts = _map(lambda S: torch.fft.fftshift(
                (lambda F: (F * torch.conj(F)).real)(
                    torch.fft.fft(S, dim=-1)), dim=-1), parts)
            return _gather_rows(mesh, parts)

        return half_fn

    def dense_fn(dyns):
        x = front(dyns)
        x = x.to(torch.complex128 if x.dtype == torch.float64
                 else torch.complex64)
        parts = _fft2_parts(mesh, _rows(mesh, x))
        power = _gather_rows(mesh, _map(
            lambda F: (F * torch.conj(F)).real, parts))
        if halve:
            # unshifted rows [0, nrfft/2) are the positive delays that
            # fftshift-then-crop keeps
            power = power[:, :nrfft // 2]
        else:
            power = torch.roll(power, nrfft // 2, dims=1)
        return torch.fft.fftshift(power, dim=-1)

    return dense_fn


__all__ = ["make_fft2_sharded", "make_gs_sharded",
           "make_sspec_power_sharded"]
