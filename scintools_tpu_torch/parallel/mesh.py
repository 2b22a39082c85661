"""The device mesh of the port, within one process or across several.

Counterpart of ``scintools_tpu/parallel/mesh.py``: ``DATA_AXIS`` and
``SEQ_AXIS`` (:20-21), ``device_count`` (:24), ``_largest_pow2_divisor``
(:27), ``make_mesh`` (:34), ``data_sharding`` (:60),
``batch_freq_sharding`` (:70), ``chunk_shardings`` (:79) and
``replicated`` (:89).

The JAX design is one controller: a 2-D mesh with axes ``('data',
'seq')`` over the devices of one process, or, after
``jax.distributed.initialize``, over every process's devices, each
process running the same program on the whole arrays. The port keeps
both. A :class:`Mesh` is an object array of ``torch.device``s of shape
(data, seq), and a mesh may name one device more than once. Such
virtual shards are how the tests run a mesh on the CPU
(``make_mesh(8, devices=["cpu"] * 8)``) and how one card runs a
four-shard mesh; on a single card they measure only the cost of
splitting and gathering.

Without a process group one process drives every shard. After
:func:`~.checkpoint.initialize_distributed` (``torch.distributed``, one
process per card, or several processes sharing a card over gloo),
:func:`make_mesh` builds a global mesh over every rank's local devices
in rank-major order and records each shard's rank (``Mesh.ranks``).
Every rank then calls each mesh function with the same whole
arguments; it computes only the shards its own devices hold and gets
back the whole result on its first local device (:func:`exchange`:
one ``all_gather_object`` of the outputs' layout, one ``all_gather``
of their bytes). The process group's timeout bounds every such wait,
so a rank whose peer failed ends with an error instead of hanging.

A sharding descriptor says how an array's axes lie over the mesh;
:func:`shard` cuts a tensor into the per-device parts it names (one
contiguous slice of the split axis per device, in device order over
data × seq) and :func:`gather` puts them back together on the mesh's
first device. :func:`run_lanes` is what the sharded survey paths
(``parallel/survey.py``) are built on: it splits the leading (lane)
axis of its inputs over the mesh, calls each shard's function in turn
under its own device's context, and gathers the outputs in shard order.

In each process one thread issues its shards, one after another. Shards on different
cards overlap only as far as a shard's function returns without
waiting on its device (its work then runs while the next shard's is
issued). A function that reads a device value on the host runs its
shard to that point before the loop goes on, so such shards run
serially even on separate cards: the LM fits (``fit/lm.py`` reads its
active mask every iteration; the acf2d fit returns host arrays) and so
:func:`~.survey.make_acf2d_fit_sharded`,
:func:`~.survey.make_survey_step` and the façade's mesh fits. A thread
per card would not lift this for the LM paths: torch's forward-mode AD
levels, which the LM's Jacobian uses, are process state. One process
per card does: its shards then run while the other ranks run theirs.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..backend import KernelError

DATA_AXIS = "data"
SEQ_AXIS = "seq"


class Mesh:
    """A (data, seq) grid of ``torch.device``s. ``.devices`` is the object
    array, ``.axis_names`` the axis names and ``.shape`` an ordered
    mapping from axis name to size, as the JAX ``Mesh`` has them, so
    ``np.prod(list(mesh.shape.values()))`` is the shard count.

    ``ranks`` (the same grid of process ranks) makes it a mesh of the
    initialised process group seen from rank ``rank``: ``.distributed``
    is then true, and ``home`` is where this rank gathers when it holds
    no shard. Without ``ranks`` every shard is this process's."""

    def __init__(self, devices, axis_names=(DATA_AXIS, SEQ_AXIS),
                 ranks=None, rank=0, home=None):
        arr = np.empty(np.shape(devices)[:2], dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(devices[idx[0]][idx[1]])
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, arr.shape))
        self.distributed = ranks is not None
        self.ranks = np.zeros(arr.shape, dtype=int) if ranks is None \
            else np.asarray(ranks, dtype=int).reshape(arr.shape)
        self.rank = int(rank)
        self.home = arr[0, 0] if home is None else torch.device(home)

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def flat_devices(self):
        """The devices in shard order (data-major, then seq)."""
        return list(self.devices.ravel())

    @property
    def local(self):
        """Per shard, in shard order: whether this process holds it."""
        return [int(r) == self.rank for r in self.ranks.ravel()]

    @property
    def crosses_ranks(self):
        """Whether some ``seq`` row has shards on more than one rank (its
        distributed FFT then exchanges blocks between processes)."""
        return any(len(set(row)) > 1 for row in self.ranks.tolist())

    @property
    def first(self):
        """The device results are gathered on: the first shard's, or on
        a mesh across processes this rank's first shard's (``home``
        where it holds none)."""
        for dev, mine in zip(self.flat_devices, self.local):
            if mine:
                return dev
        return self.home

    @property
    def key(self):
        """A hashable identity for caches: device names, axes, shape and,
        across processes, each shard's rank."""
        return (tuple(str(d) for d in self.flat_devices), self.axis_names,
                tuple(self.shape.values()),
                tuple(self.ranks.ravel().tolist()) if self.distributed
                else None)

    def __repr__(self):
        ranks = (f", ranks={self.ranks.ravel().tolist()}, rank={self.rank}"
                 if self.distributed else "")
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.flat_devices]}{ranks})")


def device_count():
    """The CUDA cards this process sees."""
    return torch.cuda.device_count()


def process_group():
    """``torch.distributed`` when its default process group is
    initialised (:func:`~.checkpoint.initialize_distributed`), else
    None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _largest_pow2_divisor(n, cap):
    p = 1
    while p * 2 <= cap and n % (p * 2) == 0:
        p *= 2
    return p


def make_mesh(n_devices=None, seq=None, devices=None):
    """Build a :class:`Mesh` with axes ``('data', 'seq')``.

    ``seq`` devices cooperate on one spectrum's distributed FFT (a power
    of two, so padded FFT lengths stay divisible); the rest fan out over
    epochs and chunks. Default: seq = the largest power of two ≤ √n
    dividing n (8 devices → 4 data × 2 seq). ``devices`` (the port's
    own) lists this process's devices, in order, and may repeat one;
    without it a process takes every CUDA card it sees, or in a process
    group its current card (one process per card), and raises
    :class:`~..backend.KernelError` when there is none.

    In an initialised process group every rank must call this with the
    same ``n_devices`` and ``seq``: the mesh is the ranks' device lists
    end to end, in rank order (one ``all_gather_object``), cut to the
    first ``n_devices``."""
    pg = process_group()
    if devices is None:
        n_cards = device_count()
        if n_cards == 0:
            raise KernelError(
                "make_mesh found no CUDA card; pass devices=['cpu'] * n "
                "for a mesh of virtual CPU shards")
        devs = ([torch.device("cuda", torch.cuda.current_device())]
                if pg is not None else
                [torch.device("cuda", i) for i in range(n_cards)])
    else:
        devs = [torch.device(d) for d in devices]
    home, ranks, rank = devs[0], None, 0
    if pg is not None:
        lists = [None] * pg.get_world_size()
        pg.all_gather_object(lists, [str(d) for d in devs])
        devs = [torch.device(d) for names in lists for d in names]
        ranks = [r for r, names in enumerate(lists) for _ in names]
        rank = pg.get_rank()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices < 1 or n_devices > len(devs):
        raise ValueError(f"n_devices={n_devices} but {len(devs)} devices "
                         "are available")
    devs = devs[:n_devices]
    if seq is None:
        seq = _largest_pow2_divisor(n_devices, int(np.sqrt(n_devices)) or 1)
    if n_devices % seq:
        raise ValueError(f"seq={seq} does not divide {n_devices} devices")
    rows = range(n_devices // seq)
    grid = [devs[r * seq:(r + 1) * seq] for r in rows]
    if ranks is not None:
        ranks = [ranks[r * seq:(r + 1) * seq] for r in rows]
    return Mesh(grid, ranks=ranks, rank=rank, home=home)


@dataclass(frozen=True)
class Sharding:
    """How an array lies over ``mesh``: ``"data"`` splits axis 0 over
    every device (data × seq combined), ``"batch_freq"`` splits axis 0
    over ``data`` and axis 1 over ``seq``, ``"replicated"`` puts a whole
    copy on each device."""

    mesh: Mesh
    kind: str
    ndim: int = 3


class Shards(list):
    """The per-device parts of one array, in shard order, with the
    :class:`Sharding` that cut them."""

    def __init__(self, parts, sharding):
        super().__init__(parts)
        self.sharding = sharding


def data_sharding(mesh, ndim=3):
    """Axis 0 over ('data', 'seq') combined: pure fan-out over every
    device (the reference's pool)."""
    return Sharding(mesh, "data", ndim)


def batch_freq_sharding(mesh):
    """Dyn batches [B, nf, nt]: B over 'data', the frequency axis over
    'seq' (the distributed FFT's layout)."""
    return Sharding(mesh, "batch_freq", 3)


def chunk_shardings(mesh, ndims):
    """One :func:`data_sharding` per array of a chunk program's
    arguments or outputs, each with the chunk batch on its leading axis:
    ``chunk_shardings(mesh, (3, 2, 2))`` for ``(dspecs[B, nf, nt],
    edges[B, n], etas[B, neta])``."""
    return tuple(data_sharding(mesh, ndim=n) for n in ndims)


def replicated(mesh):
    """A whole copy on every device."""
    return Sharding(mesh, "replicated", 0)


def _split(n, k, what):
    if n % k:
        raise ValueError(f"{what} of {n} does not split over {k} shards")
    return n // k


def shard(x, sharding):
    """Cut the tensor ``x`` into the parts ``sharding`` names, each on its
    device (copied asynchronously where it moves). Returns
    :class:`Shards`; on a mesh across processes the parts of other
    ranks' shards are None."""
    mesh = sharding.mesh
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    if sharding.kind == "replicated":
        views = [x] * mesh.size
    elif sharding.kind == "data":
        n = _split(x.shape[0], mesh.size, "axis 0")
        views = [x[i * n:(i + 1) * n] for i in range(mesh.size)]
    elif sharding.kind == "batch_freq":
        nd, ns = mesh.shape[DATA_AXIS], mesh.shape[SEQ_AXIS]
        b = _split(x.shape[0], nd, "axis 0")
        f = _split(x.shape[1], ns, "axis 1")
        views = [x[r * b:(r + 1) * b, s * f:(s + 1) * f]
                 for r in range(nd) for s in range(ns)]
    else:
        raise ValueError(f"unknown sharding kind {sharding.kind!r}")
    return Shards([v.to(d, non_blocking=True) if mine else None
                   for v, d, mine in zip(views, mesh.flat_devices,
                                         mesh.local)], sharding)


def gather(parts):
    """The array that :func:`shard` cut, rebuilt on the mesh's first
    device (a replicated array gives its first copy). Plain lists of
    parts are concatenated along axis 0 on their first part's device.
    On a mesh across processes the other ranks' parts come by
    :func:`exchange`, so every rank gets the whole array."""
    sharding = getattr(parts, "sharding", None)
    if sharding is not None and sharding.mesh.distributed:
        want = [0] if sharding.kind == "replicated" else range(len(parts))
        got = exchange(sharding.mesh, {i: parts[i] for i in want
                                       if parts[i] is not None})
        parts = Shards([got.get(i) for i in range(len(parts))], sharding)
    dev = sharding.mesh.first if sharding is not None else parts[0].device
    if sharding is not None and sharding.kind == "replicated":
        return parts[0].to(dev)
    if sharding is not None and sharding.kind == "batch_freq":
        ns = sharding.mesh.shape[SEQ_AXIS]
        rows = [torch.cat([p.to(dev) for p in parts[r:r + ns]], dim=1)
                for r in range(0, len(parts), ns)]
        return torch.cat(rows, dim=0)
    return torch.cat([p.to(dev) for p in parts], dim=0)


def on_device(dev):
    """The context that makes ``dev`` current (CUDA) or nothing (CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def lane_bounds(n_units, n_shards):
    """Contiguous, as even as possible ``(start, stop)`` unit ranges of
    each shard; a shard beyond the unit count gets an empty range."""
    return [(i * n_units // n_shards, (i + 1) * n_units // n_shards)
            for i in range(n_shards)]


def _tree_map(fn, outs):
    """Apply ``fn`` to the list of per-shard leaves at each position of
    the shards' output trees (tuples, lists, dicts, tensors or None)."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, [o[k] for o in outs]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, [o[i] for o in outs])
                           for i in range(len(first)))
    if first is None:
        return None
    return fn(outs)


_ALIGN = 16        # bytes: every dtype's element size divides it


@dataclass(frozen=True)
class _Slot:
    """Where one tensor of an exchanged tree lies in its rank's bytes."""

    dtype: torch.dtype
    shape: tuple
    offset: int
    nbytes: int


def _nbytes(t):
    return t.numel() * t.element_size()


def _padded(t):
    return -(-_nbytes(t) // _ALIGN) * _ALIGN


def _bytes(t):
    """A tensor's elements as a flat uint8 view (a copy where its one
    axis is strided, as a single element of a column can be)."""
    flat = t.detach().reshape(-1)
    if flat.stride(0) != 1:
        flat = flat.clone(memory_format=torch.contiguous_format)
    return flat.view(torch.uint8)


def _pack(tree, slots):
    """``tree`` with each tensor leaf replaced by its :class:`_Slot`, the
    tensors appended to ``slots`` as ``(offset, tensor)``; other leaves
    (numpy arrays, numbers, None) stay in the layout as they are."""
    if isinstance(tree, dict):
        return {k: _pack(v, slots) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_pack(v, slots) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return tree
    off = slots[-1][0] + _padded(slots[-1][1]) if slots else 0
    slots.append((off, tree))
    return _Slot(tree.dtype, tuple(tree.shape), off, _nbytes(tree))


def _unpack(layout, buf):
    """The tree :func:`_pack` laid out, its tensors read from ``buf``."""
    if isinstance(layout, dict):
        return {k: _unpack(v, buf) for k, v in layout.items()}
    if isinstance(layout, (tuple, list)):
        return type(layout)(_unpack(v, buf) for v in layout)
    if not isinstance(layout, _Slot):
        return layout
    part = buf[layout.offset:layout.offset + layout.nbytes]
    return part.view(layout.dtype).reshape(layout.shape).clone()


def exchange(mesh, entries):
    """Share per-shard results across the ranks of a mesh: ``entries``
    maps this rank's shard indices to output trees (tensors, tuples,
    lists, dicts, numpy arrays, None); every rank gets back the union of
    all ranks' entries, the other ranks' tensors on this rank's
    ``mesh.first`` (its own entries as they are). A collective: every
    rank of the process group calls it at the same point, in the same
    order. One ``all_gather_object`` carries each rank's layout, one
    ``all_gather`` its tensors' bytes, padded to the largest rank's
    (tensors of any dtype travel as bytes, complex ones too). It waits
    at most the process group's timeout for a peer, then raises."""
    pg = process_group()
    dev = mesh.first
    slots, layouts = [], {}
    for i in sorted(entries):
        layouts[i] = _pack(entries[i], slots)
    size = slots[-1][0] + _padded(slots[-1][1]) if slots else 0
    lists = [None] * pg.get_world_size()
    pg.all_gather_object(lists, (layouts, size))
    buf = torch.empty(max(n for _, n in lists), dtype=torch.uint8,
                      device=dev)
    for off, t in slots:
        buf[off:off + _nbytes(t)] = _bytes(t).to(dev)
    bufs = [buf] * len(lists)
    if len(buf):
        bufs = [torch.empty_like(buf) for _ in lists]
        pg.all_gather(bufs, buf)
    out = dict(entries)
    for r, (lay, _) in enumerate(lists):
        if r != mesh.rank:
            out.update({i: _unpack(t, bufs[r]) for i, t in lay.items()})
    return out


def _lane_slice(a, s, dev):
    part = a[s]
    if isinstance(part, torch.Tensor):
        return part.to(dev, non_blocking=True)
    return part


def run_lanes(mesh, fn_of, lane_args, unit=1):
    """Run a batched function over the mesh, split along its lanes.

    ``lane_args`` are tensors or numpy arrays sharing a leading (lane)
    axis of length B, a multiple of ``unit`` (the lanes that must stay
    on one shard together, a retrieval chain say). The ``B / unit``
    units go to the mesh's devices in contiguous, as even as possible
    runs in shard order; a tensor slice moves to its shard's device,
    numpy slices stay on the host. ``fn_of(device, n_lanes)`` returns
    the function that shard calls with its slices, under that device's
    context, one shard after another (no fence between them; a function
    that waits on its device serialises the shards, see the module
    note); the outputs (a tensor, or tuples, lists and
    dicts of them, each with the lane axis first) are concatenated in
    shard order on the mesh's first device. No shard runs on another
    device or another version of its function: an error raises.

    On a mesh across processes each rank runs only its own shards (the
    same split) and the outputs are exchanged (:func:`exchange`), so
    every rank returns the whole result; a rank whose shard raises
    raises, and its peers' exchange ends at the group's timeout."""
    B = len(lane_args[0])
    if B % unit:
        raise ValueError(f"{B} lanes do not make whole units of {unit}")
    devs, local = mesh.flat_devices, mesh.local
    outs = {}
    for i, (dev, (u0, u1)) in enumerate(zip(
            devs, lane_bounds(B // unit, len(devs)))):
        if u1 == u0 or not local[i]:
            continue
        s = slice(u0 * unit, u1 * unit)
        with on_device(dev):
            outs[i] = fn_of(dev, s.stop - s.start)(
                *(_lane_slice(a, s, dev) for a in lane_args))
    if mesh.distributed:
        outs = exchange(mesh, outs)
    first = mesh.first
    return _tree_map(lambda leaves: torch.cat(
        [v.to(first) for v in leaves], dim=0),
        [outs[i] for i in sorted(outs)])


def per_device(cache, key, dev, build):
    """``build()`` once per (``key``, device), kept in ``cache``."""
    k = key + (str(dev),)
    fn = cache.get(k)
    if fn is None:
        if len(cache) >= 32:
            cache.pop(next(iter(cache)))
        fn = cache[k] = build()
    return fn


__all__ = ["DATA_AXIS", "SEQ_AXIS", "Mesh", "Sharding", "Shards",
           "batch_freq_sharding", "chunk_shardings", "data_sharding",
           "device_count", "exchange", "gather", "lane_bounds",
           "make_mesh", "on_device", "per_device", "process_group",
           "replicated", "run_lanes", "shard"]
