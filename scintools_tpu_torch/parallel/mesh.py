"""The single-host device mesh of the port.

Counterpart of ``scintools_tpu/parallel/mesh.py``: ``DATA_AXIS`` and
``SEQ_AXIS`` (:20-21), ``device_count`` (:24), ``_largest_pow2_divisor``
(:27), ``make_mesh`` (:34), ``data_sharding`` (:60),
``batch_freq_sharding`` (:70), ``chunk_shardings`` (:79) and
``replicated`` (:89).

The JAX design is one controller: a 2-D mesh with axes ``('data',
'seq')`` over the devices of one process. The port keeps it. One Python
process drives every card of the host (no ``torch.distributed``): a
:class:`Mesh` is an object array of ``torch.device``s of shape
(data, seq), and a mesh may name one device more than once. Such
virtual shards are how the tests run a mesh on the CPU
(``make_mesh(8, devices=["cpu"] * 8)``) and how one card runs a
four-shard mesh; on a single card they measure only the cost of
splitting and gathering.

A sharding descriptor says how an array's axes lie over the mesh;
:func:`shard` cuts a tensor into the per-device parts it names (one
contiguous slice of the split axis per device, in device order over
data × seq) and :func:`gather` puts them back together on the mesh's
first device. :func:`run_lanes` is what the sharded survey paths
(``parallel/survey.py``) are built on: it splits the leading (lane)
axis of its inputs over the mesh, calls each shard's function in turn
under its own device's context, and gathers the outputs in shard order.

One thread issues the shards, one after another. Shards on different
cards overlap only as far as a shard's function returns without
waiting on its device (its work then runs while the next shard's is
issued). A function that reads a device value on the host runs its
shard to that point before the loop goes on, so such shards run
serially even on separate cards: the LM fits (``fit/lm.py`` reads its
active mask every iteration; the acf2d fit returns host arrays) and so
:func:`~.survey.make_acf2d_fit_sharded`,
:func:`~.survey.make_survey_step` and the façade's mesh fits. A thread
per card would not lift this for the LM paths: torch's forward-mode AD
levels, which the LM's Jacobian uses, are process state.
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
    ``np.prod(list(mesh.shape.values()))`` is the shard count."""

    def __init__(self, devices, axis_names=(DATA_AXIS, SEQ_AXIS)):
        arr = np.empty(np.shape(devices)[:2], dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(devices[idx[0]][idx[1]])
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, arr.shape))

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def flat_devices(self):
        """The devices in shard order (data-major, then seq)."""
        return list(self.devices.ravel())

    @property
    def first(self):
        """The device results are gathered on."""
        return self.devices[0, 0]

    @property
    def key(self):
        """A hashable identity for caches: device names, axes, shape."""
        return (tuple(str(d) for d in self.flat_devices), self.axis_names,
                tuple(self.shape.values()))

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.flat_devices]})")


def device_count():
    """The CUDA cards this process sees."""
    return torch.cuda.device_count()


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
    own) lists the devices to use, in order, and may repeat one;
    without it the mesh takes the first ``n_devices`` of every CUDA card
    (all of them by default) and raises :class:`~..backend.KernelError`
    when there is none."""
    if devices is None:
        n_cards = device_count()
        if n_cards == 0:
            raise KernelError(
                "make_mesh found no CUDA card; pass devices=['cpu'] * n "
                "for a mesh of virtual CPU shards")
        devs = [torch.device("cuda", i) for i in range(n_cards)]
    else:
        devs = [torch.device(d) for d in devices]
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
    grid = [devs[r * seq:(r + 1) * seq] for r in range(n_devices // seq)]
    return Mesh(grid)


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
    :class:`Shards`."""
    mesh = sharding.mesh
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    devs = mesh.flat_devices
    if sharding.kind == "replicated":
        parts = [x.to(d, non_blocking=True) for d in devs]
    elif sharding.kind == "data":
        n = _split(x.shape[0], mesh.size, "axis 0")
        parts = [x[i * n:(i + 1) * n].to(d, non_blocking=True)
                 for i, d in enumerate(devs)]
    elif sharding.kind == "batch_freq":
        nd, ns = mesh.shape[DATA_AXIS], mesh.shape[SEQ_AXIS]
        b = _split(x.shape[0], nd, "axis 0")
        f = _split(x.shape[1], ns, "axis 1")
        parts = [x[r * b:(r + 1) * b, s * f:(s + 1) * f].to(
            mesh.devices[r, s], non_blocking=True)
            for r in range(nd) for s in range(ns)]
    else:
        raise ValueError(f"unknown sharding kind {sharding.kind!r}")
    return Shards(parts, sharding)


def gather(parts):
    """The array that :func:`shard` cut, rebuilt on the mesh's first
    device (a replicated array gives its first copy). Plain lists of
    parts are concatenated along axis 0 on their first part's device."""
    sharding = getattr(parts, "sharding", None)
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
    device or another version of its function: an error raises."""
    B = len(lane_args[0])
    if B % unit:
        raise ValueError(f"{B} lanes do not make whole units of {unit}")
    devs = mesh.flat_devices
    outs = []
    for dev, (u0, u1) in zip(devs, lane_bounds(B // unit, len(devs))):
        if u1 == u0:
            continue
        s = slice(u0 * unit, u1 * unit)
        with on_device(dev):
            outs.append(fn_of(dev, s.stop - s.start)(
                *(_lane_slice(a, s, dev) for a in lane_args)))
    first = mesh.first
    return _tree_map(lambda leaves: torch.cat(
        [v.to(first) for v in leaves], dim=0), outs)


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
           "device_count", "gather", "lane_bounds", "make_mesh",
           "on_device", "per_device", "replicated", "run_lanes", "shard"]
