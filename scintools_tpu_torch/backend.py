"""Device and precision policy of the PyTorch/CUDA port, and its
formulation registry.

Counterpart of the device/precision parts of
``scintools_tpu/backend.py:1-60`` (the JAX package picks a backend
name; here every public entry point takes ``device=``). ``None``
means the CUDA card: on a host without one that is an error, never a
silent fall-back to the CPU. The CPU is used only when a caller asks
for it (``device="cpu"``), as the tests do.

The formulation registry (``scintools_tpu/backend.py:225-520``) is at
the end of this module: ``register_formulation``, ``formulation``,
``set_formulation``, ``measure_formulation`` and the per-platform
tables, keyed by the torch device type of the tensors a site computes
on.

Precision: the hot path works in float32 / complex64 like the JAX
production path on its accelerator, so TF32 is switched off here for
both matrix products and cuDNN (TF32 keeps ~3 decimal digits, which
would silently loosen every parity tolerance).
"""

from __future__ import annotations

import json
import os
import threading
import time

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


def cuda_graphed(fn):
    """``fn`` replayed from a CUDA graph. On CUDA tensor arguments the
    first call of each signature (shapes, dtypes, device) captures
    ``fn`` once; every later call copies its arguments into the graph's
    inputs and replays the graph: the same kernels in the same order,
    launched from the host once instead of once per operation. ``fn``
    takes tensors only, makes no host copy or synchronisation, and
    returns a tensor or a tuple of them; the outputs are cloned out of
    the graph's memory, so a later replay leaves them alone. Any other
    call (a CPU tensor, an argument that is not a tensor) runs ``fn``
    as it is; ``.fn`` is ``fn`` itself. The port's small per-epoch
    functions, which launch tens of kernels of a few microseconds each,
    spend their time on the host otherwise. One lock serialises the
    replays of one ``fn``."""
    graphs, lock = {}, threading.Lock()   # at most 4 signatures kept

    def capture(args):
        static = [a.clone() for a in args]
        side = torch.cuda.Stream(device=args[0].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*static)        # FFT plans and allocator blocks, uncaptured
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = fn(*static)
        return static, out, graph

    def run(*args):
        if not all(torch.is_tensor(a) and a.is_cuda for a in args):
            return fn(*args)
        sig = tuple((tuple(a.shape), a.dtype, a.device) for a in args)
        with lock:
            static, out, graph = fifo_cached(graphs, sig,
                                             lambda: capture(args), 4)
            for s, a in zip(static, args):
                s.copy_(a)
            graph.replay()
            if isinstance(out, tuple):
                return tuple(o.clone() for o in out)
            return out.clone()

    run.fn, run.graphs = fn, graphs
    return run


def as_tensor(x, device, dtype=REAL):
    """``x`` (numpy array, scalar or tensor) as a contiguous ``dtype``
    tensor on ``device`` (a numpy view with negative strides, such as a
    flip, is copied first)."""
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
    return torch.as_tensor(x, dtype=dtype, device=device).contiguous()


# ---------------------------------------------------------------------
# the formulation registry
# ---------------------------------------------------------------------
# Counterpart of ``scintools_tpu/backend.py:225-520``. An op with more
# than one exact formulation (a structured transform against its dense
# oracle, a gather against a matmul, an eigensolver) registers its
# choices and per-platform entries at import; every call site resolves
# the active choice with :func:`formulation`, passing the torch device
# type of the tensors it computes on ("cuda" or "cpu"). Resolution
# order, as in the JAX package: override (:func:`set_formulation`,
# :func:`measure_formulation`) > ``SCINTOOLS_FORMULATION_<OP>`` (the
# op with "." → "_", upper case) > the measured per-platform table >
# the registered per-platform entry > the registered default.
#
# The measured tables are the port's own:
# ``scintools_tpu_torch/formulation_tables/<platform>.json``, moved by
# ``SCINTOOLS_TORCH_FORMULATION_TABLES``. The JAX package's tables
# (timed on JAX, not on this code) are never read.

_FORMULATIONS = {}            # op -> {default, choices, platforms, doc}
_FORMULATION_OVERRIDES = {}   # op -> choice (set_formulation/measured)
_MEASURED_TABLES = {}         # platform -> op -> {choice, seconds}
_MEASURED_LOADED = set()      # platforms whose table file was read


def register_formulation(op, default, choices, platforms=None, doc=""):
    """Register (idempotently) the formulations of ``op``: ``choices``
    the valid names, ``default`` the platform-independent fallback,
    ``platforms`` an optional ``{device type: choice}`` map."""
    choices = tuple(choices)
    platforms = dict(platforms or {})
    if default not in choices:
        raise ValueError(f"{op}: default {default!r} not in {choices}")
    for plat, choice in platforms.items():
        if choice not in choices:
            raise ValueError(f"{op}: platform {plat!r} choice {choice!r} "
                             f"not in {choices}")
    _FORMULATIONS[op] = {"default": default, "choices": choices,
                         "platforms": platforms, "doc": doc}


def formulation_platform():
    """The platform of a bare query (no ``platform`` given): "cuda"
    where a card is there, else "cpu". It never decides where work
    runs: call sites pass their tensors' device type."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _platform_key(platform):
    if platform is None:
        return formulation_platform()
    if isinstance(platform, torch.device):
        return platform.type
    return str(platform).split(":")[0]       # "cuda:1" → "cuda"


def _env_formulation(op):
    return os.environ.get(
        "SCINTOOLS_FORMULATION_" + op.replace(".", "_").upper())


def formulation_table_dir():
    """Directory of the port's measured formulation tables:
    ``SCINTOOLS_TORCH_FORMULATION_TABLES`` when set, else
    ``formulation_tables/`` inside the package."""
    env = os.environ.get("SCINTOOLS_TORCH_FORMULATION_TABLES")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "formulation_tables")


def formulation_table_path(platform):
    """``<table_dir>/<platform>.json`` for a device type."""
    return os.path.join(formulation_table_dir(), f"{platform}.json")


def _measured_table(platform):
    """The measured table of ``platform``, its file read once per
    process on first use; in-process measurements shadow the file's
    entries. A missing or unreadable file is an empty table."""
    if platform not in _MEASURED_LOADED:
        _MEASURED_LOADED.add(platform)
        try:
            with open(formulation_table_path(platform)) as fh:
                ops = json.load(fh).get("ops") or {}
        except (OSError, ValueError, AttributeError):
            ops = {}
        tbl = _MEASURED_TABLES.setdefault(platform, {})
        for op, entry in ops.items():
            if not isinstance(entry, dict):
                entry = {"choice": entry}
            choice = entry.get("choice")
            if choice is not None:
                tbl.setdefault(str(op), {"choice": str(choice),
                                         "seconds": entry.get("seconds")})
    return _MEASURED_TABLES.get(platform, {})


def _record(op):
    rec = _FORMULATIONS.get(op)
    if rec is None:
        raise KeyError(f"unregistered formulation op {op!r} "
                       f"(known: {sorted(_FORMULATIONS)})")
    return rec


def formulation(op, platform=None):
    """The active formulation of the registered ``op`` on ``platform``
    (a device type or ``torch.device``; ``None``:
    :func:`formulation_platform`). An unknown op raises ``KeyError``,
    an override or environment value that is not a choice
    ``ValueError``; a table entry naming an unregistered choice is
    skipped."""
    rec = _record(op)
    for source, choice in (("override", _FORMULATION_OVERRIDES.get(op)),
                           ("env", _env_formulation(op))):
        if choice is not None:
            if choice not in rec["choices"]:
                raise ValueError(f"{op}: {source} formulation {choice!r} "
                                 f"not one of {rec['choices']}")
            return choice
    platform = _platform_key(platform)
    measured = _measured_table(platform).get(op)
    if measured and measured.get("choice") in rec["choices"]:
        return measured["choice"]
    return rec["platforms"].get(platform, rec["default"])


def set_formulation(op, choice=None):
    """Pin (``choice=None``: clear) a process-wide override of ``op``."""
    rec = _record(op)
    if choice is None:
        _FORMULATION_OVERRIDES.pop(op, None)
        return
    if choice not in rec["choices"]:
        raise ValueError(f"{op}: {choice!r} not one of {rec['choices']}")
    _FORMULATION_OVERRIDES[op] = choice


def record_measured_formulation(op, choice, seconds=None, platform=None,
                                persist=False):
    """Install ``choice`` as the measured winner of ``op`` on
    ``platform``, with the per-choice ``seconds``; ``persist=True``
    also merges it into the platform's table file."""
    rec = _record(op)
    if choice not in rec["choices"]:
        raise ValueError(f"{op}: {choice!r} not one of {rec['choices']}")
    platform = _platform_key(platform)
    _measured_table(platform)      # read the file before shadowing it
    _MEASURED_TABLES.setdefault(platform, {})[op] = {
        "choice": choice,
        "seconds": {k: round(float(v), 6)
                    for k, v in (seconds or {}).items()} or None}
    if persist:
        save_formulation_table(platform)


def save_formulation_table(platform=None, path=None):
    """Atomically write ``platform``'s measured table (file entries
    merged with this process's measurements, which win) as JSON
    ``{"platform", "ops": {op: {"choice", "seconds"}}}``. Returns the
    path written."""
    from .parallel.checkpoint import atomic_write_bytes

    platform = _platform_key(platform)
    table = _measured_table(platform)
    if path is None:
        path = formulation_table_path(platform)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    doc = {"platform": platform,
           "ops": {op: dict(entry) for op, entry in sorted(table.items())}}
    atomic_write_bytes(path, (json.dumps(doc, indent=1, sort_keys=True)
                              + "\n").encode())
    return path


def reset_measured_formulations():
    """Drop every measured table and the read-file memo (the next
    resolution reads the table files again)."""
    _MEASURED_TABLES.clear()
    _MEASURED_LOADED.clear()


def measure_formulation(op, candidates, repeats=2, persist=False,
                        platform=None):
    """Time each candidate and pin the fastest.

    ``candidates`` is ``{choice: thunk}``; each thunk runs one
    representative workload of its choice and must end in its own fence
    (``torch.cuda.synchronize()`` on the card), or the time is that of
    the launches alone. Each thunk runs once to warm up (builds, plans,
    allocations) and then ``repeats`` times; a choice's time is its best
    run. Returns ``(winner, {choice: seconds})`` and leaves the winner
    pinned (:func:`set_formulation`; clear with ``set_formulation(op,
    None)``). ``persist=True`` also records it in ``platform``'s table
    (``None``: :func:`formulation_platform`) and writes the table file,
    which later processes resolve with no pin. Every timing goes to the
    program ledger under site ``formulation.<op>``, and the event
    ``backend.formulation_measured`` to the structured log."""
    rec = _record(op)
    unknown = set(candidates) - set(rec["choices"])
    if unknown:
        raise ValueError(f"{op}: unknown candidate(s) {sorted(unknown)}")
    timings = {}
    for choice, thunk in candidates.items():
        thunk()                              # warm-up: builds, plans
        best = float("inf")
        for _ in range(max(1, int(repeats))):
            t0 = time.perf_counter()
            thunk()
            best = min(best, time.perf_counter() - t0)
        timings[choice] = best
    winner = min(timings, key=timings.get)
    set_formulation(op, winner)
    if persist:
        record_measured_formulation(op, winner, seconds=timings,
                                    platform=platform, persist=True)
    from .obs import ledger
    from .utils import slog

    for choice, best in timings.items():
        ledger.record(f"formulation.{op}", best, "steady",
                      formulation=choice)
    slog.log_event("backend.formulation_measured", op=op, winner=winner,
                   persist=bool(persist),
                   timings={k: round(v, 6) for k, v in timings.items()})
    return winner, timings


def formulation_snapshot(platform=None):
    """JSON-able view of every registered op on ``platform`` (``None``:
    :func:`formulation_platform`): its choices, default, per-platform
    entries, override, measured choice and the choice that resolves now
    (for run reports)."""
    platform = _platform_key(platform)
    measured = _measured_table(platform)
    out = {}
    for op, rec in sorted(_FORMULATIONS.items()):
        out[op] = {
            "choices": list(rec["choices"]),
            "default": rec["default"],
            "platforms": dict(rec["platforms"]),
            "override": _FORMULATION_OVERRIDES.get(op)
            or _env_formulation(op),
            "measured": (measured.get(op) or {}).get("choice"),
            "active": formulation(op, platform),
        }
    return out
