"""One run of one cell: set-up, the measured (or traced) window, the
metrics, the check against the reference, and the result line.

The order is fixed: set-up (counted in ``setup_s`` from the process's
start), the window (``--seconds`` of whole calls; with ``--trace 1`` a
sub-window of whole calls under the profiler), the memory peak, the
metrics, then the program's state freed and the reference run, the
check for JAX in the process, and last the numbers compared, each
beside its limit, on standard error and as the result line's last key.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import torch

from . import spec
from . import trace as tr

FORBIDDEN = ("jax", "jaxlib", "flax", "scintools_tpu")


def clean_env(environ=os.environ):
    """Drop every ``SCINTOOLS_*`` variable (formulation overrides and
    tables, log sinks), so a cell measures the program's defaults."""
    for k in [k for k in environ if k.startswith("SCINTOOLS_")]:
        del environ[k]


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that are JAX, its companions or
    the JAX package, each compared whole (``scintools_tpu_torch`` is
    not ``scintools_tpu``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


class Spans:
    """The benchmark's spans around calls into a layer: a
    ``record_function`` when tracing, nothing otherwise."""

    def __init__(self, enabled):
        self.enabled = enabled

    def __call__(self, name):
        if self.enabled:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()


class Context:
    """What a metric reader reads: the cell's name, the window's counts
    (``units``, ``unit``, ``calls``, ``elapsed`` s, ``setup_s``), the
    trace (or None), the driver's shapes and the table of peaks."""

    def __init__(self, cell, window, trace, shapes, peaks):
        self.cell, self.window, self.trace = cell, window, trace
        self.shapes, self.peaks = shapes, peaks


def card(query="name,power.limit"):
    """``nvidia-smi``'s reading of ``query`` on the card, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({type(e).__name__})"


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def judge(readings, limits):
    """``(correct, checks)``: each number the limits file names against
    its limit, ``checks = {name: {"value": v, "limit": l}}``; a number
    that is missing or not a number fails, and no limits fail."""
    numbers = (limits or {}).get("numbers", {})
    checks, ok = {}, bool(numbers)
    for name, entry in numbers.items():
        v = readings.get(name, float("inf"))
        checks[name] = {"value": v, "limit": entry["limit"]}
        ok = ok and v == v and v <= entry["limit"]
    return ok, checks


def timed_window(cell, seconds, err):
    calls = units = failed = 0
    ends = []
    sync()
    t0 = time.perf_counter()
    while True:
        try:
            units += cell.step(calls)
        except Exception:  # noqa: BLE001 — a failed call is counted
            failed += 1
            traceback.print_exc(file=err)
        calls += 1
        sync()
        elapsed = time.perf_counter() - t0
        ends.append(elapsed)
        if elapsed >= seconds:
            return dict(calls=calls, units=units, failed=failed,
                        elapsed=elapsed, ends=ends)


def traced_window(cell, seconds, max_calls, err):
    state = dict(calls=0, units=0, failed=0, elapsed=0.0)

    def call():
        with torch.profiler.record_function(tr.CALL):
            try:
                state["units"] += cell.step(state["calls"])
            except Exception:  # noqa: BLE001 — a failed call is counted
                state["failed"] += 1
                traceback.print_exc(file=err)
            state["calls"] += 1

    def window():
        state.update(calls=0, units=0, failed=0)
        t0 = time.perf_counter()
        while True:
            call()
            sync()
            state["elapsed"] = time.perf_counter() - t0
            if state["calls"] >= max_calls or state["elapsed"] >= seconds:
                return

    def warm():
        cell.step(0)

    trace = tr.capture(warm, window, cell.SPANS)
    return state, trace


def run(cell_name, seed, seconds, trace, t_start, device=None,
        out=None, err=None, bench=None, overrides=None):
    """Run ``cell_name`` once and print its result; returns the exit
    code. ``device`` None means the card (and the run refuses without
    enough of them); a test passes ``"cpu"`` and, in ``overrides``, its
    own ``config``, ``traffic`` or ``limits``."""
    out = out or sys.stdout
    err = err or sys.stderr
    overrides = overrides or {}
    bench = bench or spec.benchmark()
    w = spec.workload(bench, cell_name)
    config = overrides.get("config") or spec.config(bench, w["config"])[1]
    traffic = overrides.get("traffic") or spec.traffic(w["traffic"])
    limits = overrides.get("limits") or spec.limits(cell_name)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(w["chips"]):
            print(f"portbench: {cell_name} needs {w['chips']} CUDA "
                  f"device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=err)
            return 2
        device = torch.device("cuda")
    device = torch.device(device)
    on_card = device.type == "cuda"
    peaks = spec.load_json(os.path.join(spec.HERE, "peaks.json"))
    if on_card:
        print(f"portbench: card {card()}; peaks {json.dumps(peaks)}",
              file=err, flush=True)

    drv = spec.driver(traffic["driver"])
    cell = drv.Cell(config, traffic, seed, device, Spans(bool(trace)))
    cell.setup()
    sync()
    setup_s = time.perf_counter() - t_start
    print(f"portbench: set-up {setup_s:.3f} s", file=err, flush=True)

    clocks = "clocks.sm,power.draw,power.limit,temperature.gpu"
    if on_card:
        print(f"portbench: before the window {card(clocks)}", file=err,
              flush=True)
    trace_obj = None
    if trace:
        state, trace_obj = traced_window(cell, seconds,
                                         int(traffic["trace_calls"]), err)
    else:
        state = timed_window(cell, seconds, err)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    print(f"portbench: window {state['calls']} call(s), {state['units']} "
          f"{cell.UNIT}, {state['failed']} failed, {state['elapsed']:.3f} s",
          file=err, flush=True)
    ends = state.pop("ends", None)
    if ends:
        half = sum(e <= ends[-1] / 2 for e in ends)
        spans = sorted(b - a for a, b in zip([0.0] + ends, ends))
        print(f"portbench: call s min {spans[0]:.4f} median "
              f"{spans[len(spans) // 2]:.4f} max {spans[-1]:.4f}; calls "
              f"ended in the first half {half}, second "
              f"{len(ends) - half}", file=err, flush=True)
    if on_card:
        print(f"portbench: after the window {card(clocks)}", file=err,
              flush=True)

    window = dict(state, unit=cell.UNIT, setup_s=setup_s)
    ctx = Context(cell_name, window, trace_obj, cell.shapes(), peaks)
    metrics = {}
    for m in spec.metrics_for(bench, cell_name, trace):
        v = spec.reader(m["name"]).read(ctx)
        if v is None:
            print(f"portbench: metric {m['name']} found nothing to read",
                  file=err)
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    cell.release()
    readings = cell.readings()
    correct, checks = judge(readings, limits)
    correct = correct and state["failed"] == 0

    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found} (JAX or the JAX "
              "package); no result", file=err)
        return 3

    result = {"correct": bool(correct), "attempted": state["calls"],
              "failed": state["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if on_card else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if on_card else device.type),
                         "count": int(w["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if trace_obj is not None:
        result["device"]["busy_s"] = trace_obj.busy_s()
        result["device"]["window_s"] = trace_obj.window_s
        result["breakdown"] = tr.breakdown(trace_obj)
    result["checks"] = checks
    for k, v in readings.items():
        if k not in checks:
            print(f"portbench: reading {k} {v!r} (not compared)", file=err)
    for k, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
