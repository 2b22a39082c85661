"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file is
given in ``configs``, and a traffic mix, found as
``portbench/traffic/<traffic>.json``; its correctness limits are
``portbench/limits/<cell>.json``. A metric is read by
``portbench/metrics/<metric>.py``; the traffic's ``driver`` is
``portbench/drivers/<driver>.py`` and the configuration's
``reference`` is ``portbench/reference/<reference>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(path=None):
    """The parsed ``BENCHMARK.json`` (default: the one at the root)."""
    return load_json(path or os.path.join(ROOT, "BENCHMARK.json"))


def workload(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench, name):
    """The configuration entry ``name`` and its file's contents."""
    for c in bench["configs"]:
        if c["name"] == name:
            return c, load_json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name):
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits(cell):
    """The cell's limits file, or None where it has none."""
    path = os.path.join(HERE, "limits", f"{cell}.json")
    return load_json(path) if os.path.exists(path) else None


def applies(metric, cell):
    """Whether ``metric`` (an entry of ``end_to_end`` or ``per_layer``)
    is reported in ``cell``: listed there, or listing no cells."""
    return "workloads" not in metric or cell in metric["workloads"]


def metrics_for(bench, cell, trace):
    """The metric entries a run of ``cell`` reports: the end-to-end ones
    with ``trace`` 0, the per-layer ones with ``trace`` 1. A per-layer
    metric that lists no cells goes with the cells reporting the
    end-to-end metric it moves."""
    if not trace:
        return [m for m in bench["end_to_end"] if applies(m, cell)]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif applies(e2e[m["moves"]], cell):
            out.append(m)
    return out


def reader(metric):
    """The reader module of ``metric`` (a file name may hold dots, so it
    is loaded by path)."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name):
    return importlib.import_module(f"portbench.drivers.{name}")


def reference(name):
    return importlib.import_module(f"portbench.reference.{name}")
