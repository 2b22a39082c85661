"""Tests of the benchmark. They run on the CPU at tiny sizes:

    python -m pytest portbench/tests -q

The tests marked ``card`` need a CUDA card and skip without one; on a
machine with a card they run with

    python -m pytest portbench/tests -q -m card

No file here imports JAX or the JAX package.
"""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny(cell):
    """``(config, traffic, bench)`` of ``cell`` (``<config>.<traffic>``)
    cut to a size the CPU runs in seconds (the widths are the cell's, the
    sizes are not); ``bench`` is ``BENCHMARK.json`` with the cell added
    where it is not there."""
    from portbench import spec

    bench = spec.benchmark()
    config, traffic = cell.split(".", 1)
    cfg = spec.load_json(os.path.join(spec.HERE, "configs", config + ".json"))
    tr = copy.deepcopy(spec.traffic(traffic))
    if all(w["name"] != cell for w in bench["workloads"]):
        bench["workloads"].append(dict(name=cell, config=config,
                                       traffic=traffic, chips=1, why="test"))
    if "observation" in cfg:
        cfg["observation"].update(nf=128, nt=128)
        cfg["prep"].update(cwf=32, cwt=32, neta=100, nedge=32)
        tr["trace_calls"] = 2
    else:
        cfg["epochs"].update(nf=128, nt=128)
        tr.update(batch=8, check_calls=2, trace_calls=3)
    return cfg, tr, bench


@pytest.fixture
def shrink():
    """:func:`tiny`, for the tests."""
    return tiny
