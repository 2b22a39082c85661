"""Nothing a cell runs loads JAX or the JAX package, compared by whole
top-level module name (``scintools_tpu_torch`` is the port,
``scintools_tpu`` the JAX package), and the references import nothing
of the program."""

import ast
import io
import os
import subprocess
import sys
import time
import types

from portbench import harness, spec


def test_forbidden_by_whole_top_level_name():
    assert harness.forbidden_modules(
        {"scintools_tpu_torch", "scintools_tpu_torch.ops.sspec",
         "jaxtyping", "flaxen", "numpy"}) == []
    assert harness.forbidden_modules({"scintools_tpu.ops.sspec"}) == \
        ["scintools_tpu"]
    assert harness.forbidden_modules(
        {"jax.numpy", "jaxlib.xla_client", "flax.linen"}) == \
        ["flax", "jax", "jaxlib"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    top = os.path.join(spec.HERE, sub)
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_of_the_benchmark_imports_jax():
    for path in _sources():
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path


def test_the_references_import_nothing_of_the_program():
    for path in _sources("reference"):
        got = set(_imports(path))
        assert not got & {"scintools_tpu_torch", "scintools_tpu", "jax"}, \
            path


def test_a_cell_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import harness\n"
            "import portbench.drivers.thth_facade, "
            "portbench.drivers.arcfit_batch\n"
            "from scintools_tpu_torch import BasicDyn, Dynspec\n"
            "from scintools_tpu_torch.ops import fitarc, sspec\n"
            "print(harness.forbidden_modules())" % spec.ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, shrink):
    cfg, tr, _ = shrink("thth_4096.standard")
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run("thth_4096.standard", 5, 0.2, 0, time.perf_counter(),
                     device="cpu", out=out, err=err,
                     overrides=dict(config=cfg, traffic=tr))
    assert rc != 0 and out.getvalue() == ""
    assert "jax" in err.getvalue()


def test_a_run_without_the_card_prints_no_result(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run("thth_4096.standard", 5, 0.2, 0, time.perf_counter(),
                     out=out, err=err)
    assert rc != 0 and out.getvalue() == ""
