"""The PyTorch/CUDA port stands alone: neither ``scintools_tpu_torch``
nor ``chip_smoke.py`` imports JAX or anything of the JAX package
``scintools_tpu``."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "scintools_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "scintools_tpu")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_import_leaves_jax_package_unloaded():
    # jax itself may be preloaded by the interpreter's site setup, so
    # only the JAX package is checked here
    code = ("import sys, scintools_tpu_torch, scintools_tpu_torch.workloads,"
            " scintools_tpu_torch.thth.retrieval,"
            " scintools_tpu_torch.fit.acf2d, scintools_tpu_torch.fit.batch,"
            " scintools_tpu_torch.sim.acf_model,"
            " scintools_tpu_torch.io.parfile, scintools_tpu_torch.utils.orbit,"
            " scintools_tpu_torch.utils.ephemeris,"
            " scintools_tpu_torch.utils.velocity,"
            " scintools_tpu_torch.ops.scale, scintools_tpu_torch.ops.scatim,"
            " scintools_tpu_torch.ops.xfft, scintools_tpu_torch.sim.factory,"
            " scintools_tpu_torch.sim.scenario,"
            " scintools_tpu_torch.sim.brightness,"
            " scintools_tpu_torch.io.fitsio, scintools_tpu_torch.io.results,"
            " scintools_tpu_torch.obs, scintools_tpu_torch.obs.heartbeat,"
            " scintools_tpu_torch.obs.ledger, scintools_tpu_torch.obs.metrics,"
            " scintools_tpu_torch.obs.report, scintools_tpu_torch.obs.retrace,"
            " scintools_tpu_torch.obs.trace, scintools_tpu_torch.parallel,"
            " scintools_tpu_torch.parallel.checkpoint,"
            " scintools_tpu_torch.parallel.pipeline,"
            " scintools_tpu_torch.robust, scintools_tpu_torch.robust.faults,"
            " scintools_tpu_torch.robust.ladder,"
            " scintools_tpu_torch.robust.runner,"
            " scintools_tpu_torch.utils.slog,"
            " scintools_tpu_torch.utils.profiling,"
            " scintools_tpu_torch.utils.misc,"
            " scintools_tpu_torch.utils.archive, scintools_tpu_torch.compat,"
            " scintools_tpu_torch.fit.ensemble, scintools_tpu_torch.mcmc,"
            " scintools_tpu_torch.mcmc.likelihood,"
            " scintools_tpu_torch.mcmc.posterior,"
            " scintools_tpu_torch.mcmc.sampler,"
            " scintools_tpu_torch.mcmc.survey, scintools_tpu_torch.detect,"
            " scintools_tpu_torch.detect.bank,"
            " scintools_tpu_torch.detect.correlate,"
            " scintools_tpu_torch.detect.online,"
            " scintools_tpu_torch.detect.refine,"
            " scintools_tpu_torch.detect.trigger, scintools_tpu_torch.serve,"
            " scintools_tpu_torch.serve.daemon, scintools_tpu_torch.serve.http,"
            " scintools_tpu_torch.serve.lanes, scintools_tpu_torch.serve.store,"
            " scintools_tpu_torch.serve.watch, scintools_tpu_torch.obs.plane,"
            " scintools_tpu_torch.fleet, scintools_tpu_torch.fleet.chaos,"
            " scintools_tpu_torch.fleet.elastic,"
            " scintools_tpu_torch.fleet.fsops,"
            " scintools_tpu_torch.fleet.merge, scintools_tpu_torch.fleet.pod,"
            " scintools_tpu_torch.fleet.queue,"
            " scintools_tpu_torch.fleet.telemetry,"
            " scintools_tpu_torch.fleet.worker;"
            "bad = [m for m in sys.modules if m == 'scintools_tpu' or "
            "m.startswith('scintools_tpu.')];"
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_fleet_worker_process_leaves_jax_unloaded(tmp_path):
    """``python -m scintools_tpu_torch.fleet.worker`` drains a queue on
    the CPU with neither JAX nor the JAX package in ``sys.modules``."""
    import json

    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"workload": {
        "target": "scintools_tpu_torch.fleet.worker:demo_workload",
        "params": {"n_epochs": 4, "device": "cpu"}}}))
    code = ("import runpy, sys; sys.argv = ['worker', '--queue', "
            f"{str(tmp_path / 'q')!r}, '--out', {str(tmp_path / 'out')!r},"
            f" '--spec', {str(spec)!r}];"
            "from scintools_tpu_torch.fleet import WorkQueue, demo_workload;"
            f"WorkQueue({str(tmp_path / 'q')!r}).seed("
            "[('t0', demo_workload(n_epochs=4)['epochs'])]);"
            "rc = 0\n"
            "try:\n"
            "    runpy.run_module('scintools_tpu_torch.fleet.worker',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = [m for m in sys.modules if m in ('jax', 'jaxlib',"
            " 'scintools_tpu') or m.startswith(('jax.', 'jaxlib.',"
            " 'scintools_tpu.'))]\n"
            "print('BAD', bad, 'RC', rc); sys.exit(1 if bad or rc else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert '"epochs": 4' in r.stdout


def test_import_loads_no_matplotlib():
    """Plotting imports matplotlib inside its functions: importing the
    package, its plotting modules and the mesh loads none of it (nor the
    JAX package)."""
    code = ("import sys, scintools_tpu_torch, scintools_tpu_torch.plotting,"
            " scintools_tpu_torch.thth.plots, scintools_tpu_torch.sim.plots,"
            " scintools_tpu_torch.compat, scintools_tpu_torch.parallel.mesh,"
            " scintools_tpu_torch.parallel.fft,"
            " scintools_tpu_torch.parallel.survey;"
            "bad = [m for m in sys.modules if m in ('matplotlib',"
            " 'scintools_tpu') or m.startswith(('matplotlib.',"
            " 'scintools_tpu.'))];"
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
