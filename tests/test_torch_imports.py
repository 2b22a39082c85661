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
            " scintools_tpu_torch.detect.trigger;"
            "bad = [m for m in sys.modules if m == 'scintools_tpu' or "
            "m.startswith('scintools_tpu.')];"
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
