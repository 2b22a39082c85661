"""The port's formulation registry (``scintools_tpu_torch/backend.py``)
and the ops that resolve through it, against the JAX package on the CPU.

(a) The resolution-order cases of tests/test_backend.py and
tests/test_ledger.py run side by side on one test op registered in both
packages: each case resolves the same in both. (b) The port registers
the JAX package's ops with the same choices and defaults, less
``jit.donate``. (c) For every op and every choice, one numpy input made
from a seed goes through the JAX package and through the port with the
choice pinned by ``set_formulation`` in both; the tolerance is the one
the JAX package's own tests hold that formulation to, or 1e-5 of the
peak in float32 where they state none. (d) With nothing pinned every
site gives bitwise what it gives with the port's explicit choice.
(e) A pin after a first call reroutes a cached site. (f) Tables: the
JAX package's file format loads in the port, the port's own table
round-trips through a fresh process, a stale choice is skipped, and the
JAX package's committed ``tools/formulation_tables/cpu.json`` is never
read."""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))

from test_arc_pallas import _arc_batch  # noqa: E402
from test_fused_search import _arc_chunks  # noqa: E402
from test_torch_retrieval import make_arc_chunks  # noqa: E402
from test_torch_scenario import LANES, SEEDS, jax_normals, relmax  # noqa: E402

from scintools_tpu import backend as JB  # noqa: E402
from scintools_tpu_torch import backend as TB  # noqa: E402

# the modules that register the ops, in both packages
_MODULES = ("ops.xfft", "ops.sspec", "ops.scatim", "ops.normsspec",
            "detect.correlate", "thth.batch", "thth.retrieval",
            "sim.factory")
for _m in _MODULES:
    __import__(f"scintools_tpu.{_m}")
    __import__(f"scintools_tpu_torch.{_m}")

from scintools_tpu.ops import acf as jacf  # noqa: E402
from scintools_tpu.ops import normsspec as jns  # noqa: E402
from scintools_tpu.ops import scatim as jscatim  # noqa: E402
from scintools_tpu.ops import sspec as jsspec  # noqa: E402
from scintools_tpu.ops import xfft as jxfft  # noqa: E402
from scintools_tpu.sim import factory as jf  # noqa: E402
from scintools_tpu.thth import batch as jbatch  # noqa: E402
from scintools_tpu.thth import core as jcore  # noqa: E402
from scintools_tpu.thth import retrieval as jret  # noqa: E402
from scintools_tpu import detect as JD  # noqa: E402
from scintools_tpu_torch import detect as TD  # noqa: E402
from scintools_tpu_torch.ops import acf as tacf  # noqa: E402
from scintools_tpu_torch.ops import normsspec as tns  # noqa: E402
from scintools_tpu_torch.ops import scatim as tscatim  # noqa: E402
from scintools_tpu_torch.ops import sspec as tsspec  # noqa: E402
from scintools_tpu_torch.ops import xfft as txfft  # noqa: E402
from scintools_tpu_torch.sim import factory as tf  # noqa: E402
from scintools_tpu_torch.thth import batch as tbatch  # noqa: E402
from scintools_tpu_torch.thth import retrieval as tret  # noqa: E402
from scintools_tpu_torch.thth import search as tsearch  # noqa: E402

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)       # tier-1 runs under xdist workers
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_registry(monkeypatch):
    """No pin, env pin or measured table leaks into or out of a test."""
    for k in list(os.environ):
        if k.startswith("SCINTOOLS_FORMULATION_") or \
                k == "SCINTOOLS_TORCH_FORMULATION_TABLES":
            monkeypatch.delenv(k)
    yield
    for bk in (JB, TB):
        bk._FORMULATION_OVERRIDES.clear()
        bk.reset_measured_formulations()


@contextlib.contextmanager
def pinned(op, choice):
    """``choice`` pinned for ``op`` in both packages."""
    JB.set_formulation(op, choice)
    TB.set_formulation(op, choice)
    try:
        yield
    finally:
        JB.set_formulation(op, None)
        TB.set_formulation(op, None)


def _near(got, want, rel):
    """|got − want| ≤ rel · max|want| everywhere."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.max(np.abs(want)))


def _bitwise(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _bitwise(x, y)
        return
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------
# (a) resolution order, side by side
# ---------------------------------------------------------------------

OP = "testformulation.op"


def _table_env(bk):
    return ("SCINTOOLS_FORMULATION_TABLES" if bk is JB
            else "SCINTOOLS_TORCH_FORMULATION_TABLES")


def _case_registered(bk, tmp):
    return [bk.formulation(OP, platform="cpu"),
            bk.formulation(OP, platform="other")]


def _case_measured_beats_registered(bk, tmp):
    bk.record_measured_formulation(OP, "tuned", platform="cpu")
    return [bk.formulation(OP, platform="cpu"),
            bk.formulation(OP, platform="other")]


def _case_env_beats_measured(bk, tmp):
    bk.record_measured_formulation(OP, "tuned", platform="cpu")
    os.environ["SCINTOOLS_FORMULATION_TESTFORMULATION_OP"] = "slow"
    return bk.formulation(OP, platform="cpu")


def _case_override_beats_env(bk, tmp):
    os.environ["SCINTOOLS_FORMULATION_TESTFORMULATION_OP"] = "slow"
    bk.set_formulation(OP, "fast")
    out = [bk.formulation(OP, platform="cpu"),
           bk.formulation(OP, platform="other")]
    bk.set_formulation(OP, None)
    return out + [bk.formulation(OP, platform="other")]


def _case_stale_table_skipped(bk, tmp):
    with open(bk.formulation_table_path("cpu"), "w") as fh:
        json.dump({"platform": "cpu", "ops": {
            OP: {"choice": "renamed_away"}}}, fh)
    bk.reset_measured_formulations()
    return bk.formulation(OP, platform="cpu")


def _case_save_then_reload(bk, tmp):
    bk.record_measured_formulation(OP, "tuned",
                                   seconds={"tuned": 0.1, "fast": 0.4},
                                   platform="cpu", persist=True)
    data = json.loads(open(bk.formulation_table_path("cpu")).read())
    bk.reset_measured_formulations()
    return [data, bk.formulation(OP, platform="cpu")]


def _case_snapshot_layers(bk, tmp):
    bk.record_measured_formulation(OP, "tuned", platform="cpu")
    bk.set_formulation(OP, "slow")
    entry = bk.formulation_snapshot()[OP]
    return {k: entry[k] for k in ("choices", "default", "platforms",
                                  "override", "active")}


def _raises(fn):
    try:
        fn()
    except Exception as exc:          # the type and the message's gist
        return type(exc).__name__
    return None


def _case_loud_errors(bk, tmp):
    os.environ["SCINTOOLS_FORMULATION_TESTFORMULATION_OP"] = "zzz"
    return [_raises(lambda: bk.formulation("no.such.op")),
            _raises(lambda: bk.set_formulation(OP, "zzz")),
            _raises(lambda: bk.formulation(OP, platform="cpu")),
            _raises(lambda: bk.register_formulation(
                "bad.op", default="x", choices=("y",))),
            _raises(lambda: bk.measure_formulation(OP, {"zzz": None}))]


def _case_measure_pins_winner(bk, tmp):
    import time

    winner, timings = bk.measure_formulation(
        OP, {"slow": lambda: time.sleep(0.02), "fast": lambda: None},
        repeats=1)
    return [winner, sorted(timings), bk.formulation(OP, platform="cpu")]


ORDER_CASES = {f.__name__[6:]: f for f in (
    _case_registered, _case_measured_beats_registered,
    _case_env_beats_measured, _case_override_beats_env,
    _case_stale_table_skipped, _case_save_then_reload,
    _case_snapshot_layers, _case_loud_errors, _case_measure_pins_winner)}


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_resolution_order_matches_jax(case, tmp_path, monkeypatch):
    """The JAX package's resolution order (override > env > measured
    table > registered platform entry > default, loud on unknown ops
    and bad pins, quiet on a stale table entry) on one test op."""
    out = {}
    for bk in (JB, TB):
        tmp = tmp_path / bk.__name__
        tmp.mkdir()
        with monkeypatch.context() as mp:
            mp.setenv(_table_env(bk), str(tmp))
            bk.register_formulation(OP, default="slow",
                                    choices=("slow", "fast", "tuned"),
                                    platforms={"cpu": "fast"})
            bk.reset_measured_formulations()
            try:
                out[bk] = ORDER_CASES[case](bk, tmp)
            finally:
                os.environ.pop("SCINTOOLS_FORMULATION_TESTFORMULATION_OP",
                               None)
                bk.set_formulation(OP, None)
                bk.reset_measured_formulations()
                bk._FORMULATIONS.pop(OP, None)
    assert out[TB] == out[JB]


# ---------------------------------------------------------------------
# (b) the registered ops
# ---------------------------------------------------------------------

def test_ops_and_choices_are_the_jax_registry():
    want = {op: (rec["choices"], rec["default"])
            for op, rec in JB._FORMULATIONS.items()
            if op != "jit.donate" and not op.startswith("test")}
    got = {op: (rec["choices"], rec["default"])
           for op, rec in TB._FORMULATIONS.items()
           if not op.startswith("test")}
    assert len(got) == 15
    assert got == want


# the choice each port site ran before the registry, on both devices
TODAY = {"ops.cs": "rfft", "xfft.acf": "real", "xfft.sspec": "half",
         "xfft.acf_sspec": "real", "xfft.zoom": "czt",
         "xfft.offgrid": "taylor", "xfft.profile": "real",
         "ops.scatim_interp": "gather", "ops.arc_profile_interp": "tent",
         "detect.correlate": "half", "thth.eig": "pallas",
         "thth.retrieval_eig": "pallas", "thth.retrieval_group": "hbm",
         "sim.screen": "compensated", "sim.propagate": "column"}


@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_registered_entries_are_what_the_port_ran(platform):
    snap = TB.formulation_snapshot(platform)
    assert {op: e["active"] for op, e in snap.items()} == TODAY
    assert all(e["override"] is None and e["measured"] is None
               for e in snap.values())


# ---------------------------------------------------------------------
# (c) every op, every choice, against the JAX package
# ---------------------------------------------------------------------

def _rng(seed=5):
    return np.random.default_rng(seed)


def _cs_pair():
    d = _rng(1).standard_normal((3, 12, 10)).astype(np.float32) + 2.0
    want = jsspec.chunk_conjugate_spectrum_batch(jnp.asarray(d), npad=1,
                                                 xp=jnp)
    got = tsspec.chunk_conjugate_spectrum_batch(torch.from_numpy(d), npad=1)
    return got, want, 1e-5


def _acf_pair():
    d = _rng(2).standard_normal((2, 12, 10))
    want = jacf.autocovariance(d, backend="jax")
    got = tacf.autocovariance(d, device=CPU)
    return got, want, 1e-5


def _sspec_pair():
    d = _rng(3).standard_normal((12, 10))
    want = jsspec.secondary_spectrum_power(d, backend="jax")
    got = tsspec.secondary_spectrum_power(torch.from_numpy(d).float())
    return got, want, 1e-5


def _acf_sspec_pair():
    s = 10 * np.log10(_rng(4).random((16, 12)) + 0.1)
    want = jacf.acf_from_sspec(s, backend="jax")
    got = tacf.acf_from_sspec(s, device=CPU)
    return got, want, 1e-5


def _zoom_pair():
    d = _rng(6).standard_normal((12, 10))
    band = ((0.5, 7.5, 10), (-6.0, 9.0, 12))
    want = jsspec.secondary_spectrum_power(d, backend="jax", zoom=band)
    got = tsspec.secondary_spectrum_power(torch.from_numpy(d).float(),
                                          zoom=band)
    return got, want, 2e-4                # tests/test_torch_zoom.py, f32


def _offgrid_pair():
    x = _rng(7).standard_normal((3, 24))
    pts = np.array([0.3, 2.7, -4.1, 11.5, 17.25])
    want = jxfft.offgrid_dft_1d(jnp.asarray(x), jnp.asarray(pts), 24,
                                xp=jnp)
    got = txfft.offgrid_dft_1d(torch.from_numpy(x), torch.from_numpy(pts), 24)
    return got, want, 1e-9                # float64 on both sides


def _profile_pair():
    x = _rng(8).standard_normal((2, 31))
    want = jxfft.real_spectrum_1d(x, 16)
    got = txfft.real_spectrum_1d(x, 16)
    return got, want, 1e-12


def _scatim_pair():
    rng = _rng(9)
    lin = rng.standard_normal((20, 24))
    tq = rng.uniform(-1, 20, (6, 7))
    fq = rng.uniform(-1, 24, (6, 7))
    want = jscatim.cubic_interp2d(lin, tq, fq, backend="jax")
    got = tscatim.cubic_interp2d(lin, tq, fq, device=CPU)
    return got, want, 1e-9                # float64 on both sides


def _arc_interp_pair():
    sspecs, tdel, fdop = _arc_batch()
    kw = dict(startbin=2, cutmid=3, numsteps=300, fold=True, pallas=False)
    etas = np.array([0.01, 0.02, 0.005])
    want = jns.make_arc_profile_batch_fn(tdel, fdop, **kw)(sspecs, etas)
    got = tns.make_arc_profile_batch_fn(tdel, fdop, device=CPU,
                                        **kw)(sspecs, etas)
    return got, want, 2e-5                # tests/test_torch_arc.py


@pytest.fixture(scope="module")
def small_bank():
    rng = _rng(10)
    dyns = (rng.standard_normal((3, 16, 32)) + 4.0).astype(np.float32)
    jb = JD.build_bank(16, 32, 30.0, 0.5, 1e-3, 1e-1, n_templates=6)
    carried = TD.TemplateBank.from_numpy(
        jb.etas, np.asarray(jb.templates), np.asarray(jb.valid), jb.tdel,
        jb.fdop, jb.shape, jb.geometry, jb.params, device=CPU)
    return dyns, jb, carried


def _correlate_pair(small_bank):
    dyns, jb, carried = small_bank
    js, jok = JD.correlate_bank(dyns, jb)
    ts, tok = TD.correlate_bank(dyns, carried)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    return ts, js, 1e-4                   # tests/test_torch_detect.py


PAIRS = {"ops.cs": _cs_pair, "xfft.acf": _acf_pair,
         "xfft.sspec": _sspec_pair, "xfft.acf_sspec": _acf_sspec_pair,
         "xfft.zoom": _zoom_pair, "xfft.offgrid": _offgrid_pair,
         "xfft.profile": _profile_pair, "ops.scatim_interp": _scatim_pair,
         "ops.arc_profile_interp": _arc_interp_pair}
PAIR_CASES = [(op, c) for op in sorted(PAIRS)
              for c in JB._FORMULATIONS[op]["choices"]]


@pytest.mark.parametrize("op,choice", PAIR_CASES,
                         ids=[f"{o}={c}" for o, c in PAIR_CASES])
def test_every_choice_matches_jax(op, choice):
    with pinned(op, choice):
        got, want, rel = PAIRS[op]()
    _near(got, want, rel)


@pytest.mark.parametrize("choice", ["half", "dense"])
def test_correlate_choice_matches_jax(choice, small_bank):
    with pinned("detect.correlate", choice):
        got, want, rel = _correlate_pair(small_bank)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rel,
                               atol=rel)


@pytest.mark.parametrize("choice", ["warm", "power", "square", "pallas"])
def test_thth_eig_choice_matches_jax(choice):
    """The fused search with ``method="auto"`` under each pin: η and σ
    at the fused route's rel 1e-2, ``ok`` equal (tests/
    test_torch_methods.py). The JAX package's ``'pallas'`` on the CPU
    falls back to its ``'warm'`` η-scan; the port runs the warm-start
    eigensolver (the kernel's plain version here)."""
    chunks, tlist, freqs, etas, edges, eta_true, npad = _arc_chunks(
        nchunk=3, seed=19)
    fd = jcore.fft_axis(tlist[0], pad=npad, scale=1e3)
    tau = jcore.fft_axis(freqs, pad=npad, scale=1.0)
    stack = np.stack(chunks).astype(np.float32)
    with pinned("thth.eig", choice):
        want = [np.asarray(x) for x in jbatch.make_fused_search_fn(
            tau, fd, edges, 32, 32, npad=npad, fw=0.3)(
                jnp.asarray(stack), jnp.asarray(etas))]
        got = [x.numpy() for x in tbatch.make_fused_search_fn(
            tau, fd, edges, 32, 32, npad=npad, fw=0.3, device=CPU)(
                torch.from_numpy(stack), etas)]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-2)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-2)
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_allclose(got[1], eta_true, rtol=0.1)


def _corr(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return np.abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b)
                                    + 1e-300)


@pytest.fixture(scope="module")
def retrieval_grid():
    chunks, times, freqs, edges = make_arc_chunks(n_chunks=10)
    B = len(chunks)
    return (chunks, np.tile(edges, (B, 1)), np.full(B, 0.3),
            times[1] - times[0], freqs[1] - freqs[0])


RETRIEVAL_CASES = ([("thth.retrieval_eig", c)
                    for c in ("eigh", "power", "warm", "pallas")]
                   + [("thth.retrieval_group", c) for c in ("hbm", "cache")]
                   + [("ops.cs", c) for c in ("rfft", "fft2")])


@pytest.mark.parametrize("op,choice", RETRIEVAL_CASES,
                         ids=[f"{o}={c}" for o, c in RETRIEVAL_CASES])
def test_retrieval_choice_matches_jax(op, choice, retrieval_grid):
    """``grid_retrieval_batch(method=None)`` under each pin: per-chunk
    phase-aligned correlation > 0.99 (the JAX test's floor between two
    eigensolvers, tests/test_retrieval_batch.py:163), ``ok`` equal.
    The grouping changes the chained solver's warm starts only."""
    chunks, edges_b, etas_b, dt, df = retrieval_grid
    with pinned(op, choice):
        want, ok_j = jret.grid_retrieval_batch(chunks, edges_b, etas_b, dt,
                                               df, npad=1, method=None,
                                               with_ok=True)
        got, ok_t = tret.grid_retrieval_batch(chunks, edges_b, etas_b, dt,
                                              df, npad=1, method=None,
                                              with_ok=True, device=CPU)
    np.testing.assert_array_equal(ok_t, ok_j)
    for b in range(len(chunks)):
        assert _corr(got[b], want[b]) > 0.99, b


def test_cache_group_is_eight():
    assert tret.default_group(40, "cpu") == tret.hbm_group(40) == 20
    with pinned("thth.retrieval_group", "cache"):
        assert tret.default_group(40, "cpu") == 8
        assert tret.default_group(5, "cuda") == 5


@pytest.mark.parametrize("screen", ["compensated", "oversized", "plain"])
def test_sim_screen_choice_matches_jax(screen):
    """The factory's screens under each ``sim.screen`` pin from the JAX
    draws: 1e-5 of the maximum in float32 (tests/test_torch_scenario.py).
    """
    ns = 32
    keys = jf.lane_keys_from_seeds(SEEDS)
    shape = (2 * ns,) * 2 if screen == "oversized" else (ns,) * 2
    normals = jax_normals(keys, shape, 16 if screen == "compensated" else 0,
                          jnp.float32)
    with pinned("sim.screen", screen):
        want = jf.simulate_screens(4, ns=ns, nf=8, keys=keys, group_size=4,
                                   **LANES)
        fn = tf.make_scenario_factory(ns=ns, nf=8, nscreens=4, group_size=4,
                                      device=CPU)
    assert relmax(fn.screens_from_normals(*normals, **LANES).numpy(),
                  want) < 1e-5


@pytest.mark.parametrize("prop", ["phasor", "column", "dense"])
def test_sim_propagate_choice_matches_jax(prop):
    """The propagation of the JAX draws' screens under each
    ``sim.propagate`` pin: 1e-4 of the maximum in float32 (tests/
    test_sim_factory.py's phasor-vs-column tolerance)."""
    ns, nf = 32, 40 if prop == "phasor" else 8
    keys = jf.lane_keys_from_seeds(SEEDS)
    normals = jax_normals(keys, (ns, ns), 16, jnp.float32)
    with pinned("sim.propagate", prop):
        want = jf.simulate_scenarios(4, ns=ns, nf=nf, keys=keys,
                                     group_size=4, **LANES)
        fn = tf.make_scenario_factory(ns=ns, nf=nf, nscreens=4, group_size=4,
                                      device=CPU)
        spe = fn.propagate_group(fn.screens_from_normals(*normals, **LANES))
    assert relmax((spe.real ** 2 + spe.imag ** 2).numpy(), want) < 1e-4


# ---------------------------------------------------------------------
# (d) with nothing pinned, every site is bitwise its explicit choice
# ---------------------------------------------------------------------

def _d_sites():
    rng = _rng(11)
    d32 = torch.from_numpy(rng.standard_normal((12, 10)).astype(np.float32))
    d3 = torch.from_numpy(rng.standard_normal((3, 12, 10)).astype(
        np.float32))
    x = rng.standard_normal((12, 10))
    s = 10 * np.log10(rng.random((16, 12)) + 0.1)
    v = torch.from_numpy(rng.standard_normal((2, 24)))
    pts = torch.tensor([0.3, 2.7, 11.5], dtype=torch.float64)
    band = ((0.5, 7.5, 10), (-6.0, 9.0, 12))
    lin = rng.standard_normal((20, 24))
    tq, fq = rng.uniform(0, 19, (5, 4)), rng.uniform(0, 23, (5, 4))
    sspecs, tdel, fdop = _arc_batch()
    etas = np.array([0.01, 0.02, 0.005])
    akw = dict(startbin=2, cutmid=3, numsteps=300)
    return {
        "ops.cs": lambda c: tsspec.chunk_conjugate_spectrum_batch(
            d3, npad=1, **({} if c is None else {"method": c})),
        "xfft.acf": lambda c: tacf.autocovariance(x, variant=c, device=CPU),
        "xfft.sspec": lambda c: tsspec.secondary_spectrum_power(
            d32, variant=c),
        "xfft.acf_sspec": lambda c: tacf.acf_from_sspec(s, variant=c,
                                                        device=CPU),
        "xfft.zoom": lambda c: tsspec.secondary_spectrum_power(
            d32, zoom=band, variant=c),
        "xfft.offgrid": lambda c: txfft.offgrid_dft_1d(v, pts, 24,
                                                       variant=c),
        "xfft.profile": lambda c: txfft.real_spectrum_1d(v, 12, variant=c),
        "ops.scatim_interp": lambda c: tscatim.cubic_interp2d(
            lin, tq, fq, method=c, device=CPU),
        "ops.arc_profile_interp": lambda c: tns.make_arc_profile_batch_fn(
            tdel, fdop, device=CPU, pallas=None if c is None else False,
            **akw)(sspecs, etas),
        "thth.retrieval_group": lambda c: tret.default_group(
            40, "cpu") if c is None else tret.hbm_group(40),
    }


@pytest.mark.parametrize("op", sorted(_d_sites()))
def test_unpinned_site_is_bitwise_todays_choice(op):
    """The kernel route of the arc profile (``pallas=None``) is the
    ``"tent"`` arithmetic: the kernel's plain version on the CPU."""
    site = _d_sites()[op]
    explicit = TODAY[op]
    _bitwise(site(None), site(explicit if op != "ops.scatim_interp"
                              else "gather"))


def test_unpinned_search_retrieval_correlate_factory_are_bitwise(
        small_bank, retrieval_grid):
    chunks, tlist, freqs, etas, edges, _, npad = _arc_chunks(nchunk=3,
                                                             seed=19)
    fd = jcore.fft_axis(tlist[0], pad=npad, scale=1e3)
    tau = jcore.fft_axis(freqs, pad=npad, scale=1.0)
    stack = torch.from_numpy(np.stack(chunks).astype(np.float32))
    auto, pallas = (tbatch.make_fused_search_fn(
        tau, fd, edges, 32, 32, npad=npad, method=m, device=CPU)(
            stack, etas) for m in ("auto", "pallas"))
    _bitwise(auto, pallas)
    ch, edges_b, etas_b, dt, df = retrieval_grid
    _bitwise(tret.grid_retrieval_batch(ch, edges_b, etas_b, dt, df, npad=1,
                                       method=None, device=CPU),
             tret.grid_retrieval_batch(ch, edges_b, etas_b, dt, df, npad=1,
                                       method="kernel", device=CPU,
                                       group=tret.hbm_group(len(ch))))
    dyns, _, carried = small_bank
    _bitwise(TD.correlate_bank(dyns, carried),
             TD.correlate_bank(dyns, carried, variant="half"))
    kw = dict(ns=16, nf=4, nscreens=2, group_size=2, seed=3, device=CPU)
    _bitwise(tf.simulate_scenarios(**kw),
             tf.simulate_scenarios(screen="compensated", propagate="column",
                                   **kw))


# ---------------------------------------------------------------------
# (e) a pin after a first call reroutes a cached site
# ---------------------------------------------------------------------

def test_pin_after_first_call_reroutes_cached_sites(small_bank,
                                                    retrieval_grid):
    dyns, _, carried = small_bank
    first = TD.correlate_bank(dyns, carried)[0]
    dense = TD.correlate_bank(dyns, carried, variant="dense")[0]
    assert not torch.equal(first, dense)
    TB.set_formulation("detect.correlate", "dense")
    _bitwise(TD.correlate_bank(dyns, carried)[0], dense)

    kw = dict(ns=16, nf=4, nscreens=2, group_size=2, seed=3, device=CPU)
    tf.simulate_scenarios(**kw)
    TB.set_formulation("sim.propagate", "dense")
    _bitwise(tf.simulate_scenarios(**kw),
             tf.simulate_scenarios(propagate="dense", **kw))

    ch, edges_b, etas_b, dt, df = retrieval_grid
    args = (ch[:4], edges_b[:4], etas_b[:4], dt, df)
    tret.grid_retrieval_batch(*args, npad=1, method=None, device=CPU)
    TB.set_formulation("thth.retrieval_eig", "eigh")
    _bitwise(tret.grid_retrieval_batch(*args, npad=1, method=None,
                                       device=CPU),
             tret.grid_retrieval_batch(*args, npad=1, method="eigh",
                                       device=CPU))

    chunks, tlist, freqs, etas, edges, _, _ = _arc_chunks(nchunk=3, seed=19)
    tsearch._FUSED_CACHE.clear()
    before = tsearch.multi_chunk_search(chunks, freqs, tlist, etas, edges,
                                        npad=1, fw=0.3, device=CPU)
    TB.set_formulation("thth.eig", "power")
    after = tsearch.multi_chunk_search(chunks, freqs, tlist, etas, edges,
                                       npad=1, fw=0.3, device=CPU)
    power = tsearch.multi_chunk_search(chunks, freqs, tlist, etas, edges,
                                       npad=1, fw=0.3, method="power",
                                       device=CPU)
    assert [r.eta for r in after] == [r.eta for r in power]
    assert [r.eta for r in after] != [r.eta for r in before]
    TB.set_formulation("ops.cs", "fft2")
    fft2 = tsearch.multi_chunk_search(chunks, freqs, tlist, etas, edges,
                                      npad=1, fw=0.3, device=CPU)
    assert len(tsearch._FUSED_CACHE) == 3
    np.testing.assert_allclose([r.eta for r in fft2],
                               [r.eta for r in after], rtol=1e-4)


def test_pin_after_first_call_reroutes_programs():
    x = torch.from_numpy(_rng(12).standard_normal((2, 12, 10)).astype(
        np.float32))
    real = txfft.acf_program(12, 10, device=CPU)(x)
    TB.set_formulation("xfft.acf", "dense")
    prog = txfft.acf_program(12, 10, device=CPU)
    _bitwise(prog(x), txfft.acf_program(12, 10, variant="dense",
                                        device=CPU)(x))
    assert not torch.equal(prog(x), real)


def test_pinned_choice_the_port_cannot_honour_raises():
    with pytest.raises(ValueError, match="not one of"):
        TB.set_formulation("thth.eig", "mosaic")
    with pytest.raises(ValueError, match="pallas=True"):
        sspecs, tdel, fdop = _arc_batch()
        tns.make_arc_profile_batch_fn(tdel, fdop * (1 + 0.01 * fdop ** 2),
                                      pallas=True, device=CPU)


# ---------------------------------------------------------------------
# (f) the tables
# ---------------------------------------------------------------------

def test_jax_table_loads_in_the_port(tmp_path, monkeypatch):
    monkeypatch.setenv("SCINTOOLS_FORMULATION_TABLES", str(tmp_path))
    monkeypatch.setenv("SCINTOOLS_TORCH_FORMULATION_TABLES", str(tmp_path))
    JB.reset_measured_formulations()
    JB.record_measured_formulation("xfft.zoom", "dense",
                                   seconds={"dense": 1.0, "czt": 2.0},
                                   platform="cuda", persist=True)
    JB.record_measured_formulation("detect.correlate", "dense",
                                   platform="cuda", persist=True)
    TB.reset_measured_formulations()
    assert TB.formulation("xfft.zoom", "cuda") == "dense"
    assert TB.formulation("detect.correlate", "cuda") == "dense"
    assert TB.formulation("xfft.zoom", "cpu") == "czt"
    assert TB.formulation_snapshot("cuda")["xfft.zoom"]["measured"] \
        == "dense"


def test_port_table_round_trips_through_a_process(tmp_path, monkeypatch):
    monkeypatch.setenv("SCINTOOLS_TORCH_FORMULATION_TABLES", str(tmp_path))
    TB.reset_measured_formulations()
    winner, timings = TB.measure_formulation(
        "xfft.offgrid", {"taylor": lambda: None, "dense": lambda: None},
        repeats=1, persist=True, platform="cpu")
    TB.set_formulation("xfft.offgrid", None)
    path = TB.formulation_table_path("cpu")
    data = json.loads(open(path).read())
    assert path.startswith(str(tmp_path))
    assert data["platform"] == "cpu"
    assert data["ops"]["xfft.offgrid"]["choice"] == winner
    assert set(data["ops"]["xfft.offgrid"]["seconds"]) == set(timings)
    child = ("import scintools_tpu_torch.ops.xfft\n"
             "from scintools_tpu_torch import backend\n"
             "print(backend.formulation('xfft.offgrid', 'cpu'))\n")
    env = dict(os.environ, SCINTOOLS_TORCH_FORMULATION_TABLES=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", child], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == winner


def test_stale_port_table_entry_is_skipped(tmp_path, monkeypatch):
    monkeypatch.setenv("SCINTOOLS_TORCH_FORMULATION_TABLES", str(tmp_path))
    with open(tmp_path / "cpu.json", "w") as fh:
        json.dump({"platform": "cpu", "ops": {
            "xfft.sspec": {"choice": "renamed_away"},
            "xfft.acf": "dense"}}, fh)
    TB.reset_measured_formulations()
    assert TB.formulation("xfft.sspec", "cpu") == "half"
    assert TB.formulation("xfft.acf", "cpu") == "dense"


def test_jax_committed_table_is_never_read():
    """The JAX package's committed CPU table pins ``detect.correlate``
    to ``"dense"``; a fresh port process with no pin and no table
    variable resolves ``"half"``, and never opens that file."""
    jtable = os.path.join(REPO, "tools", "formulation_tables", "cpu.json")
    assert json.load(open(jtable))["ops"]["detect.correlate"]["choice"] \
        == "dense"
    assert not TB.formulation_table_dir().startswith(
        os.path.join(REPO, "tools"))
    child = ("import scintools_tpu_torch.detect.correlate\n"
             "from scintools_tpu_torch import backend\n"
             "print(backend.formulation('detect.correlate', 'cpu'),"
             " backend.formulation_table_dir())\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SCINTOOLS_")}
    out = subprocess.run([sys.executable, "-c", child], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    choice, table_dir = out.stdout.split()[-2:]
    assert choice == "half"
    assert table_dir == os.path.join(REPO, "scintools_tpu_torch",
                                     "formulation_tables")
