"""The port's mesh across processes against its single-process mesh and
the JAX package's 8-device mesh.

The counterpart of ``tests/test_multihost.py:92-137``: two fresh
interpreters join a gloo process group on 127.0.0.1 through
:func:`scintools_tpu_torch.parallel.checkpoint.initialize_distributed`,
each with four virtual CPU shards (``devices=["cpu"] * 4``), so the
global mesh has 8 shards in rank-major order. Two meshes are driven: one
whose ``seq`` rows lie within a rank (``make_mesh(8)``, 4 data × 2 seq)
and one whose ``seq`` row spans both ranks (``make_mesh(8, seq=8)``).
The ranks import only the port; they write what they computed into the
test's directory, and this process holds it against the port's
single-process 8-shard mesh (bitwise where that mesh is bitwise its
unsharded route: the façade fit, the arc fit, the retrieval chains and
the scenario factory) and against the JAX package on conftest's 8
virtual devices at the tolerances of ``tests/test_torch_parallel.py``.

Ranks and the references here run torch on one CPU thread, so a bitwise
comparison is not between two thread counts' reductions; every wait on
a rank has a deadline. The last case makes one rank's shard raise and
checks that its peer ends with an error within the group's timeout.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
LOCAL = 4                 # virtual CPU shards per rank
GROUP_TIMEOUT_S = 120.0   # the ranks' process-group timeout
FAIL_TIMEOUT_S = 5.0      # the group timeout of the failure case
DEADLINE_S = 240.0        # for both ranks to finish
ETA = 0.3                 # tests/test_thth.py's ETA_TRUE
ARC_STEPS = 2000
FACADE_PREP = dict(cwf=32, cwt=32, npad=1, fw=0.3, neta=40, nedge=24,
                   fitting_proc="standard")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@contextlib.contextmanager
def _torch_threads(n):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


# ---------------------------------------------------------------------
# what each rank computes (this process computes the same on one mesh)
# ---------------------------------------------------------------------

def _facade(inp, mesh):
    from scintools_tpu_torch.dynspec import BasicDyn, Dynspec

    eta = float(inp["facade_eta"])
    ds = Dynspec(dyn=BasicDyn(inp["facade_dyn"].copy(),
                              times=inp["facade_times"],
                              freqs=inp["facade_freqs"]),
                 process=False, verbose=False, device="cpu")
    ds.prep_thetatheta(eta_min=0.5 * eta, eta_max=2.0 * eta, **FACADE_PREP)
    ds.fit_thetatheta(mesh=mesh)
    return ds


def _compute(inp, mesh8, mesh8s):
    """Every mesh path of the slice on ``mesh8`` (4 data × 2 seq) and,
    for the distributed FFTs and Gerchberg–Saxton, ``mesh8s`` (1 × 8):
    a flat dict of numpy arrays."""
    from scintools_tpu_torch import parallel as par
    from scintools_tpu_torch.ops.fitarc import fit_arc_batch
    from scintools_tpu_torch.thth import retrieval as tret
    from scintools_tpu_torch.workloads import make_survey_arc_problem

    out = {}
    x = torch.as_tensor(inp["fft_x"])
    for kind in ("data", "batch_freq", "replicated"):
        sh = {"data": par.data_sharding, "batch_freq":
              par.batch_freq_sharding, "replicated": par.replicated}[kind]
        out[f"roundtrip_{kind}"] = par.gather(par.shard(
            x.repeat(2, 1, 1), sh(mesh8))).numpy()
    for name, m in (("m8", mesh8), ("m8s", mesh8s)):
        out[f"fft2_{name}"] = par.make_fft2_sharded(m)(x).numpy()
        out[f"ifft2_{name}"] = par.make_fft2_sharded(m, inverse=True)(
            x).numpy()
        out[f"sspec_{name}"] = par.make_sspec_power_sharded(
            m, 16, 16)(x.real.float()).numpy()

    p = make_survey_arc_problem(B=6, device="cpu")
    for on_device in (True, False):
        fits = fit_arc_batch(p["sspecs"], p["tdel"], p["fdop"],
                             numsteps=ARC_STEPS, on_device=on_device,
                             mesh=mesh8)
        tag = "dev" if on_device else "host"
        out[f"arc_{tag}_eta"] = np.array(
            [[f.eta, f.etaerr, f.etaerr2] for f in fits])
        out[f"arc_{tag}_profile"] = np.stack([f.profile for f in fits])

    ds = _facade(inp, mesh=mesh8)
    out["facade_eta_evo"] = ds.eta_evo
    out["facade_eta_evo_err"] = ds.eta_evo_err
    out["facade_eta_evo_ok"] = ds.eta_evo_ok
    out["facade_ththeta"] = np.array(ds.ththeta)

    out["gs"] = tret.gerchberg_saxton(inp["gs_E"], inp["gs_dyn"],
                                      freqs=inp["gs_freqs"], niter=3,
                                      mesh=mesh8s)

    chunks, edges = inp["retr_chunks"], inp["retr_edges"]
    dt, df = float(inp["retr_dt"]), float(inp["retr_df"])
    out["retr_batch"] = tret.chunk_retrieval_batch(
        chunks[:5], edges, ETA, dt, df, npad=1, mesh=mesh8)
    B = len(chunks)
    fn = par.survey.make_retrieval_sharded(mesh8, 32, 32, dt, df,
                                           len(edges), npad=1)
    E, ok = fn(torch.as_tensor(chunks, dtype=torch.float32),
               torch.as_tensor(np.tile(edges, (B, 1))),
               torch.full((B,), ETA, dtype=torch.float64), group=3)
    out["retr_chains_E"], out["retr_chains_ok"] = E.numpy(), ok.numpy()

    keys = np.arange(11, 21)
    dyn, ok = par.make_scenario_factory_sharded(mesh8, ns=32, nf=8,
                                                nscreens=10)(
        keys, np.linspace(1.0, 4.0, 10), 1.0, 0.0, 5 / 3)
    out["scenario_dyn"], out["scenario_ok"] = dyn.numpy(), ok.numpy()

    nf, nt = inp["step_dyns"].shape[1:]
    params, chisq, power, tcut, fcut = par.make_survey_step(
        mesh8, nf, nt, dt=2.0, df=0.05, alpha=5 / 3)(inp["step_dyns"])
    for k, v in params.items():
        out[f"step_{k}"] = v.numpy()
    out["step_chisq"], out["step_power"] = chisq.numpy(), power.numpy()
    out["step_tcut"], out["step_fcut"] = tcut.numpy(), fcut.numpy()
    return out


def _mesh_info(m):
    return {"ranks": m.ranks.tolist(), "local": m.local,
            "first": str(m.first), "crosses_ranks": m.crosses_ranks,
            "key_ranks": list(m.key[3]), "shape": dict(m.shape)}


def _worker(rank, addr, dead_addr, fail_addr, folder):
    """One rank: bring-up semantics, every mesh path, then the failure
    case on a second process group. Writes ``rank{r}.json`` (what it
    saw) and ``rank{r}.npz`` (what it computed)."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from scintools_tpu_torch import parallel as par
    from scintools_tpu_torch.backend import KernelError
    from scintools_tpu_torch.parallel.checkpoint import \
        initialize_distributed
    from scintools_tpu_torch.parallel.mesh import run_lanes

    info = {}
    if rank == 1:
        # the environment alone (set by the test for this rank)
        initialize_distributed(timeout_s=GROUP_TIMEOUT_S)
    else:
        # explicit arguments against a hostile environment: the address,
        # world size and a process_id of 0 must all win
        initialize_distributed(addr, 2, 0, timeout_s=GROUP_TIMEOUT_S)
    info["backend"] = dist.get_backend()
    info["world"], info["rank"] = dist.get_world_size(), dist.get_rank()
    initialize_distributed(dead_addr, 5, 3)          # a no-op now
    info["second_call_world"] = dist.get_world_size()

    mesh8 = par.make_mesh(8, devices=["cpu"] * LOCAL)
    mesh8s = par.make_mesh(8, seq=8, devices=["cpu"] * LOCAL)
    info["mesh8"], info["mesh8s"] = _mesh_info(mesh8), _mesh_info(mesh8s)
    with np.load(os.path.join(folder, "inputs.npz")) as f:
        inp = dict(f)
    np.savez(os.path.join(folder, f"rank{rank}.npz"),
             **_compute(inp, mesh8, mesh8s))
    info["jax_loaded"] = "jax" in sys.modules
    info["jax_package_loaded"] = "scintools_tpu" in sys.modules

    # the failure case: rank 1's shard raises; rank 0 waits in the
    # gather until the group's timeout, while rank 1 is still alive (the
    # barrier brings both to the new group's short rendezvous together)
    dist.barrier()
    dist.destroy_process_group()
    initialize_distributed(fail_addr, 2, rank, timeout_s=FAIL_TIMEOUT_S)
    mesh = par.make_mesh(2, devices=["cpu"])

    def fn_of(dev, n):
        def run(x):
            if rank == 1:
                raise KernelError("injected shard fault")
            return 2 * x
        return run

    def write(**kw):
        info.update(kw)
        with open(os.path.join(folder, f"rank{rank}.json"), "w") as fh:
            json.dump(info, fh)

    write(failure=None)
    t0 = time.monotonic()
    try:
        run_lanes(mesh, fn_of, (torch.arange(4.0),))
    except KernelError:
        write(failure="KernelError")
        time.sleep(3 * FAIL_TIMEOUT_S)
        raise
    except RuntimeError as e:
        write(failure=type(e).__name__, waited_s=time.monotonic() - t0)
        raise
    write(failure="none raised")


def _spawn(folder):
    """Start both ranks with their environments: rank 1 brings itself up
    from COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID alone; rank
    0 gets contrary values there and explicit arguments."""
    addr, dead, fail = (f"127.0.0.1:{_free_port()}" for _ in range(3))
    base = {k: v for k, v in os.environ.items()
            if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES",
                         "PROCESS_ID", "MASTER_ADDR", "WORLD_SIZE", "RANK",
                         "LOCAL_RANK")}
    base["PYTHONPATH"] = os.pathsep.join(
        [ROOT, TESTS] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    envs = [dict(base, COORDINATOR_ADDRESS=dead, NUM_PROCESSES="3",
                 PROCESS_ID="1"),
            dict(base, COORDINATOR_ADDRESS=addr, NUM_PROCESSES="2",
                 PROCESS_ID="1")]
    procs = []
    for rank, env in enumerate(envs):
        code = (f"import test_torch_multiprocess as t; t._worker({rank}, "
                f"{addr!r}, {dead!r}, {fail!r}, {str(folder)!r})")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=str(folder),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    return procs


def _wait(procs, t_start):
    """Each rank's ``(returncode, stdout, stderr)``, every rank killed at
    the deadline."""
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(
                timeout=max(1.0, t_start + DEADLINE_S - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate(timeout=30)
        outs.append((p.returncode, out.decode(), err.decode()))
    return outs


def _inputs():
    from test_thth import make_arc_dspec, make_arc_edges

    from scintools_tpu_torch.sim.simulation import simulate_dynspec_batch

    rng = np.random.default_rng(2026)
    inp = {"fft_x": rng.normal(size=(4, 16, 16))
           + 1j * rng.normal(size=(4, 16, 16))}
    # tests/test_torch_parallel.py's thin-screen arc (64², chunks of 32)
    from test_torch_parallel import _arc_facade_dyn

    (inp["facade_dyn"], inp["facade_times"], inp["facade_freqs"],
     inp["facade_eta"]) = _arc_facade_dyn()
    inp["gs_E"] = rng.standard_normal((32, 16)) \
        + 1j * rng.standard_normal((32, 16))
    inp["gs_dyn"] = rng.random((32, 16)) + 0.5
    inp["gs_dyn"][4, 5] = np.nan
    inp["gs_freqs"] = 1400.0 + 0.05 * np.arange(32)
    dspec0, times, freqs = make_arc_dspec(nt=32, nf=32, npix=6)
    inp["retr_chunks"] = np.stack([dspec0 + 1e-9 * i * rng.standard_normal(
        dspec0.shape) for i in range(9)])
    inp["retr_edges"] = make_arc_edges(nt=32, half=6)
    inp["retr_dt"], inp["retr_df"] = times[1] - times[0], freqs[1] - freqs[0]
    inp["step_dyns"] = np.transpose(simulate_dynspec_batch(
        8, ns=16, nf=32, seed=7, device="cpu").numpy(),
        (0, 2, 1)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the two ranks, compute the single-process references while
    they run, and collect what they wrote: ``(inputs, references,
    [rank 0's arrays, rank 1's], [rank 0's info, rank 1's], [(rc,
    stdout, stderr)] * 2)``."""
    from scintools_tpu_torch import parallel as par

    folder = tmp_path_factory.mktemp("ranks")
    inp = _inputs()
    np.savez(folder / "inputs.npz", **inp)
    t_start = time.monotonic()
    procs = _spawn(folder)
    try:
        with _torch_threads(1):
            refs = _compute(inp, par.make_mesh(8, devices=["cpu"] * 8),
                            par.make_mesh(8, seq=8, devices=["cpu"] * 8))
    finally:
        outs = _wait(procs, t_start)
    arrays, infos = [], []
    for r in range(2):
        path = folder / f"rank{r}.npz"
        arrays.append(dict(np.load(path)) if path.exists() else None)
        path = folder / f"rank{r}.json"
        infos.append(json.loads(path.read_text()) if path.exists() else None)
    return inp, refs, arrays, infos, outs


def _computed(ranks):
    """Both ranks' arrays, after checking that both got that far."""
    _, _, arrays, _, outs = ranks
    for r, a in enumerate(arrays):
        assert a is not None, f"rank {r} wrote no results:\n" \
            + outs[r][2][-3000:]
    return arrays


def _both(ranks, name):
    """``name`` as every rank holds it: the ranks must agree bit for bit
    (each gathers the whole result)."""
    a0, a1 = _computed(ranks)
    np.testing.assert_array_equal(a0[name], a1[name])
    return a0[name]


def _corr(a, b):
    return np.abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b)
                                    + 1e-30)


# ---------------------------------------------------------------------
# bring-up and the global mesh
# ---------------------------------------------------------------------

def test_initialize_distributed_semantics(ranks):
    """Rank 0 came up on explicit arguments against a contrary
    environment (process_id 0 included), rank 1 on the environment
    alone; a second call changed nothing; CPU ranks default to gloo."""
    _computed(ranks)
    for r, info in enumerate(ranks[3]):
        assert (info["world"], info["rank"]) == (2, r)
        assert info["second_call_world"] == 2
        assert info["backend"] == "gloo"


def test_initialize_distributed_in_this_process(monkeypatch):
    """With no address and no environment the process stays
    single-process; an explicit request that cannot be met (no rank 0
    listens) raises within its timeout and leaves no group behind. (A
    failed attempt advances torch's group count, so it is made here,
    in a process that starts no group, and not in a rank.)"""
    import torch.distributed as dist

    from scintools_tpu_torch.parallel.checkpoint import \
        initialize_distributed

    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
              "MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    initialize_distributed()
    assert not dist.is_initialized()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        initialize_distributed(f"127.0.0.1:{_free_port()}", 2, 1,
                               backend="gloo", timeout_s=1.0)
    assert time.monotonic() - t0 < 30
    assert not dist.is_initialized()


def test_global_mesh_order_and_key(ranks):
    _computed(ranks)
    from scintools_tpu_torch import parallel as par

    single = par.make_mesh(8, devices=["cpu"] * 8)
    for r, info in enumerate(ranks[3]):
        m8, m8s = info["mesh8"], info["mesh8s"]
        assert m8["shape"] == dict(single.shape) == {"data": 4, "seq": 2}
        assert m8["ranks"] == [[0, 0], [0, 0], [1, 1], [1, 1]]
        assert m8s["ranks"] == [[0, 0, 0, 0, 1, 1, 1, 1]]
        assert m8["local"] == [rank == r for rank in (0,) * 4 + (1,) * 4]
        assert m8["key_ranks"] == [0] * 4 + [1] * 4
        assert m8["first"] == "cpu"
        assert not m8["crosses_ranks"] and m8s["crosses_ranks"]
    assert single.key[3] is None and not single.distributed


@pytest.mark.parametrize("kind", ["data", "batch_freq", "replicated"])
def test_shard_gather_round_trip_across_ranks(ranks, kind):
    """Each rank cuts only its own parts; the gather gives every rank the
    whole array back."""
    np.testing.assert_array_equal(_both(ranks, f"roundtrip_{kind}"),
                                  np.tile(ranks[0]["fft_x"], (2, 1, 1)))


# ---------------------------------------------------------------------
# the distributed FFT across processes
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ["m8", "m8s"])
def test_fft2_across_ranks(ranks, name):
    """Within 1e-8 of numpy in float64 (``tests/test_multihost.py``'s
    gate), on a mesh whose seq row lies within a rank and on one whose
    row spans both; against the port's single-process mesh and the JAX
    package's as ``tests/test_torch_parallel.py`` holds them."""
    import jax
    import jax.numpy as jnp

    from scintools_tpu import parallel as jpar

    inp, refs = ranks[0], ranks[1]
    x = inp["fft_x"]
    seq = 2 if name == "m8" else 8
    for inverse in (False, True):
        key = f"{'i' if inverse else ''}fft2_{name}"
        got = _both(ranks, key)
        want = (np.fft.ifft2 if inverse else np.fft.fft2)(x, axes=(1, 2))
        np.testing.assert_allclose(got.real, want.real, rtol=0, atol=1e-8)
        np.testing.assert_allclose(got.imag, want.imag, rtol=0, atol=1e-8)
        np.testing.assert_allclose(got, refs[key], rtol=1e-10, atol=1e-12)
        jgot = np.asarray(jax.jit(jpar.make_fft2_sharded(
            jpar.make_mesh(8, seq=seq), inverse=inverse))(jnp.asarray(x)))
        np.testing.assert_allclose(got, jgot, rtol=1e-10, atol=1e-12)
    got = _both(ranks, f"sspec_{name}")
    np.testing.assert_allclose(got, refs[f"sspec_{name}"], rtol=1e-5,
                               atol=1e-6 * np.abs(got).max())


# ---------------------------------------------------------------------
# the mesh paths: bitwise where the single-process mesh is bitwise
# ---------------------------------------------------------------------

def test_fit_arc_batch_bitwise(ranks):
    """Against the single-process 8-shard fit bitwise, and the JAX
    sharded fit at the A2 tolerances (η 1e-4, etaerr 1e-3)."""
    from scintools_tpu.ops.fitarc import fit_arc_batch as jfit
    from scintools_tpu_torch.workloads import make_survey_arc_problem

    refs = ranks[1]
    for tag in ("dev", "host"):
        for part in ("eta", "profile"):
            np.testing.assert_array_equal(_both(ranks, f"arc_{tag}_{part}"),
                                          refs[f"arc_{tag}_{part}"])
    from scintools_tpu import parallel as jpar

    p = make_survey_arc_problem(B=6, device="cpu")
    j = jfit(np.asarray(p["sspecs"]), p["tdel"], p["fdop"],
             numsteps=ARC_STEPS, mesh=jpar.make_mesh(8))
    got = _both(ranks, "arc_dev_eta")
    np.testing.assert_allclose(got[:, 0], [f.eta for f in j], rtol=1e-4)
    np.testing.assert_allclose(got[:, 1], [f.etaerr for f in j], rtol=1e-3)


def test_facade_fit_thetatheta_bitwise(ranks):
    refs = ranks[1]
    for name in ("facade_eta_evo", "facade_eta_evo_err", "facade_eta_evo_ok",
                 "facade_ththeta"):
        np.testing.assert_array_equal(_both(ranks, name), refs[name])
    assert np.isfinite(refs["facade_eta_evo"]).all()


def test_retrieval_chains_and_scenario_factory_bitwise(ranks):
    """Whole retrieval chains per shard and per-key factory lanes are
    bitwise the single-process mesh's; the retrieval batch within the
    JAX sharded retrieval's corr 0.999."""
    from scintools_tpu import parallel as jpar
    from scintools_tpu.thth.retrieval import \
        chunk_retrieval_batch as jchunk

    inp, refs = ranks[0], ranks[1]
    for name in ("retr_batch", "retr_chains_E", "retr_chains_ok",
                 "scenario_dyn", "scenario_ok"):
        np.testing.assert_array_equal(_both(ranks, name), refs[name])
    got = _both(ranks, "retr_batch")
    jshard = jchunk(inp["retr_chunks"][:5], inp["retr_edges"], ETA,
                    float(inp["retr_dt"]), float(inp["retr_df"]), npad=1,
                    mesh=jpar.make_mesh(8))
    for b in range(5):
        assert _corr(got[b], jshard[b]) > 0.999, b


def test_gerchberg_saxton_across_ranks(ranks):
    """GS on a seq row spanning both ranks: against the single-process
    mesh at ``tests/test_torch_parallel.py``'s 1e-5 of the peak, and the
    JAX package's float64 loop at rel L2 1e-3."""
    from scintools_tpu.thth.retrieval import gerchberg_saxton as jgs

    inp, refs = ranks[0], ranks[1]
    got = _both(ranks, "gs")
    np.testing.assert_allclose(got, refs["gs"], rtol=0,
                               atol=1e-5 * np.abs(refs["gs"]).max())
    want = jgs(inp["gs_E"], inp["gs_dyn"], freqs=inp["gs_freqs"], niter=3,
               backend="numpy")
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-3


def test_survey_step_across_ranks(ranks):
    """The step's spectra (1e-5 of the peak) and ACF cuts (2e-4) against
    the single-process mesh's and the JAX package's step on its 8-device
    mesh; its fits within 1e-4 (relative) of the single-process mesh's
    (each shard does the same work on one thread; the float32 LM lands
    within a few 1e-6 of it, not on its bits) and within max(stderr,
    5%) of the JAX package's."""
    import jax.numpy as jnp

    from scintools_tpu import parallel as jpar

    inp, refs = ranks[0], ranks[1]
    dyns = inp["step_dyns"]
    jparams, _, jpower, jtcut, jfcut = jpar.make_survey_step(
        jpar.make_mesh(8), 32, 16, dt=2.0, df=0.05, alpha=5 / 3)(
            jnp.asarray(dyns))
    jref = {f"step_{k}": np.asarray(v) for k, v in jparams.items()}
    jref.update(step_power=np.asarray(jpower), step_tcut=np.asarray(jtcut),
                step_fcut=np.asarray(jfcut))
    assert np.isfinite(_both(ranks, "step_chisq")).all()
    for want in (refs, jref):
        power = _both(ranks, "step_power")
        np.testing.assert_allclose(power, want["step_power"], rtol=0,
                                   atol=1e-5 * np.abs(want["step_power"])
                                   .max())
        for cut in ("step_tcut", "step_fcut"):
            np.testing.assert_allclose(_both(ranks, cut), want[cut],
                                       rtol=2e-4, atol=2e-4)
    for name in ("tau", "dnu", "amp"):
        got = _both(ranks, f"step_{name}")
        np.testing.assert_allclose(got, refs[f"step_{name}"], rtol=1e-4,
                                   atol=0, err_msg=name)
        w = jref[f"step_{name}"]
        err = np.nan_to_num(jref[f"step_{name}err"])
        assert np.all(np.abs(got - w)
                      <= np.maximum(np.maximum(err, 0.05 * np.abs(w)),
                                    1e-8)), name


# ---------------------------------------------------------------------
# failure and isolation
# ---------------------------------------------------------------------

def test_failing_rank_ends_its_peer_within_the_timeout(ranks):
    """Rank 1's shard raises ``KernelError`` there; rank 0, waiting in
    the gather while rank 1 lives on, raises when the group's timeout
    expires; both exit non-zero."""
    _computed(ranks)
    (rc0, _, err0), (rc1, _, err1) = ranks[4]
    i0, i1 = ranks[3]
    assert i1["failure"] == "KernelError" and rc1 != 0
    assert "injected shard fault" in err1
    assert rc0 != 0 and i0["failure"] not in (None, "none raised"), err0
    # rank 1 lives on for 3 timeouts: rank 0's error came from its own
    assert i0["waited_s"] <= 2 * FAIL_TIMEOUT_S, i0["waited_s"]


def test_ranks_load_no_jax(ranks):
    _computed(ranks)
    for info in ranks[3]:
        assert not info["jax_loaded"] and not info["jax_package_loaded"]
