"""The port's single-host device mesh against its unsharded paths and the
JAX package's sharded ones.

Each test of ``tests/test_parallel.py`` has its counterpart here (all but
``test_graft_entry_jits``, ``test_dryrun_multichip`` and
``TestShardedEnsemble``: the port has no sharded sampler). The port's
mesh is 8 virtual CPU shards (``make_mesh(8, devices=["cpu"] * 8)``),
the JAX package's the 8 virtual CPU devices of ``tests/conftest.py``;
both lay them out as 4 data × 2 seq. Each sharded port path is held to
the port's unsharded path at the JAX test's tolerance (or bitwise where
the split cannot change a bit), and to the JAX sharded path at the
tolerance of that function's existing parity test.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_thth import ETA_TRUE, make_arc_dspec, make_arc_edges  # noqa: E402

from scintools_tpu import parallel as jpar  # noqa: E402
from scintools_tpu.ops.windows import get_window  # noqa: E402
from scintools_tpu_torch import parallel as par  # noqa: E402
from scintools_tpu_torch.backend import KernelError  # noqa: E402
from scintools_tpu_torch.ops.sspec import (fft_shapes,  # noqa: E402
                                           secondary_spectrum_power)
from scintools_tpu_torch.thth import retrieval as tret  # noqa: E402

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this file's torch work on one CPU thread. The warm-start
    eigensolver's plain version is a Python loop of small operations,
    and on a host loaded by other processes torch's intra-op pool makes
    each of them wait for every thread: the mesh façade fit took
    hundreds of seconds in a parallel test run against about one
    alone. The thread count is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return par.make_mesh(8, devices=CPU8)


@pytest.fixture(scope="module")
def jmesh():
    assert jax.device_count() >= 8, "conftest should provide 8 devices"
    return jpar.make_mesh(8)


def _corr(a, b):
    """Phase-aligned correlation of two complex arrays."""
    return np.abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b)
                                    + 1e-30)


def _sspec(dyns, **kw):
    return secondary_spectrum_power(torch.as_tensor(dyns), **kw).numpy()


# ---------------------------------------------------------------------
# mesh and placement
# ---------------------------------------------------------------------

def test_mesh_shape(mesh, jmesh):
    assert mesh.shape[par.DATA_AXIS] * mesh.shape[par.SEQ_AXIS] == 8
    assert mesh.shape[par.SEQ_AXIS] == 2
    assert dict(mesh.shape) == dict(jmesh.shape)
    assert mesh.axis_names == tuple(jmesh.axis_names)
    assert mesh.devices.shape == np.asarray(jmesh.devices).shape
    assert all(d == torch.device("cpu") for d in mesh.devices.ravel())
    assert int(np.prod(list(mesh.shape.values()))) == mesh.size == 8


@pytest.mark.parametrize("n, seq", [(1, None), (2, None), (4, None),
                                    (8, None), (8, 8), (4, 1)])
def test_make_mesh_seq_rule(n, seq):
    got = par.make_mesh(n, seq=seq, devices=["cpu"] * n)
    assert dict(got.shape) == dict(jpar.make_mesh(n, seq=seq).shape)


def test_make_mesh_refusals():
    for make in (lambda: par.make_mesh(8, seq=3, devices=CPU8),
                 lambda: jpar.make_mesh(8, seq=3)):
        with pytest.raises(ValueError, match="does not divide"):
            make()
    with pytest.raises(ValueError):
        par.make_mesh(9, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(KernelError):
            par.make_mesh()
    assert par.device_count() == torch.cuda.device_count()


def test_shard_gather_round_trip(mesh):
    x = torch.arange(8 * 4 * 6, dtype=torch.float64).reshape(8, 4, 6)
    for sh, n_first in ((par.data_sharding(mesh), 1),
                        (par.batch_freq_sharding(mesh), 2),
                        (par.replicated(mesh), 8)):
        parts = par.shard(x, sh)
        assert len(parts) == 8 and parts[0].shape[0] == n_first
        torch.testing.assert_close(par.gather(parts), x, rtol=0, atol=0)
    assert len(par.chunk_shardings(mesh, (3, 2, 2))) == 3
    with pytest.raises(ValueError):
        par.shard(x[:5], par.data_sharding(mesh))


# ---------------------------------------------------------------------
# distributed FFT and spectra
# ---------------------------------------------------------------------

@pytest.mark.parametrize("inverse, shape", [(False, (4, 16, 8)),
                                            (True, (4, 8, 16))])
def test_fft2_sharded_matches_dense(mesh, jmesh, rng, inverse, shape):
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    got = par.make_fft2_sharded(mesh, inverse=inverse)(
        torch.as_tensor(x)).numpy()
    want = (np.fft.ifft2 if inverse else np.fft.fft2)(x, axes=(1, 2))
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-12 if inverse else 1e-9)
    jgot = np.asarray(jax.jit(jpar.make_fft2_sharded(
        jmesh, inverse=inverse))(jnp.asarray(x)))
    np.testing.assert_allclose(got, jgot, rtol=1e-10, atol=1e-12)


def test_sspec_sharded_matches_single(mesh, jmesh, rng):
    B, nf, nt = 4, 24, 12
    dyns = rng.normal(size=(B, nf, nt))
    wins = get_window(nt, nf, window="hanning", frac=0.1)
    got = par.make_sspec_power_sharded(mesh, nf, nt, window_arrays=wins)(
        torch.as_tensor(dyns)).numpy()
    want = _sspec(dyns, window_arrays=wins)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    jgot = np.asarray(jax.jit(jpar.make_sspec_power_sharded(
        jmesh, nf, nt, window_arrays=wins))(jnp.asarray(dyns)))
    np.testing.assert_allclose(got, jgot, rtol=0,
                               atol=1e-5 * np.abs(jgot).max())


def test_sspec_sharded_half_matches_dense(mesh, rng):
    B, nf, nt = 4, 24, 12
    dyns = rng.normal(size=(B, nf, nt))
    wins = get_window(nt, nf, window="hanning", frac=0.1)
    half, dense = (par.make_sspec_power_sharded(
        mesh, nf, nt, window_arrays=wins, variant=v)(
            torch.as_tensor(dyns)).numpy() for v in ("half", "dense"))
    nrfft, ncfft = fft_shapes(nf, nt)
    assert half.shape == dense.shape == (B, nrfft // 2, ncfft)
    scale = np.abs(dense).max()
    np.testing.assert_allclose(half, dense, rtol=1e-5, atol=1e-7 * scale)
    want = _sspec(dyns, window_arrays=wins, variant="half")
    np.testing.assert_allclose(half, want, rtol=1e-5, atol=1e-7 * scale)


def test_sspec_sharded_full_frame_keeps_dense(mesh, rng):
    B, nf, nt = 4, 8, 8
    dyns = rng.normal(size=(B, nf, nt))
    got = par.make_sspec_power_sharded(mesh, nf, nt, halve=False,
                                       variant="half")(
        torch.as_tensor(dyns)).numpy()
    want = _sspec(dyns, halve=False)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("variant", ["czt", "dense"])
def test_sspec_sharded_zoom_matches_single(mesh, jmesh, rng, variant):
    B, nf, nt = 4, 24, 12
    dyns = rng.normal(size=(B, nf, nt))
    wins = get_window(nt, nf, window="hanning", frac=0.1)
    band = ((0.0, 8.0, 16), (-4.0, 4.0, 10))
    got = par.make_sspec_power_sharded(mesh, nf, nt, window_arrays=wins,
                                       variant=variant, zoom=band)(
        torch.as_tensor(dyns)).numpy()
    assert got.shape == (B, 16, 10)
    want = _sspec(dyns, window_arrays=wins, zoom=band, variant=variant)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-7 * np.abs(want).max())
    jgot = np.asarray(jax.jit(jpar.make_sspec_power_sharded(
        jmesh, nf, nt, window_arrays=wins, variant=variant, zoom=band))(
        jnp.asarray(dyns)))
    np.testing.assert_allclose(got, jgot, rtol=1e-5,
                               atol=1e-7 * np.abs(jgot).max())


def test_sspec_sharded_zoom_rejects_indivisible_rows(mesh, jmesh):
    for m, mod in ((mesh, par), (jmesh, jpar)):
        with pytest.raises(ValueError, match="zoom row"):
            mod.make_sspec_power_sharded(
                m, 24, 12, zoom=((0.0, 8.0, 15), (-4.0, 4.0, 10)))


def test_eta_search_sharded_matches_batch(mesh, jmesh, rng):
    from scintools_tpu.thth.core import cs_to_ri as jcs_to_ri
    from scintools_tpu_torch.thth.core import cs_to_ri, make_eval_fn
    from scintools_tpu_torch.thth.search import chunk_geometry

    nf, nt, npad = 32, 16, 1
    _, _, tau, fd, edges = chunk_geometry(nf=nf, nt=nt, npad=npad,
                                          n_edges=16)
    dyn = rng.normal(size=(nf, nt))
    CS = np.fft.fftshift(np.fft.fft2(
        np.pad(dyn, ((0, npad * nf), (0, npad * nt)))))
    etas = np.linspace(5e-4, 4e-3, 16)
    cs_ri = torch.as_tensor(cs_to_ri(CS), dtype=torch.float32)
    got = par.make_eta_search_sharded(mesh, tau, fd, edges, iters=200)(
        cs_ri, etas).numpy()
    want = make_eval_fn(tau, fd, edges, iters=200, device="cpu")(
        cs_ri, etas).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    jgot = np.asarray(jpar.make_eta_search_sharded(
        jmesh, tau, fd, edges, iters=200)(jnp.asarray(jcs_to_ri(CS)),
                                          jnp.asarray(etas)))
    np.testing.assert_allclose(got, jgot, rtol=1e-4)


def test_survey_step_fits_match_host_leastsq(mesh):
    """The sharded survey step's batched LM reproduces the host scipy
    least squares within the fit's own stderr (or 5%), as the JAX test
    holds the JAX step; its power is the unsharded spectrum's and its
    cuts the unsharded ACF's."""
    from scintools_tpu_torch.fit import Parameters, minimize_leastsq, models
    from scintools_tpu_torch.fit.batch import (acf_cuts_batch,
                                               bartlett_weights,
                                               initial_guesses_batch)
    from scintools_tpu_torch.sim.simulation import simulate_dynspec_batch

    nf, nt = 32, 16
    dt, df, alpha = 2.0, 0.05, 5 / 3
    B = mesh.shape[par.DATA_AXIS] * 2
    dyns = np.transpose(simulate_dynspec_batch(B, ns=nt, nf=nf, seed=7,
                                               device="cpu").numpy(),
                        (0, 2, 1)).astype(np.float32)
    step = par.make_survey_step(mesh, nf, nt, dt=dt, df=df, alpha=alpha)
    params, chisq, power, tcut, fcut = step(dyns)
    assert np.all(np.isfinite(chisq.numpy()))
    nrfft, ncfft = fft_shapes(nf, nt)
    assert power.shape == (B, nrfft // 2, ncfft)
    wins = get_window(nt, nf, window="hanning", frac=0.1)
    want = _sspec(dyns, window_arrays=wins)
    np.testing.assert_allclose(power.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    tcuts, fcuts = (c.numpy().astype(float)
                    for c in acf_cuts_batch(dyns, device="cpu"))
    np.testing.assert_allclose(tcut.numpy(), tcuts, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(fcut.numpy(), fcuts, rtol=2e-4, atol=2e-4)
    tau0s, dnu0s, amp0s, _ = (np.asarray(v) for v in initial_guesses_batch(
        torch.as_tensor(tcuts), torch.as_tensor(fcuts), dt, df, nt * dt,
        nf * df))
    for b in range(B):
        yt, yf = tcuts[b], fcuts[b]
        p = Parameters()
        p.add("tau", value=float(tau0s[b]), vary=True, min=0, max=np.inf)
        p.add("dnu", value=float(dnu0s[b]), vary=True, min=0, max=np.inf)
        p.add("amp", value=float(amp0s[b]), vary=True, min=0, max=np.inf)
        p.add("alpha", value=alpha, vary=False)
        res = minimize_leastsq(
            models.scint_acf_model, p,
            args=((dt * np.arange(nt), df * np.arange(nf)), (yt, yf),
                  tuple(bartlett_weights(torch.as_tensor(y), n).numpy()
                        for y, n in ((yt, nt), (yf, nf)))))
        for name in ("tau", "dnu", "amp"):
            got = float(params[name][b])
            want = res.params[name].value
            err = res.params[name].stderr or 0.0
            assert abs(got - want) <= max(err, 0.05 * abs(want), 1e-8), (
                b, name, got, want, err)


# ---------------------------------------------------------------------
# θ-θ grids and the façade's fit
# ---------------------------------------------------------------------

def _grid_geometry(rng, B=8, nf=32, nt=32):
    from scintools_tpu_torch.thth.core import cs_to_ri, fft_axis

    npad = 1
    fd = fft_axis(np.arange(nt) * 2.0, pad=npad, scale=1e3)
    tau = fft_axis(1400.0 + np.arange(nf) * 0.05, pad=npad, scale=1.0)
    cs = []
    for _ in range(B):
        d = rng.normal(size=(nf, nt)) ** 2
        CS = np.fft.fftshift(np.fft.fft2(
            np.pad(d, ((0, npad * nf), (0, npad * nt)),
                   constant_values=d.mean())))
        cs.append(cs_to_ri(CS).astype(np.float32))
    eta_c = tau.max() / (fd.max() / 4) ** 2
    etas = np.linspace(0.5 * eta_c, 2.0 * eta_c, 10)
    edges = np.linspace(-fd.max() / 2, fd.max() / 2, 16)
    return np.stack(cs), tau, fd, etas, edges


class TestShardedThthGrid:
    def test_grid_matches_unsharded(self, mesh, jmesh):
        from scintools_tpu_torch.thth.batch import make_grid_eval_fn

        cs_b, tau, fd, etas, edges = _grid_geometry(
            np.random.default_rng(17))
        B = len(cs_b)
        args = (torch.as_tensor(cs_b), np.tile(edges, (B, 1)),
                np.tile(etas, (B, 1)))
        got = par.make_thth_grid_search_sharded(
            mesh, tau, fd, len(edges), iters=300)(*args).numpy()
        plain = make_grid_eval_fn(tau, fd, len(edges), iters=300,
                                  device="cpu")(*args).numpy()
        np.testing.assert_allclose(got, plain, rtol=1e-4)
        assert got.shape == (B, len(etas))
        jgot = np.asarray(jpar.make_thth_grid_search_sharded(
            jmesh, tau, fd, len(edges), iters=300)(
                jnp.asarray(cs_b), jnp.asarray(args[1]),
                jnp.asarray(args[2])))
        np.testing.assert_allclose(got, jgot, rtol=1e-4)

    def test_warm_start_grid_is_the_per_row_search(self, mesh):
        """``method="auto"`` (the façade's mesh route) gives every chunk
        the warm-start curve of the per-row search on the same chunks."""
        from scintools_tpu_torch.thth.batch import make_multi_eval_fn

        cs_b, tau, fd, etas, edges = _grid_geometry(
            np.random.default_rng(19))
        B = len(cs_b)
        got = par.make_thth_grid_search_sharded(
            mesh, tau, fd, len(edges), method="auto")(
                torch.as_tensor(cs_b), np.tile(edges, (B, 1)),
                np.tile(etas, (B, 1))).numpy()
        want = make_multi_eval_fn(tau, fd, edges, device="cpu")(
            torch.as_tensor(cs_b), etas).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)


class TestShardedThinGrid:
    def test_thin_grid_matches_static_geometry_eval(self, mesh, jmesh):
        from scintools_tpu_torch.thth.batch import make_thin_eval_fn

        cs_b, tau, fd, etas, edges = _grid_geometry(
            np.random.default_rng(23))
        B = len(cs_b)
        arclet = edges[np.abs(edges) < 0.5 * np.abs(edges).max()]
        cut = float(edges[1] - edges[0])
        args = (cs_b, np.tile(edges, (B, 1)), np.tile(arclet, (B, 1)),
                np.tile(etas, (B, 1)))
        got = par.make_thth_thin_grid_search_sharded(
            mesh, tau, fd, len(edges), len(arclet), cut, iters=300)(
                torch.as_tensor(args[0]), *args[1:]).numpy()
        plain = make_thin_eval_fn(tau, fd, edges, arclet, cut, iters=300,
                                  device="cpu")(torch.as_tensor(cs_b),
                                                etas).numpy()
        assert got.shape == (B, len(etas))
        np.testing.assert_allclose(got, plain, rtol=2e-3)
        jgot = np.asarray(jpar.make_thth_thin_grid_search_sharded(
            jmesh, tau, fd, len(edges), len(arclet), cut, iters=300)(
                *map(jnp.asarray, args)))
        np.testing.assert_allclose(got, jgot, rtol=1e-4)

    def test_arclet_padding_is_inert(self, mesh):
        from scintools_tpu_torch.thth.batch import make_thin_eval_fn

        cs_b, tau, fd, etas, edges = _grid_geometry(
            np.random.default_rng(29))
        B = len(cs_b)
        arclet = edges[np.abs(edges) < 0.35 * np.abs(edges).max()]
        cut = float(edges[1] - edges[0])
        n_pad = len(arclet) + 3
        big = 1e6 * np.abs(edges).max()
        padded = np.concatenate([arclet, big * (1 + np.arange(
            n_pad - len(arclet)))])
        got = par.make_thth_thin_grid_search_sharded(
            mesh, tau, fd, len(edges), n_pad, cut, iters=300)(
                torch.as_tensor(cs_b), np.tile(edges, (B, 1)),
                np.tile(padded, (B, 1)), np.tile(etas, (B, 1))).numpy()
        exact = make_thin_eval_fn(tau, fd, edges, arclet, cut, iters=300,
                                  device="cpu")(torch.as_tensor(cs_b),
                                                etas).numpy()
        np.testing.assert_allclose(got, exact, rtol=2e-3)


def _arc_facade_dyn(seed=5, nf=64, nt=64, cw=32):
    """tests/test_parallel.py's thin-screen arc: chunks of ``cw`` that
    all fit, with its η_true."""
    from scintools_tpu_torch.thth.core import fft_axis

    rng = np.random.default_rng(seed)
    npad, dt, df, f0 = 1, 2.0, 0.05, 1400.0
    fd = fft_axis(np.arange(cw) * dt, pad=npad, scale=1e3)
    tau = fft_axis(f0 + np.arange(cw) * df, pad=npad, scale=1.0)
    eta_true = tau.max() / (fd.max() / 3) ** 2
    nim = 12
    fd_k = np.concatenate([[0.0], rng.uniform(-fd.max() / 3, fd.max() / 3,
                                              nim)])
    amp = np.concatenate([[1.0], 0.3 * rng.uniform(0.3, 1, nim)
                          * np.exp(1j * rng.uniform(0, 2 * np.pi, nim))])
    E = (amp[None, :] * np.exp(2j * np.pi * np.outer(
        np.arange(nf) * df, eta_true * fd_k ** 2))) @ np.exp(
        2j * np.pi * 1e-3 * np.outer(fd_k, np.arange(nt) * dt))
    return np.abs(E) ** 2, np.arange(nt) * dt, f0 + np.arange(nf) * df, \
        eta_true


@pytest.fixture(scope="module")
def arc_facade():
    return _arc_facade_dyn()


def _facades(arc_facade, proc):
    from scintools_tpu import dynspec as jdyn
    from scintools_tpu_torch import dynspec as tdyn

    dyn, times, freqs, eta_true = arc_facade
    prep = dict(cwf=32, cwt=32, npad=1, fw=0.3, eta_min=0.5 * eta_true,
                eta_max=2.0 * eta_true, neta=40, nedge=24,
                fitting_proc=proc)

    def make_t():
        ds = tdyn.Dynspec(dyn=tdyn.BasicDyn(dyn.copy(), times=times,
                                            freqs=freqs),
                          process=False, verbose=False, device="cpu")
        ds.prep_thetatheta(**prep)
        return ds

    def make_j():
        ds = jdyn.Dynspec(dyn=jdyn.BasicDyn(dyn.copy(), name="thin",
                                            times=times, freqs=freqs,
                                            dt=2.0, df=0.05),
                          process=False, verbose=False, backend="jax")
        ds.prep_thetatheta(**prep)
        return ds

    return make_t, make_j


class TestShardedFacadeFit:
    def test_dynspec_thin_mesh_matches_unsharded(self, mesh, jmesh,
                                                 arc_facade):
        """fit_thetatheta(mesh=...) with the thin proc against the
        port's per-row thin search (1e-3, the JAX test's) and the JAX
        package's sharded façade (1e-3, the thin façade's parity)."""
        make_t, make_j = _facades(arc_facade, "thin")
        ds_mesh, ds_plain, dj = make_t(), make_t(), make_j()
        ds_mesh.fit_thetatheta(mesh=mesh)
        ds_plain.fit_thetatheta()
        dj.fit_thetatheta(mesh=jmesh)
        assert ds_mesh.eta_evo.shape == ds_plain.eta_evo.shape == (2, 2)
        both = np.isfinite(ds_mesh.eta_evo) & np.isfinite(ds_plain.eta_evo)
        assert both.sum() == 4, "arc chunks should all fit"
        np.testing.assert_allclose(ds_mesh.eta_evo, ds_plain.eta_evo,
                                   rtol=1e-3)
        np.testing.assert_allclose(ds_mesh.eta_evo, dj.eta_evo, rtol=1e-3)
        np.testing.assert_array_equal(ds_mesh.f0s, ds_plain.f0s)
        np.testing.assert_array_equal(ds_mesh.t0s, ds_plain.t0s)

    @pytest.mark.parametrize("proc", ["standard", "incoherent"])
    def test_dynspec_mesh_is_the_per_row_fit(self, mesh, arc_facade, proc):
        """The single-curvature procs: every chunk's η, σ and health of
        the fused grid on the mesh equal the per-row fused search's
        (the same warm-start curve; on the CPU its plain version, whose
        batched products round alike up to 1e-5)."""
        make_t, _ = _facades(arc_facade, proc)
        ds_mesh, ds_plain = make_t(), make_t()
        ds_mesh.fit_thetatheta(mesh=mesh)
        ds_plain.fit_thetatheta()
        assert np.isfinite(ds_plain.eta_evo).all()
        np.testing.assert_allclose(ds_mesh.eta_evo, ds_plain.eta_evo,
                                   rtol=1e-5)
        np.testing.assert_allclose(ds_mesh.eta_evo_err,
                                   ds_plain.eta_evo_err, rtol=1e-4)
        np.testing.assert_array_equal(ds_mesh.eta_evo_ok,
                                      ds_plain.eta_evo_ok)
        np.testing.assert_allclose(ds_mesh.ththeta, ds_plain.ththeta,
                                   rtol=1e-5)


# ---------------------------------------------------------------------
# retrieval and Gerchberg–Saxton
# ---------------------------------------------------------------------

def _arc_chunks(B, seed):
    dspec0, times, freqs = make_arc_dspec(nt=32, nf=32, npix=6)
    rng = np.random.default_rng(seed)
    chunks = np.stack([dspec0 + 1e-9 * i * rng.standard_normal(
        dspec0.shape) for i in range(B)])
    return chunks, make_arc_edges(nt=32, half=6), times[1] - times[0], \
        freqs[1] - freqs[0]


class TestShardedRetrieval:
    def test_retrieval_batch_mesh_matches_plain(self, mesh, jmesh):
        """B = 5 chunks over 8 shards (three shards idle)."""
        from scintools_tpu.thth.retrieval import \
            chunk_retrieval_batch as jchunk

        chunks, edges, dt, df = _arc_chunks(5, 23)
        plain = tret.chunk_retrieval_batch(chunks, edges, ETA_TRUE, dt, df,
                                           npad=1, device="cpu")
        assert np.linalg.norm(plain[0]) > 0
        shard = tret.chunk_retrieval_batch(chunks, edges, ETA_TRUE, dt, df,
                                           npad=1, mesh=mesh)
        jshard = jchunk(chunks, edges, ETA_TRUE, dt, df, npad=1,
                        mesh=jmesh)
        assert shard.shape == (5,) + chunks.shape[1:]
        for b in range(5):
            assert _corr(shard[b], plain[b]) > 1 - 1e-6, b
            assert _corr(shard[b], jshard[b]) > 0.999, b

    def test_dynspec_wavefield_mesh(self, mesh):
        """calc_wavefield(mesh=...) equals the unsharded grid, and its GS
        on a data-axis-1 mesh (``gs_mesh``) the single-device GS."""
        from scintools_tpu_torch.dynspec import BasicDyn, Dynspec

        rng = np.random.default_rng(3)
        nf = nt = 32
        dyn2 = rng.normal(size=(nf, nt)).astype(np.float32) ** 2
        bd = BasicDyn(dyn2, times=np.arange(nt) * 2.0,
                      freqs=1400.0 + np.arange(nf) * 0.05)

        def make():
            ds = Dynspec(dyn=bd, process=False, verbose=False, device="cpu")
            ds.prep_thetatheta(cwf=16, cwt=16, npad=1, eta_min=5e-4,
                               eta_max=4e-3, neta=8, nedge=16)
            return ds

        ds, ref = make(), make()
        ds.calc_wavefield(mesh=mesh)
        ref.calc_wavefield()
        assert ds.wavefield.shape[0] > 0
        assert np.isfinite(ds.wavefield).all()
        np.testing.assert_array_equal(ds.eta_evo, ref.eta_evo)
        np.testing.assert_allclose(ds.chunks, ref.chunks, rtol=0,
                                   atol=1e-5 * np.abs(ref.chunks).max())
        wf_before = np.array(ds.wavefield)
        del ds.wavefield
        ds.calc_wavefield(mesh=mesh, gs=True, niter=2,
                          gs_mesh=par.make_mesh(2, seq=2,
                                                devices=["cpu"] * 2))
        want = tret.gerchberg_saxton(wf_before, ds.dyn,
                                     freqs=ds.freqs[: wf_before.shape[0]],
                                     niter=2, device="cpu")
        np.testing.assert_allclose(ds.wavefield, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())

    def test_grid_retrieval_matches_per_row(self, mesh):
        chunks0, edges, dt, df = _arc_chunks(1, 29)
        rng = np.random.default_rng(29)
        rows, B = 2, 3
        all_chunks, edges_per, etas_per, per_row = [], [], [], []
        for r in range(rows):
            eta_r = ETA_TRUE * (1 + 0.1 * r)
            edges_r = edges * (1 + 0.05 * r)
            row = np.stack([chunks0[0] + 1e-9 * (r * B + i)
                            * rng.standard_normal(chunks0[0].shape)
                            for i in range(B)])
            per_row.append(tret.chunk_retrieval_batch(
                row, edges_r, eta_r, dt, df, npad=1, device="cpu"))
            all_chunks.append(row)
            edges_per.extend([edges_r] * B)
            etas_per.extend([eta_r] * B)
        expect = np.concatenate(per_row)
        flat = np.concatenate(all_chunks)
        for m in (None, mesh):
            got = tret.grid_retrieval_batch(
                flat, np.stack(edges_per), np.asarray(etas_per), dt, df,
                npad=1, mesh=m, device=None if m else "cpu")
            assert got.shape == expect.shape
            for b in range(len(expect)):
                assert _corr(got[b], expect[b]) > 1 - 1e-6, (m, b)

    def test_retrieve_wavefield_mesh_keeps_whole_chains(self, mesh):
        """The kernel route (its plain version here) on the mesh: whole
        chains per shard, so every chunk and the stitched wavefield are
        the unsharded ones (up to the last bits of products of another
        batch size)."""
        from scintools_tpu_torch.parallel.survey import \
            make_retrieval_sharded

        chunks, edges, dt, df = _arc_chunks(9, 31)
        B = len(chunks)
        args = (torch.as_tensor(chunks, dtype=torch.float32),
                torch.as_tensor(np.tile(edges, (B, 1))),
                torch.full((B,), ETA_TRUE, dtype=torch.float64))
        fn = make_retrieval_sharded(mesh, 32, 32, dt, df, len(edges),
                                    npad=1)
        E, ok = fn(*args, group=3)
        E0, ok0 = tret.grid_retrieval_batch(
            chunks, np.tile(edges, (B, 1)), np.full(B, ETA_TRUE), dt, df,
            npad=1, method="kernel", group=3, with_ok=True, device="cpu")
        np.testing.assert_array_equal(ok.numpy(), ok0)
        for b in range(B):
            assert _corr(E[b].numpy(), E0[b]) > 1 - 1e-6, b
        with pytest.raises(ValueError, match="group"):
            fn(*args, group=4)
        wf, _ = tret.campaign_retrieval_batch(
            chunks.reshape(1, 3, 3, 32, 32), edges, ETA_TRUE, dt, df,
            npad=1, mesh=mesh)
        wf0, _ = tret.campaign_retrieval_batch(
            chunks.reshape(1, 3, 3, 32, 32), edges, ETA_TRUE, dt, df,
            npad=1, device="cpu")
        I, I0 = np.abs(wf) ** 2, np.abs(wf0) ** 2
        assert np.linalg.norm(I - I0) / np.linalg.norm(I0) < 1e-5

    def test_vlbi_and_mosaic_fn(self, mesh):
        from scintools_tpu_torch.thth.retrieval import (make_mosaic_fn,
                                                        mosaic_device,
                                                        vlbi_retrieval_batch)

        chunks, edges, dt, df = _arc_chunks(5, 37)
        ds3 = np.stack([chunks, chunks * (1 + 0j), chunks], axis=1)
        got = vlbi_retrieval_batch(ds3, edges, ETA_TRUE, dt, df, 2, npad=1,
                                   mesh=mesh)
        want = vlbi_retrieval_batch(ds3, edges, ETA_TRUE, dt, df, 2, npad=1,
                                    device="cpu")
        for b in range(5):
            for d in range(2):
                assert _corr(got[b, d], want[b, d]) > 1 - 1e-6
        grid = torch.as_tensor(np.stack([chunks[:4] * (1 + 0.5j)]),
                               dtype=torch.complex64)
        np.testing.assert_array_equal(
            make_mosaic_fn(2, 2, 32, 32)(grid)[0].numpy(),
            mosaic_device(grid[0], grid_shape=(2, 2), device="cpu"))
        with pytest.raises(ValueError):
            make_mosaic_fn(3, 2, 32, 32)(grid)


class TestShardedGS:
    def test_matches_single_device_and_numpy(self):
        from scintools_tpu.thth.retrieval import gerchberg_saxton as jgs

        rng = np.random.default_rng(21)
        E = rng.standard_normal((32, 16)) + 1j * rng.standard_normal(
            (32, 16))
        dyn = rng.random((32, 16)) + 0.5
        dyn[4, 5] = np.nan
        freqs = 1400.0 + 0.05 * np.arange(32)
        m = par.make_mesh(8, seq=8, devices=CPU8)
        got = tret.gerchberg_saxton(E, dyn, freqs=freqs, niter=3, mesh=m)
        single = tret.gerchberg_saxton(E, dyn, freqs=freqs, niter=3,
                                       device="cpu")
        np.testing.assert_allclose(got, single, rtol=0,
                                   atol=1e-5 * np.abs(single).max())
        want = jgs(E, dyn, freqs=freqs, niter=3, backend="numpy")
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-3

    def test_data_axis_mesh_rejected(self, jmesh):
        rng = np.random.default_rng(3)
        E = rng.standard_normal((32, 16)) + 0j
        dyn = rng.random((32, 16)) + 0.5
        from scintools_tpu.thth.retrieval import gerchberg_saxton as jgs

        with pytest.raises(ValueError, match="data-axis-1"):
            tret.gerchberg_saxton(E, dyn, niter=1,
                                  mesh=par.make_mesh(8, devices=CPU8))
        with pytest.raises(ValueError, match="data-axis-1"):
            jgs(E, dyn, niter=1, mesh=jmesh)

    def test_indivisible_shape_rejected(self):
        from scintools_tpu.thth.retrieval import gerchberg_saxton as jgs

        rng = np.random.default_rng(4)
        E = rng.standard_normal((30, 16)) + 0j   # 30 % 8 != 0
        dyn = rng.random((30, 16)) + 0.5
        with pytest.raises(ValueError, match="divisible"):
            tret.gerchberg_saxton(E, dyn, niter=1,
                                  mesh=par.make_mesh(8, seq=8, devices=CPU8))
        with pytest.raises(ValueError, match="divisible"):
            jgs(E, dyn, niter=1, mesh=jpar.make_mesh(8, seq=8))


# ---------------------------------------------------------------------
# survey arc fit, acf2d and the scenario factory
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def arc_survey():
    from scintools_tpu_torch.workloads import make_survey_arc_problem

    return make_survey_arc_problem(B=6, device="cpu")


class TestShardedArcFit:
    def test_fit_arc_batch_mesh_is_bitwise(self, mesh, jmesh, arc_survey):
        """Epochs over the mesh: each epoch's profile and fit are the
        unsharded ones bitwise (the profile is one thread's sum per query
        in both); against the JAX sharded fit at the A2 tolerances (η
        1e-4, etaerr 1e-3)."""
        from scintools_tpu.ops.fitarc import fit_arc_batch as jfit
        from scintools_tpu_torch.ops.fitarc import fit_arc_batch

        p = arc_survey
        args = (p["sspecs"], p["tdel"], p["fdop"])
        for on_device in (True, False):
            a = fit_arc_batch(*args, numsteps=2000, on_device=on_device,
                              device="cpu")
            b = fit_arc_batch(*args, numsteps=2000, on_device=on_device,
                              mesh=mesh)
            for x, y in zip(a, b):
                assert (x.eta, x.etaerr, x.etaerr2) == (y.eta, y.etaerr,
                                                        y.etaerr2)
                np.testing.assert_array_equal(x.profile, y.profile)
        j = jfit(np.asarray(p["sspecs"]), p["tdel"], p["fdop"],
                 numsteps=2000, mesh=jmesh)
        np.testing.assert_allclose([f.eta for f in b], [f.eta for f in j],
                                   rtol=1e-4)
        np.testing.assert_allclose([f.etaerr for f in b],
                                   [f.etaerr for f in j], rtol=1e-3)

    def test_factories_match_unsharded(self, mesh, arc_survey):
        from scintools_tpu_torch.ops.fitarc_device import \
            make_arc_fit_batch_fn
        from scintools_tpu_torch.ops.normsspec import \
            make_arc_profile_batch_fn

        p = arc_survey
        s = torch.as_tensor(np.asarray(p["sspecs"]), dtype=torch.float32)
        etas = torch.full((6,), 5e-4, dtype=torch.float64)
        fn, ndev = par.make_arc_profile_sharded(mesh, p["tdel"], p["fdop"],
                                                numsteps=500)
        assert ndev == 8
        want = make_arc_profile_batch_fn(p["tdel"], p["fdop"], startbin=3,
                                         cutmid=3, numsteps=500,
                                         device="cpu")(s, etas)
        torch.testing.assert_close(fn(s, etas), want, rtol=0, atol=0)
        fn, _ = par.make_arc_fit_sharded(mesh, p["tdel"], p["fdop"],
                                         numsteps=500)
        Ls = torch.full((6,), 200, dtype=torch.int64)
        got = fn(s, etas * 0.2, Ls)
        want = make_arc_fit_batch_fn(p["tdel"], p["fdop"], numsteps=500,
                                     device="cpu")(s, etas * 0.2, Ls)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0,
                                       equal_nan=True)


def test_acf2d_fit_sharded_matches_batch(mesh):
    """Lanes of the batched acf2d LM over the mesh against the unsharded
    batch: 1e-4 (phase 10's batch-against-B = 1 gate)."""
    from scintools_tpu_torch.fit.acf2d import MODEL_ARGS, make_acf2d_fit_one
    from scintools_tpu_torch.sim.acf_model import make_acf2d_model_core

    nc, tau, dnu, dt, df = 9, 100.0, 3.0, 10.0, 0.5
    vary = ("tau", "dnu", "amp")
    lo, hi = np.full(3, 1e-3), np.full(3, 1e4)
    model = make_acf2d_model_core(nc, nc, 1.0, 5 / 3, 0.0, tau, dt,
                                  precision="highest", device="cpu")
    y0 = model(tau, dnu, 1.0, 0.0, 0.0, 0.0, dt, df).numpy()
    rng = np.random.default_rng(2)
    B = 6
    ys = y0 + 0.01 * rng.normal(size=(B, nc, nc))
    ws = np.ones((B, nc, nc))
    ws[:, nc // 2, nc // 2] = 0
    vals = dict(tau=tau, dnu=dnu, amp=1.0, phasegrad=0.0, psi=0.0, wn=0.0,
                alpha=5 / 3)
    args = [torch.as_tensor(a) for a in (
        np.tile([1.2 * tau, 0.8 * dnu, 0.9], (B, 1)), ys, ws,
        np.ones((B, nc, nc)), np.tile([vals[n] for n in MODEL_ARGS], (B, 1)),
        np.tile([dt, df], (B, 1)))]
    kw = dict(n_iter=30, precision="highest")
    fn, ndev = par.make_acf2d_fit_sharded(mesh, nc, nc, 1.0, 5 / 3, 0.0, tau,
                                          dt, vary, lo, hi, **kw)
    got = fn(*args)
    want = make_acf2d_fit_one(nc, nc, 1.0, 5 / 3, 0.0, tau, dt, vary, lo, hi,
                              device="cpu", **kw)(*args)
    assert ndev == 8 and got["niter"].shape == want["niter"].shape
    np.testing.assert_allclose(got["x"].numpy(), want["x"].numpy(),
                               rtol=1e-4)
    np.testing.assert_array_equal(got["ok"].numpy(), want["ok"].numpy())
    assert np.all(np.abs(got["x"][:, 0].numpy() / tau - 1) < 0.1)


def test_scenario_factory_sharded_is_bitwise(mesh):
    """Each lane comes from its own key, so the sharded factory makes
    exactly the unsharded factory's screens and spectra."""
    from scintools_tpu_torch.sim.factory import simulate_scenarios

    keys = np.arange(11, 21)
    mb2 = np.linspace(1.0, 4.0, 10)
    fn = par.make_scenario_factory_sharded(mesh, ns=32, nf=8, nscreens=10)
    dyn, ok = fn(keys, mb2, 1.0, 0.0, 5 / 3)
    want, ok0 = simulate_scenarios(10, mb2=mb2, ns=32, nf=8, keys=keys,
                                   with_ok=True, device="cpu")
    np.testing.assert_array_equal(dyn.numpy(), want)
    np.testing.assert_array_equal(ok.numpy(), ok0)


def test_sharded_factories_are_built_once_per_device():
    """A mesh naming one device eight times builds each path once."""
    from scintools_tpu_torch.parallel import survey as psurvey

    m = par.make_mesh(8, devices=CPU8)
    psurvey._SHARD_FNS.clear()
    cs_b, tau, fd, etas, edges = _grid_geometry(np.random.default_rng(41))
    par.make_thth_grid_search_sharded(m, tau, fd, len(edges), iters=8)(
        torch.as_tensor(cs_b), np.tile(edges, (8, 1)), np.tile(etas, (8, 1)))
    assert len(psurvey._SHARD_FNS) == 1
