"""Every eigensolver ``method`` of the JAX package's θ-θ entry points on
the port, against the JAX package on the CPU, and the small names that
close the port: ``ops/xfft.py``'s ``pruned_meanpad_half`` and dense
``ifft2_cropped``, and the ``backend=`` message of the four classes.

Inputs come from numpy with fixed seeds (the arc chunks of
tests/test_fused_search.py) and go to both packages. JAX ``'pallas'``
runs its kernel in interpret mode. Tolerances: rtol 1e-4 on the eigen
curves where both sides run the same float32 algorithm (``'power'``,
``'warm'``, ``'pallas'``), 1e-5 for ``'square'`` against
``batched_eig_squaring_xla`` (as tests/test_torch_eig.py holds the cold
start), η rel 1e-2 on the fused and staged searches (as
tests/test_torch_thth.py holds the fused route).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_fused_search import _arc_chunks  # noqa: E402
from test_torch_retrieval import make_arc_chunks  # noqa: E402

from scintools_tpu.ops import xfft as jxfft  # noqa: E402
from scintools_tpu.thth import batch as jbatch  # noqa: E402
from scintools_tpu.thth import core as jcore  # noqa: E402
from scintools_tpu.thth import search as jsearch  # noqa: E402
from scintools_tpu_torch import ACF, BasicDyn, Brightness, Dynspec  # noqa: E402
from scintools_tpu_torch import Simulation  # noqa: E402
from scintools_tpu_torch.ops import xfft as txfft  # noqa: E402
from scintools_tpu_torch.thth import batch as tbatch  # noqa: E402
from scintools_tpu_torch.thth import core as tcore  # noqa: E402
from scintools_tpu_torch.thth import eig as teig  # noqa: E402
from scintools_tpu_torch.thth import retrieval as tret  # noqa: E402
from scintools_tpu_torch.thth import search as tsearch  # noqa: E402

# (method, rtol on the curves, extra arguments of the JAX function)
CURVE_CASES = [("power", 1e-4, {}), ("warm", 1e-4, {}),
               ("square", 1e-5, {}), ("pallas", 1e-4, {"interpret": True})]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)       # tier-1 runs under xdist workers
    yield
    torch.set_num_threads(n)


def _spectra(nchunk=2, seed=37):
    """Conjugate spectra of arc chunks (float64 host FFT, as the staged
    search), their (real, imag) float32 batch and the geometry."""
    chunks, tlist, freqs, etas, edges, _, npad = _arc_chunks(nchunk=nchunk,
                                                            seed=seed)
    fd = jcore.fft_axis(tlist[0], pad=npad, scale=1e3)
    tau = jcore.fft_axis(freqs, pad=npad, scale=1.0)
    cs = [jsearch.chunk_conjugate_spectrum(c, t, freqs, npad=npad)[0]
          for c, t in zip(chunks, tlist)]
    batch = np.stack([jcore.cs_to_ri(c) for c in cs]).astype(np.float32)
    return cs, batch, tau, fd, etas, edges


class TestMultiEvalMethods:
    @pytest.mark.parametrize("method, rtol, jkw", CURVE_CASES)
    def test_matches_the_same_jax_method(self, method, rtol, jkw):
        import jax.numpy as jnp

        _, batch, tau, fd, etas, edges = _spectra()
        want = np.asarray(jbatch.make_multi_eval_fn(
            tau, fd, edges, method=method, **jkw)(jnp.asarray(batch),
                                                  jnp.asarray(etas)))
        fn = tbatch.make_multi_eval_fn(tau, fd, edges, method=method,
                                       device="cpu")
        got = fn(torch.from_numpy(batch), etas).numpy()
        assert got.shape == want.shape == (2, len(etas))
        np.testing.assert_allclose(got, want, rtol=rtol)

    def test_warm_at_the_fused_steps(self):
        """The fused search's 64 steps per η, against JAX's same."""
        import jax.numpy as jnp

        _, batch, tau, fd, etas, edges = _spectra(seed=5)
        want = np.asarray(jbatch.make_multi_eval_fn(
            tau, fd, edges, method="warm", warm_iters=64, iters=100)(
                jnp.asarray(batch), jnp.asarray(etas)))
        got = tbatch.make_multi_eval_fn(
            tau, fd, edges, method="warm", warm_iters=64, iters=100,
            device="cpu")(torch.from_numpy(batch), etas).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4)

    def test_pallas_is_auto_and_square_is_the_cold_start(self):
        """``"pallas"`` is the ``"auto"`` route bit for bit; ``"square"``
        exposes its stages, and ``fn.solve`` is the cold start of every
        (chunk, η) matrix of ``fn.gather``'s stack, on the CPU through
        the plain version (no launch)."""
        _, batch, tau, fd, etas, edges = _spectra()
        cs = torch.from_numpy(batch)
        auto = tbatch.make_multi_eval_fn(tau, fd, edges, device="cpu")
        pallas = tbatch.make_multi_eval_fn(tau, fd, edges, method="pallas",
                                           device="cpu")
        assert torch.equal(auto(cs, etas), pallas(cs, etas))
        sq = tbatch.make_multi_eval_fn(tau, fd, edges, method="square",
                                       device="cpu")
        a = sq.gather(cs, etas)
        assert a.shape == (2, len(etas), 2, sq.n_pad, sq.n_pad)
        before = teig.batched_eig_cold.launches
        got = sq.solve(a)
        assert teig.batched_eig_cold.launches == before
        cold = teig.batched_eig_cold_plain(a.reshape(-1, 2, sq.n_pad,
                                                     sq.n_pad), sq.n_th // 2)
        assert torch.equal(got, cold.reshape(2, -1).abs())
        assert torch.equal(sq(cs, etas), got)


class TestEvalFnMethods:
    @pytest.mark.parametrize("method, rtol, jkw", CURVE_CASES)
    def test_make_eval_fn_matches_jax(self, method, rtol, jkw):
        import jax.numpy as jnp

        cs, _, tau, fd, etas, edges = _spectra(nchunk=1, seed=7)
        ri = jcore.cs_to_ri(cs[0])
        want = np.asarray(jcore.make_eval_fn(
            tau, fd, edges, method=method, **jkw)(jnp.asarray(ri),
                                                  jnp.asarray(etas)))
        got = tcore.make_eval_fn(tau, fd, edges, method=method,
                                 device="cpu")(
            torch.as_tensor(ri, dtype=torch.float32), etas).numpy()
        np.testing.assert_allclose(got, want, rtol=rtol)

    @pytest.mark.parametrize("method, rtol", [("power", 1e-4),
                                              ("warm", 1e-4),
                                              ("square", 1e-5)])
    def test_eval_calc_batch_matches_jax(self, method, rtol):
        """The JAX package's ``eval_calc_batch`` builds its methods
        without interpret mode, so ``"pallas"`` is held through
        ``make_eval_fn`` above; the port's ``eval_calc_batch`` caches one
        function per method."""
        cs, _, tau, fd, etas, edges = _spectra(nchunk=1, seed=7)
        want = jcore.eval_calc_batch(cs[0], tau, fd, etas, edges,
                                     backend="jax", method=method)
        got = tcore.eval_calc_batch(cs[0], tau, fd, etas, edges,
                                    device="cpu", method=method)
        np.testing.assert_allclose(got, want, rtol=rtol)
        key = [k for k in tcore._EVAL_CACHE if k[4] == method]
        assert key


def _fused_inputs():
    chunks, tlist, freqs, etas, edges, eta_true, npad = _arc_chunks(
        nchunk=3, seed=19)
    fd = jcore.fft_axis(tlist[0], pad=npad, scale=1e3)
    tau = jcore.fft_axis(freqs, pad=npad, scale=1.0)
    return (chunks, tlist, freqs, etas, edges, eta_true, npad, tau, fd,
            np.stack(chunks).astype(np.float32))


class TestFusedMethods:
    @pytest.mark.parametrize("method", ["power", "warm", "square", "pallas",
                                        "auto"])
    def test_matches_the_jax_fused_program(self, method):
        """η and σ at the fused route's rel 1e-2, ``ok`` equal. On the
        CPU the JAX package resolves ``'pallas'`` and ``'auto'`` to its
        ``'warm'`` η-scan, the port to the warm-start eigensolver; the
        other methods run the same algorithm on both sides."""
        import jax.numpy as jnp

        *_, etas, edges, eta_true, npad, tau, fd, stack = _fused_inputs()
        want = [np.asarray(x) for x in jbatch.make_fused_search_fn(
            tau, fd, edges, 32, 32, npad=npad, fw=0.3, method=method)(
                jnp.asarray(stack), jnp.asarray(etas))]
        got = [x.numpy() for x in tbatch.make_fused_search_fn(
            tau, fd, edges, 32, 32, npad=npad, fw=0.3, method=method,
            device="cpu")(torch.from_numpy(stack), etas)]
        np.testing.assert_allclose(got[1], want[1], rtol=1e-2)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-2)
        np.testing.assert_array_equal(got[4], want[4])
        assert (got[4] == 0).all()
        np.testing.assert_allclose(got[1], eta_true, rtol=0.1)

    def test_warm_iters_default_follows_the_method(self):
        """``warm_iters=None``: 64 steps per η for ``"warm"`` (the JAX
        default), 24 for the warm-start eigensolver."""
        *_, etas, edges, _, npad, tau, fd, stack = _fused_inputs()
        x = torch.from_numpy(stack)
        for method, steps in (("warm", 64), ("auto", 24)):
            fn = tbatch.make_fused_search_fn(tau, fd, edges, 32, 32,
                                             npad=npad, method=method,
                                             device="cpu")
            same = tbatch.make_fused_search_fn(tau, fd, edges, 32, 32,
                                               npad=npad, method=method,
                                               warm_iters=steps,
                                               device="cpu")
            assert torch.equal(fn(x, etas)[0], same(x, etas)[0])


class TestMultiChunkSearchMethod:
    """F3: ``multi_chunk_search`` takes the JAX package's ``method``."""

    @pytest.mark.parametrize("fused", [True, False])
    def test_power_matches_jax_on_both_routes(self, fused):
        chunks, tlist, freqs, etas, edges, *_ = _fused_inputs()
        npad = 1
        want = jsearch.multi_chunk_search(chunks, freqs, tlist, etas, edges,
                                          fw=0.3, npad=npad, backend="jax",
                                          method="power", fused=fused)
        got = tsearch.multi_chunk_search(chunks, freqs, tlist, etas, edges,
                                         fw=0.3, npad=npad, method="power",
                                         fused=fused, device="cpu")
        for w, g in zip(want, got):
            assert g.ok == w.ok == 0
            assert g.eta == pytest.approx(w.eta, rel=1e-2)
            np.testing.assert_array_equal(g.etas, w.etas)

    @pytest.mark.parametrize("method", ["warm", "square"])
    def test_staged_route_takes_the_method(self, method):
        """The staged route builds its evaluator with ``method``, as the
        JAX package's (``_jitted_multi_eval``): its curves are that
        method's own at rtol 1e-4."""
        chunks, tlist, freqs, etas, edges, *_ = _fused_inputs()
        want = jsearch.multi_chunk_search(chunks, freqs, tlist, etas, edges,
                                          fw=0.3, npad=1, backend="jax",
                                          method=method, fused=False)
        got = tsearch.multi_chunk_search(chunks, freqs, tlist, etas, edges,
                                         fw=0.3, npad=1, method=method,
                                         fused=False, device="cpu")
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.eigs, w.eigs, rtol=1e-4)
            assert g.eta == pytest.approx(w.eta, rel=1e-2)

    def test_cache_keyed_on_method_and_single_chunk(self):
        """Each method builds its own fused search once; one chunk goes
        to ``single_search`` whatever the method."""
        chunks, tlist, freqs, etas, edges, *_ = _fused_inputs()
        args = (chunks, freqs, tlist, etas, edges)
        kw = dict(fw=0.3, npad=1, device="cpu")
        tsearch._FUSED_CACHE.clear()
        a = tsearch.multi_chunk_search(*args, method="power", **kw)
        b = tsearch.multi_chunk_search(*args, method="square", **kw)
        assert len(tsearch._FUSED_CACHE) == 2
        tsearch.multi_chunk_search(*args, method="square", **kw)
        assert len(tsearch._FUSED_CACHE) == 2
        assert [r.eta for r in a] != [r.eta for r in b]
        one = tsearch.multi_chunk_search(chunks[:1], freqs, tlist[:1], etas,
                                         edges, method="power", **kw)
        ref = tsearch.single_search(chunks[0], freqs, tlist[0], etas, edges,
                                    **kw)
        assert one[0].eta == ref.eta
        np.testing.assert_array_equal(one[0].eigs, ref.eigs)


def _unknown_method_calls():
    cs, batch, tau, fd, etas, edges = _spectra(nchunk=1)
    chunks, tlist, freqs, *_ = _arc_chunks(nchunk=2)
    kw = dict(method="bogus", device="cpu")
    return {
        "make_multi_eval_fn": lambda: tbatch.make_multi_eval_fn(
            tau, fd, edges, **kw),
        "make_fused_search_fn": lambda: tbatch.make_fused_search_fn(
            tau, fd, edges, 32, 32, npad=1, **kw),
        "make_eval_fn": lambda: tcore.make_eval_fn(tau, fd, edges, **kw),
        "eval_calc_batch": lambda: tcore.eval_calc_batch(
            cs[0], tau, fd, etas, edges, **kw),
        "multi_chunk_search": lambda: tsearch.multi_chunk_search(
            chunks, freqs, tlist, etas, edges, npad=1, **kw),
        "multi_chunk_search_staged": lambda: tsearch.multi_chunk_search(
            chunks, freqs, tlist, etas, edges, npad=1, fused=False, **kw),
        "multi_chunk_search_one_chunk": lambda: tsearch.multi_chunk_search(
            chunks[:1], freqs, tlist[:1], etas, edges, npad=1, **kw),
        "resolve_retrieval_method": lambda: tret.resolve_retrieval_method(
            "bogus", 22),
        "grid_retrieval_batch": lambda: tret.grid_retrieval_batch(
            np.zeros((1, 64, 64)), np.zeros((1, 22)), np.full(1, 0.3), 30.0,
            0.2, npad=1, **kw),
    }


@pytest.mark.parametrize("entry", sorted(_unknown_method_calls()))
def test_unknown_method_raises(entry):
    with pytest.raises(ValueError, match="bogus"):
        _unknown_method_calls()[entry]()


class TestRetrievalNames:
    @pytest.mark.parametrize("method", [None, "auto", "pallas", "warm"])
    def test_jax_names_are_the_kernel_route(self, method):
        assert tret.resolve_retrieval_method(method) == "kernel"
        assert tret.resolve_retrieval_method(method, 22) == "kernel"

    @pytest.mark.parametrize("method", tret.METHODS)
    def test_port_names_stay(self, method):
        assert tret.resolve_retrieval_method(method, 22) == method

    def test_grid_retrieval_is_bitwise_the_kernel_route(self):
        chunks, times, freqs, edges = make_arc_chunks(n_chunks=4)
        B = len(chunks)
        args = (chunks, np.tile(edges, (B, 1)), np.full(B, 0.3),
                times[1] - times[0], freqs[1] - freqs[0])
        want, ok = tret.grid_retrieval_batch(*args, npad=1, method="kernel",
                                             with_ok=True, device="cpu")
        assert (ok == 0).all() and np.abs(want).max() > 0
        for method in (None, "pallas", "warm"):
            got, ok_m = tret.grid_retrieval_batch(*args, npad=1,
                                                  method=method,
                                                  with_ok=True, device="cpu")
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(ok_m, ok)


class TestXfftNames:
    def test_pruned_meanpad_half_matches_jax(self):
        rng = np.random.default_rng(4)
        x = rng.normal(size=(48, 40)) + 2.5
        want = jxfft.pruned_meanpad_half(x, (96, 80))
        got = txfft.pruned_meanpad_half(torch.from_numpy(x), (96, 80))
        assert got.shape == want.shape == (96, 41)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
        pad = np.full((96, 80), x.mean())
        pad[:48, :40] = x
        np.testing.assert_allclose(got.numpy(), np.fft.rfft2(pad), rtol=0,
                                   atol=1e-12 * np.abs(want).max())

    def test_ifft2_cropped_dense_is_split(self):
        rng = np.random.default_rng(5)
        X = torch.from_numpy(rng.normal(size=(3, 32, 24))
                             + 1j * rng.normal(size=(3, 32, 24)))
        dense = txfft.ifft2_cropped(X, (9, 11), variant="dense")
        split = txfft.ifft2_cropped(X, (9, 11))
        np.testing.assert_allclose(dense.numpy(), split.numpy(), atol=1e-15)
        np.testing.assert_allclose(
            dense.numpy(), jxfft.ifft2_cropped(X.numpy(), (9, 11),
                                               variant="dense"), atol=1e-15)
        with pytest.raises(ValueError, match="variant"):
            txfft.ifft2_cropped(X, (9, 11), variant="pruned")


@pytest.mark.parametrize("make", [
    lambda: Dynspec(dyn=BasicDyn(np.ones((8, 8)), freqs=np.arange(8.0),
                                 times=np.arange(8.0)),
                    backend="jax", device="cpu"),
    lambda: Simulation(ns=16, nf=8, backend="jax", device="cpu"),
    lambda: ACF(backend="jax", device="cpu"),
    lambda: Brightness(backend="jax", device="cpu"),
], ids=["Dynspec", "Simulation", "ACF", "Brightness"])
def test_backend_message(make):
    """F4: one message for ``backend=`` on the four classes."""
    with pytest.raises(NotImplementedError,
                       match="backend= is the JAX package's; the port runs "
                             "on device="):
        make()
