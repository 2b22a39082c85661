"""The port's secondary spectrum and chunk conjugate spectra
(scintools_tpu_torch/ops) against the JAX package on the CPU.

Powers are compared in linear units relative to the peak, never in dB
(dB blows up at near-cancelled bins). The port works in float32 /
complex64; the JAX side runs in float64 under the test configuration,
so the gates allow float32 FFT rounding: 1e-5 of the peak for power,
and 1e-5 of the largest magnitude for complex spectra.
"""

import numpy as np
import pytest
import torch

from scintools_tpu.ops import sspec as jsspec
from scintools_tpu.ops import windows as jwin
from scintools_tpu_torch.ops import sspec as tsspec
from scintools_tpu_torch.ops import windows as twin
from scintools_tpu_torch.ops import xfft as txfft


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dyn(nf=60, nt=44, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(nf, nt)) ** 2 + 0.1


def _close_to_peak(ours, ref, tol=1e-5):
    ours = np.asarray(ours, dtype=float)
    ref = np.asarray(ref, dtype=float)
    assert ours.shape == ref.shape
    peak = np.abs(ref).max()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * peak)


def test_windows_are_exact_copies():
    for name in ("hanning", "hamming", "blackman", "bartlett"):
        for a, b in zip(twin.get_window(44, 60, window=name, frac=0.2),
                        jwin.get_window(44, 60, window=name, frac=0.2)):
            np.testing.assert_array_equal(a, b)


def test_axes_and_shapes_match():
    assert tsspec.fft_shapes(60, 44) == jsspec.fft_shapes(60, 44)
    for halve in (True, False):
        ours = tsspec.sspec_axes(60, 44, 2.0, 0.05, halve=halve, dlam=0.1)
        ref = jsspec.sspec_axes(60, 44, 2.0, 0.05, halve=halve, dlam=0.1)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant", ["half", "dense"])
@pytest.mark.parametrize("prewhite", [False, True])
def test_secondary_spectrum_power(variant, prewhite):
    dyn = _dyn()
    wins = jwin.get_window(dyn.shape[1], dyn.shape[0])
    ref = np.asarray(jsspec.secondary_spectrum_power(
        dyn, window_arrays=wins, prewhite=prewhite, backend="jax",
        variant=variant))
    ours = tsspec.secondary_spectrum_power(
        torch.tensor(dyn, dtype=torch.float32), window_arrays=wins,
        prewhite=prewhite, variant=variant).numpy()
    if prewhite:
        # post-darkening divides by sin²·sin² down to ~1e-7, which
        # amplifies float32 rounding without bound near the axes:
        # compare the power before that division
        nr, nc = jsspec.fft_shapes(*dyn.shape)
        dark = np.outer(np.sin(np.pi / nr * np.arange(nr // 2)) ** 2,
                        np.sin(np.pi / nc * np.arange(-nc // 2, nc // 2))
                        ** 2)
        dark[:, nc // 2] = 1
        dark[0, :] = 1
        ours, ref = ours * dark, ref * dark
    _close_to_peak(ours, ref)


def test_full_frame_power():
    dyn = _dyn(nf=33, nt=20)
    ref = np.asarray(jsspec.secondary_spectrum_power(
        dyn, halve=False, backend="jax", variant="dense"))
    ours = tsspec.secondary_spectrum_power(
        torch.tensor(dyn, dtype=torch.float32), halve=False)
    _close_to_peak(ours.numpy(), ref)


def test_secondary_spectrum_db_pipeline():
    dyn = _dyn()
    fd_j, td_j, sec_j = jsspec.secondary_spectrum(dyn, 2.0, 0.05,
                                                  backend="jax")
    fd_t, td_t, sec_t = tsspec.secondary_spectrum(dyn, 2.0, 0.05,
                                                  device="cpu")
    np.testing.assert_array_equal(fd_t, fd_j)
    np.testing.assert_array_equal(td_t, td_j)
    _close_to_peak(10 ** (sec_t.numpy() / 10), 10 ** (np.asarray(sec_j) / 10))


@pytest.mark.parametrize("method", ["rfft", "fft2"])
@pytest.mark.parametrize("tau_mask", [False, True])
def test_chunk_conjugate_spectrum_batch(method, tau_mask):
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    chunks = (rng.normal(size=(3, 16, 12)) ** 2).astype(np.float32)
    npad = 1
    keep = None
    if tau_mask:
        keep = np.ones(32, dtype=bool)
        keep[14:18] = False
    ref = np.asarray(jsspec.chunk_conjugate_spectrum_batch(
        jnp.asarray(chunks), npad=npad, tau_keep=keep, xp=jnp,
        method=method))
    ours = tsspec.chunk_conjugate_spectrum_batch(
        torch.from_numpy(chunks), npad=npad, tau_keep=keep,
        method=method).numpy()
    assert ours.shape == ref.shape == (3, 32, 24)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * scale)
    if tau_mask:
        assert np.all(ours[:, 14:18] == 0)


def test_pad_chunk_batch_matches():
    chunks = np.random.default_rng(2).normal(size=(2, 8, 6))
    ref = jsspec.pad_chunk_batch(chunks, 2)
    ours = tsspec.pad_chunk_batch(torch.from_numpy(chunks), 2).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n2", [12, 13])
def test_hermitian_completion_is_fft2(n2):
    x = torch.from_numpy(np.random.default_rng(n2).normal(size=(2, 9, n2)))
    full = txfft.fft2_full(x, variant="rfft")
    np.testing.assert_allclose(full.numpy(), torch.fft.fft2(x).numpy(),
                               rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        txfft.fft2_full(x, variant="zoom")
