"""General host helpers: the port's own copies of
``scintools_tpu/utils/misc.py`` (``is_valid``, ``svd_model`` and the
eleven helpers ``difference`` … ``slow_FT``), host numpy in float64 as
there.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np


def is_valid(array):
    """Finite-and-not-NaN boolean mask."""
    return np.isfinite(array) & ~np.isnan(array)


def svd_model(arr, nmodes=1):
    """Divide out the rank-``nmodes`` SVD model: ``(arr / |model|,
    model)``."""
    u, s, w = np.linalg.svd(arr)
    s = np.array(s)
    s[nmodes:] = 0.0
    S = np.zeros((len(u), len(w)), dtype=complex)
    S[: len(s), : len(s)] = np.diag(s)
    model = u @ S @ w
    return arr / np.abs(model), model


def difference(x):
    """Centred differences, same length as x (scint_utils.py:270-283)."""
    x = np.asarray(x, dtype=float)
    dx = np.empty_like(x)
    dx[0] = (x[1] - x[0]) / 2
    dx[-1] = (x[-1] - x[-2]) / 2
    dx[1:-1] = (x[2:] - x[:-2]) / 2
    return dx


def find_nearest(arr, val):
    """Index of the element nearest ``val`` (scint_utils.py:462-468)."""
    return int(np.argmin(np.abs(np.asarray(arr) - val)))


def longest_run_of_zeros(arr):
    """(scint_utils.py:471-477)"""
    count = max_count = 0
    for num in arr:
        count = count + 1 if num == 0 else 0
        max_count = max(max_count, count)
    return max_count


def centres_to_edges(arr):
    """Pixel centres → pixel edges, assuming even spacing
    (scint_utils.py:787-794)."""
    arr = np.asarray(arr, dtype=float)
    darr = np.abs(arr[1] - arr[0])
    edges = arr - darr / 2
    return np.append(edges, edges[-1] + darr)


def cov_to_corr(cov):
    """Covariance → correlation matrix (scint_utils.py:234-242)."""
    std = np.sqrt(np.diag(cov))
    outer_std = np.outer(std, std)
    with np.errstate(divide="ignore", invalid="ignore"):
        corr = cov / outer_std
    corr[cov == 0] = 0
    return corr


def mjd_to_year(mjd):
    """MJD → Besselian-style decimal year (scint_utils.py:453-459 role;
    Julian-epoch formula, no astropy)."""
    return 2000.0 + (np.asarray(mjd, dtype=float) - 51544.5) / 365.25


def acor(arr):
    """Characteristic (50%) autocorrelation length
    (scint_utils.py:575-597)."""
    from scipy.signal import correlate

    arr = np.asarray(arr, dtype=float) - np.mean(arr)
    ac = correlate(arr, arr, mode="full")
    ac = ac[ac.size // 2:]
    ac = ac / ac[0]
    idx = np.where(ac < 0.5)[0]
    return int(idx[0]) if len(idx) > 0 else 0


def make_pickle(obj, filepath):
    """Chunked pickle write for >2 GB objects
    (scint_utils.py:797-807)."""
    max_bytes = 2 ** 31 - 1
    bytes_out = pickle.dumps(obj)
    n_bytes = sys.getsizeof(bytes_out)
    with open(filepath, "wb") as f_out:
        for idx in range(0, n_bytes, max_bytes):
            f_out.write(bytes_out[idx:idx + max_bytes])


def load_pickle(filepath):
    """Chunked pickle read (scint_utils.py:878-889)."""
    max_bytes = 2 ** 31 - 1
    input_size = os.path.getsize(filepath)
    bytes_in = bytearray(0)
    with open(filepath, "rb") as f_in:
        for _ in range(0, input_size, max_bytes):
            bytes_in += f_in.read(max_bytes)
    return pickle.loads(bytes_in)


def search_and_replace(filename, search, replace):
    """(scint_utils.py:221-231)"""
    with open(filename, "r") as fh:
        data = fh.read()
    with open(filename, "w") as fh:
        fh.write(data.replace(search, replace))


def slow_FT(dynspec, freqs):
    """DFT along scaled t·(f/fref) paths (scint_utils.py:655-702),
    einsum-vectorised. Reference frequency is the middle of the band.

    Note: the upstream function is unrunnable as published (it passes
    ``axis=`` to np.fft.fftshift at scint_utils.py:679); this is the
    intended computation with that call corrected to ``axes=``."""
    dynspec = np.asarray(dynspec, dtype=np.float64)
    ntime = dynspec.shape[0]
    src = np.arange(ntime, dtype=np.float64)
    freqs = np.asarray(freqs, dtype=np.float64)
    fref = freqs[len(freqs) // 2]
    fscale = freqs / fref
    ft = np.fft.fftfreq(ntime, 1)
    # phase[t, k, f] = -2πi · t·(f/fref) · ft_k
    tscale = src[:, None] * fscale[None, :]
    phase = np.exp(-2j * np.pi * tscale[:, None, :]
                   * ft[None, :, None])
    SS = np.einsum("tf,tkf->kf", dynspec, phase)
    SS = np.fft.fftshift(SS, axes=0)
    SS = np.fft.fft(SS, axis=1)
    return np.fft.fftshift(SS, axes=1)
