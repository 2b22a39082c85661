"""Inputs made from the run's seed: synthetic dynamic spectra whose
secondary spectra carry a scintillation arc of known curvature.

The recipe is the one of the port's ``workloads.make_arc_dynspec`` (and
``bench.py:392``), copied here so that the yardstick does not move with
the program: point images at Doppler ``fD_k`` (uniform within
``±fd_max`` mHz) with delay ``τ_k = η·fD_k²`` interfere with a dominant
central image; the field is two matrix products in delay-Doppler space,
its power is the dynamic spectrum, and white noise of ``noise`` times
the spectrum's standard deviation is added. The image draws come from
numpy's generator seeded by the run's seed and a path of integers that
names the input; the noise from a ``torch.Generator`` on the device, so
a 4096² spectrum or a batch of two thousand 256² spectra is made in a
few large calls on the card.
"""

from __future__ import annotations

import numpy as np
import torch

MASK64 = (1 << 64) - 1


def seed_sequence(seed, *path):
    """The ``numpy.random.SeedSequence`` of ``seed`` (any whole number,
    negative or beyond 64 bits included) and ``path`` (small
    non-negative integers naming one input of the run)."""
    return np.random.SeedSequence([int(seed) & MASK64, *map(int, path)])


def torch_generator(ss, device):
    """A ``torch.Generator`` on ``device`` seeded from ``ss``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0]) >> 1)
    return g


def arc_dynspecs(B, nf, nt, dt, df, eta, n_images, fd_max, noise, ss,
                 device, block=256):
    """``B`` dynamic spectra ``(B, nf, nt)`` float64 on ``device``, each
    an arc of curvature ``eta`` [µs/mHz²] made of ``n_images`` point
    images, drawn from the seed sequence ``ss``; made ``block`` spectra
    at a time."""
    rng = np.random.default_rng(ss.spawn(1)[0])
    gen = torch_generator(ss.spawn(2)[1], device)
    fd_k = np.concatenate([np.zeros((B, 1)),
                           rng.uniform(-fd_max, fd_max, (B, n_images))],
                          axis=1)
    amp_k = np.concatenate(
        [np.ones((B, 1)),
         0.12 * rng.uniform(0.3, 1.0, (B, n_images))
         * np.exp(1j * rng.uniform(0, 2 * np.pi, (B, n_images)))], axis=1)
    dfreq = torch.arange(nf, dtype=torch.float64, device=device) * df
    times = torch.arange(nt, dtype=torch.float64, device=device) * dt
    out = torch.empty((B, nf, nt), dtype=torch.float64, device=device)
    for b0 in range(0, B, block):
        fd = torch.as_tensor(fd_k[b0:b0 + block], device=device)
        amp = torch.as_tensor(amp_k[b0:b0 + block], device=device)
        tau = eta * fd ** 2
        m1 = amp[:, None, :] * torch.exp(
            2j * np.pi * dfreq[None, :, None] * tau[:, None, :])
        m2 = torch.exp(2j * np.pi * 1e-3 * fd[:, :, None]
                       * times[None, None, :])
        dyn = (m1 @ m2).abs() ** 2
        std = dyn.flatten(1).std(dim=1, correction=0)
        dyn += noise * std[:, None, None] * torch.randn(
            dyn.shape, dtype=torch.float64, device=device, generator=gen)
        out[b0:b0 + block] = dyn
    return out
