"""The workloads: the north star and the survey arc fit.

Counterpart of ``bench.py:392`` ``make_arc_dynspec``, ``:418``
``make_north_star_problem`` (numpy copies) and ``:448``
``make_north_star_pipeline`` (with ``fw``): window + padded secondary
spectrum, per-chunk mean-pad + fft2 → conjugate spectra, the masked θ-θ
gather and the warm-start eigensolver over the η grid with the chunk
batch walked in groups by a Python loop, then the closed-form peak fit.
At 4096² that is an 8×8 grid of 512² chunks (CS 1024² at npad=1), 200 η
and 256 θ edges (n_th = 255 → N = 256), on an 8192² sspec frame.

``make_survey_arc_problem`` is the epoch batch of the JAX package's
survey arc-fit configuration (``bench.py:1098`` ``bench_survey_arc``):
128 epochs of 256² known-curvature dynspecs whose secondary spectra
(256 delays × 512 Dopplers) ``ops.fitarc.fit_arc_batch`` fits at
numsteps 2000.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend import as_tensor, resolve_device
from .ops.sspec import secondary_spectrum, secondary_spectrum_power
from .ops.windows import get_window
from .thth.batch import make_multi_eval_fn
from .thth.core import fft_axis
from .thth.peakfit import fit_eig_peak_batch_device


def make_arc_dynspec(nt, nf, dt, df, f0, eta_true, n_images, seed,
                     noise=0.02):
    """An (nf, nt) dynspec whose secondary spectrum carries an arc of
    known curvature ``eta_true`` [us/mHz²]: point images at Doppler fD_k
    with delay τ_k = η·fD_k² interfering with a dominant central image,
    built in delay-Doppler space as two matrix products."""
    rng = np.random.default_rng(seed)
    fd_k = np.concatenate([[0.0], rng.uniform(-80.0, 80.0, n_images)])
    tau_k = eta_true * fd_k ** 2
    amp_k = np.concatenate(
        [[1.0], 0.12 * rng.uniform(0.3, 1.0, n_images)
         * np.exp(1j * rng.uniform(0, 2 * np.pi, n_images))]
    ).astype(complex)
    dfreq = np.arange(nf) * df                  # MHz (offset from f0)
    times = np.arange(nt) * dt                  # s
    M1 = amp_k[None, :] * np.exp(2j * np.pi * np.outer(dfreq, tau_k))
    M2 = np.exp(2j * np.pi * 1e-3 * np.outer(fd_k, times))
    dyn = np.abs(M1 @ M2) ** 2
    dyn += noise * dyn.std() * rng.standard_normal(dyn.shape)
    return dyn


def make_north_star_problem(nf, nt, n_variants=2):
    """The synthetic known-curvature dynspec (plus perturbed variants so
    no two timed calls see identical buffers), chunk geometry, η grid,
    θ edges and windows."""
    dt, df, f0 = 2.0, 0.05, 1400.0
    eta_true = 5e-4                             # us/mHz²
    cf = ct = min(512, nf)
    npad = 1
    dyn0 = make_arc_dynspec(nt, nf, dt, df, f0, eta_true, n_images=96,
                            seed=21)
    rng = np.random.default_rng(7)
    dyns = [dyn0 + 1e-6 * i * rng.standard_normal(dyn0.shape)
            for i in range(n_variants)]
    times = np.arange(ct) * dt
    freqs = f0 + np.arange(cf) * df
    fd = fft_axis(times, pad=npad, scale=1e3)   # mHz
    tau = fft_axis(freqs, pad=npad, scale=1.0)  # us
    etas = np.linspace(0.5 * eta_true, 2.0 * eta_true, 200)
    th_lim = 0.95 * min(np.sqrt(tau.max() / etas.max()), fd.max() / 2)
    edges = np.linspace(-th_lim, th_lim, 256)
    wins = get_window(nt, nf, window="hanning", frac=0.1)
    return dict(dyns=dyns, cf=cf, ct=ct, npad=npad, tau=tau, fd=fd,
                etas=etas, edges=edges, wins=wins, eta_true=eta_true,
                th_lim=th_lim, dt=dt, df=df, f0=f0)


def make_north_star_pipeline(nf, nt, cf, ct, npad, wins, tau, fd, edges,
                             group, fw=None, eig="kernel", device=None):
    """``run(dyn[nf, nt], etas[neta], mark=None)`` on ``device`` →
    ``(sec, eigs[n_chunks, neta])``, plus ``peak[n_chunks, 2]`` (columns
    eta, eta_sig) when ``fw`` is set.

    The chunk batch is walked ``group`` chunks at a time. ``mark(name)``,
    when given, is called after each stage (``sspec``, then per group
    ``cs``, ``gather``, ``eig``, then ``peakfit``) so a caller can time
    the stages; ``eig='plain'`` runs the plain eigensolver instead of
    the kernel."""
    dev = resolve_device(device)
    ncf, nct = nf // cf, nt // ct
    n_chunks = ncf * nct
    if n_chunks % group:
        raise ValueError(f"group={group} must divide {n_chunks}")
    eval_fn = make_multi_eval_fn(tau, fd, edges, eig=eig, device=dev)
    support = torch.nn.functional.pad(
        torch.ones((cf, ct), dtype=torch.bool, device=dev),
        (0, npad * ct, 0, npad * cf))

    def run(d, e, mark=None):
        mark = mark or (lambda name: None)
        d = as_tensor(d, dev)
        sec = secondary_spectrum_power(d, window_arrays=wins)
        mark("sspec")
        chunks = d.reshape(ncf, cf, nct, ct).transpose(1, 2) \
            .reshape(n_chunks, cf, ct)
        eigs = []
        for g in range(0, n_chunks, group):
            c = chunks[g:g + group]
            mu = c.mean(dim=(1, 2), keepdim=True)
            padded = torch.where(
                support[None],
                torch.nn.functional.pad(c, (0, npad * ct, 0, npad * cf)),
                mu)
            CS = torch.fft.fftshift(torch.fft.fft2(padded), dim=(1, 2))
            cs_ri = torch.stack([CS.real, CS.imag], dim=1)
            del CS, padded
            mark("cs")
            a_ri = eval_fn.gather(cs_ri, e)
            del cs_ri
            mark("gather")
            eigs.append(eval_fn.solve(a_ri))
            del a_ri
            mark("eig")
        eigs = torch.cat(eigs)
        if fw is None:
            return sec, eigs
        eta, sig, _ = fit_eig_peak_batch_device(e, eigs, fw=fw)
        mark("peakfit")
        return sec, eigs, torch.stack([eta, sig], dim=1)

    run.eval_fn = eval_fn
    return run


def make_survey_arc_problem(B=128, n=256, numsteps=2000, seed0=300,
                            device=None):
    """``B`` epochs of ``n``² synthetic arc dynspecs (η_true = 5e-4
    µs/mHz², 96 images, seeds ``seed0 + b``; dt 2 s, df 0.05 MHz from
    1400 MHz) and their secondary spectra in dB, computed on ``device``
    by :func:`~.ops.sspec.secondary_spectrum` as the JAX configuration's
    ``calc_sspec`` does. Returns a dict with ``sspecs`` (a ``(B, n,
    2n)`` float32 tensor on ``device``), the axes ``tdel`` [µs] and
    ``fdop`` [mHz], ``numsteps`` and ``eta_true``."""
    dev = resolve_device(device)
    dt, df, f0, eta_true = 2.0, 0.05, 1400.0, 5e-4
    secs = []
    for b in range(B):
        dyn = make_arc_dynspec(n, n, dt, df, f0, eta_true, n_images=96,
                               seed=seed0 + b)
        fdop, tdel, sec = secondary_spectrum(dyn, dt, df, device=dev)
        secs.append(sec)
    return dict(sspecs=torch.stack(secs), tdel=tdel, fdop=fdop,
                numsteps=numsteps, eta_true=eta_true)
