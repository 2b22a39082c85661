"""Trigger extraction and θ-θ confirmation of bank hits, on a torch
device.

Counterpart of ``scintools_tpu/detect/trigger.py``:
:func:`calibrate_noise_floor` (:57), :func:`trigger_program` (:85),
:func:`extract_triggers` (:126) and :func:`confirm_eta` (:170).

1. Each template ``k`` has its own measured noise floor ``(µ_k, σ_k)``:
   a fixed batch of pure-noise frames (numpy ``default_rng(seed)``, the
   JAX package's frames bit for bit) through the same correlation, and
   ``z_k = (s_k − µ_k)/σ_k``.
2. A lane triggers when its best template clears both ``z ≥ threshold``
   and ``s ≥ score_min``.
3. The correlator's ``ok[B]`` health bits gate it: a ``BAD_INPUT`` or
   ``BAD_CS`` lane never triggers.
4. :func:`confirm_eta` hands a hit's η to the θ-θ search
   (``thth.search.single_search``, one chain of the ``eig_warmstart``
   kernel on the card) over a narrow η window around it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import cuda_graphed, fifo_cached, resolve_device
from ..obs import retrace as _retrace

#: defaults calibrated on the scenario factory's closed loop: against the
#: measured per-template floor, pure-noise epochs peak at z ≈ 3 over a
#: 48-template bank while factory arcs score z ≳ 20
DEFAULT_THRESHOLD = 7.0
DEFAULT_SCORE_MIN = 8.0

#: frames of the noise calibration (σ_k stable to about ±12 %)
DEFAULT_CAL_FRAMES = 32


def calibrate_noise_floor(bank, *, n_frames=DEFAULT_CAL_FRAMES, seed=0,
                          variant=None, window="hanning", window_frac=0.1):
    """Each template's noise floor ``(µ_k[K], σ_k[K])`` (float32 numpy):
    a fixed batch of pure-noise frames through the same correlation real
    epochs take; σ below 0.5 is raised to 0.5. The correlator
    standardises its input, so one calibration serves a geometry."""
    from .correlate import correlate_bank

    rng = np.random.default_rng(seed)
    nf, nt = bank.geometry[0], bank.geometry[1]
    frames = rng.standard_normal((int(n_frames), nf, nt)).astype(np.float32)
    scores, _ = correlate_bank(frames, bank, variant=variant, window=window,
                               window_frac=window_frac)
    s = scores.cpu().numpy()
    mu = s.mean(axis=0)
    sigma = np.maximum(s.std(axis=0), 0.5)   # degenerate-σ guard
    return mu.astype(np.float32), sigma.astype(np.float32)


_TRIGGER_CACHE = {}
_MAX_CACHED = 16


def trigger_program(n_batch, n_templates, *, threshold=None, score_min=None,
                    device=None):
    """The cached peak extraction ``fn(scores[B, K], ok[B], mu[K],
    sigma[K]) → (z[B, K], best[B] int32, score_best[B], z_best[B],
    hit[B])`` on ``device``, site ``detect.trigger``; the noise floor is
    an input, so a re-calibration builds nothing."""
    threshold = DEFAULT_THRESHOLD if threshold is None else float(threshold)
    score_min = DEFAULT_SCORE_MIN if score_min is None else float(score_min)
    dev = resolve_device(device)
    key = (int(n_batch), int(n_templates), threshold, score_min, str(dev))

    def make():
        _retrace.record_build("detect.trigger", key)

        def run(scores, ok, mu, sigma):
            z = (scores - mu[None]) / sigma[None]
            best = torch.argmax(z, dim=1)
            z_best = torch.gather(z, 1, best[:, None])[:, 0]
            s_best = torch.gather(scores, 1, best[:, None])[:, 0]
            hit = (z_best >= threshold) & (s_best >= score_min) & (ok == 0)
            return z, best.to(torch.int32), s_best, z_best, hit

        return cuda_graphed(run)

    return fifo_cached(_TRIGGER_CACHE, key, make, _MAX_CACHED)


def extract_triggers(scores, ok, etas, *, noise_floor=None, threshold=None,
                     score_min=None, device=None):
    """Run the trigger stage on a score stack (a tensor, whose device it
    uses, or numpy on ``device``) and unpack per-lane host dicts
    ``{"hit", "eta_bank", "z", "score", "ok", "template"}``.
    ``noise_floor`` is ``(µ[K], σ[K])`` (:func:`calibrate_noise_floor`),
    else ``(0, 1)``; ``eta_bank`` is the best template's η, NaN for an
    unhealthy lane (which never hits)."""
    dev = scores.device if torch.is_tensor(scores) \
        else resolve_device(device)
    scores_d = torch.as_tensor(scores, dtype=torch.float32, device=dev)
    ok_d = torch.as_tensor(ok, device=dev).to(torch.int32)
    B, K = scores_d.shape
    if noise_floor is None:
        mu = torch.zeros((K,), dtype=torch.float32, device=dev)
        sigma = torch.ones((K,), dtype=torch.float32, device=dev)
    else:
        mu = torch.as_tensor(noise_floor[0], dtype=torch.float32, device=dev)
        sigma = torch.as_tensor(noise_floor[1], dtype=torch.float32,
                                device=dev)
    fn = trigger_program(B, K, threshold=threshold, score_min=score_min,
                         device=dev)
    _, best, s_best, z_best, hit = (t.cpu().numpy() for t in
                                    fn(scores_d, ok_d, mu, sigma))
    ok_h = ok_d.cpu().numpy()
    etas = np.asarray(etas, dtype=float)
    out = []
    for b in range(B):
        healthy = int(ok_h[b]) == 0
        out.append({
            "hit": bool(hit[b]),
            "eta_bank": float(etas[best[b]]) if healthy else float("nan"),
            "z": float(z_best[b]),
            "score": float(s_best[b]),
            "ok": int(ok_h[b]),
            "template": int(best[b]),
        })
    return out


def confirm_eta(dyn, freqs, times, eta_seed, *, window=2.5, n_eta=31,
                npad=1, n_edges=96, fw=0.2, eta_edges=None, device=None):
    """Confirm one bank hit: the θ-θ eigenvalue search
    (``thth.search.single_search``, the ``fit_thetatheta`` engine; on the
    card one chain of the ``eig_warmstart`` kernel) over
    the η window ``[η_seed/window, η_seed·window]`` on ``device``.

    Seed with the refined η (``detect/refine.py``) where there is one:
    a window sized from the bank grid can graze the 2η harmonic. The θ
    edges are sized for the window's largest curvature (``η·θ² <
    τ_max`` and ``|θ| < f_D,max/2``); ``eta_edges`` pins that sizing to a
    discrete η (the hit's template) when the seed is a refined value.

    Returns the :class:`~..thth.search.ChunkSearchResult`: its
    ``eta``/``eta_sig`` are the confirmed measurement, its ``ok`` the
    health bits, and a NaN η means the hit did not confirm."""
    from ..thth.core import fft_axis
    from ..thth.search import single_search

    freqs = np.asarray(freqs, dtype=float)
    times = np.asarray(times, dtype=float)
    etas = np.geomspace(float(eta_seed) / window, float(eta_seed) * window,
                        int(n_eta))
    fd = fft_axis(times, pad=npad, scale=1e3)
    tau = fft_axis(freqs, pad=npad, scale=1.0)
    eta_edge_max = float(eta_edges) * window if eta_edges is not None \
        else etas.max()
    th_lim = 0.95 * min(np.sqrt(tau.max() / eta_edge_max), fd.max() / 2)
    edges = np.linspace(-th_lim, th_lim, int(n_edges))
    return single_search(np.asarray(dyn), freqs, times, etas, edges, fw=fw,
                         npad=npad, device=device)
