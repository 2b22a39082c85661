"""Chain reductions on the device: only summaries come back to the host.

Counterpart of ``scintools_tpu/mcmc/posterior.py``: ``_build_summarize``
(:46), :func:`posterior_program` (:108), :func:`summarize_posterior`
(:133), :func:`log_evidence` (:157) and :func:`flatchain_summary`
(:175). A survey batch's chains are ``(B, steps, nwalkers, ndim)``
device tensors; one built reduction per geometry (``mcmc.posterior``
site) gives per-lane quantiles, mean and std, the integrated
autocorrelation ESS, split-R̂, truth ranks and the post-burn mean
log-likelihood that the tempered-lane evidence integrates.

Conventions, as the JAX package's:

- **std** over the flat kept samples is the population std (``ddof =
  0``, ``jnp.std``); split-R̂'s variances take ``ddof = 1``;
- **quantiles** interpolate linearly (``jnp.quantile``). ``torch.quantile``
  refuses inputs above 2²⁴ elements, so the lanes are reduced in chunks
  under that size (no sample is dropped);
- **ESS**: the walker-mean chain's FFT autocovariance, summed up to the
  first negative autocorrelation (``argmax`` of the mask cast to int:
  the first True), ESS = kept samples / τ_int;
- **split-R̂**: every walker's kept chain split in half in time, the
  2·nwalkers halves in the Gelman–Rubin ratio;
- **rank**: the share of kept samples below the lane's truth;
- **evidence**: ln Z = ∫₀¹ ⟨ln L⟩_β dβ by the trapezoid over the β
  ladder, under a normalised uniform-box prior.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import fifo_cached
from ..obs import retrace as _retrace

_POSTERIOR_CACHE = {}
_POSTERIOR_CACHE_MAX = 32

#: ``torch.quantile``'s largest input
QUANTILE_MAX_ELEMENTS = 1 << 24

_QUANTILES = (0.025, 0.16, 0.5, 0.84, 0.975)


def _build_summarize(steps, nwalkers, ndim, nburn, thin):
    """``summarize(chain[B, S, nw, nd], loglike[B, S, nw], truths[B, nd])
    → dict`` of per-lane tensors."""
    kept_idx = np.arange(int(nburn), int(steps), int(thin))
    K = len(kept_idx)
    S2 = K // 2
    n_kept = K * nwalkers

    def ess(walker_mean):
        """ESS per lane and parameter of ``walker_mean[B, K, nd]``."""
        x = walker_mean - walker_mean.mean(dim=1, keepdim=True)
        f = torch.fft.rfft(x, n=2 * K, dim=1)
        acov = torch.fft.irfft(f.abs() ** 2, n=2 * K, dim=1)[:, :K]
        a0 = acov[:, :1]
        rho = acov / torch.where(a0 > 0, a0, torch.ones_like(a0))
        neg = rho < 0
        first_neg = torch.where(neg.any(dim=1),
                                torch.argmax(neg.to(torch.int32), dim=1), K)
        lag = torch.arange(K, device=x.device)[None, :, None]
        win = (lag >= 1) & (lag < first_neg[:, None, :])
        tau = 1.0 + 2.0 * torch.where(win, rho, torch.zeros_like(rho)).sum(
            dim=1)
        return n_kept / torch.clamp(tau, min=1.0)

    def rhat(kept):
        """Split-R̂ per lane and parameter of ``kept[B, K, nw, nd]``."""
        halves = torch.cat([kept[:, :S2], kept[:, S2:2 * S2]], dim=2)
        means = halves.mean(dim=1)                    # (B, 2nw, nd)
        W = halves.var(dim=1, correction=1).mean(dim=1)
        Bv = S2 * means.var(dim=1, correction=1)
        var_plus = (S2 - 1) / S2 * W + Bv / S2
        return torch.sqrt(var_plus / torch.where(W > 0, W,
                                                 torch.ones_like(W)))

    def summarize(chain, loglike, truths):
        idx = torch.as_tensor(kept_idx, device=chain.device)
        kept = chain[:, idx]                          # (B, K, nw, nd)
        B = kept.shape[0]
        flat = kept.reshape(B, -1, ndim)
        qs = torch.tensor(_QUANTILES, dtype=flat.dtype, device=flat.device)
        per = max(1, QUANTILE_MAX_ELEMENTS // max(flat[0].numel(), 1))
        q = torch.cat([torch.quantile(flat[b:b + per], qs, dim=1)
                       for b in range(0, B, per)], dim=1)
        truths = truths.to(flat.dtype)
        return {
            "q025": q[0], "q16": q[1], "q50": q[2], "q84": q[3],
            "q975": q[4], "mean": flat.mean(dim=1),
            "std": flat.std(dim=1, correction=0),
            "rank": (flat < truths[:, None, :]).to(flat.dtype).mean(dim=1),
            "ess": ess(kept.mean(dim=2)), "rhat": rhat(kept),
            "mean_loglike": loglike[:, idx].reshape(B, -1).mean(dim=1),
        }

    return summarize


def posterior_program(steps, nwalkers, ndim, nburn, thin=1):
    """The cached chain-summary reduction (``mcmc.posterior`` site):
    ``summarize(chain[B, steps, nw, nd], loglike[B, steps, nw], truths[B,
    nd]) → dict`` of device tensors. ``nburn``/``thin`` select the kept
    steps; a NaN truth gives a rank of 0 (no sample lies below it) and
    leaves the rest unaffected."""
    key = (int(steps), int(nwalkers), int(ndim), int(nburn), int(thin))

    def build():
        _retrace.record_build("mcmc.posterior", key)
        return _build_summarize(*key)

    return fifo_cached(_POSTERIOR_CACHE, key, build, _POSTERIOR_CACHE_MAX)


def summarize_posterior(out, burn=0.3, thin=1, truths=None):
    """Reduce a sampler result dict (``mcmc/sampler.py``) on its device and
    fetch only the summaries: ``{name: np.ndarray}`` per-lane arrays plus
    the sampler's ``acc_frac`` and ``ok``. ``burn`` is a fraction (< 1)
    or a step count; ``truths[B, ndim]`` the per-lane truths of the rank
    statistic (optional)."""
    chain = out["chain"]
    B, steps, nwalkers, ndim = chain.shape
    nburn = int(burn * steps) if burn < 1 else int(burn)
    nburn = min(nburn, steps - 2)
    if truths is None:
        truths = np.full((B, ndim), np.nan)
    fn = posterior_program(steps, nwalkers, ndim, nburn, thin)
    summ = fn(chain, out["loglike"],
              torch.as_tensor(np.asarray(truths), device=chain.device))
    host = {k: v.cpu().numpy() for k, v in summ.items()}
    host["acc_frac"] = out["acc_frac"].cpu().numpy()
    host["ok"] = out["ok"].cpu().numpy()
    return host


def log_evidence(mean_loglikes, betas):
    """Thermodynamic-integration log-evidence from tempered-lane mean
    log-likelihoods: ln Z = ∫₀¹ ⟨ln L⟩_β dβ, the trapezoid over the
    sorted β ladder, under a normalised prior. ``mean_loglikes[..., T]``
    broadcasts over leading axes."""
    betas = np.asarray(betas, dtype=float)
    order = np.argsort(betas)
    b = betas[order]
    ll = np.asarray(mean_loglikes, dtype=float)[..., order]
    return np.trapezoid(ll, b, axis=-1) if hasattr(np, "trapezoid") \
        else np.trapz(ll, b, axis=-1)


def flatchain_summary(flatchain, var_names, truths=None):
    """Host summary of one epoch's ``flatchain[N, ndim]`` (the sampler's
    ``MinimizerResult`` field) per parameter: quantiles, mean, std and,
    with ``truths``, the rank. ``Dynspec.get_scint_params(method="mcmc")``
    stores it."""
    flat = np.asarray(flatchain, dtype=float)
    out = {}
    for i, name in enumerate(var_names):
        col = flat[:, i]
        q = np.quantile(col, list(_QUANTILES))
        rec = {"q025": q[0], "q16": q[1], "q50": q[2], "q84": q[3],
               "q975": q[4], "mean": float(np.mean(col)),
               "std": float(np.std(col))}
        if truths is not None and name in truths:
            rec["rank"] = float(np.mean(col < truths[name]))
        out[name] = rec
    return out
