"""The ensemble sampler on the device for one epoch: the B = 1 lane of the
batched engine (``mcmc/sampler.py``).

Counterpart of ``scintools_tpu/fit/ensemble.py``: :func:`make_logp`
(:40), :func:`make_ensemble_sampler` (:83) and :func:`sample_emcee_jax`
(:111). The JAX name is kept so the ``fit`` namespace matches; here it
is the device sampler, run by ``fitter(mcmc=True)``. It owns no sampler
of its own: the chain is one lane of
:func:`~..mcmc.sampler.ensemble_program`, whose built samplers are
cached per geometry, so same-shaped epochs share one. The walkers start
from the same numpy ``default_rng(seed)`` recipe as the JAX package's,
so ``pos`` is bitwise theirs; the chain's draws come from the lane's
torch generator (``mcmc.sampler.lane_keys(seed, salt=2)``), so agreement
with the host sampler (``fitter.sample_emcee``) or the JAX one is
statistical.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import resolve_device
from .fitter import chain_result, initial_walkers

F64 = torch.float64


def make_logp(model, params, args, is_weighted=True, device=None):
    """``(logp, names)``: ``logp(x[..., ndim]) → [...]`` the
    log-probability over the varying-parameter vectors ``x`` (a tensor on
    ``device``), with lmfit ``Minimizer.emcee`` semantics (``is_weighted``
    or the ``__lnsigma`` column) and −inf outside the bounds or where the
    model is not finite. The data ``args`` are fixed into it."""
    from ..mcmc.likelihood import make_model_loglike
    from ..mcmc.sampler import to_lanes

    dev = resolve_device(device)
    build, names, lo, hi, _ = make_model_loglike(model, params,
                                                 is_weighted=is_weighted)
    loglike = build(dev)
    data = to_lanes(_with_lane_axis(args), dev)
    lo_t = torch.as_tensor(lo, dtype=F64, device=dev)
    hi_t = torch.as_tensor(hi, dtype=F64, device=dev)

    def logp(x):
        x = torch.as_tensor(x, dtype=F64, device=dev)
        ll = loglike(x.reshape(1, -1, x.shape[-1]), data).reshape(
            x.shape[:-1])
        inside = ((x >= lo_t) & (x <= hi_t)).all(dim=-1)
        return torch.where(torch.isfinite(ll) & inside, ll,
                           torch.full_like(ll, -np.inf))

    return logp, names


def make_ensemble_sampler(logp, nwalkers, ndim, a=2.0, device=None):
    """``run(seed, pos0[nw, ndim], steps) → (chain[steps, nw, ndim],
    logps[steps, nw], acc_frac)`` on ``device``: the single-lane view of
    the batched engine over ``logp(x[..., ndim]) → [...]``, built once per
    ``logp`` object (pass the same function to reuse it); ``seed`` seeds
    the lane's draws."""
    from ..mcmc.sampler import draw_stretch, ensemble_program

    dev = resolve_device(device)
    run_b = ensemble_program(lambda d: (lambda x, data: logp(x)),
                             ("fit.ensemble.custom", logp), nwalkers, ndim,
                             a=a, device=dev)

    def run(seed, pos0, steps):
        pos0 = torch.as_tensor(pos0, device=dev)
        draws = draw_stretch([seed], steps, nwalkers // 2, a=a, salt=2,
                             device=dev, dtype=pos0.dtype)
        full = torch.full((ndim,), np.inf, dtype=pos0.dtype, device=dev)
        out = run_b(draws, pos0[None], -full, full,
                    torch.ones((1,), dtype=pos0.dtype, device=dev), (),
                    steps)
        return out["chain"][0], out["logp"][0], out["acc_frac"][0]

    return run


def _with_lane_axis(args):
    from ..mcmc.likelihood import tree_map

    return tree_map(lambda v: np.asarray(v)[None]
                    if not torch.is_tensor(v) else v[None], tuple(args))


def sample_emcee_jax(model, params, args=(), nwalkers=100, steps=1000,
                     burn=0.2, thin=10, pos=None, seed=0, progress=False,
                     is_weighted=True, device=None):
    """The device ensemble sampler (``fitter(mcmc=True)``) with the
    result contract of :func:`~.fitter.sample_emcee`: a
    ``MinimizerResult`` with ``flatchain``, ``var_names``, median/std
    estimates and ``acceptance_fraction``. The chain is the B = 1 lane of
    the batched engine on ``device`` (``None``: the card), in float64;
    the epoch's data ride as tensors, so a loop over same-shaped epochs
    builds one sampler. The model must take tensors
    (``mcmc.likelihood.make_model_loglike``): an error raised by it or
    by the device propagates."""
    from ..mcmc.likelihood import make_model_loglike, model_data_key
    from ..mcmc.sampler import draw_stretch, ensemble_program, to_lanes

    dev = resolve_device(device)
    params = params.copy()
    build, names, lo, hi, key_base = make_model_loglike(
        model, params, is_weighted=is_weighted)
    rng = np.random.default_rng(None if seed is None else seed)
    pos, _, _, _ = initial_walkers(rng, params, nwalkers, pos, is_weighted)
    nwalkers, ndim = pos.shape
    if nwalkers % 2:
        raise ValueError("nwalkers must be even")

    data = to_lanes(_with_lane_axis(args), dev)
    run = ensemble_program(build, model_data_key(key_base, data), nwalkers,
                           ndim, device=dev)
    if progress:
        print(f"ensemble: {nwalkers} walkers x {steps} steps on {dev}...")
    draws = draw_stretch([0 if seed is None else seed], steps,
                         nwalkers // 2, salt=2, device=dev)
    out = run(draws, torch.as_tensor(pos, dtype=F64, device=dev)[None], lo,
              hi, torch.ones((1,), dtype=F64, device=dev), data, steps)
    if progress:
        print("ensemble: done")
    chain = out["chain"][0].cpu().numpy()            # (steps, nw, ndim)
    nburn = int(burn * steps) if burn < 1 else int(burn)
    kept = chain[nburn::thin] if nburn < steps else chain[-1:]
    result = chain_result(model, params, args, kept.reshape(-1, ndim),
                          names, nwalkers * steps, is_weighted)
    result.acceptance_fraction = float(out["acc_frac"][0])
    return result
