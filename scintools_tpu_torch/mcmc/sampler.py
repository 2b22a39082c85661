"""Batched affine-invariant ensemble sampling: walkers × epochs on a torch
device.

Counterpart of ``scintools_tpu/mcmc/sampler.py``: ``_tree_finite``
(:60), ``_build_run`` (:75), :func:`ensemble_program` (:159),
:func:`lane_keys` (:205), :func:`walker_init` (:221) and
:func:`run_ensemble_batched` (:245). The Goodman & Weare (2010) stretch
move runs on two batch axes: each lane (an epoch of a survey batch)
carries its walker ensemble, its data and its inverse temperature, and
every walker of every lane advances in one step of a Python loop over
steps whose body launches a fixed set of device operations and never
waits for the host (no ``.item()``, no ``bool(tensor)``).

Randomness. Torch cannot reproduce ``jax.random``, so the draws are
split from the arithmetic, as the scenario factory does: each lane has
its own ``torch.Generator`` on the device, seeded from its epoch seed and
a salt alone (:func:`lane_keys`), which draws the lane's walker normals
(:func:`draw_normals`) and its whole run of stretch factors, partners
and acceptance uniforms (:func:`draw_stretch`) up front, three calls a
lane. An epoch's chain is then independent of batch grouping and resume.
:func:`ensemble_program`'s ``run`` takes the draws as tensors, so the
tests feed it the JAX package's own draws.

Per-lane health (``robust/guards.py`` bits): ``BAD_INPUT`` marks a lane
whose data held non-finite values, ``BAD_FIT`` one whose final ensemble
holds no finite log-probability. A flagged lane's chain stays at its
initial ensemble (every proposal rejects against −inf), and every lane's
arithmetic is its own: a neighbour's chain keeps its bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import fifo_cached, resolve_device
from ..obs import retrace as _retrace
from ..robust import guards
from .likelihood import tree_flatten, tree_map

F64 = torch.float64

#: built samplers, one per (geometry key, nwalkers, ndim, a, device); a
#: FIFO of 32, each miss one ``record_build`` at ``mcmc.sampler``
_SAMPLER_CACHE = {}
_SAMPLER_CACHE_MAX = 32


def _tree_finite(data, B):
    """``[B]`` bool: every floating leaf of the lane's data is finite."""
    leaves, _ = tree_flatten(data)
    ok = None
    for leaf in leaves:
        if not torch.is_floating_point(leaf):
            continue
        f = torch.isfinite(leaf).reshape(B, -1).all(dim=1)
        ok = f if ok is None else ok & f
    return ok


def _build_run(loglike, nwalkers, ndim, a):
    """The batched sampler ``run(draws, pos0, lo, hi, betas, data, steps)``
    (see :func:`ensemble_program`) over the kernel ``loglike(x[B, n,
    ndim], data) → [B, n]``."""
    if nwalkers % 2:
        raise ValueError("nwalkers must be even for the half-ensemble "
                         "stretch move")
    half = nwalkers // 2
    halves = (slice(0, half), slice(half, nwalkers))

    def run(draws, pos0, lo, hi, betas, data, steps):
        steps = int(steps)
        B = pos0.shape[0]
        dev, dt = pos0.device, pos0.dtype
        lo = torch.as_tensor(lo, dtype=dt, device=dev)
        hi = torch.as_tensor(hi, dtype=dt, device=dev)
        betas = torch.as_tensor(betas, dtype=dt, device=dev)[:, None]
        z_all = draws["z"].to(dt)
        logz_all = (ndim - 1) * torch.log(z_all)
        partners = draws["partners"]
        logu_all = torch.log(draws["u_acc"].to(dt))
        lanes = torch.arange(B, device=dev)[:, None]
        neg_inf = torch.tensor(-np.inf, dtype=dt, device=dev)

        def lp_ll(x):
            ll = loglike(x, data)
            in_bounds = ((x >= lo) & (x <= hi)).all(dim=-1)
            return torch.where(torch.isfinite(ll) & in_bounds,
                               betas * ll, neg_inf), ll

        pos = pos0.clone()
        lp, ll = lp_ll(pos)
        chain = torch.empty((B, steps, nwalkers, ndim), dtype=dt,
                            device=dev)
        lps = torch.empty((B, steps, nwalkers), dtype=dt, device=dev)
        lls = torch.empty_like(lps)
        n_acc = torch.zeros(B, dtype=torch.int64, device=dev)
        for s in range(steps):
            for h, (act, oth) in enumerate((halves, halves[::-1])):
                z = z_all[:, s, h]
                comp = pos[:, oth][lanes, partners[:, s, h]]
                active = pos[:, act]
                prop = comp + z[..., None] * (active - comp)
                lp_prop, ll_prop = lp_ll(prop)
                log_accept = logz_all[:, s, h] + lp_prop - lp[:, act]
                accept = logu_all[:, s, h] < log_accept
                pos[:, act] = torch.where(accept[..., None], prop, active)
                lp[:, act] = torch.where(accept, lp_prop, lp[:, act])
                ll[:, act] = torch.where(accept, ll_prop, ll[:, act])
                n_acc += accept.sum(dim=1)
            chain[:, s] = pos
            lps[:, s] = lp
            lls[:, s] = ll
        acc_frac = n_acc.to(dt) / (steps * nwalkers)
        ok = guards.health_code(input_ok=_tree_finite(data, B),
                                fit_ok=torch.isfinite(lp).any(dim=1))
        return {"chain": chain, "logp": lps, "loglike": lls,
                "acc_frac": acc_frac, "ok": ok}

    return run


def ensemble_program(build_loglike, key, nwalkers, ndim, a=2.0,
                     device=None):
    """The cached batched sampler for one geometry on ``device`` (``None``:
    the card).

    ``build_loglike(device) → loglike(x[B, n, ndim], data) → [B, n]``
    builds the kernel (only on a cache miss); ``key`` is the caller's
    hashable geometry key, which must determine the kernel.

    Returns ``run(draws, pos0[B, nw, ndim], lo[ndim], hi[ndim], betas[B],
    data, steps) → dict`` with ``draws`` from :func:`draw_stretch` (or
    any tensors of its layout) and ``data`` a nest whose leaves carry the
    lane axis ``B``. The dict holds device tensors::

        chain    (B, steps, nw, ndim)   walker positions per step
        logp     (B, steps, nw)         tempered log-posterior
        loglike  (B, steps, nw)         untempered log-likelihood
        acc_frac (B,)                   acceptance fraction
        ok       (B,) int32             guards health bitmask

    ``betas`` are per-lane inverse temperatures (1 for plain sampling;
    tempered lanes give the evidence, ``mcmc/posterior.py``)."""
    dev = resolve_device(device)
    full_key = (key, int(nwalkers), int(ndim), float(a), str(dev))

    def build():
        _retrace.record_build("mcmc.sampler", full_key)
        return _build_run(build_loglike(dev), int(nwalkers), int(ndim),
                          float(a))

    return fifo_cached(_SAMPLER_CACHE, full_key, build, _SAMPLER_CACHE_MAX)


def lane_keys(seeds, salt=0):
    """Per-lane generator seeds from integer epoch seeds and a ``salt``
    (walker init and chain draw independent streams from one seed):
    stable per (seed, salt), so an epoch's chain is independent of batch
    grouping and resume boundaries."""
    return [int(np.random.SeedSequence([int(s) & 0xFFFFFFFF, int(salt)])
                .generate_state(1, np.uint64)[0] >> 1) for s in seeds]


def _generators(seeds, salt, dev):
    for k in lane_keys(seeds, salt):
        g = torch.Generator(device=dev)
        g.manual_seed(k)
        yield g


def draw_normals(seeds, nwalkers, ndim, salt=1, device=None):
    """Each lane's float64 walker-init normals ``[B, nwalkers, ndim]``
    from its own generator on ``device``, one call a lane."""
    dev = resolve_device(device)
    return torch.stack([torch.randn((nwalkers, ndim), generator=g,
                                    device=dev, dtype=F64)
                        for g in _generators(seeds, salt, dev)])


def draw_stretch(seeds, steps, half, a=2.0, salt=2, device=None, dtype=F64):
    """Each lane's draws for a whole run, from its own generator on
    ``device`` in three calls: the stretch factors ``z = ((a − 1)u +
    1)²/a``, the partners (uniform over the other half) and the
    acceptance uniforms, each ``[B, steps, 2, half]`` (axis 2: the first
    and the second half-ensemble update of a step)."""
    dev = resolve_device(device)
    u_z, partners, u_acc = [], [], []
    shape = (int(steps), 2, int(half))
    for g in _generators(seeds, salt, dev):
        u_z.append(torch.rand(shape, generator=g, device=dev, dtype=dtype))
        partners.append(torch.randint(0, int(half), shape, generator=g,
                                      device=dev))
        u_acc.append(torch.rand(shape, generator=g, device=dev, dtype=dtype))
    return {"z": ((a - 1.0) * torch.stack(u_z) + 1.0) ** 2 / a,
            "partners": torch.stack(partners), "u_acc": torch.stack(u_acc)}


def walker_init(normals, x0, lo, hi, rel_jitter=0.05):
    """Walker ensembles ``[B, nwalkers, ndim]`` scattered around ``x0[B,
    ndim]`` by ``rel_jitter`` of |x0| times the given ``normals[B,
    nwalkers, ndim]``, clipped strictly inside any finite bounds."""
    x0 = torch.as_tensor(x0, dtype=normals.dtype, device=normals.device)
    lo = torch.as_tensor(lo, dtype=x0.dtype, device=x0.device)
    hi = torch.as_tensor(hi, dtype=x0.dtype, device=x0.device)
    scale = rel_jitter * torch.clamp(x0.abs(), min=1e-8)
    pos = x0[:, None, :] + scale[:, None, :] * normals
    width = hi - lo
    span = torch.where(torch.isfinite(width), width,
                       torch.ones_like(width))
    lo_in = torch.where(torch.isfinite(lo), lo + 1e-9 * span, lo)
    hi_in = torch.where(torch.isfinite(hi), hi - 1e-9 * span, hi)
    return torch.minimum(torch.maximum(pos, lo_in), hi_in)


def to_lanes(data, device):
    """The data nest on ``device``, each numpy leaf made a tensor (its
    dtype kept)."""
    return tree_map(lambda v: torch.as_tensor(v, device=device), data)


def run_ensemble_batched(build_loglike, key, data, x0, lo, hi, nwalkers=32,
                         steps=500, seeds=None, betas=None, a=2.0,
                         rel_jitter=0.05, device=None):
    """One call of batched sampling on ``device`` (``None``: the card):
    walker init and chain, results left on the device. ``data`` leaves
    carry the lane axis ``B``; ``x0[B, ndim]`` are the lanes' start
    points; ``seeds[B]`` their integer epoch seeds (default ``arange``);
    the walkers are float64, as the JAX package's under 64-bit mode.
    Returns the :func:`ensemble_program` dict
    (reduce it with ``mcmc/posterior.py`` before fetching)."""
    dev = resolve_device(device)
    x0 = torch.as_tensor(np.asarray(x0) if not torch.is_tensor(x0) else x0,
                         device=dev).to(F64)
    B, ndim = x0.shape
    seeds = list(range(B)) if seeds is None else [int(s) for s in seeds]
    run = ensemble_program(build_loglike, key, nwalkers, ndim, a=a,
                           device=dev)
    pos0 = walker_init(draw_normals(seeds, nwalkers, ndim, salt=1,
                                    device=dev),
                       x0, lo, hi, rel_jitter=rel_jitter)
    if betas is None:
        betas = torch.ones((B,), dtype=F64, device=dev)
    draws = draw_stretch(seeds, steps, nwalkers // 2, a=a, salt=2,
                         device=dev)
    return run(draws, pos0, lo, hi, betas, to_lanes(data, dev), steps)
