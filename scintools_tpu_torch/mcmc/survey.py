"""Posterior surveys over the scenario factory's epochs, against their
closed-form truths, on a torch device.

Counterpart of ``scintools_tpu/mcmc/survey.py``: ``_truths`` (:51),
``_param_row`` (:57), :func:`mcmc_scenario_workload` (:99),
:func:`coverage_summary` (:427), :func:`run_mcmc_survey` (:464),
:func:`run_mcmc_fleet` (:504) and :func:`model_evidence_batched` (:535).
Every epoch of a batch gets two posteriors from the batched sampler
(``mcmc/sampler.py``): (τ_d, Δν_d, amp, __lnsigma) from the joint 1-D
ACF-cut likelihood, and η from the curvature-peak probability of the
arc fit's folded profile (sampled in window-normalised units u = η/η_ref,
so every lane shares one kernel and one box prior). Only the per-lane
summaries come back to the host, as journal rows with each parameter's
quantiles, ESS, R̂, truth rank and coverage.

One batch stays on the device from generation to summary: the factory
(``sim/factory.simulate_scenarios``), the ACF cuts and Bartlett weights
(``fit/batch.py``), the batched secondary spectrum and the arc fit
(``ops/fitarc.fit_arc_batch``, one launch of the arc-profile kernel on
the card), the two samplers and their reductions. Tiers, as the closed
loop's: FUSED is that batch; STAGED one factory lane at
``precision="highest"`` through the same stage; NUMPY the reference
``Simulation`` class, the host numpy sampler (``fit.fitter.sample_emcee``)
on its ACF cuts and the arc fit of :func:`fit_stack` at B = 1, so it
launches the arc-profile kernel too, with Gaussian η quantiles from the
parabola fit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import resolve_device
from ..obs import metrics as _metrics
from ..sim.scenario import (DEFAULT_REGIMES, _lane_table,
                            make_sspec_db_batch, scenario_truths)
from ..utils import slog
from .likelihood import make_acf1d_loglike, make_eta_profile_loglike, \
    tree_map
from .posterior import log_evidence, summarize_posterior
from .sampler import run_ensemble_batched

#: posterior parameters journaled per epoch, with their truth keys
_PARAMS = ("tau", "dnu", "eta")

#: offset of the η sampler's lane seeds from the ACF sampler's
ETA_SEED_OFFSET = 500009


def _truths(p, rf, ds, dt, freq, dlam):
    t = scenario_truths(p["mb2"], p["ar"], p["psi"], p["alpha"], rf=rf,
                        ds=ds, dt=dt, freq=freq, dlam=dlam)
    return {k: float(v) for k, v in t.items()}


def _param_row(name, q16, q50, q84, std, ess, rhat, rank, true, q025=None,
               q975=None, fse=None):
    """One parameter's journal columns (JSON scalars).

    The quantiles and rank are journaled as sampled. The coverage columns
    (``cov68``/``cov95``/``rank``) fold a finite-scintle error ``fse``
    (when given) into the posterior width in quadrature, the reference's
    error model: one epoch's ACF posterior measures the realisation's
    parameters, while the truth is the ensemble's, whose epoch-level
    uncertainty is the finite-scintle variance."""
    from scipy.stats import norm as _norm

    row = {
        f"{name}_q16": float(q16), f"{name}_q50": float(q50),
        f"{name}_q84": float(q84), f"{name}_std": float(std),
        f"{name}_ess": float(ess), f"{name}_rhat": float(rhat),
        f"{name}_rank": float(rank), f"{name}_true": float(true),
    }
    if q025 is not None:
        row[f"{name}_q025"] = float(q025)
        row[f"{name}_q975"] = float(q975)
    if not np.isfinite(true):
        row[f"{name}_cov68"] = 0
        row[f"{name}_cov95"] = 0
        return row
    if fse is not None and np.isfinite(fse):
        sig = float(np.hypot(std, fse))
        row[f"{name}_fse"] = float(fse)
        row[f"{name}_cov68"] = int(abs(q50 - true) <= sig)
        row[f"{name}_cov95"] = int(abs(q50 - true) <= 1.96 * sig)
        row[f"{name}_rank"] = float(_norm.cdf(true, loc=q50,
                                              scale=max(sig, 1e-30)))
    else:
        row[f"{name}_cov68"] = int(q16 <= true <= q84)
        row[f"{name}_cov95"] = int(q025 <= true <= q975) \
            if q025 is not None else 0
    return row


def mcmc_scenario_workload(regimes=DEFAULT_REGIMES, epochs_per_regime=48,
                           ns=128, nf=64, dlam=0.05, rf=1.0, ds=0.02,
                           dt=30.0, freq=1400.0, inner=0.001, seed=0,
                           nwalkers=32, steps=400, burn=0.4, thin=1,
                           numsteps=1500, eta_window=(0.2, 5.0),
                           alpha_fit=5 / 3, device=None):
    """The posterior survey as a workload on ``device`` (``None``: the
    card), with no runner attached: ``{"epochs", "process_batch",
    "process", "sample_stack", "fit_stack"}``, the epoch table, the
    batched and per-epoch process functions, and their two stages:
    ``sample_stack(dyns[B, nf, nt], payloads, seeds) → (summ, summ_eta,
    truths, etas_ref)`` (both posteriors of a device-resident stack) and
    ``fit_stack(dyns, etas_ref, full_output)`` (its arc fit, one launch of
    the arc-profile kernel on the card)."""
    from ..fit.batch import (acf_cuts_batch, bartlett_weights,
                             initial_guesses_batch)
    from ..io.psrflux import MalformedInputError
    from ..ops.fitarc import fit_arc_batch
    from ..ops.sspec import sspec_axes
    from ..robust.ladder import TIER_NUMPY
    from ..sim.factory import lane_keys_from_seeds, simulate_scenarios

    dev = resolve_device(device)
    nt = ns
    df = freq * dlam / (nf - 1)
    tobs, bw = nt * dt, nf * df
    fdop, tdel, _ = sspec_axes(nf, nt, dt, df)
    sspec_db = make_sspec_db_batch(nt, nf, device=dev)
    epochs = _lane_table(regimes, epochs_per_regime, seed)
    H = (int(numsteps) + int(numsteps) % 2) // 2

    acf_build, _, acf_lo, acf_hi, acf_key = make_acf1d_loglike(
        nt, nf, dt, df, alpha=alpha_fit, is_weighted=False)
    eta_build, _, _, _, eta_key = make_eta_profile_loglike(H)
    u_lo = np.array([float(eta_window[0])])
    u_hi = np.array([float(eta_window[1])])

    def _acf_x0(tcuts, fcuts):
        """Per-lane start points: the reference's initial guesses and
        ln σ₀ = ln 0.1."""
        tau0, dnu0, amp0, _ = initial_guesses_batch(tcuts, fcuts, dt, df,
                                                    tobs, bw)
        lnsig0 = torch.full(tau0.shape, np.log(0.1), dtype=torch.float64,
                            device=tau0.device)
        return torch.stack(
            [tau0.clamp(min=float(acf_lo[0])),
             dnu0.clamp(min=float(acf_lo[1])),
             amp0.to(torch.float64).clamp(min=float(acf_lo[2])), lnsig0],
            dim=-1)

    def _eta_data(arcs, etas_ref):
        """Fixed-shape η-sampler data from the arc fits: window-normalised
        profile grids padded to H (floor-padded power, ascending u past
        the window), each lane's peak power and the spectrum's noise. An
        arc lane without a usable profile gets NaN data, which the
        sampler's ``BAD_INPUT`` bit condemns."""
        B = len(arcs)
        prof = np.full((B, H), np.nan, dtype=np.float32)
        urow = np.full((B, H), np.nan, dtype=np.float32)
        pmax = np.full((B,), np.nan, dtype=np.float32)
        noise = np.full((B,), np.nan, dtype=np.float32)
        x0 = np.ones((B, 1), dtype=np.float32)
        for b, fit in enumerate(arcs):
            spec = getattr(fit, "profile", None)
            eta_s = getattr(fit, "eta_array", None)
            if (spec is None or eta_s is None
                    or not np.isfinite(getattr(fit, "eta", np.nan))
                    or not np.all(np.isfinite(spec))
                    or not np.isfinite(getattr(fit, "noise", np.nan))
                    or getattr(fit, "noise", 0) <= 0):
                continue
            L = min(len(spec), H)
            u = np.asarray(eta_s[:L], float) / etas_ref[b]
            if L < 4 or not np.all(np.diff(u) > 0):
                continue
            floor = float(np.min(spec[:L]))
            prof[b, :L] = spec[:L]
            prof[b, L:] = floor
            urow[b, :L] = u
            if L < H:
                urow[b, L:] = u[-1] + 1.0 + np.arange(H - L)
            pmax[b] = float(np.max(spec[:L]))
            noise[b] = float(fit.noise)
            eta_fit = getattr(fit, "eta", np.nan)
            u0 = eta_fit / etas_ref[b] if np.isfinite(eta_fit) \
                else u[int(np.argmax(spec[:L]))]
            x0[b, 0] = np.clip(u0, eta_window[0] * 1.05,
                               eta_window[1] * 0.95)
        return (prof, urow, pmax, noise), x0

    def fit_stack(dyns, etas_ref, full_output=True):
        """The arc fit of the stack ``dyns[B, nf, nt]`` in each lane's η
        window around its truth: B ``ArcFit``."""
        return fit_arc_batch(
            None, tdel, fdop, numsteps=numsteps,
            etamin=eta_window[0] * np.asarray(etas_ref),
            etamax=eta_window[1] * np.asarray(etas_ref),
            sspecs_device=sspec_db(dyns), full_output=full_output,
            device=dev)

    def sample_stack(dyns, payloads, seeds):
        """Both posteriors over the stack ``dyns[B, nf, nt]`` (a tensor on
        the device, or numpy): the batched ACF-cut sampler, then the arc
        fit and the batched η-profile sampler; summaries on the host."""
        dyns = torch.as_tensor(dyns, device=dev)
        B = len(payloads)
        truths = [_truths(p, rf, ds, dt, freq, dlam) for p in payloads]
        tcuts, fcuts = acf_cuts_batch(dyns, device=dev)
        wt = bartlett_weights(tcuts, nt)
        wf = bartlett_weights(fcuts, nf)
        out = run_ensemble_batched(
            acf_build, acf_key, (tcuts, fcuts, wt, wf),
            _acf_x0(tcuts, fcuts), acf_lo.astype(np.float32),
            acf_hi.astype(np.float32), nwalkers=nwalkers, steps=steps,
            seeds=seeds, device=dev)
        tr = np.full((B, 4), np.nan)
        tr[:, 0] = [t["tau"] for t in truths]
        tr[:, 1] = [t["dnu"] for t in truths]
        summ = summarize_posterior(out, burn=burn, thin=thin, truths=tr)

        etas_ref = np.array([t["eta"] for t in truths])
        arcs = fit_stack(dyns, etas_ref)
        eta_data, u0 = _eta_data(arcs, etas_ref)
        out_eta = run_ensemble_batched(
            eta_build, eta_key, eta_data, u0, u_lo.astype(np.float32),
            u_hi.astype(np.float32), nwalkers=nwalkers, steps=steps,
            seeds=[s + ETA_SEED_OFFSET for s in seeds], device=dev)
        summ_eta = summarize_posterior(out_eta, burn=burn, thin=thin,
                                       truths=np.ones((B, 1)))
        _metrics.counter(
            "mcmc_epochs_sampled_total",
            help="epochs whose posteriors the batched engine sampled",
        ).inc(B)
        _metrics.counter(
            "mcmc_sampler_steps_total",
            help="ensemble steps advanced across all sampled lanes",
        ).inc(2 * B * steps)
        return summ, summ_eta, truths, etas_ref

    def _fse(tau50, dnu50):
        """Finite-scintle errors at the posterior medians (the
        reference's nscint recipe)."""
        nscint = ((1 + 0.2 * bw / max(dnu50, 1e-30))
                  * (1 + 0.2 * tobs / (max(tau50, 1e-30) * np.log(2))))
        rt = 2 * np.sqrt(max(nscint, 1.0))
        return tau50 / rt, dnu50 / rt

    def _result(p, summ, summ_eta, truths_i, eta_ref, i, code):
        row = {"ok": int(code), "regime": p["regime"],
               "acc_frac": float(summ["acc_frac"][i]),
               "eta_acc_frac": float(summ_eta["acc_frac"][i])}
        fses = _fse(float(summ["q50"][i, 0]), float(summ["q50"][i, 1]))
        for j, name in enumerate(("tau", "dnu")):
            row.update(_param_row(
                name, summ["q16"][i, j], summ["q50"][i, j],
                summ["q84"][i, j], summ["std"][i, j], summ["ess"][i, j],
                summ["rhat"][i, j], summ["rank"][i, j], truths_i[name],
                q025=summ["q025"][i, j], q975=summ["q975"][i, j],
                fse=fses[j]))
        s = float(eta_ref)
        row.update(_param_row(
            "eta", summ_eta["q16"][i, 0] * s, summ_eta["q50"][i, 0] * s,
            summ_eta["q84"][i, 0] * s, summ_eta["std"][i, 0] * s,
            summ_eta["ess"][i, 0], summ_eta["rhat"][i, 0],
            summ_eta["rank"][i, 0], truths_i["eta"],
            q025=summ_eta["q025"][i, 0] * s,
            q975=summ_eta["q975"][i, 0] * s))
        return row

    def _params_ok(p):
        vals = (p["mb2"], p["ar"], p["psi"], p["alpha"])
        return (all(np.isfinite(v) for v in vals) and p["mb2"] > 0
                and p["ar"] > 0 and 0 < p["alpha"] < 2)

    def _generate(payloads, **kw):
        return simulate_scenarios(
            len(payloads), mb2=[p["mb2"] for p in payloads],
            ar=[p["ar"] for p in payloads],
            psi=[p["psi"] for p in payloads],
            alpha=[p["alpha"] for p in payloads], ns=ns, nf=nf, dlam=dlam,
            rf=rf, ds=ds, inner=inner,
            keys=lane_keys_from_seeds([p["seed"] for p in payloads]),
            with_ok=True, device_out=True, device=dev, **kw)

    def process_batch(payloads, tier=None):
        """The batched tier: generate and sample ``payloads``; one row
        per lane, its ``ok`` the factory's and both samplers' bits."""
        seeds = [p["seed"] for p in payloads]
        dyn, code = _generate(payloads)
        dyns = dyn.transpose(1, 2).contiguous()        # (B, nf, nt)
        summ, summ_eta, truths, etas_ref = sample_stack(dyns, payloads,
                                                        seeds)
        code = code.cpu().numpy()
        out = []
        for i, p in enumerate(payloads):
            lane = int(code[i]) | int(summ["ok"][i]) | int(summ_eta["ok"][i])
            if lane:
                _metrics.counter(
                    "mcmc_lanes_quarantined_total",
                    help="sampled lanes rejected by the health mask",
                ).inc()
            out.append(_result(p, summ, summ_eta, truths[i], etas_ref[i], i,
                               lane))
        return out

    def process(p, tier=None):
        """One epoch on a fallback tier (the ladder's contract: a tier
        raises on an unhealthy lane, a returned row is accepted)."""
        if not _params_ok(p):
            raise MalformedInputError(
                f"<lane seed={p['seed']}>",
                "invalid regime params (non-finite or out of range)")
        if tier == TIER_NUMPY:
            return _process_numpy(p)
        dyn, code = _generate([p], precision="highest")
        lane = int(code[0])
        if lane != 0:
            raise ValueError(f"staged lane unhealthy (code {lane})")
        dyns = dyn.transpose(1, 2).to(torch.float32).contiguous()
        summ, summ_eta, truths, etas_ref = sample_stack(dyns, [p],
                                                        [p["seed"]])
        lane = int(summ["ok"][0]) | int(summ_eta["ok"][0])
        if lane != 0:
            raise ValueError(f"staged sampler lane unhealthy (code {lane})")
        return _result(p, summ, summ_eta, truths[0], etas_ref[0], 0, 0)

    def _process_numpy(p):
        """The reference ``Simulation`` class, the host numpy sampler on
        its ACF cuts, and the B = 1 arc fit of :func:`fit_stack` with
        Gaussian η quantiles from the parabola fit."""
        from scipy.stats import norm as _norm

        from ..fit.fitter import sample_emcee
        from ..fit.models import scint_acf_model
        from ..fit.parameters import Parameters
        from ..sim.simulation import Simulation

        t = _truths(p, rf, ds, dt, freq, dlam)
        sim = Simulation(ns=ns, nf=nf, dlam=dlam, seed=p["seed"],
                         mb2=p["mb2"], ar=p["ar"], psi=p["psi"],
                         alpha=p["alpha"], rf=rf, ds=ds, inner=inner,
                         dt=dt, freq=freq, device=dev)
        dyn1 = torch.as_tensor(np.asarray(sim.dyn, dtype=float)[None],
                               device=dev)                 # (1, nf, nt)
        tcut, fcut = acf_cuts_batch(dyn1, device=dev)
        yt, yf = (c[0].double().cpu().numpy() for c in (tcut, fcut))
        wt = bartlett_weights(tcut, nt)[0].cpu().numpy()
        wf = bartlett_weights(fcut, nf)[0].cpu().numpy()
        params = Parameters()
        params.add("tau", value=max(dt, t["tau"]), vary=True,
                   min=1e-3 * dt, max=np.inf)
        params.add("dnu", value=max(df, t["dnu"]), vary=True,
                   min=1e-3 * df, max=np.inf)
        params.add("amp", value=1.0, vary=True, min=1e-8, max=np.inf)
        params.add("alpha", value=alpha_fit, vary=False)
        res = sample_emcee(
            scint_acf_model, params,
            ((dt * np.arange(len(yt)), df * np.arange(len(yf))), (yt, yf),
             (wt, wf)),
            nwalkers=min(nwalkers, 24), steps=min(steps, 250), burn=burn,
            thin=thin, seed=p["seed"] % (2 ** 31), is_weighted=False)
        flat = res.flatchain
        # -1.0 sentinels: the host tier keeps no per-lane acceptance
        # (NaN would be nonstandard JSON in the journal)
        row = {"ok": 0, "regime": p["regime"], "acc_frac": -1.0,
               "eta_acc_frac": -1.0}
        fses = _fse(float(np.median(flat[:, 0])),
                    float(np.median(flat[:, 1])))
        for j, name in enumerate(("tau", "dnu")):
            col = flat[:, j]
            q025, q16, q50, q84, q975 = np.quantile(
                col, [0.025, 0.16, 0.5, 0.84, 0.975])
            row.update(_param_row(
                name, q16, q50, q84, np.std(col), len(col), 1.0,
                float(np.mean(col < t[name])), t[name], q025=q025,
                q975=q975, fse=fses[j]))
        arc = fit_stack(dyn1.to(torch.float32), [t["eta"]],
                        full_output=False)[0]
        eta_f, err = float(arc.eta), float(arc.etaerr)
        if not (np.isfinite(eta_f) and np.isfinite(err) and err > 0):
            raise ValueError("numpy-tier arc fit refused")
        q025, q16, q50, q84, q975 = _norm.ppf(
            [0.025, 0.16, 0.5, 0.84, 0.975], loc=eta_f, scale=err)
        row.update(_param_row("eta", q16, q50, q84, err, -1.0, 1.0,
                              float(_norm.cdf(t["eta"], loc=eta_f,
                                              scale=err)), t["eta"],
                              q025=q025, q975=q975))
        return row

    return {"epochs": epochs, "process_batch": process_batch,
            "process": process, "sample_stack": sample_stack,
            "fit_stack": fit_stack}


def coverage_summary(results, params=_PARAMS):
    """Per-regime coverage calibration over the healthy lanes of a
    posterior-survey result map: the 68% and 95% credible-interval
    coverage, the mean truth rank, and the largest |ECDF − uniform| of
    the ranks (a finite-sample Kolmogorov–Smirnov distance)."""
    by_regime = {}
    for rec in results.values():
        if not isinstance(rec, dict) or "tau_rank" not in rec:
            continue
        by_regime.setdefault(rec.get("regime", "?"), []).append(rec)
    out = {}
    for regime, recs in sorted(by_regime.items()):
        healthy = [r for r in recs if int(r.get("ok", 1)) == 0]
        d = {"n": len(recs), "n_ok": len(healthy)}
        for name in params:
            ranks = np.array([r[f"{name}_rank"] for r in healthy
                              if np.isfinite(r[f"{name}_rank"])])
            cov = np.array([r[f"{name}_cov68"] for r in healthy])
            cov95 = np.array([r.get(f"{name}_cov95", 0) for r in healthy])
            if len(ranks):
                ecdf = np.arange(1, len(ranks) + 1) / len(ranks)
                ks = float(np.max(np.abs(np.sort(ranks) - ecdf)))
            else:
                ks = float("nan")
            d[f"{name}_cov68"] = float(np.mean(cov)) if len(cov) \
                else float("nan")
            d[f"{name}_cov95"] = float(np.mean(cov95)) if len(cov95) \
                else float("nan")
            d[f"{name}_rank_mean"] = float(np.mean(ranks)) if len(ranks) \
                else float("nan")
            d[f"{name}_rank_ks"] = ks
        out[regime] = d
    return out


def run_mcmc_survey(workdir, batch_size=48, resume=True, heartbeat=None,
                    report=True, retries=1, device=None,
                    **workload_params):
    """The posterior survey as a journaled, resumable product on
    ``device`` (``None``: the card): :func:`mcmc_scenario_workload`
    through ``run_survey_batched`` (per-epoch quarantine, the tier
    ladder, the CRC journal, resume). Returns the runner's result with
    ``"coverage"`` (:func:`coverage_summary`); with ``report=True`` the
    RunReport is written with the coverage under ``"mcmc_coverage"``. A
    ``KernelError`` propagates."""
    import time

    from ..obs import report as _report
    from ..robust.runner import run_survey_batched

    wl = mcmc_scenario_workload(device=device, **workload_params)
    epochs = wl["epochs"]
    t0 = time.perf_counter()
    with slog.span("mcmc.survey", n_epochs=len(epochs),
                   batch_size=batch_size, workdir=str(workdir)):
        out = run_survey_batched(
            epochs, wl["process_batch"], workdir, process=wl["process"],
            batch_size=batch_size, retries=retries, resume=resume,
            heartbeat=heartbeat, report=False, device=device)
    wall_s = time.perf_counter() - t0
    cov = coverage_summary(out["results"])
    out["coverage"] = cov
    slog.log_event("mcmc.coverage_summary", n_epochs=len(epochs),
                   coverage={r: {k: (round(v, 4) if isinstance(v, float)
                                     else v) for k, v in d.items()}
                             for r, d in cov.items()})
    if report:
        _report.write_run_report(workdir, _report.build_run_report(
            out["summary"], out["outcomes"], wall_s=wall_s,
            runner="run_mcmc_survey", extra={"mcmc_coverage": cov}))
    return out


def run_mcmc_fleet(workdir, n_workers=3, batch_size=48, timeout=900.0,
                   pod_options=None, plane_port=None,
                   target="scintools_tpu_torch.mcmc.survey:"
                          "mcmc_scenario_workload",
                   **workload_params):
    """The posterior survey DISTRIBUTED over the fleet: epoch-batch
    tasks on the shared work queue, lease-based stealing, per-worker
    journals merged deterministically, and (``plane_port``) the merged
    telemetry plane. ``workload_params`` are
    :func:`mcmc_scenario_workload` parameters and travel to the worker
    processes as JSON (``device`` a string or None, the card);
    ``target`` names the workload callable as in
    :func:`~scintools_tpu_torch.sim.scenario.run_scenario_fleet`.
    Returns the pod result extended with ``"coverage"``."""
    from ..fleet.pod import run_pod

    spec = {"target": target, "params": dict(workload_params)}
    options = dict(pod_options or {})
    if plane_port is not None:
        options.setdefault("plane_port", plane_port)
    out = run_pod(workdir, spec, n_workers=n_workers,
                  batch_size=batch_size, timeout=timeout, **options)
    cov = coverage_summary(out["results"])
    out["coverage"] = cov
    slog.log_event("mcmc.coverage_summary",
                   n_epochs=out["summary"]["n_epochs"],
                   coverage={r: {k: (round(v, 4) if isinstance(v, float)
                                     else v) for k, v in d.items()}
                             for r, d in cov.items()})
    return out


def model_evidence_batched(build_loglike, key, data, x0, lo, hi,
                           betas=None, nwalkers=32, steps=400, burn=0.4,
                           seeds=None, device=None):
    """Per-epoch log-evidence by thermodynamic integration with tempered
    lanes on the sampler's batch axis: the ``B`` epochs tiled over a β
    ladder into ``B·T`` lanes of one batched run, then ln Z = ∫⟨ln L⟩_β dβ
    (:func:`~.posterior.log_evidence`). ``betas`` defaults to a 9-rung
    cubic ladder (dense near β = 0). Needs finite bounds (a normalised
    uniform prior). Returns ``(logz[B], mean_ll[B, T], betas[T])``."""
    dev = resolve_device(device)
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    if not (np.all(np.isfinite(lo)) and np.all(np.isfinite(hi))):
        raise ValueError(
            "model evidence needs finite parameter bounds — an improper "
            "uniform prior has no normalisation")
    if betas is None:
        betas = np.linspace(0.0, 1.0, 9) ** 3
    betas = np.asarray(betas, dtype=float)
    T = len(betas)
    x0 = np.asarray(x0)
    B = x0.shape[0]
    seeds = np.arange(B) if seeds is None else np.asarray(seeds)
    # lane layout: epoch-major (epoch b's T temperatures contiguous)
    data_t = tree_map(lambda a: torch.repeat_interleave(
        torch.as_tensor(a, device=dev), T, dim=0), data)
    seeds_t = (np.repeat(seeds, T) * 31 + np.tile(np.arange(T), B)).tolist()
    out = run_ensemble_batched(
        build_loglike, key, data_t, np.repeat(x0, T, axis=0), lo, hi,
        nwalkers=nwalkers, steps=steps, seeds=seeds_t,
        betas=torch.as_tensor(np.tile(betas, B), device=dev), device=dev)
    mean_ll = summarize_posterior(out, burn=burn)["mean_loglike"] \
        .reshape(B, T)
    return log_evidence(mean_ll, betas), mean_ll, betas
