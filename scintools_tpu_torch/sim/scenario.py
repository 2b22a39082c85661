"""Closed-loop scenario workload: generate → search → fit, on a torch
device.

Counterpart of ``scintools_tpu/sim/scenario.py:53-310`` and
``:391-416``: the calibration constants, ``DEFAULT_REGIMES``,
``scenario_truths``, ``make_sspec_db_batch``, ``_lane_table``,
``scenario_workload`` and ``recovery_summary``.

One batch of epochs stays on the device from generation to fit:

1. **generate**: ``simulate_scenarios(device_out=True)`` with per-lane
   regime parameters, each lane keyed by its epoch seed;
2. **search**: the batched 10·log10 secondary spectrum
   (:func:`make_sspec_db_batch`) → ``ops.fitarc.fit_arc_batch`` with a
   per-lane η window around the lane's theoretical curvature (one launch
   of the arc-profile kernel on the card);
3. **fit**: ``fit.batch.scint_params_batch`` on the same stack for
   (τ_d, Δν_d, amp).

A lane the batch rejects descends to the STAGED tier (one lane of the
factory at ``precision="highest"`` and the same fits) and then to the
NUMPY tier (the reference ``Simulation`` class, then the same search
and fits at B = 1), both on the same device, so every tier launches the
arc-profile kernel on the card. :func:`run_scenario_survey` drives the tiers
through the journaled survey runner (``robust.run_survey_batched``);
the distributed one (``run_scenario_fleet``) waits for the fleet.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import gamma as _gamma

from ..backend import fifo_cached, resolve_device
from ..obs import retrace as _retrace
from ..robust.ladder import TIER_FUSED, TIER_NUMPY, TIER_STAGED  # noqa: F401
from ..utils import slog

#: τ_d / Δν_d calibration of the Fresnel↔diffractive crossover to this
#: simulator's convention (measured by the JAX package on its float64
#: oracle path at ns=256): the intensity decorrelation scale saturates
#: at ``TAU_FRES·rf`` in weak scattering and follows ``TAU_DIFF·s0`` in
#: strong scattering; the decorrelation bandwidth saturates at
#: ``DNU_FRES`` of the band and falls as ``DNU_DIFF·(s0/rf)`` of it when
#: diffractive; ``ar`` enters as ``τ ∝ ar^-1/2``, ``Δν ∝ ar^1/4``.
TAU_FRES = 0.19
TAU_DIFF = 1.3
DNU_FRES = 0.65
DNU_DIFF = 1.95

#: the default regime sweep: weak (Fresnel-limited) and strong
#: (diffractive) scattering and anisotropy, one built factory for all
DEFAULT_REGIMES = (
    {"name": "weak", "mb2": 0.5, "ar": 1.0, "psi": 0.0,
     "alpha": 5 / 3},
    {"name": "strong", "mb2": 16.0, "ar": 1.0, "psi": 0.0,
     "alpha": 5 / 3},
    {"name": "aniso", "mb2": 16.0, "ar": 2.0, "psi": 30.0,
     "alpha": 5 / 3},
)


#: ``ok`` code of a lane whose fit was refused (``guards.BAD_FIT``)
_BAD_FIT = 8

def _no_mark(name):
    pass


_SSPEC_DB_CACHE = {}
_SSPEC_DB_CACHE_SIZE = 16
SSPEC_DB_CACHE_STATS = {"builds": 0}


def scenario_truths(mb2, ar, psi, alpha, rf=1.0, ds=0.02, dt=30.0,
                    freq=1400.0, dlam=0.05):
    """Closed-form per-lane ground truths ``{eta, tau, dnu}`` (host
    numpy, broadcastable lane arrays): ``eta`` [s³] the reference's
    theoretical arc curvature (scint_sim.py:123-133), ``tau`` [s] and
    ``dnu`` [MHz] the calibrated crossover forms above, with the
    diffractive scale ``s0 = rf·cdrf^(1/α)`` and ``V = ds/dt``."""
    mb2, ar, psi, alpha = np.broadcast_arrays(
        *(np.asarray(v, dtype=float) for v in (mb2, ar, psi, alpha)))
    a2 = alpha * 0.5
    cdrf = (2.0 ** alpha * np.cos(alpha * np.pi * 0.25)
            * _gamma(1.0 + a2) / mb2)
    s0 = rf * cdrf ** (1.0 / alpha)
    V = ds / dt
    k_wave = 2 * np.pi / freq
    eta = (rf ** 2 * k_wave / (2 * V ** 2) / 1e6
           / np.cos(psi * np.pi / 180) ** 2)
    tau = 1.0 / (V * np.sqrt((1 / (TAU_FRES * rf)) ** 2
                             + (1 / (TAU_DIFF * s0)) ** 2)
                 * np.sqrt(ar))
    band = freq * dlam
    dnu = (band / np.sqrt(1 / DNU_FRES ** 2
                          + (rf / (DNU_DIFF * s0)) ** 2)
           * ar ** 0.25)
    return {"eta": eta, "tau": tau, "dnu": dnu}


def make_sspec_db_batch(nt, nf, window="hanning", window_frac=0.1,
                        device=None):
    """``fn(dyns[B, nf, nt]) → sec_db[B, ntdel, nfdop]``: the batched
    secondary spectrum in dB on ``device``, built once per geometry and
    device (a FIFO of 16, ``SSPEC_DB_CACHE_STATS["builds"]``)."""
    from ..ops.sspec import secondary_spectrum_power
    from ..ops.windows import get_window

    dev = resolve_device(device)
    key = (int(nt), int(nf), window, float(window_frac), str(dev))

    def build():
        SSPEC_DB_CACHE_STATS["builds"] += 1
        _retrace.record_build("sim.scenario_sspec", key)
        wins = get_window(nt, nf, window=window, frac=window_frac)

        def run(dyns):
            dyns = torch.as_tensor(dyns, device=dev).to(torch.float32)
            return 10.0 * torch.log10(
                secondary_spectrum_power(dyns, window_arrays=wins))

        return run

    return fifo_cached(_SSPEC_DB_CACHE, key, build, _SSPEC_DB_CACHE_SIZE)


def _lane_table(regimes, epochs_per_regime, seed):
    """The survey's epoch list: ``(epoch_id, payload)`` with the lane's
    regime parameters and its deterministic integer seed."""
    epochs = []
    for ri, reg in enumerate(regimes):
        for i in range(epochs_per_regime):
            lane_seed = int(seed) * 1000003 + ri * 100003 + i
            epochs.append((f"{reg['name']}/{i:05d}", {
                "regime": reg["name"],
                "mb2": float(reg.get("mb2", 2.0)),
                "ar": float(reg.get("ar", 1.0)),
                "psi": float(reg.get("psi", 0.0)),
                "alpha": float(reg.get("alpha", 5 / 3)),
                "seed": lane_seed & 0x7FFFFFFF,
            }))
    return epochs


def scenario_workload(regimes=DEFAULT_REGIMES, epochs_per_regime=128,
                      ns=128, nf=64, dlam=0.05, rf=1.0, ds=0.02,
                      dt=30.0, freq=1400.0, inner=0.001, seed=0,
                      numsteps=1500, n_iter=60, eta_window=(0.2, 5.0),
                      device=None):
    """The closed-loop scenario survey as a workload on ``device``
    (``None``: the card): ``{"epochs", "process_batch", "process",
    "fit_stack"}``, the epoch table, the batched and per-epoch process
    functions and their search-and-fit stage, with no runner attached.
    Every result dict carries the recovered and the true η, τ and Δν,
    the regime and the lane's ``ok`` code."""
    from ..fit.batch import scint_params_batch
    from ..io.psrflux import MalformedInputError
    from ..ops.fitarc import fit_arc_batch
    from ..ops.sspec import sspec_axes
    from .factory import lane_keys_from_seeds, simulate_scenarios
    from .simulation import Simulation

    dev = resolve_device(device)
    nt = ns                                   # factory: (ns time, nf)
    df = freq * dlam / (nf - 1)
    fdop, tdel, _ = sspec_axes(nf, nt, dt, df)
    sspec_db = make_sspec_db_batch(nt, nf, device=dev)
    epochs = _lane_table(regimes, epochs_per_regime, seed)
    sim_kw = dict(ns=ns, nf=nf, dlam=dlam, rf=rf, ds=ds, inner=inner,
                  device=dev)

    def _truths(p):
        t = scenario_truths(p["mb2"], p["ar"], p["psi"], p["alpha"],
                            rf=rf, ds=ds, dt=dt, freq=freq, dlam=dlam)
        return {k: float(v) for k, v in t.items()}

    def _result(p, eta, etaerr, fits, i, code):
        t = _truths(p)
        return {
            "ok": int(code), "regime": p["regime"],
            "eta": float(eta), "etaerr": float(etaerr),
            "tau": float(fits["tau"][i]),
            "tauerr": float(fits["tauerr"][i]),
            "dnu": float(fits["dnu"][i]),
            "dnuerr": float(fits["dnuerr"][i]),
            "eta_true": t["eta"], "tau_true": t["tau"],
            "dnu_true": t["dnu"],
        }

    def fit_stack(dyns, payloads, mark=_no_mark):
        """Search and fit the stack ``dyns[B, nf, nt]`` (on the device or
        numpy): ``(arcs, fits)``, B ``ArcFit`` and the dict of
        ``scint_params_batch``."""
        sec_db = sspec_db(dyns)
        mark("spectrum")
        etas_t = np.array([_truths(p)["eta"] for p in payloads])
        arcs = fit_arc_batch(
            None, tdel, fdop, numsteps=numsteps,
            etamin=eta_window[0] * etas_t, etamax=eta_window[1] * etas_t,
            sspecs_device=sec_db, full_output=False, device=dev)
        mark("arc fit")
        fits = scint_params_batch(dyns, dt, df, n_iter=n_iter, device=dev)
        mark("scint fit")
        return arcs, fits

    def _generate(payloads, **kw):
        return simulate_scenarios(
            len(payloads), mb2=[p["mb2"] for p in payloads],
            ar=[p["ar"] for p in payloads],
            psi=[p["psi"] for p in payloads],
            alpha=[p["alpha"] for p in payloads],
            keys=lane_keys_from_seeds([p["seed"] for p in payloads]),
            with_ok=True, device_out=True, **sim_kw, **kw)

    def process_batch(payloads, tier=None, mark=_no_mark):
        """The batched tier: generate, search and fit ``payloads``; one
        result dict per lane. ``mark(name)`` is called after each stage
        (generate, spectrum, arc fit, scint fit)."""
        dyn, code = _generate(payloads)
        dyns = dyn.transpose(1, 2).contiguous()       # (B, nf, nt)
        mark("generate")
        arcs, fits = fit_stack(dyns, payloads, mark)
        code = code.cpu().numpy()
        out = []
        for i, p in enumerate(payloads):
            eta, err = arcs[i].eta, arcs[i].etaerr
            lane = int(code[i])
            if lane == 0 and not (np.isfinite(eta)
                                  and np.isfinite(fits["tau"][i])
                                  and np.isfinite(fits["dnu"][i])):
                lane = _BAD_FIT
            out.append(_result(p, eta, err, fits, i, lane))
        return out

    def _params_ok(p):
        vals = (p["mb2"], p["ar"], p["psi"], p["alpha"])
        return (all(np.isfinite(v) for v in vals) and p["mb2"] > 0
                and p["ar"] > 0 and 0 < p["alpha"] < 2)

    def process(p, tier=None):
        """One epoch on a fallback tier: ``TIER_NUMPY``, the reference
        generator (the ``Simulation`` class) and the search and fits of
        :func:`fit_stack` at B = 1; otherwise STAGED, one factory lane
        at ``precision="highest"`` and the same fits. Both tiers launch
        the arc-profile kernel on the card. Invalid lane parameters
        raise ``MalformedInputError``: no tier can fix them."""
        if not _params_ok(p):
            raise MalformedInputError(
                f"<lane seed={p['seed']}>",
                "invalid regime params (non-finite or out of range)")
        if tier == TIER_NUMPY:
            sim = Simulation(seed=p["seed"], mb2=p["mb2"], ar=p["ar"],
                             psi=p["psi"], alpha=p["alpha"], dt=dt,
                             freq=freq, **sim_kw)
            dyns = torch.as_tensor(sim.dyn[None], dtype=torch.float32,
                                   device=dev)
            arcs, fits = fit_stack(dyns, [p])
            return _result(p, arcs[0].eta, arcs[0].etaerr, fits, 0, 0)
        dyn, code = _generate([p], precision="highest")
        lane = int(code[0])
        if lane != 0:
            # a flagged staged lane is a failed attempt, not a result:
            # the ladder descends to the numpy tier
            raise ValueError(f"staged lane unhealthy (code {lane})")
        dyns = dyn.transpose(1, 2).to(torch.float32).contiguous()
        arcs, fits = fit_stack(dyns, [p])
        return _result(p, arcs[0].eta, arcs[0].etaerr, fits, 0, lane)

    return {"epochs": epochs, "process_batch": process_batch,
            "process": process, "fit_stack": fit_stack}


def run_scenario_survey(workdir, regimes=DEFAULT_REGIMES,
                        epochs_per_regime=128, ns=128, nf=64,
                        dlam=0.05, rf=1.0, ds=0.02, dt=30.0,
                        freq=1400.0, inner=0.001, batch_size=64,
                        seed=0, numsteps=1500, n_iter=60,
                        eta_window=(0.2, 5.0), resume=True,
                        heartbeat=None, report=True, retries=1,
                        device=None):
    """The closed generate → search → fit loop as a journaled survey on
    ``device`` (``None``: the card). Returns the
    :func:`~scintools_tpu_torch.robust.run_survey_batched` result
    extended with ``"recovery"``: per-regime median relative errors of
    η / τ_d / Δν_d against the closed-form truths, over healthy lanes.

    Every per-epoch result dict carries the recovered AND true
    parameter values plus the lane health code, so the journal (and
    therefore resume, the RunReport, and any downstream reader) is a
    self-contained record of the recovery experiment. A lane the batch
    refuses descends to the staged tier, then to the numpy tier; a
    ``KernelError`` propagates."""
    from ..robust.runner import run_survey_batched

    wl = scenario_workload(
        regimes=regimes, epochs_per_regime=epochs_per_regime, ns=ns,
        nf=nf, dlam=dlam, rf=rf, ds=ds, dt=dt, freq=freq,
        inner=inner, seed=seed, numsteps=numsteps, n_iter=n_iter,
        eta_window=eta_window, device=device)
    epochs = wl["epochs"]
    with slog.span("sim.scenario_survey", n_epochs=len(epochs),
                   n_regimes=len(regimes), ns=ns, nf=nf,
                   batch_size=batch_size):
        out = run_survey_batched(
            epochs, wl["process_batch"], workdir,
            process=wl["process"], batch_size=batch_size,
            retries=retries, resume=resume, heartbeat=heartbeat,
            report=report, device=device)
    out["recovery"] = recovery_summary(out["results"])
    slog.log_event("sim.scenario_summary",
                   n_epochs=len(epochs),
                   recovery={r: {k: round(v, 4) for k, v in d.items()}
                             for r, d in out["recovery"].items()})
    return out


def run_scenario_fleet(workdir, n_workers=3, batch_size=48,
                       timeout=900.0, pod_options=None, plane_port=None,
                       target="scintools_tpu_torch.sim.scenario:"
                              "scenario_workload",
                       **workload_params):
    """The scenario survey DISTRIBUTED: the same closed
    generate → search → fit loop, run by ``n_workers`` worker processes
    through the fleet work queue (fleet/pod.py) — epoch-batch tasks,
    lease-based work-stealing, per-worker journals merged
    deterministically into one survey journal and a merged RunReport.
    ``workload_params`` are :func:`scenario_workload` parameters and
    travel to the workers as JSON, so ``device`` is a string (``"cuda"``,
    ``"cpu"``) or None (the card). ``target`` names the workload
    callable (``"module:callable"`` with :func:`scenario_workload`'s
    signature and result; a wrapper may add instrumentation). Returns
    the pod result with the per-regime ``"recovery"`` summary, as
    :func:`run_scenario_survey` does.

    ``plane_port`` (0 = ephemeral, advertised in ``<workdir>/plane.json``)
    starts the fleet observability plane: one port serving the merged
    ``/metrics``, ``/state``, ``/report`` and ``/workers`` of the run."""
    from ..fleet.pod import run_pod

    spec = {"target": target, "params": dict(workload_params)}
    options = dict(pod_options or {})
    if plane_port is not None:
        options.setdefault("plane_port", plane_port)
    out = run_pod(workdir, spec, n_workers=n_workers,
                  batch_size=batch_size, timeout=timeout, **options)
    out["recovery"] = recovery_summary(out["results"])
    slog.log_event("sim.scenario_summary",
                   n_epochs=out["summary"]["n_epochs"],
                   recovery={r: {k: round(v, 4) for k, v in d.items()}
                             for r, d in out["recovery"].items()})
    return out


def recovery_summary(results):
    """Per-regime median relative recovery errors (and lane counts)
    over the healthy lanes of a scenario-survey result map."""
    by_regime = {}
    for rec in results.values():
        if not isinstance(rec, dict) or "eta_true" not in rec:
            continue
        by_regime.setdefault(rec.get("regime", "?"), []).append(rec)
    out = {}
    for regime, recs in sorted(by_regime.items()):
        rel = {"eta": [], "tau": [], "dnu": []}
        n_ok = 0
        for r in recs:
            if int(r.get("ok", 1)) != 0:
                continue
            n_ok += 1
            for k in rel:
                truth = r[f"{k}_true"]
                if np.isfinite(r[k]) and truth:
                    rel[k].append(abs(r[k] - truth) / abs(truth))
        out[regime] = {
            "n": len(recs), "n_ok": n_ok,
            **{f"{k}_med_rel": float(np.median(v)) if v else np.nan
               for k, v in rel.items()},
        }
    return out
