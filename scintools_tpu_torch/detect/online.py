"""Online arc detection: the per-epoch detection hook, on a torch device.

Counterpart of ``scintools_tpu/detect/online.py``: :class:`ArcDetector`
with ``warmup``, ``scan_batch``, ``examine``, ``examine_group``,
``make_hook``, ``make_group_hook`` and ``describe``. Each epoch is
scanned against the bank on the device, a hit is refined on the zoomed
sub-grid (``detect/refine.py``) and confirmed by the θ-θ search
(``detect/trigger.py:confirm_eta``, the ``eig_warmstart`` kernel on the
card), and the chain reports through ``detect.trigger`` /
``detect.refine`` / ``detect.confirmed`` slog events and the
``detect_*`` metrics.

The hooks are plain callables ``hook(service, epoch_id, payload,
outcome)`` and ``hook(service, entries, outcomes)``, which the serving
daemon (``serve/``) registers.

Refinement, confirmation and the hooks are advisory, as in the JAX
package: an ordinary failure is logged, counted and leaves the epoch
unrefined, unconfirmed or unannotated. A kernel error or a device fault
(``backend.is_kernel_error``) is not: it propagates, as in the survey
runner, so a broken kernel never hides behind an unconfirmed hit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..backend import is_kernel_error, resolve_device
from ..obs import metrics as _metrics
from ..utils import slog
from .bank import DEFAULT_N_TEMPLATES, build_bank
from .correlate import correlate_bank, extract_blocks
from .refine import DEFAULT_N_ETA, refine_eta
from .trigger import calibrate_noise_floor, confirm_eta, extract_triggers


def _host(dyn):
    return dyn.detach().cpu().numpy() if torch.is_tensor(dyn) \
        else np.asarray(dyn)


def _count(name, help):
    _metrics.counter(name, help=help).inc()


def _hook_failure(exc, epoch):
    """Log and count an advisory failure; re-raise a kernel error."""
    if is_kernel_error(exc):
        raise exc
    slog.log_failure("detect.error", stage="hook", error=exc,
                     epoch=str(epoch))
    _count("detect_errors_total",
           "detection hook failures (epoch skipped, daemon unaffected)")


class ArcDetector:
    """Streaming template-bank arc detector for one epoch geometry on
    ``device`` (``None``: the card).

    ``nf, nt``: the bank frame (frequency channels × time subints);
    longer epochs are cut into 50 %-overlap-save blocks. ``dt`` [s] /
    ``df`` [MHz]: the axis steps; ``eta_range`` [s³]: the log-spaced
    bank span. ``threshold`` / ``score_min``: the trigger significances
    (``detect/trigger.py``). ``confirm=False`` skips the θ-θ stage,
    ``refine=False`` the sub-grid one. The detector is single-threaded
    by design, as the JAX package's."""

    def __init__(self, nf, nt, dt, df, eta_range,
                 n_templates=DEFAULT_N_TEMPLATES, threshold=None,
                 score_min=None, variant=None, window="hanning",
                 window_frac=0.1, confirm=True, confirm_window=2.25,
                 confirm_window_refined=1.8, confirm_n_eta=31,
                 confirm_npad=1, confirm_fw=0.2, confirm_edges=96,
                 refine=True, refine_n_eta=DEFAULT_N_ETA, refine_span=None,
                 refine_variant=None, f0=1400.0, hop=None, cal_frames=None,
                 cal_seed=0, device=None):
        self.device = resolve_device(device)
        self.nf, self.nt = int(nf), int(nt)
        self.dt, self.df = float(dt), float(df)
        self.eta_range = (float(eta_range[0]), float(eta_range[1]))
        self.threshold = threshold
        self.score_min = score_min
        self.variant = variant
        self.window = window
        self.window_frac = float(window_frac)
        self.confirm = bool(confirm)
        self.confirm_window = float(confirm_window)
        # a refined seed takes a tighter θ-θ window than the bank-grid
        # 2.25×: 1.8× covers the refined-η error while keeping the 2η
        # harmonic outside the searched grid
        self.confirm_window_refined = float(confirm_window_refined)
        self.confirm_n_eta = int(confirm_n_eta)
        self.confirm_npad = int(confirm_npad)
        self.confirm_fw = float(confirm_fw)
        self.confirm_edges = int(confirm_edges)
        self.refine = bool(refine)
        self.refine_n_eta = int(refine_n_eta)
        self.refine_span = refine_span
        self.refine_variant = refine_variant
        self.hop = hop
        self.bank = build_bank(self.nf, self.nt, self.dt, self.df,
                               self.eta_range[0], self.eta_range[1],
                               n_templates=n_templates, device=self.device)
        cal_kw = {} if cal_frames is None else {"n_frames": int(cal_frames)}
        self.noise_floor = calibrate_noise_floor(
            self.bank, seed=cal_seed, variant=self.variant,
            window=self.window, window_frac=self.window_frac, **cal_kw)
        self._freqs = float(f0) + np.arange(self.nf) * self.df
        self._times = np.arange(self.nt) * self.dt

    # ---- core scan ---------------------------------------------------
    def warmup(self):
        """Build the correlation and trigger functions (and the refine
        and θ-θ ones where enabled) before the first real epoch."""
        blank = np.zeros((self.nf, self.nt), dtype=np.float32)
        self.examine("<warmup>", blank, _quiet=True)
        eta_mid = float(np.sqrt(self.eta_range[0] * self.eta_range[1]))
        if self.refine:
            refine_eta(blank, self.bank, eta_mid, n_eta=self.refine_n_eta,
                       span=self.refine_span, variant=self.refine_variant,
                       window=self.window, window_frac=self.window_frac)
        if self.confirm:
            confirm_eta(blank, self._freqs, self._times, eta_mid,
                        window=self.confirm_window,
                        n_eta=self.confirm_n_eta, npad=self.confirm_npad,
                        fw=self.confirm_fw, n_edges=self.confirm_edges,
                        device=self.device)
        return self

    def scan_batch(self, dyns):
        """Bank-correlate a same-geometry stack ``[B, nf, nt]`` and
        extract each lane's trigger (no refine or θ-θ stage)."""
        scores, ok = correlate_bank(dyns, self.bank, variant=self.variant,
                                    window=self.window,
                                    window_frac=self.window_frac)
        return extract_triggers(scores, ok, self.bank.etas,
                                noise_floor=self.noise_floor,
                                threshold=self.threshold,
                                score_min=self.score_min)

    def _record(self, epoch_id, lane, frame, n_blocks, _quiet):
        """One epoch's detection record from its best lane, with the
        refine and θ-θ stages on a hit."""
        rec = dict(lane, n_blocks=n_blocks, triggered=bool(lane["hit"]),
                   confirmed=False, eta=None, eta_sig=None,
                   eta_refined=None)
        del rec["hit"]
        _count("detect_epochs_scanned_total",
               "epochs scanned against the template bank")
        if rec["ok"] != 0:
            from ..robust.guards import describe_health

            rec["health"] = describe_health(rec["ok"])
            _count("detect_epochs_unhealthy_total",
                   "epochs whose detection lanes failed the health guards "
                   "(quarantined, never triggered)")
        if rec["triggered"]:
            _count("detect_triggers_total",
                   "bank hits above the significance threshold")
            if not _quiet:
                slog.log_event("detect.trigger", epoch=str(epoch_id),
                               eta_bank=rec["eta_bank"],
                               z=round(rec["z"], 2),
                               score=round(rec["score"], 2),
                               n_blocks=n_blocks)
            if self.refine:
                self._refine(epoch_id, frame, rec, _quiet)
            if self.confirm:
                self._confirm(epoch_id, frame, rec, _quiet)
        return rec

    def examine(self, epoch_id, dyn, _quiet=False):
        """Scan one epoch (in overlap-save blocks when its time axis
        exceeds the bank frame): correlate → trigger → refine and θ-θ
        confirm on a hit. Returns the JSON-able detection record."""
        t0 = time.perf_counter()
        dyn = _host(dyn)
        blocks = extract_blocks(dyn, self.nt, self.hop) \
            if dyn.shape[-1] != self.nt else dyn[None]
        lanes = self.scan_batch(blocks)
        # the epoch's detection is its best block's
        bi = int(np.argmax([r["z"] for r in lanes]))
        rec = self._record(epoch_id, lanes[bi], blocks[bi], len(lanes),
                           _quiet)
        _metrics.histogram(
            "detect_scan_seconds",
            help="per-epoch bank scan + confirmation wall time",
        ).observe(time.perf_counter() - t0)
        return rec

    def examine_group(self, epoch_ids, dyns, _quiet=False):
        """Scan a same-geometry epoch group ``[B, nf, nt]`` in one bank
        correlation; hits escalate per epoch. Returns ``{epoch_id:
        record}`` with :meth:`examine`'s records (``n_blocks`` 1)."""
        t0 = time.perf_counter()
        dyns = _host(dyns)
        lanes = self.scan_batch(dyns)
        out = {str(e): self._record(e, lane, dyn, 1, _quiet)
               for e, lane, dyn in zip(epoch_ids, lanes, dyns)}
        _metrics.histogram(
            "detect_scan_seconds",
            help="per-epoch bank scan + confirmation wall time",
        ).observe(time.perf_counter() - t0)
        return out

    def _refine(self, epoch_id, frame, rec, _quiet):
        """Sub-grid η of a hit, on the best block's frame. Advisory: an
        ordinary failure leaves ``eta_refined`` None and the confirmation
        seeds from the bank η; a kernel error propagates."""
        try:
            res = refine_eta(np.asarray(frame), self.bank, rec["eta_bank"],
                             n_eta=self.refine_n_eta, span=self.refine_span,
                             variant=self.refine_variant,
                             window=self.window,
                             window_frac=self.window_frac)
        except Exception as e:  # noqa: BLE001 — advisory stage
            if is_kernel_error(e):
                raise
            slog.log_failure("detect.error", stage="refine", error=e,
                             epoch=str(epoch_id))
            return
        rec["eta_refined"] = float(res["eta_refined"])
        rec["refine_score"] = float(res["score"])
        _count("detect_refined_total",
               "bank hits rescored on the zoomed sub-grid η stage")
        if not _quiet:
            slog.log_event("detect.refine", epoch=str(epoch_id),
                           eta_refined=rec["eta_refined"],
                           eta_bank=rec["eta_bank"],
                           score=round(rec["refine_score"], 2))

    def _confirm(self, epoch_id, frame, rec, _quiet):
        """θ-θ confirmation of a hit on the best block's frame, seeded
        from the refined η where there is one (the θ-edge sizing pinned
        to the bank η). Advisory: an ordinary failure leaves the hit
        unconfirmed; a kernel error propagates. A vertex outside the
        searched window is refused as extrapolation."""
        seed = rec.get("eta_refined") or rec["eta_bank"]
        window = self.confirm_window_refined if rec.get("eta_refined") \
            else self.confirm_window
        try:
            res = confirm_eta(np.asarray(frame), self._freqs, self._times,
                              seed, window=window, n_eta=self.confirm_n_eta,
                              npad=self.confirm_npad, fw=self.confirm_fw,
                              n_edges=self.confirm_edges,
                              eta_edges=rec["eta_bank"], device=self.device)
        except Exception as e:  # noqa: BLE001 — advisory stage
            if is_kernel_error(e):
                raise
            slog.log_failure("detect.error", stage="confirm", error=e,
                             epoch=str(epoch_id))
            return
        in_window = (res.healthy and np.isfinite(res.eta)
                     and seed / window <= res.eta <= seed * window)
        if in_window:
            rec.update(confirmed=True, eta=float(res.eta),
                       eta_sig=float(res.eta_sig))
            _count("detect_confirmed_total",
                   "bank hits confirmed by the θ-θ stage")
            if not _quiet:
                slog.log_event("detect.confirmed", epoch=str(epoch_id),
                               eta=float(res.eta),
                               eta_sig=float(res.eta_sig),
                               eta_bank=rec["eta_bank"],
                               eta_refined=rec.get("eta_refined"))
        else:
            rec.update(confirmed=False, eta=None, eta_sig=None,
                       confirm_ok=int(res.ok))

    # ---- daemon wiring ----------------------------------------------
    def make_hook(self, extract=None):
        """The per-epoch ``on_published`` hook ``hook(service, epoch_id,
        payload, outcome)``: epochs whose outcome is not ``"ok"`` are
        skipped; ``extract(payload, outcome) → dyn[nf, nt] | None`` maps
        the payload to the dynspec (default: the payload itself); the
        record goes to ``service.annotate(epoch_id, detect=rec)``."""

        def hook(service, epoch_id, payload, outcome):
            if getattr(outcome, "status", None) != "ok":
                return
            try:
                dyn = extract(payload, outcome) if extract else payload
                if dyn is None:
                    return
                dyn = _host(dyn)
                if dyn.ndim != 2:
                    return
                rec = self.examine(epoch_id, dyn)
            except Exception as e:  # noqa: BLE001 — a consumer of
                # published results, never a reason to stop serving
                _hook_failure(e, epoch_id)
                return
            service.annotate(epoch_id, detect=rec)

        hook.hook_stage = "detect"
        return hook

    def make_group_hook(self, extract=None):
        """The batched ``on_published_group`` hook ``hook(service,
        entries, outcomes)``: the group's ok epochs of the bank's frame
        are scanned in one correlation (:meth:`examine_group`), others
        take the per-epoch overlap-save path, and each scanned epoch is
        annotated as :meth:`make_hook` does."""

        def hook(service, entries, outcomes):
            ids, dyns = [], []
            for key, payload in entries:
                out = outcomes.get(str(key))
                if getattr(out, "status", None) != "ok":
                    continue
                try:
                    dyn = extract(payload, out) if extract else payload
                    if dyn is None:
                        continue
                    dyn = _host(dyn)
                except Exception as e:  # noqa: BLE001 — see make_hook
                    _hook_failure(e, key)
                    continue
                if dyn.ndim != 2:
                    continue
                if dyn.shape == (self.nf, self.nt):
                    ids.append(str(key))
                    dyns.append(dyn)
                else:
                    try:
                        service.annotate(key, detect=self.examine(key, dyn))
                    except Exception as e:  # noqa: BLE001
                        _hook_failure(e, key)
            if not ids:
                return
            try:
                recs = self.examine_group(ids, np.stack(dyns))
            except Exception as e:  # noqa: BLE001 — see make_hook
                _hook_failure(e, ids[0])
                return
            for key, rec in recs.items():
                service.annotate(key, detect=rec)

        hook.hook_stage = "detect"
        return hook

    def describe(self):
        """JSON-able detector configuration."""
        return {
            "bank": self.bank.describe(),
            "threshold": self.threshold,
            "score_min": self.score_min,
            "variant": self.variant,
            "confirm": self.confirm,
            "confirm_window": self.confirm_window,
            "confirm_window_refined": self.confirm_window_refined,
            "refine": self.refine,
            "refine_n_eta": self.refine_n_eta,
            "refine_span": self.refine_span,
            "refine_variant": self.refine_variant,
        }
