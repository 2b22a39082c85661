"""Driver of the survey arc-fit cells: a closed loop of
``ops.fitarc.fit_arc_batch`` calls over batches of epochs resident on
the card, called as the survey engine calls it (``sspecs_device=``,
``full_output=False``).

Set-up makes ``traffic["batches"]`` batches of ``traffic["batch"]``
epochs' dynamic spectra on the card from the seed and their secondary
spectra in dB with the port's ``ops.sspec.secondary_spectrum``, one
epoch at a time as a survey's loaders do; the calls take the batches
in turn.

What is checked (once the window has closed): of ``traffic
["check_calls"]`` calls per batch, drawn from the seed, every epoch's
η, its noise error and its parabola error against the reference, which
works the spectra out again from the dynamic spectra.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import generate
from ..reference import arcfit as ref
from . import rel_gap

SPANS = ("arcfit.call",)


class Cell:
    UNIT = "epochs"
    SPANS = SPANS

    def __init__(self, config, traffic, seed, device, spans):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.span = seed, device, spans
        self.B = int(traffic["batch"])
        self.nbatch = int(traffic["batches"])
        self.keep = int(traffic["check_calls"])
        self.kept = {}               # batch → ([fits], calls seen)
        self._pick = np.random.default_rng(generate.seed_sequence(seed, 99))

    def setup(self):
        from scintools_tpu_torch import _build
        from scintools_tpu_torch.ops.sspec import secondary_spectrum

        if self.device.type == "cuda":
            _build.build()

        ep = self.config["epochs"]
        dyns = generate.arc_dynspecs(
            self.B * self.nbatch, ep["nf"], ep["nt"], ep["dt"], ep["df"],
            ep["eta_true"], ep["n_images"], ep["fd_max"], ep["noise"],
            generate.seed_sequence(self.seed, 2), self.device)
        secs = []
        for d in dyns:
            self.fdop, self.tdel, sec = secondary_spectrum(
                d, ep["dt"], ep["df"], device=self.device)
            secs.append(sec)
        self.batches = [torch.stack(secs[i * self.B:(i + 1) * self.B])
                        .contiguous() for i in range(self.nbatch)]
        del secs
        self.dyns = dyns.cpu()
        del dyns
        for i in range(self.nbatch):
            self._fit(i)

    def _fit(self, i):
        from scintools_tpu_torch.ops.fitarc import fit_arc_batch

        f = self.config["fit"]
        with self.span("arcfit.call"):
            return fit_arc_batch(
                None, self.tdel, self.fdop, numsteps=f["numsteps"],
                startbin=f["startbin"], cutmid=f["cutmid"],
                nsmooth=f["nsmooth"], sspecs_device=self.batches[i],
                full_output=False, device=self.device)

    def step(self, i):
        """One batch; returns the epochs fitted."""
        k = i % self.nbatch
        fits = self._fit(k)
        kept, seen = self.kept.get(k, ([], 0))
        seen += 1
        if len(kept) < self.keep:
            kept.append(fits)
        else:
            j = int(self._pick.integers(seen))
            if j < self.keep:
                kept[j] = fits
        self.kept[k] = (kept, seen)
        return len(fits)

    def shapes(self):
        """The shapes the roofline count of the profile reads: epochs,
        delay rows, Doppler bins and queries of one call."""
        f = self.config["fit"]
        nrows = len(self.tdel) - 1 - f["startbin"]
        return {"epochs": self.B, "rows": nrows,
                "doppler": len(self.fdop),
                "queries": int(f["numsteps"]) + int(f["numsteps"]) % 2}

    def release(self):
        self.batches = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def references(self, precision="float64"):
        """Per batch, the reference's (or control's) ``(eta, etaerr,
        etaerr2)`` of every epoch."""
        ep, f = self.config["epochs"], self.config["fit"]
        out = []
        for i in range(self.nbatch):
            d = self.dyns[i * self.B:(i + 1) * self.B].to(self.device)
            fdop, tdel, sec = ref.spectra(d, ep["dt"], ep["df"], precision)
            del d
            out.append(np.stack(ref.fit_batch(
                sec, tdel, fdop, numsteps=f["numsteps"],
                startbin=f["startbin"], cutmid=f["cutmid"],
                nsmooth=f["nsmooth"], precision=precision), axis=1))
            del sec
        return out

    def readings(self, refs=None):
        refs = refs or self.references()
        answers = [(k, np.array([[a.eta, a.etaerr, a.etaerr2] for a in fits],
                                dtype=float))
                   for k, (calls, _) in self.kept.items() for fits in calls]
        return compare(answers, refs)

    def control_readings(self, refs, precision):
        ctl = self.references(precision)
        return compare(list(enumerate(ctl)), refs)


def compare(answers, refs):
    """Readings of ``answers`` ``[(batch, [B, 3] (eta, etaerr,
    etaerr2))]`` against ``refs`` (a ``[B, 3]`` array per batch)."""
    names = ("eta_gap", "etaerr_gap", "etaerr2_gap")
    r = {n: 0.0 for n in names}
    r.update(nan_mismatch=0.0, eta_gap_p99=0.0)
    if not answers:
        return {k: float("inf") for k in r}
    for k, got in answers:
        want = refs[k]
        if got.shape != want.shape:
            return {n: float("inf") for n in r}
        for j, n in enumerate(names):
            r[n] = max(r[n], float(rel_gap(got[:, j], want[:, j]).max()))
        r["nan_mismatch"] = max(r["nan_mismatch"], float(
            np.sum(np.isnan(got[:, 0]) != np.isnan(want[:, 0]))))
        r["eta_gap_p99"] = max(r["eta_gap_p99"], float(
            np.quantile(rel_gap(got[:, 0], want[:, 0]), 0.99)))
    return r
