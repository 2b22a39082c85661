"""Driver of the θ-θ curvature cells: a closed loop of observations
through the façade users call.

Each call builds a ``Dynspec`` from the next dynamic spectrum of a ring
made from the seed, then ``calc_sspec()``, ``prep_thetatheta(**prep)``
and ``fit_thetatheta()``, and ends on the host with ``ththeta``. The
ring holds ``traffic["ring"]`` distinct spectra, taken in turn, so no
two consecutive calls see one buffer.

What is checked (once the window has closed): every observation's
per-chunk ``eta_evo``, ``eta_evo_err``, ``eta_evo_ok`` and its
``ththeta``, ``ththetaerr`` against the reference of its spectrum, and
for each spectrum of the ring the secondary spectrum ``sspec`` of one
observation drawn from the seed.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import generate
from ..reference import thth as ref
from . import rel_gap

SPANS = ("thth.load", "thth.sspec", "thth.prep", "thth.search")


class Cell:
    UNIT = "obs"
    SPANS = SPANS

    def __init__(self, config, traffic, seed, device, spans):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.span = seed, device, spans
        obs = config["observation"]
        self.freqs = obs["f0"] + obs["df"] * np.arange(obs["nf"])
        self.times = obs["dt"] * np.arange(obs["nt"])
        p = dict(config["prep"])
        eta = obs["eta_true"]
        self.prep = dict(
            cwf=p["cwf"], cwt=p["cwt"], npad=p["npad"], fw=p["fw"],
            eta_min=p["eta_min_frac"] * eta, eta_max=p["eta_max_frac"] * eta,
            neta=p["neta"], nedge=p["nedge"], edges_lim=p["edges_lim"],
            fitting_proc=traffic["proc"])
        self.answers = []            # (slot, eta_evo, err, ok, th, th_err)
        self.sspecs = {}             # slot → (sspec, observations seen)
        self._pick = np.random.default_rng(generate.seed_sequence(seed, 99))

    def setup(self):
        """The program's kernels (built once per checkout, all of them,
        whichever cell runs first), the ring of spectra from the seed,
        then one observation of each, which builds the façade's search
        functions."""
        from scintools_tpu_torch import _build

        if self.device.type == "cuda":
            _build.build()
        obs = self.config["observation"]
        self.ring = []
        for k in range(int(self.traffic["ring"])):
            d = generate.arc_dynspecs(
                1, obs["nf"], obs["nt"], obs["dt"], obs["df"],
                obs["eta_true"], obs["n_images"], obs["fd_max"],
                obs["noise"], generate.seed_sequence(self.seed, 1, k),
                self.device)
            self.ring.append(d[0].cpu().numpy())
            del d
        for k in range(len(self.ring)):
            self._observe(k)

    def _observe(self, k):
        from scintools_tpu_torch import BasicDyn, Dynspec

        with self.span("thth.load"):
            bd = BasicDyn(self.ring[k], name=f"ring{k}", freqs=self.freqs,
                          times=self.times)
            ds = Dynspec(dyn=bd, process=False, verbose=False,
                         device=self.device)
        with self.span("thth.sspec"):
            ds.calc_sspec()
        with self.span("thth.prep"):
            ds.prep_thetatheta(**self.prep)
        with self.span("thth.search"):
            ds.fit_thetatheta()
        return ds

    def step(self, i):
        """One observation; returns the observations done (1)."""
        k = i % len(self.ring)
        ds = self._observe(k)
        self.answers.append((k, ds.eta_evo, ds.eta_evo_err, ds.eta_evo_ok,
                             float(ds.ththeta), float(ds.ththetaerr)))
        # one sspec per spectrum, drawn from the seed among its
        # observations (a reservoir of one)
        _, seen = self.sspecs.get(k, (None, 0))
        if self._pick.random() < 1.0 / (seen + 1):
            self.sspecs[k] = (ds.sspec, seen + 1)
        else:
            self.sspecs[k] = (self.sspecs[k][0], seen + 1)
        return 1

    def shapes(self):
        """The shapes the roofline counts of the search read."""
        obs, p = self.config["observation"], self.config["prep"]
        chunks = (obs["nf"] // p["cwf"]) * (obs["nt"] // p["cwt"])
        return {"chunks": chunks, "neta": p["neta"], "n": p["nedge"] - 1}

    def release(self):
        torch.cuda.empty_cache() if torch.cuda.is_available() else None

    # ------------------------------------------------------------------
    def references(self, precision="float64"):
        """The reference (or, in a lower precision, the control) of each
        spectrum of the ring."""
        return [ref.observation(d, self.freqs, self.times, self.prep,
                                precision=precision, device=self.device)
                for d in self.ring]

    def readings(self, refs=None):
        """The numbers compared: the program's answers against ``refs``."""
        refs = refs or self.references()
        sspecs = {k: s for k, (s, _) in self.sspecs.items()}
        return compare(self.answers, sspecs, refs, self.device)

    def control_readings(self, refs, precision):
        """The same numbers for the reference computed in ``precision``
        put in the program's place."""
        ctl = self.references(precision)
        answers = [(k, c["eta_evo"], c["eta_evo_err"], c["eta_evo_ok"],
                    c["ththeta"], c["ththetaerr"]) for k, c in enumerate(ctl)]
        sspecs = {k: c["sspec"] for k, c in enumerate(ctl)}
        return compare(answers, sspecs, refs, self.device)


def sspec_gap(got, want, device):
    """Mean |ΔdB| between two secondary spectra in dB over every bin
    whose reference power is above 1e-12 of its mean (so not the bins
    that are zero by construction, as the delay-0, Doppler-0 bin after
    the mean is removed, whose value is rounding in any precision); inf
    where the shapes differ or the program's is not finite there."""
    g = (got if isinstance(got, torch.Tensor)
         else torch.as_tensor(np.asarray(got), device=device)).double()
    w = want.double()
    if g.shape != w.shape:
        return float("inf")
    use = w > 10 * torch.log10((10 ** (w / 10)).mean()) - 120
    if bool((~torch.isfinite(g[use])).any()):
        return float("inf")
    return float((g - w)[use].abs().mean())


def compare(answers, sspecs, refs, device):
    """Readings of ``answers`` ``[(slot, eta_evo, eta_evo_err,
    eta_evo_ok, ththeta, ththetaerr)]`` and ``sspecs`` ``{slot:
    sspec}`` against ``refs`` (one reference dict per slot). The
    ``*_gap`` numbers are the largest relative gaps over every chunk of
    every observation; ``global_fit_gap`` and ``global_fit_err_gap``
    hold ``ththeta`` and ``ththetaerr`` to the weighted fit of the
    answer's own per-chunk η and errors (the fit stage alone, from the
    program's state)."""
    names = ("sspec_db_gap", "eta_gap", "eta_err_gap", "ok_mismatch",
             "ththeta_gap", "ththetaerr_gap", "global_fit_gap",
             "global_fit_err_gap")
    r = dict.fromkeys(names, 0.0)
    if not answers or not sspecs:
        return dict.fromkeys(names, float("inf"))
    for k, s in sspecs.items():
        r["sspec_db_gap"] = max(r["sspec_db_gap"],
                                sspec_gap(s, refs[k]["sspec"], device))
    for k, eta, err, ok, th, th_err in answers:
        want = refs[k]
        gf, gf_err = ref.global_fit(np.asarray(eta, dtype=float),
                                    np.asarray(err, dtype=float),
                                    want["f0s"], want["fref"])
        for name, v in (
                ("eta_gap", rel_gap(eta, want["eta_evo"]).max()),
                ("eta_err_gap", rel_gap(err, want["eta_evo_err"]).max()),
                ("ok_mismatch", np.sum(np.asarray(ok) != want["eta_evo_ok"])),
                ("ththeta_gap", rel_gap(th, want["ththeta"])),
                ("ththetaerr_gap", rel_gap(th_err, want["ththetaerr"])),
                ("global_fit_gap", rel_gap(th, gf)),
                ("global_fit_err_gap", rel_gap(th_err, gf_err))):
            r[name] = max(r[name], float(v))
    r["lanczos_bound"] = max(x["lanczos_bound"] for x in refs)
    return r
