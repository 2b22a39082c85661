"""Dynspec façade of the port: psrflux files and their processing,
secondary spectra and ACFs, arc curvature, θ-θ curvature fits (standard,
incoherent and thin-screen) and wavefield retrieval.

Counterpart of ``scintools_tpu/dynspec.py``: ``Dynspec.__init__`` (:73),
``load_file`` (:90), ``load_dyn_obj`` (:105), ``_adopt`` (:129),
``_as_raw`` (:145), ``write_file`` (:151), ``__add__`` (:161),
``remove_short_subs`` (:176), ``trim_edges`` (:193, with ``_trim_freq``
and ``_trim_time``), ``crop_dyn`` (:246), ``zap`` (:269), ``refill``
(:276, every method), ``correct_dyn`` (:298), ``scale_dyn`` (:357,
equal-wavelength, velocity or orbit, and trapezoid), ``_select_dyn``
(:441), ``calc_sspec`` (:462),
``calc_acf`` (:511), ``cut_dyn`` (:533),
``_select_sspec`` (:575), ``fit_arc`` (:596), ``norm_sspec`` (:689,
with ``fit_spectrum``), ``get_scint_params`` (:758, methods ``nofit``,
``acf1d``, ``acf2d_approx`` and ``acf2d``), ``get_acf_tilt`` (:1070),
``prep_thetatheta`` (:1240, with the Hough seed of :1277-1296 and the
thin-screen limits of :1303-1324), ``_chunk`` (:1341),
``thetatheta_single`` (:1354), ``fit_thetatheta`` (:1416, the batched row
branch :1443-1489, the serial branch :1527-1536 and the weighted global
η ∝ f⁻² fit :1538-1581, ``time_avg`` included), ``thetatheta_chunks``
(:1787, the batched grid branch and the row-by-row ``memmap`` branch),
``calc_wavefield`` (:1888), ``_retrieval_grid_inputs`` (:1915),
``retrieve_wavefield`` (:1934), ``gerchberg_saxton`` (:1974),
``calc_asymmetry`` (:1990), ``calc_scattered_image`` (:1137),
``auto_processing``, ``default_processing``
and ``info`` (:2033-2061), the sharded fit ``_fit_thetatheta_sharded``
and ``_fit_thetatheta_sharded_fused`` (:1587-1785, one method here), the
plot methods ``plot_dyn`` … ``plot_all`` (:2065-2145), ``BasicDyn`` (:2148), ``MatlabDyn`` (:2177),
``SimDyn`` (:2209), ``HoloDyn`` (:2236) and ``sort_dyn`` (:2646). A
``sim.Simulation`` loads directly too (``Dynspec(dyn=sim)``). Every shared method takes the reference's
parameters in the reference's order; the port's own (``eig``,
``device``, ``mark``) come after them. State accretes on the instance as
in the JAX package (``self.dyn``, ``self.acf``, ``self.sspec``,
``self.lamsspec``, ``self.betaeta``, ``self.eta_evo``, ``self.ththeta``,
``self.chunks``, ``self.wavefield``, ``self.tau``, ``self.dnu``,
``self.acf_model``, …) as numpy arrays. The FFTs, the median refill's
sort, the θ-θ work, the analytic 2-D ACF and the acf2d fit run on
``self.device``; the steps that are host numpy in the JAX package
(parsing, trimming, the biharmonic and ``griddata`` refills, the SVD
flux model, the scipy fits, the initial guesses, the tilt fit, the
ephemeris and orbit, the λ and velocity resamplings) stay on the host;
the trapezoid resampling and the scattered image's interpolation run on
``self.device``.

Plots (every ``plot=``, ``plot_spec=`` and ``plot_fit=`` option and the
``plot_*`` methods) are drawn on the host by :mod:`.plotting` from the
numpy state, after the same device work as without them; ``mesh=``
(:func:`.parallel.make_mesh`) spreads the θ-θ fit, the retrieval and
Gerchberg–Saxton over a device mesh. Not ported: the ``sspec`` fitting
method (disabled upstream) raises ``NotImplementedError``. ``pool`` is
accepted and ignored, as the JAX package does off its numpy backend.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .backend import resolve_device
from .fit import models as mdl
from .fit.acf2d import fit_acf2d
from .fit.fitter import fitter
from .fit.parameters import Parameters
from .io.psrflux import RawDynSpec, concatenate_time, load_psrflux, \
    write_psrflux
from .ops import acf as acf_ops
from .ops import fitarc as fitarc_ops
from .ops import inpaint as inpaint_ops
from .ops import normsspec as normsspec_ops
from .ops import scale as scale_ops
from .ops import sspec as sspec_ops
from .ops.interp import interp_nan_2d
from .ops.scatim import is_uniform, scattered_image_interp
from .ops.scale import SPEED_OF_LIGHT
from .robust.guards import BAD_CS, BAD_INPUT
from .thth import core as thth_core
from .thth import retrieval as thth_ret
from .thth import search as thth_search
from .utils import slog
from .utils.misc import is_valid, svd_model

_STATE_KEYS = ("dyn", "times", "freqs", "dt", "df", "cwf", "cwt", "ncf_fit",
               "nct_fit", "ncf_ret", "nct_ret", "npad", "fw", "fref",
               "eta_min", "eta_max", "neta", "edges", "thth_tau_mask",
               "thetatheta_proc")
_OBS_KEYS = ("tobs", "bw", "nsub", "nchan", "freq", "mjd")


def _not_ported(**opts):
    """Raise for the options this port does not take yet."""
    given = sorted(k for k, v in opts.items()
                   if not (v is None or v is False))
    if given:
        raise NotImplementedError(f"{', '.join(given)} not ported yet")


class Dynspec:
    """Dynamic spectrum analysis object on a torch device."""

    def __init__(self, filename=None, dyn=None, verbose=True, process=False,
                 lamsteps=False, remove_short_subs=True, subint_thresh=2.33,
                 mjd=None, backend=None, device=None):
        """Load the psrflux file ``filename`` (:meth:`load_file`) or the
        adapter object ``dyn`` (:meth:`load_dyn_obj`). ``backend`` is the
        JAX package's and must stay None: the port runs on ``device``."""
        _not_ported(backend=backend)
        self.device = resolve_device(device)
        if filename:
            self.load_file(filename, verbose=verbose, process=process,
                           lamsteps=lamsteps, subint_thresh=subint_thresh,
                           remove_short_subs=remove_short_subs, mjd=mjd)
        elif dyn is not None:
            self.load_dyn_obj(dyn, verbose=verbose, process=process,
                              lamsteps=lamsteps)
        else:
            raise ValueError("No dynamic spectrum file or object")

    @classmethod
    def from_reference_state(cls, state, device=None):
        """A Dynspec holding exactly the θ-θ state ``state`` — a dict of
        plain numpy/float values named as the JAX ``Dynspec`` holds them
        after ``prep_thetatheta`` (``dyn, times, freqs, dt, df, cwf,
        cwt, ncf_fit, nct_fit, ncf_ret, nct_ret, npad, fw, fref, eta_min,
        eta_max, neta, edges, thth_tau_mask, thetatheta_proc``, and
        ``arclet_lim`` and ``center_cut`` when the proc is ``"thin"``) —
        ready for :meth:`fit_thetatheta`. An optional ``ththeta`` (the
        fitted curvature) makes it ready for retrieval without a fit.
        Optional observation values (``_OBS_KEYS``: ``tobs``, ``bw``,
        ``nsub``, ``nchan``, ``freq``, ``mjd``) and an optional ``acf``
        with ``acf_tilt`` and ``acf_tilt_err`` make it ready for
        :meth:`get_scint_params` and :meth:`get_acf_tilt` on that ACF."""
        missing = [k for k in _STATE_KEYS if k not in state]
        if missing:
            raise KeyError(f"reference state lacks {missing}")
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        for k in _STATE_KEYS:
            v = state[k]
            setattr(self, k, np.array(v, dtype=float)
                    if isinstance(v, (np.ndarray, list)) else v)
        if "ththeta" in state:
            self.ththeta = float(state["ththeta"])
        for k in _OBS_KEYS + ("acf_tilt", "acf_tilt_err"):
            if k in state:
                setattr(self, k, state[k])
        if "acf" in state:
            self.acf = np.array(state["acf"], dtype=float)
        if self.thetatheta_proc == "thin":
            missing = [k for k in ("arclet_lim", "center_cut")
                       if k not in state]
            if missing:
                raise KeyError(f"thin reference state lacks {missing}")
            self.arclet_lim = float(state["arclet_lim"])
            self.center_cut = float(state["center_cut"])
        self.name = state.get("name", "reference")
        return self

    # ------------------------------------------------------------------
    # loading and writing
    # ------------------------------------------------------------------
    def load_file(self, filename, verbose=True, process=False,
                  lamsteps=False, remove_short_subs=True, subint_thresh=2.33,
                  mjd=None):
        """Load a psrflux file (host numpy); drop short leading subints
        when the subint spacing varies; with ``process``, run
        :meth:`auto_processing`."""
        ds = load_psrflux(filename, mjd=mjd)
        self._adopt(ds)
        if remove_short_subs and np.std(np.diff(self.times)) != 0:
            self.remove_short_subs(threshold=subint_thresh)
        self.lamsteps = lamsteps
        if process:
            self.auto_processing(lamsteps=lamsteps)
        if verbose:
            print(f"LOADED {filename}")
            self.info()

    def load_dyn_obj(self, dyn, verbose=True, process=True, lamsteps=False):
        """Load from an adapter object such as :class:`BasicDyn`; with
        ``process`` (the default here, as in the reference), run
        :meth:`default_processing`."""
        self.name = dyn.name
        self.header = list(getattr(dyn, "header", []))
        self.times = np.asarray(dyn.times, dtype=float)
        self.freqs = np.asarray(dyn.freqs, dtype=float)
        self.nchan = dyn.nchan
        self.nsub = dyn.nsub
        self.bw = dyn.bw
        self.df = dyn.df
        self.freq = dyn.freq
        self.dt = dyn.dt
        self.tobs = (dyn.tobs if dyn.tobs is not None
                     else np.ptp(self.times) + self.dt)
        self.mjd = dyn.mjd if dyn.mjd is not None else 60000.0
        self.dyn = np.array(dyn.dyn, dtype=float)
        self.filename = getattr(dyn, "filename", None)
        self.lamsteps = lamsteps
        if process:
            self.default_processing(lamsteps=lamsteps)
        if verbose:
            print(f"LOADED DYNSPEC OBJECT {dyn.name}")
            self.info()

    def _adopt(self, ds):
        self.name = ds.name
        self.header = list(ds.header)
        self.times = np.asarray(ds.times, dtype=float)
        self.freqs = np.asarray(ds.freqs, dtype=float)
        self.nchan = ds.nchan
        self.nsub = ds.nsub
        self.bw = ds.bw
        self.df = ds.df
        self.freq = ds.freq
        self.dt = ds.dt
        self.tobs = ds.tobs
        self.mjd = ds.mjd
        self.dyn = np.array(ds.dyn, dtype=float)
        self.filename = ds.filename

    def _as_raw(self):
        return RawDynSpec(dyn=self.dyn, times=self.times, freqs=self.freqs,
                          mjd=self.mjd, name=self.name, header=self.header,
                          dt=self.dt, df=self.df, bw=self.bw,
                          freq=self.freq, tobs=self.tobs)

    def write_file(self, filename=None, verbose=True, note=None):
        """Write a psrflux file (by default beside the loaded one, as
        ``<name>.processed.<ext>``)."""
        if filename is None:
            ext = self.filename.split(".")[-1]
            filename = (".".join(self.filename.split(".")[:-1])
                        + ".processed." + ext)
        write_psrflux(self._as_raw(), filename, note=note)
        if verbose:
            print(f"Wrote dynamic spectrum file as {filename}")

    def __add__(self, other):
        """Time-concatenate, zero-filling the MJD gap; the sum lives on
        this instance's device."""
        cat = concatenate_time(self._as_raw(), other._as_raw())
        return Dynspec(dyn=BasicDyn(
            cat.dyn, name=cat.name, header=cat.header, times=cat.times,
            freqs=cat.freqs, nchan=cat.nchan, nsub=cat.nsub, bw=cat.bw,
            df=cat.df, freq=cat.freq, tobs=cat.tobs, dt=cat.dt,
            mjd=cat.mjd), verbose=False, process=False, device=self.device)

    # ------------------------------------------------------------------
    # processing (host numpy, as in the JAX package; the median refill
    # sorts on the device)
    # ------------------------------------------------------------------
    def remove_short_subs(self, threshold=2.33):
        """Remove short leading subints."""
        diffs = np.abs(np.diff(self.times))
        while (len(diffs) > 1
               and diffs[0] - np.mean(diffs[1:])
               <= -threshold * np.std(diffs[1:])
               and np.std(diffs[1:]) >= 0
               and diffs[0] != np.mean(diffs[1:])):
            self.dyn = np.delete(self.dyn, 0, axis=1)
            self.times = np.delete(self.times, 0)
            diffs = np.abs(np.diff(self.times))
        self.mjd += np.min(self.times) / 86400
        self.times = self.times - np.min(self.times)
        self.nsub = len(self.times)
        self.dt = round(float(np.mean(np.diff(self.times))), 3)
        self.tobs = round(float(max(self.times) + self.dt), 3)

    def trim_edges(self, bandwagon_frac=0.5, remove_short_sub=True):
        """Trim all-zero band and time edges; an edge row more than
        ``bandwagon_frac`` zeros is zeroed first. ``remove_short_sub`` is
        accepted and unused, as in the reference."""
        self.dyn = np.nan_to_num(self.dyn)

        def zap_edge_rows(dyn, idx, frac, axis):
            line = dyn[idx, :] if axis == 0 else dyn[:, idx]
            if np.sum(line == 0) > frac * line.size:
                if axis == 0:
                    dyn[idx, :] = 0
                else:
                    dyn[:, idx] = 0
            return dyn

        for axis, trim, n in ((0, self._trim_freq, lambda: self.dyn.shape[0]),
                              (1, self._trim_time, lambda: self.dyn.shape[1])):
            for idx in (0, -1):
                self.dyn = zap_edge_rows(self.dyn, idx, bandwagon_frac, axis)
                while n() > 1 and np.sum(np.abs(
                        self.dyn[idx, :] if axis == 0
                        else self.dyn[:, idx])) == 0:
                    trim(idx)
                    self.dyn = zap_edge_rows(self.dyn, idx, bandwagon_frac,
                                             axis)

        self.mjd += np.min(self.times) / 86400
        self.times = self.times - np.min(self.times)
        self.nchan = len(self.freqs)
        self.bw = round(float(max(self.freqs) - min(self.freqs)
                              + self.df), 3)
        self.freq = round(float(np.mean(self.freqs)), 3)
        self.nsub = len(self.times)
        self.dt = round(float(np.mean(np.diff(self.times))), 3)
        self.tobs = round(float(max(self.times) + self.dt), 3)
        self.df = self.bw / self.nchan

    def _trim_freq(self, idx):
        self.dyn = np.delete(self.dyn, idx, axis=0)
        self.freqs = np.delete(self.freqs, idx)

    def _trim_time(self, idx):
        self.dyn = np.delete(self.dyn, idx, axis=1)
        self.times = np.delete(self.times, idx)

    def crop_dyn(self, fmin=0, fmax=np.inf, tmin=0, tmax=np.inf):
        """Crop in frequency (MHz) and time (minutes)."""
        keep = (self.freqs >= fmin) & (self.freqs <= fmax)
        self.dyn = self.dyn[keep, :]
        self.freqs = self.freqs[keep]
        self.nchan = len(self.freqs)
        self.bw = round(float(max(self.freqs) - min(self.freqs)
                              + self.df), 2)
        self.freq = round(float(np.mean(self.freqs)), 2)

        tmin, tmax = tmin * 60, tmax * 60
        if tmax < self.tobs:
            self.tobs = tmax - tmin
        else:
            self.tobs = self.tobs - tmin
        keep = (self.times >= tmin) & (self.times <= tmax)
        self.dyn = self.dyn[:, keep]
        self.nsub = self.dyn.shape[1]
        self.times = self.times[keep]
        self.mjd += np.min(self.times) / 86400
        self.times = self.times - np.min(self.times)

    def zap(self, sigma=7):
        """Set to NaN the pixels more than ``sigma`` median absolute
        deviations from the median."""
        d = np.abs(self.dyn - np.median(self.dyn[~np.isnan(self.dyn)]))
        mdev = np.median(d[~np.isnan(d)])
        s = d / mdev
        self.dyn[s > sigma] = np.nan

    def refill(self, method="biharmonic", zeros=True, kernel_size=5,
               linear=True):
        """Fill the NaNs (and, with ``zeros``, every exact zero):
        ``"biharmonic"`` by a sparse biharmonic solve, ``"median"`` by
        the kernel median (sorted on ``self.device``), ``"linear"``,
        ``"cubic"`` or ``"nearest"`` by ``griddata`` (with ``linear``);
        what is left takes the mean of the valid pixels."""
        if zeros:
            self.dyn[self.dyn == 0] = np.nan
        if method == "biharmonic":
            nanmask = np.isnan(self.dyn)
            if nanmask.any():
                filled = inpaint_ops.inpaint_biharmonic(self.dyn, nanmask)
                self.dyn[nanmask] = filled[nanmask]
        elif method == "median":
            self.dyn = inpaint_ops.refill_median(
                self.dyn, kernel_size=kernel_size, device=self.device)
        elif method in ("linear", "cubic", "nearest") and linear:
            self.dyn = interp_nan_2d(self.dyn, method=method)
        meanval = np.mean(self.dyn[is_valid(self.dyn)])
        self.dyn[np.isnan(self.dyn)] = meanval

    def correct_dyn(self, svd=True, nmodes=1, frequency=True, time=True,
                    lamsteps=False, nsmooth=None, velocity=False):
        """Flux correction on the host: divide out the rank-``nmodes``
        SVD model (``self.svd_model_arr``), or the mean bandpass and
        time profile (``savgol``-smoothed over ``nsmooth``). It corrects
        ``self.dyn``, or with ``lamsteps`` ``self.lamdyn``, with
        ``velocity`` ``self.vdyn`` (both: ``self.vlamdyn``; a velocity
        spectrum must come from :meth:`scale_dyn` first)."""
        from scipy.signal import savgol_filter

        if hasattr(self, "svd_model_arr"):
            print("Warning: An svd_model exists. "
                  "Check before applying twice")
        name = ("v" if velocity else "") + ("lamdyn" if lamsteps else "dyn")
        if velocity and not hasattr(self, name):
            raise ValueError("Need to run scale_dyn with a model")
        if name == "lamdyn" and not hasattr(self, "lamdyn"):
            self.scale_dyn(lamsteps=True)
        dyn = getattr(self, name)

        dyn = np.nan_to_num(dyn)
        if svd:
            dyn, model = svd_model(dyn, nmodes=nmodes)
            self.svd_model_arr = model
        else:
            if frequency:
                bandpass = np.nanmean(np.where(dyn == 0, np.nan, dyn),
                                      axis=1)
                bandpass[bandpass == 0] = np.mean(bandpass)
                self.bandpass = bandpass
                if nsmooth is not None:
                    bandpass = savgol_filter(bandpass, nsmooth, 1)
                dyn = dyn / bandpass[:, None]
            if time:
                tprof = np.nanmean(np.where(dyn == 0, np.nan, dyn), axis=0)
                tprof[tprof == 0] = np.mean(tprof)
                if nsmooth is not None:
                    tprof = savgol_filter(tprof, nsmooth, 1)
                dyn = dyn / tprof[None, :]
            dyn = np.nan_to_num(dyn)
        setattr(self, name, dyn)

    # ------------------------------------------------------------------
    # rescaling and spectra
    # ------------------------------------------------------------------
    def scale_dyn(self, scale="lambda", window_frac=0.1, pars=None,
                  parfile=None, window="hanning", spacing="auto", s=None,
                  d=None, vism_ra=None, vism_dec=None, Omega=None, inc=None,
                  vism_zeta=None, zeta=None, lamsteps=False, velocity=False,
                  trap=False):
        """Resample the spectrum; ``scale`` may name several grids.

        - ``"lambda"``/``"wavelength"`` (or ``lamsteps``): an
          equal-wavelength grid on the host (``self.lamdyn``,
          ``self.lam``, ``self.dlam``, ``self.nlam``);
        - ``"velocity"``/``"orbit"`` (or ``velocity``): an equal
          cumulative-|veff| time grid on the host (``self.vdyn``, and
          ``self.vlamdyn`` when ``self.lamdyn`` exists). ``pars`` (a
          dict) or ``parfile`` gives the pulsar; the subint MJDs
          (``self.mjd`` + times, kept in float64 as a split epoch) are
          moved to the barycentre by the Roemer delay, then the Earth's
          velocity, the orbit's true anomaly and
          ``effective_velocity_annual`` give ``self.veff_ra`` and
          ``self.veff_dec`` [km/s], less the screen's ``vism_ra``/
          ``vism_dec``, or projected on ``zeta`` [deg] less
          ``vism_zeta``. ``s``, ``d``, ``inc`` and ``Omega`` fill a
          missing s, d, KIN, KOM;
        - ``"trap"`` (or ``trap``): the trapezoid grid on
          ``self.device`` (``self.trapdyn``), windowed by ``window`` over
          ``window_frac``."""
        if "lambda" in scale or "wavelength" in scale or lamsteps:
            self.lamdyn, self.lam, self.dlam = scale_ops.lambda_rescale(
                self.dyn, self.freqs, spacing=spacing)
            self.nlam = len(self.lam)

        if "velocity" in scale or "orbit" in scale or velocity:
            self._velocity_rescale(pars, parfile, s, d, vism_ra, vism_dec,
                                   Omega, inc, vism_zeta, zeta)

        if "trap" in scale or trap:
            self.trapdyn = scale_ops.trapezoid_rescale(
                self.dyn, self.times, self.freqs, window=window,
                window_frac=window_frac, device=self.device)

    def _velocity_rescale(self, pars, parfile, s, d, vism_ra, vism_dec,
                          Omega, inc, vism_zeta, zeta):
        from .io.parfile import read_par
        from .utils.ephemeris import get_earth_velocity, get_ssb_delay
        from .utils.orbit import get_true_anomaly

        if pars is None and parfile is None:
            raise ValueError("Requires dictionary of parameters or "
                             ".par file for velocity calculation")
        if parfile is not None:
            pars = read_par(parfile)
        pars = dict(pars)

        # split-epoch MJD arithmetic keeps barycentric precision in
        # float64
        mjd = np.asarray(self.mjd, dtype=float) + self.times / 86400
        mjd = mjd + np.asarray(get_ssb_delay(mjd, pars["RAJ"],
                                             pars["DECJ"])) / 86400
        vearth_ra, vearth_dec = get_earth_velocity(mjd, pars["RAJ"],
                                                   pars["DECJ"])
        true_anomaly = get_true_anomaly(mjd, pars)
        for key, val, msg in (("s", s, "screen distance s"),
                              ("d", d, "pulsar distance d"),
                              ("KIN", inc, "inclination angle (KIN)"),
                              ("KOM", Omega, "ascending node (KOM)")):
            if key not in pars:
                if val is None:
                    raise ValueError(f"Requires {msg} in parameter "
                                     "dictionary, or as input")
                pars[key] = val

        veff_ra, veff_dec, _, _ = mdl.effective_velocity_annual(
            pars, true_anomaly, vearth_ra, vearth_dec, mjd=mjd)

        def screen(key, val):
            return pars.get(key, val if val is not None else 0)

        if "zeta" in pars or zeta is not None:
            zeta_v = pars.get("zeta", zeta) * np.pi / 180
            vz = pars.get("vism_zeta", vism_zeta)
            if vz is not None:
                veff2 = (veff_ra * np.sin(zeta_v)
                         + veff_dec * np.cos(zeta_v) - vz) ** 2
            else:
                veff_ra = veff_ra - screen("vism_ra", vism_ra)
                veff_dec = veff_dec - screen("vism_dec", vism_dec)
                veff2 = (veff_ra * np.sin(zeta_v)
                         + veff_dec * np.cos(zeta_v)) ** 2
        else:
            veff_ra = veff_ra - screen("vism_ra", vism_ra)
            veff_dec = veff_dec - screen("vism_dec", vism_dec)
            veff2 = veff_ra ** 2 + veff_dec ** 2

        veff = np.sqrt(veff2)
        self.veff_ra = veff_ra
        self.veff_dec = veff_dec
        self.vdyn = scale_ops.velocity_rescale(self.dyn, veff)
        if hasattr(self, "lamdyn"):
            self.vlamdyn = scale_ops.velocity_rescale(self.lamdyn, veff)

    def _select_dyn(self, lamsteps=False, velocity=False, trap=False):
        if lamsteps:
            if not hasattr(self, "lamdyn"):
                self.scale_dyn()
            if velocity:
                if not hasattr(self, "vlamdyn"):
                    self.scale_dyn(scale="velocity")
                return self.vlamdyn
            return self.lamdyn
        if velocity:
            if not hasattr(self, "vdyn"):
                self.scale_dyn(scale="velocity")
            return self.vdyn
        if trap:
            if not hasattr(self, "trapdyn"):
                self.scale_dyn(scale="trapezoid")
            return self.trapdyn
        return self.dyn

    def calc_sspec(self, prewhite=False, halve=True, plot=False,
                   lamsteps=False, input_dyn=None, input_x=None,
                   input_y=None, trap=False, window="hanning",
                   window_frac=0.1, return_sspec=False, velocity=False):
        """Secondary spectrum in dB, computed on ``self.device``:
        ``self.sspec`` (``self.lamsspec`` and the β axis ``self.beta``
        with ``lamsteps``; ``self.vsspec``, ``self.vlamsspec`` or
        ``self.trapsspec`` of the velocity or trapezoid spectra with
        ``velocity`` or ``trap``), ``self.fdop`` and ``self.tdel``. With
        ``input_dyn`` (a spectrum of its own) or ``return_sspec`` nothing
        is stored and ``(fdop, tdel or beta, sec)`` is returned. ``plot``
        draws the spectrum (:meth:`plot_sspec`; ``input_x`` and
        ``input_y`` label its axes when given)."""
        if input_dyn is None:
            dyn = self._select_dyn(lamsteps=lamsteps, velocity=velocity,
                                   trap=trap)
        else:
            dyn = input_dyn
        dlam = self.dlam if lamsteps else None
        fdop, _, sec = sspec_ops.secondary_spectrum(
            dyn, self.dt, self.df, window=window, window_frac=window_frac,
            prewhite=prewhite, halve=halve, dlam=dlam, device=self.device)
        sec = sec.cpu().numpy()
        nf, nt = np.shape(dyn)
        _, tdel, beta = sspec_ops.sspec_axes(nf, nt, self.dt, self.df,
                                             halve=halve, dlam=dlam)
        if input_dyn is not None or return_sspec:
            if plot:
                self.plot_sspec(input_sspec=sec, lamsteps=lamsteps,
                                input_x=(input_x if input_x is not None
                                         else fdop),
                                input_y=(input_y if input_y is not None
                                         else (beta if lamsteps
                                               else tdel)))
            return fdop, (beta if lamsteps else tdel), sec
        self.fdop, self.tdel = fdop, tdel
        if lamsteps:
            self.beta = beta
        name = ("vlamsspec" if velocity else "lamsspec") if lamsteps else (
            "vsspec" if velocity else "trapsspec" if trap else "sspec")
        setattr(self, name, sec)
        if plot:
            self.plot_sspec(lamsteps=lamsteps, trap=trap)

    def calc_acf(self, method="direct", input_dyn=None, normalise=True,
                 window_frac=0.1):
        """2-D autocovariance on ``self.device``: ``"direct"`` of
        ``self.dyn`` (or ``input_dyn``, whose ACF is returned and not
        stored) by the real Wiener–Khinchin round trip, ``"sspec"`` from
        the full-frame secondary spectrum. Sets ``self.acf``."""
        if method == "direct":
            dyn = self.dyn if input_dyn is None else input_dyn
            arr = acf_ops.autocovariance(np.asarray(dyn, dtype=float),
                                         normalise=normalise,
                                         device=self.device)
        elif method == "sspec":
            _, _, ss = self.calc_sspec(prewhite=False, halve=False,
                                       return_sspec=True,
                                       window_frac=window_frac)
            arr = acf_ops.acf_from_sspec(ss, normalise=normalise,
                                         device=self.device)
        else:
            raise ValueError(
                'Method not understood. Choose "direct" or "sspec"')
        arr = arr.cpu().numpy()
        if input_dyn is not None:
            return arr
        self.acf = arr

    def cut_dyn(self, tcuts=0, fcuts=0, plot=False, filename=None, dpi=200,
                lamsteps=False, maxfdop=np.inf, figsize=(8, 13),
                display=True):
        """Tile the spectrum into (fcuts + 1) × (tcuts + 1) pieces with
        each tile's secondary spectrum and ACF: ``self.cutdyn``,
        ``self.cutsspec``, ``self.cutacf``, the tiles' axes
        ``self.cut_times``, ``self.cut_freqs`` and the spectra's axes
        ``self.cut_sspec_x``, ``self.cut_sspec_y``. ``plot`` draws the
        tiles' spectra, ACFs and secondary spectra
        (:func:`.plotting.plot_cut_tiles`; ``filename``, ``dpi``,
        ``maxfdop``, ``figsize`` and ``display`` configure it)."""
        nchan, nsub = len(self.freqs), len(self.times)
        fnum = int(np.floor(nchan / (fcuts + 1)))
        tnum = int(np.floor(nsub / (tcuts + 1)))
        cutdyn = np.empty((fcuts + 1, tcuts + 1, fnum, tnum))
        nrfft = int(2 ** (np.ceil(np.log2(fnum)) + 1) / 2)
        ncfft = int(2 ** (np.ceil(np.log2(tnum)) + 1))
        cutsspec = np.empty((fcuts + 1, tcuts + 1, nrfft, ncfft))
        cutacf = np.empty((fcuts + 1, tcuts + 1, 2 * fnum, 2 * tnum))
        sspec_x = sspec_y = None
        for ii in range(fcuts + 1):
            for jj in range(tcuts + 1):
                tile = self.dyn[ii * fnum:(ii + 1) * fnum,
                                jj * tnum:(jj + 1) * tnum]
                cutdyn[ii][jj] = tile
                sspec_x, sspec_y, cutsspec[ii][jj] = self.calc_sspec(
                    input_dyn=tile, lamsteps=lamsteps)
                cutacf[ii][jj] = self.calc_acf(input_dyn=tile)
        self.cutdyn = cutdyn
        self.cutsspec = cutsspec
        self.cutacf = cutacf
        self.cut_times = [self.times[jj * tnum:(jj + 1) * tnum]
                          for jj in range(tcuts + 1)]
        self.cut_freqs = [self.freqs[ii * fnum:(ii + 1) * fnum]
                          for ii in range(fcuts + 1)]
        self.cut_sspec_x = np.asarray(sspec_x)
        self.cut_sspec_y = np.asarray(sspec_y)
        if plot:
            from . import plotting

            plotting.plot_cut_tiles(self, lamsteps=lamsteps,
                                    maxfdop=maxfdop, filename=filename,
                                    display=display, figsize=figsize,
                                    dpi=dpi)

    # ------------------------------------------------------------------
    # arc curvature
    # ------------------------------------------------------------------
    def _select_sspec(self, lamsteps=False, velocity=False, trap=False):
        if lamsteps:
            name = "vlamsspec" if velocity else "lamsspec"
            if not hasattr(self, name):
                self.calc_sspec(lamsteps=True, velocity=velocity)
            return np.array(getattr(self, name)), np.array(self.beta)
        name = "vsspec" if velocity else "trapsspec" if trap else "sspec"
        if not hasattr(self, name):
            self.calc_sspec(velocity=velocity, trap=trap)
        return np.array(getattr(self, name)), np.array(self.tdel)

    def fit_arc(self, asymm=False, plot=False, delmax=None, numsteps=1e4,
                startbin=3, cutmid=3, lamsteps=False, etamax=None,
                etamin=None, low_power_diff=-1, high_power_diff=-0.5,
                ref_freq=1400, constraint=(0, np.inf), nsmooth=5, efac=1,
                filename=None, noise_error=True, display=True,
                log_parabola=False, logsteps=False, plot_spec=False,
                fit_spectrum=False, subtract_artefacts=False, velocity=False,
                weighted=False, figsize=(9, 9), dpi=200, figN=None):
        """Arc-curvature measurement: ``self.betaeta`` (``lamsteps``) or
        ``self.eta``, their errors, the profile and its η grid. Explicit
        ``etamin``/``etamax``/``constraint`` in the non-lamsteps path are
        β values at ``ref_freq``, converted to η [s³] at this spectrum's
        frequency. ``plot_spec`` draws the normalised spectrum at the
        fitted curvature (:meth:`norm_sspec`), ``plot`` the fit
        (:func:`.plotting.plot_arc_fit`; ``filename``, ``display``,
        ``figsize``, ``dpi`` and ``figN`` configure it)."""
        if not hasattr(self, "tdel"):
            self.calc_sspec()
        sspec, yaxis = self._select_sspec(lamsteps=lamsteps,
                                          velocity=velocity)
        delmax_t = np.max(self.tdel) if delmax is None else delmax
        # the crop index is defined on the tdel axis; translate to yaxis
        ind = int(np.argmin(np.abs(self.tdel - delmax_t)))
        ymax_cut = yaxis[min(ind, len(yaxis) - 1)]

        if not lamsteps:
            beta_to_eta = SPEED_OF_LIGHT * 1e6 / (ref_freq * 1e6) ** 2
            fcorr = (self.freq / ref_freq) ** 2

            def b2e(x):
                return None if x is None else \
                    np.asarray(x) / fcorr * beta_to_eta

            etamax = b2e(etamax)
            etamin = b2e(etamin)
            constraint = np.asarray(constraint) / fcorr * beta_to_eta

        fits = fitarc_ops.fit_arc(
            sspec, yaxis, self.fdop, asymm=asymm, delmax=ymax_cut,
            numsteps=numsteps, startbin=startbin, cutmid=cutmid,
            etamax=etamax, etamin=etamin, low_power_diff=low_power_diff,
            high_power_diff=high_power_diff, constraint=constraint,
            nsmooth=nsmooth, efac=efac, noise_error=noise_error,
            log_parabola=log_parabola, logsteps=logsteps,
            fit_spectrum=fit_spectrum,
            subtract_artefacts=subtract_artefacts, weighted=weighted,
            device=self.device)

        self.noise = fits[0].noise
        self.norm_delmax = delmax_t
        for fit, side in zip(fits, ["left", "right"] if asymm else [""]):
            sfx = f"_{side}" if side else ""
            pre = "betaeta" if lamsteps else "eta"
            setattr(self, pre + sfx, fit.eta)
            setattr(self, pre + "err" + sfx, fit.etaerr)
            setattr(self, pre + "err2" + sfx, fit.etaerr2)
            num = {"left": "1", "right": "2", "": ""}[side]
            setattr(self, "norm_sspec_avg" + num, fit.profile)
            setattr(self, "prob_eta_peak" + num, fit.prob_eta_peak)
        self.eta_array = fits[0].eta_array
        if plot_spec:
            # norm_sspec takes an explicit η of the non-lamsteps path as a
            # β value at ref_freq: convert the fitted η back to that form
            eta_plot = fits[0].eta
            if not lamsteps:
                eta_plot = (eta_plot * (self.freq / ref_freq) ** 2
                            / (SPEED_OF_LIGHT * 1e6 / (ref_freq * 1e6) ** 2))
            self.norm_sspec(eta=eta_plot, delmax=delmax_t, plot=True,
                            lamsteps=lamsteps, ref_freq=ref_freq,
                            display=display)
        if plot:
            from . import plotting

            plotting.plot_arc_fit(fits[0], lamsteps=lamsteps,
                                  filename=filename, display=display,
                                  figsize=figsize, dpi=dpi, figN=figN)
        return fits

    def norm_sspec(self, eta=None, delmax=None, plot=False, startbin=1,
                   maxnormfac=5, minnormfac=0, cutmid=0, lamsteps=True,
                   scrunched=True, plot_fit=True, ref_freq=1400,
                   velocity=False, numsteps=None, filename=None,
                   display=True, weighted=True, unscrunched=True,
                   logsteps=False, powerspec=True, interp_nan=False,
                   fit_spectrum=False, powerspec_cut=False, figsize=(9, 9),
                   subtract_artefacts=False, dpi=200):
        """Normalise the Doppler axis by the arc at ``eta`` (fitted by
        :meth:`fit_arc` when None; in the non-lamsteps path an explicit
        ``eta`` is a β value at ``ref_freq``). Sets ``self.normsspecavg``,
        ``self.normsspec`` (masked), ``self.powerspectrum``, … and returns
        the :class:`~.ops.normsspec.NormSspec`. ``plot`` draws its panels
        (:func:`.plotting.plot_norm_sspec`; ``scrunched``, ``plot_fit``,
        ``filename``, ``display``, ``unscrunched``, ``powerspec``,
        ``figsize`` and ``dpi`` configure it)."""
        if not hasattr(self, "tdel"):
            self.calc_sspec()
        sspec, yaxis = self._select_sspec(lamsteps=lamsteps,
                                          velocity=velocity)
        if eta is None:
            name = "betaeta" if lamsteps else "eta"
            if not hasattr(self, name):
                self.fit_arc(lamsteps=lamsteps, delmax=delmax,
                             startbin=startbin, velocity=velocity)
            eta = getattr(self, name)
        elif not lamsteps:
            beta_to_eta = SPEED_OF_LIGHT * 1e6 / (ref_freq * 1e6) ** 2
            eta = eta / (self.freq / ref_freq) ** 2 * beta_to_eta

        delmax_t = np.max(self.tdel) if delmax is None else delmax
        ind = int(np.argmin(np.abs(self.tdel - delmax_t)))
        ymax_cut = yaxis[min(ind, len(yaxis) - 1)]
        ns = normsspec_ops.normalise_sspec(
            sspec, yaxis, self.fdop, eta, delmax=ymax_cut,
            startbin=startbin, maxnormfac=maxnormfac, minnormfac=minnormfac,
            cutmid=cutmid, numsteps=numsteps, logsteps=logsteps,
            weighted=weighted, interp_nan=interp_nan,
            fit_spectrum=fit_spectrum, powerspec_cut=powerspec_cut,
            subtract_artefacts=subtract_artefacts, device=self.device)
        self.normsspecavg = ns.normsspecavg
        self.normsspec = np.ma.array(ns.normsspec, mask=ns.mask)
        self.normsspec_tdel = ns.tdel
        self.normsspec_fdop = ns.fdop
        self.powerspectrum = ns.powerspectrum
        self.mask = ns.mask
        self.weights = ns.weights
        for attr in ("ps_wn", "ps_amp", "ps_alpha", "ps_wn_err",
                     "ps_amp_err", "ps_alpha_err"):
            val = getattr(ns, attr)
            if val is not None:
                setattr(self, attr, val)
        if plot:
            from . import plotting

            plotting.plot_norm_sspec(self, scrunched=scrunched,
                                     unscrunched=unscrunched,
                                     powerspec=powerspec, plot_fit=plot_fit,
                                     maxnormfac=maxnormfac, lamsteps=lamsteps,
                                     filename=filename, display=display,
                                     figsize=figsize, dpi=dpi)
        return ns

    # ------------------------------------------------------------------
    # scintillation parameters
    # ------------------------------------------------------------------
    def get_scint_params(self, method="acf1d", plot=False, alpha=5 / 3,
                         mcmc=False, full_frame=False, nscale=5,
                         nwalkers=50, steps=10000, burn=0.25, nitr=1,
                         lnsigma=True, verbose=False, progress=True,
                         display=True, filename=None, dpi=200,
                         nan_policy="raise", weighted=True, workers=1,
                         tau_vary_2d=True, tau_input=None, bartlett=True,
                         get_fit_report=True, precision=None):
        """Scintillation timescale and bandwidth from the ACF
        (``self.acf``, computed first when missing): ``self.tau``,
        ``self.dnu``, ``self.amp``, their errors with the finite-scintle
        terms, ``self.tscat``, ``self.nscint``, the no-fit estimates
        (``dnu_est``, ``modulation_index``, …), and for the 2-D methods
        ``self.acf_model`` and ``self.phasegrad`` (with ``ar``, ``theta``
        and ``psi`` for ``"acf2d"``). Returns the fit's
        :class:`~.fit.fitter.MinimizerResult` (None for ``"nofit"``).

        ``"acf1d"`` and ``"acf2d_approx"`` are scipy fits on the host.
        ``"acf2d"`` fits the analytic ACF on ``self.device``: the batched
        LM (:func:`~.fit.acf2d.fit_acf2d`, ``precision`` its policy) for
        an odd crop, else ``nitr`` scipy fits over the model.

        ``method="mcmc"`` samples the acf1d likelihood with the ensemble
        sampler on ``self.device`` (``fitter(mcmc=True)``, ``nwalkers``,
        ``steps``, ``burn``, ``progress``) and stores the posterior's
        summary per parameter in ``self.mcmc_summary``. ``mcmc=True``
        samples every fit of the method instead of the least squares;
        the 2-D fits then sample the ``__lnsigma`` noise term unless
        ``lnsigma=False``, and ``"acf2d"`` samples the analytic model
        (never the LM). ``"sspec"`` raises. ``plot`` draws the fit
        (:func:`.plotting.plot_scint_fit_1d` or ``_2d``; ``display``,
        ``filename`` and ``dpi`` configure it; ``workers`` is the scipy
        fit's)."""
        methods = ("nofit", "acf1d", "acf2d_approx", "acf2d", "sspec",
                   "mcmc")
        if method not in methods:
            raise ValueError(f"method must be one of {methods}, "
                             f"got {method!r}")
        if method == "sspec":
            raise NotImplementedError(
                "the sspec fitting method is disabled upstream")
        if not hasattr(self, "acf"):
            self.calc_acf()

        nf, nt = np.shape(self.acf)
        ydata_f = self.acf[nf // 2:, nt // 2]
        xdata_f = self.df * np.arange(len(ydata_f))
        ydata_t = self.acf[nf // 2, nt // 2:]
        xdata_t = self.dt * np.arange(len(ydata_t))

        # initial guesses
        wn = min(ydata_f[0] - ydata_f[1], ydata_t[0] - ydata_t[1])
        amp = max(ydata_f[0] - wn, ydata_t[0] - wn)
        below_t = np.flatnonzero(ydata_t < amp / np.e)
        if below_t.size == 0:
            tau = self.dt if ydata_t[1] < 0 else self.tobs
        else:
            tau = xdata_t[below_t[0]]
        below_f = np.flatnonzero(ydata_f < amp / 2)
        if below_f.size == 0:
            dnu = self.df if ydata_f[1] < 0 else self.bw
        else:
            dnu = xdata_f[below_f[0]]

        if not full_frame:
            t_sel = xdata_t <= max(nscale * tau, 5 * self.dt)
            f_sel = xdata_f <= max(nscale * dnu, 5 * self.df)
            xdata_t, ydata_t = xdata_t[t_sel], ydata_t[t_sel]
            xdata_f, ydata_f = xdata_f[f_sel], ydata_f[f_sel]

        # no-fit estimates
        self.tau, self.dnu, self.amp, self.wn = tau, dnu, amp, wn
        tau_half = xdata_t[np.argmin(np.abs(ydata_t - amp / 2))]
        tau_half = np.clip(tau_half, self.dt, self.tobs)
        nscint = ((1 + 0.2 * self.bw / dnu)
                  * (1 + 0.2 * self.tobs / tau_half))
        self.dnuerr = dnu / np.sqrt(nscint)
        self.tauerr = tau / np.sqrt(nscint)
        self.amperr = amp / np.sqrt(nscint)
        self.wnerr = wn / np.sqrt(nscint)
        self.tscat = 1 / (2 * np.pi * dnu)
        self.nscint = nscint
        self.scint_param_method = "nofit"

        valid = is_valid(self.dyn) & (self.dyn != 0)
        mean = np.mean(self.dyn[valid])
        flux_var = np.var(self.dyn[valid])
        self.dnu_est = max(self.df * (flux_var / mean ** 2 - 1), 0)
        self.dnu_esterr = self.dnu_est / np.sqrt(nscint)
        self.tscat_est = (1 / (2 * np.pi * self.dnu_est)
                          if self.dnu_est > 0 else 0)
        self.modulation_index = np.sqrt(flux_var) / mean

        if method == "nofit":
            return None

        params = Parameters()
        params.add("tau", value=tau, vary=True, min=0, max=np.inf)
        params.add("dnu", value=dnu, vary=True, min=0, max=np.inf)
        params.add("amp", value=amp, vary=True, min=0, max=np.inf)
        if alpha is None:
            params.add("alpha", value=5 / 3, vary=True)
        else:
            params.add("alpha", value=alpha, vary=False)
        params.add("nt", value=nt, vary=False)
        params.add("nf", value=nf, vary=False)

        # Bartlett-formula ACF error weights
        t_errors = np.ones(np.shape(xdata_t)) / np.sqrt(nt / 2)
        t_errors[0] = 1e-3
        f_errors = np.ones(np.shape(xdata_f)) / np.sqrt(nf / 2)
        f_errors[0] = 1e-3
        if bartlett:
            var_t = np.ones(np.shape(ydata_t)) / (nt / 2)
            var_t[0] = 1e-10
            var_t[2:] *= 1 + 2 * np.cumsum(ydata_t[1:-1] ** 2)
            t_errors = np.sqrt(var_t)
            var_f = np.ones(np.shape(ydata_f)) / (nf / 2)
            var_f[0] = 1e-10
            var_f[2:] *= 1 + 2 * np.cumsum(ydata_f[1:-1] ** 2)
            f_errors = np.sqrt(var_f)
        weights_t = 1 / t_errors if weighted else None
        weights_f = 1 / f_errors if weighted else None

        results = fitter(
            mdl.scint_acf_model, params,
            ((xdata_t, xdata_f), (ydata_t, ydata_f),
             (weights_t, weights_f)), max_nfev=50000,
            nan_policy=nan_policy, mcmc=(mcmc or method == "mcmc"),
            nwalkers=nwalkers, steps=steps, burn=burn, progress=progress,
            device=self.device)
        if method == "mcmc" \
                and getattr(results, "flatchain", None) is not None:
            from .mcmc.posterior import flatchain_summary

            self.mcmc_summary = flatchain_summary(
                results.flatchain, getattr(results, "var_names",
                                           params.varying_names()))
        if results.params["dnu"].stderr is not None:
            for k in ("tau", "dnu", "amp"):
                params[k].value = results.params[k].value

        tdata = fdata = ydata_2d = None
        if method in ("acf2d_approx", "acf2d"):
            params["tau"].vary = tau_vary_2d
            if tau_input is not None:
                params["tau"].value = tau_input

            tticks = np.linspace(-self.tobs, self.tobs, nt + 1)[:-1]
            fticks = np.linspace(-self.bw, self.bw, nf + 1)[:-1]
            T, F = np.meshgrid(self.tobs - abs(tticks),
                               self.bw - abs(fticks))
            N2d = (self.nsub * self.nchan * (T / max(tticks))
                   * (F / max(fticks)))
            with np.errstate(divide="ignore", invalid="ignore"):
                errors_2d = 1 / np.sqrt(N2d)
            errors_2d[~is_valid(errors_2d)] = np.inf
            weights_2d = np.ones(np.shape(self.acf))
            if weighted:
                weights_2d = weights_2d / errors_2d

            # centre on the white-noise spike
            wn_loc = np.unravel_index(np.argmax(self.acf), self.acf.shape)
            fhalf = min(wn_loc[0], nf - wn_loc[0] - 1)
            thalf = min(wn_loc[1], nt - wn_loc[1] - 1)
            fmin_, fmax_ = wn_loc[0] - fhalf, wn_loc[0] + fhalf + 1
            tmin_, tmax_ = wn_loc[1] - thalf, wn_loc[1] + thalf + 1
            ydata_c = self.acf[fmin_:fmax_, tmin_:tmax_]
            weights_c = weights_2d[fmin_:fmax_, tmin_:tmax_]
            tdata_c = tticks[tmin_:tmax_]
            fdata_c = fticks[fmin_:fmax_]

            if nscale is not None and not full_frame:
                tframe = int(round(nscale * (tau / self.dt)))
                fframe = int(round(nscale * (dnu / self.df)))
                tc = ydata_c.shape[1] // 2
                fc = ydata_c.shape[0] // 2
                tmin_, tmax_ = max(tc - tframe, 0), tc + tframe + 1
                fmin_, fmax_ = max(fc - fframe, 0), fc + fframe + 1
                ydata_2d = ydata_c[fmin_:fmax_, tmin_:tmax_]
                weights_2d = weights_c[fmin_:fmax_, tmin_:tmax_]
                tdata = tdata_c[tmin_:tmax_]
                fdata = fdata_c[fmin_:fmax_]
            else:
                ydata_2d, weights_2d = ydata_c, weights_c
                tdata, fdata = tdata_c, fdata_c

            with np.errstate(invalid="ignore"):
                weights_2d[ydata_2d - 1 / weights_2d < 0] = 0
            weights_2d = np.fft.fftshift(weights_2d)
            weights_2d[0][0] = 1e10
            weights_2d = np.fft.ifftshift(weights_2d)

            params.add("phasegrad", value=0, vary=True)
            if (hasattr(self, "acf_tilt")
                    and getattr(self, "acf_tilt_err", None) is not None):
                params["phasegrad"].value = self.acf_tilt
            params.add("tobs", value=self.tobs, vary=False)
            params.add("bw", value=self.bw, vary=False)
            params.add("freq", value=self.freq, vary=False)

            results = fitter(
                mdl.scint_acf_model_2d_approx, params,
                (tdata, fdata, ydata_2d, weights_2d), mcmc=mcmc,
                max_nfev=50000, nan_policy=nan_policy, steps=steps,
                burn=burn, progress=progress, workers=workers,
                nwalkers=nwalkers, is_weighted=(not lnsigma),
                device=self.device)

            if method == "acf2d":
                params2d = results.params.copy()
                params2d.add("ar", value=2, vary=False)
                params2d.add("theta", value=0, vary=False)
                params2d.add("psi", value=60, vary=True)
                params2d["phasegrad"].value = 0.0
                chisqr = np.inf
                # the batched LM is deterministic from an unchanged
                # start, so it runs once; the scipy route restarts nitr
                # times
                device_lm = (not mcmc and ydata_2d.shape[0] % 2 == 1
                             and ydata_2d.shape[1] % 2 == 1)
                for _ in range(1 if device_lm else nitr):
                    if device_lm:
                        res = fit_acf2d(params2d, ydata_2d, weights_2d,
                                        precision=precision,
                                        device=self.device)
                    else:
                        res = fitter(
                            mdl.scint_acf_model_2d, params2d,
                            (ydata_2d, weights_2d, self.device), mcmc=mcmc,
                            nwalkers=nwalkers, steps=steps, burn=burn,
                            progress=progress, workers=workers,
                            max_nfev=90000, nan_policy=nan_policy,
                            is_weighted=(not lnsigma), device=self.device)
                    if res.chisqr < chisqr:
                        chisqr = res.chisqr
                        results = res

        if (results.params["tau"].stderr is None
                or results.params["dnu"].stderr is None):
            print("\n Warning: Could not estimate uncertainties")
        elif (results.params["tau"].stderr > results.params["tau"].value
              or results.params["dnu"].stderr
              > results.params["dnu"].value):
            print("\n Warning: Parameters unconstrained")

        self.scint_param_method = method
        if get_fit_report:
            self.report = results.fit_report()
            if verbose:
                print(self.report)

        if plot:
            from . import plotting

            if method == "acf1d":
                plotting.plot_scint_fit_1d(
                    self, results, xdata_t, ydata_t, t_errors, xdata_f,
                    ydata_f, f_errors, filename=filename, display=display,
                    dpi=dpi)
            elif method.startswith("acf2d"):
                plotting.plot_scint_fit_2d(
                    self, results, method, tdata, fdata, ydata_2d,
                    filename=filename, display=display, dpi=dpi)

        # results and finite-scintle errors
        self.tau = results.params["tau"].value
        self.dnu = results.params["dnu"].value
        self.tscat = 1 / (2 * np.pi * self.dnu)
        if self.dnu < self.df:
            print("Warning: Scint bandwidth < channel bandwidth.")
        nscint = ((1 + 0.2 * self.bw / self.dnu)
                  * (1 + 0.2 * self.tobs / (self.tau * np.log(2))))
        self.nscint = nscint
        self.fse_tau = self.tau / (2 * np.sqrt(nscint))
        self.fse_dnu = self.dnu / (2 * np.sqrt(nscint))
        fit_tau = results.params["tau"].stderr or np.inf
        fit_dnu = results.params["dnu"].stderr or np.inf
        self.tauerr = np.sqrt(fit_tau ** 2 + self.fse_tau ** 2)
        self.dnuerr = np.sqrt(fit_dnu ** 2 + self.fse_dnu ** 2)
        self.amp = results.params["amp"].value
        self.amperr = results.params["amp"].stderr
        self.wn = 1 - self.amp
        if "sim:mb2=" in self.name:
            self.wn = 0
        if alpha is None:
            self.talpha = results.params["alpha"].value
            self.talphaerr = results.params["alpha"].stderr
        else:
            self.talpha = alpha
            self.talphaerr = 0

        if method.startswith("acf2d"):
            if method == "acf2d_approx":
                model = -mdl.scint_acf_model_2d_approx(
                    results.params, tdata, fdata,
                    np.zeros(np.shape(ydata_2d)), None)
            else:
                model = -mdl.scint_acf_model_2d(
                    results.params, np.zeros(np.shape(ydata_2d)), None,
                    self.device)
            self.acf_model = np.asarray(model)
            self.phasegrad = results.params["phasegrad"].value
            fit_ph = results.params["phasegrad"].stderr or np.inf
            self.phasegraderr = fit_ph
            self.fse_phasegrad = self.phasegrad * np.sqrt(
                (self.fse_dnu / self.dnu) ** 2
                + (self.fse_tau / self.tau) ** 2)
            if method == "acf2d":
                for k in ("ar", "theta", "psi"):
                    setattr(self, k, results.params[k].value)
                    setattr(self, k + "err", results.params[k].stderr)
        return results

    def get_acf_tilt(self, plot=False, tmax=None, fmax=None, display=True,
                     filename=None, nscale=0.8, nscaleplot=2, nmin=5,
                     dpi=200, method="acf1d", tmaxplot=None,
                     fmaxplot=None):
        """ACF tilt (a phase-gradient proxy, min/MHz) on the host: the
        parabola peak of each frequency-lag row of ``self.acf`` within
        ``fmax`` (``nscale``·Δν by default; ``get_scint_params(method)``
        runs first when there is no fit), then a line fitted to the peaks
        weighted by their errors. Sets ``self.acf_tilt``,
        ``self.acf_tilt_err`` and ``self.fse_tilt``. ``plot`` draws the
        peaks with the line and the ACF with the tilt
        (:func:`.plotting.plot_acf_tilt`; ``display``, ``filename``,
        ``nscaleplot``, ``dpi``, ``tmaxplot`` and ``fmaxplot`` configure
        it); ``tmax`` is accepted and unused, as in the JAX package."""
        if not hasattr(self, "acf"):
            self.calc_acf()
        if not hasattr(self, "dnu") or self.scint_param_method == "nofit":
            self.get_scint_params(method=method)
        if fmax is None:
            fmax = nscale * self.dnu

        acf = np.array(self.acf)
        nr, nc = acf.shape
        t_delays = np.linspace(-self.tobs / 60, self.tobs / 60,
                               nc + 1)[:-1]
        f_shifts = np.linspace(-self.bw, self.bw, nr + 1)[:-1]
        inds = np.flatnonzero(np.abs(f_shifts) <= fmax)
        if len(inds) < nmin:
            inds = np.flatnonzero(np.abs(f_shifts) <= nmin * self.df)

        peaks, peakerrs, ys = [], [], []
        for ii in inds:
            x_max = int(np.argmax(acf[ii, :]))
            ydata = acf[ii, x_max - 3:x_max + 4]
            xdata = t_delays[x_max - 3:x_max + 4]
            if len(xdata) < 7:
                continue
            _, peak, peakerr = mdl.fit_parabola(xdata, ydata)
            peaks.append(peak)
            peakerrs.append(peakerr)
            ys.append(f_shifts[ii])
        peaks = np.array(peaks)
        peakerrs = np.array(peakerrs)
        ys = np.array(ys)

        params, pcov = np.polyfit(peaks, ys, 1, cov=True, w=1 / peakerrs)
        xfit = (ys - params[1]) / params[0]
        errors = np.sqrt(np.abs(np.diag(pcov)))
        res = peaks - xfit
        red_chisq = np.sum(res ** 2 / peakerrs ** 2) / (len(xfit) - 2)
        errors = errors * np.sqrt(red_chisq)

        self.acf_tilt = float(1 / params[0])  # min/MHz
        self.acf_tilt_err = float(errors[0] / params[0] ** 2)
        N = ((1 + 0.2 * self.bw / self.dnu)
             * (1 + 0.2 * self.tobs / (self.tau * np.log(2))))
        fse_tau = self.tau / (2 * np.sqrt(N))
        fse_dnu = self.dnu / (2 * np.sqrt(N))
        self.fse_tilt = self.acf_tilt * np.sqrt(
            (fse_dnu / self.dnu) ** 2 + (fse_tau / self.tau) ** 2)
        if plot:
            from . import plotting

            yfit = params[0] * peaks + params[1]
            plotting.plot_acf_tilt(
                self, peaks, peakerrs, ys, yfit, nscaleplot=nscaleplot,
                tmaxplot=tmaxplot, fmaxplot=fmaxplot, filename=filename,
                display=display, dpi=dpi)

    # ------------------------------------------------------------------
    # θ-θ pipeline
    # ------------------------------------------------------------------
    def prep_thetatheta(self, fw=.1, npad=3, verbose=False,
                        fitting_proc="standard", **kwargs):
        """Chunk geometry + η range + edges for θ-θ (η in s³, edges
        mHz). A bound not given (``eta_min``, ``eta_max``) comes from the
        Hough seed: :meth:`fit_arc` on the λ-scaled spectrum, η ± twice
        its larger error. ``fitting_proc="thin"`` takes the edges out to
        the whole Doppler range and sets ``self.arclet_lim`` (the
        arclets' |θ| bound, ``arclet_lim``, default the edges' limit) and
        ``self.center_cut`` (``center_cut``, default 0)."""
        procs = ["standard", "thin", "incoherent"]
        if fitting_proc not in procs:
            raise ValueError(f"fitting_proc must be one of {procs}")
        self.thetatheta_proc = fitting_proc
        self.npad = npad
        self.fw = fw
        if "cwf" in kwargs:
            self.cwf = 2 * (kwargs["cwf"] // 2)
            self.ncf_fit = self.dyn.shape[0] // self.cwf
            self.ncf_ret = (self.dyn.shape[0] // (self.cwf // 2)) - 1
        else:
            self.cwf = self.dyn.shape[0]
            self.ncf_fit = self.ncf_ret = 1
        if "cwt" in kwargs:
            self.cwt = 2 * (kwargs["cwt"] // 2)
            self.nct_fit = self.dyn.shape[1] // self.cwt
            self.nct_ret = (self.dyn.shape[1] // (self.cwt // 2)) - 1
        else:
            self.cwt = self.dyn.shape[1]
            self.nct_fit = self.nct_ret = 1

        tau_lim = kwargs.get("tau_lim")
        self.fref = kwargs.get("fref", float(self.freqs.mean()))

        fd = thth_core.fft_axis(self.times[:self.cwt], scale=1e3)
        tau = thth_core.fft_axis(self.freqs[:self.cwf], scale=1.0)

        self.eta_min = 4 * (tau[1] - tau[0]) / fd.max() ** 2
        self.eta_max = tau.max() / (fd[1] - fd[0]) ** 2
        self.eta_min *= (self.freqs.max() / self.fref) ** 2
        self.eta_max *= (self.freqs.min() / self.fref) ** 2
        if "eta_min" in kwargs:
            self.eta_min = max(kwargs["eta_min"], self.eta_min)
        if "eta_max" in kwargs:
            self.eta_max = min(kwargs["eta_max"], self.eta_max)
        if not ("eta_min" in kwargs and "eta_max" in kwargs):
            if not hasattr(self, "betaeta"):
                # Hough seed: η[s³] → β[m⁻¹mHz⁻²] via η·fref²/c
                to_beta = (self.fref * 1e6) ** 2 / (SPEED_OF_LIGHT * 1e6)
                self.fit_arc(lamsteps=True, numsteps=1e4,
                             etamin=self.eta_min * to_beta,
                             etamax=self.eta_max * to_beta, delmax=tau_lim)
            from_beta = SPEED_OF_LIGHT * 1e6 / (self.fref * 1e6) ** 2
            eta_hough = self.betaeta * from_beta
            err_hough = 2 * max(self.betaetaerr,
                                self.betaetaerr2) * from_beta
            if "eta_min" not in kwargs:
                self.eta_min = max(self.eta_min, eta_hough - err_hough)
            if "eta_max" not in kwargs:
                self.eta_max = min(self.eta_max, eta_hough + err_hough)

        l0, l1 = np.log10(self.eta_min), np.log10(self.eta_max)
        self.neta = int(1 + (l1 - l0) / np.log10(1 + self.fw / 10))
        if "neta" in kwargs:
            self.neta = int(kwargs["neta"])

        if self.thetatheta_proc == "thin":
            fd_cut = fd.max() * (self.fref / self.freqs.max())
        else:
            fd_cut = (fd.max() / 2) * (self.fref / self.freqs.max())
        edges_lim = min(kwargs.get("edges_lim", fd_cut), fd_cut)
        if tau_lim is not None:
            edges_lim = min(edges_lim, np.sqrt(tau_lim / self.eta_max))

        if "nedge" in kwargs:
            if kwargs["nedge"] % 2 != 0:
                raise ValueError("nedge must be even!")
            self.edges = np.linspace(-edges_lim, edges_lim, kwargs["nedge"])
        else:
            self.edges = thth_core.min_edges(
                edges_lim, fd, tau,
                self.eta_max * (self.fref / self.freqs.min()),
                2) * (self.freqs.min() / self.fref)
        if self.thetatheta_proc == "thin":
            self.arclet_lim = kwargs.get("arclet_lim", edges_lim)
            self.center_cut = kwargs.get("center_cut", 0)
        self.thth_tau_mask = kwargs.get("tau_mask", 0.0)

        if verbose:
            print(f"Chunks: {self.ncf_fit}x{self.nct_fit} of "
                  f"{self.cwf}x{self.cwt} (mosaic {self.ncf_ret}x"
                  f"{self.nct_ret}); eta {self.eta_min} to "
                  f"{self.eta_max} s^3 with {self.neta} points; "
                  f"{self.edges.shape[0]} edges out to {self.edges[-1]} mHz")

    def _chunk(self, cf, ct, fit=True):
        """Mean-subtracted chunk: fitting chunks tile the plane;
        retrieval chunks (``fit=False``) half-overlap."""
        fs, ts = _chunk_slices(cf, ct, self.cwf, self.cwt, fit)
        return (_centred_chunk(self.dyn, fs, ts), self.freqs[fs],
                self.times[ts])

    def _thth_row_geometry(self, freq2):
        """The η grid and θ edges of a chunk row at frequencies
        ``freq2`` (η ∝ f⁻², θ ∝ f)."""
        etas = np.logspace(np.log10(self.eta_min), np.log10(self.eta_max),
                           self.neta) * (self.fref / freq2.mean()) ** 2
        return etas, self.edges * (freq2.mean() / self.fref)

    def _thin_search(self, dspecs, freq2, tlist, etas, edges):
        """The thin-screen search of one row's chunks: the arclet edges
        are the row's scaled edges within ``self.arclet_lim``."""
        return thth_search.multi_chunk_search_thin(
            dspecs, freq2, tlist, etas, edges,
            edges[np.abs(edges) < self.arclet_lim], self.center_cut,
            fw=self.fw, npad=self.npad, tau_mask=self.thth_tau_mask,
            device=self.device)

    def thetatheta_single(self, cf=0, ct=0, fname=None, verbose=False,
                          plot=False, arrays=False, eig="kernel"):
        """η search of the fitting chunk (cf, ct) (indices clipped to the
        grid) by :func:`~.thth.search.single_search`: the η grid walked as
        one chain of the warm-start eigensolver on ``self.device``
        (``eig`` as in :meth:`fit_thetatheta`); with the thin proc by
        :func:`~.thth.search.single_search_thin`, its arclet edges the
        chunk's frequency-scaled edges within ``self.arclet_lim``.
        Returns the :class:`~.thth.search.ChunkSearchResult`, or with
        ``arrays`` its ``(etas, eigs, popt)``. ``plot`` draws the chunk's
        diagnostic (:func:`.thth.plots.plot_func`) into the file ``fname``
        or shows it."""
        if not hasattr(self, "cwf"):
            self.prep_thetatheta(verbose=verbose)
        cf = min(cf, self.ncf_fit - 1)
        ct = min(ct, self.nct_fit - 1)
        dspec2, freq2, time2 = self._chunk(cf, ct, fit=True)
        etas, edges = self._thth_row_geometry(freq2)
        if self.thetatheta_proc == "thin":
            res = self._thin_search([dspec2], freq2, [time2], etas, edges)[0]
        else:
            res = thth_search.single_search(
                dspec2, freq2, time2, etas, edges, fw=self.fw,
                npad=self.npad,
                coher=(self.thetatheta_proc != "incoherent"),
                tau_mask=self.thth_tau_mask, device=self.device, eig=eig)
        if plot:
            self._plot_chunk(res, dspec2, freq2, time2, etas, edges, fname)
        if arrays:
            return res.etas, res.eigs, res.popt
        return res

    def _plot_chunk(self, res, dspec2, freq2, time2, etas, edges, fname):
        """The θ-θ diagnostic of one searched chunk."""
        from .thth.plots import plot_func

        CS, tau, fd = thth_search.chunk_conjugate_spectrum(
            dspec2, time2, freq2, npad=self.npad, tau_mask=self.thth_tau_mask)
        # a marginal chunk can leave no finite point of its curve: fall
        # back to the raw η grid so the diagnostic still draws
        if len(res.etas) and np.any(np.isfinite(res.eigs)):
            petas, peigs = res.etas, res.eigs
        else:
            petas, peigs = etas, np.full(len(etas), np.nan)
        if np.isfinite(res.eta):
            e_pk = res.eta
        elif np.any(np.isfinite(peigs)):
            e_pk = petas[np.nanargmax(peigs)]
        else:
            e_pk = petas.mean()
        sel = np.abs(petas - e_pk) < self.fw * e_pk
        fig = plot_func(dspec2, time2, freq2, CS, fd, tau, edges, res.eta,
                        res.eta_sig, petas, peigs, petas[sel], res.popt,
                        device=self.device)
        if fname is not None:
            fig.savefig(fname, bbox_inches="tight")
        else:
            import matplotlib.pyplot as plt

            plt.show()
        return fig

    def fit_thetatheta(self, verbose=False, plot=False, pool=None,
                       time_avg=False, mesh=None, eig="kernel"):
        """Per-chunk η(f, t) searches → weighted global η ∝ f⁻² fit
        (``self.ththeta``, ``self.ththetaerr``; per-chunk ``eta_evo``,
        ``eta_evo_err`` and the health bitmask ``eta_evo_ok``), after
        :meth:`prep_thetatheta` with its defaults when it has not run.
        With two or more chunks per row, one fused batched search per
        frequency row; with one, :meth:`thetatheta_single` per chunk, as
        the JAX package does. ``eig="plain"`` runs the eigensolver's
        plain PyTorch version on the card too (the reference the kernel
        is held to); the thin-screen search has no kernel and runs its
        device power iteration under either value. ``time_avg`` fits the
        rows' time-averaged η, weighted by their scatter over time, in
        place of every chunk's. ``pool`` is accepted and ignored. ``plot``
        draws η against frequency with the fit
        (:func:`.plotting.plot_eta_evolution`).

        ``mesh`` (:func:`.parallel.make_mesh`) searches the whole chunk
        grid at once, the chunks spread over the mesh's devices
        (:meth:`_fit_thetatheta_sharded`), each chunk with the η grid and
        edges of its row, so a chunk gets the η it gets without the
        mesh."""
        if eig not in ("kernel", "plain"):
            raise ValueError(f"unknown eig {eig!r} (want 'kernel' or "
                             "'plain')")
        if not hasattr(self, "cwf"):
            self.prep_thetatheta(verbose=verbose)
        self.eta_evo = np.zeros((self.ncf_fit, self.nct_fit))
        self.eta_evo_err = np.zeros((self.ncf_fit, self.nct_fit))
        self.eta_evo_ok = np.zeros((self.ncf_fit, self.nct_fit), dtype=int)
        self.f0s = np.zeros(self.ncf_fit)
        self.t0s = np.zeros(self.nct_fit)
        if mesh is not None:
            self._fit_thetatheta_sharded(mesh, eig=eig, verbose=verbose)
        for cf in range(self.ncf_fit if mesh is None else 0):
            if self.nct_fit > 1:
                chunks, tlist, freq2 = [], [], None
                for ct in range(self.nct_fit):
                    dspec2, freq2, time2 = self._chunk(cf, ct)
                    chunks.append(dspec2)
                    tlist.append(time2)
                etas, edges = self._thth_row_geometry(freq2)
                if self.thetatheta_proc == "thin":
                    results = self._thin_search(chunks, freq2, tlist, etas,
                                                edges)
                else:
                    results = thth_search.multi_chunk_search(
                        chunks, freq2, tlist, etas, edges, fw=self.fw,
                        npad=self.npad,
                        coher=(self.thetatheta_proc != "incoherent"),
                        tau_mask=self.thth_tau_mask, eig=eig,
                        device=self.device)
            else:
                results = [self.thetatheta_single(cf, 0, verbose=verbose,
                                                  eig=eig)]
            for ct, res in enumerate(results):
                self.eta_evo[cf, ct] = res.eta
                self.eta_evo_err[cf, ct] = res.eta_sig
                self.eta_evo_ok[cf, ct] = res.ok
                self.f0s[cf] = res.freq_mean
                self.t0s[ct] = res.time_mean
            ok = np.isfinite(self.eta_evo[cf])
            if verbose:
                print(f"Chunk row {cf + 1}/{self.ncf_fit} "
                      f"(f={self.f0s[cf]:.1f} MHz): "
                      f"{int(ok.sum())}/{self.nct_fit} fits")
            slog.log_event(
                "thetatheta.row", cf=cf, freq=float(self.f0s[cf]),
                fits=int(ok.sum()), n=self.nct_fit,
                median_eta=float(np.nanmedian(self.eta_evo[cf]))
                if ok.any() else None)

        n_quar = int(np.sum((self.eta_evo_ok & (BAD_INPUT | BAD_CS)) != 0))
        n_refused = int(np.sum((self.eta_evo_ok != 0)
                               & ((self.eta_evo_ok
                                   & (BAD_INPUT | BAD_CS)) == 0)))
        slog.log_event("thetatheta.health",
                       chunks=int(self.eta_evo_ok.size),
                       quarantined=n_quar, refused=n_refused)
        if verbose and n_quar:
            print(f"fit_thetatheta: {n_quar} chunk(s) quarantined "
                  "(non-finite input/CS power; see eta_evo_ok)")

        self.ththeta, self.ththetaerr = global_eta_fit(
            self.eta_evo, self.eta_evo_err, self.f0s, self.fref, time_avg)
        if plot:
            from . import plotting

            plotting.plot_eta_evolution(self, time_avg=time_avg)

    def _fit_thetatheta_sharded(self, mesh, verbose=False, eig="kernel"):
        """The whole fitting chunk grid over ``mesh``: every (cf, ct) chunk
        with its row's η grid and edges, raw chunks in, and on each shard
        the spectrum, the θ-θ gather, the eigen curve, the closed-form
        peak fit and the health bitmask of each row's fused search: the
        warm-start eigensolver for the single-curvature procs
        (:func:`.parallel.make_fused_grid_search_sharded`,
        ``method="auto"``), the thin search's 200 power steps for the thin
        proc (:func:`.parallel.make_fused_thin_grid_search_sharded`). The
        JAX package's sharded route takes 64 cold power steps and, for the
        thin proc, host spectra and the scipy peak fit; here every chunk
        gets the η the per-row search gives it. Fills ``eta_evo``,
        ``eta_evo_err``, ``eta_evo_ok``, ``f0s`` and ``t0s``."""
        from . import parallel as par

        thin = self.thetatheta_proc == "thin"
        chunks, edges_l, etas_l, arclet_l, meta = [], [], [], [], []
        for cf in range(self.ncf_fit):
            for ct in range(self.nct_fit):
                dspec2, freq2, time2 = self._chunk(cf, ct)
                etas, edges = self._thth_row_geometry(freq2)
                chunks.append(np.asarray(dspec2, dtype=np.float32))
                etas_l.append(etas)
                edges_l.append(edges)
                if thin:
                    arclet_l.append(edges[np.abs(edges) < self.arclet_lim])
                meta.append((cf, ct, float(freq2.mean()),
                             float(time2.mean())))
        fd = thth_core.fft_axis(time2, pad=self.npad, scale=1e3)
        tau = thth_core.fft_axis(freq2, pad=self.npad, scale=1.0)
        nf_c, nt_c = chunks[0].shape
        args = [torch.as_tensor(np.stack(chunks)),
                torch.as_tensor(np.stack(edges_l))]
        common = dict(npad=self.npad,
                      coher=self.thetatheta_proc != "incoherent",
                      tau_mask=self.thth_tau_mask, fw=self.fw)
        if thin:
            from .thth.batch import pad_arclet_edges

            arclet_b = pad_arclet_edges(arclet_l, np.abs(self.edges).max())
            args.append(torch.as_tensor(arclet_b))
            fn = par.make_fused_thin_grid_search_sharded(
                mesh, tau, fd, len(self.edges), arclet_b.shape[1],
                self.center_cut, nf_c, nt_c, **common)
        else:
            fn = par.make_fused_grid_search_sharded(
                mesh, tau, fd, len(self.edges), nf_c, nt_c, method="auto",
                eig=eig, **common)
        args.append(torch.as_tensor(np.stack(etas_l)))
        _, eta, sig, _, ok = (t.cpu().numpy() for t in fn(*args))
        for i, (cf, ct, f_m, t_m) in enumerate(meta):
            self.eta_evo[cf, ct] = eta[i]
            self.eta_evo_err[cf, ct] = sig[i]
            self.eta_evo_ok[cf, ct] = int(ok[i])
            self.f0s[cf] = f_m
            self.t0s[ct] = t_m
        if verbose:
            print(f"Sharded chunk grid: "
                  f"{int(np.isfinite(self.eta_evo).sum())}/{len(meta)} "
                  f"chunk fits on {mesh.size} devices")

    # ------------------------------------------------------------------
    # wavefield retrieval
    # ------------------------------------------------------------------
    def _retrieval_grid_inputs(self):
        """The half-overlap retrieval grid with each frequency row's
        scaled geometry: ``(chunks[ncf, nct, cwf, cwt],
        edges_rows[ncf, n_edges], etas_rows[ncf])``."""
        chunks = np.zeros((self.ncf_ret, self.nct_ret, self.cwf, self.cwt))
        edges_rows = np.zeros((self.ncf_ret, len(self.edges)))
        etas_rows = np.zeros(self.ncf_ret)
        for cf in range(self.ncf_ret):
            for ct in range(self.nct_ret):
                chunks[cf, ct], freq2, _ = self._chunk(cf, ct, fit=False)
            freq = freq2.mean()
            etas_rows[cf] = self.ththeta * (self.fref / freq) ** 2
            edges_rows[cf] = self.edges * (freq / self.fref)
        return chunks, edges_rows, etas_rows

    def _steps(self):
        return self.times[1] - self.times[0], self.freqs[1] - self.freqs[0]

    def thetatheta_chunks(self, verbose=False, pool=None, memmap=False,
                          mesh=None):
        """Retrieve the half-overlap chunk grid (``self.chunks``
        ``[ncf_ret, nct_ret, cwf, cwt]``) with the dense ``"eigh"``
        solve, as the JAX package does: in one batched pass (complex64),
        or with ``memmap`` row by row into a complex128 ``np.memmap`` on
        the file ``memmap.dat`` of the working directory, so that one
        frequency row of chunks is in memory at a time. ``pool`` is
        accepted and ignored; ``mesh`` spreads the chunks over its
        devices (and the fit, when one runs first)."""
        if not hasattr(self, "ththeta"):
            self.fit_thetatheta(verbose=verbose, mesh=mesh)
        nct = self.nct_ret
        dt, df = self._steps()
        if memmap:
            self.chunks = np.memmap(
                "memmap.dat", dtype=complex, mode="w+",
                shape=(self.ncf_ret, nct, self.cwf, self.cwt))
            for cf in range(self.ncf_ret):
                row = [self._chunk(cf, ct, fit=False) for ct in range(nct)]
                freq = row[-1][1].mean()
                eta = self.ththeta * (self.fref / freq) ** 2
                self.chunks[cf] = thth_ret.chunk_retrieval_batch(
                    np.stack([r[0] for r in row]),
                    self.edges * (freq / self.fref), eta, dt, df,
                    npad=self.npad, tau_mask=self.thth_tau_mask, mesh=mesh,
                    device=self.device)
                if verbose:
                    print(f"retrieved row {cf + 1}/{self.ncf_ret} ({nct} "
                          f"chunks, eta={eta:.4g})")
            return
        chunks, edges_rows, etas_rows = self._retrieval_grid_inputs()
        E = thth_ret.grid_retrieval_batch(
            chunks.reshape(-1, self.cwf, self.cwt),
            np.repeat(edges_rows, nct, axis=0), np.repeat(etas_rows, nct),
            dt, df, npad=self.npad, tau_mask=self.thth_tau_mask, mesh=mesh,
            device=self.device)
        self.chunks = E.reshape(self.ncf_ret, nct, self.cwf, self.cwt)
        if verbose:
            print(f"retrieved {self.ncf_ret}x{nct} chunks")

    def calc_wavefield(self, verbose=False, pool=None, gs=False,
                       memmap=False, niter=1, mesh=None, gs_mesh=None,
                       device_mosaic=False):
        """Mosaic the retrieval chunks into ``self.wavefield`` with the
        numpy greedy stitch (``device_mosaic=True``: the device one),
        retrieving them first if needed (``memmap`` as in
        :meth:`thetatheta_chunks`); ``gs`` then runs
        :meth:`gerchberg_saxton`. ``pool`` is accepted and ignored;
        ``mesh`` spreads the retrieval over its devices, ``gs_mesh`` (a
        data-axis-1 mesh, ``make_mesh(n, seq=n)``) splits the GS loop's
        FFTs: the grid wants chunk fan-out, GS one wavefield over
        devices."""
        if not hasattr(self, "chunks"):
            self.thetatheta_chunks(verbose=verbose, memmap=memmap,
                                   mesh=mesh)
        if device_mosaic:
            self.wavefield = thth_ret.mosaic_device(self.chunks,
                                                    device=self.device)
        else:
            self.wavefield = thth_ret.mosaic(self.chunks)
        if gs:
            self.gerchberg_saxton(niter=niter, verbose=verbose, mesh=gs_mesh)
        return self.wavefield

    def retrieve_wavefield(self, verbose=False, mesh=None, gs=False,
                           niter=1, gs_mesh=None, method=None, mark=None):
        """Device retrieval and mosaic of the half-overlap grid: the
        chunk wavefields go from the batched retrieval to the device
        stitch without leaving the card. Sets ``self.wavefield`` and the
        per-chunk health grid ``self.wavefield_ok`` (quarantined chunks
        are zero). ``method=None`` is the hand-written kernel route
        (``"plain"``, ``"eigh"`` and ``"power"`` as in
        :func:`~.thth.retrieval.grid_retrieval_batch`); ``mark`` is the
        stage callback of
        :func:`~.thth.retrieval.campaign_retrieval_batch`. ``mesh``
        spreads the chains over its devices in whole chains (every chunk
        as without it; the wavefield is stitched on its first device),
        ``gs_mesh`` splits the GS loop as in :meth:`calc_wavefield`."""
        if not hasattr(self, "ththeta"):
            self.fit_thetatheta(verbose=verbose, mesh=mesh)
        chunks, edges_rows, etas_rows = self._retrieval_grid_inputs()
        dt, df = self._steps()
        wf, ok = thth_ret.campaign_retrieval_batch(
            chunks[None], edges_rows, etas_rows, dt, df, npad=self.npad,
            tau_mask=self.thth_tau_mask, method=method, mesh=mesh,
            device=self.device, mark=mark)
        self.wavefield = wf[0]
        self.wavefield_ok = ok[0]
        slog.log_event("thth.retrieve_wavefield",
                       ncf=self.ncf_ret, nct=self.nct_ret,
                       n_quarantined=int(np.count_nonzero(ok)),
                       shape=list(self.wavefield.shape))
        if verbose:
            print(f"retrieved {self.ncf_ret}x{self.nct_ret} chunks, "
                  f"{int(np.count_nonzero(ok))} quarantined")
        if gs:
            self.gerchberg_saxton(niter=niter, verbose=verbose, mesh=gs_mesh)
        return self.wavefield

    def gerchberg_saxton(self, niter=1, verbose=False, pool=None, mesh=None):
        """Gerchberg–Saxton iterations on ``self.wavefield`` (``pool`` is
        accepted and ignored; ``mesh``, a data-axis-1 mesh, splits the
        loop's FFTs over its ``seq`` shards)."""
        if not hasattr(self, "wavefield"):
            self.calc_wavefield(verbose=verbose)
        self.wavefield = thth_ret.gerchberg_saxton(
            self.wavefield, self.dyn,
            freqs=self.freqs[: self.wavefield.shape[0]], niter=niter,
            mesh=mesh, device=self.device)
        return self.wavefield


    def calc_asymmetry(self, verbose=False, pool=None):
        """Per fitting chunk, the L/R power asymmetry of the dominant
        eigenvector of its reduced θ-θ at the fitted curvature
        (``self.asymmetry``, NaN where the θ-θ has no valid square).
        ``pool`` is accepted and ignored."""
        if not hasattr(self, "ththeta"):
            self.fit_thetatheta(verbose=verbose)
        self.asymmetry = np.zeros((self.ncf_fit, self.nct_fit))
        for cf in range(self.ncf_fit):
            for ct in range(self.nct_fit):
                dspec2, freq2, time2 = self._chunk(cf, ct, fit=True)
                freq = freq2.mean()
                eta = self.ththeta * (self.fref / freq) ** 2
                CS, tau, fd = thth_search.chunk_conjugate_spectrum(
                    dspec2, time2, freq2, npad=self.npad)
                try:
                    thth_red, edges_red = thth_core.thth_redmap(
                        CS, tau, fd, eta, self.edges * (freq / self.fref),
                        device=self.device)
                except ValueError:
                    self.asymmetry[cf, ct] = np.nan
                    continue
                _, V = thth_core.dominant_eig_power(thth_red)
                self.asymmetry[cf, ct] = thth_ret.calc_asymmetry(V,
                                                                 edges_red)
        return self.asymmetry

    # ------------------------------------------------------------------
    # scattered image
    # ------------------------------------------------------------------
    def calc_scattered_image(self, input_sspec=None, input_eta=None,
                             input_fdop=None, input_tdel=None,
                             sampling=64, lamsteps=False, trap=False,
                             ref_freq=1400, clean=True, s=None, veff=None,
                             d=None, fit_arc=True, plot_fit=False,
                             plot=False, plot_log=True, use_angle=False,
                             use_spatial=False):
        """Map the secondary spectrum's power onto the (θx, θy) plane,
        assuming interference with the primary arc: ``self.
        scattered_image`` (2·sampling + 1)² and its axis ``self.
        scattered_image_ax`` [mHz]. The arc's η comes from ``input_eta``,
        else from :meth:`fit_arc` (``log_parabola``; with ``lamsteps`` the
        β curvature converted at ``ref_freq``), else from the spectrum's
        corner. The spectrum is cropped so the arc stays inside the delay
        axis, tiny powers are refilled (``clean``), and on uniform axes
        the cubic-convolution interpolation runs on ``self.device``
        (``ops.scatim``); other axes take the host
        ``RectBivariateSpline``. ``plot_fit`` draws the arc fit it runs,
        ``plot`` the image (:meth:`plot_scattered_image`; ``plot_log``,
        ``use_angle``, ``use_spatial``, ``s``, ``veff`` and ``d``
        configure it)."""
        if input_sspec is None:
            sspec, yaxis = self._select_sspec(lamsteps=lamsteps, trap=trap)
            fdop = np.array(self.fdop)
            tdel = np.array(yaxis)
        else:
            sspec = input_sspec
            fdop = np.asarray(input_fdop)
            tdel = np.asarray(input_tdel)

        linsspec = 10 ** (np.asarray(sspec) / 10)
        if input_eta is None and fit_arc:
            if not hasattr(self, "betaeta") and not hasattr(self, "eta"):
                self.fit_arc(lamsteps=lamsteps, log_parabola=True,
                             plot=plot_fit)
            if lamsteps:
                beta_to_eta = SPEED_OF_LIGHT * 1e6 / (ref_freq * 1e6) ** 2
                eta = (self.betaeta / (self.freq / ref_freq) ** 2
                       * beta_to_eta)
            else:
                eta = self.eta
        elif input_eta is None:
            eta = tdel[-1] / fdop[-1] ** 2
        else:
            eta = input_eta

        # crop so the arc tdel = η·fdop² stays inside the delay axis and
        # the interpolation never extrapolates (the JAX package's
        # tdel[:tlim], where the reference takes fdop[:tlim])
        nf_ax = len(fdop)
        inside = np.flatnonzero(eta * fdop ** 2 < np.max(tdel))
        flim = int(inside[0]) if len(inside) else 0
        if flim == 0:
            above = np.flatnonzero(tdel > eta * fdop[0] ** 2)
            if len(above):
                tlim = max(int(above[0]), 4)   # ≥ 4 rows for the cubic
                linsspec = linsspec[:tlim, :]
                tdel = tdel[:tlim]
        else:
            pad = int(0.02 * nf_ax)
            lo = max(flim - pad, 0)
            hi = min(nf_ax - flim + pad, nf_ax)
            if hi - lo >= 4:
                linsspec = linsspec[:, lo:hi]
                fdop = fdop[lo:hi]

        if clean:
            arr = np.ma.masked_where(linsspec < 1e-22, linsspec)
            if arr.mask.any():
                linsspec = interp_nan_2d(
                    np.where(arr.mask, np.nan, linsspec))
                linsspec[np.isnan(linsspec)] = np.nanmean(linsspec)

        nx, ny = 2 * sampling + 1, sampling + 1
        fdop_x = np.linspace(-max(fdop), max(fdop), nx)
        fdop_y = np.linspace(0, max(fdop), ny)
        FX, FY = np.meshgrid(fdop_x, fdop_y)
        tdel_est = (FX ** 2 + FY ** 2) * eta
        if is_uniform(tdel) and is_uniform(fdop):
            image = scattered_image_interp(
                linsspec, tdel, fdop, tdel_est, FX,
                device=self.device).cpu().numpy() * FY
        else:                               # not an FFT grid
            from scipy.interpolate import RectBivariateSpline

            image = RectBivariateSpline(tdel, fdop, linsspec).ev(
                tdel_est, FX) * FY
        scat_im = np.zeros((nx, nx))
        scat_im[ny - 1:nx, :] = image
        scat_im[0:ny - 1, :] = image[ny - 1:0:-1, :]
        self.scattered_image = scat_im
        self.scattered_image_ax = fdop_x
        if plot:
            self.plot_scattered_image(plot_log=plot_log, use_angle=use_angle,
                                      use_spatial=use_spatial, s=s,
                                      veff=veff, d=d)
        return scat_im

    # ------------------------------------------------------------------
    # pipelines and info
    # ------------------------------------------------------------------
    def auto_processing(self, lamsteps=False, remove_short_sub=True):
        """trim → biharmonic refill → ACF → (λ rescale) → spectrum."""
        self.trim_edges(remove_short_sub=remove_short_sub)
        self.refill()
        self.calc_acf()
        if lamsteps:
            self.scale_dyn()
        self.calc_sspec(lamsteps=lamsteps)

    def default_processing(self, lamsteps=False):
        """trim → linear refill → ACF → (λ rescale) → spectrum."""
        self.trim_edges()
        self.refill(method="linear")
        self.calc_acf()
        if lamsteps:
            self.scale_dyn()
        self.calc_sspec(lamsteps=lamsteps)

    # ------------------------------------------------------------------
    # plotting (host matplotlib, :mod:`.plotting`)
    # ------------------------------------------------------------------
    def plot_dyn(self, lamsteps=False, input_dyn=None, filename=None,
                 input_x=None, input_y=None, trap=False, display=True,
                 figsize=(9, 9), dpi=200, title=None, velocity=False):
        from . import plotting

        return plotting.plot_dyn(self, lamsteps=lamsteps, input_dyn=input_dyn,
                                 filename=filename, input_x=input_x,
                                 input_y=input_y, trap=trap, display=display,
                                 figsize=figsize, dpi=dpi, title=title,
                                 velocity=velocity)

    def plot_acf(self, method="acf1d", alpha=5 / 3, contour=False,
                 filename=None, input_acf=None, input_t=None, input_f=None,
                 nscale=4, mcmc=False, display=True, crop=False, tlim=None,
                 flim=None, figsize=(9, 9), verbose=False, dpi=200):
        from . import plotting

        return plotting.plot_acf(self, method=method, alpha=alpha,
                                 contour=contour, filename=filename,
                                 input_acf=input_acf, input_t=input_t,
                                 input_f=input_f, nscale=nscale, mcmc=mcmc,
                                 display=display, crop=crop, tlim=tlim,
                                 flim=flim, figsize=figsize, verbose=verbose,
                                 dpi=dpi)

    def plot_sspec(self, lamsteps=False, input_sspec=None, filename=None,
                   input_x=None, input_y=None, trap=False, prewhite=False,
                   plotarc=False, maxfdop=np.inf, delmax=None, cutmid=0,
                   startbin=0, display=True, colorbar=True, title=None,
                   figsize=(9, 9), subtract_artefacts=False,
                   overplot_curvature=None, dpi=200, velocity=False,
                   vmin=None, vmax=None, **kwargs):
        # the reference's signature; ``ref_freq`` alone is tolerated (the
        # JAX package's earlier releases took it), anything else raises
        kwargs.pop("ref_freq", None)
        if kwargs:
            raise TypeError("plot_sspec() got unexpected keyword "
                            f"arguments {sorted(kwargs)}")
        from . import plotting

        return plotting.plot_sspec(
            self, lamsteps=lamsteps, input_sspec=input_sspec,
            filename=filename, input_x=input_x, input_y=input_y, trap=trap,
            prewhite=prewhite, plotarc=plotarc, maxfdop=maxfdop,
            delmax=delmax, cutmid=cutmid, startbin=startbin, display=display,
            colorbar=colorbar, title=title, figsize=figsize,
            subtract_artefacts=subtract_artefacts,
            overplot_curvature=overplot_curvature, dpi=dpi,
            velocity=velocity, vmin=vmin, vmax=vmax)

    def plot_scattered_image(self, input_scattered_image=None,
                             input_fdop=None, display=True, s=None,
                             veff=None, d=None, use_angle=False,
                             use_spatial=False, plot_log=True, colorbar=True,
                             title=None, filename=None, figsize=(9, 9),
                             dpi=200):
        from . import plotting

        return plotting.plot_scattered_image(
            self, input_scattered_image=input_scattered_image,
            input_fdop=input_fdop, display=display, plot_log=plot_log,
            colorbar=colorbar, title=title, use_angle=use_angle,
            use_spatial=use_spatial, s=s, veff=veff, d=d, filename=filename,
            figsize=figsize, dpi=dpi)

    def plot_all(self, dyn=1, sspec=3, acf=2, norm_sspec=4, colorbar=True,
                 lamsteps=False, filename=None, display=True, figsize=(9, 9),
                 dpi=200):
        from . import plotting

        return plotting.plot_all(self, dyn=dyn, sspec=sspec, acf=acf,
                                 norm_sspec=norm_sspec, colorbar=colorbar,
                                 lamsteps=lamsteps, filename=filename,
                                 display=display, figsize=figsize, dpi=dpi)

    def info(self):
        """Print the observation's properties."""
        print("\t OBSERVATION PROPERTIES\n")
        print(f"filename:\t\t\t{self.name}")
        print(f"MJD:\t\t\t\t{self.mjd}")
        print(f"Centre frequency (MHz):\t\t{self.freq}")
        print(f"Bandwidth (MHz):\t\t{self.bw}")
        print(f"Channel bandwidth (MHz):\t{self.df}")
        print(f"Integration time (s):\t\t{self.tobs}")
        print(f"Subintegration time (s):\t{self.dt}")


def global_eta_fit(eta_evo, eta_evo_err, f0s, fref, time_avg=False):
    """The weighted global η ∝ f⁻² fit of the per-chunk η (host float64,
    the reference's formula): ``(ththeta, ththetaerr)`` at ``fref``.
    With ``time_avg`` each row's η is first averaged over time and
    weighted by its scatter. Zero errors get infinite weight, as in the
    reference."""
    with np.errstate(divide="ignore", invalid="ignore"):
        if time_avg:
            eta_avg = np.nanmean(eta_evo, 1)
            eta_count = np.nansum(eta_evo, 1) / eta_avg
            avg_err = np.nanstd(eta_evo, 1) / np.sqrt(eta_count - 1)
            tofit = np.isfinite(eta_avg) & np.isfinite(avg_err)
            A = (np.sum(eta_avg[tofit] / (f0s * avg_err)[tofit] ** 2)
                 / np.sum(1 / (f0s ** 2 * avg_err)[tofit] ** 2))
            A_err = np.sqrt(1 / np.sum(2 / ((f0s ** 2) * avg_err)[tofit]
                                       ** 2))
        else:
            f0s = f0s[:, None]
            tofit = np.isfinite(eta_evo) & np.isfinite(eta_evo_err)
            A = (np.sum(eta_evo[tofit] / (f0s * eta_evo_err)[tofit] ** 2)
                 / np.sum(1 / ((f0s ** 2) * eta_evo_err)[tofit] ** 2))
            A_err = np.sqrt(1 / np.sum(
                2 / ((f0s ** 2) * eta_evo_err)[tofit] ** 2))
    return A / fref ** 2, A_err / fref ** 2


class BasicDyn:
    """Raw-array adapter."""

    def __init__(self, dyn, name="BasicDyn", header=("BasicDyn",),
                 times=None, freqs=None, nchan=None, nsub=None, bw=None,
                 df=None, freq=None, tobs=None, dt=None, mjd=60000):
        times = np.asarray([] if times is None else times, dtype=float)
        freqs = np.asarray([] if freqs is None else freqs, dtype=float)
        if times.size == 0 or freqs.size == 0:
            raise ValueError("must input array of times and frequencies")
        self.name = name
        self.header = list(header)
        self.times = times
        self.freqs = freqs
        self.nchan = nchan if nchan is not None else len(freqs)
        self.nsub = nsub if nsub is not None else len(times)
        self.bw = bw if bw is not None else float(np.ptp(freqs))
        self.df = (df if df is not None
                   else float(np.mean(np.abs(np.diff(freqs)))))
        self.freq = (freq if freq is not None
                     else float(np.mean(np.unique(freqs))))
        self.dt = (dt if dt is not None
                   else float(np.mean(np.abs(np.diff(times)))))
        self.tobs = (tobs if tobs is not None
                     else float(np.ptp(times)) + self.dt)
        self.mjd = mjd
        self.dyn = dyn


class MatlabDyn:
    """Adapter for the Matlab ``.mat`` dynamic spectra of Coles et al.
    (variables ``spi`` and ``dlam``)."""

    def __init__(self, matfilename):
        from scipy.io import loadmat

        self.matfile = loadmat(matfilename)
        if "spi" not in self.matfile:
            raise NameError('No variable named "spi" found in mat file')
        if "dlam" not in self.matfile:
            raise NameError('No variable named "dlam" found in mat file')
        self.dyn = self.matfile["spi"]
        dlam = float(np.asarray(self.matfile["dlam"]).squeeze())
        self.name = matfilename.split()[0]
        self.header = [str(self.matfile.get("__header__", "")),
                       f"Dynspec loaded from Matfile {matfilename}"]
        self.dt = 2.7 * 60
        self.freq = 1400
        self.nsub = int(np.shape(self.dyn)[0])
        self.nchan = int(np.shape(self.dyn)[1])
        lams = np.linspace(1, 1 + dlam, self.nchan)
        freqs = 1.0 / lams
        self.freqs = self.freq * np.linspace(np.min(freqs), np.max(freqs),
                                             self.nchan)
        self.bw = max(self.freqs) - min(self.freqs)
        self.times = self.dt * np.arange(self.nsub)
        self.df = self.bw / self.nchan
        self.tobs = float(self.times[-1] - self.times[0])
        self.mjd = 60000.0
        self.dyn = np.transpose(self.dyn)


class SimDyn:
    """Adapter for a ``sim.Simulation`` (its intensity ``spi`` on a
    1/λ-spaced axis, as the reference's adapter builds it)."""

    def __init__(self, sim):
        self.name = "sim:mb2={0}_ar={1}_psi={2}_dlam={3}".format(
            sim.mb2, sim.ar, sim.psi, sim.dlam)
        if sim.lamsteps:
            self.name += ",lamsteps"
        self.header = [self.name]
        self.dyn = np.asarray(sim.spi)
        dlam = sim.dlam
        self.dt = sim.dt
        self.freq = sim.freq
        self.mjd = sim.mjd
        self.nsub = int(np.shape(self.dyn)[0])
        self.nchan = int(np.shape(self.dyn)[1])
        lams = np.linspace(1, 1 + dlam, self.nchan)
        freqs = 1.0 / lams
        self.freqs = self.freq * np.linspace(np.min(freqs), np.max(freqs),
                                             self.nchan)
        self.bw = max(self.freqs) - min(self.freqs)
        self.times = self.dt * np.arange(self.nsub)
        self.df = self.bw / self.nchan
        self.tobs = self.nsub * self.dt
        self.dyn = np.transpose(self.dyn)


class HoloDyn:
    """Adapter for the holography FITS images of Walker et al. 2008: the
    real (and optional imaginary) image, read by ``io.fitsio``."""

    def __init__(self, holofile, imholofile=None, df=1, dt=1, fmin=0,
                 mjd=0):
        from .io.fitsio import read_fits_image

        redata = read_fits_image(holofile)
        imdata = (read_fits_image(imholofile) if imholofile is not None
                  else np.zeros(np.shape(redata)))
        dynt = np.abs(redata + 1j * imdata)
        self.dyn = np.flip(np.transpose(np.flip(dynt, axis=0)), axis=1)
        self.name = os.path.basename(holofile)
        self.header = [self.name]
        self.freqs = np.arange(len(self.dyn)) * df + fmin
        self.times = np.arange(len(self.dyn[0])) * dt
        self.nchan = len(self.freqs)
        self.nsub = len(self.times)
        self.bw = abs(max(self.freqs)) - abs(min(self.freqs))
        self.tobs = max(self.times)
        self.df = df
        self.dt = dt
        self.freq = float(np.mean(np.unique(self.freqs)))
        self.mjd = mjd


def sort_dyn(dynfiles, outdir=None, min_nsub=10, min_nchan=50, min_tsub=10,
             min_freq=0, max_freq=5000, verbose=True, max_frac_bw=2,
             device=None):
    """Sort psrflux files into ``good_files.txt`` and ``bad_files.txt``
    (with the reason) in ``outdir`` (default: the first file's
    directory); returns their paths. A file that does not parse is one
    bad file; a good one is trimmed, refilled, SVD-corrected and gives a
    spectrum with a finite value (on ``device``, ``None``: the card).
    Every decision is also a structured log event (``sort_dyn.reject``,
    ``sort_dyn.accept``; utils/slog.py)."""

    def _reject(bad_files, dynfile, msg):
        bad_files.write(f"{dynfile}\t{msg}\n")
        slog.log_event("sort_dyn.reject", file=dynfile,
                       reason=msg.strip())

    if outdir is None:
        outdir = os.path.split(dynfiles[0])[0]
    bad_path = os.path.join(outdir, "bad_files.txt")
    good_path = os.path.join(outdir, "good_files.txt")
    with open(bad_path, "w") as bad_files, \
            open(good_path, "w") as good_files:
        bad_files.write("FILENAME\t REASON\n")
        for i, dynfile in enumerate(dynfiles):
            if verbose:
                print(f"{i + 1}/{len(dynfiles)}\t"
                      f"{os.path.split(dynfile)[1]}")
            try:
                dyn = Dynspec(filename=dynfile, verbose=False,
                              process=False, device=device)
            except (OSError, ValueError, IndexError, KeyError) as e:
                _reject(bad_files, dynfile, f" malformed: "
                        f"{type(e).__name__}: {str(e)[:120]}")
                continue
            if dyn.freq > max_freq or dyn.freq < min_freq:
                msg = (f"freq<{min_freq} " if dyn.freq < min_freq
                       else f"freq>{max_freq}")
                _reject(bad_files, dynfile, msg)
                continue
            if dyn.bw / dyn.freq > max_frac_bw:
                _reject(bad_files, dynfile, f" frac_bw>{max_frac_bw}")
                continue
            dyn.trim_edges()
            if dyn.nchan < min_nchan or dyn.nsub < min_nsub:
                msg = ""
                if dyn.nchan < min_nchan:
                    msg += f"nchan<{min_nchan} "
                if dyn.nsub < min_nsub:
                    msg += f"nsub<{min_nsub}"
                _reject(bad_files, dynfile, f" {msg}")
                continue
            if dyn.tobs < 60 * min_tsub:
                _reject(bad_files, dynfile, f" tobs<{min_tsub}")
                continue
            dyn.refill()
            dyn.correct_dyn()
            dyn.calc_sspec()
            if np.isnan(dyn.sspec).all():
                _reject(bad_files, dynfile, " sspec_isnan")
                continue
            good_files.write(f"{dynfile}\n")
            slog.log_event("sort_dyn.accept", file=dynfile)
    return good_path, bad_path


# --------------------------------------------------------------------------
# journaled surveys
# --------------------------------------------------------------------------

def run_psrflux_survey(dynfiles, workdir, crop=None, alpha=5 / 3,
                       n_iter=100, pipeline=True, prefetch=4,
                       inflight=2, loader_workers=2, timeline=None,
                       device=None, **runner_kw):
    """Journaled, pipelined scintillation-parameter survey over a list
    of psrflux files on ``device`` (``None``: the card) — the
    Dynspec-level entry to the survey engine
    (``robust.runner.run_survey`` + ``parallel.pipeline``).

    Each file becomes one epoch. Its LOADER (parse with
    ``load_psrflux(survey=True)``, optional ``crop=(nchan, nsub)``
    top-left crop, float32 cast: host work only) runs in the
    background prefetch queue; a malformed or truncated file raises
    :class:`~scintools_tpu_torch.io.MalformedInputError` and is
    quarantined with a journal record while the survey streams on. The
    per-epoch ``process`` uploads the epoch on the dispatching thread
    and runs the acf1d LM fit (``fit.batch.scint_params_batch`` at
    B = 1), whose values stay on the device until the runner consumes
    them (dispatch-ahead). The port has one route for this fit, so the
    ladder has one tier, ``jax_fused`` (the JAX package's name): an
    epoch that fails it after its transient retries is quarantined, not
    run again unchanged under another tier's name. Results journal to
    ``workdir/journal.jsonl``; rerunning the same ``workdir`` resumes.

    ``pipeline=False`` is the sequential oracle (identical journal
    bytes); remaining ``runner_kw`` pass through to
    :func:`~scintools_tpu_torch.robust.runner.run_survey` (``heartbeat``,
    ``report``, ``tiers``, ``retries`` …)."""
    from .robust.ladder import TIER_FUSED
    from .robust.runner import run_survey

    runner_kw.setdefault("tiers", (TIER_FUSED,))

    dev = resolve_device(device)
    load_fn, process = _psrflux_survey_fns(crop, alpha, n_iter, dev)
    epochs = [(os.path.basename(os.fspath(f)),
               _psrflux_loader(f, load_fn)) for f in dynfiles]
    return run_survey(epochs, process, workdir, pipeline=pipeline,
                      prefetch=prefetch, inflight=inflight,
                      loader_workers=loader_workers,
                      timeline=timeline, device=dev, **runner_kw)


def _psrflux_survey_fns(crop, alpha, n_iter, dev):
    """The ``(load_fn, process)`` pair of the psrflux survey:
    ``load_fn(path)`` parses and crops one epoch on the host
    (survey-mode errors → :class:`MalformedInputError`, the quarantining
    kind), ``process(payload, tier=...)`` fits it on ``dev`` (every tier
    the same route)."""
    import torch

    from .fit.batch import scint_params_batch

    def load_fn(path):
        ds = load_psrflux(path, survey=True)
        dyn = np.asarray(ds.dyn, dtype=np.float32)
        if crop is not None:
            dyn = dyn[:crop[0], :crop[1]]
        return dyn, float(ds.dt), float(ds.df)

    def process(payload, tier=None):
        dyn, dt, df = payload
        dyns = torch.as_tensor(np.ascontiguousarray(dyn)[None],
                               device=dev)
        out = scint_params_batch(dyns, dt, df, alpha=alpha, n_iter=n_iter,
                                 device_out=True, device=dev)
        return {k: v[0] for k, v in out.items()}

    return load_fn, process


def _psrflux_loader(path, load_fn):
    """Lazy per-file loader (the runner's callable-payload shape)."""
    def load():
        return load_fn(path)

    return load


def _survey_batch_fns(alpha, n_iter, dev):
    """The batched-service pair: ``process_batch(payloads, tier=...)``
    fits a whole assembled lane group through ONE guarded program on
    ``dev`` (``fit.batch.make_scint_params_serve``: a per-lane ``ok``
    health bitmask, bad lanes NaN and flagged, their neighbours
    bitwise untouched) and brings the group's results to the host in
    one transfer per field, not one per lane; ``geometry_fn(payload)``
    keys the lane assembler, so only same-geometry epochs share a
    batch. Payloads are the survey loaders' ``(dyn, dt, df)``."""
    import torch

    from .fit.batch import make_scint_params_serve

    def process_batch(payloads, tier=None):
        dyns = torch.as_tensor(
            np.stack([np.asarray(p[0], dtype=np.float32)
                      for p in payloads]), device=dev)
        dt, df = float(payloads[0][1]), float(payloads[0][2])
        B, nf, nt = dyns.shape
        program = make_scint_params_serve(B, nf, nt, dt, df, alpha=alpha,
                                          n_iter=n_iter, device=dev)
        out = {k: v.cpu().numpy() for k, v in program(dyns).items()}
        return [{k: (int(v[i]) if k == "ok" else float(v[i]))
                 for k, v in out.items()} for i in range(B)]

    def geometry_fn(payload):
        dyn, dt, df = payload
        return (tuple(np.shape(dyn)), round(float(dt), 9),
                round(float(df), 9))

    return process_batch, geometry_fn


def _serve(load_fn, process, spool_dir, workdir, pattern, poll_s, host,
           port, start, max_batch, alpha, n_iter, dev, service_kw):
    """The service both serving entries build: a :class:`SpoolWatcher`
    over ``spool_dir`` feeding a :class:`SurveyService` (batched when
    ``max_batch`` > 1), with one tier as :func:`run_psrflux_survey`."""
    from .robust.ladder import TIER_FUSED
    from .serve import SpoolWatcher, SurveyService

    if max_batch is not None and max_batch > 1:
        process_batch, geometry_fn = _survey_batch_fns(alpha, n_iter, dev)
        service_kw.setdefault("process_batch", process_batch)
        service_kw.setdefault("geometry_fn", geometry_fn)
        service_kw.setdefault("max_batch", max_batch)
    service_kw.setdefault("tiers", (TIER_FUSED,))
    service_kw.setdefault("http", (host, port))
    source = SpoolWatcher(spool_dir, pattern=pattern, poll_s=poll_s)
    service = SurveyService(source, process, workdir, load_fn=load_fn,
                            **service_kw)
    return service.start() if start else service


def serve_psrflux_survey(spool_dir, workdir, crop=None, alpha=5 / 3,
                         n_iter=100, pattern="*.dynspec", poll_s=0.2,
                         host="127.0.0.1", port=0, start=True,
                         max_batch=None, device=None, **service_kw):
    """Survey as a service on ``device`` (``None``: the card): watch
    ``spool_dir`` for arriving psrflux epochs and stream them through
    the pipelined fit engine for as long as the process lives.

    Each matching file, once COMPLETE (the
    :class:`~scintools_tpu_torch.serve.SpoolWatcher` admits a file only
    after its size stops changing), becomes one epoch: parsed in the
    background prefetch workers, fitted as :func:`run_psrflux_survey`
    fits it (the same ``process``, one tier, the same quarantine),
    fenced, published to the append-only ``workdir/results.jsonl``
    store, deduped by content hash and resumed across restarts. The
    live telemetry listener binds ``host:port`` (``port=0`` =
    ephemeral; see ``service.http_port``): ``/metrics``, ``/healthz``,
    ``/readyz``, ``/report``, ``/state``, ``/ledger``.

    Returns the (started, unless ``start=False``)
    :class:`~scintools_tpu_torch.serve.SurveyService`; call ``stop()``
    for a graceful drain and the final RunReport, or SIGKILL it — the
    next start resumes. Remaining ``service_kw`` pass to
    :class:`~scintools_tpu_torch.serve.SurveyService` (``heartbeat``,
    ``prefetch``/``inflight``/``loader_workers``, ``validate``,
    ``warmup``, ``tenant_policy``, ``tiers``).

    ``max_batch`` (> 1) turns on the batched mode: arrivals assemble
    into lanes of one guarded program per geometry, the batch size
    tracking the backlog up to ``max_batch`` and draining back to
    single-epoch dispatch at idle. Tenant subdirectories of the spool
    become tenant namespaces."""
    dev = resolve_device(device)
    load_fn, process = _psrflux_survey_fns(crop, alpha, n_iter, dev)
    return _serve(load_fn, process, spool_dir, workdir, pattern, poll_s,
                  host, port, start, max_batch, alpha, n_iter, dev,
                  service_kw)


def serve_fits_survey(spool_dir, workdir, dt, df, crop=None, alpha=5 / 3,
                      n_iter=100, pattern="*.fits", poll_s=0.2,
                      host="127.0.0.1", port=0, start=True, max_batch=None,
                      device=None, **service_kw):
    """FITS counterpart of :func:`serve_psrflux_survey`: watch
    ``spool_dir`` for simple FITS images (``io.fitsio.read_fits_image``,
    a primary-HDU 2-D dynspec) and stream them through the same fit.
    A simple FITS image carries no axis calibration, so the caller
    gives the shared ``dt`` [s] and ``df`` [MHz]. A truncated or
    malformed file raises ``MalformedInputError`` in the loader and is
    quarantined while the stream flows on; everything else is shared
    with the psrflux entry."""
    dev = resolve_device(device)
    load_fn, process = _fits_survey_fns(dt, df, crop, alpha, n_iter, dev)
    return _serve(load_fn, process, spool_dir, workdir, pattern, poll_s,
                  host, port, start, max_batch, alpha, n_iter, dev,
                  service_kw)


def _fits_survey_fns(dt, df, crop, alpha, n_iter, dev):
    """The ``(load_fn, process)`` pair of the FITS serving entry:
    ``load_fn`` parses one primary-HDU image into the shared ``(dyn, dt,
    df)`` payload; ``process`` is the psrflux entries' fit."""
    from .io.fitsio import read_fits_image
    from .io.psrflux import MalformedInputError

    _, process = _psrflux_survey_fns(crop, alpha, n_iter, dev)

    def load_fn(path):
        dyn = np.asarray(read_fits_image(path, survey=True),
                         dtype=np.float32)
        if dyn.ndim != 2:
            raise MalformedInputError(
                path, f"expected a 2-D dynspec image, got shape "
                      f"{dyn.shape}")
        if crop is not None:
            dyn = dyn[:crop[0], :crop[1]]
        return dyn, float(dt), float(df)

    return load_fn, process


def _chunk_slices(cf, ct, cwf, cwt, fit=True):
    """Frequency and time slices of chunk (cf, ct): fitting chunks tile
    the plane; retrieval chunks (``fit=False``) half-overlap."""
    if fit:
        return (slice(cf * cwf, (cf + 1) * cwf),
                slice(ct * cwt, (ct + 1) * cwt))
    return (slice(cf * (cwf // 2), cf * (cwf // 2) + cwf),
            slice(ct * (cwt // 2), ct * (cwt // 2) + cwt))


def _centred_chunk(dyn, fs, ts):
    """``dyn[fs, ts]`` less its NaN-mean, NaNs set to 0."""
    chunk = np.array(dyn[fs, ts])
    chunk -= np.nanmean(chunk)
    return np.nan_to_num(chunk)


def _wavefield_grid(dyn, cwf, cwt):
    """Half-overlap retrieval grid of a raw dynspec, chunked as
    ``Dynspec._chunk(fit=False)`` chunks. Returns
    ``chunks[ncf, nct, cwf, cwt]``."""
    nf, nt = dyn.shape
    ncf = nf // (cwf // 2) - 1
    nct = nt // (cwt // 2) - 1
    if ncf < 1 or nct < 1:
        raise ValueError(f"dynspec {dyn.shape} too small for "
                         f"{cwf}x{cwt} half-overlap chunks")
    chunks = np.zeros((ncf, nct, cwf, cwt))
    for cf in range(ncf):
        for ct in range(nct):
            chunks[cf, ct] = _centred_chunk(
                dyn, *_chunk_slices(cf, ct, cwf, cwt, fit=False))
    return chunks


def _wavefield_survey_fns(edges, eta, cwf, cwt, npad, tau_mask, method,
                          workdir, save_wavefields, dev):
    """``process(payload, tier=...)`` of the wavefield survey: one
    epoch's stitched wavefield on the tier's route, as JSON-able
    scalars (+ an atomically written ``.npy``). Tiers, all on ``dev``:

    - ``jax_fused`` — the batched retrieval
      (``thth.retrieval.campaign_retrieval_batch``: the
      ``eigvec_warmstart`` kernel on the card) and the device mosaic;
    - ``jax_staged`` — the same batched retrieval, stitched by the
      greedy host ``mosaic`` oracle;
    - ``numpy`` — the looped ``single_chunk_retrieval`` (each chunk's
      eigenpair a chain of one) and the host ``mosaic`` (the reference
      route).

    Every tier launches the ``eigvec_warmstart`` kernel on the card.
    """
    import hashlib
    import io as _io

    import torch

    from .parallel.checkpoint import atomic_write_bytes
    from .robust.ladder import TIER_NUMPY, TIER_STAGED

    edges = np.asarray(edges, dtype=float)
    wf_dir = os.path.join(workdir, "wavefields")

    def _host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    def process(payload, tier=None):
        dyn, times, freqs = payload
        epoch_key = hashlib.sha256(
            np.ascontiguousarray(dyn).tobytes()).hexdigest()[:16]
        dt = float(times[1] - times[0])
        df = float(freqs[1] - freqs[0])
        chunks = _wavefield_grid(np.asarray(dyn, dtype=float), cwf, cwt)
        ncf, nct = chunks.shape[:2]
        fref = float(np.asarray(freqs, dtype=float).mean())
        # per-frequency-row scaled geometry (the façade's row inputs)
        etas_rows = np.zeros(ncf)
        edges_rows = np.zeros((ncf, len(edges)))
        for cf in range(ncf):
            fsl = np.asarray(
                freqs[_chunk_slices(cf, 0, cwf, cwt, fit=False)[0]],
                dtype=float)
            etas_rows[cf] = eta * (fref / fsl.mean()) ** 2
            edges_rows[cf] = edges * (fsl.mean() / fref)
        if tier == TIER_NUMPY:
            Ec = np.zeros((ncf, nct, cwf, cwt), dtype=complex)
            for cf in range(ncf):
                for ct in range(nct):
                    fs, ts = _chunk_slices(cf, ct, cwf, cwt, fit=False)
                    Ec[cf, ct] = thth_ret.single_chunk_retrieval(
                        chunks[cf, ct], edges_rows[cf], times[ts],
                        freqs[fs], etas_rows[cf], npad=npad,
                        tau_mask=tau_mask, device=dev)[0]
            n_quar = int(sum(not np.any(Ec[cf, ct])
                             for cf in range(ncf) for ct in range(nct)))
            wf = thth_ret.mosaic(Ec)
        elif tier == TIER_STAGED:
            Ec, ok = thth_ret.campaign_retrieval_batch(
                chunks[None], edges_rows, etas_rows, dt, df, npad=npad,
                tau_mask=tau_mask, method=method, stitch=False,
                device=dev)
            n_quar = int(np.count_nonzero(_host(ok)))
            wf = thth_ret.mosaic(_host(Ec)[0].astype(complex))
        else:
            wf_b, ok = thth_ret.campaign_retrieval_batch(
                chunks[None], edges_rows, etas_rows, dt, df, npad=npad,
                tau_mask=tau_mask, method=method, device=dev)
            n_quar = int(np.count_nonzero(_host(ok)))
            wf = _host(wf_b)[0]
        wf = np.asarray(wf, dtype=complex)
        rec = {"n_chunks": int(ncf * nct), "ncf": ncf, "nct": nct,
               "n_quarantined": n_quar,
               "wf_power": float(np.mean(np.abs(wf) ** 2)),
               "wf_sha": hashlib.sha256(wf.tobytes()).hexdigest()}
        if save_wavefields:
            os.makedirs(wf_dir, exist_ok=True)
            fname = f"{epoch_key}.npy"
            buf = _io.BytesIO()
            np.save(buf, wf)
            atomic_write_bytes(os.path.join(wf_dir, fname), buf.getvalue())
            rec["file"] = os.path.join("wavefields", fname)
        return rec

    return process


def run_wavefield_survey(epochs, workdir, edges, eta, cwf, cwt, npad=3,
                         tau_mask=0.0, method=None, save_wavefields=True,
                         device=None, **runner_kw):
    """Campaign-scale phase-retrieval survey on ``device`` (``None``:
    the card): every epoch's complex wavefield retrieved and
    mosaic-stitched through the ladder/journal/resume/report stack
    (``robust.runner.run_survey``).

    ``epochs`` is an iterable of ``(epoch_id, payload)`` where the
    payload (or the value of a CALLABLE lazy loader, loaded in the
    runner's background prefetch queue) is ``(dyn[nf, nt], times[nt],
    freqs[nf])``. All epochs share one chunk geometry
    (``cwf``/``cwt``/``edges``), so the survey reuses one built
    retrieval. ``eta`` is the campaign curvature at the epoch band
    centre, scaled per frequency row as ``Dynspec.thetatheta_chunks``
    does.

    Per-epoch results journal to ``workdir/journal.jsonl`` (chunk
    counts, quarantine count, wavefield power + sha) and each stitched
    wavefield is written atomically to
    ``workdir/wavefields/<epoch key>.npy`` (``save_wavefields=False``
    to skip). Tier ladder, quarantine, resume, heartbeat and report:
    :func:`~scintools_tpu_torch.robust.runner.run_survey` (tiers
    documented on :func:`_wavefield_survey_fns`)."""
    from .robust.runner import run_survey

    dev = resolve_device(device)
    process = _wavefield_survey_fns(edges, eta, cwf, cwt, npad, tau_mask,
                                    method, workdir, save_wavefields, dev)
    return run_survey(epochs, process, workdir, device=dev, **runner_kw)
