"""The curvature (η) template bank, on a torch device.

Counterpart of ``scintools_tpu/detect/bank.py``: :class:`TemplateBank`
(:50), :func:`eta_grid` (:101), ``_bank_program`` (:120) and
:func:`build_bank` (:170). An arc of curvature η is the parabolic ridge
τ = η·f_D² of the halved secondary-spectrum frame (positive delays,
fftshifted Doppler, the frame of ``ops.sspec.secondary_spectrum_power``),
so a template is a normalised parabolic band over that frame and the
bank a log-spaced η grid:

- a Gaussian band around the parabola, σ(f_D) = σ₀·Δτ + rel_width·η·f_D²;
- both Doppler arms;
- a validity mask without the zero-Doppler column(s) and the zero-delay
  row (the DC ridge carries power in every epoch);
- zero mean over the valid region and unit L2 norm, so a template is a
  contrast filter and, under the correlator's standardised input, a
  score is a significance.

The bank is built once per geometry and device (``detect.bank`` site),
in float32 as the JAX package's, and its ``T[K, R·C]`` matrix stays on
the device. :meth:`TemplateBank.from_numpy` carries a bank made
elsewhere (the JAX package's, field by field) onto a device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import fifo_cached, resolve_device
from ..obs import retrace as _retrace
from ..ops.sspec import fft_shapes, sspec_axes

#: default number of templates; the bank prunes, it only has to land
#: within the θ-θ confirmation window of the truth
DEFAULT_N_TEMPLATES = 48


class TemplateBank:
    """One geometry's template bank: the η grid, the template matrix on
    the device and the frame bookkeeping of the correlator.

    ``templates`` is ``f32[K, R·C]`` (the flattened halved frame, delay
    rows × fftshifted Doppler columns), zero-mean over the valid region
    and unit-norm per row; ``valid`` is ``f32[R·C]`` (1 = the pixel is
    scored). Build through :func:`build_bank`, which caches per
    geometry."""

    __slots__ = ("etas", "templates", "valid", "tdel", "fdop", "shape",
                 "geometry", "params")

    def __init__(self, etas, templates, valid, tdel, fdop, shape, geometry,
                 params):
        self.etas = etas                    # host f64 [K]
        self.templates = templates          # device f32 [K, P]
        self.valid = valid                  # device f32 [P]
        self.tdel = tdel                    # host f64 [R] (µs)
        self.fdop = fdop                    # host f64 [C] (mHz)
        self.shape = shape                  # (R, C) sspec frame
        self.geometry = geometry            # (nf, nt, dt, df)
        self.params = params                # build knobs (JSON-able)

    @classmethod
    def from_numpy(cls, etas, templates, valid, tdel, fdop, shape,
                   geometry, params, device=None):
        """A bank from host arrays (for one, ``np.asarray`` of each field
        of the JAX package's bank), its matrices put on ``device``
        (``None``: the card) as float32."""
        dev = resolve_device(device)
        return cls(np.asarray(etas, dtype=float),
                   torch.tensor(np.asarray(templates, dtype=np.float32),
                                device=dev),
                   torch.tensor(np.asarray(valid, dtype=np.float32),
                                device=dev),
                   np.asarray(tdel, dtype=float),
                   np.asarray(fdop, dtype=float),
                   tuple(int(v) for v in shape),
                   (int(geometry[0]), int(geometry[1]), float(geometry[2]),
                    float(geometry[3])), dict(params))

    @property
    def device(self):
        return self.templates.device

    @property
    def n_templates(self):
        return len(self.etas)

    @property
    def n_pixels(self):
        return int(self.shape[0] * self.shape[1])

    def describe(self):
        """JSON-able view for reports and records."""
        return {
            "n_templates": int(self.n_templates),
            "eta_range": [float(self.etas[0]), float(self.etas[-1])],
            "frame": list(self.shape),
            "geometry": {"nf": self.geometry[0], "nt": self.geometry[1],
                         "dt": self.geometry[2], "df": self.geometry[3]},
            **self.params,
        }


def eta_grid(eta_min, eta_max, n=DEFAULT_N_TEMPLATES):
    """Log-spaced curvature grid [s³ ≡ µs/mHz² on the sspec axes]: log
    spacing matches the templates' relative band width."""
    if not (0 < eta_min < eta_max):
        raise ValueError(f"need 0 < eta_min < eta_max, got "
                         f"({eta_min}, {eta_max})")
    return np.geomspace(float(eta_min), float(eta_max), int(n))


def _valid_mask(tdel, fdop, tau_min, fd_min):
    return ((np.abs(fdop)[None, :] >= fd_min)
            & (tdel[:, None] >= tau_min)).astype(np.float32)


_BANK_PROGRAM_CACHE = {}
_BANK_CACHE = {}
_MAX_CACHED = 8


def _bank_program(tdel, fdop, tau_min, fd_min, sigma0, rel_width, dev):
    """The bank builder ``build(etas[K]) → T[K, R·C]`` of one frame, width
    law and device; the η grid is an input, so re-spanning builds
    nothing."""
    key = (tdel.tobytes(), fdop.tobytes(), float(tau_min), float(fd_min),
           float(sigma0), float(rel_width), str(dev))

    def make():
        _retrace.record_build("detect.bank", key)
        f32 = torch.float32
        tdel32 = torch.as_tensor(tdel, dtype=f32, device=dev)
        fdop32 = torch.as_tensor(fdop, dtype=f32, device=dev)
        dtau = float(tdel[1] - tdel[0])
        valid2d = _valid_mask(tdel, fdop, tau_min, fd_min)
        valid = torch.as_tensor(valid2d, device=dev)
        n_valid = float(valid2d.sum())

        def build(etas):
            # arc band: |τ − η·f_D²| against a widening Gaussian
            arc = etas[:, None, None] * fdop32[None, None, :] ** 2
            sig = sigma0 * dtau + rel_width * arc
            w = torch.exp(-0.5 * ((tdel32[None, :, None] - arc) / sig) ** 2)
            w = w * valid[None]
            # contrast filter: zero mean over the valid region …
            mu = w.sum(dim=(1, 2), keepdim=True) / n_valid
            t = (w - mu) * valid[None]
            # … and unit L2 norm per template
            nrm = torch.sqrt((t * t).sum(dim=(1, 2), keepdim=True))
            t = t / torch.clamp(nrm, min=1e-20)
            return t.reshape(t.shape[0], -1)

        return build

    return fifo_cached(_BANK_PROGRAM_CACHE, key, make, _MAX_CACHED)


def build_bank(nf, nt, dt, df, eta_min, eta_max,
               n_templates=DEFAULT_N_TEMPLATES, tau_min=None, fd_min=None,
               sigma0=1.0, rel_width=0.1, device=None):
    """Build (or return the cached) :class:`TemplateBank` of one epoch
    geometry on ``device`` (``None``: the card).

    ``nf, nt``: dynspec shape (frequency channels × time subints);
    ``dt`` [s] / ``df`` [MHz]: the axis steps (they set the sspec τ/f_D
    axes); ``eta_min, eta_max`` [s³]: the log η span; ``tau_min`` [µs] /
    ``fd_min`` [mHz]: the DC exclusions (defaults: one delay bin, 1.5
    Doppler bins); ``sigma0``/``rel_width``: the band width law."""
    dev = resolve_device(device)
    nrfft, ncfft = fft_shapes(nf, nt)
    fdop, tdel, _ = sspec_axes(nf, nt, dt, df, halve=True)
    if tau_min is None:
        tau_min = float(tdel[1])            # exclude the τ=0 row
    if fd_min is None:
        fd_min = 1.5 * float(fdop[1] - fdop[0])
    etas = eta_grid(eta_min, eta_max, n_templates)
    key = (int(nf), int(nt), float(dt), float(df), etas.tobytes(),
           float(tau_min), float(fd_min), float(sigma0), float(rel_width),
           str(dev))

    def make():
        fn = _bank_program(tdel, fdop, tau_min, fd_min, sigma0, rel_width,
                           dev)
        T = fn(torch.as_tensor(etas, dtype=torch.float32, device=dev))
        return TemplateBank(
            etas=etas, templates=T,
            valid=torch.as_tensor(
                _valid_mask(tdel, fdop, tau_min, fd_min).ravel(),
                device=dev),
            tdel=tdel, fdop=fdop, shape=(nrfft // 2, ncfft),
            geometry=(int(nf), int(nt), float(dt), float(df)),
            params={"tau_min": float(tau_min), "fd_min": float(fd_min),
                    "sigma0": float(sigma0),
                    "rel_width": float(rel_width)})

    return fifo_cached(_BANK_CACHE, key, make, _MAX_CACHED)
