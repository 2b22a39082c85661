"""Electromagnetic scintillation simulator (Coles et al. 2010) on a
torch device.

Counterpart of ``scintools_tpu/sim/simulation.py``: ``_swdsp`` (:39),
``hermitian_fill`` (:57), ``screen_weights`` (:103), ``fresnel_filter_q2``
(:114), ``propagate`` (:124), the ``Simulation`` class (:200-437) and
``make_dynspec_batch_fn`` / ``simulate_dynspec_batch`` (:443-475).

A Kolmogorov phase screen is drawn in the spectral domain and
propagated to the observer plane with a Fresnel quadratic-phase filter,
once per frequency channel:

- the spectral weights ``w`` are the reference's hermitian fill, built
  on the host in float64 numpy (copied, bit for bit);
- the normals are drawn on the host from an explicit
  ``np.random.RandomState(seed_used)``, two ``randn(nx, ny)`` calls: the
  stream of the JAX package's default numpy backend, without touching
  numpy's global state, so ``Simulation(seed=s)`` here equals the JAX
  package's ``Simulation(seed=s)`` to FFT rounding;
- ``φ = Re fft2(w·(N + iN))`` and the per-frequency ``fft2 → filter →
  ifft2 → centre column`` run on the device in float64/complex128, the
  frequency axis walked in groups (:data:`PROP_GROUP_ELEMENTS`) so the
  whole (nf, nx, ny) stack never lives at once;
- the impulse response (``get_pulse``), the lazy last-plane intensity
  ``xyi`` and the packaging stay host numpy, as in the JAX package.

Plotting (``plot=`` and the ``plot_*`` methods) is not ported.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from scipy.special import gamma as _gamma

from ..backend import resolve_device

SPEED_OF_LIGHT = 299792458.0  # m/s

#: complex128 elements of one frequency group of the propagation
#: (2**25: 512 MB, 128 channels of a 512² screen)
PROP_GROUP_ELEMENTS = 2 ** 25


def _swdsp(kx, ky, psi, ar, alpha, inner, consp):
    """Anisotropic Kolmogorov spectral weight √P(kx,ky)
    (scint_sim.py:276-292)."""
    cs = np.cos(psi * np.pi / 180)
    sn = np.sin(psi * np.pi / 180)
    r = ar
    con = np.sqrt(consp)
    alf = -(alpha + 2) / 4
    a = (cs ** 2) / r + r * sn ** 2
    b = r * cs ** 2 + sn ** 2 / r
    c = 2 * cs * sn * (1 / r - r)
    q2 = a * kx ** 2 + b * ky ** 2 + c * kx * ky
    with np.errstate(divide="ignore"):
        out = con * q2 ** alf * np.exp(-(kx ** 2 + ky ** 2)
                                       * inner ** 2 / 2)
    return out


def hermitian_fill(nx, ny, dqx, dqy, swdsp):
    """The reference's exact hermitian fill pattern
    (scint_sim.py:175-198), vectorised, with the spectral function
    abstracted out: ``swdsp(kx, ky)`` is evaluated on the reference's
    wavenumber arguments and its values are mirrored into the conjugate
    cells (value copies, so the reference's one-off mirror indexing
    quirks are kept bit for bit). Called with extractor functions
    (``lambda kx, ky: kx + 0 * ky``) it gives the effective per-cell
    wavenumber grids (``factory.effective_wavenumbers``)."""
    nx2 = int(nx / 2 + 1)
    ny2 = int(ny / 2 + 1)
    w = np.zeros([nx, ny])

    # ky=0 line
    k = np.arange(2, nx2 + 1)
    w[k - 1, 0] = swdsp((k - 1) * dqx, np.zeros(len(k)))
    w[nx + 1 - k, 0] = w[k, 0]
    # kx=0 line
    ll = np.arange(2, ny2 + 1)
    w[0, ll - 1] = swdsp(np.zeros(len(ll)), (ll - 1) * dqy)
    w[0, ny + 1 - ll] = w[0, ll - 1]
    # rest of the field (vectorised over the reference's il loop)
    kp = np.arange(2, nx2 + 1)
    k = np.arange(nx2 + 1, nx + 1)
    km = -(nx - k + 1)
    il = np.arange(2, ny2 + 1)
    w[np.ix_(kp - 1, il - 1)] = swdsp(((kp - 1) * dqx)[:, None]
                                      + 0 * il[None, :],
                                      ((il - 1) * dqy)[None, :]
                                      + 0 * kp[:, None])
    w[np.ix_(k - 1, il - 1)] = swdsp((km * dqx)[:, None]
                                     + 0 * il[None, :],
                                     ((il - 1) * dqy)[None, :]
                                     + 0 * km[:, None])
    w[np.ix_(nx + 1 - kp, ny + 1 - il)] = w[np.ix_(kp - 1, il - 1)]
    w[np.ix_(nx + 1 - k, ny + 1 - il)] = w[np.ix_(k - 1, il - 1)]
    return w


def screen_weights(nx, ny, dx, dy, psi, ar, alpha, inner, consp):
    """Spectral weight array ``w[nx, ny]`` with the reference's exact
    hermitian fill (scint_sim.py:175-198), vectorised."""
    dqx = 2 * np.pi / (dx * nx)
    dqy = 2 * np.pi / (dy * ny)
    return hermitian_fill(
        nx, ny, dqx, dqy,
        lambda kx, ky: _swdsp(kx, ky, psi, ar, alpha, inner, consp))


def fresnel_filter_q2(nx, ny, ffconx, ffcony):
    """Quadratic-phase exponent grid q2[i,j] = ffconx·min(i,nx−i)² +
    ffcony·min(j,ny−j)² — closed form of the reference's quadrant
    filter (scint_sim.py:294-311)."""
    ix = np.minimum(np.arange(nx), nx - np.arange(nx)).astype(float)
    iy = np.minimum(np.arange(ny), ny - np.arange(ny)).astype(float)
    return ffconx * ix[:, None] ** 2 + ffcony * iy[None, :] ** 2


def screen_from_normals(w, re, im, device=None):
    """``φ = Re fft2(w·(re + i·im))`` on ``device`` in complex128, as a
    float64 tensor (the screen recipe of scint_sim.py:199-207)."""
    dev = resolve_device(device)
    field = torch.complex(torch.as_tensor(w * re, device=dev),
                          torch.as_tensor(w * im, device=dev))
    return torch.fft.fft2(field).real


def propagate(xyp, q2, scales, column, device=None):
    """Fresnel-propagate the phase screen ``xyp[nx, ny]`` to the
    observer plane for each frequency scale: ``spe[nx, nf]`` complex128
    on ``device``, column ``f`` being

        ifft2(fft2(exp(i·φ·s_f)) · exp(−i·q2·s_f))[:, column]

    (scint_sim.py:226-230). Any screen is taken (numpy or tensor; the
    tests hand it the JAX backend's). The frequency axis is walked in
    groups of ``PROP_GROUP_ELEMENTS // (nx·ny)`` channels."""
    dev = resolve_device(device)
    if isinstance(xyp, torch.Tensor):
        xyp = xyp.to(dev, torch.float64)
    else:
        xyp = torch.as_tensor(np.array(xyp, dtype=float), device=dev)
    q2 = torch.as_tensor(np.asarray(q2), dtype=torch.float64, device=dev)
    scales = torch.as_tensor(np.asarray(scales, dtype=float),
                             dtype=torch.float64, device=dev)
    nx, ny = xyp.shape
    nf = scales.shape[0]
    per = max(1, PROP_GROUP_ELEMENTS // (nx * ny))
    spe = torch.empty((nx, nf), dtype=torch.complex128, device=dev)
    for f0 in range(0, nf, per):
        s = scales[f0:f0 + per, None, None]
        xye = torch.fft.fft2(torch.exp(1j * (xyp * s)))
        xye = xye * torch.exp(-1j * (q2 * s))
        spe[:, f0:f0 + per] = torch.fft.ifft2(xye)[:, :, column].T
    return spe


class Simulation:
    """The reference ``Simulation`` class on ``device`` (``None``: the
    CUDA card). Parameters follow scint_sim.py:25-45; ``backend`` is the
    JAX package's and must stay None."""

    def __init__(self, mb2=2, rf=1, ds=0.01, alpha=5 / 3, ar=1, psi=0,
                 inner=0.001, ns=256, nf=256, dlam=0.25, lamsteps=False,
                 seed=None, nx=None, ny=None, dx=None, dy=None,
                 plot=False, verbose=False, freq=1400, dt=30, mjd=60000,
                 nsub=None, efield=False, noise=None, backend=None,
                 device=None):
        if backend is not None:
            raise NotImplementedError(
                "backend= is the JAX package's; the port runs on device=")
        if plot:
            raise NotImplementedError("the port has no plotting")
        self.device = resolve_device(device)
        self.mb2 = mb2
        self.rf = rf
        self.ds = ds
        self.dx = dx if dx is not None else ds
        self.dy = dy if dy is not None else ds
        self.alpha = alpha
        self.ar = ar
        self.psi = psi
        self.inner = inner
        self.nx = nx if nx is not None else ns
        self.ny = ny if ny is not None else ns
        self.nf = nf
        self.dlam = dlam
        self.lamsteps = lamsteps
        self.seed = seed
        self.noise = noise  # accepted-and-unused upstream too

        self.set_constants()
        if verbose:
            print("Computing screen phase")
        self.get_screen()
        if verbose:
            print("Getting intensity...")
        self.get_intensity()
        if nf > 1:
            if verbose:
                print("Computing dynamic spectrum")
            self.get_dynspec()
        if verbose:
            print("Getting impulse response...")
        self.get_pulse()

        # physical-units packaging (scint_sim.py:81-134)
        self.name = "sim:mb2={0},ar={1},psi={2},dlam={3}".format(
            self.mb2, self.ar, self.psi, self.dlam)
        if lamsteps:
            self.name += ",lamsteps"
        self.header = [self.name, "MJD0: {}".format(mjd)]
        dyn = np.real(self.spe) if efield else self.spi

        self.dt = dt
        self.freq = freq
        self.nsub = int(np.shape(dyn)[0]) if nsub is None else nsub
        self.nchan = int(np.shape(dyn)[1])
        if not lamsteps:
            self.df = self.freq * self.dlam / (self.nchan - 1)
            self.freqs = self.freq + np.arange(-self.nchan / 2,
                                               self.nchan / 2, 1) * self.df
        else:
            self.lam = SPEED_OF_LIGHT / (self.freq * 10 ** 6)
            self.dl = self.lam * self.dlam / (self.nchan - 1)
            self.lams = self.lam + np.arange(-self.nchan / 2,
                                             self.nchan / 2, 1) * self.dl
            self.freqs = SPEED_OF_LIGHT / self.lams / 10 ** 6
            self.freq = (np.max(self.freqs) - np.min(self.freqs)) / 2
        self.bw = max(self.freqs) - min(self.freqs)
        self.times = self.dt * np.arange(0, self.nsub)
        self.df = self.bw / self.nchan
        self.tobs = float(self.times[-1] - self.times[0])
        self.mjd = mjd
        if nsub is not None:
            dyn = dyn[0:nsub, :]
        self.dyn = np.transpose(dyn)

        # theoretical arc curvature oracle (scint_sim.py:123-133)
        V = self.ds / self.dt
        k_wave = 2 * np.pi / self.freq
        L = self.rf ** 2 * k_wave
        self.eta = (L / (2 * V ** 2) / 10 ** 6
                    / np.cos(psi * np.pi / 180) ** 2)
        beta_to_eta = SPEED_OF_LIGHT * 1e6 / ((self.freq * 10 ** 6) ** 2)
        self.betaeta = self.eta / beta_to_eta

    # ------------------------------------------------------------------
    def set_constants(self):
        """Normalisation constants (scint_sim.py:137-167)."""
        ns = 1
        lenx = self.nx * self.dx
        leny = self.ny * self.dy
        self.ffconx = (2.0 / (ns * lenx * lenx)) * (np.pi * self.rf) ** 2
        self.ffcony = (2.0 / (ns * leny * leny)) * (np.pi * self.rf) ** 2
        dqx = 2 * np.pi / lenx
        dqy = 2 * np.pi / leny
        a2 = self.alpha * 0.5
        aa = 1.0 + a2
        ab = 1.0 - a2
        cdrf = (2.0 ** self.alpha * np.cos(self.alpha * np.pi * 0.25)
                * _gamma(aa) / self.mb2)
        self.s0 = self.rf * cdrf ** (1.0 / self.alpha)
        cmb2 = self.alpha * self.mb2 / (
            4 * np.pi * _gamma(ab) * np.cos(self.alpha * np.pi * 0.25) * ns)
        self.consp = cmb2 * dqx * dqy / (self.rf ** self.alpha)
        self.scnorm = 1.0 / (self.nx * self.ny)
        self.sref = self.rf ** 2 / self.s0

    def get_screen(self):
        """Phase screen φ(x,y) = Re fft2(w·(N + iN))
        (scint_sim.py:169-207): ``w`` and the normals on the host, the
        transform on the device.

        An explicit integer ``seed`` (≥ 0) is deterministic; ``None``
        and the reference's ``-1`` draw fresh entropy on every call. The
        seed used is kept as ``self.seed_used``, so an unseeded run can
        be reproduced."""
        w = screen_weights(self.nx, self.ny, self.dx, self.dy, self.psi,
                           self.ar, self.alpha, self.inner, self.consp)
        self.w = w
        self.seed_used = (int.from_bytes(os.urandom(4), "little")
                          & 0x7FFFFFFF) \
            if self.seed in (None, -1) else int(self.seed)
        rs = np.random.RandomState(self.seed_used)
        re = rs.randn(self.nx, self.ny)
        im = rs.randn(self.nx, self.ny)
        self._xyp_dev = screen_from_normals(w, re, im, device=self.device)
        self.xyp = self._xyp_dev.cpu().numpy()

    def frfilt3(self, xye, scale):
        """Apply the Fresnel quadratic-phase filter in place (the
        reference's quadrant-sliced method, scint_sim.py:294-311, in
        the closed form of :func:`fresnel_filter_q2`)."""
        q2 = fresnel_filter_q2(self.nx, self.ny, self.ffconx,
                               self.ffcony)
        xye *= np.exp(-1j * q2 * scale)
        return xye

    def frequency_scales(self):
        ifreq = np.arange(self.nf)
        if self.lamsteps:
            return 1.0 + self.dlam * (ifreq - 1 - self.nf / 2) / self.nf
        frfreq = 1.0 + self.dlam * (-0.5 + ifreq / self.nf)
        return 1.0 / frfreq

    def get_intensity(self):
        """Fresnel propagation per frequency → host ``spe[nx, nf]``
        (scint_sim.py:209-236). The device copy of the screen that
        :meth:`get_screen` just made is used, then dropped (it would go
        stale if the caller edits ``self.xyp``)."""
        q2 = fresnel_filter_q2(self.nx, self.ny, self.ffconx, self.ffcony)
        column = int(np.floor(self.ny / 2))
        xyp = self.__dict__.pop("_xyp_dev", self.xyp)
        self.spe = propagate(xyp, q2, self.frequency_scales(), column,
                             device=self.device).cpu().numpy()
        self._q2 = q2

    @property
    def xyi(self):
        """Intensity image at the last frequency (the reference keeps the
        loop's final plane, scint_sim.py:232-234); host numpy, computed
        on first use."""
        if not hasattr(self, "_xyi"):
            scale = self.frequency_scales()[-1]
            xye = np.fft.ifft2(
                np.fft.fft2(np.exp(1j * self.xyp * scale))
                * np.exp(-1j * self._q2 * scale))
            self._xyi = np.real(xye * np.conj(xye))
        return self._xyi

    def get_dynspec(self):
        """spi = |spe|² plus normalised axes (scint_sim.py:238-252)."""
        self.spi = np.real(self.spe * np.conj(self.spe))
        self.x = np.linspace(0, self.dx * self.nx, self.nx)
        ifreq = np.linspace(0, self.nf - 1, self.nf)
        lam_norm = 1.0 + self.dlam * (ifreq - 1 - self.nf / 2) / self.nf
        self.lams = lam_norm / np.mean(lam_norm)
        frfreq = 1.0 + self.dlam * (-0.5 + ifreq / self.nf)
        self.freqs = frfreq / np.mean(frfreq)

    def get_pulse(self):
        """Intensity impulse response vs position (scint_sim.py:254-274),
        a host FFT as in the JAX package."""
        p = np.fft.fft(self.spe * np.blackman(self.nf), 2 * self.nf)
        p = np.real(p * np.conj(p))
        self.pulsewin = np.transpose(np.roll(p, self.nf, axis=-1))
        self.dm = self.xyp[:, int(self.ny / 2)] * self.dlam / np.pi

    # -- plotting (scint_sim.py:313-415): not ported --------------------
    def _no_plot(self, *args, **kwargs):
        raise NotImplementedError("the port has no plotting")

    plot_screen = plot_intensity = plot_dynspec = plot_efield = _no_plot
    plot_delay = plot_pulse = plot_all = _no_plot


def make_dynspec_batch_fn(mb2=2, rf=1, ds=0.01, alpha=5 / 3, ar=1, psi=0,
                          inner=0.001, ns=128, nf=128, dlam=0.25,
                          device=None):
    """Batched simulator ``fn(keys[B]) → dynspecs[B, ns, nf]`` (a tensor
    on ``device``) over the scenario factory (``factory.py``): the
    scalar parameters ride the lane axis, lanes are keyed by ``keys``
    (integer lane seeds, ``factory.lane_keys_from_seeds``)."""
    from .factory import simulate_scenarios

    def fn(keys):
        return simulate_scenarios(
            int(np.shape(keys)[0]), mb2=mb2, ar=ar, psi=psi, alpha=alpha,
            ns=ns, nf=nf, dlam=dlam, rf=rf, ds=ds, inner=inner, keys=keys,
            device_out=True, device=device)

    return fn


def simulate_dynspec_batch(nscreens, mb2=2, rf=1, ds=0.01, alpha=5 / 3,
                           ar=1, psi=0, inner=0.001, ns=128, nf=128,
                           dlam=0.25, seed=0, device=None):
    """``nscreens`` dynspecs ``(B, ns, nf)`` from the scenario factory,
    lanes seeded from ``seed`` (a tensor on ``device``)."""
    from .factory import simulate_scenarios

    return simulate_scenarios(
        nscreens, mb2=mb2, ar=ar, psi=psi, alpha=alpha, ns=ns, nf=nf,
        dlam=dlam, rf=rf, ds=ds, inner=inner, seed=seed, device_out=True,
        device=device)
