"""Delay-Doppler spectrum from a scattered angular spectrum (Yao et al.
2020; Coles' original Matlab) on a torch device.

Counterpart of ``scintools_tpu/sim/brightness.py:20-138``: the
brightness distribution is the host float64 FFT of the analytic e-field
ACF (as in the JAX package); the map to (delay, Doppler) runs on the
device in float64 — the Jacobian over the whole grid at once and the
bilinear lookup on the regular brightness grid as gathers (NaN outside
it), then the point-mirrored sum — and the ACF is an FFT of the
spectrum on the device. Plotting is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import resolve_device

F64 = torch.float64


def _bilinear(B, x0, dx, qx, qy):
    """Sample the tensor ``B`` (indexed [y, x]) on the regular grid with
    origin ``x0`` and step ``dx`` at the points (qx, qy); NaN outside
    the grid."""
    fx = (qx - x0) / dx
    fy = (qy - x0) / dx
    n = B.shape[0]
    ix = torch.clamp(torch.floor(fx).long(), 0, n - 2)
    iy = torch.clamp(torch.floor(fy).long(), 0, n - 2)
    tx = fx - ix
    ty = fy - iy
    v = (B[iy, ix] * (1 - tx) * (1 - ty) + B[iy, ix + 1] * tx * (1 - ty)
         + B[iy + 1, ix] * (1 - tx) * ty + B[iy + 1, ix + 1] * tx * ty)
    inside = (fx >= 0) & (fx <= n - 1) & (fy >= 0) & (fy <= n - 1)
    return torch.where(inside, v, np.nan)


class Brightness:
    """Analytic brightness distribution → secondary spectrum → ACF on
    ``device`` (``None``: the CUDA card). Results are host numpy arrays,
    named as in the JAX package; ``backend`` is the JAX package's and
    must stay None."""

    def __init__(self, ar=1.0, psi=0, alpha=1.67, thetagx=0, thetagy=0,
                 thetarx=0, thetary=0, df=0.02, dt=0.08, dx=0.1,
                 nf=10, nt=80, nx=30, ncuts=5, plot=False, contour=True,
                 figsize=(10, 8), calc_sspec=True, calc_acf=True,
                 backend=None, device=None):
        if backend is not None:
            raise NotImplementedError(
                "backend= is the JAX package's; the port runs on device=")
        if plot:
            raise NotImplementedError("the port has no plotting")
        self.device = resolve_device(device)
        self.ar = ar
        self.alpha = alpha
        self.thetagx = thetagx
        self.thetagy = thetagy
        self.thetarx = thetarx
        self.thetary = thetary
        self.psi = psi
        self.df = df
        self.dt = dt
        self.dx = dx
        self.nf = nf
        self.nt = nt
        self.nx = nx
        self.ncuts = ncuts

        self.calc_brightness()
        if calc_sspec:
            self.calc_SS()
        if calc_acf:
            self.calc_acf()

    def calc_brightness(self):
        """E-field ACF → fft2 → brightness B(θx, θy), host float64
        (scint_sim.py:838-869)."""
        x = np.arange(-self.nx, self.nx, self.dx)
        self.X, self.Y = np.meshgrid(x, x)
        R = (self.ar ** 2 - 1) / (self.ar ** 2 + 1)
        cosa = np.cos(2 * (90 - self.psi) * np.pi / 180)
        sina = np.sin(2 * (90 - self.psi) * np.pi / 180)
        a = (1 - R * cosa) / np.sqrt(1 - R ** 2)
        b = (1 + R * cosa) / np.sqrt(1 - R ** 2)
        c = -2 * R * sina / np.sqrt(1 - R ** 2)
        Rho = np.exp(-0.5 * (a * self.X ** 2 + b * self.Y ** 2
                             + c * self.X * self.Y) ** (self.alpha / 2))
        self.x = x
        self.acf_efield = Rho
        B = np.fft.ifftshift(np.fft.fft2(np.fft.fftshift(Rho)))
        self.B = np.abs(B)

    def calc_SS(self):
        """Map the brightness to (f_D, τ) with the bounded Jacobian
        (scint_sim.py:871-951) on the device in float64."""
        dev = self.device
        fd = np.arange(-self.nf, self.nf, self.df)
        td = np.arange(-self.nt, self.nt, self.dt)
        self.fd = fd
        self.td = td

        FD = torch.as_tensor(fd, dtype=F64, device=dev)[None, :]
        TD = torch.as_tensor(td, dtype=F64, device=dev)[:, None]
        thetax = (FD - self.thetagx + self.thetarx) * torch.ones_like(TD)
        typ_sq = (TD - (thetax + self.thetagx) ** 2
                  + self.thetarx ** 2 + self.thetary ** 2)
        pos = typ_sq > 0
        thymthgy = torch.sqrt(torch.where(pos, typ_sq, 1.0))  # θy − θgy
        thetay = torch.where(pos, thymthgy - self.thetagy, 0.0)
        amp = torch.where(
            pos,
            torch.where(thymthgy < 0.5 * self.df, 2 / self.df,
                        1 / thymthgy),
            1e-6)

        self.thetax = thetax.cpu().numpy()
        self.thetay = thetay.cpu().numpy()
        self.jacobian = amp.cpu().numpy()

        B = torch.as_tensor(self.B, dtype=F64, device=dev)
        x0, dx = float(self.x[0]), float(self.dx)
        SS = (_bilinear(B, x0, dx, thetax, thetay) * amp
              + _bilinear(B, x0, dx, thetax, -thetay) * amp)
        # add the point-mirrored spectrum (scint_sim.py:943-948)
        SS[1:, 1:] += SS[1:, 1:].flip(0, 1)
        self.SS = SS.cpu().numpy()
        with np.errstate(divide="ignore", invalid="ignore"):
            self.LSS = 10 * np.log10(self.SS)

    def calc_acf(self):
        """ACF as the fft2 of the secondary spectrum
        (scint_sim.py:953-958), on the device."""
        SS = torch.nan_to_num(torch.as_tensor(self.SS, dtype=F64,
                                              device=self.device), nan=0.0)
        acf = torch.fft.fftshift(torch.fft.fft2(torch.fft.fftshift(SS)))
        acf = acf.real
        self.acf = (acf / acf.max()).cpu().numpy()

    # -- plotting (scint_sim.py:960-1065): not ported --------------------
    def _no_plot(self, *args, **kwargs):
        raise NotImplementedError("the port has no plotting")

    plot_acf_efield = plot_brightness = plot_sspec = plot_acf = _no_plot
    plot_cuts = _no_plot
