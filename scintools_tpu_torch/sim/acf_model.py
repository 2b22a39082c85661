"""Analytic 2-D intensity ACF (Rickett, Coles et al. 2014, Appendix A)
on a torch device.

Counterpart of ``scintools_tpu/sim/acf_model.py``: ``_efield_acf``
(:32), ``_fresnel_row`` (:44), ``_fresnel_row_lowrank`` (:63),
``lowrank_gammes`` (:90), ``_gammitv_block`` (:155), the ``ACF`` class
and ``calc_acf`` (:198-323), ``theoretical_acf`` (:365),
``acf2d_grid_sizes`` (:371), ``make_acf2d_model_core`` (:390),
``make_acf2d_model_fn`` (:529), ``_fresnel_row_czt`` (:112) and
``ACF.calc_sspec`` (:326).

The Fresnel-kernel integral is factorised into matrix products:
expanding the quadratic phase,

    Σ_xy Γ(x,y)·exp(i((x−sx)² + (y−sy)²)/(2Δν))
      = e^{i(sx²+sy²)/2Δν} · Σ_y [E1·G]·E2

with G = Γ·chirp_x⊗chirp_y and E1/E2 plane-wave matrices. The lag axis
is a leading batch axis: for every frequency lag past the first, E1 and
E2 are ``(nlag, nsn, nx)`` complex tensors and the products are one
batched ``torch.matmul`` (the JAX package ``vmap``s a row function over
the lags). Every function here runs on ``device``; the truncated SVD of
the static e-field kernel (:func:`lowrank_gammes`) is host float64
numpy, as in the JAX package, so both packages keep the same rank and
factors.

``fresnel_method="czt"`` evaluates the same integral with chirp-Z
transforms (``ops.xfft.czt_1d``) instead of plane-wave products: the x-
and y-contractions are Bluestein transforms onto the uniform sample
grids, and the diagonal of the separable 2-D transform gives the
(snx_i, sny_i) samples, O(nx²·log nx) per lag against the products'
O(nsn·nx²). Its forward-mode derivative needs three more transforms of
the same kind, whatever the number of tangents (G·r², G·x, G·y; and
one per tangent of the kernel while alpha varies). Plotting is not
ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import resolve_device
from ..ops.windows import get_window
from ..ops.xfft import czt_1d, czt_fft_length, hermitian_full_from_half

ACF2D_RANK_TOL = 1e-5       # low-rank kernel truncation (·σ0)


def _linspace(start, stop, n, step):
    """``jnp.linspace(start, stop, n)`` with tensor end points: start·(1 −
    s) + stop·s over ``step`` = s = k/(n − 1) for k < n − 1, then stop
    itself, so the end points may carry derivatives and lane axes."""
    out = start * (1 - step) + stop * step
    stop = torch.as_tensor(stop, dtype=out.dtype, device=out.device)
    return torch.cat([out, torch.reshape(stop, (1,))])


def _step(n, dtype, device):
    """k/(n − 1) for k = 0 … n − 2, divided exactly on the host."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    s = np.arange(n - 1, dtype=np_dtype) / np_dtype(n - 1)
    return torch.as_tensor(s, device=device)


def _efield_acf(snx, sny, sqrtar, alph2, tan=None):
    """ACF of the electric field → ``(value, tangent)``. The double
    ``where`` guards the α/2 power at base 0: the value there is exp(0) =
    1 but d(x^a)/dx → ∞, so the tangent there is 0, as JAX's forward mode
    gives it. ``tan = (snx_t, sny_t, alph2_t)`` with a leading tangent
    axis (``alph2_t`` None while alpha is fixed); without it the tangent
    is None."""
    base = (snx / sqrtar) ** 2 + (sny * sqrtar) ** 2
    zero = base == 0
    safe = torch.where(zero, torch.ones_like(base), base)
    p = safe ** alph2
    e = torch.exp(-0.5 * p)
    val = torch.where(zero, torch.ones_like(base), e)
    if tan is None:
        return val, None
    snx_t, sny_t, a_t = tan
    base_t = (2 * (snx / sqrtar) * (snx_t / sqrtar)
              + 2 * (sny * sqrtar) * (sny_t * sqrtar))
    p_t = alph2 * safe ** (alph2 - 1) * torch.where(
        zero, torch.zeros_like(base_t), base_t)
    if a_t is not None:
        p_t = p_t + p * torch.log(safe) * a_t[:, None]
    return val, torch.where(zero, torch.zeros_like(p_t), -0.5 * e * p_t)


def _waves(snp, snx, sny, dnun, tan):
    """The chirp and the two plane-wave matrices of the factorised
    integral for the lags ``dnun[...]``, with their tangents when ``tan
    = (snx_t, sny_t, dnun_t)`` is given."""
    inv2d = (1.0 / (2.0 * dnun))[..., None]
    w = {"inv2d": inv2d,
         "chirp": torch.exp(1j * inv2d * snp ** 2),
         # plane waves exp(−i·x·sx/Δν), 2·inv2d = 1/Δν
         "E1": torch.exp(-2j * inv2d[..., None] * snx[..., :, None] * snp),
         "E2": torch.exp(-2j * inv2d[..., None] * sny[..., :, None] * snp)}
    if tan is not None:
        snx_t, sny_t, d_t = tan
        inv2d_t = -2.0 * inv2d ** 2 * d_t[..., None]   # d(1/2d)
        w["inv2d_t"] = inv2d_t
        w["chirp_t"] = w["chirp"] * (1j * snp ** 2) * inv2d_t
        for E, sn, sn_t in (("E1", snx, snx_t), ("E2", sny, sny_t)):
            w[E + "_t"] = w[E] * (-2j * snp) * (
                inv2d_t[..., None] * sn[..., :, None]
                + inv2d[..., None] * sn_t[..., :, None])
    return w


def _row_out(w, snx, sny, dnun, dsp_eff, s, tan, s_t):
    """−i·dsp²·phase·s/(2π·Δν), and its tangent."""
    inv2d = w["inv2d"]
    q = snx ** 2 + sny ** 2
    phase = torch.exp(1j * inv2d * q)
    den = (2 * np.pi) * dnun[..., None]
    row = -1j * (dsp_eff ** 2) * phase * s / den
    if tan is None:
        return row, None
    snx_t, sny_t, d_t = tan
    q_t = 2 * snx * snx_t + 2 * sny * sny_t
    phase_t = phase * 1j * (w["inv2d_t"] * q + inv2d * q_t)
    row_t = (-1j * (dsp_eff ** 2) * (phase_t * s + phase * s_t) / den
             - row * (d_t[..., None] / dnun[..., None]))
    return row, row_t


def _fresnel_row(gammes, snp, snx, sny, dnun, dsp_eff, tan=None,
                 gammes_t=None):
    """gammitv[:, idn] for the frequency lags ``dnun[...]`` through the
    factorised integral → ``(row, tangent)``: ``gammes`` (nx, nx) is the
    e-field ACF on grid ``snp``, ``snx``/``sny`` (..., nsn) the sample
    points, ``dsp_eff`` the grid step. ``tan = (snx_t, sny_t, dnun_t)``
    (and ``gammes_t`` while alpha varies) carries tangents along a
    leading axis; without it the tangent is None."""
    w = _waves(snp, snx, sny, dnun, tan)
    chirp = w["chirp"]
    # G[y, x] (rows are y, columns are x)
    G = gammes * chirp[..., :, None] * chirp[..., None, :]
    M = w["E2"] @ G                              # contract y
    s = (M * w["E1"]).sum(-1)                    # contract x
    s_t = None
    if tan is not None:
        ct = w["chirp_t"]
        G_t = gammes * (ct[..., :, None] * chirp[..., None, :]
                        + chirp[..., :, None] * ct[..., None, :])
        if gammes_t is not None:
            lags = (1,) * (chirp.ndim - 1)
            gammes_t = gammes_t.reshape(gammes_t.shape[:1] + lags
                                        + gammes_t.shape[1:])
            G_t = G_t + gammes_t * chirp[..., :, None] * chirp[..., None, :]
        M_t = w["E2_t"] @ G + w["E2"] @ G_t
        s_t = (M_t * w["E1"] + M * w["E1_t"]).sum(-1)
    return _row_out(w, snx, sny, dnun, dsp_eff, s, tan, s_t)


def _fresnel_row_lowrank(U, V, snp, snx, sny, dnun, dsp_eff, tan=None):
    """:func:`_fresnel_row` with the static e-field kernel factorised as
    ``gammes ≈ U @ V.T`` (rank r): the two dense chirp products collapse
    to thin ones, s_i = Σ_p [E2 @ (cy·U)]_ip · [E1 @ (cx·V)]_ip. Valid
    only while alpha is fixed."""
    w = _waves(snp, snx, sny, dnun, tan)
    chirp = w["chirp"][..., :, None]
    Uc = chirp * U                               # (..., ny, r)
    Vc = chirp * V                               # (..., nx, r)
    A = w["E2"] @ Uc
    B = w["E1"] @ Vc
    s = (A * B).sum(-1)
    s_t = None
    if tan is not None:
        ct = w["chirp_t"][..., :, None]
        A_t = w["E2_t"] @ Uc + w["E2"] @ (ct * U)
        B_t = w["E1_t"] @ Vc + w["E1"] @ (ct * V)
        s_t = (A_t * B + A * B_t).sum(-1)
    return _row_out(w, snx, sny, dnun, dsp_eff, s, tan, s_t)


def _czt_samples(F, snp, snx, sny, two, fft_len):
    """``S[..., i] = Σ_yx F[..., y, x]·exp(−i·two·(snx_i·x + sny_i·y))``
    on the grid ``snp`` for uniform sample grids ``snx``/``sny`` (..., nsn)
    and ``two`` (..., 1), by two chirp-Z transforms and a diagonal. With
    x_m = x0 + m·dsn and snx_n = sx0 + n·gx the phase splits into the
    m·n chirp (rate two·dsn·gx), a per-m phase (two·sx0·x_m) and a per-n
    one (two·x0·gx); the per-m phase is computed in float64."""
    cdt = F.dtype
    f64 = torch.float64
    dsn = snp[1] - snp[0]
    x0 = snp[0]
    snp64 = snp.to(f64)
    two64 = two.to(f64)

    def axis(u, sn):
        g0 = sn[..., 1:2] - sn[..., 0:1]
        pre = torch.exp(-1j * (two64 * sn[..., 0:1].to(f64)) * snp64)
        return czt_1d(u * pre.to(cdt)[..., None, :], two * dsn * g0,
                      two * x0 * g0, fft_len)

    Tx = axis(F, snx)                            # contract x: (..., ny, nsn)
    Ty = axis(Tx.mT, sny)                        # contract y: (..., nsn, nsn)
    return torch.diagonal(Ty, dim1=-2, dim2=-1)


def _fresnel_row_czt(gammes, snp, snx, sny, dnun, dsp_eff, fft_len=None,
                     tan=None, gammes_t=None):
    """:func:`_fresnel_row` by chirp-Z transforms (:func:`_czt_samples`)
    → ``(row, tangent)``; ``snx``/``sny`` must be uniform (they are:
    linspaces times direction cosines, shifted per lag). The tangent
    along ``tan = (snx_t, sny_t, dnun_t)`` (and ``gammes_t`` (T, ny, nx)
    while alpha varies) comes from the transforms of G·r², G·x and G·y:
    ∂s = S[∂Γ·C] + i·∂inv2d·S[G·r²] − 2i(∂inv2d·snx + inv2d·∂snx)·S[G·x]
    − 2i(∂inv2d·sny + inv2d·∂sny)·S[G·y]."""
    nsn = snx.shape[-1]
    if fft_len is None:
        fft_len = czt_fft_length(snp.shape[0], nsn)
    inv2d = (1.0 / (2.0 * dnun))[..., None]
    chirp = torch.exp(1j * inv2d * snp ** 2)
    C = chirp[..., :, None] * chirp[..., None, :]
    G = gammes * C                               # rows y, columns x
    fields = [G]
    if tan is not None:
        fields += [G * (snp[:, None] ** 2 + snp ** 2), G * snp,
                   G * snp[:, None]]
    nfix = len(fields)
    F = torch.stack(fields, dim=-3)
    if gammes_t is not None:
        F = torch.cat([F, C[..., None, :, :] * gammes_t], dim=-3)
    S = _czt_samples(F, snp, snx[..., None, :], sny[..., None, :],
                     2 * inv2d[..., None, :], fft_len)
    s = S[..., 0, :]
    w = {"inv2d": inv2d}
    s_t = None
    if tan is not None:
        snx_t, sny_t, d_t = tan
        inv2d_t = -2.0 * inv2d ** 2 * d_t[..., None]
        w["inv2d_t"] = inv2d_t
        s_t = (1j * inv2d_t * S[..., 1, :]
               - 2j * (inv2d_t * snx + inv2d * snx_t) * S[..., 2, :]
               - 2j * (inv2d_t * sny + inv2d * sny_t) * S[..., 3, :])
        if gammes_t is not None:
            s_t = s_t + torch.movedim(S[..., nfix:, :], -2, 0)
    return _row_out(w, snx, sny, dnun, dsp_eff, s, tan, s_t)


def lowrank_gammes(snp, sqrtar, alph2, rank_tol=1e-5, dtype=None):
    """Truncated-SVD factors ``(U, V)`` of the static e-field ACF kernel
    on grid ``snp`` with ``gammes ≈ U @ V.T`` (host float64 numpy);
    singular values below ``rank_tol·σ0`` are dropped, √σ is folded into
    both factors."""
    snp = np.asarray(snp, dtype=float)
    SX, SY = np.meshgrid(snp, snp)
    base = (SX / sqrtar) ** 2 + (SY * sqrtar) ** 2
    g = np.exp(-0.5 * base ** alph2)
    U, s, Vt = np.linalg.svd(g)
    r = max(int(np.sum(s > rank_tol * s[0])), 1)
    sq = np.sqrt(s[:r])
    U = U[:, :r] * sq
    V = Vt[:r].T * sq
    if dtype is not None:
        U = U.astype(dtype)
        V = V.astype(dtype)
    return U, V


def _gammitv_block(snx, sny, snp, gammes, snp2, gammes2, dnun, dsp,
                   res_fac, core_fac, sigxn, sigyn, sqrtar, alph2, wn_amp,
                   spike_index):
    """gammitv[nsn, ndnun]: lag 0 from the e-field ACF, the first lag on
    the fine (core) grid, the rest on the normal grid in one batched
    product over the lag axis."""
    col0 = _efield_acf(snx, sny, sqrtar, alph2)[0]
    if spike_index is not None:
        col0 = col0.clone()
        col0[spike_index] += wn_amp
    cols = [col0.to(torch.complex128)[:, None]]
    cols.append(_fresnel_row(gammes2, snp2, snx - 2 * sigxn * dnun[1],
                             sny - 2 * sigyn * dnun[1], dnun[1],
                             dsp / core_fac)[0][:, None])
    if len(dnun) > 2:
        d = dnun[2:]
        cols.append(_fresnel_row(gammes, snp, snx - 2 * sigxn * d[:, None],
                                 sny - 2 * sigyn * d[:, None], d,
                                 dsp / res_fac)[0].T)
    return torch.cat(cols, dim=1)


def _efield_kernel(snp, sqrtar, alph2):
    """exp(−0.5·((x/√ar)² + (y·√ar)²)^(α/2)) on the grid ``snp`` (rows
    y, columns x), built on ``snp``'s device."""
    base = (snp[None, :] / sqrtar) ** 2 + (snp[:, None] * sqrtar) ** 2
    return torch.exp(-0.5 * base ** alph2)


class ACF:
    """Theoretical 2-D intensity ACF with anisotropy and phase gradient,
    computed in float64 on ``device`` (``None``: the CUDA card) in
    ``__init__``, as the reference does. The constructor follows the
    JAX package's; ``device`` replaces its ``backend``."""

    def __init__(self, psi=0, phasegrad=0, theta=0, ar=1, alpha=5 / 3,
                 taumax=4, dnumax=4, nf=51, nt=51, amp=1, wn=0,
                 spatial_factor=2, resolution_factor=1, core_factor=2,
                 auto_sampling=True, plot=False, display=True,
                 backend=None, device=None):
        if backend is not None:
            raise NotImplementedError(
                "backend is the JAX package's and must stay None: the "
                "port runs on device")
        self.alpha = alpha
        self.ar = ar
        self.psi = psi
        self.phasegrad = phasegrad
        self.theta = theta
        self.amp = amp
        self.wn = wn
        self.taumax = taumax
        self.dnumax = dnumax
        if nf % 2 == 0:
            nf += 1  # odd, so the ACF has a centre
        if nt % 2 == 0:
            nt += 1
        self.nf = nf
        self.nt = nt
        if auto_sampling:
            spmax = taumax
            self.sp_fac = 6 * ar / spmax
            self.res_fac = 1 + ar / 3
            self.core_fac = 4
        else:
            self.sp_fac = spatial_factor
            self.res_fac = resolution_factor
            self.core_fac = core_factor
        self.dsp = 4 * taumax / (nt - 1)
        self.device = resolve_device(device)
        self.calc_acf()
        if plot:
            self.plot_acf(display=display)

    def calc_acf(self):
        """Build the full ACF: ``self.acf`` (nf, nt), its axes ``fn``,
        ``tn`` (= ``sn``), the grid ``snp`` and ``acf_efield``."""
        dev = self.device
        f64 = torch.float64
        alph2 = self.alpha / 2
        spmax = self.taumax
        dnumax = self.dnumax
        dsp = self.dsp
        phasegrad = self.phasegrad
        theta = self.theta
        xi = 90 - self.psi
        Vx = np.cos(xi * np.pi / 180)
        Vy = np.sin(xi * np.pi / 180)
        sigxn = float(phasegrad * np.cos((xi - theta) * np.pi / 180))
        sigyn = float(phasegrad * np.sin((xi - theta) * np.pi / 180))

        ar = self.ar
        sqrtar = np.sqrt(ar)
        dnun = np.linspace(0, dnumax, int(np.ceil(self.nf / 2)))
        self.ddnun = abs(dnun[1] - dnun[0])
        sp_fac, res_fac = self.sp_fac, self.res_fac
        core_fac = self.res_fac * self.core_fac

        snp = np.arange(-sp_fac * spmax, sp_fac * spmax + dsp / res_fac,
                        dsp / res_fac)
        snp2 = np.arange(-sp_fac * spmax, sp_fac * spmax + dsp / core_fac,
                         dsp / core_fac)
        snp_t = torch.as_tensor(snp, dtype=f64, device=dev)
        snp2_t = torch.as_tensor(snp2, dtype=f64, device=dev)
        gammes = _efield_kernel(snp_t, sqrtar, alph2)
        gammes2 = _efield_kernel(snp2_t, sqrtar, alph2)

        if phasegrad == 0:
            tn = np.linspace(0, spmax, int(np.ceil(self.nt / 2)))
            snx, sny = Vx * tn, Vy * tn
            spike_index = 0
        else:
            tn = np.linspace(-spmax, spmax, self.nt)
            snx = np.cos(xi * np.pi / 180) * tn
            sny = np.sin(xi * np.pi / 180) * tn
            zeros = np.flatnonzero(snx == 0)
            spike_index = int(zeros[0]) if len(zeros) else None

        def t(a):
            return torch.as_tensor(a, dtype=f64, device=dev)

        g = _gammitv_block(t(snx), t(sny), snp_t, gammes, snp2_t, gammes2,
                           t(dnun), dsp, res_fac, core_fac, sigxn, sigyn,
                           sqrtar, alph2, self.wn / self.amp, spike_index)
        # equation A1: ACF of E → ACF of I
        gammitv = (g * torch.conj(g)).real.cpu().numpy()

        if phasegrad == 0:
            # mirror one quadrant to the full plane
            nr, nc = gammitv.shape
            gam2 = np.zeros((nr, nc * 2 - 1))
            gam2[:, 0:nc - 1] = np.fliplr(gammitv[:, 1:])
            gam2[:, nc - 1:] = gammitv
            gam3 = np.zeros((nr * 2 - 1, nc * 2 - 1))
            gam3[0:nr - 1, :] = np.flipud(gam2[1:, :])
            gam3[nr - 1:, :] = gam2
            gam3 = np.transpose(gam3)
            t2 = np.concatenate((np.flip(-tn[1:]), tn))
            f2 = np.concatenate((np.flip(-dnun[1:]), dnun))
        else:
            # two quadrants computed; mirror in frequency only
            nr, nc = gammitv.shape
            gam3 = np.zeros((nr, nc * 2 - 1))
            gam3[:, 0:nc - 1] = np.fliplr(np.flipud(gammitv[:, 1:]))
            gam3[:, nc - 1:] = gammitv
            gam3 = np.transpose(gam3)
            f2 = np.concatenate((np.flip(-dnun[1:]), dnun))
            t2 = tn

        self.fn = f2
        self.tn = t2
        self.sn = t2
        self.snp = snp
        self.acf = self.amp * gam3
        self.acf_efield = gammes.cpu().numpy()

    def calc_sspec(self, window="hanning", window_frac=1):
        """The model ACF's secondary spectrum [dB] on ``self.device`` in
        float64: the windowed ACF, fftshifted as the reference does,
        through the real-input forward transform (rfft2 and the Hermitian completion,
        the full complex fft2 of a real input), shifted back; the
        magnitude in dB. Sets and returns ``self.sspec``."""
        nf, nt = np.shape(self.acf)
        chan_window, subint_window = get_window(nt, nf, window=window,
                                                frac=window_frac)
        arr = chan_window * self.acf
        arr = (subint_window * arr.T).T
        x = torch.fft.fftshift(torch.as_tensor(arr, dtype=torch.float64,
                                               device=self.device))
        F = torch.fft.fftshift(hermitian_full_from_half(
            torch.fft.rfft2(x), nt))
        mag = torch.sqrt((F * torch.conj(F)).real)
        self.sspec = (10 * torch.log10(mag)).cpu().numpy()
        return self.sspec

    # -- plotting (scint_sim.py:680-765) -------------------------------
    def plot_acf(self, display=True, contour=True, filled=False,
                 **kwargs):
        from .plots import plot_acf_model
        return plot_acf_model(self, display=display, contour=contour,
                              filled=filled, **kwargs)

    def plot_acf_efield(self, display=True, **kwargs):
        from .plots import plot_acf_efield_model
        return plot_acf_efield_model(self, display=display, **kwargs)

    def plot_sspec(self, display=True, vmin=None, vmax=None, **kwargs):
        from .plots import plot_acf_sspec
        return plot_acf_sspec(self, display=display, vmin=vmin,
                              vmax=vmax, **kwargs)


def theoretical_acf(**kwargs):
    """Functional entry used by the 2-D fit model
    (``fit/models.py:scint_acf_model_2d``)."""
    return ACF(**kwargs)


def acf2d_grid_sizes(nt_crop, dt, ar, tau0, grid_oversample=1.25):
    """(n_normal, n_core) integration-grid point counts of
    :func:`make_acf2d_model_core`: the only way ``tau0`` enters a built
    model, hence part of the cache key in ``fit/acf2d.py``."""
    res_fac = 1 + ar / 3
    core_fac = 4 * res_fac
    taumax0 = nt_crop * dt / abs(tau0)
    dsp0 = 4 * taumax0 / (nt_crop - 1)

    def n(fac):
        return max(int(np.ceil(2 * 6 * ar / (dsp0 / fac)
                               * grid_oversample)), 9)

    return n(res_fac), n(core_fac)


def make_acf2d_model_core(nt_crop, nf_crop, ar, alpha, theta, tau0, dt0,
                          grid_oversample=1.25, precision="default",
                          alpha_varies=False, fresnel_method="gemm",
                          device=None):
    """Static-shape theoretical-ACF model with the lag steps as inputs:
    ``model(tau, dnu, amp, phasegrad, psi, wn, dt, df[, alpha]) →
    (nf_crop, nt_crop)`` on ``device`` (``None``: the CUDA card). The
    inputs are Python numbers or 0-d tensors (a lane of
    ``torch.func.vmap``). ``model.jvp`` gives the model with its
    forward-mode derivatives along given tangents, written out by hand:
    autograd's dual numbers would route every product with a constant
    through a Python-level zero-tensor path on the host. ``dt0`` and
    ``tau0`` size the static grids (:func:`acf2d_grid_sizes`), which span
    ±6·ar; the two-quadrant branch serves every phase gradient and the
    white-noise spike lands at the centre bin (the crop is odd).

    ``precision="default"``: float32/complex64 rows with the static
    e-field kernel factorised by truncated SVD (:func:`lowrank_gammes`,
    rank ≲ 10) unless alpha varies or the rows are chirp-Z;
    ``"highest"``: dense rows in float64/complex128.
    ``fresnel_method="czt"`` evaluates every row by chirp-Z transforms
    (:func:`_fresnel_row_czt`, full rank) with the GEMM rows as its
    oracle."""
    if nt_crop % 2 == 0 or nf_crop % 2 == 0:
        raise ValueError("acf2d crop must be odd-sized (the ACF is "
                         "centred on its white-noise spike)")
    if precision not in ("default", "highest"):
        raise ValueError(f"precision must be 'default' or 'highest', "
                         f"got {precision!r}")
    if fresnel_method not in ("gemm", "czt"):
        raise ValueError(f"fresnel_method must be 'gemm' or 'czt', "
                         f"got {fresnel_method!r}")
    dev = resolve_device(device)
    sqrtar = float(np.sqrt(ar))
    f32 = precision == "default"
    rdt = torch.float32 if f32 else torch.float64
    czt = fresnel_method == "czt"
    lowrank = f32 and not alpha_varies and not czt
    n_normal, n_core = acf2d_grid_sizes(nt_crop, dt0, ar, tau0,
                                        grid_oversample)

    def _grid(n):
        snp = np.linspace(-6 * ar, 6 * ar, n)
        SX, SY = np.meshgrid(snp, snp)
        base = (SX / sqrtar) ** 2 + (SY * sqrtar) ** 2
        if f32:
            snp = snp.astype(np.float32)
            base = base.astype(np.float32)
        uv = None
        if lowrank:
            uv = tuple(torch.as_tensor(a, device=dev) for a in lowrank_gammes(
                snp, sqrtar, alpha / 2, rank_tol=ACF2D_RANK_TOL,
                dtype=np.float32))
        return (torch.as_tensor(snp, device=dev),
                torch.as_tensor(base, device=dev), uv,
                float(snp[1] - snp[0]), czt_fft_length(n, nt_crop))

    grids = (_grid(n_normal), _grid(n_core))
    ndnun = (nf_crop + 1) // 2
    spike_index = nt_crop // 2              # tn centre (nt odd)
    is_spike = torch.arange(nt_crop, device=dev) == spike_index
    step_t = _step(nt_crop, rdt, dev)
    step_f = _step(ndnun, rdt, dev)
    deg = np.pi / 180.0

    unit_t = _linspace(-1.0, 1.0, nt_crop, step_t)   # ∂tn/∂taumax
    unit_f = _linspace(0.0, 1.0, ndnun, step_f)      # ∂dnun/∂dnumax

    def _row(which, alph2, snx, sny, d, tan, a_t):
        snp, base, uv, eff_step, fft_len = grids[which]
        if lowrank:
            return _fresnel_row_lowrank(uv[0], uv[1], snp, snx, sny, d,
                                        eff_step, tan)
        zero = base == 0
        safe = torch.where(zero, torch.ones_like(base), base)
        p = safe ** alph2
        gam = torch.where(zero, torch.ones_like(base), torch.exp(-0.5 * p))
        gam_t = None
        if a_t is not None:
            gam_t = torch.where(zero, torch.zeros_like(base),
                                -0.5 * gam * p * torch.log(safe)) \
                * a_t[:, None, None]
        if czt:
            return _fresnel_row_czt(gam, snp, snx, sny, d, eff_step,
                                    fft_len, tan, gam_t)
        return _fresnel_row(gam, snp, snx, sny, d, eff_step, tan, gam_t)

    def _as(v):
        if isinstance(v, torch.Tensor):
            return v.to(rdt)
        return torch.tensor(v, dtype=rdt, device=dev)

    def forward(tau, dnu, amp, phasegrad, psi, wn, dt, df, alpha, tang):
        """The model, and with ``tang`` (T, 7) — tangents of (tau, dnu,
        amp, phasegrad, psi, wn, alpha) — its forward-mode derivative
        (T, nf_crop, nt_crop), written out so no operation goes through
        autograd's dual numbers."""
        tau_in, dnu_in = _as(tau), _as(dnu)
        tau, dnu = torch.abs(tau_in), torch.abs(dnu_in)
        amp, phasegrad, psi, wn, dt, df = (
            _as(v) for v in (amp, phasegrad, psi, wn, dt, df))
        alph2 = alpha / 2
        taumax = nt_crop * dt / tau
        dnumax = nf_crop * df / dnu
        xi = (90.0 - psi) * deg
        cs, sn = torch.cos(xi - theta * deg), torch.sin(xi - theta * deg)
        sigxn = phasegrad * cs
        sigyn = phasegrad * sn
        tn = _linspace(-taumax, taumax, nt_crop, step_t)
        cxi, sxi = torch.cos(xi), torch.sin(xi)
        snx = cxi * tn
        sny = sxi * tn
        dnun = _linspace(0.0, dnumax, ndnun, step_f)
        d = dnun[2:]
        rows = ((1, snx - 2 * sigxn * dnun[1], sny - 2 * sigyn * dnun[1],
                 dnun[1]),
                (0, snx - 2 * sigxn * d[:, None], sny - 2 * sigyn * d[:, None],
                 d))

        tan_e = a_t = None
        tans = (None, None)
        if tang is not None:
            tau_t = torch.sign(tau_in) * tang[:, 0]
            dnu_t = torch.sign(dnu_in) * tang[:, 1]
            pg_t, xi_t = tang[:, 3], -deg * tang[:, 4]
            a_t = tang[:, 6] / 2 if alpha_varies else None
            taumax_t = -taumax / tau * tau_t
            dnumax_t = -dnumax / dnu * dnu_t
            sigxn_t = pg_t * cs - phasegrad * sn * xi_t
            sigyn_t = pg_t * sn + phasegrad * cs * xi_t
            tn_t = taumax_t[:, None] * unit_t
            snx_t = -sxi * xi_t[:, None] * tn + cxi * tn_t
            sny_t = cxi * xi_t[:, None] * tn + sxi * tn_t
            dnun_t = dnumax_t[:, None] * unit_f
            d_t = dnun_t[:, 2:]
            tan_e = (snx_t, sny_t, a_t)
            tans = ((snx_t - 2 * (sigxn_t * dnun[1] + sigxn * dnun_t[:, 1])
                     [:, None],
                     sny_t - 2 * (sigyn_t * dnun[1] + sigyn * dnun_t[:, 1])
                     [:, None], dnun_t[:, 1]),
                    (snx_t[:, None] - 2 * (sigxn_t[:, None, None] * d[:, None]
                                           + sigxn * d_t[..., None]),
                     sny_t[:, None] - 2 * (sigyn_t[:, None, None] * d[:, None]
                                           + sigyn * d_t[..., None]), d_t))

        col0, col0_t = _efield_acf(snx, sny, sqrtar, alph2, tan_e)
        col0 = torch.where(is_spike, col0 + wn / amp, col0)
        (first, first_t), (rest, rest_t) = (
            _row(w, alph2, sx, sy, dd, t, a_t)
            for (w, sx, sy, dd), t in zip(rows, tans))
        # rest: (ndnun − 2, nt) → columns
        g = torch.cat([col0[:, None].to(rest.dtype), first[:, None],
                       rest.T], dim=1)
        inten = (g * torch.conj(g)).real             # |Γ_E|² → Γ_I
        # mirror in frequency only (the two-quadrant branch), then
        # transpose to (nf, nt)
        gam3 = torch.cat([torch.flip(inten[:, 1:], dims=(0, 1)), inten],
                         dim=1).T
        out = amp * gam3
        if tang is None:
            return out, None
        amp_t, wn_t = tang[:, 2], tang[:, 5]
        col0_t = torch.where(is_spike, col0_t + (wn_t / amp - wn * amp_t
                                                 / amp ** 2)[:, None], col0_t)
        g_t = torch.cat([col0_t[..., None].to(rest.dtype), first_t[..., None],
                         rest_t.mT], dim=-1)
        inten_t = 2 * (torch.conj(g) * g_t).real
        gam3_t = torch.cat([torch.flip(inten_t[..., 1:], dims=(-2, -1)),
                            inten_t], dim=-1).mT
        return out, amp_t[:, None, None] * gam3 + amp * gam3_t

    def model(tau, dnu, amp, phasegrad, psi, wn, dt, df, alpha=alpha):
        return forward(tau, dnu, amp, phasegrad, psi, wn, dt, df, alpha,
                       None)[0]

    def jvp(tau, dnu, amp, phasegrad, psi, wn, dt, df, alpha=alpha,
            tangents=None):
        """``(model, ∂model)``: ``tangents`` (T, 7) holds the tangents of
        (tau, dnu, amp, phasegrad, psi, wn, alpha) (alpha's read only
        when ``alpha_varies``); ∂model is (T, nf_crop, nt_crop)."""
        return forward(tau, dnu, amp, phasegrad, psi, wn, dt, df, alpha,
                       tangents)

    model.jvp = jvp
    return model


def make_acf2d_model_fn(nt_crop, nf_crop, dt, df, ar, alpha, theta, tau0,
                        grid_oversample=1.25, precision="default",
                        alpha_varies=False, fresnel_method="gemm",
                        device=None):
    """:func:`make_acf2d_model_core` with ``dt``/``df`` fixed:
    ``model(tau, dnu, amp, phasegrad, psi, wn) → (nf_crop, nt_crop)``."""
    core = make_acf2d_model_core(nt_crop, nf_crop, ar, alpha, theta, tau0,
                                 dt, grid_oversample=grid_oversample,
                                 precision=precision,
                                 alpha_varies=alpha_varies,
                                 fresnel_method=fresnel_method,
                                 device=device)

    def model(tau, dnu, amp, phasegrad, psi, wn, alpha=alpha):
        return core(tau, dnu, amp, phasegrad, psi, wn, dt, df, alpha=alpha)

    return model
