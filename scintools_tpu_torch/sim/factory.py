"""Batched scenario factory: lanes of phase screens → Fresnel
propagation → dynamic spectra, on a torch device.

Counterpart of ``scintools_tpu/sim/factory.py:113-542``:
``effective_wavenumbers``, ``compensator_modes``,
``frequency_scale_grid``, ``build_scenario_fn``,
``make_scenario_factory``, ``lane_keys_from_seeds``,
``simulate_scenarios`` and ``simulate_screens``.

- **Lane physics.** ``mb2``, ``ar``, ``psi`` and ``alpha`` are per-lane
  tensors (Γ through ``torch.lgamma``), so one built function serves a
  whole regime sweep; the geometry (wavenumber grids, filters, mode
  matrices) is built once per geometry on the device.
- **Formulations.** ``screen=None`` and ``propagate=None`` resolve the
  ``sim.screen`` and ``sim.propagate`` registry ops (the JAX package's
  :93, :103, registered here) on the device; the registered entries
  are ``"compensated"`` and ``"column"`` on both devices.
- **Screens** (``screen=``): ``"compensated"`` (the default) adds the
  sub-fundamental spectral modes as a rank-M correction
  ``Re(Ex·C·Eyᵀ)`` with the central cells halved, as a 2× oversized grid
  would weight them; ``"oversized"`` synthesises the 2× screen and
  crops; ``"plain"`` is the reference's screen.
- **Propagation** (``propagate=``): ``"column"`` (the default)
  projects ``ifft2(fft2(E)·fx⊗fy)[:, :, col]`` onto the sampled column
  (``ops.xfft`` column projection: a per-lane row sum and two length-nx
  transforms, no 2-D FFT); ``"phasor"`` (the JAX package's default,
  kept for parity with it) also replaces the
  per-frequency ``exp(iφs)`` by the carried recurrence
  ``E_i = E_{i−1}·R̄·corr(δ_i)`` (a 3-term correction for the
  non-uniform grid, an exact resync every :data:`PHASOR_RESYNC`
  steps); ``"dense"`` is the full-plane fft2/ifft2 oracle.
- **Precision.** float32/complex64 (the throughput policy);
  ``precision="highest"`` gives float64/complex128.
- **Quarantine.** Invalid lane parameters give ``BAD_INPUT`` (1), a
  non-finite lane ``BAD_OUTPUT`` (2); the lane comes back NaN and its
  neighbours are bitwise untouched: nothing mixes lanes, and every
  per-lane sum is a row reduction (a product and ``sum``, not a matrix
  product, whose split of the sum could follow the number of rows), so
  a lane's bits do not depend on how many lanes share its group.
- **Grouping.** The batch is walked in :data:`SIM_GROUP_SIZE` groups.
- **Random streams.** Torch cannot reproduce ``jax.random``. A lane's
  key is an integer seed (:func:`lane_keys_from_seeds`), and each lane
  draws from its own ``torch.Generator`` on the device seeded by its
  key, in this order: the real plane, the imaginary plane, then the
  compensator's (M, 2) modes. A lane's data is therefore independent
  of how the batch is grouped, padded or resumed. Lane streams differ
  between the CPU and the card (torch's generators do).

The stages are reachable on their own: a built function ``fn`` has
``fn.normals(key)`` (one lane's draws), ``fn.screens_from_normals(re,
im, zm, mb2, ar, psi, alpha)`` and ``fn.propagate_group(phi)``, which
the tests drive with the JAX package's own draws.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import (fifo_cached, formulation, register_formulation,
                       resolve_device)
from ..obs import retrace as _retrace
from ..ops import xfft
from ..robust.guards import BAD_INPUT
from .simulation import hermitian_fill

#: lanes propagated together: bounds the live complex-field working set
SIM_GROUP_SIZE = 8

#: the phasor recurrence recomputes ``exp(iφs)`` outright every N-th
#: frequency step, bounding the drift of its Taylor correction
PHASOR_RESYNC = 16

#: ``ok`` bit 2: the propagated lane went non-finite
BAD_OUTPUT = 2

SCREENS = ("compensated", "oversized", "plain")
PROPAGATIONS = ("phasor", "column", "dense")

register_formulation(
    "sim.screen", default="compensated", choices=SCREENS,
    platforms={"cpu": "compensated", "cuda": "compensated"},
    doc="phase-screen low frequencies: the rank-M sub-fundamental "
        "compensation vs a 2x oversized screen, cropped, vs the plain "
        "reference screen")
register_formulation(
    "sim.propagate", default="phasor", choices=PROPAGATIONS,
    platforms={"cpu": "column", "cuda": "column"},
    doc="per-frequency Fresnel propagation: column projection with the "
        "exp(i*phi*s) recurrence vs with an exact exp per scale vs the "
        "full-plane fft2/ifft2")

#: built functions per geometry, formulations and device (a FIFO of 32)
_SCENARIO_CACHE = {}
_SCENARIO_CACHE_SIZE = 32


def effective_wavenumbers(nx, ny, dqx, dqy):
    """Per-cell effective ``(kx, ky)`` grids and the filled-cell mask of
    the reference's hermitian fill, recovered by running the fill with
    extractor functions, so every value-copy quirk of its mirror
    indexing is carried into the grids: ``screen_weights(...) ==
    mask * swdsp(KX, KY)`` bit for bit."""
    kx = hermitian_fill(nx, ny, dqx, dqy, lambda a, b: a + 0 * b)
    ky = hermitian_fill(nx, ny, dqx, dqy, lambda a, b: b + 0 * a)
    mask = hermitian_fill(nx, ny, dqx, dqy,
                          lambda a, b: 1 + 0 * a + 0 * b) > 0
    return kx, ky, mask


def compensator_modes(dqx, dqy, levels=1):
    """Sub-fundamental mode lattice of the ``"compensated"`` screen: for
    each level ``l`` the central spectral cells split on the ``dq/2^l``
    half-lattice (points of the parent lattice excluded), each mode
    weighted ``2^-l``, the amplitude a ``2^l``-oversized grid gives that
    wavenumber. Returns host arrays ``(qx[M], qy[M], scale[M])``."""
    qx, qy, scale = [], [], []
    for lev in range(1, levels + 1):
        sx, sy = dqx / 2 ** lev, dqy / 2 ** lev
        for mx in range(-2, 3):
            for my in range(-2, 3):
                if mx % 2 == 0 and my % 2 == 0:
                    continue          # on the parent lattice already
                qx.append(mx * sx)
                qy.append(my * sy)
                scale.append(0.5 ** lev)
    qx, qy = np.asarray(qx), np.asarray(qy)
    scale = np.asarray(scale)
    # deeper levels refine the inner square of the level above: a
    # shallower mode inside it loses another factor of 2
    for lev in range(2, levels + 1):
        inner = ((np.abs(qx) <= dqx / 2 ** (lev - 1) + 1e-12)
                 & (np.abs(qy) <= dqy / 2 ** (lev - 1) + 1e-12)
                 & (scale > 0.5 ** lev))
        scale = np.where(inner, scale / 2, scale)
    return qx, qy, scale


def frequency_scale_grid(nf, dlam, lamsteps=False):
    """Per-channel Fresnel scale factors (host float64): uniform in
    wavelength (``lamsteps``, scint_sim.py:216-219) or the reference's
    default reciprocal-frequency grid."""
    ifreq = np.arange(nf)
    if lamsteps:
        return 1.0 + dlam * (ifreq - 1 - nf / 2) / nf
    return 1.0 / (1.0 + dlam * (-0.5 + ifreq / nf))


def _formulations(precision, screen, propagate, platform):
    highest = precision == "highest"
    screen_f = screen or formulation("sim.screen", platform)
    prop_f = propagate or formulation("sim.propagate", platform)
    if screen_f not in SCREENS:
        raise ValueError(f"unknown screen {screen_f!r} (want one of "
                         f"{SCREENS})")
    if prop_f not in PROPAGATIONS:
        raise ValueError(f"unknown propagate {prop_f!r} (want one of "
                         f"{PROPAGATIONS})")
    return highest, screen_f, prop_f


def build_scenario_fn(ns=128, nf=128, dlam=0.25, rf=1.0, ds=0.01,
                      inner=0.001, nscreens=64, group_size=None,
                      precision=None, screen=None, propagate=None,
                      levels=1, lamsteps=False, output="dynspec",
                      device=None):
    """The factory for one geometry on ``device``:
    ``fn(keys[B], mb2[B], ar[B], psi[B], alpha[B]) → (dynspec[B, ns, nf],
    ok[B] int32)`` as tensors on the device (``screens[B, ns, ns]`` when
    ``output="screens"``); ``keys`` are integer lane seeds. See the
    module docstring for the formulations and the stages it exposes."""
    dev = resolve_device(device)
    B = int(nscreens)
    G = min(int(group_size or SIM_GROUP_SIZE), B)
    if B % G:
        raise ValueError(f"nscreens={B} not divisible by "
                         f"group_size={G} (pad the lane stack)")
    highest, screen_f, prop_f = _formulations(precision, screen, propagate,
                                              dev.type)
    fdt = torch.float64 if highest else torch.float32
    cdt = torch.complex128 if highest else torch.complex64

    def T(x, dtype=fdt):
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)   # a Python float would become float32
        return torch.as_tensor(x, device=dev).to(dtype)

    # ---- geometry (host float64, lane-independent) --------------------
    nx = ny = int(ns)
    dx = dy = float(ds)
    lenx, leny = nx * dx, ny * dy
    dqx, dqy = 2 * np.pi / lenx, 2 * np.pi / leny
    ffconx = (2.0 / (lenx * lenx)) * (np.pi * rf) ** 2
    ffcony = (2.0 / (leny * leny)) * (np.pi * rf) ** 2
    column = int(np.floor(ny / 2))
    scales_np = frequency_scale_grid(nf, dlam, lamsteps=lamsteps)

    def grids(n1, n2, q1, q2):
        kx, ky, mask = effective_wavenumbers(n1, n2, q1, q2)
        return (T(kx ** 2), T(ky ** 2), T(kx * ky), T(kx ** 2 + ky ** 2),
                T(mask, torch.bool), kx, ky, mask)

    if screen_f == "oversized":
        os_ = 2 ** levels
        KX2, KY2, KXY, K2, MASK = grids(os_ * nx, os_ * ny, dqx / os_,
                                        dqy / os_)[:5]
        shape = (os_ * nx, os_ * ny)
        con_div = float(os_)
    else:
        KX2, KY2, KXY, K2, MASK, kxg, kyg, maskg = grids(nx, ny, dqx, dqy)
        shape = (nx, ny)
        con_div = 1.0
    M = 0
    if screen_f == "compensated":
        mqx, mqy, mscale = compensator_modes(dqx, dqy, levels=levels)
        M = len(mqx)
        MQX2, MQY2, MQXY = T(mqx ** 2), T(mqy ** 2), T(mqx * mqy)
        MQ2, MSCALE = T(mqx ** 2 + mqy ** 2), T(mscale)
        # the rank-M field Re(Σ_m c_m·Ex[:, m]⊗Ey[:, m]) from the M
        # outer-product planes, Ex[n, m] = exp(−i·qx_m·x_n)
        xs = (np.arange(nx) * dx)[:, None]
        ys = (np.arange(ny) * dy)[:, None]
        EX = np.exp(-1j * xs * mqx[None, :])
        EY = np.exp(-1j * ys * mqy[None, :])
        PLANES = T(np.einsum("xm,ym->mxy", EX, EY), cdt)
        # cells the half-lattice covers keep half their amplitude
        ringg = (maskg & (np.abs(kxg) <= dqx + 1e-9 * dqx)
                 & (np.abs(kyg) <= dqy + 1e-9 * dqy))
        RING = T(np.where(ringg, 0.5, 1.0))

    # ---- propagation constants ----------------------------------------
    q2x = T(ffconx * np.minimum(np.arange(nx), nx - np.arange(nx))
            .astype(float) ** 2)
    q2y = T(ffcony * np.minimum(np.arange(ny), ny - np.arange(ny))
            .astype(float) ** 2)
    GPH = T(xfft.column_phase(ny, column), cdt)
    SCALES = T(scales_np)
    if nf > 1:
        diffs = np.diff(scales_np)
        dbar = float(diffs.mean())
        deltas_np = np.concatenate([[0.0], diffs - dbar])
    else:
        dbar, deltas_np = 0.0, np.zeros(1)
    DELTAS = T(deltas_np)
    DBAR = T(dbar)
    q2grid = q2x[:, None] + q2y[None, :]
    # per-frequency filters: fx (nf, nx) and the column projectors
    # g (nf, ny) = fft(fy·gph)/ny
    FXT = torch.exp(-1j * (q2x[None, :] * SCALES[:, None])).to(cdt)
    GPROJ = xfft.column_projector(
        torch.exp(-1j * (q2y[None, :] * SCALES[:, None])).to(cdt), GPH)

    def lane_spectrum(kx2, ky2, kxky, k2, mb2, ar, psi, alpha, con):
        """Anisotropic-Kolmogorov √spectrum per lane on wavenumber grids
        (1, n1, n2) or modes (M,) — simulation._swdsp over a lane axis."""
        cs = torch.cos(psi * np.pi / 180)
        sn = torch.sin(psi * np.pi / 180)
        alf = -(alpha + 2) / 4
        a = cs ** 2 / ar + ar * sn ** 2
        b = ar * cs ** 2 + sn ** 2 / ar
        c = 2 * cs * sn * (1 / ar - ar)
        ex = (..., None, None) if kx2.ndim == 3 else (..., None)
        q2 = a[ex] * kx2 + b[ex] * ky2 + c[ex] * kxky
        return con[ex] * q2 ** alf[ex] * torch.exp(-k2 * (inner ** 2) / 2)

    def lane_params(mb2, ar, psi, alpha):
        """Validity per lane, the parameters with invalid lanes set to
        the defaults, and √consp (set_constants, Γ through lgamma)."""
        mb2, ar, psi, alpha = (T(v) for v in (mb2, ar, psi, alpha))
        ok = (torch.isfinite(mb2) & torch.isfinite(ar)
              & torch.isfinite(psi) & torch.isfinite(alpha)
              & (mb2 > 0) & (ar > 0) & (alpha > 0) & (alpha < 2))
        mb2 = torch.where(ok, mb2, 2.0)
        ar = torch.where(ok, ar, 1.0)
        psi = torch.where(ok, psi, 0.0)
        alpha = torch.where(ok, alpha, 5 / 3)
        ab = 1.0 - alpha * 0.5
        cmb2 = alpha * mb2 / (4 * np.pi * torch.exp(torch.lgamma(ab))
                              * torch.cos(alpha * np.pi * 0.25))
        consp = cmb2 * dqx * dqy / (rf ** alpha)
        return ok, mb2, ar, psi, alpha, torch.sqrt(consp)

    def normals(key):
        """One lane's draws from its own generator seeded by ``key``:
        the real plane, the imaginary plane, then (``"compensated"``)
        the (M, 2) modes."""
        g = torch.Generator(device=dev)
        g.manual_seed(int(key))
        re = torch.randn(shape, generator=g, dtype=fdt, device=dev)
        im = torch.randn(shape, generator=g, dtype=fdt, device=dev)
        zm = (torch.randn((M, 2), generator=g, dtype=fdt, device=dev)
              if M else None)
        return re, im, zm

    def screens(re, im, zm, mb2, ar, psi, alpha, con):
        w = torch.where(MASK[None],
                        lane_spectrum(KX2[None], KY2[None], KXY[None],
                                      K2[None], mb2, ar, psi, alpha,
                                      con / con_div),
                        0.0)
        if screen_f == "compensated":
            w = w * RING[None]
        phi = torch.fft.fft2(w * torch.complex(re, im)).real
        if screen_f == "oversized":
            phi = phi[:, :nx, :ny]
        elif screen_f == "compensated":
            wm = (lane_spectrum(MQX2, MQY2, MQXY, MQ2, mb2, ar, psi, alpha,
                                con) * MSCALE[None])
            cm = (wm * torch.complex(zm[..., 0], zm[..., 1])).to(cdt)
            phi = phi + (cm[:, :, None, None] * PLANES[None]).sum(1).real
        return phi.to(fdt)

    def screens_from_normals(re, im, zm, mb2, ar, psi, alpha):
        """Screens ``(G, ns, ns)`` from given normals (``re``, ``im``:
        (G, *shape); ``zm``: (G, M, 2) or None) and lane parameters."""
        _, mb2, ar, psi, alpha, con = lane_params(mb2, ar, psi, alpha)
        return screens(T(re), T(im), None if zm is None else T(zm), mb2,
                       ar, psi, alpha, con)

    def project(E, i0, i1):
        """Per-lane column projection of the planes E[k, G, nx, ny] of
        steps i0 … i1−1: (k, G, nx)."""
        return (E * GPROJ[i0:i1, None, None, :]).sum(-1)

    def propagate_group(xyp):
        """Screens (G, nx, ny) → field column spe (G, nx, nf)."""
        xyp = T(xyp)
        if prop_f == "dense":
            cols = []
            for i in range(nf):
                s = SCALES[i]
                xye = torch.fft.fft2(torch.exp(1j * (xyp * s)).to(cdt))
                xye = xye * torch.exp(-1j * (q2grid * s)).to(cdt)[None]
                cols.append(torch.fft.ifft2(xye)[:, :, column])
            return torch.stack(cols, dim=-1)
        V = []
        R = torch.exp(1j * (xyp * DBAR)).to(cdt)
        E = None
        for i0 in range(0, nf, PHASOR_RESYNC):
            i1 = min(i0 + PHASOR_RESYNC, nf)
            if prop_f == "column":
                s = SCALES[i0:i1, None, None, None]
                V.append(project(torch.exp(1j * (xyp[None] * s)).to(cdt),
                                 i0, i1))
                continue
            # phasor: an exact step at i0, then the recurrence with the
            # corrections of the block's steps made at once
            E = torch.exp(1j * (xyp * SCALES[i0])).to(cdt)
            V.append(project(E[None], i0, i0 + 1))
            if i1 > i0 + 1:
                pd = xyp[None] * DELTAS[i0 + 1:i1, None, None, None]
                corr = torch.complex(1 - 0.5 * pd * pd,
                                     pd - (1 / 6) * pd * pd * pd).to(cdt)
                for k in range(i1 - i0 - 1):
                    E = E * R * corr[k]
                    V.append(project(E[None], i0 + 1 + k, i0 + 2 + k))
        # the nx transforms run along the last axis of a contiguous
        # (G, nf, nx) stack: a strided transform's bits can follow the
        # batch size
        v = torch.cat(V, dim=0).transpose(0, 1).contiguous()
        return xfft.filter_axis0(v, FXT).transpose(1, 2)  # (G, nx, nf)

    def run_group(keys, mb2, ar, psi, alpha):
        lane_ok, mb2, ar, psi, alpha, con = lane_params(mb2, ar, psi, alpha)
        draws = [normals(k) for k in keys]
        re = torch.stack([d[0] for d in draws])
        im = torch.stack([d[1] for d in draws])
        zm = torch.stack([d[2] for d in draws]) if M else None
        phi = screens(re, im, zm, mb2, ar, psi, alpha, con)
        if output == "screens":
            spi = phi
        else:
            spe = propagate_group(phi)
            spi = (spe.real ** 2 + spe.imag ** 2).to(fdt)
        out_ok = torch.isfinite(spi).flatten(1).all(dim=1)
        code = torch.where(lane_ok, torch.where(out_ok, 0, BAD_OUTPUT),
                           BAD_INPUT).to(torch.int32)
        spi = torch.where((code == 0)[:, None, None], spi, np.nan)
        return spi, code

    def run(keys, mb2, ar, psi, alpha):
        keys = np.asarray(keys, dtype=np.int64).reshape(B)
        lanes = [np.asarray(v, dtype=float).reshape(B)
                 for v in (mb2, ar, psi, alpha)]
        spis, codes = [], []
        for g0 in range(0, B, G):
            sl = slice(g0, g0 + G)
            spi, code = run_group(keys[sl], *(v[sl] for v in lanes))
            spis.append(spi)
            codes.append(code)
        return torch.cat(spis), torch.cat(codes)

    run.normals = normals
    run.screens_from_normals = screens_from_normals
    run.propagate_group = propagate_group
    return run


def make_scenario_factory(ns=128, nf=128, dlam=0.25, rf=1.0, ds=0.01,
                          inner=0.001, nscreens=64, group_size=None,
                          precision=None, screen=None, propagate=None,
                          levels=1, lamsteps=False, output="dynspec",
                          device=None):
    """:func:`build_scenario_fn`, built once per geometry, resolved
    formulations and device and kept in a FIFO of 32
    (``obs.retrace`` counts the builds at site ``sim.factory``)."""
    dev = resolve_device(device)
    _, screen_f, prop_f = _formulations(precision, screen, propagate,
                                        dev.type)
    key = (int(ns), int(nf), float(dlam), float(rf), float(ds),
           float(inner), int(nscreens),
           int(min(group_size or SIM_GROUP_SIZE, nscreens)),
           precision, screen_f, prop_f, int(levels), bool(lamsteps),
           output, str(dev))

    def build():
        _retrace.record_build("sim.factory", key)
        return build_scenario_fn(
            ns=ns, nf=nf, dlam=dlam, rf=rf, ds=ds, inner=inner,
            nscreens=nscreens, group_size=group_size, precision=precision,
            screen=screen_f, propagate=prop_f, levels=levels,
            lamsteps=lamsteps, output=output, device=dev)

    return fifo_cached(_SCENARIO_CACHE, key, build, _SCENARIO_CACHE_SIZE)


def lane_keys_from_seeds(seeds):
    """Per-lane keys from integer lane seeds: the seeds themselves
    (int64), each the seed of its lane's generator. Stable per seed: an
    epoch keyed by its seed gets the same screen however the batch
    around it was grouped or resumed."""
    return np.asarray(seeds, dtype=np.int64).reshape(-1)


def simulate_scenarios(nscreens, mb2=2.0, ar=1.0, psi=0.0, alpha=5 / 3,
                       ns=128, nf=128, dlam=0.25, rf=1.0, ds=0.01,
                       inner=0.001, seed=0, keys=None, group_size=None,
                       precision=None, screen=None, propagate=None,
                       levels=1, lamsteps=False, with_ok=False,
                       device_out=False, output="dynspec", device=None):
    """``nscreens`` dynamic spectra ``(B, ns, nf)`` through the factory on
    ``device`` (``None``: the card).

    ``mb2 / ar / psi / alpha`` are scalars or per-lane arrays. Lanes are
    keyed by ``keys`` (integer lane seeds) or, without them, by seeds
    drawn from ``np.random.Generator(PCG64(seed))`` (the first B lanes'
    seeds do not depend on the padding). The stack is padded to a
    multiple of the group with copies of the last lane. ``with_ok``
    also returns the int32 health code per lane (0, ``BAD_INPUT``,
    ``BAD_OUTPUT``); ``device_out`` returns tensors on the device
    instead of numpy arrays."""
    dev = resolve_device(device)
    B = int(nscreens)
    G = min(int(group_size or SIM_GROUP_SIZE), B)
    pad = (-B) % G
    Bp = B + pad

    def lanes(v):
        arr = np.broadcast_to(np.asarray(v, dtype=float), (B,))
        return np.concatenate([arr, np.repeat(arr[-1:], pad)])

    if keys is None:
        keys = np.random.Generator(np.random.PCG64(seed)).integers(
            0, 2 ** 62, size=Bp)
    else:
        keys = lane_keys_from_seeds(keys)
        keys = np.concatenate([keys, np.repeat(keys[-1:], pad)])
    fn = make_scenario_factory(
        ns=ns, nf=nf, dlam=dlam, rf=rf, ds=ds, inner=inner, nscreens=Bp,
        group_size=G, precision=precision, screen=screen,
        propagate=propagate, levels=levels, lamsteps=lamsteps,
        output=output, device=dev)
    dyn, ok = fn(keys, lanes(mb2), lanes(ar), lanes(psi), lanes(alpha))
    dyn, ok = dyn[:B], ok[:B]
    if not device_out:
        dyn, ok = dyn.cpu().numpy(), ok.cpu().numpy()
    return (dyn, ok) if with_ok else dyn


def simulate_screens(nscreens, **kw):
    """Phase screens only: :func:`simulate_scenarios` with the
    propagation skipped, ``(B, ns, ns)``."""
    return simulate_scenarios(nscreens, output="screens", **kw)
