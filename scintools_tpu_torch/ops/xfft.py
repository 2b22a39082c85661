"""Real-input 2-D transforms on ``torch.fft`` (cuFFT on the card).

Counterpart of ``scintools_tpu/ops/xfft.py``: ``hermitian_full_from_half``
(:111), ``hermitian_half_gather`` (:125), ``fft2_full`` (:141, ``rfft``
and ``fft2`` variants), ``pruned_meanpad_half`` (:160),
``ifft2_cropped`` (:186, ``split`` and ``dense``), ``wiener_khinchin``
(:236), ``halfrow_power`` (:262) and the dense branch of ``Plan.power``
(:548-559).

The structured-or-dense choice of each transform is a formulation of the
registry (``backend.formulation``), registered here under the JAX
package's names (:62-92): ``xfft.acf``, ``xfft.sspec``,
``xfft.acf_sspec``, ``xfft.zoom``, ``xfft.offgrid`` and ``xfft.profile``.
A ``variant=None`` resolves it on the input's device type at call time.
The declarative front door :func:`plan` / :class:`Plan` (:458-640) and
the cached batched programs ``acf_program``, ``sspec_power_program``,
``zoom_power_program`` and ``offgrid_program`` (:645-760) lower to the
functions here.

The separable column projection of :211-233 (``column_phase``,
``separable_filter_column``, with its two halves ``column_projector`` and
``filter_axis0``), which the scenario factory uses.

The band-limited (zoom) and off-grid family of :285-455: ``czt_1d``
(Bluestein chirp-Z), ``zoom_dft_1d`` (``"czt"`` or the ``"dense"``
plane-wave DFT oracle), ``zoom_power_2d``, ``offgrid_taylor`` (the
Taylor expansion from an oversampled FFT), ``offgrid_dft_1d``
(``"taylor"`` or ``"dense"``) and ``real_spectrum_1d``. They run through
``torch.fft`` and ``torch.matmul`` on the input's device. Every phase
(chirps, pre-phases, plane waves) is computed in float64 and cast to the
input's complex dtype: in float32 the chirp's a·m²/2 would lose its
digits at m of a few thousand. Band edges, chirp rates and sample
points may be tensors; nothing is built per geometry.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..backend import (fifo_cached, formulation, formulation_platform,
                       register_formulation, resolve_device)

register_formulation(
    "xfft.acf", default="real", choices=("real", "dense"),
    platforms={"cpu": "real", "cuda": "real"},
    doc="autocovariance Wiener–Khinchin: real-input rfft → |·|² → "
        "irfft2 vs the complex fft2/ifft2 oracle")
register_formulation(
    "xfft.sspec", default="half", choices=("half", "dense"),
    platforms={"cpu": "half", "cuda": "half"},
    doc="secondary-spectrum power: rfft over the halved delay axis, "
        "crop folded before the second transform, vs the full fft2 "
        "oracle")
register_formulation(
    "xfft.acf_sspec", default="real", choices=("real", "dense"),
    platforms={"cpu": "real", "cuda": "real"},
    doc="sspec→ACF forward transform: rfft2 + Hermitian completion vs "
        "the complex fft2 oracle")
register_formulation(
    "xfft.zoom", default="czt", choices=("czt", "dense"),
    platforms={"cpu": "czt", "cuda": "czt"},
    doc="band-limited (zoom) DFT: Bluestein chirp-Z vs the dense "
        "plane-wave DFT product")
register_formulation(
    "xfft.offgrid", default="taylor", choices=("taylor", "dense"),
    platforms={"cpu": "taylor", "cuda": "taylor"},
    doc="off-grid DFT: oversampled FFT + Taylor expansion vs the dense "
        "point-DFT product")
register_formulation(
    "xfft.profile", default="real", choices=("real", "dense"),
    platforms={"cpu": "real", "cuda": "real"},
    doc="1-D profile spectrum real(fft(x))[:keep]: rfft half spectrum vs "
        "the full complex fft")


def _platform(x):
    """The device type of ``x`` ("cpu" for a numpy array or a number)."""
    return x.device.type if isinstance(x, torch.Tensor) else "cpu"


def hermitian_full_from_half(H, n2):
    """Full 2-D spectrum of a real input from its ``rfft2`` half
    ``H[..., n1, n2//2+1]``: ``F[k1, k2] = conj(F[(-k1) % n1, n2 - k2])``
    for the missing columns ``k2 = n2//2+1 .. n2-1``."""
    n1 = H.shape[-2]
    m = H.shape[-1]                       # n2 // 2 + 1
    idx1 = (-torch.arange(n1, device=H.device)) % n1
    tail = torch.conj(H[..., idx1, 1:n2 - m + 1].flip(-1))
    return torch.cat([H, tail], dim=-1)


def hermitian_half_gather(H, n2, rows, cols):
    """Point-gather full-spectrum entries of real inputs from their
    ``rfft2`` halves ``H[B, n1, n2//2+1]``: ``rows``/``cols`` (int64,
    leading axis B) index the RAW full ``(n1, n2)`` spectrum of each
    input, and entries in the missing columns (``cols > n2//2``) read
    the conjugate of the mirrored half-plane entry, so the full complex
    spectrum never materialises."""
    n1, m = H.shape[-2:]
    tail = cols >= m
    r = torch.where(tail, (n1 - rows) % n1, rows)
    c = torch.where(tail, n2 - cols, cols)
    b = torch.arange(H.shape[0], device=H.device).view(
        (-1,) + (1,) * (rows.ndim - 1))
    v = H[b, r, c]
    return torch.where(tail, torch.conj(v), v)


def fft2_full(x, variant="fft2", s=None):
    """Full complex 2-D spectrum of the trailing axes, zero-padded to
    ``s`` (the two trailing lengths) when given. ``'rfft'`` takes the
    half spectrum of a real input plus the Hermitian completion;
    ``'fft2'`` is the dense complex transform (complex inputs always
    take it)."""
    if variant not in ("rfft", "fft2"):
        raise ValueError(f"unknown variant {variant!r} "
                         "(want 'rfft' or 'fft2')")
    s = None if s is None else tuple(int(n) for n in s)
    if variant == "rfft" and not x.is_complex():
        n2 = x.shape[-1] if s is None else s[-1]
        return hermitian_full_from_half(torch.fft.rfft2(x, s=s), n2)
    return torch.fft.fft2(x, s=s)


def pruned_meanpad_half(x, pad_to):
    """Half spectrum ``[N1, N2//2+1]`` of the real 2-D frame ``x``
    mean-padded to ``pad_to = (N1, N2)``: mean-padding is
    ``zeropad(x − µ) + µ``, and the transform of the constant µ-canvas is
    one DC term, so the axis-1 rfft runs on the data rows only (the zero
    rows are appended, not transformed) and µ·N1·N2 is added at
    ``H[0, 0]``. Equal to ``rfft2`` of the mean-padded frame up to float
    rounding. Single-frame, as the JAX package's."""
    N1, N2 = pad_to
    mu = x.mean()
    r1 = torch.fft.rfft(x - mu, n=N2, dim=1)
    r1 = torch.cat([r1, r1.new_zeros((N1 - x.shape[0], r1.shape[1]))])
    H = torch.fft.fft(r1, dim=0)
    H[0, 0] += mu * N1 * N2          # H is this call's own; x is untouched
    return H


def ifft2_cropped(X, crop, variant="split"):
    """``ifft2(X)[..., :rows, :cols]`` over the trailing axes.
    ``'split'`` folds the row crop between the per-axis transforms: only
    ``rows`` of the axis-0 outputs reach the axis-1 transform (exact:
    the crop commutes with the per-row transform). ``'dense'`` is the
    ``ifft2``-then-crop oracle."""
    if variant not in ("split", "dense"):
        raise ValueError(f"unknown variant {variant!r} "
                         "(want 'split' or 'dense')")
    r, c = crop
    if variant == "dense":
        return torch.fft.ifft2(X)[..., :r, :c]
    Y = torch.fft.ifft(X, dim=-2)[..., :r, :]
    return torch.fft.ifft(Y, dim=-1)[..., :c]


def wiener_khinchin(x, pad_to, variant=None):
    """Circular autocovariance ``F⁻¹|F x|²`` of ``x`` over the trailing
    axes zero-padded to ``pad_to``, in raw layout. ``'real'`` (a real
    ``x``): the axis-1 rfft of the data rows, the axis-0 fft, |·|², then
    the real inverse ``irfft2``, so the discarded Hermitian half is
    never computed; ``'dense'`` is the complex ``fft2 → |·|² → ifft2``
    oracle (complex inputs always take it). ``None``: the ``xfft.acf``
    formulation on ``x``'s device."""
    if variant is None:
        variant = formulation("xfft.acf", _platform(x))
    if variant not in ("real", "dense"):
        raise ValueError(f"unknown variant {variant!r} "
                         "(want 'real' or 'dense')")
    N1, N2 = pad_to
    if variant == "real" and not x.is_complex():
        H = torch.fft.rfft(x, n=N2, dim=-1)        # data rows only
        H = torch.fft.fft(H, n=N1, dim=-2)
        P = (H * torch.conj(H)).real
        return torch.fft.irfft2(P, s=(N1, N2))
    arr = torch.fft.fft2(x, s=(N1, N2))
    return torch.fft.ifft2(arr.abs() ** 2).real


def halfrow_power(x, pad_to):
    """``fftshift(|fft2(x, s=pad_to)|²)[N1//2:]`` of a real ``x`` with
    the row crop folded into the transform: rfft over the halved
    (delay) axis, crop, then the second-axis transform on half the
    rows. Rows come back in raw order (= the kept half of the shifted
    frame), the column axis fftshifted."""
    N1, N2 = pad_to
    S = torch.fft.rfft(x, n=N1, dim=-2)
    S = torch.fft.fft(S[..., :N1 // 2, :], n=N2, dim=-1)
    p = (S * torch.conj(S)).real
    return torch.fft.fftshift(p, dim=-1)


def dense_power(x, pad_to, halved):
    """The dense oracle of ``Plan.power``: full complex fft2, power,
    fftshift, and the ``[N1//2:]`` crop when ``halved``."""
    N1, N2 = pad_to
    simf = torch.fft.fft2(x, s=(N1, N2))
    sec = torch.fft.fftshift((simf * torch.conj(simf)).real,
                             dim=(-2, -1))
    return sec[..., N1 // 2:, :] if halved else sec


# ---------------------------------------------------------------------
# separable-kernel filtering (the factory's column projection)
# ---------------------------------------------------------------------

def column_phase(n, col):
    """Column-extraction phase vector ``exp(2πi·k·col/n)`` (host numpy,
    complex128): multiplying an axis spectrum by it and summing is the
    single-column inverse transform."""
    return np.exp(2j * np.pi * np.arange(n) * col / n)


def column_projector(fy, gph):
    """``g = fft(fy · gph)/ny`` over the last axis: ``E @ g`` is the
    filtered axis-1 inverse transform of ``E`` sampled at the column
    that ``gph`` (:func:`column_phase`, in the working complex dtype)
    selects. Leading axes of ``fy`` (one filter per frequency) give one
    projector each."""
    return torch.fft.fft(fy * gph, dim=-1) / fy.shape[-1]


def filter_axis0(v, fx, dim=-1):
    """The remaining filtered 1-D round trip along the screen's first
    axis: ``ifft(fx · fft(v))`` over ``dim`` of the projected columns
    ``v``, ``fx`` broadcast against them."""
    return torch.fft.ifft(fx * torch.fft.fft(v, dim=dim), dim=dim)


def separable_filter_column(E, fx, fy, gph):
    """``ifft2(fft2(E) · fx ⊗ fy)[..., col]`` of ``E[..., nx, ny]`` via
    the rank-1 separability of the filter: one matvec with
    :func:`column_projector` and one filtered 1-D round trip along axis 0
    (:func:`filter_axis0`) — no 2-D FFT. ``fx[nx]``, ``fy[ny]`` and
    ``gph`` are in ``E``'s complex dtype; exact, not approximate."""
    v = E @ column_projector(fy, gph)
    return filter_axis0(v, fx)


# ---------------------------------------------------------------------
# band-limited (zoom) and off-grid transforms
# ---------------------------------------------------------------------

def _cdtype(x):
    """complex128 for float64/complex128 input, else complex64."""
    return (torch.complex128 if x.dtype in (torch.float64, torch.complex128)
            else torch.complex64)


def _f64(v, device):
    """``v`` (a number or a tensor, also a lane of ``torch.func.vmap``)
    as float64 on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float64)
    if np.ndim(v) == 0:
        # a fill on the device, no host copy: a CUDA graph can hold it
        return torch.full((), float(v), dtype=torch.float64, device=device)
    return torch.tensor(v, dtype=torch.float64, device=device)


def czt_fft_length(M, N):
    """``(fft_len, N)`` for :func:`czt_1d`: the smallest power-of-two
    convolution length ≥ M + N − 1."""
    L = 1
    while L < M + N - 1:
        L *= 2
    return (L, N)


def czt_1d(u, a, phi0, L):
    """Bluestein chirp-Z: ``X[n] = Σ_m u[..., m]·exp(−i·(a·m·n +
    phi0·n))`` for n = 0 … N − 1 over the last axis, ``L = (fft_len,
    N)`` from :func:`czt_fft_length`. ``a`` and ``phi0`` are numbers or
    tensors that broadcast against ``u``'s leading axes. m·n = (m² + n²
    − (n − m)²)/2 turns the sum into a convolution of u·e^{−i·a·m²/2}
    with the conjugate chirp, done with zero-padded FFTs: O((M + N)·log)
    per row instead of the O(M·N) plane-wave product."""
    Lf, N = L
    M = u.shape[-1]
    dev = u.device
    cdt = _cdtype(u)
    a = _f64(a, dev)[..., None]
    phi0 = _f64(phi0, dev)[..., None]
    m = torch.arange(M, dtype=torch.float64, device=dev)
    n = torch.arange(N, dtype=torch.float64, device=dev)
    k = torch.arange(-(M - 1), N, dtype=torch.float64, device=dev)
    wm = torch.exp(-0.5j * a * m ** 2).to(cdt)
    wn = torch.exp(-0.5j * a * n ** 2 - 1j * phi0 * n).to(cdt)
    v = torch.exp(0.5j * a * k ** 2).to(cdt)     # the conjugate chirp
    uf = torch.fft.fft(u.to(cdt) * wm, n=Lf, dim=-1)
    vf = torch.fft.fft(v, n=Lf, dim=-1)
    conv = torch.fft.ifft(uf * vf, dim=-1)
    # conv index M − 1 + n aligns (n − m) = k
    return conv[..., M - 1:M - 1 + N] * wn


def zoom_dft_1d(x, n_grid, f0, df, n_out, variant=None, fft_len=None):
    """Band-limited DFT over the last axis: ``X[j] = Σ_m x[..., m]·
    exp(−2πi·m·(f0 + j·df)/n_grid)`` for j = 0 … n_out − 1, with ``f0``
    and ``df`` in (fractional, signed) bin units of an ``n_grid``-point
    transform. Integer ``f0`` with ``df = 1`` gives the ``fft(x,
    n=n_grid)`` bins; ``df = 1/z`` samples the z×-padded grid without
    building it. ``"czt"`` folds the band start into a pre-phase and
    runs :func:`czt_1d`; ``"dense"`` is the plane-wave DFT product
    (O(M·n_out)); ``None`` the ``xfft.zoom`` formulation on ``x``'s
    device."""
    if variant is None:
        variant = formulation("xfft.zoom", _platform(x))
    if variant not in ("czt", "dense"):
        raise ValueError(f"unknown variant {variant!r} "
                         "(want 'czt' or 'dense')")
    M = x.shape[-1]
    dev = x.device
    cdt = _cdtype(x)
    w = 2.0 * np.pi / n_grid
    m = torch.arange(M, dtype=torch.float64, device=dev)
    f0 = _f64(f0, dev)
    df = _f64(df, dev)
    if variant == "czt":
        if fft_len is None:
            fft_len = czt_fft_length(M, n_out)
        pre = torch.exp(-1j * w * f0 * m).to(cdt)
        return czt_1d(x.to(cdt) * pre, w * df, 0.0, fft_len)
    freqs = f0 + df * torch.arange(n_out, dtype=torch.float64, device=dev)
    E = torch.exp(-1j * w * m[:, None] * freqs[None, :]).to(cdt)
    return x.to(cdt) @ E


def zoom_power_2d(x, pad_to, band_r, band_c, variant=None):
    """Band-limited power ``|F(r0 + j1·dr, c0 + j2·dc)|²`` of ``x`` over
    its trailing axes, F the DFT on the ``pad_to = (N1, N2)`` grid and
    each band a ``(f0, f1, n_out)`` triple in (fractional, signed) bin
    units, sampled at ``f0 + j·(f1 − f0)/n_out`` (end point excluded, as
    FFT bins). The edges may be tensors. Only the n_out_r × n_out_c band
    pixels are computed: the row-axis zoom runs first, so the column
    transform sees n_out_r rows instead of N1. ``variant`` as
    :func:`zoom_dft_1d`'s, resolved once for both axes."""
    if variant is None:
        variant = formulation("xfft.zoom", _platform(x))
    N1, N2 = pad_to
    r0, r1, nr = band_r
    c0, c1, nc = band_c
    F = zoom_dft_1d(x.transpose(-1, -2), N1, r0, (r1 - r0) / nr, int(nr),
                    variant=variant)
    F = zoom_dft_1d(F.transpose(-1, -2), N2, c0, (c1 - c0) / nc, int(nc),
                    variant=variant)
    return (F * torch.conj(F)).real


def offgrid_taylor_bound(order, oversample):
    """Remainder coefficient of :func:`offgrid_taylor`: its truncation
    error is ≤ ``bound·Σ|x|`` with ``bound = r^k/k!·1/(1 − r/(k + 1))``,
    r = π/oversample (the phase derivative times half an oversampled
    bin)."""
    r = np.pi / oversample
    k = int(order)
    return float(r ** k / math.factorial(k) / (1.0 - r / (k + 1)))


def offgrid_taylor(x, pts, n_grid, order=8, oversample=4):
    """Off-grid DFT samples ``X(p) = Σ_m x[..., m]·exp(−2πi·m·p/n_grid)``
    at scattered points ``pts`` (fractional bin units): one FFT per
    derivative order t on the ``oversample``×-oversampled grid (of
    x·(−2πi·m/n_grid)^t), then a k-term Taylor expansion from the
    nearest oversampled bin, evaluated by Horner in the offset δ. Error
    ≤ :func:`offgrid_taylor_bound` ``(order, oversample)·Σ|x|``."""
    M = x.shape[-1]
    dev = x.device
    cdt = _cdtype(x)
    Nq = int(oversample) * int(n_grid)
    cm = (-2j * np.pi / n_grid) * torch.arange(M, dtype=torch.float64,
                                                device=dev)
    pw = [torch.ones_like(cm)]
    for _ in range(1, order):
        pw.append(pw[-1] * cm)
    pw = torch.stack(pw).to(cdt)                           # (k, M)
    F = torch.fft.fft(x.to(cdt)[..., None, :] * pw, n=Nq, dim=-1)
    pts = _f64(pts, dev)
    g = torch.round(pts * oversample)
    delta = (pts - g / oversample).to(F.real.dtype)        # grid bins
    idx = torch.remainder(g, Nq).to(torch.int64)
    Fp = F[..., idx]                                       # (k, P)
    acc = Fp[..., order - 1, :]
    for t in range(order - 1, 0, -1):                      # Horner:
        acc = Fp[..., t - 1, :] + acc * (delta / t)        # δ^t/t!
    return acc


def offgrid_dft_1d(x, pts, n_grid, order=8, oversample=4, variant=None):
    """Scattered-point DFT over the last axis: ``"taylor"`` is
    :func:`offgrid_taylor`; ``"dense"`` the exact point-DFT product
    (O(M·P)); ``None`` the ``xfft.offgrid`` formulation on ``x``'s
    device."""
    if variant is None:
        variant = formulation("xfft.offgrid", _platform(x))
    if variant == "taylor":
        return offgrid_taylor(x, pts, n_grid, order=order,
                              oversample=oversample)
    if variant != "dense":
        raise ValueError(f"unknown variant {variant!r} "
                         "(want 'taylor' or 'dense')")
    dev = x.device
    m = torch.arange(x.shape[-1], dtype=torch.float64, device=dev)
    E = torch.exp(-2j * np.pi / n_grid * m[:, None]
                  * _f64(pts, dev)[None, :]).to(_cdtype(x))
    return x.to(E.dtype) @ E


def real_spectrum_1d(x, keep, variant=None):
    """``real(fft(x))[..., :keep]`` of a numpy array or tensor. A real
    input with ``keep ≤ n//2 + 1`` takes the rfft half spectrum under
    ``"real"``; ``"dense"`` is the full complex FFT; ``None`` the
    ``xfft.profile`` formulation on ``x``'s device (the CPU for numpy)."""
    if variant is None:
        variant = formulation("xfft.profile", _platform(x))
    if variant not in ("real", "dense"):
        raise ValueError(f"unknown variant {variant!r} "
                         "(want 'real' or 'dense')")
    n = x.shape[-1]
    if isinstance(x, torch.Tensor):
        if variant == "real" and not x.is_complex() and keep <= n // 2 + 1:
            return torch.fft.rfft(x).real[..., :keep]
        return torch.fft.fft(x).real[..., :keep]
    if (variant == "real" and not np.iscomplexobj(x)
            and keep <= n // 2 + 1):
        return np.real(np.fft.rfft(x))[..., :keep]
    return np.real(np.fft.fft(x))[..., :keep]


# ---------------------------------------------------------------------
# plan(): the declarative front door
# ---------------------------------------------------------------------

class Plan:
    """Declared structure of a 2-D transform over the trailing axes,
    lowered at call time to the functions of this module.

    Built by :func:`plan`. The structured-or-dense choice resolves
    through the registry op ``op`` on the input's device type unless a
    call pins ``variant=``; a plan with no ``op`` is dense. Plans are
    stateless descriptors."""

    __slots__ = ("shape", "pad_to", "real_input", "mean_pad", "crop",
                 "layout", "op", "band")

    def __init__(self, shape, pad_to, real_input, mean_pad, crop, layout,
                 op, band=None):
        self.shape = tuple(int(n) for n in shape)
        self.pad_to = tuple(int(n) for n in (pad_to or shape))
        self.real_input = bool(real_input)
        self.mean_pad = bool(mean_pad)
        self.crop = crop
        self.layout = layout
        self.op = op
        self.band = band

    def variant(self, pinned=None, platform=None):
        """The active choice: ``pinned`` when given, else ``op``
        resolved on ``platform`` (``None``:
        ``backend.formulation_platform()``), else ``"dense"``."""
        if pinned is not None:
            return pinned
        return formulation(self.op, platform) if self.op else "dense"

    def structured(self, pinned=None, platform=None):
        return self.variant(pinned, platform) not in ("dense", "fft2")

    def describe(self):
        """JSON-able view: the declared properties and the variant that
        resolves now."""
        def _band(b):
            try:
                return [float(b[0]), float(b[1]), int(b[2])]
            except (TypeError, RuntimeError):   # tensor edges of a batch
                return ["tensor", "tensor", int(b[2])]

        return {
            "shape": list(self.shape), "pad_to": list(self.pad_to),
            "real_input": self.real_input, "mean_pad": self.mean_pad,
            "crop": list(self.crop) if self.crop else None,
            "layout": self.layout, "op": self.op,
            "band": [_band(b) for b in self.band] if self.band else None,
            "variant": self.variant(platform=formulation_platform()),
        }

    def forward(self, x, variant=None):
        """Full complex forward spectrum: declared real input takes the
        half spectrum and the Hermitian completion; the 'shifted' layout
        applies the final fftshift."""
        want_rfft = self.real_input and self.structured(variant,
                                                        _platform(x))
        pad = None if self.pad_to == tuple(x.shape[-2:]) else self.pad_to
        F = fft2_full(x, variant="rfft" if want_rfft else "fft2", s=pad)
        if self.layout == "shifted":
            F = torch.fft.fftshift(F, dim=(-2, -1))
        return F

    def half(self, x):
        """Half spectrum for gather consumers (raw layout); a declared
        mean pad folds into a DC scalar (:func:`pruned_meanpad_half`)."""
        if self.mean_pad:
            return pruned_meanpad_half(x, self.pad_to)
        return torch.fft.rfft2(x, s=self.pad_to)

    def power(self, x, variant=None):
        """Spectral power with the declared row crop. A ``band`` lowers
        to :func:`zoom_power_2d` (only the band's pixels); a half-row
        crop of real input to :func:`halfrow_power`; dense is the full
        frame, shifted and cropped (:func:`dense_power`)."""
        plat = _platform(x)
        if self.band is not None:
            return zoom_power_2d(x, self.pad_to, self.band[0], self.band[1],
                                 variant=self.variant(variant, plat))
        halved = self.crop is not None and self.crop[0] == self.pad_to[0] // 2
        if (halved and self.real_input and self.structured(variant, plat)
                and not x.is_complex()):
            return halfrow_power(x, self.pad_to)
        return dense_power(x, self.pad_to, halved)

    def acf(self, x, variant=None):
        """Wiener–Khinchin autocovariance; 'shifted' centres the zero
        lag."""
        arr = wiener_khinchin(x, self.pad_to,
                              variant=self.variant(variant, _platform(x)))
        if self.layout == "shifted":
            arr = torch.fft.fftshift(arr, dim=(-2, -1))
        return arr

    def inverse(self, X, variant=None):
        """Inverse transform with the declared output crop folded
        between the per-axis transforms."""
        crop = self.crop or self.pad_to
        v = "split" if self.structured(variant, _platform(X)) else "dense"
        return ifft2_cropped(X, crop, variant=v)


def plan(shape, pad_to=None, *, real_input=False, mean_pad=False,
         crop=None, layout="raw", op=None, band=None):
    """Declare the structure of a 2-D transform; returns a :class:`Plan`.

    ``shape`` — the trailing two data axes. ``pad_to`` — transform
    lengths (zero pad; default none). ``real_input`` — forwards take
    half-spectrum lowerings, round-trip power the real inverse.
    ``mean_pad`` — the padding holds the data mean. ``crop`` — ``(rows,
    cols)`` output crop (a ``None`` entry keeps the axis). ``layout`` —
    ``'raw'`` or ``'shifted'``. ``band`` — ``((f0, f1, n_out) rows,
    (f0, f1, n_out) cols)`` in (fractional, signed) raw bin units of the
    ``pad_to`` grid: power computes only that band (raw layout only).
    ``op`` — the registry op of the structured-or-dense choice; band
    plans default to ``'xfft.zoom'``."""
    if layout not in ("raw", "shifted"):
        raise ValueError(f"unknown layout {layout!r} "
                         "(want 'raw' or 'shifted')")
    if band is not None:
        if layout != "raw":
            raise ValueError("band plans are raw-layout (the band IS the "
                             "output frame)")
        if len(band) != 2 or any(len(b) != 3 for b in band):
            raise ValueError("band wants ((f0, f1, n_out) rows, "
                             "(f0, f1, n_out) cols)")
        if op is None:
            op = "xfft.zoom"
    return Plan(shape, pad_to, real_input, mean_pad, crop, layout, op, band)


# ---------------------------------------------------------------------
# cached batched programs
# ---------------------------------------------------------------------

# keyed on shape, resolved variant and device, so a formulation flip
# builds a new program instead of reusing the old one
_PROGRAM_CACHE = {}


def _program(key, build, site):
    def make():
        from ..obs import retrace as _retrace

        _retrace.record_build(site, key)
        return build()

    return fifo_cached(_PROGRAM_CACHE, key, make, 16)


def acf_program(nf, nt, *, variant=None, normalise=True, device=None):
    """Cached batched autocovariance ``fn(dyn[B, nf, nt]) → acf[B, 2nf,
    2nt]`` on ``device`` (``None``: the card) under the ``xfft.acf``
    choice, site ``xfft.acf``."""
    dev = resolve_device(device)
    if variant is None:
        variant = formulation("xfft.acf", dev.type)
    key = ("acf", int(nf), int(nt), variant, bool(normalise), str(dev))

    def build():
        from .acf import autocovariance

        def fn(dyn):
            return autocovariance(dyn, normalise=normalise, variant=variant,
                                  device=dev)

        return fn

    return _program(key, build, "xfft.acf")


def sspec_power_program(nf, nt, *, variant=None, device=None):
    """Cached batched halved secondary-spectrum power ``fn(dyn[B, nf,
    nt]) → sec[B, nrfft//2, ncfft]`` on ``device`` under the
    ``xfft.sspec`` choice, site ``xfft.sspec``."""
    dev = resolve_device(device)
    if variant is None:
        variant = formulation("xfft.sspec", dev.type)
    key = ("sspec", int(nf), int(nt), variant, str(dev))

    def build():
        from .sspec import secondary_spectrum_power

        def fn(dyn):
            return secondary_spectrum_power(
                torch.as_tensor(dyn, device=dev), variant=variant)

        return fn

    return _program(key, build, "xfft.sspec")


def zoom_power_program(nf, nt, pad_to, n_r, n_c, *, variant=None,
                       device=None):
    """Cached batched band-limited power ``fn(dyn[B, nf, nt], band_r[2],
    band_c[2]) → sec[B, n_r, n_c]`` on ``device``, the band edges
    ``(f0, f1)`` in (fractional, signed) bin units of the ``pad_to``
    grid (numbers or tensors: one program serves every band), under the
    ``xfft.zoom`` choice, site ``xfft.zoom``."""
    dev = resolve_device(device)
    if variant is None:
        variant = formulation("xfft.zoom", dev.type)
    pad_to = tuple(int(n) for n in pad_to)
    nr, nc = int(n_r), int(n_c)
    key = ("zoom", int(nf), int(nt), pad_to, nr, nc, variant, str(dev))

    def build():
        def fn(dyn, band_r, band_c):
            return zoom_power_2d(torch.as_tensor(dyn, device=dev), pad_to,
                                 (band_r[0], band_r[1], nr),
                                 (band_c[0], band_c[1], nc), variant=variant)

        return fn

    return _program(key, build, "xfft.zoom")


def offgrid_program(n, n_pts, *, n_grid=None, order=8, oversample=4,
                    variant=None, device=None):
    """Cached batched scattered-point DFT ``fn(x[B, n], pts[n_pts]) →
    X[B, n_pts]`` on ``device`` (points in fractional bin units of the
    ``n_grid``-point transform, default ``n``) under the
    ``xfft.offgrid`` choice, site ``xfft.offgrid``."""
    dev = resolve_device(device)
    if variant is None:
        variant = formulation("xfft.offgrid", dev.type)
    ng = int(n_grid if n_grid is not None else n)
    key = ("offgrid", int(n), int(n_pts), ng, int(order), int(oversample),
           variant, str(dev))

    def build():
        def fn(x, pts):
            return offgrid_dft_1d(torch.as_tensor(x, device=dev), pts, ng,
                                  order=order, oversample=oversample,
                                  variant=variant)

        return fn

    return _program(key, build, "xfft.offgrid")
