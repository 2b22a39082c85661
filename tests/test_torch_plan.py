"""The port's declarative transform plan (``ops/xfft.py``: ``plan``,
``Plan`` and the cached batched programs ``acf_program``,
``sspec_power_program``, ``zoom_power_program``, ``offgrid_program``)
against the JAX package's on the CPU, mirroring tests/test_xfft.py's
cases: every declared property (real forward, real round trip, mean pad,
crop, shifted layout, band) under the registry's choice and under each
pinned variant. Both sides run float64 for the plans (rel 1e-10 of the
peak); the programs take float32 stacks (rel 2e-4 of the peak, the
tolerance tests/test_xfft.py holds its float32 sspec program to, against
the same values through the JAX programs in float64). The
port's sites that now go through a plan (``autocovariance``,
``acf_from_sspec``, ``secondary_spectrum_power`` on both its branches
and the ACF model's ``calc_sspec``) are held bitwise to the lowering
they ran before it, and each program bitwise to the direct call it
stands for."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scintools_tpu.ops import xfft as jxfft
from scintools_tpu_torch import backend as TB
from scintools_tpu_torch.obs import retrace
from scintools_tpu_torch.ops import acf as tacf
from scintools_tpu_torch.ops import sspec as tsspec
from scintools_tpu_torch.ops import xfft as txfft
from scintools_tpu_torch.sim import acf_model as tacfm
from scintools_tpu_torch.backend import REAL

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)       # tier-1 runs under xdist workers
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def rng():
    return np.random.default_rng(23)


def _near(got, want, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.max(np.abs(want)))


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.numpy().tobytes() == b.numpy().tobytes()


# ---------------------------------------------------------------------
# the plan against the JAX plan
# ---------------------------------------------------------------------

PLANS = {
    "real_forward": (dict(shape=(12, 10), pad_to=(16, 14), real_input=True,
                          op="xfft.acf_sspec"), "forward"),
    "real_forward_shifted": (dict(shape=(12, 10), real_input=True,
                                  layout="shifted", op="xfft.acf_sspec"),
                             "forward"),
    "real_round_trip": (dict(shape=(12, 10), pad_to=(24, 20),
                             real_input=True, op="xfft.acf"), "acf"),
    "real_round_trip_shifted": (dict(shape=(12, 10), pad_to=(24, 20),
                                     real_input=True, layout="shifted",
                                     op="xfft.acf"), "acf"),
    "mean_pad": (dict(shape=(12, 10), pad_to=(48, 40), real_input=True,
                      mean_pad=True), "half"),
    "zero_pad_half": (dict(shape=(12, 10), pad_to=(48, 40),
                           real_input=True), "half"),
    "crop_halved_power": (dict(shape=(12, 10), pad_to=(32, 32),
                               real_input=True, crop=(16, None),
                               layout="shifted", op="xfft.sspec"), "power"),
    "full_frame_power": (dict(shape=(12, 10), pad_to=(32, 32),
                              real_input=True, layout="shifted",
                              op="xfft.sspec"), "power"),
    "band": (dict(shape=(12, 10), pad_to=(32, 32), real_input=True,
                  band=((0.5, 7.5, 10), (-6.0, 9.0, 12))), "power"),
}
# the variants a call may pin, per method (None: the registry's)
PINS = {"forward": [None, "rfft", "fft2"], "acf": [None, "real", "dense"],
        "half": [None], "power": [None, "structured", "dense"]}
PLAN_CASES = [(name, pin) for name, (_, m) in PLANS.items()
              for pin in PINS[m]]


def _pin_for(kw, pin):
    if pin != "structured":
        return pin
    return "czt" if kw.get("band") else "half"


@pytest.mark.parametrize("name,pin", PLAN_CASES,
                         ids=[f"{n}-{p}" for n, p in PLAN_CASES])
def test_plan_matches_jax(name, pin, rng):
    kw, method = PLANS[name]
    kw = dict(kw)
    shape = kw.pop("shape")
    pad_to = kw.pop("pad_to", None)
    x = rng.standard_normal(shape) + 1.5
    jp = jxfft.plan(shape, pad_to, **kw)
    tp = txfft.plan(shape, pad_to, **kw)
    assert tp.describe() == jp.describe()
    extra = {} if method == "half" else {"variant": _pin_for(kw, pin)}
    want = getattr(jp, method)(jnp.asarray(x), xp=jnp, **extra)
    got = getattr(tp, method)(torch.from_numpy(x), **extra)
    assert got.dtype in (torch.float64, torch.complex128)
    _near(got, want, 1e-10)


@pytest.mark.parametrize("crop,pin", [((6, 5), None), ((6, 5), "dense"),
                                      (None, None)])
def test_inverse_with_declared_crop_matches_jax(crop, pin, rng):
    X = rng.standard_normal((16, 14)) + 1j * rng.standard_normal((16, 14))
    jp = jxfft.plan((16, 14), crop=crop, op="xfft.acf")
    tp = txfft.plan((16, 14), crop=crop, op="xfft.acf")
    _near(tp.inverse(torch.from_numpy(X), variant=pin),
          jp.inverse(jnp.asarray(X), xp=jnp, variant=pin), 1e-12)


def test_plan_routes_through_the_registry():
    p = txfft.plan((16, 12), (32, 24), real_input=True, layout="shifted",
                   op="xfft.acf")
    assert p.variant(platform="cuda") == "real" and p.structured()
    TB.set_formulation("xfft.acf", "dense")
    try:
        assert p.variant(platform="cuda") == "dense"
        assert not p.structured(platform="cpu")
        assert p.describe()["variant"] == "dense"
    finally:
        TB.set_formulation("xfft.acf", None)
    assert p.variant("dense") == "dense"
    assert txfft.plan((4, 4)).variant() == "dense"      # no op: dense
    assert txfft.plan((4, 4), band=((0, 1, 2), (0, 1, 2))).op == "xfft.zoom"


def test_plan_validation_matches_jax():
    for kw in (dict(layout="weird"),
               dict(layout="shifted", band=((0, 1, 2), (0, 1, 2))),
               dict(band=((0, 1), (0, 1)))):
        with pytest.raises(ValueError):
            jxfft.plan((12, 10), (16, 16), **kw)
        with pytest.raises(ValueError):
            txfft.plan((12, 10), (16, 16), **kw)


# ---------------------------------------------------------------------
# the cached programs
# ---------------------------------------------------------------------

def _programs(variant):
    """(port program, JAX program, arguments builder, direct port call)
    for each of the four."""
    band_r, band_c = (0.5, 7.5), (-6.0, 9.0)
    pts = np.array([0.3, 2.7, -4.1, 11.5, 17.25])
    return {
        "acf": (
            lambda: txfft.acf_program(12, 10, variant=variant, device=CPU),
            lambda: jxfft.acf_program(12, 10, variant=variant),
            lambda x: (x,),
            lambda x: tacf.autocovariance(x, variant=variant, device=CPU)),
        "sspec": (
            lambda: txfft.sspec_power_program(12, 10, variant=variant,
                                              device=CPU),
            lambda: jxfft.sspec_power_program(12, 10, variant=variant),
            lambda x: (x,),
            lambda x: tsspec.secondary_spectrum_power(x, variant=variant)),
        "zoom": (
            lambda: txfft.zoom_power_program(12, 10, (32, 32), 10, 12,
                                             variant=variant, device=CPU),
            lambda: jxfft.zoom_power_program(12, 10, (32, 32), 10, 12,
                                             variant=variant),
            lambda x: (x, band_r, band_c),
            lambda x: txfft.zoom_power_2d(x, (32, 32), band_r + (10,),
                                          band_c + (12,), variant=variant)),
        "offgrid": (
            lambda: txfft.offgrid_program(10, 5, n_grid=24, variant=variant,
                                          device=CPU),
            lambda: jxfft.offgrid_program(10, 5, n_grid=24, variant=variant),
            lambda x: (x[:, 0, :], pts),
            lambda x: txfft.offgrid_dft_1d(x[:, 0, :], pts, 24,
                                           variant=variant)),
    }


PROGRAM_VARIANTS = {"acf": ("real", "dense"), "sspec": ("half", "dense"),
                    "zoom": ("czt", "dense"), "offgrid": ("taylor", "dense")}
PROGRAM_CASES = [(n, v) for n, vs in PROGRAM_VARIANTS.items()
                 for v in (None,) + vs]


@pytest.mark.parametrize("name,variant", PROGRAM_CASES,
                         ids=[f"{n}-{v}" for n, v in PROGRAM_CASES])
def test_program_matches_jax_and_direct_call(name, variant, rng):
    make_t, make_j, args, direct = _programs(variant)[name]
    x32 = rng.standard_normal((3, 12, 10)).astype(np.float32)
    x = torch.from_numpy(x32)
    got = make_t()(*args(x))
    # the same values in float64 on the JAX side: its dense zoom product
    # refuses a float32 operand under x64
    want = make_j()(*args(jnp.asarray(x32.astype(np.float64))))
    _near(got, want, 2e-4)
    _same(got, direct(x))


def test_programs_cached_per_shape_variant_and_device():
    retrace.reset()
    fn = txfft.acf_program(8, 6, device=CPU)
    assert txfft.acf_program(8, 6, device=CPU) is fn
    assert txfft.acf_program(8, 6, variant="real", device=CPU) is fn
    assert txfft.acf_program(8, 6, variant="dense", device=CPU) is not fn
    assert txfft.acf_program(9, 6, device=CPU) is not fn
    assert retrace.compile_counts().get("xfft.acf") == 3
    z = txfft.zoom_power_program(12, 10, (16, 16), 6, 8, device=CPU)
    assert txfft.zoom_power_program(12, 10, (16, 16), 6, 8,
                                    device=CPU) is z
    assert txfft.zoom_power_program(12, 10, (16, 16), 8, 8,
                                    device=CPU) is not z
    og = txfft.offgrid_program(16, 5, device=CPU)
    assert txfft.offgrid_program(16, 5, order=6, device=CPU) is not og
    assert txfft.sspec_power_program(12, 10, variant="half", device=CPU) \
        is not txfft.sspec_power_program(12, 10, variant="dense", device=CPU)


def test_programs_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        txfft.acf_program(8, 6)


# ---------------------------------------------------------------------
# the sites that go through a plan: bitwise their lowering before it
# ---------------------------------------------------------------------

def _acf_before(dyn, variant):
    x = torch.as_tensor(dyn).to(torch.float64)
    nf, nt = x.shape[-2:]
    finite = torch.isfinite(x)
    x0 = torch.where(finite, x, 0.0)
    mean = x0.sum(dim=(-2, -1), keepdim=True) / finite.sum(
        dim=(-2, -1), keepdim=True)
    x = torch.where(finite, x - mean, 0.0)
    arr = txfft.wiener_khinchin(x.to(REAL), (2 * nf, 2 * nt),
                                variant=variant)
    arr = torch.fft.fftshift(arr, dim=(-2, -1))
    return arr / arr.amax(dim=(-2, -1), keepdim=True)


def _acf_from_sspec_before(s_db, variant):
    s = torch.fft.fftshift(torch.as_tensor(s_db).to(REAL), dim=(-2, -1))
    lin = 10 ** (s / 10)
    F = txfft.fft2_full(lin, variant="rfft" if variant == "real" else "fft2")
    arr = torch.fft.fftshift(F, dim=(-2, -1)).real
    return arr / arr.max()


def _sspec_before(dyn, variant, halve=True, zoom=None, wins=None):
    nf, nt = dyn.shape[-2:]
    nrfft, ncfft = tsspec.fft_shapes(nf, nt)
    dyn = dyn - dyn.mean(dim=(-2, -1), keepdim=True)
    if wins is not None:
        dyn = tsspec.apply_window(dyn, wins[0], wins[1])
    dyn = dyn - dyn.mean(dim=(-2, -1), keepdim=True)
    if zoom is not None:
        return txfft.zoom_power_2d(dyn, (nrfft, ncfft), zoom[0], zoom[1],
                                   variant=variant)
    if halve and variant == "half":
        return txfft.halfrow_power(dyn, (nrfft, ncfft))
    return txfft.dense_power(dyn, (nrfft, ncfft), halve)


@pytest.mark.parametrize("variant", ["real", "dense"])
def test_autocovariance_is_its_pre_plan_lowering(variant, rng):
    d = rng.standard_normal((2, 12, 10))
    d[0, 3, 4] = np.nan
    _same(tacf.autocovariance(d, variant=variant, device=CPU),
          _acf_before(d, variant))
    if variant == "real":
        _same(tacf.autocovariance(d, device=CPU), _acf_before(d, variant))


@pytest.mark.parametrize("variant", ["real", "dense"])
def test_acf_from_sspec_is_its_pre_plan_lowering(variant, rng):
    s = 10 * np.log10(rng.random((16, 12)) + 0.1)
    _same(tacf.acf_from_sspec(s, variant=variant, device=CPU),
          _acf_from_sspec_before(s, variant))
    if variant == "real":
        _same(tacf.acf_from_sspec(s, device=CPU),
              _acf_from_sspec_before(s, variant))


@pytest.mark.parametrize("variant,halve,windowed", [
    ("half", True, True), ("dense", True, True), ("half", False, False),
    ("dense", False, True), (None, True, False)])
def test_sspec_power_is_its_pre_plan_lowering(variant, halve, windowed,
                                              rng):
    d = torch.from_numpy(rng.standard_normal((3, 12, 10)).astype(
        np.float32))
    wins = tsspec.get_window(10, 12) if windowed else None
    _same(tsspec.secondary_spectrum_power(d, window_arrays=wins,
                                          halve=halve, variant=variant),
          _sspec_before(d, variant or "half", halve=halve, wins=wins))


@pytest.mark.parametrize("variant", [None, "czt", "dense"])
def test_sspec_zoom_is_its_pre_plan_lowering(variant, rng):
    d = torch.from_numpy(rng.standard_normal((12, 10)).astype(np.float32))
    band = ((0.5, 7.5, 10), (-6.0, 9.0, 12))
    _same(tsspec.secondary_spectrum_power(d, zoom=band, variant=variant),
          _sspec_before(d, variant or "czt", zoom=band))


@pytest.mark.parametrize("kw", [dict(ar=2.0, nt=21, nf=17),
                                dict(psi=30.0, phasegrad=0.1, theta=0.5,
                                     ar=1.5, taumax=2.0, dnumax=2.0, nt=16,
                                     nf=14)])
def test_acf_model_sspec_is_its_pre_plan_lowering(kw):
    model = tacfm.ACF(device=CPU, **kw)
    got = model.calc_sspec()
    nf, nt = np.shape(model.acf)
    cw, sw = tsspec.get_window(nt, nf, window="hanning", frac=1)
    arr = cw * model.acf
    arr = (sw * arr.T).T
    x = torch.fft.fftshift(torch.as_tensor(arr, dtype=torch.float64))
    F = torch.fft.fftshift(txfft.hermitian_full_from_half(
        torch.fft.rfft2(x), nt))
    want = (10 * torch.log10(torch.sqrt((F * torch.conj(F)).real))).numpy()
    assert got.tobytes() == want.tobytes()
