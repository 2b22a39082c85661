"""The port's arc-curvature slice (scintools_tpu_torch/ops/arc_profile.py,
normsspec.py, fitarc_device.py, fitarc.py, scale.py, interp.py and
fit/models.py) against the JAX package on the CPU.

Inputs are made with numpy from fixed seeds and handed to both sides.
The JAX side runs under tier-1's x64: its Pallas arc-profile kernel in
interpret mode (float32 inside, as on the TPU), its survey fit through
the float64 gather formulation it picks on the CPU. The port's batch
path computes in float32 through the kernel's plain version, its
serial path interpolates in float64.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench import make_arc_dynspec  # noqa: E402
from test_arc_pallas import _arc_batch  # noqa: E402

from scintools_tpu.ops import arc_pallas as jpal  # noqa: E402
from scintools_tpu.ops import fitarc as jfa  # noqa: E402
from scintools_tpu.ops import fitarc_device as jfd  # noqa: E402
from scintools_tpu.ops import normsspec as jns  # noqa: E402
from scintools_tpu.ops import scale as jscale  # noqa: E402
from scintools_tpu.fit import models as jmodels  # noqa: E402
from scintools_tpu_torch.fit import models as tmodels  # noqa: E402
from scintools_tpu_torch.ops import arc_profile as tap  # noqa: E402
from scintools_tpu_torch.ops import fitarc as tfa  # noqa: E402
from scintools_tpu_torch.ops import fitarc_device as tfd  # noqa: E402
from scintools_tpu_torch.ops import normsspec as tns  # noqa: E402
from scintools_tpu_torch.ops import scale as tscale  # noqa: E402
from scintools_tpu_torch.ops.sspec import secondary_spectrum  # noqa: E402
from scintools_tpu_torch.obs.retrace import compile_counts  # noqa: E402

CPU = "cpu"


def _arc_fit_builds():
    """Builds of ``fit_arc_batch``'s device functions so far."""
    return compile_counts().get("ops.arc_fit_device", 0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)       # tier-1 runs under xdist workers
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arc_epochs():
    """tests/test_arc.py TestFitArcBatch's fixture: 3 epochs of 128²
    synthetic arcs (seeds 50-52), their secondary spectra by the JAX
    package's numpy route, in dB."""
    from scintools_tpu.dynspec import BasicDyn, Dynspec

    B, nt, nf = 3, 128, 128
    dt, df, f0 = 2.0, 0.05, 1400.0
    sspecs = []
    for b in range(B):
        dyn = make_arc_dynspec(nt, nf, dt, df, f0, 5e-4, n_images=32,
                               seed=50 + b)
        bd = BasicDyn(dyn, name=f"e{b}", times=np.arange(nt) * dt,
                      freqs=f0 + np.arange(nf) * df, dt=dt, df=df)
        ds = Dynspec(dyn=bd, process=False, verbose=False, backend="numpy")
        ds.calc_sspec(prewhite=False, lamsteps=False, window="hanning",
                      window_frac=0.1)
        sspecs.append(np.asarray(ds.sspec, float))
    return np.stack(sspecs), np.asarray(ds.tdel), np.asarray(ds.fdop)


def _kernel_inputs(sspecs, tdel, fdop, etas, startbin, cutmid):
    """The kernel surface's inputs, built in numpy as
    normsspec.make_arc_profile_batch_fn builds them."""
    ind = int(np.argmin(np.abs(tdel - np.max(tdel))))
    tdel_c = tdel[startbin:ind]
    s = np.array(sspecs[:, startbin:ind, :])
    nc = s.shape[-1]
    if cutmid:
        s[:, :, int(nc / 2 - cutmid // 2):int(nc / 2 + cutmid // 2)] = np.nan
    good = ~np.isnan(s)
    scales = np.sqrt(tdel_c[None, :] / etas[:, None])
    return (np.where(good, s, 0.0).astype(np.float32),
            good.astype(np.float32), scales.astype(np.float32), tdel_c)


def _cut(nc, cutmid):
    """The cut columns [c0, c1) of the JAX package's slice."""
    if not cutmid:
        return (0, 0)
    return (int(nc / 2 - cutmid // 2), int(nc / 2 + cutmid // 2))


def _surface_inputs(sspecs, tdel, fdop, etas, startbin, numsteps, cutmid):
    """The kernel's surface (``ops.arc_profile.arc_profile``) built in
    numpy: the spectra as they are, the scales rounded once to float32,
    the query grid, the row range, the cut and the float32 constants."""
    ind = int(np.argmin(np.abs(tdel - np.max(tdel))))
    scales = np.sqrt(tdel[startbin:ind][None, :] / etas[:, None])
    fq = np.linspace(-1, 1, numsteps + numsteps % 2)
    return (torch.from_numpy(sspecs.astype(np.float32)),
            torch.from_numpy(scales.astype(np.float32)),
            torch.from_numpy(fq.astype(np.float32)), startbin,
            _cut(len(fdop), cutmid), float(fdop[0]),
            float(np.mean(np.diff(fdop))), float(np.max(np.abs(fdop))))


def _same_bits(a, b):
    """Equal bit for bit, NaN where the other is NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        a[~na].view(torch.int32), b[~nb].view(torch.int32))


GEOMS = [dict(ntdel=40, nfdop=96, startbin=2, cutmid=3, numsteps=300,
              etas=(0.01, 0.02, 0.005)),
         dict(ntdel=24, nfdop=128, startbin=1, cutmid=0, numsteps=130,
              etas=(0.008, 0.03, 0.015))]


class TestArcProfileKernel:
    """The plain versions of the port's kernel against the TPU kernel in
    interpret mode: rtol = atol = 2e-5, the TPU kernel's own tolerance
    against its XLA base (tests/test_arc_pallas.py:35); both compute in
    float32."""

    @pytest.mark.parametrize("geom", GEOMS, ids=["40x96", "24x128"])
    def test_plain_matches_pallas_interpret(self, geom):
        """``arc_profile_plain`` at the TPU kernel's own surface, and the
        kernel's wrapper on a CPU tensor (the spectra as they are), which
        runs the plain version: bit for bit the same, no launch."""
        sspecs, tdel, fdop = _arc_batch(ntdel=geom["ntdel"],
                                        nfdop=geom["nfdop"])
        etas = np.array(geom["etas"])
        s_m, good, scales, tdel_c = _kernel_inputs(
            sspecs, tdel, fdop, etas, geom["startbin"], geom["cutmid"])
        fdopnew = np.linspace(-1, 1, geom["numsteps"])
        nc = len(fdop)
        pad = jpal.pad_to_multiple(nc) - nc
        kfn = jpal.make_arc_profile_pallas_fn(tdel_c, fdop, fdopnew,
                                              interpret=True)
        padc = ((0, 0), (0, 0), (0, pad))
        ref = np.asarray(kfn(np.pad(s_m, padc), np.pad(good, padc), scales))
        consts = (fdop[0], np.mean(np.diff(fdop)), np.max(np.abs(fdop)))
        got = tap.arc_profile_plain(
            torch.from_numpy(s_m), torch.from_numpy(good),
            torch.from_numpy(scales),
            torch.from_numpy(fdopnew.astype(np.float32)), *consts, nc)
        assert got.shape == ref.shape == (3, geom["numsteps"])
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
        before = tap.arc_profile.launches
        rows = tap.arc_profile(
            torch.from_numpy(sspecs.astype(np.float32)),
            torch.from_numpy(scales), torch.from_numpy(fdopnew.astype(
                np.float32)), geom["startbin"], _cut(nc, geom["cutmid"]),
            *consts)
        assert tap.arc_profile.launches == before      # CPU: no kernel
        assert _same_bits(rows, got)

    @pytest.mark.parametrize("fold", [False, True])
    def test_batch_fn_matches_jax_pallas_batch_fn(self, fold):
        sspecs, tdel, fdop = _arc_batch()
        kw = dict(startbin=2, cutmid=3, numsteps=300, fold=fold)
        etas = np.array([0.01, 0.02, 0.005])
        ref = np.asarray(jns.make_arc_profile_batch_fn(
            tdel, fdop, pallas=True, **kw)(sspecs, etas))
        got = tns.make_arc_profile_batch_fn(tdel, fdop, device=CPU,
                                            **kw)(sspecs, etas).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("fold", [False, True])
    def test_batch_fn_matches_jax_xla_base(self, fold):
        """Against JAX's ``pallas=False`` base (on the CPU its float64
        gather formulation): 2e-5, the tolerance the JAX package holds
        its kernel to against that base on this fixture."""
        sspecs, tdel, fdop = _arc_batch()
        kw = dict(startbin=2, cutmid=3, numsteps=300, fold=fold)
        etas = np.array([0.01, 0.02, 0.005])
        ref = np.asarray(jns.make_arc_profile_batch_fn(
            tdel, fdop, pallas=False, **kw)(sspecs, etas))
        got = tns.make_arc_profile_batch_fn(tdel, fdop, device=CPU,
                                            **kw)(sspecs, etas).numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)

    def test_nonuniform_grid_matches_jax(self):
        """A non-uniform Doppler axis takes the jnp.interp-semantics
        row interpolation on both sides (float64 there, float32 out
        here): rtol = atol = 2e-5."""
        sspecs, tdel, fdop = _arc_batch()
        fdop_nu = fdop * (1 + 0.05 * np.linspace(-1, 1, len(fdop)) ** 2)
        kw = dict(startbin=2, cutmid=3, numsteps=200)
        etas = np.array([0.01, 0.02, 0.005])
        ref = np.asarray(jns.make_arc_profile_batch_fn(
            tdel, fdop_nu, pallas=False, **kw)(sspecs, etas))
        got = tns.make_arc_profile_batch_fn(tdel, fdop_nu, device=CPU,
                                            **kw)(sspecs, etas).numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


class TestArcProfileRows:
    """The kernel's surface (the spectra read in place, with the row
    range, the cut and the scales) and its plain version
    ``arc_profile_rows_plain``."""

    @pytest.mark.parametrize("cutmid", [0, 3], ids=["nocut", "cut3"])
    @pytest.mark.parametrize("geom", GEOMS, ids=["40x96", "24x128"])
    def test_rows_plain_matches_jax_pallas_batch_fn(self, geom, cutmid):
        """Against the JAX package's ``make_arc_profile_batch_fn(
        pallas=True)`` (the Pallas kernel in interpret mode after its
        crop, cut and mask): rtol = atol = 2e-5; and the port's batch fn
        hands the wrapper exactly these arguments."""
        sspecs, tdel, fdop = _arc_batch(ntdel=geom["ntdel"],
                                        nfdop=geom["nfdop"])
        etas = np.array(geom["etas"])
        kw = dict(startbin=geom["startbin"], cutmid=cutmid,
                  numsteps=geom["numsteps"])
        ref = np.asarray(jns.make_arc_profile_batch_fn(
            tdel, fdop, pallas=True, **kw)(sspecs, etas))
        args = _surface_inputs(sspecs, tdel, fdop, etas, geom["startbin"],
                               geom["numsteps"], cutmid)
        got = tap.arc_profile_rows_plain(*args)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
        fn = tns.make_arc_profile_batch_fn(tdel, fdop, device=CPU, **kw)
        made = fn.kernel_args(sspecs, etas)
        for a, b in zip(made, args):
            if isinstance(b, torch.Tensor):
                assert _same_bits(a, b)
            else:
                assert a == b
        assert _same_bits(fn(sspecs, etas), got)

    def test_rows_plain_is_crop_mask_then_plain(self):
        """Bit for bit the crop, the NaN cut, the mask and
        ``arc_profile_plain``, on spectra with NaN pixels, ±inf pixels
        (one on an edge column) and an epoch stride larger than the
        epoch (a view into a wider array)."""
        rng = np.random.default_rng(11)
        B, ntdel, nc, Q = 3, 30, 64, 150
        wide = 20.0 + 5.0 * rng.standard_normal((B, ntdel + 4, nc))
        wide[0, 6, 9:12] = np.nan
        wide[1, 10, 40] = np.inf
        wide[2, 28, 0] = -np.inf       # the last row: queries clip to it
        spectra = torch.from_numpy(wide.astype(np.float32))[:, 2:2 + ntdel]
        assert spectra.stride(0) == (ntdel + 4) * nc
        startbin, R, cut = 2, 25, (31, 33)
        scales = torch.from_numpy(np.sqrt(np.linspace(0.3, 9.0, R)[None]
                                          / np.array([0.01, 0.02, 0.005])
                                          [:, None]).astype(np.float32))
        fq = torch.linspace(-1, 1, Q)
        consts = (-30.0, 60.0 / 63, 30.0)
        got = tap.arc_profile_rows_plain(spectra, scales, fq, startbin, cut,
                                         *consts)
        s = spectra[:, startbin:startbin + R].clone()
        s[:, :, cut[0]:cut[1]] = float("nan")
        good = ~torch.isnan(s)
        want = tap.arc_profile_plain(torch.where(good, s, 0.0),
                                     good.float(), scales, fq, *consts, nc)
        assert _same_bits(got, want)
        assert bool(torch.isnan(got).any()) and bool(torch.isinf(s).any())
        assert torch.equal(torch.isfinite(got[0]), torch.ones(Q, dtype=bool))


def _plan(B, Q=2000, nc=512, seats=132, smem_limit=232448, cluster=None):
    """``_plan`` against a stubbed card of 132 SMs: ``seats`` work units
    resident whatever their shape (one CTA an SM by default), the
    kernel's layout (16 B of barriers per stage, 128-aligned, then the
    ring) capped at ``smem_limit``."""
    def smem_bytes(k, S):
        need = -(-16 * S // 128) * 128 + S * k * nc * 4
        return need if need <= smem_limit else 0

    return tap._plan(B, Q, nc, smem_bytes, lambda c, w, smem: seats,
                     (4, 16, 8), cluster)


class TestArcProfilePlan:
    """The launch plan against a stubbed card of 132 SMs."""

    @pytest.mark.parametrize("B", [1, 16, 64, 128, 132, 1000])
    def test_one_cta_per_epoch_unless_forced(self, B):
        """C = 1 at every B (on the H100 no C > 1 was faster at 1, 16, 64
        or 128 epochs): one pass of 16 warps × 32 threads × 4 query slots
        over 2000 queries, 16 KB copies of 8 rows of 512 floats into a
        ring of 4 stages; what the card does not seat at once runs in
        further launches of 132 epochs."""
        plan = _plan(B)
        assert {p["cluster"] for p in plan} == {1}
        assert [p["epochs"] for p in plan] == \
            [132] * (B // 132) + ([B % 132] if B % 132 else [])
        for p in plan:
            assert (p["passes"], p["warps"]) == (1, 16)
            assert (p["rows"], p["stages"]) == (8, 4)
            assert p["smem"] == 128 + 4 * 8 * 512 * 4
            assert p["resident"] == 132

    def test_call_the_card_cannot_seat_in_one_launch(self):
        """50 work units at once: B = 128 runs as 50, 50 and 28 epochs;
        forced C = 4 splits each epoch's 2000 queries over 4 CTAs of 16
        warps (500 a CTA, 16 warps × 32 threads); a card that seats no
        work unit raises."""
        plan = _plan(128, seats=50)
        assert [(p["epochs"], p["cluster"]) for p in plan] == \
            [(50, 1), (50, 1), (28, 1)]
        assert all(p["resident"] == 50 for p in plan)
        p = _plan(128, seats=50, cluster=4)
        assert [(q["epochs"], q["cluster"]) for q in p] == \
            [(50, 4), (50, 4), (28, 4)]
        assert p[0]["warps"] == 16
        with pytest.raises(RuntimeError):
            _plan(4, seats=0)

    def test_forced_cluster_many_queries_and_wide_rows(self):
        plan = _plan(128, cluster=4)
        assert [(p["epochs"], p["cluster"]) for p in plan] == [(128, 4)]
        # 10⁴ queries: more than 16 warps × 32 × 4 slots hold, so each
        # epoch takes 5 passes of 2000 queries
        p = _plan(128, Q=10 ** 4)[0]
        assert (p["passes"], p["warps"]) == (5, 16)
        # rows of 20000 floats: one row a copy, stages shrink until the
        # ring fits
        p = _plan(128, nc=20000)[0]
        assert p["rows"] == 1 and p["stages"] == 2
        assert p["smem"] == 128 + 2 * 20000 * 4
        with pytest.raises(ValueError):
            _plan(128, nc=40000)


class TestTwoInterpolations:
    """Trouble spot A1: the kernel (tent) and the serial path (np.interp
    gather) differ at an exact-integer position beside a NaN bin and at
    the right edge. Each side of the port is pinned to its own JAX
    counterpart, exactly."""

    def _geometry(self):
        fdop = np.arange(-8.0, 8.0)                      # 16 bins, step 1
        tdel = np.array([0.0, 4.0])
        row = np.arange(16.0) + 10.0
        return fdop, tdel, row

    def test_integer_position_beside_nan(self):
        fdop, tdel, row = self._geometry()
        row[12] = np.nan              # the right neighbour of bin 11
        # eta = 4, tdel 4 → scale 1: query 3.0 lands on bin 11 exactly
        fq = np.array([3.0, -3.0])
        s_m = np.where(np.isnan(row), 0.0, row)[None, None].astype(
            np.float32)
        good = (~np.isnan(row))[None, None].astype(np.float32)
        scales = np.ones((1, 1), np.float32)
        got = tap.arc_profile_plain(
            torch.from_numpy(s_m), torch.from_numpy(good),
            torch.from_numpy(scales), torch.tensor(fq, dtype=torch.float32),
            fdop[0], 1.0, 8.0, 16).numpy()
        kfn = jpal.make_arc_profile_pallas_fn(tdel[1:], fdop, fq,
                                              interpret=True)
        pad = ((0, 0), (0, 0), (0, 112))
        ref = np.asarray(kfn(np.pad(s_m, pad), np.pad(good, pad), scales))
        # the tent gives the NaN neighbour zero weight: not poisoned
        np.testing.assert_array_equal(got, [[21.0, 15.0]])
        np.testing.assert_array_equal(got, ref)
        # the gather multiplies it by zero: NaN, masked
        norm, mask = tns.scaled_row_interp(row[None], fdop, tdel[1:], 4.0,
                                           fq, device=CPU)
        jn, jm = jns.scaled_row_interp(row[None], fdop, tdel[1:], 4.0, fq,
                                       backend="jax")
        np.testing.assert_array_equal(mask.numpy(), [[True, False]])
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(norm.numpy(), np.asarray(jn))

    def test_right_edge(self):
        fdop, tdel, row = self._geometry()
        row[14] = np.nan              # bin nc − 2
        fq = np.array([7.5])          # pos 15.5 → clipped to the last bin
        s_m = np.where(np.isnan(row), 0.0, row)[None, None].astype(
            np.float32)
        good = (~np.isnan(row))[None, None].astype(np.float32)
        got = tap.arc_profile_plain(
            torch.from_numpy(s_m), torch.from_numpy(good),
            torch.ones((1, 1)), torch.tensor(fq, dtype=torch.float32),
            fdop[0], 1.0, 8.0, 16).numpy()
        np.testing.assert_array_equal(got, [[25.0]])     # tap 15 alone
        norm, mask = tns.scaled_row_interp(row[None], fdop, tdel[1:], 4.0,
                                           fq, device=CPU)
        jn, jm = jns.scaled_row_interp(row[None], fdop, tdel[1:], 4.0, fq,
                                       backend="jax")
        assert bool(mask[0, 0]) and bool(np.asarray(jm)[0, 0])


class TestSerialPath:
    """The serial path against the JAX package's (``backend='jax'``,
    x64): both interpolate in float64 with the same gather arithmetic
    and fit on the host in numpy, so they agree to rounding (rel 1e-9)."""

    def test_scaled_row_interp_any_grid(self):
        rng = np.random.default_rng(3)
        fdop = np.sort(rng.uniform(-30, 30, 64))
        sspec = rng.normal(size=(12, 64))
        sspec[4, 20:23] = np.nan
        tdel = np.linspace(0.1, 6.0, 12)
        fdopnew = np.linspace(-1, 1, 90)
        norm, mask = tns.scaled_row_interp(sspec, fdop, tdel, 0.01, fdopnew,
                                           device=CPU)
        jn, jm = jns.scaled_row_interp(sspec, fdop, tdel, 0.01, fdopnew,
                                       backend="jax")
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
        ok = ~np.asarray(jm)
        np.testing.assert_allclose(norm.numpy()[ok], np.asarray(jn)[ok],
                                   rtol=1e-12)

    @pytest.mark.parametrize("opts", [
        dict(), dict(logsteps=True, cutmid=3),
        dict(weighted=False, powerspec_cut=True, subtract_artefacts=True,
             minnormfac=0.1)], ids=["default", "logsteps", "options"])
    def test_normalise_sspec(self, arc_epochs, opts):
        sspecs, tdel, fdop = arc_epochs
        kw = dict(startbin=3, numsteps=400, **opts)
        got = tns.normalise_sspec(sspecs[0], tdel, fdop, 2e-4, device=CPU,
                                  **kw)
        ref = jns.normalise_sspec(sspecs[0], tdel, fdop, 2e-4,
                                  backend="jax", **kw)
        np.testing.assert_array_equal(got.mask, ref.mask)
        np.testing.assert_array_equal(got.fdop, ref.fdop)
        np.testing.assert_allclose(got.normsspecavg, ref.normsspecavg,
                                   rtol=1e-9)
        np.testing.assert_allclose(got.powerspectrum, ref.powerspectrum,
                                   rtol=1e-9)
        np.testing.assert_allclose(got.weights, ref.weights, rtol=1e-9)

    def test_fit_arc(self, arc_epochs):
        sspecs, tdel, fdop = arc_epochs
        for b in range(len(sspecs)):
            got = tfa.fit_arc(sspecs[b], tdel, fdop, numsteps=2000,
                              device=CPU)[0]
            ref = jfa.fit_arc(sspecs[b], tdel, fdop, numsteps=2000,
                              backend="jax")[0]
            for k in ("eta", "etaerr", "etaerr2", "noise"):
                assert getattr(got, k) == pytest.approx(getattr(ref, k),
                                                        rel=1e-9), k
            np.testing.assert_allclose(got.profile, ref.profile, rtol=1e-9)
            np.testing.assert_allclose(got.eta_array, ref.eta_array,
                                       rtol=1e-12)

    @pytest.mark.parametrize("kw", [dict(asymm=True),
                                    dict(log_parabola=True)],
                             ids=["asymm", "log_parabola"])
    def test_fit_arc_options(self, arc_epochs, kw):
        """The same fits, or the same refusal (a forward parabola)."""
        sspecs, tdel, fdop = arc_epochs
        for b in range(len(sspecs)):
            try:
                ref = jfa.fit_arc(sspecs[b], tdel, fdop, numsteps=1500,
                                  backend="jax", **kw)
            except ValueError:
                with pytest.raises(ValueError):
                    tfa.fit_arc(sspecs[b], tdel, fdop, numsteps=1500,
                                device=CPU, **kw)
                continue
            got = tfa.fit_arc(sspecs[b], tdel, fdop, numsteps=1500,
                              device=CPU, **kw)
            assert len(got) == len(ref)
            for g, r in zip(got, ref):
                assert g.eta == pytest.approx(r.eta, rel=1e-9)
                assert g.etaerr == pytest.approx(r.etaerr, rel=1e-9)

    def test_unported_options_raise(self, arc_epochs):
        """``fit_spectrum`` and ``interp_nan`` are ported. The power-
        spectrum fit (``fitter`` over ``powerspectrum_model`` on the
        host) gives the JAX package's ``ps_*`` at rel 1e-3 (the spectra
        agree at 1e-9, but scipy's default ftol of 1e-8 on the cost leaves
        the parameters loose at ~1e-5), through ``normalise_sspec`` and
        through ``Dynspec.norm_sspec``, and the average it weights at
        1e-6; ``interp_nan`` (the normalised spectrum's
        NaNs filled by ``griddata`` on the host) holds to the JAX
        package's at the serial path's 1e-9."""
        from scintools_tpu import dynspec as jdyn
        from scintools_tpu_torch import dynspec as tdyn

        sspecs, tdel, fdop = arc_epochs
        ps = ("ps_wn", "ps_amp", "ps_alpha", "ps_wn_err", "ps_amp_err",
              "ps_alpha_err")
        kw = dict(fit_spectrum=True, numsteps=400)
        got = tns.normalise_sspec(sspecs[0], tdel, fdop, 2e-4, device=CPU,
                                  **kw)
        ref = jns.normalise_sspec(sspecs[0], tdel, fdop, 2e-4, backend="jax",
                                  **kw)
        for k in ps:
            assert getattr(got, k) == pytest.approx(getattr(ref, k),
                                                    rel=1e-3), k
        np.testing.assert_allclose(got.normsspecavg, ref.normsspecavg,
                                   rtol=1e-6)
        dyn = make_arc_dynspec(128, 128, 2.0, 0.05, 1400.0, 5e-4,
                               n_images=32, seed=50)
        bd = dict(times=np.arange(128) * 2.0,
                  freqs=1400.0 + np.arange(128) * 0.05)
        dj = jdyn.Dynspec(dyn=jdyn.BasicDyn(dyn, **bd), process=False,
                          verbose=False, backend="jax")
        dp = tdyn.Dynspec(dyn=tdyn.BasicDyn(dyn, **bd), process=False,
                          verbose=False, device=CPU)
        for d in (dj, dp):
            d.norm_sspec(eta=2e-4, lamsteps=False, **kw)
        for k in ps:
            assert getattr(dp, k) == pytest.approx(getattr(dj, k),
                                                   rel=1e-3), k
        kw = dict(interp_nan=True, cutmid=3, numsteps=400)
        got = tns.normalise_sspec(sspecs[0], tdel, fdop, 2e-4, device=CPU,
                                  **kw)
        ref = jns.normalise_sspec(sspecs[0], tdel, fdop, 2e-4, backend="jax",
                                  **kw)
        np.testing.assert_array_equal(got.mask, ref.mask)
        np.testing.assert_allclose(got.normsspec, ref.normsspec, rtol=1e-9,
                                   equal_nan=True)
        np.testing.assert_allclose(got.normsspecavg, ref.normsspecavg,
                                   rtol=1e-9)


class TestFitArcBatch:
    """The survey fit against the JAX package's on TestFitArcBatch's
    fixture at numsteps 2000. The port computes the profile and the
    device tail in float32, the JAX side on the CPU in float64 (A2), so
    the tolerances are those the JAX package holds its float32 device
    tail to against its float64 host tail (tests/test_arc.py:327-329):
    η rel 1e-4, etaerr rel 1e-3, etaerr2 rel 5e-2, noise rel 1e-4."""

    def _close(self, got, ref):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.eta == pytest.approx(r.eta, rel=1e-4)
            assert g.etaerr == pytest.approx(r.etaerr, rel=1e-3)
            assert g.etaerr2 == pytest.approx(r.etaerr2, rel=5e-2)
            assert g.noise == pytest.approx(r.noise, rel=1e-4)
            np.testing.assert_allclose(g.eta_array, r.eta_array, rtol=1e-10)
            np.testing.assert_allclose(g.xdata, r.xdata, rtol=1e-10)

    @pytest.mark.parametrize("on_device", [True, False])
    def test_matches_jax(self, arc_epochs, on_device):
        sspecs, tdel, fdop = arc_epochs
        got = tfa.fit_arc_batch(sspecs, tdel, fdop, numsteps=2000,
                                on_device=on_device, device=CPU)
        ref = jfa.fit_arc_batch(sspecs, tdel, fdop, numsteps=2000,
                                on_device=on_device)
        self._close(got, ref)
        assert all(np.isfinite(g.eta) for g in got)

    def test_profile_matches_jax_kernel_route(self, arc_epochs,
                                              monkeypatch):
        """The folded profile against the JAX package's own kernel route
        (``SCINTOOLS_ARC_PALLAS=1``: the Pallas kernel in interpret mode,
        float32 as the port): within 1e-5 of the profile's span. Against
        the float64 gather the float32 query positions alone move the
        profile by up to ~1e-4 dB here (neighbouring dB bins differ by
        up to ~100 dB), hence the kernel route for this comparison."""
        sspecs, tdel, fdop = arc_epochs
        monkeypatch.setenv("SCINTOOLS_ARC_PALLAS", "1")
        ref = jfa.fit_arc_batch(sspecs, tdel, fdop, numsteps=2000)
        got = tfa.fit_arc_batch(sspecs, tdel, fdop, numsteps=2000,
                                device=CPU)
        self._close(got, ref)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.profile, r.profile, rtol=0,
                                       atol=1e-5 * np.ptp(r.profile))
            np.testing.assert_allclose(g.yfit, r.yfit,
                                       atol=1e-3 * np.ptp(r.yfit))

    def test_device_tail_matches_host_tail(self, arc_epochs):
        """The port's float32 device tail against its float64 host tail
        on the same profile, every scalar (tests/test_arc.py:315-339)."""
        sspecs, tdel, fdop = arc_epochs
        dev = tfa.fit_arc_batch(sspecs, tdel, fdop, numsteps=2000,
                                on_device=True, device=CPU)
        host = tfa.fit_arc_batch(sspecs, tdel, fdop, numsteps=2000,
                                 on_device=False, device=CPU)
        self._close(dev, host)
        for d, h in zip(dev, host):
            np.testing.assert_allclose(d.profile, h.profile, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(d.yfit, h.yfit,
                                       atol=1e-3 * np.ptp(h.yfit))

    def test_constraint_quarantine(self, arc_epochs):
        """A constraint window with no η grid point NaNs every epoch on
        both tails, with the unflipped profile and its descending η axis
        (tests/test_arc.py:341-358)."""
        sspecs, tdel, fdop = arc_epochs
        kw = dict(numsteps=2000, constraint=(1e9, 1e9 + 1))
        for on_device in (True, False):
            got = tfa.fit_arc_batch(sspecs, tdel, fdop, on_device=on_device,
                                    device=CPU, **kw)
            ref = jfa.fit_arc_batch(sspecs, tdel, fdop, on_device=on_device,
                                    **kw)
            for g, r in zip(got, ref):
                assert np.isnan(g.eta) and np.isnan(r.eta)
                np.testing.assert_allclose(g.eta_array, r.eta_array,
                                           rtol=1e-10)
                np.testing.assert_allclose(g.profile, r.profile, rtol=1e-5,
                                           atol=1e-3)

    def test_peak_on_first_point_quarantines(self, arc_epochs):
        sspecs, tdel, fdop = arc_epochs
        emin = (tdel[1] - tdel[0]) * 3 / np.max(fdop) ** 2
        kw = dict(numsteps=2000, constraint=(emin * 0.9995, emin * 1.0005))
        for on_device in (True, False):
            got = tfa.fit_arc_batch(sspecs, tdel, fdop, on_device=on_device,
                                    device=CPU, **kw)
            assert all(np.isnan(g.eta) for g in got)

    def test_neg_inf_epoch_quarantines(self):
        """A −inf dB pixel (10·log10(0)) NaNs its epoch on the device
        tail and leaves the clean epoch as a clean run fits it
        (tests/test_fused_search.py:420)."""
        nt = nf = 128
        dt, df = 2.0, 0.05
        dyn = make_arc_dynspec(nt, nf, dt, df, 1400.0, 5e-4, n_images=64,
                               seed=77)
        fdop, tdel, sec = secondary_spectrum(dyn, dt, df, device=CPU)
        clean = sec.double().numpy()
        poisoned = clean.copy()
        poisoned[5, 7] = -np.inf
        fits = tfa.fit_arc_batch(np.stack([clean, poisoned]), tdel, fdop,
                                 numsteps=1000, full_output=False,
                                 device=CPU)
        ref = tfa.fit_arc_batch(clean[None], tdel, fdop, numsteps=1000,
                                full_output=False, device=CPU)
        jref = jfa.fit_arc_batch(np.stack([clean, poisoned]), tdel, fdop,
                                 numsteps=1000, full_output=False)
        assert np.isfinite(fits[0].eta)
        assert fits[0].eta == pytest.approx(ref[0].eta, rel=1e-6)
        assert fits[0].eta == pytest.approx(jref[0].eta, rel=1e-4)
        assert not np.isfinite(fits[1].eta) and not np.isfinite(jref[1].eta)
        assert not np.isfinite(fits[1].etaerr)

    def test_full_output_false_and_device_copy(self, arc_epochs):
        """A tensor passed as ``sspecs``, or alone as ``sspecs_device``
        (the JAX package's name), fits as the numpy array does, on both
        tails; ``full_output=False`` leaves the diagnostics None."""
        sspecs, tdel, fdop = arc_epochs
        s_dev = torch.as_tensor(sspecs)             # float64, as the array
        lite = tfa.fit_arc_batch(s_dev, tdel, fdop, numsteps=2000,
                                 full_output=False, device=CPU)
        alias = tfa.fit_arc_batch(None, tdel, fdop, numsteps=2000,
                                  full_output=False, sspecs_device=s_dev,
                                  device=CPU)
        full = tfa.fit_arc_batch(sspecs, tdel, fdop, numsteps=2000,
                                 device=CPU)
        host = tfa.fit_arc_batch(s_dev, tdel, fdop, numsteps=2000,
                                 on_device=False, device=CPU)
        host_np = tfa.fit_arc_batch(sspecs, tdel, fdop, numsteps=2000,
                                    on_device=False, device=CPU)
        for lf, af, ff, hf, hn in zip(lite, alias, full, host, host_np):
            assert lf.eta == ff.eta == af.eta
            assert hf.eta == hn.eta and hf.noise == hn.noise
            assert lf.profile is None and lf.eta_array is None
            assert ff.profile is not None

    def test_rejected_inputs(self, arc_epochs):
        sspecs, tdel, fdop = arc_epochs
        with pytest.raises(ValueError, match="sspecs_device"):
            tfa.fit_arc_batch(sspecs, tdel, fdop, numsteps=2000,
                              sspecs_device=torch.zeros((1, 4, 4)),
                              device=CPU)
        with pytest.raises(ValueError, match="host-only"):
            tfa.fit_arc_batch(sspecs, tdel, fdop, numsteps=2000,
                              log_parabola=True, on_device=True, device=CPU)
        with pytest.raises(AttributeError):     # not a parallel.Mesh
            tfa.fit_arc_batch(sspecs, tdel, fdop, mesh=object(), device=CPU)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                tfa.fit_arc_batch(sspecs, tdel, fdop)   # device=None: card

    def test_log_parabola_host_tail(self, arc_epochs):
        sspecs, tdel, fdop = arc_epochs
        got = tfa.fit_arc_batch(sspecs[:1], tdel, fdop, numsteps=2000,
                                log_parabola=True, device=CPU)
        ref = jfa.fit_arc_batch(sspecs[:1], tdel, fdop, numsteps=2000,
                                log_parabola=True)
        assert got[0].eta == pytest.approx(ref[0].eta, rel=1e-4)


class TestFitArcBatchCache:
    """The per-geometry cache of ``fit_arc_batch`` (the JAX package's
    FIFO of 8, scintools_tpu/ops/fitarc.py:362-413)."""

    @staticmethod
    def _eta(fits):
        return np.array([[f.eta, f.etaerr, f.etaerr2, f.noise]
                         for f in fits])

    @pytest.mark.parametrize("on_device", [True, False])
    def test_repeat_call_builds_nothing_and_keeps_the_bits(self, arc_epochs,
                                                           on_device):
        sspecs, tdel, fdop = arc_epochs
        tfa._ARC_FIT_CACHE.clear()
        kw = dict(numsteps=2000, on_device=on_device, device=CPU)
        n0 = _arc_fit_builds()
        fresh = tfa.fit_arc_batch(sspecs, tdel, fdop, **kw)
        assert _arc_fit_builds() == n0 + 1
        again = tfa.fit_arc_batch(sspecs, tdel, fdop, **kw)
        assert _arc_fit_builds() == n0 + 1
        np.testing.assert_array_equal(self._eta(again), self._eta(fresh))
        for a, f in zip(again, fresh):
            np.testing.assert_array_equal(a.profile, f.profile)
        # the JAX package keeps one entry for the same geometry too
        jfa._ARC_PROFILE_CACHE.clear()
        for _ in range(2):
            jfa.fit_arc_batch(sspecs, tdel, fdop, numsteps=2000,
                              on_device=on_device)
        assert len(jfa._ARC_PROFILE_CACHE) == 1 == len(tfa._ARC_FIT_CACHE)

    def test_a_changed_key_builds_and_the_ninth_evicts_the_first(
            self, arc_epochs):
        sspecs, tdel, fdop = arc_epochs
        tfa._ARC_FIT_CACHE.clear()
        n0 = _arc_fit_builds()
        tfa.fit_arc_batch(sspecs, tdel, fdop, numsteps=2000, device=CPU)
        for kw in (dict(numsteps=2002), dict(nsmooth=7), dict(cutmid=5),
                   dict(startbin=4), dict(delmax=tdel[100]),
                   dict(on_device=False), dict(constraint=(1e-4, 1e-2))):
            tfa.fit_arc_batch(sspecs, tdel, fdop,
                              **dict(dict(numsteps=2000, device=CPU), **kw))
        assert _arc_fit_builds() == n0 + 8
        assert len(tfa._ARC_FIT_CACHE) == 8
        first = next(iter(tfa._ARC_FIT_CACHE))
        tfa.fit_arc_batch(sspecs, tdel, fdop * 1.5, numsteps=2000,
                          device=CPU)
        assert _arc_fit_builds() == n0 + 9
        assert len(tfa._ARC_FIT_CACHE) == 8
        assert first not in tfa._ARC_FIT_CACHE
        tfa.fit_arc_batch(sspecs, tdel, fdop, numsteps=2000, device=CPU)
        assert _arc_fit_builds() == n0 + 10

class TestDeviceTailPieces:
    def test_savgol_matches_scipy(self):
        """The fixed-shape masked savgol against scipy's mode='interp'
        on random valid prefixes, in float32: rtol 1e-5, atol 1e-6
        (tests/test_arc.py:360-379)."""
        from scipy.signal import savgol_filter

        rng = np.random.default_rng(21)
        H = 64
        for w in (5, 7):
            smooth = tfd.make_savgol_interp(w, H)
            Ls = [w + 2, 13, 40, 64]
            q = rng.standard_normal((len(Ls), H))
            got = smooth(torch.tensor(q, dtype=torch.float32),
                         torch.tensor(Ls)).numpy()
            for b, L in enumerate(Ls):
                want = savgol_filter(q[b, :L], w, 1)
                np.testing.assert_allclose(got[b, :L], want, rtol=1e-5,
                                           atol=1e-6)

    def test_eta_grid_and_crop_lengths_match_jax(self):
        for numsteps in (10, 1999, 2000):
            a, fa = tfd.eta_grid(numsteps)
            b, fb = jfd.eta_grid(numsteps)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(fa, fb)
        emins, emaxs = [2e-5, 1e-4, 1e-6], [3e-3, 0.4, np.inf]
        np.testing.assert_array_equal(
            tfd.eta_crop_lengths(2000, emins, emaxs),
            jfd.eta_crop_lengths(2000, emins, emaxs))

    def test_noise_batch_matches_jax(self, arc_epochs):
        sspecs, tdel, _ = arc_epochs
        for cutmid in (0, 3):
            ref = jfa.sspec_noise_batch(sspecs, cutmid, 60)
            np.testing.assert_allclose(
                tfa.sspec_noise_batch(torch.as_tensor(sspecs), cutmid,
                                      60).numpy(), ref, rtol=1e-12)
            # float32, as the device fit runs it
            np.testing.assert_allclose(
                tfa.sspec_noise_batch(torch.as_tensor(sspecs).float(),
                                      cutmid, 60).numpy(), ref, rtol=1e-5)
            assert tfa.sspec_noise(sspecs[0], cutmid, 60) == pytest.approx(
                jfa.sspec_noise(sspecs[0], cutmid, 60), rel=1e-12)


class TestHostHelpers:
    def test_lambda_rescale_matches_jax(self):
        """Same scipy cubic in float64: rtol 1e-10."""
        rng = np.random.default_rng(9)
        freqs = 1400.0 + 0.05 * np.arange(96)
        dyn = rng.normal(size=(96, 40)) ** 2
        for spacing in ("auto", "max", "median", "mean", "min"):
            got = tscale.lambda_rescale(dyn, freqs, spacing=spacing)
            ref = jscale.lambda_rescale(dyn, freqs, spacing=spacing)
            np.testing.assert_allclose(got[0], ref[0], rtol=1e-10)
            np.testing.assert_allclose(got[1], ref[1], rtol=1e-10)
            assert got[2] == pytest.approx(ref[2], rel=1e-10)
        assert tscale.SPEED_OF_LIGHT == jscale.SPEED_OF_LIGHT
        with pytest.raises(ValueError):
            tscale.lambda_rescale(dyn, freqs, spacing="bogus")

    def test_parabola_fitters_match_jax(self):
        rng = np.random.default_rng(4)
        x = np.linspace(1e-4, 3e-4, 21)
        y = -((x - 2.1e-4) / 1e-4) ** 2 + 0.01 * rng.normal(size=21)
        for fn in ("fit_parabola", "fit_log_parabola"):
            got = getattr(tmodels, fn)(x, y)
            ref = getattr(jmodels, fn)(x, y)
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g, r, rtol=1e-12)
