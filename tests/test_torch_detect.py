"""The port's arc detection (``scintools_tpu_torch/detect``) against the
JAX package's on the CPU: the template bank, the overlap-save
correlation with the JAX bank carried across
(``TemplateBank.from_numpy``), the noise floor, the trigger stage, the
sub-grid refinement, the θ-θ confirmation, the NaN-lane quarantine, the
detector's records and its hook. The epochs are the JAX scenario
factory's anisotropic recall epochs (``tests/test_detect.py``) at
128 × 64. Tolerances are stated per test."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scintools_tpu import detect as J
from scintools_tpu.detect import trigger as jtrig
from scintools_tpu.sim.factory import lane_keys_from_seeds, simulate_scenarios
from scintools_tpu.sim.scenario import scenario_truths
from scintools_tpu_torch import detect as T
from scintools_tpu_torch.backend import KernelError
from scintools_tpu_torch.robust.guards import BAD_INPUT

CPU = "cpu"
NS, NF = 128, 64
DT, FREQ, DLAM = 30.0, 1400.0, 0.05
DF = FREQ * DLAM / (NF - 1)

#: two anisotropic recall regimes of tests/test_detect.py, 2 seeds each
REGIMES = ({"mb2": 16.0, "ar": 8.0, "psi": 0.0},
           {"mb2": 32.0, "ar": 8.0, "psi": 0.0})


def _truth(reg):
    return float(scenario_truths(reg["mb2"], reg["ar"], reg["psi"], 5 / 3,
                                 rf=1.0, ds=0.02, dt=DT, freq=FREQ,
                                 dlam=DLAM)["eta"])


@pytest.fixture(scope="module")
def epochs():
    payloads = [dict(reg, seed=9000 + ri * 1000 + i)
                for ri, reg in enumerate(REGIMES) for i in range(2)]
    dyn, code = simulate_scenarios(
        len(payloads), mb2=[p["mb2"] for p in payloads],
        ar=[p["ar"] for p in payloads], psi=[p["psi"] for p in payloads],
        alpha=5 / 3, ns=NS, nf=NF, dlam=DLAM, rf=1.0, ds=0.02, inner=0.001,
        keys=lane_keys_from_seeds([p["seed"] for p in payloads]),
        with_ok=True, device_out=True)
    assert not np.asarray(code).any()
    truths = np.array([_truth(p) for p in payloads])
    return np.asarray(jnp.transpose(dyn, (0, 2, 1))), truths


@pytest.fixture(scope="module")
def banks(epochs):
    _, truths = epochs
    span = (truths.min() / 5, truths.max() * 5)
    jb = J.build_bank(NF, NS, DT, DF, *span, n_templates=48)
    carried = T.TemplateBank.from_numpy(
        jb.etas, np.asarray(jb.templates), np.asarray(jb.valid), jb.tdel,
        jb.fdop, jb.shape, jb.geometry, jb.params, device=CPU)
    own = T.build_bank(NF, NS, DT, DF, *span, n_templates=48, device=CPU)
    return jb, carried, own, span


@pytest.fixture(scope="module")
def recall_set():
    """``tests/test_detect.py``'s recall set (3 anisotropic regimes × 7
    seeds from 9000, the JAX factory) through both packages' detectors
    with refinement: ``(truths, jax_records, port_records)``."""
    regimes = ({"mb2": 16.0, "ar": 8.0, "psi": 0.0},
               {"mb2": 16.0, "ar": 8.0, "psi": 30.0},
               {"mb2": 32.0, "ar": 8.0, "psi": 0.0})
    payloads = [dict(reg, seed=9000 + ri * 1000 + i)
                for ri, reg in enumerate(regimes) for i in range(7)]
    dyn, code = simulate_scenarios(
        21, mb2=[p["mb2"] for p in payloads],
        ar=[p["ar"] for p in payloads], psi=[p["psi"] for p in payloads],
        alpha=5 / 3, ns=NS, nf=NF, dlam=DLAM, rf=1.0, ds=0.02, inner=0.001,
        keys=lane_keys_from_seeds([p["seed"] for p in payloads]),
        with_ok=True, device_out=True)
    assert not np.asarray(code).any()
    dyns = np.asarray(jnp.transpose(dyn, (0, 2, 1)))
    truths = np.array([_truth(p) for p in payloads])
    kw = dict(nf=NF, nt=NS, dt=DT, df=DF, n_templates=48, confirm=False,
              f0=FREQ, eta_range=(truths.min() / 5, truths.max() * 5))
    jdet, tdet = J.ArcDetector(**kw), T.ArcDetector(device=CPU, **kw)
    return (truths, [jdet.examine("r", d, _quiet=True) for d in dyns],
            [tdet.examine("r", d, _quiet=True) for d in dyns])


@pytest.fixture()
def noise_epochs():
    rng = np.random.default_rng(11)
    return rng.normal(50.0, 3.0, (4, NF, NS)).astype(np.float32)


class TestBank:
    def test_templates_against_jax(self, banks):
        """rtol 1e-6 with atol 1e-5 of the largest |T|: both packages sum
        the band's mean and norm over 16,384 float32 pixels, whose
        rounding (~1e-6 of the peak) dominates where a template crosses
        zero."""
        jb, _, own, _ = banks
        want = np.asarray(jb.templates)
        got = own.templates.numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-5 * np.abs(want).max())
        np.testing.assert_array_equal(own.valid.numpy(),
                                      np.asarray(jb.valid))
        np.testing.assert_array_equal(own.etas, jb.etas)
        assert own.shape == tuple(jb.shape)
        assert own.describe() == jb.describe()
        assert own is T.build_bank(NF, NS, DT, DF, own.etas[0],
                                   own.etas[-1], n_templates=48,
                                   device=CPU)
        with pytest.raises(ValueError, match="eta_min"):
            T.eta_grid(2.0, 1.0)


class TestCorrelate:
    @pytest.mark.parametrize("variant", ["half", "dense"])
    def test_scores_with_the_jax_bank(self, epochs, banks, variant):
        """rtol 1e-4, atol 1e-4, the same health bits."""
        dyns, _ = epochs
        jb, carried, _, _ = banks
        js, jok = J.correlate_bank(dyns, jb, variant=variant)
        ts, tok = T.correlate_bank(dyns, carried, variant=variant)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))

    def test_even_valid_count(self, epochs, banks):
        """With the two lowest delay rows left out the valid region has an
        even pixel count, so the median is the mean of the two middle
        values (``jnp.nanmedian``), not the lower one: scores rtol
        1e-4, atol 1e-4."""
        dyns, _ = epochs
        _, _, _, span = banks
        from scintools_tpu.ops.sspec import sspec_axes

        tdel = sspec_axes(NF, NS, DT, DF, halve=True)[1]
        jb = J.build_bank(NF, NS, DT, DF, *span, n_templates=8,
                          tau_min=float(tdel[2]))
        assert int(np.asarray(jb.valid).sum()) % 2 == 0
        carried = T.TemplateBank.from_numpy(
            jb.etas, np.asarray(jb.templates), np.asarray(jb.valid),
            jb.tdel, jb.fdop, jb.shape, jb.geometry, jb.params, device=CPU)
        js, _ = J.correlate_bank(dyns, jb)
        ts, _ = T.correlate_bank(dyns, carried)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4,
                                   atol=1e-4)
        # the two middle values differ, so the lower one would not do
        x = torch.tensor([[1.0, 2.0, 4.0, 8.0]])
        assert float(torch.nanquantile(x, 0.5, dim=1)) == 3.0
        assert float(torch.nanmedian(x, dim=1).values) == 2.0

    def test_nan_lane_neighbours_bitwise(self, epochs, banks, noise_epochs):
        dyns, _ = epochs
        _, carried, _, _ = banks
        nan_lane = np.full((NF, NS), np.nan, dtype=np.float32)
        sa, oka = T.correlate_bank(np.stack([dyns[0], nan_lane, dyns[2]]),
                                   carried)
        sb, okb = T.correlate_bank(
            np.stack([dyns[0], noise_epochs[0], dyns[2]]), carried)
        assert oka.tolist() == [0, BAD_INPUT, 0]
        assert okb.tolist() == [0, 0, 0]
        assert torch.isfinite(sa).all()
        assert torch.equal(sa[0], sb[0]) and torch.equal(sa[2], sb[2])
        lanes = T.extract_triggers(sa, oka, carried.etas)
        assert lanes[1]["hit"] is False and np.isnan(lanes[1]["eta_bank"])

    def test_blocks_exactly_equal(self):
        for args in ((128, 128), (192, 128), (200, 128, 64), (1000, 96, 7)):
            assert T.time_blocks(*args) == J.time_blocks(*args)
        with pytest.raises(ValueError, match="shorter"):
            T.time_blocks(100, 128)
        dyn = np.arange(4 * 10, dtype=float).reshape(4, 10)
        np.testing.assert_array_equal(T.extract_blocks(dyn, 6, hop=3),
                                      J.extract_blocks(dyn, 6, hop=3))

    def test_geometry_mismatch_refused(self, banks):
        _, carried, _, _ = banks
        with pytest.raises(ValueError, match="geometry"):
            T.correlate_bank(np.zeros((2, NF, NS // 2)), carried)


class TestTrigger:
    def test_noise_floor(self, banks):
        """rtol 1e-5 from the same numpy frames."""
        jb, carried, _, _ = banks
        jm, js = jtrig.calibrate_noise_floor(jb)
        tm, ts = T.calibrate_noise_floor(carried)
        assert tm.dtype == ts.dtype == np.float32
        np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ts, js, rtol=1e-5)

    def test_extract_triggers(self, epochs, banks, noise_epochs):
        """The same best template and hit per lane."""
        dyns, _ = epochs
        jb, carried, _, _ = banks
        stack = np.concatenate([dyns, noise_epochs])
        floor = jtrig.calibrate_noise_floor(jb)
        want = J.extract_triggers(*J.correlate_bank(stack, jb), jb.etas,
                                  noise_floor=floor)
        got = T.extract_triggers(*T.correlate_bank(stack, carried),
                                 carried.etas, noise_floor=floor)
        assert [g["template"] for g in got] == [w["template"] for w in want]
        assert [g["hit"] for g in got] == [w["hit"] for w in want]
        assert [g["ok"] for g in got] == [w["ok"] for w in want]
        assert sum(g["hit"] for g in got) == len(dyns)
        np.testing.assert_allclose([g["z"] for g in got],
                                   [w["z"] for w in want], rtol=1e-4,
                                   atol=1e-4)

    def test_refine_eta(self, epochs, banks):
        """The refined η rtol 1e-4, the local scores rtol 1e-4 (atol 1e-4
        of their peak), the same window and band."""
        dyns, _ = epochs
        jb, carried, _, _ = banks
        for i in (0, 3):
            eta_bank = float(jb.etas[20 + i])
            want = J.refine_eta(dyns[i], jb, eta_bank)
            got = T.refine_eta(dyns[i], carried, eta_bank)
            assert got["eta_refined"] == pytest.approx(
                want["eta_refined"], rel=1e-4)
            peak = np.abs(want["scores"]).max()
            np.testing.assert_allclose(got["scores"], want["scores"],
                                       rtol=1e-4, atol=1e-4 * peak)
            np.testing.assert_array_equal(got["etas"], want["etas"])
            assert (got["eta_lo"], got["eta_hi"], got["band"]) == (
                want["eta_lo"], want["eta_hi"], want["band"])

    def test_confirm_eta(self, epochs):
        """η within rel 1e-2 (the tolerance of test_torch_thth.py's
        single-chunk search), the same health bits."""
        dyns, truths = epochs
        freqs = FREQ + np.arange(NF) * DF
        times = np.arange(NS) * DT
        kw = dict(window=1.8, eta_edges=truths[0])
        want = jtrig.confirm_eta(dyns[0], freqs, times, truths[0], **kw)
        got = T.confirm_eta(dyns[0], freqs, times, truths[0], device=CPU,
                            **kw)
        assert got.ok == want.ok == 0
        assert got.eta == pytest.approx(want.eta, rel=1e-2)
        np.testing.assert_array_equal(got.etas, want.etas)


class TestDetector:
    @pytest.fixture(scope="class")
    def detectors(self, banks):
        _, _, _, span = banks
        kw = dict(nf=NF, nt=NS, dt=DT, df=DF, eta_range=span,
                  n_templates=48, confirm=True, f0=FREQ)
        return J.ArcDetector(**kw), T.ArcDetector(device=CPU, **kw)

    def test_examine_against_jax(self, epochs, noise_epochs, detectors):
        """On an arc epoch and on noise: the same record keys, the same
        hit or no hit; the arc confirmed near the JAX η."""
        dyns, truths = epochs
        jd, td = detectors
        for dyn in (dyns[1], noise_epochs[0]):
            want = jd.examine("e", dyn, _quiet=True)
            got = td.examine("e", dyn, _quiet=True)
            assert set(got) == set(want)
            assert got["triggered"] == want["triggered"]
            assert got["confirmed"] == want["confirmed"]
            assert got["template"] == want["template"]
        assert got["triggered"] is False and got["eta"] is None
        arc = td.examine("arc", dyns[1], _quiet=True)
        assert arc["triggered"] and arc["confirmed"]
        # each detector scores its own bank (templates 1e-6 apart) and
        # noise floor, so the refined vertex moves a little more than in
        # test_refine_eta's shared bank
        assert arc["eta_refined"] == pytest.approx(
            jd.examine("arc", dyns[1], _quiet=True)["eta_refined"], rel=1e-3)
        assert abs(arc["eta"] - truths[1]) / truths[1] < 0.35
        assert td.describe() == jd.describe()

    def test_long_epoch_and_group(self, epochs, noise_epochs, detectors):
        dyns, _ = epochs
        _, td = detectors
        long_epoch = np.concatenate([dyns[0], dyns[0][:, :NS // 2]], axis=1)
        rec = td.examine("long", long_epoch, _quiet=True)
        assert rec["n_blocks"] == 2 and rec["triggered"]
        recs = td.examine_group(["a", "b"], np.stack([dyns[0],
                                                      noise_epochs[1]]),
                                _quiet=True)
        assert recs["a"]["triggered"] and not recs["b"]["triggered"]
        nan = td.examine("nan", np.full((NF, NS), np.nan, np.float32),
                         _quiet=True)
        assert nan["ok"] == BAD_INPUT and nan["health"] == ["input_nonfinite"]
        assert nan["triggered"] is False

    def test_make_hook_with_a_stub_outcome(self, epochs, noise_epochs,
                                           detectors, monkeypatch):
        """The hook annotates published epochs, skips others, contains an
        ordinary failure and lets a kernel error through."""
        from types import SimpleNamespace

        from scintools_tpu_torch.detect import online

        dyns, _ = epochs
        _, td = detectors

        class Service:
            def __init__(self):
                self.notes = {}

            def annotate(self, epoch_id, **kw):
                self.notes[epoch_id] = kw

        ok, bad = SimpleNamespace(status="ok"), SimpleNamespace(
            status="quarantined")
        svc = Service()
        hook = td.make_hook()
        assert hook.hook_stage == "detect"
        hook(svc, "e0", noise_epochs[0], ok)
        hook(svc, "e1", dyns[0], ok)
        hook(svc, "e2", dyns[0], bad)
        assert set(svc.notes) == {"e0", "e1"}
        assert svc.notes["e1"]["detect"]["triggered"]
        assert not svc.notes["e0"]["detect"]["triggered"]

        def boom(payload, outcome):
            raise ValueError("bad payload")

        td.make_hook(extract=boom)(svc, "e3", dyns[0], ok)
        assert "e3" not in svc.notes

        def broken(*a, **k):
            raise KernelError("arc kernel failed to launch")

        monkeypatch.setattr(online, "confirm_eta", broken)
        with pytest.raises(KernelError):
            hook(svc, "e4", dyns[0], ok)
        group = td.make_group_hook()
        entries = [("g0", dyns[1]), ("g1", noise_epochs[1])]
        monkeypatch.undo()
        group(svc, entries, {"g0": ok, "g1": ok})
        assert svc.notes["g0"]["detect"]["triggered"]
        assert not svc.notes["g1"]["detect"]["triggered"]

    def test_refined_share_on_the_reference_recall_set(self, recall_set):
        """The port's refined η lies closer to the truth than its bank η on
        at least 90% of the recall set of ``tests/test_detect.py`` (the
        JAX factory's 21 epochs), the reference's own gate there."""
        truths, _, port = recall_set
        tighter = sum(abs(r["eta_refined"] - t) < abs(r["eta_bank"] - t)
                      for r, t in zip(port, truths))
        assert tighter >= 0.9 * len(truths), tighter

    def test_refined_eta_on_the_reference_recall_set(self, recall_set):
        """On the same 21 epochs each of the port's refined η is within
        rel 1e-3 of the JAX detector's (each side scores its own bank), so
        both land closer than the bank η on the same epochs."""
        truths, ref, port = recall_set
        for r, p, t in zip(ref, port, truths):
            assert p["eta_refined"] == pytest.approx(r["eta_refined"],
                                                     rel=1e-3)
            assert p["eta_bank"] == pytest.approx(r["eta_bank"], rel=1e-6)
            assert (abs(p["eta_refined"] - t) < abs(p["eta_bank"] - t)) \
                == (abs(r["eta_refined"] - t) < abs(r["eta_bank"] - t))

