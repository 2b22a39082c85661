"""The three surveys on the port's survey engine, and the θ-θ search
ladder, against the JAX package on the CPU: ``thth_search_ladder`` tier
by tier, ``run_psrflux_survey`` over small psrflux files with one
truncated, ``run_wavefield_survey`` over two 64² epochs, and
``run_scenario_survey`` (the port's random streams are torch's, so its
checks are the JAX tests' gates, plus equality with a plain loop over
``process_batch`` on the same epochs). Tolerances are those of the
matching route's parity tests: η rel 1e-2 (tests/test_torch_thth.py),
fitted scintillation parameters rtol 1e-4 (tests/test_torch_scint.py),
stitched intensities rel L2 < 5e-3 and corr > 0.9999
(tests/test_torch_retrieval.py)."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from test_fused_search import _arc_chunks  # noqa: E402
from test_torch_retrieval import ETA, make_arc_chunks  # noqa: E402

from scintools_tpu import dynspec as jdyn  # noqa: E402
from scintools_tpu.robust import faults as jfaults  # noqa: E402
from scintools_tpu.robust import ladder as jladder  # noqa: E402
from scintools_tpu.sim.simulation import simulate_dynspec_batch  # noqa: E402
from scintools_tpu_torch import dynspec as tdyn  # noqa: E402
from scintools_tpu_torch import obs as tobs  # noqa: E402
from scintools_tpu_torch.io.psrflux import RawDynSpec  # noqa: E402
from scintools_tpu_torch.io import psrflux as tio  # noqa: E402
from scintools_tpu_torch.obs import retrace as tretrace  # noqa: E402
from scintools_tpu_torch.robust import faults as tfaults  # noqa: E402
from scintools_tpu_torch.robust import ladder as tladder  # noqa: E402
from scintools_tpu_torch.robust import (TIER_FUSED, TIER_NUMPY,  # noqa: E402
                                        TIER_STAGED)
from scintools_tpu_torch.sim import DEFAULT_REGIMES  # noqa: E402
from scintools_tpu_torch.sim import scenario as tsc  # noqa: E402
from scintools_tpu_torch.utils import slog as tslog  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True)
def _isolate_port_observability():
    tobs.REGISTRY.reset()
    tslog.reset()
    yield
    tobs.REGISTRY.reset()
    tslog.reset()


def _records(workdir):
    out = {}
    with open(os.path.join(workdir, "journal.jsonl")) as fh:
        for line in fh:
            rec = json.loads(line)
            out[rec["epoch"]] = rec
    return out


# ---------------------------------------------------------------------
# thth_search_ladder
# ---------------------------------------------------------------------

class TestThthSearchLadder:
    @pytest.mark.parametrize("tier", [TIER_FUSED, TIER_STAGED, TIER_NUMPY])
    def test_tier_matches_jax(self, tier):
        chunks, tlist, freqs, etas, edges, eta_true, npad = _arc_chunks(
            seed=19)
        ref, rep_j = jladder.thth_search_ladder(
            chunks, freqs, tlist, etas, edges, fw=0.3, npad=npad,
            tiers=[tier])
        got, rep_t = tladder.thth_search_ladder(
            chunks, freqs, tlist, etas, edges, fw=0.3, npad=npad,
            tiers=[tier], device=CPU)
        assert rep_t.tier == rep_j.tier == tier
        assert len(got) == len(ref) == len(chunks)
        for r, o in zip(ref, got):
            assert np.isfinite(o.eta) and o.ok == r.ok == 0
            assert o.eta == pytest.approx(r.eta, rel=1e-2)
            assert o.time_mean == r.time_mean

    def test_staged_equals_jax_staged_route(self):
        from scintools_tpu.thth import search as jsearch
        from scintools_tpu_torch.thth import search as tsearch

        chunks, tlist, freqs, etas, edges, _, npad = _arc_chunks(seed=19)
        ref = jsearch.multi_chunk_search(chunks, freqs, tlist, etas, edges,
                                         fw=0.3, npad=npad, fused=False)
        got = tsearch.multi_chunk_search(chunks, freqs, tlist, etas, edges,
                                         fw=0.3, npad=npad, fused=False,
                                         device=CPU)
        for r, o in zip(ref, got):
            assert o.ok == r.ok
            assert o.eta == pytest.approx(r.eta, rel=1e-2)
            np.testing.assert_array_equal(o.etas, r.etas)

    def test_forced_fused_failure_descends_to_staged(self):
        chunks, tlist, freqs, etas, edges, _, npad = _arc_chunks(seed=19)
        with tfaults.tier_failure_hook([TIER_FUSED]):
            got, rep = tladder.thth_search_ladder(
                chunks, freqs, tlist, etas, edges, fw=0.3, npad=npad,
                epoch="row0", device=CPU)
        assert rep.tier == TIER_STAGED and rep.retries == 2
        assert all(np.isfinite(r.eta) for r in got)
        assert len(tslog.recent(event="robust.fallback")) == 2


# ---------------------------------------------------------------------
# run_psrflux_survey
# ---------------------------------------------------------------------

def _psrflux_files(tmp_path, n=6, bad=4):
    d = np.asarray(simulate_dynspec_batch(n, ns=64, nf=96, seed=77))
    files = []
    for i in range(n):
        dyn = np.transpose(d[i]).astype(np.float64)          # (nf, nt)
        raw = RawDynSpec(dyn=dyn, times=np.arange(64) * 2.0,
                         freqs=1400.0 + np.arange(96) * 0.05,
                         mjd=60000.0 + i)
        path = os.path.join(tmp_path, f"ep{i}.dynspec")
        tio.write_psrflux(raw, path)
        files.append(path)
    tfaults.corrupt_file_tail(files[bad], drop_bytes=200)
    return files


class TestPsrfluxSurvey:
    def test_matches_jax(self, tmp_path):
        files = _psrflux_files(tmp_path)
        wd_j, wd_t = tmp_path / "jax", tmp_path / "torch"
        out_j = jdyn.run_psrflux_survey(files, os.fspath(wd_j))
        out_t = tdyn.run_psrflux_survey(files, os.fspath(wd_t), device=CPU)
        assert out_t["summary"]["n_ok"] == out_j["summary"]["n_ok"] == 5
        assert out_t["summary"]["n_quarantined"] == 1
        rj, rt = _records(wd_j), _records(wd_t)
        assert list(rt) == list(rj)
        for eid in rj:
            for k in ("status", "tier", "error_class"):
                assert rt[eid].get(k) == rj[eid].get(k), (eid, k)
        assert rt["ep4.dynspec"]["error_class"] == "MalformedInputError"
        for eid, rec in rt.items():
            if rec["status"] != "ok":
                continue
            for k in ("tau", "dnu", "amp", "chisqr", "redchi"):
                np.testing.assert_allclose(rec["result"][k],
                                           rj[eid]["result"][k], rtol=1e-4,
                                           err_msg=f"{eid} {k}")
        with open(os.path.join(wd_t, "run_report.json")) as fh:
            from scintools_tpu.obs.report import validate_run_report

            validate_run_report(json.load(fh))

    def test_pipeline_and_numpy_tier(self, tmp_path):
        files = _psrflux_files(tmp_path)
        tdyn.run_psrflux_survey(files, os.fspath(tmp_path / "p"),
                                inflight=3, device=CPU)
        tdyn.run_psrflux_survey(files, os.fspath(tmp_path / "s"),
                                pipeline=False, device=CPU)
        with open(tmp_path / "p" / "journal.jsonl", "rb") as a, \
                open(tmp_path / "s" / "journal.jsonl", "rb") as b:
            assert a.read() == b.read()
        # one route, one tier: a failed fit is quarantined, not rerun
        with tfaults.tier_failure_hook([TIER_FUSED]):
            out = tdyn.run_psrflux_survey(files, os.fspath(tmp_path / "q"),
                                          retries=0, device=CPU)
        assert out["summary"]["n_quarantined"] == 6
        assert not out["summary"]["tier_counts"].get(TIER_NUMPY)
        # a caller who lists the numpy tier gets the same fit under it
        with tfaults.tier_failure_hook([TIER_FUSED]):
            out = tdyn.run_psrflux_survey(files, os.fspath(tmp_path / "n"),
                                          retries=0, device=CPU,
                                          tiers=(TIER_FUSED, TIER_NUMPY))
        assert out["summary"]["tier_counts"][TIER_NUMPY] == 5
        rn, rs = _records(tmp_path / "n"), _records(tmp_path / "s")
        for eid, rec in rn.items():
            if rec["status"] == "ok":
                assert rec["result"] == rs[eid]["result"]

    def test_rerun_resumes_and_builds_nothing(self, tmp_path):
        files = _psrflux_files(tmp_path)
        wd = os.fspath(tmp_path / "run")
        tdyn.run_psrflux_survey(files, os.fspath(tmp_path / "warm"),
                                device=CPU)
        with tretrace.retrace_guard():
            tdyn.run_psrflux_survey(files, wd, device=CPU)
            out = tdyn.run_psrflux_survey(files, wd, device=CPU)
        assert out["summary"]["n_resumed"] == 6
        assert out["summary"]["n_ok"] == 0


# ---------------------------------------------------------------------
# run_wavefield_survey
# ---------------------------------------------------------------------

def _wavefield_epochs():
    chunks, times, freqs, edges = make_arc_chunks(n_chunks=1)
    rng = np.random.default_rng(12)
    dyn0 = chunks[0]
    dyns = [dyn0, dyn0 + 0.01 * rng.standard_normal(dyn0.shape)]
    epochs = [(f"w{i}", (d, times, freqs)) for i, d in enumerate(dyns)]
    return epochs, edges


def _gap(a, b):
    Ia, Ib = np.abs(a) ** 2, np.abs(b) ** 2
    return (np.linalg.norm(Ia - Ib) / np.linalg.norm(Ib),
            np.corrcoef(Ia.ravel(), Ib.ravel())[0, 1])


class TestWavefieldSurvey:
    KW = dict(cwf=32, cwt=32, npad=1)

    def _run_pair(self, tmp_path, tiers_failing=()):
        epochs, edges = _wavefield_epochs()
        with jfaults.tier_failure_hook(list(tiers_failing)):
            out_j = jdyn.run_wavefield_survey(
                epochs, os.fspath(tmp_path / "jax"), edges, ETA,
                method="warm", retries=0, **self.KW)
        with tfaults.tier_failure_hook(list(tiers_failing)):
            out_t = tdyn.run_wavefield_survey(
                epochs, os.fspath(tmp_path / "torch"), edges, ETA,
                retries=0, device=CPU, **self.KW)
        return out_j, out_t

    def _compare(self, tmp_path, out_j, out_t):
        rj, rt = _records(tmp_path / "jax"), _records(tmp_path / "torch")
        assert list(rt) == list(rj) == ["w0", "w1"]
        for eid in rj:
            a, b = rt[eid]["result"], rj[eid]["result"]
            assert rt[eid]["tier"] == rj[eid]["tier"]
            for k in ("n_chunks", "ncf", "nct", "n_quarantined"):
                assert a[k] == b[k], k
            assert a["n_chunks"] == 9
            assert a["wf_power"] == pytest.approx(b["wf_power"], rel=5e-3)
            wt = np.load(tmp_path / "torch" / a["file"])
            wj = np.load(tmp_path / "jax" / b["file"])
            assert wt.shape == wj.shape == (64, 64)
            rel, corr = _gap(wt, wj)
            assert rel < 5e-3 and corr > 0.9999, (eid, rel, corr)
        return rt

    def test_fused_matches_jax(self, tmp_path):
        out_j, out_t = self._run_pair(tmp_path)
        rt = self._compare(tmp_path, out_j, out_t)
        assert all(r["tier"] == TIER_FUSED for r in rt.values())

    def test_numpy_tier_matches_jax(self, tmp_path):
        out_j, out_t = self._run_pair(tmp_path, (TIER_FUSED, TIER_STAGED))
        rt = self._compare(tmp_path, out_j, out_t)
        assert all(r["tier"] == TIER_NUMPY for r in rt.values())

    def test_numpy_tier_calls_the_kernel_wrapper(self, tmp_path,
                                                 monkeypatch):
        """The numpy tier's per-chunk retrievals go through the
        eigensolver's kernel wrapper (which launches the kernel on a
        card), one chain of one per chunk."""
        from scintools_tpu_torch.thth import retrieval as tret

        calls = []
        orig = tret.batched_eigvec_warmstart

        def counted(a_ri, *args, **kw):
            calls.append(tuple(a_ri.shape[:2]))
            return orig(a_ri, *args, **kw)

        monkeypatch.setattr(tret, "batched_eigvec_warmstart", counted)
        epochs, edges = _wavefield_epochs()
        with tfaults.tier_failure_hook([TIER_FUSED, TIER_STAGED]):
            out = tdyn.run_wavefield_survey(
                epochs[:1], os.fspath(tmp_path), edges, ETA, retries=0,
                device=CPU, **self.KW)
        rec = out["results"]["w0"]
        assert out["outcomes"][0].tier == TIER_NUMPY
        assert calls == [(1, 1)] * (rec["n_chunks"] - rec["n_quarantined"])
        assert len(calls) == 9

    def test_staged_equals_fused_and_resume(self, tmp_path):
        epochs, edges = _wavefield_epochs()
        fused = tdyn.run_wavefield_survey(
            epochs, os.fspath(tmp_path / "f"), edges, ETA, device=CPU,
            **self.KW)
        with tfaults.tier_failure_hook([TIER_FUSED]):
            staged = tdyn.run_wavefield_survey(
                epochs, os.fspath(tmp_path / "s"), edges, ETA, retries=0,
                device=CPU, **self.KW)
        assert staged["summary"]["tier_counts"][TIER_STAGED] == 2
        for eid in ("w0", "w1"):
            a, b = fused["results"][eid], staged["results"][eid]
            assert a["n_quarantined"] == b["n_quarantined"]
            wf = np.load(tmp_path / "f" / a["file"])
            ws = np.load(tmp_path / "s" / b["file"])
            assert np.linalg.norm(ws - wf) / np.linalg.norm(wf) < 1e-5
        again = tdyn.run_wavefield_survey(
            epochs, os.fspath(tmp_path / "f"), edges, ETA, device=CPU,
            **self.KW)
        assert again["summary"]["n_resumed"] == 2
        assert again["summary"]["n_ok"] == 0


# ---------------------------------------------------------------------
# run_scenario_survey
# ---------------------------------------------------------------------

# the JAX tests' configuration (tests/test_sim_factory.py): the resolved
# default geometry ns=128/nf=64, 16 epochs per regime
KW = dict(epochs_per_regime=16, batch_size=16, seed=2, numsteps=800,
          n_iter=30)


@pytest.fixture(scope="module")
def scenario_run(tmp_path_factory):
    wd = os.fspath(tmp_path_factory.mktemp("scenario") / "run")
    return wd, tsc.run_scenario_survey(wd, device=CPU, **KW)


class TestScenarioSurvey:
    def test_end_to_end(self, scenario_run):
        from scintools_tpu.obs.report import validate_run_report

        wd, out = scenario_run
        s = out["summary"]
        assert s["n_epochs"] == 48 and s["n_ok"] == 48
        assert s["n_quarantined"] == 0
        rec = out["recovery"]
        assert set(rec) == {r["name"] for r in DEFAULT_REGIMES}
        for regime, d in rec.items():
            assert d["n_ok"] == 16
            assert d["eta_med_rel"] < 0.35, (regime, d)
            assert d["tau_med_rel"] < 0.5, (regime, d)
            assert d["dnu_med_rel"] < 0.7, (regime, d)
        assert os.path.exists(os.path.join(wd, "journal.jsonl"))
        with open(os.path.join(wd, "run_report.json")) as fh:
            validate_run_report(json.load(fh))
        any_rec = next(iter(out["results"].values()))
        assert {"eta", "tau", "dnu", "eta_true", "tau_true",
                "dnu_true", "regime", "ok"} <= set(any_rec)

    def test_resume_serves_all_from_journal(self, scenario_run):
        wd, _ = scenario_run
        with tretrace.retrace_guard():
            out = tsc.run_scenario_survey(wd, device=CPU, **KW)
        assert out["summary"]["n_resumed"] == 48
        assert out["summary"]["n_ok"] == 0

    def test_runner_equals_plain_loop(self, scenario_run):
        """The loop of chip_smoke.py 12.3: ``process_batch`` per batch,
        and a lane the batch refuses through ``process`` on the staged
        tier. The runner's journaled results are those values."""
        _, out = scenario_run
        wl = tsc.scenario_workload(
            epochs_per_regime=KW["epochs_per_regime"], seed=KW["seed"],
            numsteps=KW["numsteps"], n_iter=KW["n_iter"], device=CPU)
        epochs, bs = wl["epochs"], KW["batch_size"]
        loop, descended = {}, []
        for i in range(0, len(epochs), bs):
            group = epochs[i:i + bs]
            for (eid, p), r in zip(group, wl["process_batch"](
                    [p for _, p in group])):
                if r["ok"] != 0:
                    descended.append(eid)
                    r = wl["process"](p, tier=TIER_STAGED)
                loop[eid] = r
        assert sorted(loop) == sorted(out["results"])
        for eid, r in loop.items():
            assert json.dumps(out["results"][eid], sort_keys=True) \
                == json.dumps(r, sort_keys=True), eid
        tiers = {o.epoch: o.tier for o in out["outcomes"]}
        assert sorted(e for e, t in tiers.items() if t != TIER_FUSED) \
            == sorted(descended)

    def test_poisoned_regime_quarantined(self, tmp_path):
        regimes = ({"name": "good", "mb2": 2.0},
                   {"name": "bad", "mb2": float("nan")})
        out = tsc.run_scenario_survey(
            os.fspath(tmp_path / "run"), regimes=regimes,
            epochs_per_regime=3, ns=32, nf=16, ds=0.04,
            batch_size=3, seed=4, numsteps=600, n_iter=20, retries=0,
            device=CPU)
        s = out["summary"]
        assert s["n_epochs"] == 6
        assert s["n_quarantined"] == 3
        good = [o for o in out["outcomes"]
                if str(o.epoch).startswith("good/")]
        assert all(o.status == "ok" for o in good)
        bad = [o for o in out["outcomes"] if str(o.epoch).startswith("bad/")]
        assert all(o.error_class == "MalformedInputError" for o in bad)

    def test_numpy_tier_calls_the_kernel_wrapper(self, tmp_path,
                                                 monkeypatch):
        """A lane on the numpy tier still fits its arc through the
        arc-profile wrapper (which launches the kernel on a card)."""
        from scintools_tpu_torch.ops import normsspec

        calls = []
        orig = normsspec.arc_profile

        def counted(*args, **kw):
            calls.append(1)
            return orig(*args, **kw)

        monkeypatch.setattr(normsspec, "arc_profile", counted)
        with tfaults.tier_failure_hook([TIER_FUSED, TIER_STAGED]):
            out = tsc.run_scenario_survey(
                os.fspath(tmp_path / "run"),
                regimes=({"name": "good", "mb2": 2.0},),
                epochs_per_regime=2, ns=32, nf=16, ds=0.04, batch_size=2,
                seed=4, numsteps=600, n_iter=20, retries=0, device=CPU)
        assert out["summary"]["tier_counts"][TIER_NUMPY] == 2
        assert out["summary"]["n_ok"] == 2
        assert len(calls) == 2

    def test_kernel_error_propagates(self, tmp_path, monkeypatch):
        from scintools_tpu_torch.backend import KernelError
        from scintools_tpu_torch.ops import normsspec

        def broken(*args, **kw):
            raise KernelError("arc_profile launch failed (1)")

        monkeypatch.setattr(normsspec, "arc_profile", broken)
        wd = os.fspath(tmp_path / "run")
        with pytest.raises(KernelError):
            _run_kernel_error_case(wd)
        recs = _records(wd) if os.path.exists(
            os.path.join(wd, "journal.jsonl")) else {}
        assert all(r["tier"] != TIER_NUMPY for r in recs.values())


def _run_kernel_error_case(wd):
    """One small batch whose arc fit raises a ``KernelError``."""
    return tsc.run_scenario_survey(
        wd, regimes=({"name": "good", "mb2": 2.0},), epochs_per_regime=2,
        ns=32, nf=16, ds=0.04, batch_size=2, seed=4, numsteps=600,
        n_iter=20, device=CPU)
