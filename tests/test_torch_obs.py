"""The port's observability layer against the JAX package's: the same
counter, gauge and histogram calls give equal snapshots and equal
Prometheus text; the port's RunReport and Chrome trace pass the JAX
package's validators; slog records keep their shape; and the build
accounting's ``retrace_guard`` raises on a rebuild and passes on a
repeat of a built geometry."""

import json
import os

import numpy as np
import pytest

from scintools_tpu.obs import metrics as jmetrics
from scintools_tpu.obs.report import validate_run_report
from scintools_tpu.obs.trace import validate_chrome_trace
from scintools_tpu.utils import slog as jslog
from scintools_tpu_torch import obs as tobs
from scintools_tpu_torch.obs import heartbeat as thb
from scintools_tpu_torch.obs import ledger as tledger
from scintools_tpu_torch.obs import metrics as tmetrics
from scintools_tpu_torch.obs import report as treport
from scintools_tpu_torch.obs import retrace as tretrace
from scintools_tpu_torch.utils import profiling as tprof
from scintools_tpu_torch.utils import slog as tslog


@pytest.fixture(autouse=True)
def _isolate_port_observability():
    tobs.REGISTRY.reset()
    tslog.reset()
    yield
    tobs.REGISTRY.reset()
    tslog.reset()


def _drive(mod):
    reg = mod.MetricsRegistry()
    reg.counter("survey_epochs_ok_total", help="ok").inc(3)
    reg.counter("survey_fallback_transitions_total").labels(
        tier="jax_fused").inc()
    reg.counter("survey_fallback_transitions_total").labels(
        tier="jax_staged").inc(2)
    reg.gauge("survey_prefetch_queue_depth").set(2.5)
    reg.gauge("g").labels(worker="w1").dec(4)
    h = reg.histogram("survey_load_seconds", help="load")
    for v in (0.0004, 0.02, 0.2, 7.0, 99.0):
        h.observe(v)
    reg.histogram("lat", buckets=(0.1, 1.0)).labels(tenant="a").observe(0.5)
    return reg


class TestMetricsParity:
    def test_snapshot_and_prometheus_equal(self):
        j, t = _drive(jmetrics), _drive(tmetrics)
        assert j.snapshot() == t.snapshot()
        assert j.to_prometheus() == t.to_prometheus()
        assert json.loads(json.dumps(t.snapshot())) == t.snapshot()

    def test_aggregate_snapshots_equal(self):
        snaps = [_drive(tmetrics).snapshot(), _drive(tmetrics).snapshot()]
        assert tmetrics.aggregate_snapshots(snaps) \
            == jmetrics.aggregate_snapshots(snaps)

    def test_disabled_registry_is_a_no_op(self):
        reg = tmetrics.MetricsRegistry(enabled=False)
        reg.counter("c").inc()
        assert reg.snapshot()["counters"] == {}


class TestReportAndTrace:
    def test_run_report_passes_jax_validator(self, tmp_path):
        tally = {"n_epochs": 3, "n_ok": 2, "n_quarantined": 1,
                 "n_resumed": 0, "retries": 1,
                 "tier_counts": {"jax_fused": 2, "jax_staged": 0,
                                 "numpy": 0}}
        from scintools_tpu_torch.robust.runner import EpochOutcome

        outs = [EpochOutcome("a", "ok", tier="jax_fused"),
                EpochOutcome("b", "ok", tier="jax_fused"),
                EpochOutcome("c", "quarantined", error="bad",
                             error_class="MalformedInputError")]
        tobs.counter("survey_epochs_ok_total").inc(2)
        rep = treport.build_run_report(tally, outs, wall_s=1.5,
                                       runner="run_survey")
        validate_run_report(rep)
        treport.validate_run_report(rep)
        path = treport.write_run_report(str(tmp_path), rep)
        with open(path) as fh:
            validate_run_report(json.load(fh))
        assert os.path.exists(os.path.join(tmp_path, "run_report.md"))
        snap = treport.RunReportBuilder(runner="s").snapshot(tally, outs)
        validate_run_report(snap)

    def test_chrome_trace_passes_jax_validator(self, tmp_path):
        tl = tprof.StageTimeline()
        for i in range(3):
            tl.assign_trace(f"e{i}", f"{i:05d}/e{i}")
            with tl.span(f"e{i}", "load"):
                pass
            with tl.span(f"e{i}", "dispatch"):
                pass
        path = os.path.join(tmp_path, "trace.json")
        tl.export_trace(path)
        with open(path) as fh:
            doc = json.load(fh)
        validate_chrome_trace(doc)
        tobs.validate_chrome_trace(doc)
        s = tl.summary()
        assert set(s["stage_busy_s"]) == {"load", "dispatch"}


class TestSlogAndHeartbeat:
    def test_same_records_in_both_packages(self):
        jslog.reset()
        for mod in (jslog, tslog):
            mod.log_failure("robust.quarantine", epoch="e1", stage="load",
                            error=ValueError("bad file"), tier=None)
            with mod.span("survey.run", n=2):
                pass
        strip = ("t", "pid", "secs")

        def norm(recs):
            return [{k: v for k, v in r.items() if k not in strip}
                    for r in recs]

        assert norm(tslog.recent()) == norm(jslog.recent())
        jslog.reset()

    def test_file_sink(self, tmp_path):
        path = os.path.join(tmp_path, "log.jsonl")
        tslog.configure(path=path)
        tslog.log_event("x.y", a=1)
        with open(path) as fh:
            rec = json.loads(fh.readline())
        assert rec["event"] == "x.y" and rec["a"] == 1

    def test_heartbeat_cadence(self):
        hb = thb.Heartbeat(every_n=2, every_s=1e9, total=4)
        emitted = [hb.beat(i) for i in range(1, 5)]
        assert [e is not None for e in emitted] == [False, True, False,
                                                     True]
        assert len(tslog.recent(event="survey.heartbeat")) == 2


class TestRetraceAndLedger:
    def test_retrace_guard_raises_on_rebuild(self):
        tretrace.record_build("t.site", key=("a", 1))
        with pytest.raises(tretrace.RetraceRegression):
            with tretrace.retrace_guard(sites=["t.site"]):
                tretrace.record_build("t.site", key=("b", 2))
        with tretrace.retrace_guard(sites=["t.site"]) as grew:
            pass
        assert grew == {}
        snap = tretrace.snapshot()["t.site"]
        assert snap["builds"] == 2 and snap["distinct_keys"] == 2

    def test_fit_arc_batch_builds_once_per_geometry(self):
        from scintools_tpu_torch.ops.fitarc import fit_arc_batch
        from scintools_tpu_torch.workloads import make_survey_arc_problem

        p = make_survey_arc_problem(B=2, device="cpu")
        fit_arc_batch(p["sspecs"], p["tdel"], p["fdop"], numsteps=400,
                      full_output=False, device="cpu")
        with tretrace.retrace_guard(sites=["ops.arc_fit_device"]):
            fit_arc_batch(p["sspecs"], p["tdel"], p["fdop"],
                          numsteps=400, full_output=False, device="cpu")
        with pytest.raises(tretrace.RetraceRegression):
            with tretrace.retrace_guard(sites=["ops.arc_fit_device"]):
                fit_arc_batch(p["sspecs"], p["tdel"], p["fdop"],
                              numsteps=402, full_output=False,
                              device="cpu")

    def test_ledger_platform_and_roundtrip(self, tmp_path):
        led = tledger.ProgramLedger()
        assert led.platform() in ("cpu", "cuda")
        led.record("s", 0.5)
        led.record("s", 1.5)
        led.record("s", 2.0, kind="compile")
        assert led.steady_median("s") == 1.0
        path = os.path.join(tmp_path, tledger.LEDGER_BASENAME)
        led.save(path)
        other = tledger.ProgramLedger()
        other.load(path)
        assert other.steady_median("s") == 1.0


class TestProfiling:
    def test_timer_and_trace(self, tmp_path):
        import torch

        tm = tprof.Timer()
        with tm("a"):
            torch.ones(4).sum()
        assert tm.total("a") >= 0 and "a" in tm.report()
        with tprof.trace(os.path.join(tmp_path, "tr")) as prof:
            torch.fft.fft(torch.ones(64))
        assert prof.key_averages() is not None
        with open(os.path.join(tmp_path, "tr", "trace.json")) as fh:
            assert "traceEvents" in json.load(fh)
        out = tprof.timeit_fn(lambda x: x * 2, np.ones(3), repeats=2)
        assert out["best_s"] >= 0
