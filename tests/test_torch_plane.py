"""The port's telemetry plane against the JAX package's: the snapshot
merger folds the same update sequence to the same pod view, its
Prometheus text is byte for byte the JAX text, the journal tail and the
fleet state tracker read the same files to the same records, and a
thread-mode pod serves ``/metrics``, ``/state``, ``/report``,
``/workers`` and ``/ledger`` on one port mid-run. Everything runs on the
CPU."""

import json
import random
import time
import urllib.request

import pytest

from scintools_tpu.fleet import telemetry as jtele
from scintools_tpu.obs import metrics as jmetrics
from scintools_tpu.obs import plane as jplane
from scintools_tpu_torch import obs as tobs
from scintools_tpu_torch.fleet import Pod
from scintools_tpu_torch.fleet import telemetry as ttele
from scintools_tpu_torch.obs import metrics as tmetrics
from scintools_tpu_torch.obs import plane as tplane
from scintools_tpu_torch.parallel.checkpoint import EpochJournal
from scintools_tpu_torch.utils import slog as tslog


@pytest.fixture(autouse=True)
def _isolate_port_observability():
    tobs.REGISTRY.reset()
    tslog.reset()
    yield
    tobs.REGISTRY.reset()
    tslog.reset()


def _get(url, path, timeout=10):
    try:
        r = urllib.request.urlopen(url + path, timeout=timeout)
        code, headers, body = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        code, headers, body = e.code, e.headers, e.read()
    if "json" in headers.get("Content-Type", ""):
        return code, headers, json.loads(body)
    return code, headers, body.decode()


def _worker_snapshot(metrics, rng, wid):
    """One worker's registry snapshot after a random run of updates, in
    the named package's metrics module (same draws for both)."""
    reg = metrics.MetricsRegistry()
    for _ in range(rng.randint(1, 6)):
        reg.counter("epochs_total").labels(tier=rng.choice(
            ["jax_fused", "numpy"])).inc(rng.randint(1, 3))
        reg.gauge("queue_depth").set(rng.randint(0, 9))
        reg.histogram("lat_seconds", buckets=rng.choice(
            [(0.1, 1.0), (0.5, 1.0), (0.05, 0.5, 5.0)])).observe(
            rng.uniform(0, 2))
    snap = reg.snapshot()
    if wid == "w2":
        snap["gauges"]['depth{worker="orig"}'] = 1.0
    return snap


class TestMergerAndPrometheus:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_merged_and_text_equal_jax(self, seed):
        mt, mj = tplane.SnapshotMerger(), jplane.SnapshotMerger()
        for step in range(12):
            wid = f"w{step % 3}"
            rng_t, rng_j = random.Random(seed * 100 + step), \
                random.Random(seed * 100 + step)
            st = _worker_snapshot(tmetrics, rng_t, wid)
            sj = _worker_snapshot(jmetrics, rng_j, wid)
            assert st == sj
            assert mt.update(wid, st) == mj.update(wid, sj)
            assert mt.merged() == mj.merged()
        mt.update("junk", "not a snapshot")
        mj.update("junk", "not a snapshot")
        assert (mt.updates, mt.skipped) == (mj.updates, mj.skipped)
        assert mt.workers() == mj.workers()
        text = tplane.snapshot_to_prometheus(mt.merged(),
                                             help_map={"epochs_total": "e"})
        assert text == jplane.snapshot_to_prometheus(
            mj.merged(), help_map={"epochs_total": "e"})
        assert "# TYPE lat_seconds histogram" in text
        assert tplane.snapshot_to_prometheus({}) == ""


class TestTailAndTracker:
    def _journals(self, root):
        rows = {"w0": [("e0", dict(status="ok", result={"v": 1},
                                   worker="w0", t_commit=10.0)),
                       ("e1", dict(status="ok", result={"v": 2},
                                   worker="w0", t_commit=11.0))],
                "w1": [("e0", dict(status="ok", result={"v": 1},
                                   worker="w1", t_commit=20.0)),
                       ("e1", dict(status="ok", result={"v": 99},
                                   worker="w1", t_commit=5.0)),
                       ("e2", dict(status="quarantined", tier="",
                                   error="x", error_class="ValueError",
                                   worker="w1", t_commit=6.0))]}
        for wid, recs in rows.items():
            (root / wid).mkdir(parents=True, exist_ok=True)
            j = EpochJournal(root / wid / "journal.jsonl")
            for epoch, fields in recs:
                j.append(epoch, **fields)

    def test_tail_reads_equal_jax(self, tmp_path):
        path = tmp_path / "j.jsonl"
        j = EpochJournal(path)
        j.append("e0", status="ok", result={"v": 1})
        tails = (ttele.JournalTail(path), jtele.JournalTail(path))

        def poll():
            got = [t.poll() for t in tails]
            assert got[0] == got[1]
            return got[0]

        assert [r["epoch"] for r in poll()] == ["e0"]
        assert poll() == []
        j.append("e1", status="ok", result={"v": 2})
        with open(path, "a") as fh:
            fh.write('{"epoch": "torn", "cr')
        assert [r["epoch"] for r in poll()] == ["e1"]
        with open(path, "a") as fh:
            fh.write('c": "zzz"}\n')
        assert poll() == []
        assert [(t.lines, t.corrupt) for t in tails] == [(2, 1), (2, 1)]

    def test_tracker_equal_jax(self, tmp_path):
        root = tmp_path / "workers"
        self._journals(root)
        tt, tj = ttele.FleetStateTracker(root), jtele.FleetStateTracker(root)
        assert tt.refresh() == tj.refresh() == 5
        assert tt.refresh() == 0
        assert tt.snapshot() == tj.snapshot()
        assert tt.records() == tj.records()
        st = tt.snapshot()
        assert st["duplicates"] == 2 and st["conflicts"] == 1
        assert tt.records()["e1"]["result"] == {"v": 99}
        assert tslog.recent(event="plane.state_conflict")
        counters = tobs.REGISTRY.snapshot()["counters"]
        assert counters["plane_state_conflicts_total"] == 1


class TestPlaneThreadMode:
    def test_endpoints_live_mid_run(self, tmp_path):
        pod = Pod(tmp_path / "pod",
                  {"target": "scintools_tpu_torch.fleet.worker:"
                             "demo_workload",
                   "params": {"n_epochs": 24, "slow_s": 0.04,
                              "device": "cpu"}},
                  n_workers=2, batch_size=4, mode="thread", lease_s=5.0,
                  monitor_s=0.05, plane_port=0).start()
        url = pod.telemetry.url
        try:
            assert json.load(open(tmp_path / "pod" / "plane.json"))[
                "url"] == url
            code, _, index = _get(url, "/")
            assert set(index["paths"]) == {"/", "/metrics", "/report",
                                           "/state", "/workers", "/ledger"}
            assert _get(url, "/nope")[0] == 404
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                state = _get(url, "/state")[2]
                if 0 < len(state["epochs"]) < 24:
                    break
                time.sleep(0.02)
            else:
                pytest.fail("never observed a mid-run /state")
            assert state["n_epochs"] == 24
            code, _, rep = _get(url, "/report")
            tobs.validate_run_report(rep)
            assert rep["in_progress"] is True and rep["runner"] == "run_pod"
            pod.poll()
            code, headers, text = _get(url, "/metrics")
            assert headers["Content-Type"].startswith(
                "text/plain; version=0.0.4")
            assert "# TYPE fleet_queue_pending gauge" in text
            workers = _get(url, "/workers")[2]
            assert set(workers["workers"]) >= {"w0", "w1"}
            assert "entries" in _get(url, "/ledger")[2]
        finally:
            out = pod.wait(timeout=120.0)
        assert out["summary"]["n_ok"] == 24
        with pytest.raises(urllib.error.URLError):
            urllib.request.urlopen(url + "/state", timeout=2)
        doc = json.load(open(tmp_path / "pod" / "trace.merged.json"))
        tobs.validate_chrome_trace(doc)
        assert out["fleet"]["trace"]["workers"] == 2
