"""The port's serving layer against the JAX package's: the results store
writes the same bytes for the same records; the spool watcher admits
the same files in the same order (a torn file withheld, tenants, shared
spool claims); the batch controller, tenant policy, lane assembler,
``bucket_size`` and ``pad_group`` make the same decisions for the same
observations; both daemons publish byte-identical stores for the same
stream; ``serve_psrflux_survey`` fits within rtol 1e-4 of the JAX
entry's; the batched mode's lanes match B = 1, a NaN lane quarantines
alone with its neighbours bitwise untouched; a SIGKILLed daemon restarts
and publishes nothing twice; and a kernel error in ``process``, a hook
or the warm-up ends the service and is re-raised from ``stop()``.
Everything runs on the CPU."""

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from scintools_tpu import serve as jserve
from scintools_tpu.io import MalformedInputError as JMalformed
from scintools_tpu.serve import lanes as jlanes
from scintools_tpu_torch import obs as tobs
from scintools_tpu_torch import serve as tserve
from scintools_tpu_torch.backend import KernelError
from scintools_tpu_torch.io import MalformedInputError as TMalformed
from scintools_tpu_torch.parallel.checkpoint import EpochJournal
from scintools_tpu_torch.serve import lanes as tlanes
from scintools_tpu_torch.utils import slog as tslog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one package's serve namespace and malformed-input error
PKGS = {"jax": (jserve, JMalformed), "torch": (tserve, TMalformed)}


@pytest.fixture(autouse=True)
def _isolate_port_observability():
    tobs.REGISTRY.reset()
    tobs.ledger.reset()
    tslog.reset()
    yield
    tobs.REGISTRY.reset()
    tobs.ledger.reset()
    tslog.reset()


def _wait(cond, timeout=30.0, every=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(every)
    return False


def _done_count(svc):
    c = svc.state_snapshot()["counts"]
    return (c.get("ok", 0) + c.get("quarantined", 0)
            + c.get("resumed", 0) + c.get("duplicate", 0))


def _get(port, path, timeout=10):
    """(status, headers, parsed body) from a telemetry listener."""
    try:
        r = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                   timeout=timeout)
        code, headers, body = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        code, headers, body = e.code, e.headers, e.read()
    if "json" in headers.get("Content-Type", ""):
        return code, headers, json.loads(body)
    return code, headers, body.decode()


def _numeric(malformed):
    def process(payload, tier=None):
        if isinstance(payload, np.ndarray) \
                and not np.isfinite(payload).all():
            raise malformed("<epoch>", "non-finite epoch")
        return {"v": float(np.mean(payload)), "tier": str(tier)}

    return process


# ---- the results store ----------------------------------------------------

class TestStore:
    @pytest.mark.parametrize("data", [b"spool bytes", np.arange(6.0),
                                      {"seed": 3}])
    def test_content_hash_equal(self, data):
        assert tserve.content_hash(data) == jserve.content_hash(data)

    def test_store_bytes_equal_and_index_rebuilds(self, tmp_path):
        rows = [("e0", dict(status="ok", tier="jax_fused", retries=0,
                            result={"tau": 12.5, "dnu": 0.25},
                            sha="a1")),
                ("e1", dict(status="quarantined", tier="", retries=0,
                            error="bad", error_class="MalformedInputError",
                            sha="b2")),
                ("e2", dict(status="ok", tier="jax_fused", retries=1,
                            result={"v": -1e-9}))]
        for pkg in PKGS:
            store = PKGS[pkg][0].ResultsStore(tmp_path / pkg)
            for key, fields in rows:
                store.journal.append(key, **fields)
                store.note_published(key, fields.get("sha"))
        t = (tmp_path / "torch" / "results.jsonl").read_bytes()
        assert t == (tmp_path / "jax" / "results.jsonl").read_bytes()
        again = tserve.ResultsStore(tmp_path / "torch")
        assert again.known_content("b2") == "e1"
        assert again.known_content(None) is None
        assert len(again) == 3


# ---- the spool watcher ----------------------------------------------------

def _admitted(watcher):
    out = []
    while (item := watcher.get()) is not None:
        out.append((item.epoch, os.path.basename(item.payload), item.sha,
                    item.tenant))
    return out


class TestSpoolWatcher:
    def test_same_admissions_torn_withheld_tenants(self, tmp_path):
        """Both watchers polled over one evolving spool admit the same
        files in the same order: a growing file waits until its size
        settles, tenant subdirectories namespace their files."""
        spool = tmp_path / "spool"
        (spool / "alice").mkdir(parents=True)
        ws = {p: PKGS[p][0].SpoolWatcher(spool, pattern="*.dat",
                                         settle_polls=2, start=False)
              for p in PKGS}
        seen = {p: [] for p in PKGS}

        def poll():
            for p, w in ws.items():
                w._poll_once()
                seen[p] += _admitted(w)

        (spool / "b.dat").write_bytes(b"epoch b")
        (spool / "alice" / "a.dat").write_bytes(b"epoch a")
        torn = spool / "c.dat"
        torn.write_bytes(b"par")
        poll()
        torn.write_bytes(b"partial")            # still growing
        poll()
        poll()
        assert [e for e, *_ in seen["torch"]] == ["alice/a.dat", "b.dat"]
        torn.write_bytes(b"partial and now complete")
        (spool / "ignored.txt").write_bytes(b"not a match")
        for _ in range(3):
            poll()
        assert seen["torch"] == seen["jax"]
        assert [(e, t) for e, _, _, t in seen["torch"]] == [
            ("alice/a.dat", "alice"), ("b.dat", None), ("c.dat", None)]
        assert seen["torch"][2][2] == tserve.content_hash(
            b"partial and now complete")

    def test_shared_spool_claims_each_file_once(self, tmp_path):
        spool = tmp_path / "spool"
        spool.mkdir()
        for i in range(24):
            (spool / f"e{i:03d}.dat").write_bytes(str(i).encode())
        ws = [tserve.SpoolWatcher(spool, pattern="*.dat", claim=True,
                                  owner=o, start=False) for o in "ab"]
        barrier = threading.Barrier(2)

        def race(w):
            barrier.wait()
            for _ in range(3):
                w._poll_once()

        threads = [threading.Thread(target=race, args=(w,)) for w in ws]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        got = [{e for e, *_ in _admitted(w)} for w in ws]
        assert not got[0] & got[1]
        assert got[0] | got[1] == {f"e{i:03d}.dat" for i in range(24)}
        assert sorted(os.listdir(spool)) == [".claims"]
        counters = tobs.REGISTRY.snapshot()["counters"]
        assert counters["serve_spool_claims_won_total"] == 24


# ---- lane decisions -------------------------------------------------------

class TestLaneDecisions:
    def test_bucket_and_pad(self):
        for cap in (1, 3, 8, 12, 16):
            for n in range(0, 20):
                assert tlanes.bucket_size(n, cap) \
                    == jlanes.bucket_size(n, cap)
                if n:
                    assert tlanes.pad_group(list(range(n)), cap) \
                        == jlanes.pad_group(list(range(n)), cap)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_controller_sequence(self, seed):
        rng = random.Random(seed)
        kw = dict(max_batch=rng.choice([4, 8, 16]),
                  gain=rng.choice([0.5, 1.0, 2.0]),
                  decay=rng.choice([0.25, 0.5, 0.75]))
        ct = tlanes.AdaptiveBatchController(**kw)
        cj = jlanes.AdaptiveBatchController(**kw)
        for _ in range(200):
            if rng.random() < 0.1:
                t1, tb, b = rng.uniform(0.01, 1), rng.uniform(0.01, 4), \
                    rng.choice([1, 2, 4, 8])
                assert ct.reschedule(t1, tb, b) == cj.reschedule(t1, tb, b)
                assert (ct.gain, ct.decay) == (cj.gain, cj.decay)
            backlog = rng.choice([0, 0, 1, 3, 7, 40])
            assert ct.observe(backlog) == cj.observe(backlog)
        for args in [(None, 1, 2), (1.0, 0.0, 4), (1.0, 2.0, 1)]:
            assert tlanes.amortisation_factor(*args) \
                == jlanes.amortisation_factor(*args)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_assembler_and_policy_sequence(self, seed):
        rng = random.Random(seed)
        kw = dict(max_pending=rng.choice([None, 3, 5]),
                  quotas={"flood": 0.25, "quiet": 0.5},
                  default_quota=rng.choice([1.0, 0.5]))
        pt, pj = tlanes.TenantPolicy(**kw), jlanes.TenantPolicy(**kw)
        at, aj = tlanes.LaneAssembler(pt), jlanes.LaneAssembler(pj)
        tenants = ["flood", "flood", "flood", "quiet", "other"]
        for i in range(300):
            if rng.random() < 0.6:
                t = rng.choice(tenants)
                g = rng.choice([(64, 32), (32, 16)])
                pend = rng.randint(0, 6)
                assert pt.admit(t, pend) == pj.admit(t, pend)
                at.stage(f"e{i}", t, g)
                aj.stage(f"e{i}", t, g)
            else:
                b = rng.choice([1, 2, 4, 8])
                assert pt.lane_cap("flood", b) == pj.lane_cap("flood", b)
                assert at.take(b) == aj.take(b)
            assert len(at) == len(aj)
            assert at.staged_tenants() == aj.staged_tenants()


# ---- the daemon -----------------------------------------------------------

def _stream(pkg, svc_root, **kw):
    """One package's daemon over one fixed stream (six epochs, a NaN one,
    a duplicate); returns its store's valid lines and final counts."""
    serve, malformed = PKGS[pkg]
    src = serve.QueueSource(hash_payloads=True)
    svc = serve.SurveyService(src, _numeric(malformed), svc_root,
                              http=False, heartbeat=False, report=False,
                              **kw)
    with svc:
        for i in range(6):
            src.put(f"e{i}", np.full((3, 3), float(i)))
        src.put("bad", np.full((3, 3), np.nan))
        src.put("dup", np.full((3, 3), 2.0))
        assert _wait(lambda: _done_count(svc) >= 8)
        counts = svc.state_snapshot()["counts"]
    return svc.store.valid_lines(), counts


class TestDaemon:
    def test_store_bytes_equal_jax_daemon(self, tmp_path):
        lines = {p: _stream(p, tmp_path / p) for p in PKGS}
        assert lines["torch"] == lines["jax"]
        assert lines["torch"][1] == {"ok": 6, "quarantined": 1,
                                     "duplicate": 1}
        assert tobs.REGISTRY.snapshot()["counters"][
            "serve_duplicates_total"] == 1

    def test_resume_publishes_nothing_twice(self, tmp_path):
        lines, _ = _stream("torch", tmp_path / "run")
        src = tserve.QueueSource(hash_payloads=True)
        svc = tserve.SurveyService(src, _numeric(TMalformed),
                                   tmp_path / "run", http=False,
                                   heartbeat=False)
        with svc:
            for i in range(6):
                src.put(f"e{i}", np.full((3, 3), float(i)))
            src.put("e6", np.full((3, 3), 6.0))
            assert _wait(lambda: _done_count(svc) >= 7)
            counts = svc.state_snapshot()["counts"]
        assert counts == {"resumed": 6, "ok": 1}
        assert svc.store.valid_lines()[:len(lines)] == lines
        assert len(svc.store.valid_lines()) == len(lines) + 1

    def test_validator_descends_tiers(self, tmp_path):
        calls = []

        def process(payload, tier=None):
            calls.append(tier)
            return {"tier": str(tier)}

        src = tserve.QueueSource()
        svc = tserve.SurveyService(
            src, process, tmp_path / "run", http=False, heartbeat=False,
            validate=lambda r: r["tier"] == "numpy")
        with svc:
            src.put("e0", 1.0)
            assert svc.wait_idle() and _wait(lambda: len(svc.results()))
        assert svc.results()["e0"]["tier"] == "numpy"
        assert calls == ["jax_fused", "jax_staged", "numpy"]

    def test_live_surfaces(self, tmp_path):
        def process(payload, tier=None):
            time.sleep(0.01)
            return {"v": float(np.mean(payload))}

        src = tserve.QueueSource(hash_payloads=True)
        svc = tserve.SurveyService(src, process, tmp_path / "run",
                                   heartbeat={"every_n": 2})
        port = svc.http_port
        with svc:
            code, _, ready = _get(port, "/readyz")
            assert code == 503 and ready["warm"] is False
            code, _, index = _get(port, "/")
            assert set(index["paths"]) == {
                "/", "/metrics", "/healthz", "/readyz", "/report",
                "/state", "/ledger"}
            for i in range(8):
                src.put(f"e{i}", np.full((2, 2), float(i)))
            assert _wait(lambda: _done_count(svc) >= 8)
            code, headers, text = _get(port, "/metrics")
            assert code == 200 and headers["Content-Type"].startswith(
                "text/plain; version=0.0.4")
            assert "# TYPE serve_e2e_latency_seconds histogram" in text
            code, _, rep = _get(port, "/report")
            tobs.validate_run_report(rep)
            assert rep["latency"]["n"] == 8
            assert _get(port, "/state")[2]["counts"] == {"ok": 8}
            assert _get(port, "/healthz")[0] == 200
            assert _get(port, "/readyz")[0] == 200
            assert "entries" in _get(port, "/ledger")[2]
            assert _get(port, "/nope")[0] == 404
        doc = json.load(open(svc.export_trace(tmp_path / "trace.json")))
        spans = {e["name"] for e in tobs.validate_chrome_trace(doc)
                 if e.get("ph") == "X" and e["args"].get("epoch") == "e0"}
        assert {"ingest", "dispatch", "fence", "publish"} <= spans


# ---- kernel errors end the service -----------------------------------------

class TestKernelErrorEndsService:
    @pytest.mark.parametrize("where", ["process", "hook", "group_hook",
                                       "warmup"])
    @pytest.mark.parametrize("err", [KernelError("kernel did not load"),
                                     RuntimeError("CUDA error: illegal "
                                                  "memory access")])
    def test_reraised_from_stop(self, tmp_path, where, err):
        def process(payload, tier=None):
            if where == "process":
                raise err
            return {"v": float(payload), "ok": 0}

        def raise_err(*args):
            raise err

        kw = {}
        if where == "warmup":
            kw["warmup"] = raise_err
        if where == "group_hook":
            kw.update(process_batch=lambda ps, tier=None:
                      [process(p) for p in ps], max_batch=4,
                      controller=tlanes.AdaptiveBatchController(4),
                      on_published_group=[raise_err])
            kw["controller"].observe(8)
        if where == "hook":
            kw["on_published"] = [raise_err]
        src = tserve.QueueSource()
        for i in range(3):
            src.put(f"e{i}", float(i))
        svc = tserve.SurveyService(src, process, tmp_path / "run",
                                   http=False, heartbeat=False, **kw)
        svc.start()
        assert _wait(lambda: not svc._thread.is_alive(), timeout=20)
        assert svc.healthy()["ok"] is False
        with pytest.raises(type(err), match=str(err)[:12]):
            svc.wait_idle(timeout=5)
        with pytest.raises(type(err), match=str(err)[:12]):
            svc.stop()

    def test_other_hook_and_warmup_errors_contained(self, tmp_path):
        def bad(*args):
            raise ValueError("a consumer bug")

        src = tserve.QueueSource()
        svc = tserve.SurveyService(
            src, lambda p, tier=None: {"v": float(p)}, tmp_path / "run",
            http=False, heartbeat=False, warmup=bad, on_published=[bad])
        with svc:
            for i in range(3):
                src.put(f"e{i}", float(i))
            assert _wait(lambda: len(svc.results()) == 3)
            assert svc.ready()["warm"] is True     # an epoch warmed it
        counters = tobs.REGISTRY.snapshot()["counters"]
        assert counters["serve_hook_errors_total"] == 3
        assert tslog.recent(event="serve.warmup_error")


# ---- post-publish hooks wait behind newer publishes ------------------------

class TestDeferredHooks:
    """The port's loop publishes newer arrivals before it runs a waiting
    post-publish hook call (the JAX daemon runs each straight after its
    publish): every call still runs, in publish order, before ``stop()``
    returns, and at most ``HOOK_BACKLOG`` calls wait."""

    def _serve(self, tmp_path, n, hook):
        src = tserve.QueueSource()
        for i in range(n):
            src.put(f"e{i:02d}", float(i))
        svc = tserve.SurveyService(
            src, lambda p, tier=None: {"v": float(p)}, tmp_path / "run",
            http=False, heartbeat=False, report=False, on_published=[hook])
        with svc:
            assert svc.wait_idle(timeout=30)
        return svc

    def test_publish_order_behind_newer_publishes(self, tmp_path):
        seen = []

        def hook(service, epoch_id, payload, outcome):
            seen.append((str(epoch_id),
                         service.state_snapshot()["counts"].get("ok", 0)))
            time.sleep(0.02)

        self._serve(tmp_path, 8, hook)
        assert [e for e, _ in seen] == [f"e{i:02d}" for i in range(8)]
        # a later epoch was published before an earlier one's hook ran
        assert any(n_ok > i + 1 for i, (_, n_ok) in enumerate(seen))

    def test_backlog_is_bounded(self, tmp_path, monkeypatch):
        from scintools_tpu_torch.serve import daemon as tdaemon

        monkeypatch.setattr(tdaemon, "HOOK_BACKLOG", 2)
        waiting = []

        def hook(service, epoch_id, payload, outcome):
            waiting.append(len(service._hook_q))
            time.sleep(0.01)

        svc = self._serve(tmp_path, 16, hook)
        assert len(waiting) == 16 and max(waiting) <= 2
        assert svc.state_snapshot()["counts"] == {"ok": 16}


# ---- the batched mode -----------------------------------------------------

class TestBatched:
    def test_burst_batches_then_drains(self, tmp_path):
        calls = []

        def process_batch(payloads, tier=None):
            calls.append(len(payloads))
            return [{"v": float(np.mean(p)), "ok": 0} for p in payloads]

        src = tserve.QueueSource(hash_payloads=True)
        svc = tserve.SurveyService(
            src, _numeric(TMalformed), tmp_path / "run",
            process_batch=process_batch, max_batch=8, prefetch=16,
            http=False, heartbeat=False, report=False)
        with svc:
            for i in range(32):
                src.put(f"e{i:02d}", np.full((3, 3), float(i)))
            assert _wait(lambda: len(svc.results()) == 32)
            assert calls and all(c in (2, 4, 8) for c in calls)
            assert _wait(lambda: svc._controller.current == 1, timeout=10)
        assert svc.results()["e07"]["result"]["v"] == 7.0

    def test_nan_lane_quarantined_alone_bitwise_neighbours(self):
        from scintools_tpu_torch.fit.batch import make_scint_params_serve

        B, nf, nt = 4, 16, 16
        rng = np.random.default_rng(7)
        healthy = (10.0 + rng.standard_normal((B, nf, nt))).astype(
            np.float32)
        poisoned = healthy.copy()
        poisoned[2, ::3, ::2] = np.nan
        fn = make_scint_params_serve(B, nf, nt, 1.0, 1.0, n_iter=8,
                                     device="cpu")
        out_h = {k: v.numpy() for k, v in fn(healthy).items()}
        out_p = {k: v.numpy() for k, v in fn(poisoned).items()}
        assert out_p["ok"][2] != 0 and not out_h["ok"].any()
        for k in out_h:
            for lane in (0, 1, 3):
                assert out_h[k][lane].tobytes() \
                    == out_p[k][lane].tobytes(), (k, lane)


# ---- the psrflux entry ----------------------------------------------------

def _write_epochs(spool, n=4):
    """``n`` simulated 96 × 64 epochs (dt 2 s, df 0.05 MHz) as psrflux
    files arriving atomically, and one malformed file."""
    from scintools_tpu.sim.simulation import simulate_dynspec_batch
    from scintools_tpu_torch.io.psrflux import RawDynSpec, write_psrflux

    dyns = np.transpose(np.asarray(simulate_dynspec_batch(
        n, ns=64, nf=96, seed=77)), (0, 2, 1))
    spool.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        tmp = spool.parent / f"e{i}.tmp"
        write_psrflux(RawDynSpec(dyn=dyns[i], times=2.0 * np.arange(64),
                                 freqs=1400.0 + 0.05 * np.arange(96.0)),
                      tmp)
        os.replace(tmp, spool / f"e{i}.dynspec")
    bad = spool.parent / "bad.tmp"
    bad.write_text("# MJD0: 60000\nnot a dynspec\n")
    os.replace(bad, spool / "bad.dynspec")
    return n


def _serve_results(svc, n_total, timeout=120):
    """The store after ``n_total`` epochs are done and ``stop()`` has
    drained the journal writer (a publish reaches the journal through
    the writer's thread)."""
    try:
        assert _wait(lambda: _done_count(svc) >= n_total, timeout=timeout)
    finally:
        svc.stop()
    return svc.results()


class TestServePsrflux:
    def test_fits_match_jax_entry(self, tmp_path):
        from scintools_tpu.dynspec import serve_psrflux_survey as jserve_ps
        from scintools_tpu_torch.dynspec import serve_psrflux_survey

        n = _write_epochs(tmp_path / "spool")
        kw = dict(n_iter=25, poll_s=0.02, heartbeat=False)
        got = _serve_results(serve_psrflux_survey(
            tmp_path / "spool", tmp_path / "torch", device="cpu", **kw),
            n + 1)
        ref = _serve_results(jserve_ps(tmp_path / "spool",
                                       tmp_path / "jax", **kw), n + 1)
        assert got["bad.dynspec"]["status"] == "quarantined"
        assert got["bad.dynspec"]["error_class"] == "MalformedInputError"
        for i in range(n):
            g, r = got[f"e{i}.dynspec"], ref[f"e{i}.dynspec"]
            assert g["status"] == r["status"] == "ok"
            for k in ("tau", "dnu", "amp"):
                np.testing.assert_allclose(g["result"][k], r["result"][k],
                                           rtol=1e-4)
        with open(tmp_path / "torch" / "run_report.json") as fh:
            final = tobs.validate_run_report(json.load(fh))
        assert final["n_ok"] == n and final["n_quarantined"] == 1

    def test_batched_lanes_match_b1(self, tmp_path):
        from scintools_tpu_torch.dynspec import serve_psrflux_survey

        n = _write_epochs(tmp_path / "spool", n=6)
        kw = dict(n_iter=25, poll_s=0.02, heartbeat=False, http=False,
                  device="cpu")
        single = _serve_results(serve_psrflux_survey(
            tmp_path / "spool", tmp_path / "b1", **kw), n + 1)
        ctrl = tlanes.AdaptiveBatchController(max_batch=8)
        ctrl.observe(8)
        svc = serve_psrflux_survey(tmp_path / "spool", tmp_path / "b8",
                                   max_batch=8, controller=ctrl,
                                   prefetch=16, start=False, **kw)
        svc.start()
        batched = _serve_results(svc, n + 1)
        counters = tobs.REGISTRY.snapshot()["counters"]
        assert counters.get("serve_batches_total", 0) >= 1
        assert batched["bad.dynspec"]["status"] == "quarantined"
        for i in range(n):
            b, s = batched[f"e{i}.dynspec"], single[f"e{i}.dynspec"]
            for k in ("tau", "dnu", "amp"):
                np.testing.assert_allclose(b["result"][k], s["result"][k],
                                           rtol=1e-4)

    def test_no_card_raises(self, tmp_path):
        from scintools_tpu_torch.dynspec import (serve_fits_survey,
                                                 serve_psrflux_survey)

        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError):
            serve_psrflux_survey(tmp_path / "s", tmp_path / "w")
        with pytest.raises(RuntimeError):
            serve_fits_survey(tmp_path / "s", tmp_path / "w", 10.0, 1.0)

    def test_fits_entry(self, tmp_path):
        from scintools_tpu_torch.dynspec import serve_fits_survey
        from scintools_tpu_torch.io.fitsio import write_fits_image

        spool = tmp_path / "spool"
        spool.mkdir()
        rng = np.random.default_rng(3)
        for i in range(2):
            tmp = tmp_path / f"e{i}.tmp"
            write_fits_image(tmp, rng.normal(10, 1, (32, 16)))
            os.replace(tmp, spool / f"e{i}.fits")
        (spool / "bad.fits").write_bytes(b"SIMPLE  =")
        got = _serve_results(serve_fits_survey(
            spool, tmp_path / "run", 10.0, 1.0, n_iter=25, poll_s=0.02,
            heartbeat=False, http=False, device="cpu"), 3)
        assert got["bad.fits"]["status"] == "quarantined"
        assert all(np.isfinite(got[f"e{i}.fits"]["result"]["tau"])
                   for i in range(2))


# ---- SIGKILL and restart ----------------------------------------------------

_KILL_SCRIPT = r"""
import json, os, sys, time
import numpy as np

sys.path.insert(0, {repo!r})
from scintools_tpu_torch.serve import SpoolWatcher, SurveyService

spool, workdir, kill_after, n_total = (
    sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
count = {{"n": 0}}


def load_fn(path):
    with open(path) as fh:
        return int(fh.read().strip())


def process(payload, tier=None):
    if kill_after >= 0 and count["n"] == kill_after:
        os.kill(os.getpid(), 9)
    count["n"] += 1
    rng = np.random.default_rng(int(payload))
    return {{"v": float(rng.normal()), "s": float(np.sin(int(payload)))}}


src = SpoolWatcher(spool, pattern="*.epoch", poll_s=0.02)
svc = SurveyService(src, process, workdir, load_fn=load_fn, http=False,
                    heartbeat=False, inflight=2)
svc.start()
deadline = time.time() + 90
while time.time() < deadline:
    c = svc.state_snapshot()["counts"]
    if c.get("ok", 0) + c.get("resumed", 0) >= n_total:
        break
    time.sleep(0.02)
svc.stop()
print("COUNTS", json.dumps(svc.state_snapshot()["counts"], sort_keys=True))
"""


class TestKillAndResumeService:
    N = 10

    def _spool(self, path):
        path.mkdir()
        for i in range(self.N):
            (path / f"e{i:02d}.epoch").write_text(str(i * 3 + 1))

    def _run(self, script, spool, workdir, kill_after):
        return subprocess.run(
            [sys.executable, str(script), str(spool), str(workdir),
             str(kill_after), str(self.N)],
            capture_output=True, text=True, timeout=120, cwd=REPO)

    def test_sigkill_restart_publishes_nothing_twice(self, tmp_path):
        script = tmp_path / "daemon_script.py"
        script.write_text(_KILL_SCRIPT.format(repo=REPO))
        self._spool(tmp_path / "spool_k")
        self._spool(tmp_path / "spool_c")
        r = self._run(script, tmp_path / "spool_k", tmp_path / "killed", 4)
        assert r.returncode == -signal.SIGKILL
        n_done = len(EpochJournal(
            tmp_path / "killed" / "results.jsonl").valid_lines())
        assert 0 < n_done < self.N
        r = self._run(script, tmp_path / "spool_k", tmp_path / "killed", -1)
        assert r.returncode == 0, r.stderr[-2000:]
        counts = json.loads(r.stdout.split("COUNTS", 1)[1])
        assert counts.get("resumed", 0) >= n_done
        assert counts.get("resumed", 0) + counts.get("ok", 0) == self.N
        r = self._run(script, tmp_path / "spool_c", tmp_path / "clean", -1)
        assert r.returncode == 0, r.stderr[-2000:]
        resumed = EpochJournal(
            tmp_path / "killed" / "results.jsonl").valid_lines()
        clean = EpochJournal(
            tmp_path / "clean" / "results.jsonl").valid_lines()
        assert resumed == clean
        keys = [json.loads(ln)["epoch"] for ln in resumed]
        assert len(keys) == len(set(keys)) == self.N
