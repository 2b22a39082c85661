"""The port's fleet against the JAX package's: the claim race has one
winner; leases expire, are stolen, renewed and tolerate skew; the merge
writes the JAX merge's bytes for the same worker journals; the chaos
engine draws the JAX engine's faults for the same schedule; the
autoscaler decides as the JAX one does; the fs seam retries and parks;
thread- and process-mode pods (one worker SIGKILLed) merge to the
single-process journal with no JAX module in a worker; the scenario
and posterior fleets merge to the port's own surveys' journals; and a
kernel error in a worker ends the run with no recovery spawn.
Everything runs on the CPU."""

import errno
import json
import os
import random
import signal
import threading
import time

import pytest
import torch

from scintools_tpu import fleet as jfleet
from scintools_tpu.obs.report import validate_run_report as jvalidate
from scintools_tpu_torch import fleet as tfleet
from scintools_tpu_torch import obs as tobs
from scintools_tpu_torch.backend import KernelError
from scintools_tpu_torch.fleet import (FsOpDegradedError, FsOps, Pod,
                                       RetryPolicy, WorkQueue,
                                       claim_by_rename, demo_workload,
                                       run_pod, run_worker)
from scintools_tpu_torch.parallel.checkpoint import EpochJournal
from scintools_tpu_torch.robust import run_survey_batched
from scintools_tpu_torch.utils import slog as tslog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = "scintools_tpu_torch.fleet.worker:demo_workload"


@pytest.fixture(autouse=True)
def _isolate_port_observability():
    tobs.REGISTRY.reset()
    tslog.reset()
    yield
    tobs.REGISTRY.reset()
    tslog.reset()


def _spec(**params):
    return {"target": DEMO, "params": {"device": "cpu", **params}}


def _oracle_journal(tmp_path, name="oracle", **params):
    """The single-process runner's journal of the same demo workload."""
    wl = demo_workload(**params)
    run_survey_batched(wl["epochs"], wl["process_batch"], tmp_path / name,
                       process=wl["process"], batch_size=5, report=False,
                       device="cpu")
    return EpochJournal(tmp_path / name / "journal.jsonl").valid_lines()


# ---- the queue ------------------------------------------------------------

class TestQueue:
    def test_claim_race_exactly_one_winner(self, tmp_path):
        src = tmp_path / "tasks" / "t0.json"
        src.parent.mkdir()
        src.write_text("{}")
        wins = []
        barrier = threading.Barrier(8)

        def racer(i):
            barrier.wait()
            won = claim_by_rename(src, tmp_path / f"claims{i}")
            if won is not None:
                wins.append(won)

        threads = [threading.Thread(target=racer, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert len(wins) == 1 and os.path.exists(wins[0])
        assert not src.exists()

    def test_seed_claim_complete_drain(self, tmp_path):
        q = WorkQueue(tmp_path / "q", worker="w0")
        tasks = [(f"t{i}", [(f"e{i}", {"seed": i})]) for i in range(3)]
        assert q.seed(tasks) == 3 and q.seed(tasks) == 0
        while (task := q.claim()) is not None:
            assert q.complete(task)
        assert q.drained() and q.done_ids() == {"t0", "t1", "t2"}
        assert q.seed(tasks) == 0

    def test_expiry_steal_skew_and_renew(self, tmp_path):
        holder = WorkQueue(tmp_path / "q", worker="dead", lease_s=0.5,
                           skew_s=0.0)
        patient = WorkQueue(tmp_path / "q", worker="p", skew_s=30.0)
        thief = WorkQueue(tmp_path / "q", worker="thief", skew_s=0.0)
        holder.seed([("t0", [("e0", 0)])])
        task = holder.claim()
        assert task is not None and thief.claim() is None
        time.sleep(0.6)
        assert patient.claim() is None           # within its skew
        stolen = thief.claim()
        assert stolen.stolen and stolen.stolen_from == "dead"
        assert not holder.renew(task)            # the loss is seen
        assert not holder.complete(task)
        assert thief.read_lease("t0")["worker"] == "thief"
        assert thief.complete(stolen) and thief.drained()
        assert tslog.recent(event="fleet.steal")

    def test_heartbeat_keeps_lease(self, tmp_path):
        holder = WorkQueue(tmp_path / "q", worker="h", lease_s=0.6,
                           skew_s=0.0)
        thief = WorkQueue(tmp_path / "q", worker="t", skew_s=0.0)
        holder.seed([("t0", [("e0", 0)])])
        task = holder.claim()
        for _ in range(4):
            time.sleep(0.3)
            assert holder.renew(task) and thief.claim() is None
        assert holder.complete(task)

    def test_release_own_hands_back_to_fresh_path(self, tmp_path):
        q = WorkQueue(tmp_path / "q", worker="leaver", lease_s=30.0)
        q.seed([(f"t{i}", [(f"e{i}", i)]) for i in range(3)])
        assert q.claim() and q.claim()
        assert q.release_own() == 2
        other = WorkQueue(tmp_path / "q", worker="other", lease_s=30.0)
        got = [other.claim() for _ in range(3)]
        assert all(t is not None and not t.stolen for t in got)


# ---- the merge -------------------------------------------------------------

def _worker_journals(root):
    """Worker journals with a same-payload duplicate, a conflicting one,
    an unstamped record and a torn tail."""
    rows = {"a": [("e2", dict(status="ok", result={"v": 2.5}, worker="a",
                              t_commit=10.0)),
                  ("e0", dict(status="ok", result={"v": 1}, worker="a",
                              t_commit=11.0)),
                  ("e1", dict(status="quarantined", tier="", retries=1,
                              error="x", error_class="ValueError",
                              worker="a", t_commit=12.0))],
            "b": [("e0", dict(status="ok", result={"v": 1}, worker="b",
                              t_commit=20.0)),
                  ("e1", dict(status="ok", result={"v": 99}, worker="b",
                              t_commit=5.0)),
                  ("e9", dict(status="ok", result={"v": -1e-12}))]}
    paths = []
    for w, recs in rows.items():
        j = EpochJournal(root / f"{w}.jsonl")
        for epoch, fields in recs:
            j.append(epoch, **fields)
        paths.append(str(j.path))
    with open(paths[1], "a") as fh:
        fh.write('{"epoch": "e7", "status": "ok", "cr')
    return paths


class TestMerge:
    @pytest.mark.parametrize("chunk", [1, 100_000])
    def test_merge_bytes_equal_jax(self, tmp_path, chunk):
        paths = _worker_journals(tmp_path)
        order = ["e0", "e1", "e2"]
        with pytest.warns(UserWarning):
            st = tfleet.merge_journals(paths, tmp_path / "t.jsonl",
                                       order=order, chunk_records=chunk)
        with pytest.warns(UserWarning):
            sj = jfleet.merge_journals(paths, tmp_path / "j.jsonl",
                                       order=order, chunk_records=chunk)
        assert st == sj
        assert st["duplicates"] == 2 and st["conflicts"] == 1
        assert (tmp_path / "t.jsonl").read_bytes() \
            == (tmp_path / "j.jsonl").read_bytes()
        with pytest.warns(UserWarning):
            lines, stats = tfleet.merge_records(paths, order=order)
        assert lines == EpochJournal(tmp_path / "t.jsonl").valid_lines()
        assert {k: stats[k] for k in ("epochs", "duplicates",
                                      "conflicts")} \
            == {k: st[k] for k in ("epochs", "duplicates", "conflicts")}

    def test_strip_restores_single_process_bytes(self, tmp_path):
        wl = demo_workload(n_epochs=7, fail_every=3)
        run_survey_batched(
            wl["epochs"], wl["process_batch"], tmp_path / "w",
            process=wl["process"], batch_size=3, report=False,
            journal_extra=lambda: {"worker": "wX",
                                   "t_commit": round(time.time(), 3)},
            device="cpu")
        lines, _ = tfleet.merge_records(
            [str(tmp_path / "w" / "journal.jsonl")],
            order=[e for e, _ in wl["epochs"]])
        assert lines == _oracle_journal(tmp_path, n_epochs=7, fail_every=3)


# ---- chaos, the fs seam, the autoscaler -------------------------------------

def _chaos_stream(fleet, sched, worker, tmp_path, n=80):
    eng = fleet.ChaosEngine(sched, worker)
    root = tmp_path / fleet.__name__
    root.mkdir(exist_ok=True)
    out = []
    for i in range(n):
        path = root / f"{worker}-{i}"
        try:
            eng.before("write" if i % 3 == 0 else "read", path,
                       data=b"0123456789")
            out.append(None)
        except OSError as e:
            out.append((e.errno, e.strerror, os.path.basename(e.filename),
                        path.exists() and path.read_bytes()))
    return out, eng.faults, eng.n_faults


class TestChaosSeamAutoscaler:
    @pytest.mark.parametrize("worker", ["w0", "w1"])
    def test_chaos_draws_equal_jax(self, tmp_path, worker):
        spec = dict(seed=7, rates={"eio": 0.2, "estale": 0.1,
                                   "torn_write": 0.1, "delay": 0.05,
                                   "hang": 0.02},
                    delay_s=0.0, hang_s=0.0, torn_frac=0.3,
                    clock_offsets={"w1": -2.5}, fail_after_ops={"w1": 60},
                    max_faults=12)
        t = _chaos_stream(tfleet, tfleet.ChaosSchedule(**spec), worker,
                          tmp_path)
        j = _chaos_stream(jfleet, jfleet.ChaosSchedule(**spec), worker,
                          tmp_path)
        assert t == j and any(x is not None for x in t[0])
        assert tfleet.ChaosSchedule(**spec).to_spec() \
            == jfleet.ChaosSchedule(**spec).to_spec()
        assert tfleet.ChaosEngine(spec, worker).clock_offset() \
            == jfleet.ChaosEngine(spec, worker).clock_offset()
        with pytest.raises(ValueError):
            tfleet.ChaosSchedule(rates={"eoi": 0.1})

    def test_autoscaler_decisions_equal(self):
        rng = random.Random(3)
        kw = dict(min_workers=1, max_workers=6, tasks_per_worker=1.5,
                  cooldown_polls=2)
        at, aj = tfleet.Autoscaler(**kw), jfleet.Autoscaler(**kw)
        for _ in range(100):
            counts = {"pending": rng.randint(0, 12),
                      "claimed": rng.randint(0, 4)}
            assert at.raw_target(counts) == aj.raw_target(counts)
            assert at.target(counts) == aj.target(counts)
        assert isinstance(tfleet.as_autoscaler({"max_workers": 2}),
                          tfleet.Autoscaler)
        with pytest.raises(TypeError):
            tfleet.as_autoscaler(7)

    def test_fsops_retry_then_degraded(self, tmp_path):
        fast = dict(base_s=0.001, max_s=0.002)
        fs = FsOps(policy=RetryPolicy(retries=4, **fast))
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise OSError(errno.EIO, "flaky")
            return "ok"

        assert fs._call("read", "/x", flaky) == "ok" and fs.retries == 2
        dead = FsOps(policy=RetryPolicy(retries=2, **fast), worker="wX")

        def broken():
            raise OSError(errno.EIO, "dead disk")

        with pytest.raises(FsOpDegradedError) as ei:
            dead._call("write", "/q/lease.json", broken)
        assert not isinstance(ei.value, OSError)
        assert dead.degraded and ei.value.attempts == 3
        with pytest.raises(FileNotFoundError):
            fs.read_bytes(tmp_path / "missing")
        sched = tfleet.ChaosSchedule(seed=0, rates={"torn_write": 1.0},
                                     torn_frac=0.3, max_faults=2)
        fs = FsOps(policy=RetryPolicy(retries=4, **fast),
                   chaos=tfleet.ChaosEngine(sched, "w0"))
        fs.write_json(tmp_path / "lease.json", {"worker": "w0"})
        assert json.loads((tmp_path / "lease.json").read_text()) \
            == {"worker": "w0"}
        assert fs.retries == 2

    def test_dead_disk_worker_parks_pod_finishes(self, tmp_path):
        pod = Pod(tmp_path / "pod", _spec(n_epochs=12, slow_s=0.02),
                  n_workers=2, batch_size=2, mode="thread", lease_s=1.0,
                  skew_s=0.2, poll_s=0.05, monitor_s=0.05,
                  chaos={"seed": 5, "fail_after_ops": {"w1": 40}}).start()
        out = pod.wait(timeout=120.0)
        assert out["summary"]["n_ok"] == 12
        assert out["fleet"]["degraded"] >= 1
        assert "w1" not in out["fleet"]["dead_workers"]
        assert EpochJournal(out["journal"]).valid_lines() \
            == _oracle_journal(tmp_path, n_epochs=12)
        assert tslog.recent(event="fleet.worker_degraded")


# ---- pods -----------------------------------------------------------------

class TestPod:
    def test_thread_mode_report_and_merge(self, tmp_path):
        out = run_pod(tmp_path / "pod", _spec(n_epochs=23, fail_every=7),
                      n_workers=3, batch_size=5, mode="thread",
                      lease_s=5.0, timeout=120.0)
        s = out["summary"]
        assert s["n_epochs"] == 23 and s["n_quarantined"] == 3
        rep = jvalidate(tobs.validate_run_report(out["report"]))
        assert rep["runner"] == "run_pod"
        assert rep["fleet"]["merge"]["epochs"] == 23
        assert EpochJournal(out["journal"]).valid_lines() \
            == _oracle_journal(tmp_path, n_epochs=23, fail_every=7)
        with open(tmp_path / "pod" / "run_report.json") as fh:
            tobs.validate_run_report(json.load(fh))

    def test_worker_drains_queue(self, tmp_path):
        q = WorkQueue(tmp_path / "q", worker="seeder")
        wl = demo_workload(n_epochs=12)
        q.seed([(f"t{i}", wl["epochs"][i * 3:(i + 1) * 3])
                for i in range(4)])
        stats = run_worker(tmp_path / "q", tmp_path / "out",
                           _spec(n_epochs=12), worker_id="w0", lease_s=5.0)
        assert stats["tasks"] == 4 and stats["epochs"] == 12 and q.drained()
        recs = EpochJournal(tmp_path / "out" / "workers" / "w0"
                            / "journal.jsonl").iter_records()
        assert len(recs) == 12 and all(r["worker"] == "w0" for r in recs)

    def test_worker_without_card_raises(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(KernelError):
            run_worker(tmp_path / "q", tmp_path / "out",
                       {"target": DEMO, "params": {"n_epochs": 2}})

    @staticmethod
    def _broken_kernel_module(root):
        root.mkdir()
        (root / "broken_kernel.py").write_text(
            "from scintools_tpu_torch.backend import KernelError\n"
            "from scintools_tpu_torch.fleet.worker import demo_workload\n"
            "def workload(**kw):\n"
            "    wl = demo_workload(**kw)\n"
            "    def process_batch(payloads, tier=None):\n"
            "        raise KernelError('arc_profile launch failed')\n"
            "    wl['process_batch'] = process_batch\n"
            "    return wl\n")
        return {"target": "broken_kernel:workload",
                "params": {"n_epochs": 8, "device": "cpu"}}

    def test_kernel_error_ends_run_without_recovery(self, tmp_path,
                                                    monkeypatch):
        """Thread mode: the workers' KernelError ends the pod's run at
        once — no recovery worker, no steal."""
        spec = self._broken_kernel_module(tmp_path / "probe")
        monkeypatch.syspath_prepend(str(tmp_path / "probe"))
        pod = Pod(tmp_path / "pod", spec, n_workers=2, batch_size=4,
                  mode="thread", lease_s=30.0, poll_s=0.05,
                  monitor_s=0.05).start()
        with pytest.raises(KernelError, match="arc_profile"):
            pod.wait(timeout=120.0)
        assert pod._recoveries == 0
        assert not tslog.recent(event="fleet.steal")
        assert not tslog.recent(event="fleet.recovery_spawn")

    def test_dead_process_worker_of_kernel_error_ends_run(self, tmp_path,
                                                          monkeypatch):
        """Process mode, both halves without a subprocess: a worker whose
        task dies of a KernelError writes a final ``kernel_error``
        heartbeat and re-raises; the pod that finds such a worker dead
        raises KernelError instead of spawning a recovery worker."""
        spec = self._broken_kernel_module(tmp_path / "probe")
        monkeypatch.syspath_prepend(str(tmp_path / "probe"))
        pod = Pod(tmp_path / "pod", spec, n_workers=1, batch_size=4,
                  lease_s=30.0)
        pod._queue.seed(pod.tasks())
        with pytest.raises(KernelError):
            run_worker(pod.queue_root, pod.out_root, spec, worker_id="w0",
                       lease_s=30.0)
        beat = pod.heartbeats()["w0"]
        assert beat["phase"] == "kernel_error"
        assert beat["error_class"] == "KernelError"

        class DeadWorker:                 # a process that exited 1
            worker_id, pid, error = "w0", None, None

            def alive(self):
                return False

            def returncode(self):
                return 1

            def kill(self):
                pass

            close = kill

        pod.workers.append(DeadWorker())
        with pytest.raises(KernelError, match="w0 died of KernelError"):
            pod.poll()
        assert pod._recoveries == 0 and len(pod.workers) == 1

    def test_process_mode_sigkill_steal_no_jax(self, tmp_path,
                                               monkeypatch):
        """Real worker subprocesses, one SIGKILLed holding a claim: its
        task is stolen, every epoch completes once, the merged journal
        equals the single-process one, and no worker imported JAX or
        the JAX package."""
        probe = tmp_path / "probe"
        probe.mkdir()
        (probe / "module_probe.py").write_text(
            "import json, os, sys\n"
            "from scintools_tpu_torch.fleet.worker import demo_workload\n"
            "def workload(out, **kw):\n"
            "    bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'scintools_tpu.')) "
            "or m == 'scintools_tpu')\n"
            "    with open(os.path.join(out, f'{os.getpid()}.json'), "
            "'w') as fh:\n"
            "        json.dump(bad, fh)\n"
            "    return demo_workload(**kw)\n")
        seen = tmp_path / "seen"
        seen.mkdir()
        env = {"PYTHONPATH": os.pathsep.join([REPO, str(probe)])}
        monkeypatch.syspath_prepend(str(probe))
        pod = Pod(tmp_path / "pod",
                  {"target": "module_probe:workload",
                   "params": {"out": str(seen), "n_epochs": 30,
                              "slow_s": 0.12, "device": "cpu"}},
                  n_workers=3, batch_size=5, lease_s=2.0, skew_s=0.5,
                  poll_s=0.1, monitor_s=0.1, worker_env=env).start()
        victim = pod.workers[0]
        claims = os.path.join(pod.queue_root, "claims", victim.worker_id)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if os.path.isdir(claims) and any(
                    f.endswith(".json") for f in os.listdir(claims)):
                break
            time.sleep(0.02)
        else:
            pytest.fail("the victim never claimed a task")
        os.kill(victim.pid, signal.SIGKILL)
        held = any(f.endswith(".json") for f in os.listdir(claims))
        out = pod.wait(timeout=120.0)
        assert out["summary"]["n_ok"] == 30
        assert victim.worker_id in out["fleet"]["dead_workers"]
        if held:
            assert out["fleet"]["steals"] >= 1
        assert out["fleet"]["merge"]["conflicts"] == 0
        assert EpochJournal(out["journal"]).valid_lines() \
            == _oracle_journal(tmp_path, n_epochs=30)
        workers = {w.pid for w in pod.workers}
        found = {int(f[:-5]): json.load(open(seen / f))
                 for f in os.listdir(seen)}
        assert workers <= set(found)
        assert all(found[pid] == [] for pid in workers)


# ---- the two fleets ---------------------------------------------------------

class TestSurveyFleets:
    KW = dict(epochs_per_regime=8, seed=2, numsteps=800, n_iter=30,
              device="cpu")

    def test_scenario_fleet_matches_survey(self, tmp_path):
        from scintools_tpu.sim.scenario import DEFAULT_REGIMES as JREG
        from scintools_tpu_torch.sim.scenario import (run_scenario_fleet,
                                                      run_scenario_survey)

        out = run_scenario_fleet(
            tmp_path / "fleet", n_workers=2, batch_size=6, timeout=300.0,
            pod_options={"mode": "thread", "lease_s": 30.0}, plane_port=0,
            **self.KW)
        s = out["summary"]
        assert s["n_epochs"] == 24 and s["n_ok"] + s["n_quarantined"] == 24
        assert set(out["recovery"]) == {r["name"] for r in JREG}
        jvalidate(out["report"])
        with open(tmp_path / "fleet" / "plane.json") as fh:
            assert json.load(fh)["port"] > 0
        run_scenario_survey(tmp_path / "ref", batch_size=6, report=False,
                            **self.KW)
        assert EpochJournal(out["journal"]).valid_lines() == EpochJournal(
            tmp_path / "ref" / "journal.jsonl").valid_lines()

    def test_mcmc_fleet_matches_survey(self, tmp_path):
        from scintools_tpu_torch.mcmc.survey import (run_mcmc_fleet,
                                                     run_mcmc_survey)

        kw = dict(epochs_per_regime=2, nwalkers=16, steps=60,
                  device="cpu")
        out = run_mcmc_fleet(tmp_path / "fleet", n_workers=2, batch_size=3,
                             timeout=300.0,
                             pod_options={"mode": "thread",
                                          "lease_s": 30.0}, **kw)
        ref = run_mcmc_survey(tmp_path / "ref", batch_size=3, report=False,
                              **kw)
        assert out["summary"]["n_ok"] == ref["summary"]["n_ok"] == 6
        assert out["coverage"] == ref["coverage"]
        assert EpochJournal(out["journal"]).valid_lines() == EpochJournal(
            tmp_path / "ref" / "journal.jsonl").valid_lines()
