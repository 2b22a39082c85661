"""The port's survey engine against the JAX package's: the same epochs
and one pure-numpy ``process`` / ``process_batch`` through both runners
give byte-identical journals and equal summaries; each package resumes
the other's journal; pipelined and sequential journals are
byte-identical; a SIGKILLed run resumes; and a ``KernelError`` is never
descended past or quarantined. Everything runs on the CPU."""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from scintools_tpu.robust import faults as jfaults
from scintools_tpu.robust import runner as jrunner
from scintools_tpu.io import MalformedInputError as JMalformed
from scintools_tpu.parallel.checkpoint import EpochJournal as JJournal
from scintools_tpu_torch import obs as tobs
from scintools_tpu_torch.backend import KernelError
from scintools_tpu_torch.io import MalformedInputError as TMalformed
from scintools_tpu_torch.parallel import checkpoint as tckpt
from scintools_tpu_torch.parallel.pipeline import (DeferredResult,
                                                   finalize_result)
from scintools_tpu_torch.robust import faults as tfaults
from scintools_tpu_torch.robust import ladder as tladder
from scintools_tpu_torch.robust import runner as trunner
from scintools_tpu_torch.robust import (TIER_FUSED, TIER_NUMPY,
                                        TIER_STAGED)
from scintools_tpu_torch.utils import slog as tslog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one package's runner, fault hook and malformed-input error
PKGS = {"jax": (jrunner, jfaults, JMalformed),
        "torch": (trunner, tfaults, TMalformed)}


@pytest.fixture(autouse=True)
def _isolate_port_observability():
    tobs.REGISTRY.reset()
    tslog.reset()
    yield
    tobs.REGISTRY.reset()
    tslog.reset()


def _value(i, tier):
    rng = np.random.default_rng(1000 + i)
    return {"v": float(rng.normal()), "s": float(np.sin(i * 1.7)),
            "tier_seen": tier, "n": int(i), "ok": 0}


def _epochs(malformed_cls, n=8, bad=3):
    """``n`` epochs with lazy loaders; epoch ``bad`` fails to load."""
    def loader(i):
        def load():
            if i == bad:
                raise malformed_cls(f"e{i}.dynspec", "truncated row")
            return i
        return load
    return [(f"e{i}", loader(i)) for i in range(n)]


def _process(payload, tier=None):
    return _value(int(payload), tier)


def _run(pkg, workdir, pipeline=True, **kw):
    runner, faults, malformed = PKGS[pkg]
    # tier 0 of epoch e5 fails twice (one retry, then descent); epoch e6
    # fails on every tier: quarantined with the full attempt trail
    fail_all = {"e6"}

    def hook(tier=None, epoch=None, stage=None):
        if epoch in fail_all or (epoch == "e5" and tier == TIER_FUSED):
            raise RuntimeError("XLA compile failed (injected fault)")

    prev = faults.TIER_FAIL_HOOK
    faults.TIER_FAIL_HOOK = hook
    try:
        return runner.run_survey(_epochs(malformed), _process,
                                 os.fspath(workdir), pipeline=pipeline,
                                 **kw, **_on_cpu(pkg))
    finally:
        faults.TIER_FAIL_HOOK = prev


def _on_cpu(pkg):
    """The port's runners take ``device=`` (``None``: the card)."""
    return {"device": "cpu"} if pkg == "torch" else {}


def _batch_epochs(n=10):
    return [(f"b{i}", i) for i in range(n)]


def _process_batch(payloads, tier=None):
    out = []
    for p in payloads:
        r = _value(int(p), tier)
        r["ok"] = 8 if int(p) == 4 else 0      # lane 4: health rejected
        out.append(r)
    return out


def _run_batched(pkg, workdir, pipeline=True):
    runner = PKGS[pkg][0]
    return runner.run_survey_batched(
        _batch_epochs(), _process_batch, os.fspath(workdir),
        process=_process, batch_size=4, pipeline=pipeline, **_on_cpu(pkg))


def _journal_bytes(workdir):
    with open(os.path.join(workdir, "journal.jsonl"), "rb") as fh:
        return fh.read()


class TestRunnerParity:
    @pytest.mark.parametrize("pipeline", [True, False])
    def test_run_survey_journals_byte_identical(self, tmp_path, pipeline):
        outs = {p: _run(p, tmp_path / p, pipeline=pipeline)
                for p in PKGS}
        assert _journal_bytes(tmp_path / "jax") \
            == _journal_bytes(tmp_path / "torch")
        assert outs["jax"]["summary"] == outs["torch"]["summary"]
        s = outs["torch"]["summary"]
        assert s["n_epochs"] == 8 and s["n_quarantined"] == 2
        assert s["tier_counts"][TIER_STAGED] == 1
        recs = tckpt.EpochJournal(
            tmp_path / "torch" / "journal.jsonl").records()
        assert recs["e3"]["error_class"] == "MalformedInputError"
        assert recs["e5"]["tier"] == TIER_STAGED
        assert recs["e5"]["retries"] == 2
        assert recs["e6"]["status"] == "quarantined"

    @pytest.mark.parametrize("pipeline", [True, False])
    def test_run_survey_batched_journals_byte_identical(self, tmp_path,
                                                        pipeline):
        outs = {p: _run_batched(p, tmp_path / p, pipeline=pipeline)
                for p in PKGS}
        assert _journal_bytes(tmp_path / "jax") \
            == _journal_bytes(tmp_path / "torch")
        assert outs["jax"]["summary"] == outs["torch"]["summary"]
        s = outs["torch"]["summary"]
        assert s["n_ok"] == 10 and s["n_batches"] == 3
        assert s["tier_counts"][TIER_STAGED] == 1   # the rejected lane
        assert [o.epoch for o in outs["torch"]["outcomes"]] \
            == [e for e, _ in _batch_epochs()]

    @pytest.mark.parametrize("first,second", [("jax", "torch"),
                                              ("torch", "jax")])
    def test_each_package_resumes_the_others_journal(self, tmp_path,
                                                     first, second):
        wd = tmp_path / "run"
        _run(first, wd)
        before = _journal_bytes(wd)
        out = _run(second, wd)
        assert out["summary"]["n_resumed"] == 8
        assert out["summary"]["n_ok"] == 0
        assert _journal_bytes(wd) == before
        wd_b = tmp_path / "batched"
        _run_batched(first, wd_b)
        out = _run_batched(second, wd_b)
        assert out["summary"]["n_resumed"] == 10

    def test_pipelined_equals_sequential(self, tmp_path):
        _run("torch", tmp_path / "p", pipeline=True, inflight=3)
        _run("torch", tmp_path / "s", pipeline=False)
        assert _journal_bytes(tmp_path / "p") == _journal_bytes(tmp_path / "s")

    def test_format_line_matches_jax(self):
        rec = dict(status="ok", tier=TIER_FUSED, retries=0,
                   result={"eta": 0.1, "n": 3, "l": [1.5, None],
                           "s": "x"})
        assert tckpt.EpochJournal.format_line("e0", **rec) \
            == JJournal.format_line("e0", **rec)

    def test_report_written_and_valid_for_jax(self, tmp_path):
        from scintools_tpu.obs.report import validate_run_report

        _run("torch", tmp_path / "r")
        with open(tmp_path / "r" / "run_report.json") as fh:
            validate_run_report(json.load(fh))


class TestDeviceValues:
    def test_tensor_result_journals_as_number(self, tmp_path):
        def process(payload, tier=None):
            return {"eta": torch.tensor(0.25, dtype=torch.float64),
                    "v": torch.tensor([1.5, 2.5]),
                    "n": torch.tensor(3)}

        for pipeline in (True, False):
            wd = tmp_path / str(pipeline)
            trunner.run_survey([("e0", 0)], process, os.fspath(wd),
                               pipeline=pipeline, device="cpu")
            line = _journal_bytes(wd).decode()
            assert "tensor" not in line
            rec = json.loads(line)
            assert rec["result"] == {"eta": 0.25, "v": [1.5, 2.5], "n": 3}

    def test_finalize_result(self):
        out = finalize_result(DeferredResult(
            value={"a": torch.tensor(1.0), "b": (np.float32(2.0), "s")}))
        assert out == {"a": 1.0, "b": [2.0, "s"]}
        assert isinstance(out["a"], float)


class TestKernelError:
    @pytest.mark.parametrize("pipeline", [True, False])
    def test_run_survey_propagates(self, tmp_path, pipeline):
        def process(payload, tier=None):
            if tier == TIER_FUSED and payload == 2:
                raise KernelError("arc_profile launch failed (1)")
            return _value(payload, tier)

        with pytest.raises(KernelError):
            trunner.run_survey([(f"e{i}", i) for i in range(4)], process,
                               os.fspath(tmp_path), pipeline=pipeline,
                               device="cpu")
        recs = tckpt.EpochJournal(tmp_path / "journal.jsonl").records()
        assert all(r["tier"] != TIER_NUMPY for r in recs.values())
        assert "e2" not in recs

    @pytest.mark.parametrize("pipeline", [True, False])
    def test_run_survey_batched_propagates(self, tmp_path, pipeline):
        def process_batch(payloads, tier=None):
            raise KernelError("arc_profile launch failed (1)")

        with pytest.raises(KernelError):
            trunner.run_survey_batched(
                _batch_epochs(), process_batch, os.fspath(tmp_path),
                process=_process, batch_size=4, pipeline=pipeline,
                device="cpu")
        recs = tckpt.EpochJournal(tmp_path / "journal.jsonl").records()
        assert recs == {}

    def test_lane_descent_propagates(self, tmp_path):
        def process(payload, tier=None):
            raise KernelError("arc_profile launch failed (1)")

        with pytest.raises(KernelError):
            trunner.run_survey_batched(
                _batch_epochs(), _process_batch, os.fspath(tmp_path),
                process=process, batch_size=4, device="cpu")
        recs = tckpt.EpochJournal(tmp_path / "journal.jsonl").records()
        assert all(r["tier"] == TIER_FUSED for r in recs.values())

    def test_loader_kernel_error_is_not_quarantined(self, tmp_path):
        def load():
            raise KernelError("no card")

        with pytest.raises(KernelError):
            trunner.run_survey([("e0", load)], _process,
                               os.fspath(tmp_path), pipeline=False,
                               device="cpu")

    def test_ladder_never_descends_or_retries(self):
        calls = []

        def broken():
            calls.append(TIER_FUSED)
            raise KernelError("eig_warmstart launch failed (2)")

        def fallback():
            calls.append(TIER_NUMPY)
            return 1

        with pytest.raises(KernelError):
            tladder.run_ladder([(TIER_FUSED, broken),
                                (TIER_NUMPY, fallback)], retries=3)
        assert calls == [TIER_FUSED]
        assert not tladder.is_transient(KernelError("out of memory"))

    @pytest.mark.parametrize("pipeline", [True, False])
    @pytest.mark.parametrize("fault", [
        "accelerator", "runtime"])
    def test_device_fault_at_the_fence_propagates(self, tmp_path, pipeline,
                                                  fault):
        msg = "CUDA error: an illegal memory access was encountered"
        exc = (torch.AcceleratorError(msg) if fault == "accelerator"
               else RuntimeError(msg))
        seen = []

        def fence():
            raise exc

        def process(payload, tier=None):
            seen.append((payload, tier))
            if payload == 2:
                return DeferredResult(finalize_fn=fence)
            return _value(payload, tier)

        with pytest.raises(type(exc), match="CUDA error"):
            trunner.run_survey([(f"e{i}", i) for i in range(4)], process,
                               os.fspath(tmp_path), pipeline=pipeline,
                               inflight=3, device="cpu")
        assert (2, TIER_STAGED) not in seen and (2, TIER_NUMPY) not in seen
        recs = tckpt.EpochJournal(tmp_path / "journal.jsonl").records()
        assert "e2" not in recs
        assert all(r["tier"] == TIER_FUSED for r in recs.values())

    def test_device_fault_classification(self):
        from scintools_tpu_torch.backend import is_kernel_error

        assert is_kernel_error(KernelError("no card"))
        assert is_kernel_error(torch.AcceleratorError("CUDA error: x"))
        assert is_kernel_error(RuntimeError("CUDA error: misaligned"))
        assert not is_kernel_error(torch.OutOfMemoryError("CUDA out of "
                                                          "memory."))
        assert not is_kernel_error(RuntimeError("CUDA error: out of memory"))
        assert not is_kernel_error(ValueError("CUDA error: x"))
        assert not tladder.is_transient(RuntimeError("CUDA error: "
                                                     "unavailable"))

    def test_oom_stays_transient(self):
        assert tladder.is_transient(
            torch.OutOfMemoryError("CUDA out of memory. Tried to allocate"))
        assert tladder.is_transient(RuntimeError("CUDA out of memory"))

    def test_no_card_is_a_kernel_error(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        from scintools_tpu_torch.backend import resolve_device

        with pytest.raises(KernelError):
            resolve_device(None)

    def test_runners_refuse_before_the_first_epoch(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        for run in (lambda: trunner.run_survey(
                        [("e0", 0)], _process, os.fspath(tmp_path)),
                    lambda: trunner.run_survey_batched(
                        [("e0", 0)], _process_batch, os.fspath(tmp_path))):
            with pytest.raises(KernelError):
                run()
        assert not os.path.exists(tmp_path / "journal.jsonl")


_KILL_SCRIPT = r"""
import json, os, sys, time
import numpy as np

sys.path.insert(0, {repo!r})
from scintools_tpu_torch.robust import run_survey

workdir, kill_after = sys.argv[1], int(sys.argv[2])
count = {{"n": 0}}


def journaled():
    try:
        with open(os.path.join(workdir, "journal.jsonl")) as fh:
            return sum(1 for _ in fh)
    except OSError:
        return 0


def process(payload, tier=None):
    if kill_after >= 0 and count["n"] == kill_after:
        # the journal writer is a thread: let it commit the epochs
        # consumed so far, so the kill lands mid-run with a journal
        t_end = time.monotonic() + 30
        while journaled() == 0 and time.monotonic() < t_end:
            time.sleep(0.01)
        os.kill(os.getpid(), 9)          # real SIGKILL mid-epoch
    count["n"] += 1
    rng = np.random.default_rng(int(payload))
    return {{"v": float(rng.normal()),
             "s": float(np.sin(int(payload) * 1.7))}}


epochs = [(f"e{{i}}", i) for i in range(8)]
out = run_survey(epochs, process, workdir, device="cpu")
with open(os.path.join(workdir, "final.json"), "w") as fh:
    json.dump({{k: out["results"][k]
               for k in sorted(out["results"])}}, fh, sort_keys=True)
print("RESUMED", out["summary"]["n_resumed"])
"""


class TestKillAndResume:
    def _run(self, script, workdir, kill_after):
        return subprocess.run(
            [sys.executable, script, str(workdir), str(kill_after)],
            capture_output=True, text=True, timeout=240, cwd=REPO)

    def test_sigkill_resume_identical(self, tmp_path):
        script = tmp_path / "survey_script.py"
        script.write_text(_KILL_SCRIPT.format(repo=REPO))
        interrupted = tmp_path / "interrupted"
        uninterrupted = tmp_path / "uninterrupted"

        r = self._run(script, interrupted, kill_after=4)
        assert r.returncode == -signal.SIGKILL
        n_done = len(tckpt.EpochJournal(interrupted / "journal.jsonl"))
        assert 0 < n_done < 8

        r = self._run(script, interrupted, kill_after=-1)
        assert r.returncode == 0, r.stderr[-2000:]
        assert f"RESUMED {n_done}" in r.stdout

        r = self._run(script, uninterrupted, kill_after=-1)
        assert r.returncode == 0, r.stderr[-2000:]
        assert (interrupted / "final.json").read_text() \
            == (uninterrupted / "final.json").read_text()


class _Unpickled:
    """An object whose unpickling would be seen."""

    loaded = False

    def __init__(self):
        self.v = 1

    def __setstate__(self, state):
        type(self).loaded = True


class TestCheckpointer:
    def test_save_restore_keep_and_corrupt_fallback(self, tmp_path):
        state = tckpt.results_state(5)
        ck = tckpt.SurveyCheckpointer(tmp_path, every=2, keep=2)
        for step in range(6):
            state["params"][step % 5] = step
            state["done"][step % 5] = True
            ck.maybe_save(step, state)
        assert ck.all_steps() == [3, 5]
        got = ck.restore(template=tckpt.results_state(5))
        np.testing.assert_array_equal(got["params"], state["params"])
        assert got["done"].dtype == bool
        # a truncated newest step falls back to the previous one
        path = os.path.join(tmp_path, "5", "state.pt")
        with open(path, "r+b") as fh:
            fh.truncate(10)
        with pytest.warns(UserWarning):
            older = ck.restore()
        assert older["params"][3, 0] == 3 and older["params"][4, 0] == 0

    def test_restore_keeps_types_and_loads_no_objects(self, tmp_path):
        state = {"a": np.arange(6, dtype=np.int16).reshape(2, 3),
                 "m": np.array([True, False]), "s": np.float32(2.5),
                 "t": torch.arange(3.0), "n": [1, 2.5, "x"],
                 "z": (np.complex64(1 + 2j), None)}
        ck = tckpt.SurveyCheckpointer(tmp_path / "ok", every=1, keep=1)
        ck.save(0, state)
        got = ck.restore()
        assert got["a"].dtype == np.int16 and got["a"].shape == (2, 3)
        np.testing.assert_array_equal(got["a"], state["a"])
        np.testing.assert_array_equal(got["m"], state["m"])
        assert isinstance(got["s"], np.float32) and got["s"] == 2.5
        assert torch.equal(got["t"], state["t"])
        assert got["n"] == [1, 2.5, "x"]
        assert got["z"] == (np.complex64(1 + 2j), None)
        assert isinstance(got["z"][0], np.complex64)
        # a stamped step holding a pickled object is refused, not run
        bad = tckpt.SurveyCheckpointer(tmp_path / "bad", every=1, keep=1)
        bad.save(0, {"x": np.zeros(2)})
        with open(os.path.join(tmp_path, "bad", "0", "state.pt"),
                  "wb") as fh:
            torch.save({"x": _Unpickled()}, fh)
        bad._write_stamp(0)
        with pytest.raises(Exception, match="[Ww]eights only"):
            bad.restore(0)
        assert not _Unpickled.loaded

    def test_run_survey_with_checkpoints_resumes(self, tmp_path):
        def step(state, i):
            return {"x": state["x"] + i}

        out = tckpt.run_survey_with_checkpoints(
            step, {"x": 0}, 7, tmp_path, every=3)
        assert out == {"x": 21}
        again = tckpt.run_survey_with_checkpoints(
            step, {"x": 0}, 7, tmp_path, every=3)
        assert again == {"x": 21}
