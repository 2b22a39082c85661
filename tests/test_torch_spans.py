"""The program's spans (``obs.trace.span``) on the curvature path, on the
CPU: nothing is recorded without a profiler; under ``torch.profiler`` a
façade run leaves the span tree of ``dynspec.*``, ``sspec.*`` and
``thth.*`` with one observation id per ``Dynspec``, opens no
``record_function`` of its own, and stamps its spans on the profiler's
clock; a cache miss of the fused search leaves one ``build`` record;
``StageTimeline`` shares the clock; ``utils.profiling.trace`` writes
the spans as a track of its Chrome trace."""

import json
import statistics
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from scintools_tpu_torch import BasicDyn, Dynspec
from scintools_tpu_torch.obs import trace as ot
from scintools_tpu_torch.thth import search as tsearch
from scintools_tpu_torch.utils import profiling

CPU = "cpu"
NF = NT = 64
PREP = dict(cwf=32, cwt=32, npad=1, eta_min=1e-4, eta_max=1e-2, neta=20,
            nedge=16)
ROW = ["thth.row.upload", "thth.row.search", "thth.row.fetch",
       "thth.row.results"]
STAGES = ["thth.cs", "thth.gather", "thth.eig", "thth.peak"]
PROGRAM_NAMES = {"dynspec.init", "dynspec.calc_sspec", "sspec.transform",
                 "sspec.fetch", "dynspec.prep_thetatheta",
                 "dynspec.fit_thetatheta", "thth.row.chunk", "thth.row",
                 "thth.global_fit", "build", *ROW, *STAGES}


def observe(proc="standard", seed=0):
    rng = np.random.default_rng(seed)
    bd = BasicDyn(rng.random((NF, NT)) + 1.0,
                  freqs=1400.0 + 0.05 * np.arange(NF),
                  times=2.0 * np.arange(NT))
    ds = Dynspec(dyn=bd, process=False, verbose=False, device=CPU)
    ds.calc_sspec()
    ds.prep_thetatheta(fitting_proc=proc, **PREP)
    ds.fit_thetatheta()
    return ds


@pytest.fixture(scope="module", autouse=True)
def warm():
    """Build the fused searches of both procs once, so a checked run
    hits every cache."""
    observe("standard")
    observe("thin")


def traced(fn):
    """``(result, records, profiler)`` of ``fn()`` under the profiler."""
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, ot.program_spans(t0, time.time_ns()), prof


def children(recs, parent):
    return [r for r in sorted(recs, key=lambda r: r.start_ns)
            if r.parent == parent.span_id]


def test_nothing_is_recorded_without_a_profiler(monkeypatch):
    stamps = []

    def counting():
        stamps.append(1)
        return time.time_ns()

    monkeypatch.setattr(ot, "_now", counting)
    before = list(ot.RING)
    assert not torch.autograd.profiler._is_profiler_enabled
    observe("standard")
    observe("thin")
    assert stamps == []
    assert list(ot.RING) == before


@pytest.mark.parametrize("proc", ["standard", "thin"])
def test_a_traced_run_records_the_span_tree(proc):
    (a, b), recs, _ = traced(lambda: (observe(proc, 1), observe(proc, 2)))
    assert a.observation_id != b.observation_id
    for ds in (a, b):
        mine = [r for r in recs if r.observation == ds.observation_id]
        roots = [r for r in sorted(mine, key=lambda r: r.start_ns)
                 if r.parent is None]
        assert [r.name for r in roots] == [
            "dynspec.init", "dynspec.calc_sspec", "dynspec.prep_thetatheta",
            "dynspec.fit_thetatheta"]
        assert [r.name for r in children(mine, roots[1])] == [
            "sspec.transform", "sspec.fetch"]
        assert children(mine, roots[0]) == children(mine, roots[2]) == []
        fit = children(mine, roots[3])
        assert [r.name for r in fit] == ["thth.row.chunk"] + [
            "thth.row"] * ds.ncf_fit + ["thth.global_fit"]
        # the chunk grid: cut and centred once a call, from one float64
        # upload of the tiled part of the spectrum
        assert fit[0].attrs == {
            "rows": ds.ncf_fit, "chunks": ds.ncf_fit * ds.nct_fit,
            "bytes": ds.ncf_fit * ds.cwf * ds.nct_fit * ds.cwt * 8}
        assert children(mine, fit[0]) == []
        for cf, row in enumerate(fit[1:-1]):
            assert row.attrs == {"cf": cf, "chunks": ds.nct_fit,
                                 "proc": proc, "grid": True}
            kids = children(mine, row)
            assert [r.name for r in kids] == ROW
            search = kids[1]
            assert [r.name for r in children(mine, search)] == STAGES
            for r in kids + children(mine, search):
                assert row.start_ns <= r.start_ns <= r.end_ns <= row.end_ns
        # every span nests in its parent and belongs to one observation
        by_id = {r.span_id: r for r in mine}
        for r in mine:
            if r.parent is not None:
                p = by_id[r.parent]
                assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
        assert {r.name for r in mine} <= PROGRAM_NAMES
    assert {r.observation for r in recs} == {a.observation_id,
                                            b.observation_id}
    assert all(r.device_ms is None for r in recs)      # no CUDA events


def test_a_traced_run_opens_no_record_function():
    _, recs, prof = traced(lambda: observe("standard", 3))
    assert {r.name for r in recs} >= {"thth.row", "thth.eig"}
    names = {e.name for e in prof.events()}
    assert not names & PROGRAM_NAMES


def test_spans_are_stamped_on_the_profilers_clock():
    n = 200

    def spans():
        for i in range(n):
            with record_function(f"probe{i}"):
                with ot.span("probe.inner", i=i):
                    torch.ones(8).sum()

    _, recs, prof = traced(spans)
    ours = {r.attrs["i"]: r for r in recs if r.name == "probe.inner"}
    theirs = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("probe") and e.name()[5:].isdigit():
            theirs[int(e.name()[5:])] = (e.start_ns(),
                                         e.start_ns() + e.duration_ns())
    assert len(ours) == len(theirs) == n
    lead = [ours[i].start_ns - theirs[i][0] for i in range(n)]
    trail = [theirs[i][1] - ours[i].end_ns for i in range(n)]
    inside = sum(a >= 0 and b >= 0 for a, b in zip(lead, trail))
    assert inside >= 0.95 * n
    assert 0 <= statistics.median(lead) < 50_000
    assert 0 <= statistics.median(trail) < 50_000


def test_a_fused_cache_miss_leaves_one_build_record():
    rng = np.random.default_rng(4)
    chunks = [rng.random((32, 32)) + 1.0 for _ in range(2)]
    freq = 1400.0 + 0.05 * np.arange(32)
    times = [2.0 * np.arange(32), 64.0 + 2.0 * np.arange(32)]
    edges = np.linspace(-1.0, 1.0, 16)
    etas = np.geomspace(1e-4, 1e-2, 20)

    def search():
        # an fw no other test takes: a key the cache has not seen
        return tsearch.multi_chunk_search(chunks, freq, times, etas, edges,
                                          fw=0.1234, npad=1, device=CPU)

    _, first, _ = traced(search)
    _, again, _ = traced(search)
    builds = [r for r in first if r.name == "build"]
    assert [r.attrs for r in builds] == [{"site": "thth.fused"}]
    assert builds[0].start_ns == builds[0].end_ns
    assert not [r for r in again if r.name == "build"]


def test_stage_timeline_spans_share_the_profilers_clock():
    tl = profiling.StageTimeline()

    def stage():
        with tl.span("e0", "load"):
            with record_function("probe.timeline"):
                time.sleep(0.002)

    _, _, prof = traced(stage)
    (_, _, t0, t1), = tl.spans()
    ev, = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "probe.timeline"]
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    slack = 50_000                      # ns
    assert t0 * 1e9 <= start + slack and end - slack <= t1 * 1e9
    assert (t1 - t0) * 1e9 < (end - start) + 10 * slack
    assert abs(profiling.clock() - time.time_ns() / 1e9) < 1.0


def test_profiling_trace_writes_the_program_track(tmp_path):
    with profiling.trace(tmp_path):
        with ot.span("probe.outer", observation=7):
            with record_function("probe.host"):
                time.sleep(0.002)
        observe("standard", 5)
    with open(tmp_path / "trace.json") as fh:
        doc = json.load(fh)
    events = doc["traceEvents"]
    ours = [e for e in events if e.get("cat") == "program"]
    assert {"probe.outer", "dynspec.fit_thetatheta", "thth.row",
            "thth.eig"} <= {e["name"] for e in ours}
    outer, = [e for e in ours if e["name"] == "probe.outer"]
    host, = [e for e in events if e.get("name") == "probe.host"
             and e.get("ph") == "X"]
    # the program's span encloses the profiler's range, on its time base
    assert outer["ts"] <= host["ts"] + 50
    assert host["ts"] + host["dur"] <= outer["ts"] + outer["dur"] + 50
    assert outer["tid"] == 7
    named = {(e["pid"], e["tid"]) for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert all((e["pid"], e["tid"]) in named for e in ours)
