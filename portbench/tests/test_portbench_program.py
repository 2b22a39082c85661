"""The readers of the program's own spans (``portbench/program.py``) on a
synthetic trace and a synthetic span ring: clipping to the window, an
idle gap split across two stages by overlap, self time under nested
children, division per observation, the idle readers and the
unattributed share adding up to the window's idle time, and None where
there is nothing to read."""

import collections

import pytest

from portbench import harness, program, spec
from portbench import trace as tr
from scintools_tpu_torch.obs import trace as ot

MS = 1_000_000           # ns


def rec(name, sid, parent, a, b, events=None, **attrs):
    return ot.SpanRecord(name, sid, parent, 1, a, b, attrs, events)


class FakeEvent:
    def __init__(self, t_ms):
        self.t_ms = t_ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t_ms - self.t_ms


@pytest.fixture
def ring(monkeypatch):
    """Install ``records`` as the program's span ring."""
    def install(records):
        monkeypatch.setattr(ot, "RING", collections.deque(records))
    return install


def ctx_of(device, window, calls=1):
    return harness.Context("c", {"calls": calls},
                           tr.Trace(device, [], window), {}, {})


def read(metric, ctx):
    return spec.reader(metric).read(ctx)


def test_spans_are_clipped_to_the_window(ring):
    # no device work: the window is one idle gap; the span starts
    # before the window and ends inside it
    ring([rec("thth.row.chunk", 1, None, -50 * MS, 50 * MS)])
    ctx = ctx_of([], (0, 100 * MS))
    assert read("thth.idle_chunk_ms", ctx) == pytest.approx(50.0)
    assert read("program.idle_unattributed_pct", ctx) == pytest.approx(50.0)


def test_one_gap_is_split_between_two_stages_by_overlap(ring):
    # device busy 0-10 and 90-100: the one gap 10-90 begins under the
    # chunking and ends under the launch
    ring([rec("thth.row", 1, None, 0, 100 * MS),
          rec("thth.row.chunk", 2, 1, 0, 40 * MS),
          rec("thth.row.search", 3, 1, 40 * MS, 100 * MS)])
    ctx = ctx_of([("k", 0, 10 * MS), ("k", 90 * MS, 100 * MS)],
                 (0, 100 * MS))
    assert read("thth.idle_chunk_ms", ctx) == pytest.approx(30.0)
    assert read("thth.idle_launch_ms", ctx) == pytest.approx(50.0)
    assert read("thth.idle_rest_ms", ctx) == pytest.approx(0.0)


def test_self_time_leaves_out_nested_children(ring):
    # fit 0-100 > row 10-90 > (chunk 20-30, search 30-80 > eig 40-70),
    # and the row's fetch 80-85; the device never runs
    ring([rec("dynspec.fit_thetatheta", 1, None, 0, 100 * MS),
          rec("thth.row", 2, 1, 10 * MS, 90 * MS),
          rec("thth.row.chunk", 3, 2, 20 * MS, 30 * MS),
          rec("thth.row.search", 4, 2, 30 * MS, 80 * MS),
          rec("thth.eig", 5, 4, 40 * MS, 70 * MS),
          rec("thth.row.fetch", 6, 2, 80 * MS, 85 * MS),
          rec("build", 7, 2, 25 * MS, 25 * MS, site="thth.fused")])
    ctx = ctx_of([], (0, 100 * MS))
    # the fit's own 0-10 and 90-100, the row's 10-20 and 85-90, and
    # the fetch's 80-85
    assert read("thth.idle_rest_ms", ctx) == pytest.approx(40.0)
    assert read("thth.idle_launch_ms", ctx) == pytest.approx(50.0)
    assert read("thth.row_wait_ms", ctx) == pytest.approx(5.0)
    assert read("thth.builds_per_obs", ctx) == pytest.approx(1.0)
    got = dict(program.self_intervals(ot.RING, 0, 100 * MS))
    by_name = {r.name: p for r, p in got.items()}
    assert by_name["thth.row.search"] == [(30 * MS, 40 * MS),
                                          (70 * MS, 80 * MS)]
    assert by_name["thth.row"] == [(10 * MS, 20 * MS), (85 * MS, 90 * MS)]


def test_readers_divide_by_the_observations(ring):
    g = FakeEvent
    ring([rec("thth.row.chunk", 1, None, 0, 40 * MS),
          rec("thth.row.fetch", 2, None, 40 * MS, 60 * MS),
          rec("thth.gather", 3, None, 60 * MS, 61 * MS,
              events=(g(0.0), g(8.0))),
          rec("thth.eig", 4, None, 61 * MS, 62 * MS,
              events=(g(8.0), g(20.0))),
          rec("build", 5, None, 70 * MS, 70 * MS, site="thth.fused")])
    one, two = (ctx_of([], (0, 100 * MS), calls) for calls in (1, 2))
    for metric, want in (("thth.idle_chunk_ms", 40.0),
                         ("thth.row_wait_ms", 20.0),
                         ("thth.gather_device_ms", 8.0),
                         ("thth.eig_device_ms", 12.0),
                         ("thth.builds_per_obs", 1.0)):
        assert read(metric, one) == pytest.approx(want), metric
        assert read(metric, two) == pytest.approx(want / 2), metric


def test_the_idle_readers_make_up_the_window_idle_time(ring):
    ring([rec("dynspec.calc_sspec", 1, None, 0, 20 * MS),
          rec("sspec.transform", 2, 1, 0, 5 * MS),
          rec("sspec.fetch", 3, 1, 12 * MS, 20 * MS),
          rec("dynspec.fit_thetatheta", 4, None, 25 * MS, 95 * MS),
          rec("thth.row", 5, 4, 30 * MS, 90 * MS),
          rec("thth.row.chunk", 6, 5, 30 * MS, 45 * MS),
          rec("thth.row.upload", 7, 5, 45 * MS, 47 * MS),
          rec("thth.row.search", 8, 5, 47 * MS, 60 * MS),
          rec("thth.cs", 9, 8, 48 * MS, 50 * MS),
          rec("thth.row.fetch", 10, 5, 60 * MS, 80 * MS),
          rec("thth.row.results", 11, 5, 80 * MS, 85 * MS),
          rec("thth.global_fit", 12, 4, 90 * MS, 94 * MS)])
    device = [("fft", 2 * MS, 10 * MS), ("eig", 50 * MS, 75 * MS)]
    ctx = ctx_of(device, (0, 100 * MS), calls=2)
    total_ms = sum(b - a for a, b in tr.idle_gaps(
        [(a, b) for _, a, b in device], 0, 100 * MS)) / MS
    stages = sum(read(m, ctx) for m in (
        "thth.idle_chunk_ms", "thth.idle_launch_ms", "thth.idle_rest_ms",
        "sspec.idle_ms"))
    share = read("program.idle_unattributed_pct", ctx)
    assert stages * 2 + share / 100 * total_ms == pytest.approx(total_ms)
    # idle outside every span: 20-25 and 95-100
    assert share == pytest.approx(100 * 10 / total_ms)
    assert read("sspec.idle_ms", ctx) == pytest.approx((2 + 10) / 2)


@pytest.mark.parametrize("metric", [
    "thth.idle_chunk_ms", "thth.idle_launch_ms", "thth.idle_rest_ms",
    "thth.row_wait_ms", "sspec.idle_ms", "thth.gather_device_ms",
    "thth.eig_device_ms", "thth.builds_per_obs",
    "program.idle_unattributed_pct"])
def test_nothing_to_read_gives_none(metric, ring):
    ring([])
    assert read(metric, ctx_of([], (0, 100 * MS))) is None
    ctx = harness.Context("c", {"calls": 1}, None, {}, {})
    assert read(metric, ctx) is None
    # spans outside the window are not read
    ring([rec("thth.row.chunk", 1, None, 200 * MS, 300 * MS),
          rec("thth.gather", 2, None, 200 * MS, 300 * MS)])
    assert read(metric, ctx_of([], (0, 100 * MS))) is None


def test_device_readers_need_device_time(ring):
    # spans recorded on the CPU carry no CUDA events
    ring([rec("thth.gather", 1, None, 0, 10 * MS),
          rec("thth.eig", 2, None, 10 * MS, 20 * MS)])
    ctx = ctx_of([], (0, 100 * MS))
    assert read("thth.gather_device_ms", ctx) is None
    assert read("thth.eig_device_ms", ctx) is None
    assert read("thth.builds_per_obs", ctx) == 0.0


def test_a_program_without_spans_reads_none(monkeypatch):
    # the readers run on a program that records no spans too
    monkeypatch.delattr(ot, "program_spans")
    for metric in ("thth.idle_chunk_ms", "thth.builds_per_obs",
                   "program.idle_unattributed_pct"):
        assert read(metric, ctx_of([], (0, 100 * MS))) is None


def test_the_new_metrics_are_listed_for_both_cells():
    bench = spec.benchmark()
    names = {m["name"] for m in bench["per_layer"]}
    for m in ("thth.idle_chunk_ms", "thth.idle_launch_ms",
              "thth.idle_rest_ms", "thth.row_wait_ms", "sspec.idle_ms",
              "thth.gather_device_ms", "thth.eig_device_ms",
              "thth.builds_per_obs", "program.idle_unattributed_pct"):
        assert m in names
        for cell in ("thth_4096.standard", "thth_4096.thin"):
            assert m in {e["name"] for e in spec.metrics_for(bench, cell, 1)}
