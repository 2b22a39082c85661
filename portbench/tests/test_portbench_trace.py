"""The idle-share arithmetic on synthetic intervals: idle time at the
window's edges and between calls counts, which a busy share taken from
the first device activity to the last misses."""

import pytest

from portbench import harness, spec
from portbench import trace as tr


def test_union_merges_overlaps_and_clips_to_the_window():
    iv = [(10, 20), (15, 30), (40, 50), (-5, 2), (95, 120)]
    assert tr.merged(iv, 0, 100) == [[0, 2], [10, 30], [40, 50], [95, 100]]
    assert tr.busy_ns(iv, 0, 100) == 2 + 20 + 10 + 5


def test_idle_gaps_include_the_edges():
    iv = [(10, 20), (40, 50)]
    assert tr.idle_gaps(iv, 0, 100) == [(0, 10), (20, 40), (50, 100)]
    assert tr.idle_gaps([], 0, 100) == [(0, 100)]


def test_idle_share_counts_the_edges_a_first_to_last_share_misses():
    # device busy 20 of a 100-unit window; between its first and last
    # activities it is busy 20 of 40
    device = [("k", 10, 20), ("k", 40, 50)]
    t = tr.Trace(device, [], (0, 100))
    ctx = harness.Context("c", {"calls": 1}, t, {}, {})
    idle = spec.reader("device_idle_pct.curvature").read(ctx)
    assert idle == pytest.approx(80.0)
    first_to_last = tr.busy_ns([(a, b) for _, a, b in device], 10, 50) / 40
    assert 100 * (1 - first_to_last) == pytest.approx(50.0)
    assert spec.reader("device_idle_pct.arcfit").read(ctx) == idle


def test_gap_labels_are_the_innermost_host_span():
    spans = [("portbench.call", 0, 100), ("thth.sspec", 0, 30),
             ("thth.search", 30, 90)]
    assert tr.label_at(spans, 5) == "thth.sspec"
    assert tr.label_at(spans, 50) == "thth.search"
    assert tr.label_at(spans, 95) == "portbench.call"
    assert tr.label_at(spans, 150) == "between calls"


def test_breakdown_sums_device_ops_and_idle_by_span():
    device = [("gemm", 10, 20), ("fft", 20, 25), ("gemm", 40, 50)]
    spans = [("portbench.call", 0, 45), ("thth.prep", 25, 40)]
    b = tr.breakdown(tr.Trace(device, spans, (0, 100)))
    assert b["device_ops"] == [["gemm", 2e-8], ["fft", 5e-9]]
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"between calls": 5e-8, "thth.prep": 1.5e-8,
         "portbench.call": 1e-8})


def test_span_readers_take_the_mean_span():
    spans = [("thth.sspec", 0, 2_000_000), ("thth.sspec", 5_000_000,
                                             9_000_000)]
    ctx = harness.Context("c", {"calls": 2}, tr.Trace([], spans, (0, 10)),
                          {}, {})
    assert spec.reader("thth.sspec_ms").read(ctx) == pytest.approx(3.0)
    assert spec.reader("thth.prep_ms").read(ctx) is None


def test_launch_and_device_time_per_call():
    device = [("a", 0, 1_000_000), ("b", 500_000, 2_000_000),
              ("c", 3_000_000, 4_000_000)]
    ctx = harness.Context("c", {"calls": 2},
                          tr.Trace(device, [], (0, 10_000_000)), {}, {})
    assert spec.reader("arcfit.launches_per_batch").read(ctx) == 1.5
    assert spec.reader("arcfit.device_ms_per_batch").read(ctx) == \
        pytest.approx(1.5)
