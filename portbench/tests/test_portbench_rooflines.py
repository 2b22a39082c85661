"""Each roofline count equals hand arithmetic at the cells' shapes, and
the per-layer readers divide it by the device time they read."""

import pytest

from portbench import harness, spec
from portbench import trace as tr
from portbench.rooflines import arc_profile, eig_warmstart

PEAKS = spec.load_json(spec.HERE + "/peaks.json")


def test_peaks_are_the_published_h100_sxm_ones():
    assert PEAKS["hbm_bytes_per_s"] == 3.35e12
    assert PEAKS["f32_flop_per_s"] == 67e12
    assert PEAKS["tf32_flop_per_s"] == 495e12


def test_eig_warmstart_at_the_thth_shapes():
    # 8 x 8 chunks of 512², 200 η, 256 edges → 255 θ bins
    flops, nbytes = eig_warmstart.work(64, 200, 255)
    assert flops == 64 * 200 * 24 * 8 * 255 * 255 == 159_805_440_000
    assert nbytes == 64 * 200 * (65025 * 8 + 4) == 6_658_611_200
    t, what = eig_warmstart.least_seconds(
        {"chunks": 64, "neta": 200, "n": 255}, PEAKS)
    assert what == "operations"
    assert t == pytest.approx(64 * 200 * 24 * 8 * 65025 / 67e12)
    assert t == pytest.approx(2.38516e-3, rel=1e-5)


def test_arc_profile_at_the_arcfit_shapes():
    # 1024 epochs, delay rows 3 … 254 of 256, 512 Doppler bins, 2000
    # queries
    flops, nbytes = arc_profile.work(1024, 252, 512, 2000)
    assert nbytes == 1024 * 252 * 512 * 4 + 1024 * 2000 * 4 == 536_674_304
    assert flops == 20 * 1024 * 252 * 2000
    t, what = arc_profile.least_seconds(
        {"epochs": 1024, "rows": 252, "doppler": 512, "queries": 2000},
        PEAKS)
    assert what == "bytes"
    assert t == pytest.approx(536_674_304 / 3.35e12)
    # chip_smoke's count for 128 epochs: 67.2 MB, less its per-row
    # scales and query grid (the kernel's own inputs, not the cell's)
    assert arc_profile.work(128, 252, 512, 2000)[1] / 1e6 == \
        pytest.approx(67.084, abs=0.001)


def _ctx(device, calls, shapes, window=(0, 10_000_000)):
    t = tr.Trace(device, [], window)
    return harness.Context("cell", {"calls": calls, "units": calls,
                                    "unit": "obs", "elapsed": 1.0,
                                    "setup_s": 1.0}, t, shapes, PEAKS)


def test_roofline_readers_divide_least_time_by_device_time():
    shapes = {"chunks": 64, "neta": 200, "n": 255}
    least, _ = eig_warmstart.least_seconds(shapes, PEAKS)
    # two calls, each 100 ms of eig_warmstart launches and other work
    dev = [("eig_warmstart_kernel", 0, 60_000_000),
           ("eig_warmstart_kernel", 61_000_000, 101_000_000),
           ("gather", 101_000_000, 150_000_000),
           ("eig_warmstart_kernel", 200_000_000, 300_000_000)]
    ctx = _ctx(dev, 2, shapes, (0, 400_000_000))
    got = spec.reader("eig_warmstart_roofline").read(ctx)
    assert got == pytest.approx(100 * least / 0.1)
    assert spec.reader("arc_profile_roofline").read(ctx) is None
    ctx.trace = None
    assert spec.reader("eig_warmstart_roofline").read(ctx) is None
