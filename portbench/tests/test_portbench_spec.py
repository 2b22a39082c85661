"""``BENCHMARK.json`` keeps to its contract, and every file it names is
found by name."""

import json
import os
import re

import pytest

from portbench import spec

BENCH = os.path.join(spec.ROOT, "BENCHMARK.json")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def one_line(s, most=200):
    return isinstance(s, str) and 1 <= len(s) <= most and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(BENCH) <= 64 * 1024


def test_command_and_paths(bench):
    cmd, paths = bench["command"], bench["paths"]
    assert 1 <= len(cmd) <= 32 and all(one_line(c) for c in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(spec.ROOT, p))
    for word in cmd:
        if "/" in word or word.endswith(".py"):
            assert not word.startswith("/") and ".." not in word
            assert any(word.startswith(p.rstrip("/") + "/") for p in paths)
            assert os.path.exists(os.path.join(spec.ROOT, word))


def test_run_seconds_fits_the_full_check(bench):
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert spec.NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
    for group in ("configs", "workloads"):
        got = [n for g, n in names if g == group]
        assert len(got) == len(set(got))
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in bench["workloads"]:
        assert spec.NAME.match(w["config"]) and spec.NAME.match(w["traffic"])


def test_configs(bench):
    files = [c["file"] for c in bench["configs"]]
    assert 1 <= len(files) <= 24 and len(files) == len(set(files))
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert any(c["file"].startswith(p.rstrip("/") + "/")
                   for p in bench["paths"])
        assert len(c["reduced"]) <= 16
        assert all(spec.NAME.match(k) for k in c["reduced"])
        _, data = spec.config(bench, c["name"])
        assert data["name"] == c["name"]
        assert c["name"] in used
        spec.reference(data["reference"])


def test_workloads(bench):
    ws = bench["workloads"]
    assert 1 <= len(ws) <= 24
    pairs = [(w["config"], w["traffic"]) for w in ws]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in ws)
    assert four <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        spec.config(bench, w["config"])
        t = spec.traffic(w["traffic"])
        assert hasattr(spec.driver(t["driver"]), "Cell")
        lim = spec.limits(w["name"])
        assert lim is not None and lim["numbers"], w["name"]
        for entry in lim["numbers"].values():
            assert entry["limit"] >= 0


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert one_line(m["layer"]) and m["moves"] in e2e
        for c in m.get("workloads", []):
            assert c in cells and spec.applies(e2e[m["moves"]], c)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
        assert set(m.get("workloads", [])) <= cells


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in spec.metrics_for(bench, w["name"], 0)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_for(bench, w["name"], 1)


def test_files_under_paths_are_named_from_name_characters(bench):
    for p in bench["paths"]:
        for dirpath, dirnames, filenames in os.walk(
                os.path.join(spec.ROOT, p)):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for f in filenames:
                rel = os.path.relpath(os.path.join(dirpath, f), spec.ROOT)
                assert PATH.match(rel), rel


def test_benchmark_json_is_what_the_driver_reads():
    with open(BENCH) as f:
        assert json.load(f) == spec.benchmark()
