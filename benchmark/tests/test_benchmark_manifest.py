"""BENCHMARK.json against the benchmark's contract, and the files it names."""

from __future__ import annotations

import json
import os
import re
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)

from benchlib.manifest import NAME_RE, UNIT_RE, Bench, check_manifest  # noqa: E402

MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def m() -> dict:
    with open(MANIFEST) as f:
        return json.load(f)


def test_top_level_keys_and_size(m):
    assert set(m) == KEYS
    assert os.path.getsize(MANIFEST) <= 64 * 1024
    assert m["paths"] == ["benchmark"]
    assert m["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51


@pytest.mark.parametrize("group", sorted(ENTRY_KEYS))
def test_entry_keys(m, group):
    for e in m[group]:
        extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[group] <= set(e) <= ENTRY_KEYS[group] | extra, e["name"]


def test_naming_rules(m):
    assert check_manifest(m) == []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in m[group]]
        assert len(names) == len(set(names))
        for n in names:
            assert NAME_RE.match(n) and len(n) <= 64
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT_RE.match(x["unit"]) and len(x["unit"]) <= 16, x["unit"]
        assert not re.search(r"\s", x["unit"])
    for e in m["configs"] + m["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for x in m["per_layer"]:
        assert 1 <= len(x["layer"]) <= 200 and "\n" not in x["layer"]


@pytest.mark.parametrize("bad,ok", [("a b", "a_b"), ("x,y", "x.y"), ("a/b", "a-b"),
                                    ("-x", "_x"), ("µs", "us")])
def test_name_pattern(bad, ok):
    assert not NAME_RE.match(bad) and NAME_RE.match(ok)


@pytest.mark.parametrize("bad,ok", [("tokens per s", "tokens/s"), ("µs", "us"),
                                    ("x" * 17, "audio_s/s")])
def test_unit_pattern(bad, ok):
    assert not UNIT_RE.match(bad) and UNIT_RE.match(ok)


def test_bounds(m):
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25, x["name"]
    assert {x["name"]: x for x in m["end_to_end"]}["setup_s"]["bound"] <= 0.25
    assert {x["source"] for x in m["end_to_end"]} <= {"host_clock", "device_trace"}


def test_chips(m):
    four = [w for w in m["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in m["workloads"])
    assert len(four) <= max(1, len(m["workloads"]) // 4)


def test_every_cell_reports_enough(m):
    bench = Bench(BENCH, MANIFEST)
    for w in m["workloads"]:
        cell = bench.cell(w["name"])
        e2e = {x["name"] for x in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for x in cell.per_layer:      # a metric moves an end-to-end metric its cells report
            assert x["moves"] in e2e, (w["name"], x["name"])


def test_every_config_is_used_and_filed(m):
    used = {w["config"] for w in m["workloads"]}
    files = set()
    for c in m["configs"]:
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16


def test_metric_files_match_manifest(m):
    bench = Bench(BENCH, MANIFEST)
    for x in m["per_layer"]:
        mod = bench.module("metrics", x["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (x["layer"], x["unit"], x["moves"]), x["name"]
        assert callable(mod.read)
    layers = {}
    for x in m["per_layer"]:      # one layer, one spelling
        layers.setdefault(x["layer"].lower(), set()).add(x["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_shares_are_percent_and_named(m):
    for x in m["per_layer"]:
        if "roofline" in x["name"] or "mfu" in x["name"]:
            assert x["unit"] == "%"
    for w in m["workloads"]:
        names = {x["name"] for x in Bench(BENCH, MANIFEST).cell(w["name"]).per_layer}
        assert any("mfu" in n for n in names), w["name"]


def test_paths_hold_only_the_benchmark(m):
    for p in m["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    for word in m["command"]:
        assert not word.startswith("/") and ".." not in word.split("/")
