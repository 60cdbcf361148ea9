"""A configuration, a traffic mix, a cell and a per-layer metric are added
by adding files and manifest entries: no file of the harness changes."""

from __future__ import annotations

import json
import os
import sys
import time

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))

from benchlib import runner, tiny  # noqa: E402
from benchlib.manifest import Bench  # noqa: E402

READER = '''"""rows_per_encode.batch: rows a call of the encoder, from its spans."""

from benchlib import readers

LAYER = "encoder"
UNIT = "rows"
MOVES = "rtfx"


def read(r: readers.Readings) -> float | None:
    spans = r.spans.of("encode")
    return sum(s.rows for s in spans) / len(spans) if spans else None
'''


def _snapshot(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_new_files_are_found_by_name(tmp_path):
    bdir = tiny.make_bench(str(tmp_path))
    before = _snapshot(bdir)

    cfg = dict(tiny.CONFIG, name="test2l-int8-b")
    mix = dict(tiny.MIXES["tiny-batch"], batch=3, burst_size=1)
    cell = dict(tiny.CELLS[0], name="tiny-b.batch3", config="test2l-int8-b", traffic="tiny-batch3")
    for folder, name, body in (("configs", cfg["name"], cfg), ("traffic", "tiny-batch3", mix),
                               ("workloads", cell["name"], cell)):
        with open(os.path.join(bdir, folder, f"{name}.json"), "w") as f:
            json.dump(body, f)
    with open(os.path.join(bdir, "metrics", "rows_per_encode.batch.py"), "w") as f:
        f.write(READER)

    manifest_path = os.path.join(str(tmp_path), "BENCHMARK.json")
    with open(manifest_path) as f:
        m = json.load(f)
    m["configs"].append({"name": cfg["name"], "source": "tiny", "reduced": [], "why": "a test",
                         "file": "benchmark/configs/test2l-int8-b.json"})
    m["workloads"].append({"name": cell["name"], "config": cfg["name"], "traffic": "tiny-batch3",
                           "chips": 1, "why": "a test"})
    for x in m["end_to_end"] + m["per_layer"]:
        if "tiny.batch" in x.get("workloads", []):
            x["workloads"].append(cell["name"])
    m["per_layer"].append({"name": "rows_per_encode.batch", "unit": "rows", "better": "higher",
                           "source": "program_span", "layer": "encoder", "moves": "rtfx",
                           "workloads": [cell["name"]]})
    with open(manifest_path, "w") as f:
        json.dump(m, f)

    # every harness file is as it was: only new files were added
    after = _snapshot(bdir)
    assert all(after[k] == v for k, v in before.items())
    assert len(after) == len(before) + 4

    bench = Bench(bdir)
    c = bench.cell(cell["name"])
    assert c.config["name"] == "test2l-int8-b" and c.traffic["batch"] == 3
    assert "rows_per_encode.batch" in [x["name"] for x in c.per_layer]
    log = []
    r0 = runner.run_cell(bench, cell["name"], 9, 8.0, False, torch.device("cpu"),
                         time.perf_counter(), log=log.append)
    assert set(r0["metrics"]) == {"rtfx", "setup_s"}     # peak_mem_mib is read on a card
    r1 = runner.run_cell(bench, cell["name"], 9, 8.0, True, torch.device("cpu"),
                         time.perf_counter(), log=log.append)
    assert r1["metrics"]["rows_per_encode.batch"] == {"value": 3.0, "unit": "rows"}
    assert r0["correct"] and r1["correct"]


def test_missing_files_are_named(tmp_path):
    bench = Bench(tiny.make_bench(str(tmp_path)))
    os.remove(os.path.join(bench.dir, "traffic", "tiny-batch.json"))
    try:
        bench.cell("tiny.batch")
    except FileNotFoundError as e:
        assert "tiny-batch" in str(e)
    else:
        raise AssertionError("a cell whose traffic file is missing loaded")
