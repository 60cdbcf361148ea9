"""A run end to end: the command's refusals, and the result line's shape."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(1, ROOT)

from benchlib import program, runner, tiny  # noqa: E402
from benchlib.manifest import Bench  # noqa: E402

ARGS = ["--workload", "small-int8.windows30s", "--seed", str(2 ** 31 + 99), "--seconds", "2",
        "--trace", "0"]


def _run_py(cwd: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""          # no card
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    p = _run_py(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_benchmark_files_alone_are_not_enough(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = _run_py(str(tmp_path))
    assert p.returncode != 0 and p.stdout.strip() == ""
    with pytest.raises(RuntimeError, match="outside the checkout"):
        program.import_port(str(tmp_path))
    assert program.import_port(ROOT).__name__ == "openai_whisper_compression_tpu_torch"


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return Bench(tiny.make_bench(str(tmp_path_factory.mktemp("tiny"))))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["tiny.batch", "tiny.serve"])
def test_result_line(bench, cell, trace):
    c = bench.cell(cell)
    r = runner.run_cell(bench, cell, 2 ** 31 + 5, 8.0, trace, torch.device("cpu"),
                        time.perf_counter(), log=lambda m: None)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert list(r)[-1] == "checks"
    json.dumps(r)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    names = {x["name"]: x["unit"] for x in (c.per_layer if trace else c.end_to_end)}
    for k, v in r["metrics"].items():
        assert names[k] == v["unit"] and isinstance(v["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"]) and r["device"]["window_s"] > 0
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in r["breakdown"].values())
    else:
        assert "setup_s" in r["metrics"]
        assert "rtfx" in r["metrics"] or "latency_p95_ms" in r["metrics"]
    for k, v in r["checks"].items():
        assert set(v) == {"value", "limit"}, k


def test_reader_that_finds_nothing_is_left_out(bench):
    """On the CPU no device operation is traced: the idle share is absent,
    never 0 or 100."""
    r = runner.run_cell(bench, "tiny.batch", 3, 8.0, True, torch.device("cpu"),
                        time.perf_counter(), log=lambda m: None)
    assert "device_idle.batch" not in r["metrics"]
    assert "encode_ms.batch" in r["metrics"]


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of the first cell on the card (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "benchmark/run.py", *ARGS[:-1], "1"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
