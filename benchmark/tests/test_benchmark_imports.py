"""Nothing the benchmark runs is JAX or the JAX package.

The port's package name begins with the JAX package's name, so every check
compares the top-level name (the part before the first dot) whole.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)

from benchlib import runner  # noqa: E402

JAXISH = {"jax", "jaxlib", "flax", "openai_whisper_compression_tpu"}


def _imports(path: str) -> list[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            out += [a.value for a in node.args if isinstance(a, ast.Constant)]
    return out


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    seen = set()
    for path in _sources():
        for mod in _imports(path):
            top = mod.split(".")[0]
            seen.add(top)
            assert top not in JAXISH, (path, mod)
    assert "openai_whisper_compression_tpu_torch" in seen     # the port is what is imported


def test_no_source_reads_the_jax_benchmark():
    for path in _sources():
        if os.path.samefile(path, __file__):
            continue
        with open(path) as f:
            text = f.read()
        for word in ("bench.py", "BENCH_r", "BASELINE.json", "MULTICHIP_"):
            assert word not in text, (path, word)


@pytest.mark.parametrize("loaded,found", [
    (["openai_whisper_compression_tpu_torch", "openai_whisper_compression_tpu_torch.models"], []),
    (["openai_whisper_compression_tpu.models.decode"], ["openai_whisper_compression_tpu"]),
    (["openai_whisper_compression_tpux", "jaxtyping", "flaxen"], []),
    (["jax.numpy", "jaxlib"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
])
def test_forbidden_modules_compare_whole_names(monkeypatch, loaded, found):
    mods = {k: v for k, v in sys.modules.items() if k.split(".")[0] not in JAXISH}
    mods.update({name: object() for name in loaded})
    monkeypatch.setattr(sys, "modules", mods)
    assert runner.forbidden_modules() == found


def test_a_run_loads_neither(tmp_path):
    """A whole run of the tiny cell (CPU) in a fresh process, then a look at
    sys.modules."""
    code = f"""
import json, sys, time, torch
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
from benchlib import tiny, runner
from benchlib.manifest import Bench
b = Bench(tiny.make_bench({str(tmp_path)!r}))
r = runner.run_cell(b, "tiny.serve", 31, 1.0, False, torch.device("cpu"), time.perf_counter(),
                    log=lambda m: None)
print(json.dumps({{"correct": r["correct"], "found": runner.forbidden_modules(),
                  "port": "openai_whisper_compression_tpu_torch" in sys.modules}}))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, env=env, cwd=str(tmp_path))
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "found": [], "port": True}
