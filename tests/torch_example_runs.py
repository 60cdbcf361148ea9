"""What the example tests (`test_torch_examples_*.py`) share: a JAX example
run in a subprocess, the port's seeded weights replaced by the JAX
package's draws, and the comparison of the two outputs line by line.

The port's `init_params` draws from a torch generator, so `--model test2l
--seed 0` means another tree than JAX's; `same_weights` patches it (for
every architecture the examples build, the draft's too) to JAX's
`init_params` carried over with `from_numpy`, so that both examples decode
one tree."""

from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE_TIMEOUT_S = 600


def run_jax_example(name: str, argv: tuple = (), prelude: str = "",
                    env: dict | None = None) -> str:
    """stdout of `examples/<name>.py` run with `PYTHONPATH` = the repo and
    `JAX_PLATFORMS=cpu`, after the Python `prelude` (patches that record
    what a run drew)."""
    script = str(ROOT / "examples" / f"{name}.py")
    code = (prelude + "\nimport runpy, sys\n"
            f"sys.argv = {[script, *argv]!r}\n"
            f"runpy.run_path({script!r}, run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=EXAMPLE_TIMEOUT_S,
                         env={**os.environ, "PYTHONPATH": str(ROOT),
                              "JAX_PLATFORMS": "cpu", **(env or {})})
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


def same_weights(monkeypatch) -> None:
    """The port's `init_params` replaced by the JAX package's draws for the
    same architecture and seed."""
    import jax

    from openai_whisper_compression_tpu.config import WhisperArch as JaxArch
    from openai_whisper_compression_tpu.models import params as JP
    from openai_whisper_compression_tpu_torch.models import params as P

    def init_params(arch, seed=0, dtype=torch.float32, device="cuda"):
        jarch = JaxArch(**{f.name: getattr(arch, f.name) for f in dataclasses.fields(arch)})
        jdt = {torch.float32: np.float32, torch.bfloat16: jax.numpy.bfloat16}[dtype]
        jp = JP.init_params(jarch, jax.random.PRNGKey(seed), dtype=jdt)
        return P.from_numpy(_numpy(jp), device=device)

    monkeypatch.setattr(P, "init_params", init_params)


def _numpy(tree):
    """A JAX tree as numpy, every dict in its own key order (the order
    `init_params` built it in; `jax.tree.map` would sort the keys)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return np.asarray(tree)


NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def numbers(line: str) -> list[float]:
    return [float(x) for x in NUMBER.findall(line)]


def assert_lines_match(jax_out: str, port_out: str, exempt=(), close=None,
                       subs=()) -> None:
    """The two outputs line for line, after the substitutions `subs`
    ((pattern, replacement) pairs: temporary paths, timing values) in both:
    equal, but for the lines that match a pattern of `exempt` (named by the
    caller, each with its reason) and the lines that match a key of `close`,
    whose text must be equal with the numbers taken out and whose numbers
    are held by the key's specs, one a number: None for equal, or (rel,
    abs) for |port - jax| <= rel |jax| + abs."""
    close = close or {}
    for pat, rep in subs:
        jax_out, port_out = re.sub(pat, rep, jax_out), re.sub(pat, rep, port_out)
    jl, pl = jax_out.splitlines(), port_out.splitlines()
    assert len(jl) == len(pl), (len(jl), len(pl), jax_out, port_out)
    for j, p in zip(jl, pl):
        if any(re.search(e, j) for e in exempt):
            assert any(re.search(e, p) for e in exempt), (j, p)
            continue
        specs = next((t for pat, t in close.items() if re.search(pat, j)), None)
        if specs is None:
            assert p == j, (j, p)
            continue
        assert NUMBER.sub("#", p) == NUMBER.sub("#", j), (j, p)
        a, b = numbers(j), numbers(p)
        assert len(a) == len(b) == len(specs), (j, p, specs)
        for x, y, spec in zip(a, b, specs):
            if spec is None:
                assert x == y, (j, p)
            else:
                rel, tol = spec
                assert abs(x - y) <= rel * abs(x) + tol, (j, p, spec)
