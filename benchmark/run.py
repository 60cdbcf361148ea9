"""The port's benchmark: run one cell of BENCHMARK.json and print one result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run sets up (seeded weights made on the card, the program's quantization,
warm-up of the cell's own shapes), measures for `--seconds`, checks what the
timed path produced against the plain reference in `benchmark/reference/`,
and prints one JSON object as the last line of standard output. `--trace 0`
reports the cell's end-to-end metrics, `--trace 1` its per-layer metrics.
Without a CUDA device, or with fewer than the cell asks for, it exits 2 and
prints no result.

What it measures is the PyTorch port, `openai_whisper_compression_tpu_torch`;
nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()   # set-up is timed from here

import os    # noqa: E402
import sys   # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _fixed_cache_dirs() -> None:
    """Every build and kernel cache in a fixed directory inside the checkout,
    so that only a checkout's first run builds."""
    cache = os.path.join(HERE, ".cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


if __name__ == "__main__":
    _fixed_cache_dirs()
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    from benchlib.runner import main

    sys.exit(main(sys.argv[1:], t_start=T_START))
