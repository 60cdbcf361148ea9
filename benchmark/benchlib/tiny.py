"""A copy of the benchmark with cells of the port's 2-layer test model, for
running the harness end to end on the CPU (the tests, and a rehearsal
before a chip run).

`make_bench(dst)` copies the benchmark folder to `dst/benchmark`, adds the
configuration `test2l-int8` (the port's `ARCHS["test2l"]`: width 64, 4
heads, 2 + 2 layers, vocab 1000, a window of 64 encoder positions), two
traffic mixes and two cells on them, `tiny.batch` and `tiny.serve`, and
writes a manifest holding only them at `dst/BENCHMARK.json`.
"""

from __future__ import annotations

import json
import os
import shutil

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG = {
    "name": "test2l-int8",
    "source": "openai_whisper_compression_tpu_torch/config.py ARCHS['test2l']",
    "model": {"d_model": 64, "encoder_layers": 2, "encoder_attention_heads": 4,
              "decoder_layers": 2, "decoder_attention_heads": 4, "encoder_ffn_dim": 128,
              "decoder_ffn_dim": 128, "num_mel_bins": 80, "vocab_size": 1000,
              "max_source_positions": 64, "max_target_positions": 32,
              "decoder_start_token_id": 998, "eos_token_id": 997,
              "forced_prefix": [998, 999]},
    "program": {"arch": "test2l", "weights_dtype": "bfloat16", "quantize": "int8",
                "fuse_qkv": True, "mel_dft": "bfloat16", "encoder_mlp_gelu": "tanh",
                "decode": {"greedy": True, "kv_int8": True, "cross_kv_int8": True,
                           "suppress_eot": True}},
    "reduced": [],
}
SHORT = {"kind": "lognormal", "median_s": 0.6, "sigma": 0.5, "min_s": 0.2, "max_s": 1.2}
MIXES = {
    "tiny-batch": {"arrivals": "closed", "batch": 4, "pool_batches": 2, "source_seconds": 10,
                   "durations": SHORT, "new_tokens": 24},
    "tiny-poisson": {"arrivals": "poisson", "rate_per_s": 20.0, "source_seconds": 10,
                     "durations": SHORT, "new_tokens": 24},
}
CELLS = [
    {"name": "tiny.batch", "config": "test2l-int8", "traffic": "tiny-batch", "chips": 1,
     "entry": "transcribe_fn", "trace": {"batches": 2},
     "check": {"sample_requests": 8, "limits": {"logit_gap": 0.015}},
     "why": "the harness on the CPU"},
    {"name": "tiny.serve", "config": "test2l-int8", "traffic": "tiny-poisson", "chips": 1,
     "entry": "service",
     "service": {"batch_size": 8, "max_wait_ms": 20.0, "transfer": "int16", "pipeline": 2},
     "check": {"sample_requests": 8, "limits": {"logit_gap": 0.015}},
     "why": "the harness on the CPU"},
]


def make_bench(dst: str) -> str:
    """The tiny benchmark under `dst`; returns its benchmark folder."""
    bdir = os.path.join(dst, "benchmark")
    shutil.copytree(BENCH_DIR, bdir, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    with open(os.path.join(bdir, "configs", "test2l-int8.json"), "w") as f:
        json.dump(CONFIG, f)
    for folder, items in (("workloads", {c["name"]: c for c in CELLS}), ("traffic", MIXES)):
        for name, body in items.items():
            with open(os.path.join(bdir, folder, f"{name}.json"), "w") as f:
                json.dump(body, f)
    with open(os.path.join(os.path.dirname(BENCH_DIR), "BENCHMARK.json")) as f:
        real = json.load(f)
    names = [c["name"] for c in CELLS]
    manifest = {
        "command": real["command"], "paths": real["paths"], "run_seconds": 2,
        "configs": [{"name": "test2l-int8", "source": CONFIG["source"],
                     "file": "benchmark/configs/test2l-int8.json", "reduced": [],
                     "why": "tiny"}],
        "workloads": [{"name": c["name"], "config": c["config"], "chips": 1,
                       "traffic": c["traffic"], "why": c["why"]} for c in CELLS],
        "end_to_end": [dict(m, workloads=names[:1] if m["name"] == "rtfx" else
                            names[1:] if m["name"] == "latency_p95_ms" else names)
                       for m in real["end_to_end"]],
        "per_layer": [dict(m, workloads=names[:1] if m["name"].endswith(".batch") else names[1:])
                      for m in real["per_layer"]],
    }
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return bdir
