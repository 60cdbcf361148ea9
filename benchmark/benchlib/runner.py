"""One run of one cell: set-up, the measured window, the check, the result line."""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import torch

from benchlib import check, flops, program, readers, weights
from benchlib import traffic as traffic_gen
from benchlib.manifest import Bench, check_manifest
from benchlib.spans import SpanRecorder
from benchlib.trace import DeviceTrace

FORBIDDEN = ("jax", "jaxlib", "flax", "openai_whisper_compression_tpu")
BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (the port's name only begins with the latter)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class RunContext:
    """What an entry module sees: the cell's files, the run's arguments, the seeded
    weights and traffic, the device, and the hooks of the window."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device):
        self.cell = cell
        self.config, self.workload, self.mix = cell.config, cell.workload, cell.traffic
        self.new_tokens = int(self.mix["new_tokens"])
        self.seed, self.seconds, self.device = seed, seconds, device
        self.sample = int(self.workload["check"]["sample_requests"])
        self.tracer = DeviceTrace(device.type == "cuda") if trace else None
        self.spans = SpanRecorder() if trace else None
        self.weights = None
        self.traffic = None
        self.t_window = None
        self.peak_bytes = None

    def window_opens(self) -> None:
        """Called by the entry just before its first timed request."""
        if self.spans is not None:
            program.install_spans(self.spans)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.t_window = time.perf_counter()

    def window_closes(self) -> None:
        """Called by the entry once every counted request has finished."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.peak_bytes = torch.cuda.max_memory_allocated()
        if self.spans is not None:
            self.spans.close()


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=20)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False, log=print) -> dict:
    """Set up, measure, check; the result line's object (with "checks" last)."""
    cell = bench.cell(name)
    ctx = RunContext(cell, seed, seconds, trace, device)
    wl = cell.workload
    entry = bench.module("entries", wl["entry"])
    if device.type == "cuda":
        program.enable_kernel_cache(os.path.join(bench.dir, ".cache", "kernels"))
    window_samples = cell.config["model"]["max_source_positions"] * 320   # 30 s
    marks = [("start", time.perf_counter())]
    ctx.traffic = traffic_gen.generate(cell.traffic, seed, seconds, window_samples, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()             # the audio's buffers are not the program's
    marks.append(("traffic", time.perf_counter()))
    ctx.weights = weights.of_config(cell.config, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("weights", time.perf_counter()))
    prog = entry.build(ctx)
    marks.append(("build and warm-up", time.perf_counter()))
    ctx.weights = None                       # the program holds what it serves
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: before the cell {marks[0][1] - t_start:.3f}; "
        + "; ".join(f"{n} {t - marks[i][1]:.3f}" for i, (n, t) in enumerate(marks[1:])))
    try:
        out = entry.window(ctx, prog)
    finally:
        if hasattr(entry, "close"):
            entry.close(prog)
    trace_red = ctx.tracer.reduce(ctx.spans.ranges()) if ctx.tracer is not None else None
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {found}")
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    got = check.compare(cell.config, seed, out.served, device, control=control)
    limits = dict(wl["check"]["limits"])
    numbers = {"logit_gap": (got["logit_gap"], limits["logit_gap"]),
               "failed_requests": (out.failed, 0),
               "short_outputs": (out.short, 0),
               "checked_requests_missing": (max(0, min(ctx.sample, out.attempted)
                                                - len(out.served)), 0)}
    correct = all(v <= lim for v, lim in numbers.values())

    peak = flops.peak_of(torch.cuda.get_device_name(0) if device.type == "cuda" else "")
    metrics = {}
    if not trace:
        values = dict(out.e2e)
        values["setup_s"] = setup_s
        if ctx.peak_bytes is not None:
            values["peak_mem_mib"] = ctx.peak_bytes / 2 ** 20
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        tw = (ctx.tracer.h0, ctx.tracer.h1) if ctx.tracer.h1 else None
        r = readers.Readings(cell.config, ctx.spans, trace_red, tw, out, peak)
        for m in cell.per_layer:
            v = bench.module("metrics", m["name"]).read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
           "count": int(cell.spec["chips"]),
           "memory_peak_bytes": int(ctx.peak_bytes or 0)}
    result = {"correct": bool(correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics, "device": dev}
    if trace_red is not None:
        dev["busy_s"], dev["window_s"] = trace_red["busy_s"], trace_red["window_s"]
        result["breakdown"] = {"device_ops": trace_red["device_ops"],
                               "idle_gaps": trace_red["idle_gaps"]}
    for line in out.notes:
        log(line)
    log(f"tokens compared {got['tokens_compared']} over {len(out.served)} requests")
    if control:
        result["control_gap"] = got["control_gap"]
        log(f"control (int4 weights) logit_gap {got['control_gap']!r}")
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    return result


def parse(argv: list[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: list[str], t_start: float) -> int:
    args = parse(argv)
    bench = Bench(BENCH_DIR)
    faults = check_manifest(bench.manifest)
    if faults:
        print(f"{bench.manifest_path}: {faults}", file=sys.stderr)
        return 2
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.spec["chips"]:
        print(f"{args.workload} needs {cell.spec['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    program.import_port(os.path.dirname(BENCH_DIR))
    log(f"card: {power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda"), t_start, log=log)
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package are loaded: {found}")
        return 3
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
