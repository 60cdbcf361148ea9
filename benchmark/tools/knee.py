"""The service's knee: the highest offered rate whose backlog does not grow.

    python3 benchmark/tools/knee.py --workload <serve cell> --seed 5 --seconds 20 --rates 40,60,80

One set-up (the cell's configuration and service settings), then one
open-loop window a rate, each with the cell's traffic mix at that rate.
For each rate it prints one JSON line: requests offered and answered a
second, latency p50 and p95, and the median latency of the window's first
and last thirds of requests; a backlog that grows shows as a last third far
slower than the first, and as answers falling behind offers. The cell's
own rate is then fixed in its traffic file at about 0.8 of the knee
(PERF.md gives the sweep). Needs a CUDA device; checks nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True, help="comma-separated requests a second")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from benchlib import program, runner, traffic, weights
    from benchlib.manifest import Bench

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    program.import_port(os.path.dirname(BENCH))
    bench = Bench(BENCH)
    cell = bench.cell(args.workload)
    entry = bench.module("entries", cell.workload["entry"])
    dev = torch.device("cuda")
    program.enable_kernel_cache(os.path.join(bench.dir, ".cache", "kernels"))
    ctx = runner.RunContext(cell, args.seed, args.seconds, False, dev)
    ctx.sample = 0
    ctx.weights = weights.of_config(cell.config, args.seed, dev)
    prog = entry.build(ctx)
    ctx.weights = None
    window = cell.config["model"]["max_source_positions"] * 320
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            mix = dict(cell.traffic, rate_per_s=rate)
            ctx.traffic = traffic.generate(mix, args.seed, args.seconds, window)
            out = entry.window(ctx, prog)
            lat = np.asarray(out.latencies) * 1e3
            third = max(1, len(lat) // 3)
            done = len(out.done)
            print(json.dumps({
                "rate_per_s": rate, "offered_per_s": out.attempted / args.seconds,
                "answered": done, "failed": out.failed,
                "p50_ms": float(np.median(lat)), "p95_ms": out.e2e["latency_p95_ms"],
                "first_third_p50_ms": float(np.median(lat[:third])),
                "last_third_p50_ms": float(np.median(lat[-third:])),
                "batch_occupancy": out.counters.get("batch_occupancy"),
                "batches": out.counters.get("batches")}), flush=True)
            for line in out.notes:
                print(line, file=sys.stderr, flush=True)
    finally:
        entry.close(prog)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, BENCH)
    sys.path.insert(1, os.path.dirname(BENCH))
    sys.exit(main(sys.argv[1:]))
