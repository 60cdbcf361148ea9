"""The check's readings on several seeds in one process: the program's
widest logit gap and the int4 control's (the reference with its linear
weights rounded to int4 put in the program's place), on the same sample;
or, with `--fault`, the program's widest gap with a fault planted under
the timed path (`benchlib/faults.py`: token, half_batch, state).

    python3 benchmark/tools/control.py --workload <cell> --seeds 11,12,13 --seconds 8
    python3 benchmark/tools/control.py --workload <cell> --seeds 11,12 --fault half_batch

Each seed is a whole run of the cell at its own size (its own weights and
traffic, set-up, the window, the check, with the control beside it where no
fault is planted); one JSON line a seed on standard output. The limits in
`workloads/<cell>.json` are set from these readings (PERF.md gives them).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--fault", default="", help="token, half_batch or state")
    args = ap.parse_args(argv)

    import torch

    import contextlib

    from benchlib import faults, program, runner
    from benchlib.manifest import Bench

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    program.import_port(os.path.dirname(BENCH))
    bench = Bench(BENCH)
    if args.fault and args.fault not in faults.FAULTS[:3]:
        print(f"--fault is one of {faults.FAULTS[:3]}", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = bench.cell(args.workload)
        planted = faults.plant(args.fault, cell.config, seed) if args.fault \
            else contextlib.nullcontext()
        with planted:
            r = runner.run_cell(bench, args.workload, seed, args.seconds, False,
                                torch.device("cuda"), time.perf_counter(),
                                control=not args.fault,
                                log=lambda m: print(m, file=sys.stderr, flush=True))
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault or None,
                          "correct": r["correct"],
                          "logit_gap": r["checks"]["logit_gap"]["value"],
                          "control_gap": r.get("control_gap"), "metrics": r["metrics"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, BENCH)
    sys.path.insert(1, os.path.dirname(BENCH))
    sys.exit(main(sys.argv[1:]))
