#!/usr/bin/env python3
"""Compile each of the port's CUDA sources with `nvcc -Xptxas -v` (the
flags of `ops/kernels.py`, one nvcc process a source, all at once) and
print, a source at a time, how many kernels it holds, the seconds its
nvcc took (all running at once), the most registers
any takes, and every kernel that spills or keeps a stack frame, with its
demangled name. Needs nvcc (the GPU machine):

    python3 tools/torch_ptxas_report.py [--out ptxas.txt] [source ...]

The full ptxas output goes to --out; the summary to stdout. Exits 1 where
a source fails to compile."""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    from openai_whisper_compression_tpu_torch.ops import kernels

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", help="csrc/*.cu names (default: all)")
    ap.add_argument("--out", default=None, help="file for the full ptxas output")
    args = ap.parse_args()
    nvcc = kernels._nvcc()
    srcs = [kernels.CSRC / s for s in args.sources] if args.sources else \
        sorted(kernels.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(s, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(s), "-o",
             str(Path(tmp) / (s.stem + ".o"))], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)) for s in srcs]
        done: dict = {}
        while len(done) < len(procs):   # each source's wall time to its end
            for s, p in procs:
                if s not in done and p.poll() is not None:
                    done[s] = time.perf_counter() - t0
            time.sleep(0.05)
        outs = [(s, p.communicate()[0], p.returncode) for s, p in procs]
    wall = time.perf_counter() - t0
    full, failed = [], False
    for src, out, rc in outs:
        full.append(f"==== {src.name} (rc {rc})\n{out}")
        if rc != 0:
            failed = True
            print(f"{src.name}: FAILED\n{out[-4000:]}")
            continue
        name, regs, worst, flagged = None, [], 0, []
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and name and any(int(g) for g in m.groups()):
                flagged.append((name, line.strip()))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs.append(int(m.group(1)))
                worst = max(worst, int(m.group(1)))
        print(f"{src.name}: {len(regs)} kernels in {done[src]:.1f} s, at most {worst} "
              f"registers, {len(flagged)} with a stack frame or spills")
        if flagged:
            names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in flagged),
                                   capture_output=True, text=True).stdout.splitlines()
            for (mangled, line), nice in zip(flagged, names or [n for n, _ in flagged]):
                print(f"  {nice[:160]}: {line}")
    print(f"compiled {len(srcs)} sources in parallel in {wall:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(full))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
