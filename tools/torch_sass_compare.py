#!/usr/bin/env python3
"""Compare the machine code of the port's CUDA kernels in two checkouts:
compile each source of both (the flags of `ops/kernels.py`, all nvcc
processes at once), disassemble with `cuobjdump -sass`, count each kernel's
SASS instructions, and print, a source at a time, the kernels whose counts
differ and how many are equal. A kernel of this checkout that carries one
more template argument than the other's (a RAGGED flag) is matched to the
other's kernel by its `false` instance. Needs nvcc and cuobjdump (the GPU
machine):

    python3 tools/torch_sass_compare.py --root path/to/other/checkout [source ...]

Sources are names under `openai_whisper_compression_tpu_torch/csrc/`
(default: those of the attention kernels)."""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CSRC = "openai_whisper_compression_tpu_torch/csrc"
DEFAULT = ["cross_attention.cu", "cross_attention_d16.cu", "cross_attention_d32.cu",
           "cross_attention_d128.cu", "encoder_attention.cu", "self_attention_step.cu",
           "transpose_quant.cu"]


def counts(obj: Path, cuobjdump: str) -> dict[str, int]:
    """Kernel (demangled, without its parameter list) -> SASS instructions."""
    sass = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True,
                          text=True, check=True).stdout
    out: dict[str, int] = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]+\*/", line):
            out[name] += 1
    names = subprocess.run(["c++filt"], input="\n".join(out), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    tidy = {}
    for (_, n), nice in zip(out.items(), names):
        nice = re.sub(r"_GLOBAL__N__\w+::|\(anonymous namespace\)::", "", nice)
        tidy[re.sub(r"\(.*", "", nice.replace("void ", "", 1))] = n
    return tidy


def main() -> int:
    from openai_whisper_compression_tpu_torch.ops import kernels

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="the other checkout")
    ap.add_argument("sources", nargs="*", default=DEFAULT)
    args = ap.parse_args()
    trees = {"this": ROOT, "other": Path(args.root).resolve()}
    cuobjdump = str(Path(kernels._nvcc()).parent / "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        procs = {(side, src): subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-w", "-c", str(tree / CSRC / src), "-o",
             str(Path(tmp) / f"{side}_{src}.o")]) for side, tree in trees.items()
            for src in args.sources}
        if any(p.wait() for p in procs.values()):
            print("a source failed to compile")
            return 1
        for src in args.sources:
            this, other = (counts(Path(tmp) / f"{side}_{src}.o", cuobjdump) for side in trees)
            same, differ = 0, []
            for kern, n in sorted(other.items()):
                mine = this.get(kern, this.get(kern[:-1] + ", false>"))
                if mine == n:
                    same += 1
                else:
                    differ.append(f"  {kern}: other {n}, this {mine}")
            print(f"{src}: {len(other)} kernels of the other checkout, {same} with "
                  f"the same instruction count, {len(differ)} not")
            print("\n".join(differ) if differ else "", end="\n" if differ else "")
    return 0


if __name__ == "__main__":
    sys.exit(main())
