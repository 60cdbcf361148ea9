#!/usr/bin/env python3
"""Time the w8a8 matmul of the PyTorch port on one CUDA card, for the
package of the checkout at --root: dynamic and static, bf16 activations, at
whisper-small's four linears (qkv, o, fc1, fc2) at M = 96 (a decode step of
bench.py's batch) and M = 96 x 1500 (its encoder), and, where the
checkout's wrapper takes them, at the ragged widths of whisper-small after
`activation_guided_ffn_prune(0.3)` (fc1 N = 922, fc2 K = 922) at M = 32,
96 and 32 x 1500; each call bit-equal to the plain version.

Two checkouts are timed in one call by running it in turns (parent,
change, change, parent):

    python3 tools/torch_w8a8_ab.py --root path/to/checkout --tag parent

Prints one JSON line: the tag, the card's name and power limit, and the
device ms per call (`chip_smoke.cuda_ms`: 3 calls at encoder M, 20 at
decode M); a shape the checkout's wrapper refuses is reported as
"refused"."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import cuda_ms  # noqa: E402

# (label, M, K, N)
SHAPES = [(f"{what}_m{m}", m, k, n) for m in (96, 96 * 1500)
          for what, k, n in (("qkv", 768, 2304), ("o", 768, 768), ("fc1", 768, 3072),
                             ("fc2", 3072, 768))]
SHAPES += [(f"{what}922_m{m}", m, k, n) for m in (32, 96, 32 * 1500)
           for what, k, n in (("fc1", 768, 922), ("fc2", 922, 768))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose openai_whisper_compression_tpu_torch is timed")
    ap.add_argument("--tag", default="this", help="name printed with the result")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from openai_whisper_compression_tpu_torch.ops import quant_matmul as qm
    from openai_whisper_compression_tpu_torch.quant.core import quantize_int8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"tag": args.tag, "root": args.root,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True).stdout.strip().splitlines()[0]}
    for label, m, k, n in SHAPES:
        q = quantize_int8(torch.randn(k, n, generator=gen, device=dev) * 0.02)
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        frozen = (x.abs().max().float() / 127.0).reshape(())
        few = {"warmup": 1, "iters": 3} if m > 1024 else {}
        for mode, act_scale in (("dyn", None), ("static", frozen)):
            key = f"{label}_{mode}"
            try:
                got = qm.w8a8_matmul(x, q.data, q.scale, act_scale)
            except ValueError:
                res[key] = "refused"
                continue
            if not torch.equal(got, qm.w8a8_matmul_ref(x, q.data, q.scale, act_scale)):
                raise RuntimeError(f"{key}: differs from the plain version")
            res[key] = cuda_ms(lambda: qm.w8a8_matmul(x, q.data, q.scale, act_scale), **few)
        del x, q
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
