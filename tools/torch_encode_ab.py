#!/usr/bin/env python3
"""Time the PyTorch port's two encode-side kernels through their public
wrappers on one CUDA card, for the package of the checkout at --root: the
fused log-mel (`log_mel_cuda`, bf16 DFT at batch 32 and 96 and the f32 DFT
at batch 32, 30 s clips) and the cross-KV transpose + int8 quantize
(`transpose_quant_kv`, bf16, whisper-small's (96, 1500, 768) and
whisper-medium's (64, 1500, 1024)). Two checkouts are timed in one call by
running it in turns (parent, change, change, parent):

    python3 tools/torch_encode_ab.py --root path/to/checkout --tag parent

Only the wrappers' public signatures are used, so a tree from before their
redesign times too. Each result is checked against its plain version
(log-mel within chip_smoke's MEL_ATOL, codes and scales bit for bit through
chip_smoke's `check_tq`). Prints one JSON line: the tag, the card's name and
power limit, and the device ms per call (`chip_smoke.cuda_ms`)."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import MEL_ATOL, check, check_tq, cuda_ms, max_err  # noqa: E402


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
    from openai_whisper_compression_tpu_torch.audio import features
    from openai_whisper_compression_tpu_torch.audio.mel_kernel import log_mel_cuda

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"tag": args.tag, "root": args.root,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True).stdout.strip().splitlines()[0]}
    for b, dtype in ((32, torch.bfloat16), (96, torch.bfloat16), (32, torch.float32)):
        wav = torch.randn(b, 480_000, generator=gen, device=dev) * 0.1
        err = max_err(log_mel_cuda(wav, 80, dtype), features.log_mel(wav, 80, dtype))
        check(err <= MEL_ATOL, f"mel {b} {dtype}: err {err} > {MEL_ATOL}")
        key = f"mel_{'bf16' if dtype == torch.bfloat16 else 'f32'}_{b}"
        res[key + "_ms"] = cuda_ms(lambda: log_mel_cuda(wav, 80, dtype))
        res[key + "_err"] = err
        del wav
    for b, h in ((96, 12), (64, 16)):
        x = (torch.randn(b, 1500, h * 64, generator=gen, device=dev) * 0.4).to(torch.bfloat16)
        res[f"tq_{b}_{h * 64}_ms"] = check_tq(x, h)[0]["ms"]
        del x
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
