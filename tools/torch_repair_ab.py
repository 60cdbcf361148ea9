#!/usr/bin/env python3
"""Time the f32-DFT log-mel and the weight-only dequant-matmuls of the
PyTorch port on one CUDA card, for the package of the checkout at --root:

- `log_mel_cuda` with the f32 DFT at (32, 480000) and (1, 480000) on seeded
  noise x 0.1, and at batch 1 on a streaming flush's kind of window (2 s of
  noise, then zeros), with the kernel's and the plain version's largest
  distances from the float64 log-mel (reported, so that a body that misses
  the margin is timed too);
- every storage trait of the weight-only matmul at the shapes `PERF.md`'s
  kernel table reports (whisper-small qkv at M = 32, 96 and 288 for int8;
  whisper-medium qkv at M = 64 for int4; whisper-small qkv at M = 32 for
  NF4 double-quant and HQQ int4 / uint8), and, where the checkout's
  wrappers take them, at ragged widths (whisper-small's fc1 and fc2 with
  922 FFN units), each against its plain version.

Two checkouts are timed in one call by running it in turns (parent,
change, change, parent):

    python3 tools/torch_repair_ab.py --root path/to/checkout --tag parent

Prints one JSON line: the tag, the card's name and power limit, and the
device ms per call (`chip_smoke.cuda_ms`); a shape the checkout's wrapper
refuses is reported as "refused"."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import BF16_REL, MEL_EXACT_MARGIN, cuda_ms, max_err  # noqa: E402

# (label, trait, M, K, N)
MATMULS = [("int8_qkv_m32", "int8", 32, 768, 2304), ("int8_qkv_m96", "int8", 96, 768, 2304),
           ("int8_qkv_m288", "int8", 288, 768, 2304),
           ("int4_medium_qkv_m64", "int4", 64, 1024, 3072),
           ("nf4dq_qkv_m32", "nf4", 32, 768, 2304), ("hqq4_qkv_m32", "hqq4", 32, 768, 2304),
           ("hqq8_qkv_m32", "hqq8", 32, 768, 2304),
           ("int8_fc1_n922_m96", "int8", 96, 768, 922), ("int8_fc2_k922_m96", "int8", 96, 922, 768),
           ("int4_fc1_n922_m96", "int4", 96, 768, 922), ("int4_fc2_k922_m96", "int4", 96, 922, 768)]


def matmul_case(trait: str, w: torch.Tensor):
    """(kernel, plain version, arguments after x) of a storage trait."""
    from openai_whisper_compression_tpu_torch.ops import quant_matmul as qm
    from openai_whisper_compression_tpu_torch.ops.qtensor import effective_block_scale
    from openai_whisper_compression_tpu_torch.quant.core import (
        quantize_hqq, quantize_int8, quantize_int_sub8, quantize_nf4)

    if trait == "int8":
        q = quantize_int8(w)
        return qm.int8_matmul, qm.int8_matmul_ref, (q.data, q.scale)
    if trait == "int4":
        q = quantize_int_sub8(w, 4)
        return qm.int4_matmul, qm.int4_matmul_ref, (q.data, q.scale)
    if trait == "nf4":
        q = quantize_nf4(w, block_size=64, double_quant=True, kind="nf4")
        return qm.nf4_matmul, qm.nf4_matmul_ref, (
            q.data, effective_block_scale(q).contiguous(), "nf4", 64)
    q = quantize_hqq(w, bits=4 if trait == "hqq4" else 8,
                     group_size=64 if trait == "hqq4" else 128)
    return qm.group_asym_matmul, qm.group_asym_matmul_ref, (
        q.data, q.scale, q.zero, q.block_size)


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
    f32 = torch.float32
    for key, b, tail_s in (("mel_f32_32", 32, None), ("mel_f32_1", 1, None),
                           ("mel_f32_1_tail2s", 1, 2.0)):
        wav = torch.randn(b, 480_000, generator=gen, device=dev) * 0.1
        if tail_s is not None:
            wav[:, int(tail_s * 16000):] = 0.0
        got, ref = log_mel_cuda(wav, 80, f32), features.log_mel(wav, 80, f32)
        exact = features.log_mel_f64(wav, 80, f32)
        err_k, err_p = (float((t.double() - exact).abs().max()) for t in (got, ref))
        # reported, not enforced: the parent's body is timed whatever it reads
        res[key + "_exact_err"] = {"kernel": err_k, "plain": err_p,
                                   "within_margin": err_k <= err_p + MEL_EXACT_MARGIN}
        res[key + "_ms"] = cuda_ms(lambda: log_mel_cuda(wav, 80, f32))
        res[key + "_plain_ms"] = cuda_ms(lambda: features.log_mel(wav, 80, f32))
    for label, trait, m, k, n in MATMULS:
        w = torch.randn(k, n, generator=gen, device=dev) * 0.02
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        fn, plain, rest = matmul_case(trait, w)
        try:
            got = fn(x, *rest)
        except ValueError:
            res[label] = "refused"
            continue
        want = plain(x, *rest)
        err = max_err(got, want)
        if not err <= BF16_REL * float(want.float().abs().max()):
            raise RuntimeError(f"{label}: err {err} against the plain version")
        res[label] = {"ms": cuda_ms(lambda: fn(x, *rest)), "max_abs_err": err}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
