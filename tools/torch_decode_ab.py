#!/usr/bin/env python3
"""Time the PyTorch port's two small-batch decode kernels through their
public wrappers on one CUDA card, for the package of the checkout at --root:
the one-query cross-attention (`decode_cross_attention`: K/V in q's type,
int8 and int4 K/V under f32, bf16 and f16 q, at 12 and 36 rows, whisper-small
at batch 1 and 3, s_valid 1500 of 1536) and the int8 cache update
(`decode_self_attention_update_int8`) with its read-only body (the int8
`decode_self_attention`) over a 64-row cache at 1152 and 12 rows, pos 30,
without and with a mixed `start`. Two checkouts are timed in one call by
running it in turns (parent, change, change, parent):

    python3 tools/torch_decode_ab.py --root path/to/checkout --tag parent

Only the wrappers' public signatures are used, so a tree from before their
redesign times too. Each result is checked against its plain version
(within one step of q's type of its largest magnitude; caches bit for bit;
the read-only body bit for bit against the update's output). Each kernel is
timed warm (back to back on one buffer set, chip_smoke's `cuda_ms`) and cold
(rotating over copies of its buffers larger than the 50 MB L2,
`cuda_ms_cold`). Prints a line a case and one JSON line: the tag, the card's
name and power limit, and the device ms per call."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import KERNEL_REL, check, cuda_ms, cuda_ms_cold, max_err  # noqa: E402

S_PAD, S_VALID, POS, H = 1536, 1500, 30, 12
TAGS = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}


def cross_kv(gen, kind: str, bh: int, dtype: torch.dtype) -> tuple:
    """(k_t, v_t, k_scale, v_scale) of one storage kind: K/V in q's type
    ("fp"), int8 codes or split-half packed int4 bytes with f32 scales."""
    dev = gen.device
    if kind == "fp":
        return (*(torch.randn(bh, 64, S_PAD, generator=gen, device=dev).to(dtype)
                  for _ in range(2)), None, None)
    rows, lo = (64, -127) if kind == "int8" else (32, -128)
    codes = (torch.randint(lo, 128, (bh, rows, S_PAD), generator=gen, device=dev,
                           dtype=torch.int8) for _ in range(2))
    scales = (torch.rand(bh, 1, S_PAD, generator=gen, device=dev) * 0.03 + 1e-3
              for _ in range(2))
    return (*codes, *scales)


def time_cross(res: dict, gen) -> None:
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        decode_cross_attention, decode_cross_attention_ref)

    for bh in (H, 3 * H):
        for kind in ("fp", "int8", "int4"):
            for dtype in TAGS:
                q = (torch.randn(bh, 64, generator=gen, device=gen.device) * 0.125).to(dtype)
                kv = cross_kv(gen, kind, bh, dtype)
                got = decode_cross_attention(q, *kv, S_VALID)
                ref = decode_cross_attention_ref(q, *kv, S_VALID)
                err = max_err(got, ref)
                tol = KERNEL_REL[dtype] * float(ref.float().abs().max())
                key = f"cross_{kind}_{TAGS[dtype]}_{bh}"
                check(got.dtype == dtype and err <= tol, f"{key}: err {err} > {tol}")
                warm = cuda_ms(lambda: decode_cross_attention(q, *kv, S_VALID))
                cold = cuda_ms_cold(lambda *a: decode_cross_attention(*a, S_VALID), [q, *kv])
                res[key + "_ms"], res[key + "_cold_ms"] = warm, cold
                print(f"{res['tag']} {key}: err {err:.3g} (bound {tol:.3g}) warm "
                      f"{warm:.4f} ms cold {cold:.4f} ms", flush=True)


def time_self_int8(res: dict, gen) -> None:
    from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas

    dev = gen.device
    for bh in (96 * H, H):
        for with_start in (False, True):
            start = ((torch.arange(bh, device=dev) // H * 5 % 13).to(torch.int32)
                     if with_start else None)
            q = (torch.randn(bh, 64, generator=gen, device=dev) * 0.125).to(torch.bfloat16)
            kn, vn = (torch.randn(2, bh, 64, generator=gen, device=dev) * 2).to(torch.bfloat16)
            kc, vc = torch.randint(-127, 128, (2, bh, 64, 64), generator=gen, device=dev,
                                   dtype=torch.int8)
            ks, vs = torch.rand(2, bh, 64, generator=gen, device=dev) * 0.03 + 1e-3
            bufs, refs = [kc, vc, ks, vs], [t.clone() for t in (kc, vc, ks, vs)]
            got = sas.decode_self_attention_update_int8(q, kn, vn, *bufs, POS, start=start)
            ref = sas.decode_self_attention_update_int8_ref(q, kn, vn, *refs, POS,
                                                            start=start)
            err = max_err(got, ref)
            tol = KERNEL_REL[torch.bfloat16] * float(ref.float().abs().max())
            key = f"self_int8_{bh}" + ("_start" if with_start else "")
            check(all(torch.equal(a, b) for a, b in zip(bufs, refs)),
                  f"{key}: cache rows or scales differ from the plain version's")
            check(err <= tol, f"{key}: err {err} > {tol}")
            again = sas.decode_self_attention(q, kc, vc, POS, start=start, k_scale=ks,
                                              v_scale=vs)
            check(torch.equal(again, got), f"{key}: the read-only body differs from "
                                           "the update's output")

            def update(q_, kn_, vn_, *b):
                return sas.decode_self_attention_update_int8(q_, kn_, vn_, *b, POS,
                                                             start=start)

            def attend(q_, *b):
                return sas.decode_self_attention(q_, b[0], b[1], POS, start=start,
                                                 k_scale=b[2], v_scale=b[3])

            res[key + "_ms"] = cuda_ms(lambda: update(q, kn, vn, *bufs))
            res[key + "_cold_ms"] = cuda_ms_cold(update, [q, kn, vn, *bufs])
            res["attend" + key[4:] + "_ms"] = cuda_ms(lambda: attend(q, *bufs))
            res["attend" + key[4:] + "_cold_ms"] = cuda_ms_cold(attend, [q, *bufs])
            print(f"{res['tag']} {key}: err {err:.3g} (bound {tol:.3g}) update warm "
                  f"{res[key + '_ms']:.4f} ms cold {res[key + '_cold_ms']:.4f} ms; "
                  f"read-only warm {res['attend' + key[4:] + '_ms']:.4f} ms cold "
                  f"{res['attend' + key[4:] + '_cold_ms']:.4f} ms", flush=True)


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
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(0)
    res = {"tag": args.tag, "root": args.root,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True).stdout.strip().splitlines()[0]}
    time_cross(res, gen)
    time_self_int8(res, gen)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
