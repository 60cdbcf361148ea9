#!/usr/bin/env python3
"""Hold and time the encoder attention's f32 and WIDE bodies, and the calls
past the grid's 65535 limit, on one CUDA card, for the package of the
checkout at --root:

- f32 (up to head dim 256, 3xTF32 on the tensor cores): whisper-small batch
  96, (96, 12, 1500, 64), on the strided views the model hands it, timed
  beside `sdpa` in f32 (TF32 off) and the bound (three TF32 products at 495
  TFLOP/s, or the bytes); held at every capacity (16, 32, 64, 128, 256),
  at ragged dims (8, 36, 100, 200) and on a view with odd strides;
- WIDE (bf16 and f16 past 256): (8, 2, 1500, 384) and small-h2's (32, 2,
  1500, 384), timed beside `sdpa` and the bound (the 16-bit tensor-core
  peak); held at 257, 288, 384, 512 and 1024;
- past 65535 (held only): the encoder attention at B*H = 70000 (T = 8) in
  bf16, f16 and f32 at Dh 64 and 288, `log_mel_cuda` on (70000, 800) in
  both DFT types, `transpose_quant_kv` at B = 70000 and at H = 70000, the
  int8 matmul at M = 8,388,481, K = 32.

Each call is held against its plain version (`chip_smoke.KERNEL_REL` of its
largest output; the quantizer's codes bit for bit, the log-mel no less
exact than the plain version against float64). Two checkouts are timed in
one call by running it in turns (parent, change, change, parent):

    python3 tools/torch_encoder_bodies.py --root path/to/checkout --tag parent
    python3 tools/torch_encoder_bodies.py --tag change

--held-only skips the timing (a first check of a build); --no-limits skips
the calls past 65535 (a checkout that refuses them). Prints one JSON line:
the tag, the card's name and power limit, the times (ms per call,
`chip_smoke.cuda_ms`) and every held call's error."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import (KERNEL_REL, bound, check, cuda_ms, enc_attn_op_seconds,  # noqa: E402
                        max_err, mel_exactness, sdpa)

BF, F32, F16 = torch.bfloat16, torch.float32, torch.float16


def views(gen, b, h, t, dh, dtype):
    """(B, H, T, Dh) views of three (B, T, H Dh) projections."""
    return [torch.randn(b, t, h * dh, generator=gen, device=gen.device).to(dtype)
            .view(b, t, h, dh).transpose(1, 2) for _ in range(3)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT), help="checkout whose package runs")
    ap.add_argument("--tag", default="change")
    ap.add_argument("--held-only", action="store_true")
    ap.add_argument("--no-limits", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    for mod in [m for m in sys.modules if m.startswith("openai_whisper_compression_tpu_torch")]:
        del sys.modules[mod]
    from openai_whisper_compression_tpu_torch.ops import kernels
    from openai_whisper_compression_tpu_torch.ops.attention import (
        encoder_attention, encoder_attention_ref)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels.lib()
    gen = torch.Generator(device=dev).manual_seed(21)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    res = {"tag": args.tag, "card": card, "ms": {}, "err": {}}

    def hold(key, q, k, v):
        got = encoder_attention(q, k, v)
        ref = encoder_attention_ref(q, k, v)
        err, tol = max_err(got, ref), KERNEL_REL[q.dtype] * float(ref.float().abs().max())
        check(got.shape == q.shape and bool(torch.isfinite(got).all()) and err <= tol,
              f"{key}: err {err} > {tol}, or not finite")
        res["err"][key] = err
        print(f"{key}: held, err {err:.3g} (bound {tol:.3g})", flush=True)

    def timed(key, q, k, v):
        hold(key, q, k, v)
        if args.held_only:
            return
        b, h, t, dh = q.shape
        flop = 4 * b * h * t * t * dh
        least = bound(4 * b * h * t * dh * q.element_size(), enc_attn_op_seconds(flop, q.dtype))
        t_k = cuda_ms(lambda: encoder_attention(q, k, v))
        t_lib = cuda_ms(lambda: sdpa(q, k, v))
        res["ms"][key] = {"kernel": t_k, "sdpa": t_lib, **least}
        print(f"{key}: kernel {t_k:.4f} ms ({flop / t_k / 1e9:.1f} TFLOP/s) sdpa "
              f"{t_lib:.4f} ms least {least['bound_ms']:.4f} ms ({least['bound_by']})",
              flush=True)

    timed("f32 small (96, 12, 1500, 64)", *views(gen, 96, 12, 1500, 64, F32))
    for dtype in (BF, F16):
        for b in (8, 32):
            timed(f"wide {dtype} ({b}, 2, 1500, 384)", *views(gen, b, 2, 1500, 384, dtype))
    torch.cuda.empty_cache()
    for dh in (16, 32, 64, 128, 256, 8, 36, 100, 200):
        for b, h, t in ((2, 3, 129), (1, 2, 1500), (3, 1, 1)):
            hold(f"f32 ({b}, {h}, {t}, {dh})", *views(gen, b, h, t, dh, F32))
    q, k, v = views(gen, 2, 3, 300, 100, F32)
    hold("f32 odd view", q[:, :, 1:, 1:99], k[:, :, 1:, 1:99], v[:, :, 1:, 1:99])
    for dh in (257, 288, 384, 512, 1024):
        for dtype in (BF, F16):
            for b, h, t in ((2, 3, 129), (2, 2, 1500), (1, 1, 1)):
                hold(f"wide {dtype} ({b}, {h}, {t}, {dh})", *views(gen, b, h, t, dh, dtype))
    torch.cuda.empty_cache()
    if not args.no_limits:
        limits(gen, hold, res)
    print(json.dumps(res), flush=True)
    return 0


def limits(gen, hold, res) -> None:
    """The calls past the grid's 65535 rows, held only."""
    from openai_whisper_compression_tpu_torch.audio import features, mel_kernel
    from openai_whisper_compression_tpu_torch.ops import cross_attention as ca
    from openai_whisper_compression_tpu_torch.ops import quant_matmul as qm

    dev = gen.device
    for dtype in (BF, F16, F32):
        for dh in (64, 288):
            hold(f"limit encoder {dtype} B*H=70000 dh {dh}", *views(gen, 35000, 2, 8, dh, dtype))
    torch.cuda.empty_cache()
    wav = torch.randn(70000, 800, generator=gen, device=dev) * 0.1
    for dtype in (F32, BF):
        got, ref = mel_kernel.log_mel_cuda(wav, 80, dtype), features.log_mel(wav, 80, dtype)
        check(got.shape == (70000, 80, 5), f"mel {dtype}: shape {tuple(got.shape)}")
        err_k, err_p = mel_exactness(f"limit (70000, 800) {dtype}", wav, got, ref, 80, dtype)
        res["err"][f"limit mel {dtype}"] = max_err(got, ref)
    del wav
    for b, h in ((70000, 1), (1, 70000)):
        x = (torch.randn(b, 8, h * 64, generator=gen, device=dev) * 0.4).to(BF)
        got, ref = ca.transpose_quant_kv(x, h), ca.transpose_quant_kv_ref(x, h)
        check(all(torch.equal(a, r) for a, r in zip(got, ref)),
              f"transpose_quant_kv B={b} H={h}: differs from the plain version")
        res["err"][f"limit tq B={b} H={h}"] = 0.0
        print(f"limit transpose_quant_kv B={b} H={h}: codes and scales equal", flush=True)
    del x, got, ref
    torch.cuda.empty_cache()
    m = 65535 * 128 + 1
    x = torch.randn(m, 32, generator=gen, device=dev).to(BF)
    w = torch.randint(-127, 128, (32, 64), generator=gen, device=dev, dtype=torch.int8)
    scale = torch.rand(64, generator=gen, device=dev) * 0.01
    got, ref = qm.int8_matmul(x, w, scale), qm.int8_matmul_ref(x, w, scale)
    err, tol = max_err(got, ref), KERNEL_REL[BF] * float(ref.float().abs().max())
    check(err <= tol, f"int8_matmul M={m}: err {err} > {tol}")
    check(max_err(got[-1:], ref[-1:]) <= tol, f"int8_matmul M={m}: the last row differs")
    res["err"][f"limit int8_matmul M={m}"] = err
    print(f"limit int8_matmul M={m} K=32: held, err {err:.3g} (bound {tol:.3g})", flush=True)


if __name__ == "__main__":
    sys.exit(main())
