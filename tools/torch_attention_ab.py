#!/usr/bin/env python3
"""Time the PyTorch port's attention kernels (PERF.md's rows 7-13: the
one-query and grouped cross-attention, the cross-KV quantizer, the encoder
attention, both cache updates and the read-only self-attention) at head dim
64 (or each of --dims, whisper-small's width of 768 cut into 768 / Dh heads
where the list below says 12 heads, and 1024 / Dh where it says 16), at the
shapes of `chip_smoke.py`'s phase 1, through their public wrappers, on one
CUDA card, for the package of the checkout at --root:

- row 7: the one-query cross-attention at 12 rows over bf16, int8 and int4
  K/V and at 36 rows over bf16, f32 and f16 K/V (s_valid 1500 of 1536);
- row 8: `transpose_quant_kv` at (96, 1500, 768) and (64, 1500, 1024) bf16;
- row 9: the grouped cross-attention at 384 rows, 1 and 8 slots (bf16),
  1152 rows, 1 slot (int8, int4), 192 rows, 1 slot (f32, f16), 384 rows,
  1 slot (f32: at Dh = 128 the 192 rows of batch 32);
- row 10: the encoder attention at (96, 12, 1500, 64) and (64, 16, 1500,
  64) on the strided layout the model hands it;
- rows 11-13: the fp cache update at (384, 64, 64) bf16 pos 30 without and
  with a mixed `start`, f32 and f16 at 192 rows; the int8 update at 1152
  rows pos 30, without and with `start`; the read-only bodies (bf16 at 384
  rows, int8 at 1152) on the caches the updates wrote.

Each result is checked against its plain version first (one step of the
output type, caches and codes bit for bit). Two checkouts are timed in one
call by running it in turns (parent, change, change, parent):

    python3 tools/torch_attention_ab.py --root path/to/checkout --tag parent
    python3 tools/torch_attention_ab.py --dims 16,32,64,128 --tag change

--wide times the WIDE cross-attention body (PERF.md rows 7 and 9 past head
dim 256) at Dh 384, S 1500 of 1536: the one-query call at 6 rows over f32,
bf16 and f16 K/V in q's type and int8 and int4 K/V, and at 66 rows over
bf16 and int8 K/V; the grouped call at 64 rows, one slot, over the same
five, at 64 rows and 5 slots over bf16 K/V, and at 192 rows, one slot,
over bf16 and int8 K/V. With --yardsticks it also times each call's plain
version and, for K/V in q's type, `sdpa` on the same inputs, and prints
each call's bound (`chip_smoke.bound`: K/V up to s_valid, q and the output
moved once, or 4 flop an element at the peak of q's type).

--ragged times, for the checkout's own package, every attention kernel at
the head dims no whole body has (8, 36, 96, 100, 256) as `chip_smoke.py`'s
phase 1 holds them (`phase1_dim`: kernel, plain version, bound, `sdpa`),
and the body of each one's capacity (16, 64, 128, 128, 256: the smallest
whole or 256 body that holds it) at the same heads, rows and S.

Prints one JSON line: the tag, the card's name and power limit, and the
device ms per call (`chip_smoke.cuda_ms`)."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import KERNEL_REL, check, cuda_ms, max_err  # noqa: E402

S_PAD, S_VALID, POS = 1536, 1500, 30
BF, F32, F16 = torch.bfloat16, torch.float32, torch.float16


def held(key: str, got, ref) -> None:
    outs = got if isinstance(got, tuple) else (got,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    for a, b in zip(outs, refs):
        if a.dtype in (torch.int8,) or key.startswith("tq"):
            check(torch.equal(a, b), f"{key}: differs from its plain version")
        else:
            err, tol = max_err(a, b), KERNEL_REL[a.dtype] * float(b.float().abs().max())
            check(err <= tol, f"{key}: err {err} > {tol}")


def kv(gen, kind: str, bh: int, dtype=BF, dh: int = 64) -> tuple:
    dev = gen.device
    if kind == "fp":
        return (*(torch.randn(bh, dh, S_PAD, generator=gen, device=dev).to(dtype)
                  for _ in range(2)), None, None)
    rows, lo = (dh, -127) if kind == "int8" else (dh // 2, -128)
    codes = [torch.randint(lo, 128, (bh, rows, S_PAD), generator=gen, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand(bh, 1, S_PAD, generator=gen, device=dev) * 0.03 + 1e-3
              for _ in range(2)]
    return (*codes, *scales)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose openai_whisper_compression_tpu_torch is timed")
    ap.add_argument("--tag", default="this", help="name printed with the result")
    ap.add_argument("--dims", default="64", help="head dims to time, comma separated")
    ap.add_argument("--ragged", action="store_true",
                    help="time the ragged head dims against their capacities' bodies")
    ap.add_argument("--wide", action="store_true",
                    help="time the WIDE cross-attention body at Dh 384")
    ap.add_argument("--yardsticks", action="store_true",
                    help="with --wide: also time the plain versions and sdpa")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from openai_whisper_compression_tpu_torch.models.whisper import split_heads
    from openai_whisper_compression_tpu_torch.ops import attention as att
    from openai_whisper_compression_tpu_torch.ops import cross_attention as ca
    from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"tag": args.tag, "root": args.root,
           "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True, check=True).stdout.strip().splitlines()[0]}

    def case(key, call, plain):
        held(key, call(), plain())
        res[key] = cuda_ms(call)
        print(f"{args.tag} {key}: {res[key]:.4f} ms", flush=True)

    if args.ragged:
        return ragged(args.tag, dev, res)
    if args.wide:
        wide(gen, case, res, ca, args.yardsticks)
        print(json.dumps(res), flush=True)
        return 0
    for dh in map(int, args.dims.split(",")):
        whole_dim(dh, dev, gen, case, res, args.tag, split_heads, att, ca, sas)
    print(json.dumps(res), flush=True)
    return 0


WIDE_DH = 384
# (call, rows, slots, K/V kind, q type) of --wide
WIDE_CALLS = ([("one_query", 6, 1, kind, dtype) for kind, dtype in
               (("fp", F32), ("fp", BF), ("fp", F16), ("int8", BF), ("int4", BF))]
              + [("one_query", 66, 1, kind, BF) for kind in ("fp", "int8")]
              + [("grouped", 64, 1, kind, dtype) for kind, dtype in
                 (("fp", F32), ("fp", BF), ("fp", F16), ("int8", BF), ("int4", BF))]
              + [("grouped", 64, 5, "fp", BF), ("grouped", 192, 1, "fp", BF),
                 ("grouped", 192, 1, "int8", BF)])


def wide(gen, case, res: dict, ca, yardsticks: bool) -> None:
    """The WIDE cross-attention calls of `WIDE_CALLS`, each held and timed
    (`case`); with `yardsticks` also its plain version, `sdpa` (K/V in q's
    type) and its bound, under the call's key + " plain", " sdpa",
    " bound"."""
    from chip_smoke import bound, nbytes, peak_flops, sdpa

    dev, dh = gen.device, WIDE_DH
    for call, bh, kq, kind, dtype in WIDE_CALLS:
        one = call == "one_query"
        q = (torch.randn(*((bh, dh) if one else (bh, kq, dh)), generator=gen, device=dev)
             * dh ** -0.5).to(dtype)
        k = kv(gen, kind, bh, dtype, dh)
        fn, plain = ((ca.decode_cross_attention, ca.decode_cross_attention_ref) if one else
                     (ca.decode_cross_attention_grouped,
                      ca.decode_cross_attention_grouped_ref))
        key = f"wide {call} {kind} {str(dtype)[6:]} {bh}rows K={kq}"
        case(key, lambda: fn(q, *k, S_VALID), lambda: plain(q, *k, S_VALID))
        if yardsticks:
            res[key + " plain"] = cuda_ms(lambda: plain(q, *k, S_VALID))
            moved = 2 * nbytes(q) + S_VALID / S_PAD * nbytes(*k)
            res[key + " bound"] = bound(moved, 4 * bh * kq * dh * S_VALID / peak_flops(dtype))
            if kind == "fp":
                kk, vv = (t[:, :, :S_VALID].transpose(1, 2) for t in k[:2])
                q3 = q[:, None, :] if one else q
                res[key + " sdpa"] = cuda_ms(lambda: sdpa(q3, kk, vv, scale=1.0))
            print(f"{key}: plain {res[key + ' plain']:.4f} ms, sdpa "
                  f"{res.get(key + ' sdpa')}, bound {res[key + ' bound']}", flush=True)
        del q, k
        torch.cuda.empty_cache()


def ragged(tag: str, dev, res: dict) -> int:
    """`chip_smoke.phase1_dim` timed at each ragged head dim and at its
    capacity with the same heads; one JSON line of both."""
    import chip_smoke
    from openai_whisper_compression_tpu_torch.ops import kernels

    for dh in chip_smoke.RAGGED_DIMS:
        cap, heads = kernels.head_dim_capacity(dh), chip_smoke.WIDTH // dh
        for width in (dh, cap):
            out: dict = {}
            chip_smoke.phase1_dim(dev, torch.Generator(device=dev).manual_seed(dh), width,
                                  out, timed=True, heads=heads)
            res[f"dh{dh}" + ("" if width == dh else f" at capacity {cap}")] = out
    print(json.dumps(res), flush=True)
    return 0


def whole_dim(dh: int, dev, gen, case, res: dict, tag: str, split_heads, att, ca,
              sas) -> None:
    """Rows 7-13 at head dim dh: 768 // dh heads where Dh = 64 has 12, 1024 //
    dh where it has 16; the keys name dh where it is not 64."""
    H = 768 // dh
    sfx = "" if dh == 64 else f" dh{dh}"
    scale = dh ** -0.5
    for bh, kind, dtype in ((H, "fp", BF), (H, "int8", BF), (H, "int4", BF),
                            (3 * H, "fp", BF), (3 * H, "fp", F32), (3 * H, "fp", F16)):
        q = (torch.randn(bh, dh, generator=gen, device=dev) * scale).to(dtype)
        k = kv(gen, kind, bh, dtype, dh)
        case(f"row7 one_query {kind} {str(dtype)[6:]} {bh}rows{sfx}",
             lambda: ca.decode_cross_attention(q, *k, S_VALID),
             lambda: ca.decode_cross_attention_ref(q, *k, S_VALID))
    for b, h in ((96, H), (64, 1024 // dh)):
        x = (torch.randn(b, S_VALID, h * dh, generator=gen, device=dev) * 0.4).to(BF)
        case(f"tq ({b}, {S_VALID}, {h * dh}){sfx}", lambda: ca.transpose_quant_kv(x, h),
             lambda: ca.transpose_quant_kv_ref(x, h))
        del x
    for bh, kq, kind, dtype in ((32 * H, 1, "fp", BF), (32 * H, 8, "fp", BF),
                                (96 * H, 1, "int8", BF), (96 * H, 1, "int4", BF),
                                (16 * H, 1, "fp", F32), (32 * H, 1, "fp", F32),
                                (16 * H, 1, "fp", F16)):
        q = (torch.randn(bh, kq, dh, generator=gen, device=dev) * scale).to(dtype)
        k = kv(gen, kind, bh, dtype, dh)
        case(f"row9 grouped {kind} {str(dtype)[6:]} {bh}rows K={kq}{sfx}",
             lambda: ca.decode_cross_attention_grouped(q, *k, S_VALID),
             lambda: ca.decode_cross_attention_grouped_ref(q, *k, S_VALID))
        del k
    torch.cuda.empty_cache()
    for b, h in ((96, H), (64, 1024 // dh)):
        q, k, v = (split_heads(torch.randn(b, S_VALID, h * dh, generator=gen, device=dev)
                               .to(BF), h) for _ in range(3))
        # held on 8 of the batch (the plain version's scores of all of it at
        # Dh = 16 would not fit in device memory), timed on all of it
        got, ref = (fn(q[:8], k[:8], v[:8]) for fn in (att.encoder_attention,
                                                         att.encoder_attention_ref))
        held(f"row10 ({b}, {h}){sfx}", got, ref)
        del got, ref
        key = f"row10 encoder ({b}, {h}, {S_VALID}, {dh})"
        res[key] = cuda_ms(lambda: att.encoder_attention(q, k, v))
        print(f"{tag} {key}: {res[key]:.4f} ms", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    for bh, dtype, with_start in ((32 * H, BF, False), (32 * H, BF, True), (16 * H, F32, False),
                                  (16 * H, F16, False)):
        start = ((torch.arange(bh, device=dev) // H * 5 % 13).to(torch.int32)
                 if with_start else None)
        q = (torch.randn(bh, dh, generator=gen, device=dev) * scale).to(dtype)
        kn, vn = (torch.randn(2, bh, dh, generator=gen, device=dev) * 2).to(dtype)
        bufs = [torch.randn(bh, 64, dh, generator=gen, device=dev).to(dtype) for _ in range(2)]
        refs = [t.clone() for t in bufs]
        key = (f"row11 fp update {str(dtype)[6:]} {bh}rows" + (" start" if with_start else "")
               + sfx)
        out = sas.decode_self_attention_update(q, kn, vn, *bufs, POS, start=start)
        held(key, out, sas.decode_self_attention_update_ref(q, kn, vn, *refs, POS, start))
        check(all(torch.equal(a, b) for a, b in zip(bufs, refs)), f"{key}: caches differ")
        res[key] = cuda_ms(lambda: sas.decode_self_attention_update(q, kn, vn, *bufs, POS,
                                                                    start=start))
        print(f"{tag} {key}: {res[key]:.4f} ms", flush=True)
        if dtype == BF and not with_start:
            check(torch.equal(sas.decode_self_attention(q, *bufs, POS), out),
                  "row12 bf16: differs from the update's output")
            res[f"row12 read-only bf16 {bh}rows{sfx}"] = cuda_ms(
                lambda: sas.decode_self_attention(q, *bufs, POS))
    for with_start in (False, True):
        bh = 96 * H
        start = ((torch.arange(bh, device=dev) // H * 5 % 13).to(torch.int32)
                 if with_start else None)
        q = (torch.randn(bh, dh, generator=gen, device=dev) * scale).to(BF)
        kn, vn = (torch.randn(2, bh, dh, generator=gen, device=dev) * 2).to(BF)
        kc, vc = torch.randint(-127, 128, (2, bh, 64, dh), generator=gen, device=dev,
                               dtype=torch.int8)
        ks, vs = torch.rand(2, bh, 64, generator=gen, device=dev) * 0.03 + 1e-3
        bufs, refs = [kc, vc, ks, vs], [t.clone() for t in (kc, vc, ks, vs)]
        key = f"row13 int8 update {bh}rows" + (" start" if with_start else "") + sfx
        out = sas.decode_self_attention_update_int8(q, kn, vn, *bufs, POS, start=start)
        held(key, out, sas.decode_self_attention_update_int8_ref(q, kn, vn, *refs, POS,
                                                                 start))
        check(all(torch.equal(a, b) for a, b in zip(bufs, refs)), f"{key}: caches differ")
        res[key] = cuda_ms(lambda: sas.decode_self_attention_update_int8(
            q, kn, vn, *bufs, POS, start=start))
        print(f"{tag} {key}: {res[key]:.4f} ms", flush=True)
        if not with_start:
            check(torch.equal(sas.decode_self_attention(q, kc, vc, POS, k_scale=ks,
                                                        v_scale=vs), out),
                  "row12 int8: differs from the update's output")
            res[f"row12 read-only int8 {bh}rows{sfx}"] = cuda_ms(
                lambda: sas.decode_self_attention(q, kc, vc, POS, k_scale=ks, v_scale=vs))


if __name__ == "__main__":
    sys.exit(main())
