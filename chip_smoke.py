#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py              # from the repository root
    python3 chip_smoke.py --profile    # also torch.profiler kernel tables

Phase 0  prints the card and its power limit, builds the CUDA kernels from
         `openai_whisper_compression_tpu_torch/csrc` (nvcc, sm_90a, one
         process per source).
Phase 1  each kernel against its plain PyTorch version on the card, at
         main-path shapes (whisper-small batch 32 for slice 1's four
         kernels, batch 96 for the int8/int4-KV kernels; for the int4,
         NF4/FP4 and HQQ dequant-matmuls, the decoder linears of the
         phase-2 run of each kind at M = batch and 3 x batch, and
         whisper-medium's at M = 64 and 256), with CUDA-event times; the
         dequant-matmuls also beside dequant + torch.matmul.
Phase 2  decode runs at full width with seeded random bf16 weights, fused
         decoder qkv, `make_transcribe_fn` (bf16 DFT mel, tanh encoder
         GELU, greedy 25 tokens) on seeded synthetic 30 s waveforms:
           bf16-kv      whisper-small, int8 weights, batch 32, bf16
                        self-KV and cross-KV (slice 1);
           int8-kv      whisper-small, int8 weights, batch 96, int8 self-KV
                        and int8 cross-KV (`bench.py`'s headline decode);
           int4-ckv     the same with int4 cross-KV (one batch);
           medium-int4  whisper-medium, int4 weights, batch 64, int8
                        self-KV and cross-KV (`bench.py --presets`'
                        medium_int4_kv8 row);
           small-nf4dq, small-hqq4, small-hqq8  whisper-small, batch 32,
                        int8 self-KV and cross-KV, with the REGISTRY's
                        bnb_nf4_double_quant, hqq_int4 and hqq_int8 weights
                        (one batch each).
         bf16-kv and int8-kv run three batches with EOT suppressed, then
         the first batch again with EOT allowed and its embedding tied to
         a generated token, so that rows stop at different steps;
         medium-int4 runs three batches with EOT suppressed. Every launch
         count is set to 0 before a run and read after it: each kernel of
         the run's path must have launched, and no other.
Phase 3  first-step logits of 2 utterances, card (bf16, kernels) against
         the same port run on the CPU in f32 (plain versions): whisper-small
         int8 weights with bf16 caches and with the int8 self-KV and
         cross-KV, and int4, NF4 double-quant and HQQ int4 weights with the
         int8 caches.

Any failure exits nonzero. On success the last stdout line is
{"ok": true, "device": {...}}; the line before it lists every kernel with
its launch count, error and times. Needs torch with CUDA, numpy and nvcc;
never imports jax.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
ARCH = "small"
BATCH = 32        # slice 1's phase-1 shapes, its bf16-KV run, the small 4-bit runs
HEAD_BATCH = 96   # bench.py's headline batch (int8 self-KV and cross-KV)
MEDIUM_BATCH = 64  # bench.py --presets' medium_int4_kv8 batch
AUDIO_S = 30.0
CSRC = "openai_whisper_compression_tpu_torch/csrc/"
JAX_PKG = "openai_whisper_compression_tpu/"
# every kernel: (entry name, wrapper module, wrapper, launch counter
# attribute, source file, the TPU kernel it replaces, phase-1 result key)
KERNELS = [
    ("log_mel_cuda", "audio.mel_kernel", "log_mel_cuda", "launches",
     "mel.cu", "audio/mel_pallas.py:62", "mel"),
    ("int8_matmul", "ops.quant_matmul", "int8_matmul", "launches",
     "quant_matmul.cu", "ops/quant_matmul.py:55", "int8_matmul"),
    ("decode_cross_attention_grouped", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches", "cross_attention.cu",
     "ops/cross_attention.py:321", "cross"),
    ("decode_self_attention_update", "ops.self_attention_step",
     "decode_self_attention_update", "launches", "self_attention_step.cu",
     "ops/self_attention_step.py:245", "self"),
    ("transpose_quant_kv", "ops.cross_attention", "transpose_quant_kv",
     "launches", "transpose_quant.cu", "ops/cross_attention.py:248", "tq"),
    ("decode_cross_attention_grouped_int8", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches_int8", "cross_attention.cu",
     "ops/cross_attention.py:306", "cross_int8"),
    ("decode_cross_attention_grouped_int4", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches_int4", "cross_attention.cu",
     "ops/cross_attention.py:313", "cross_int4"),
    ("decode_self_attention_update_int8", "ops.self_attention_step",
     "decode_self_attention_update_int8", "launches", "self_attention_step.cu",
     "ops/self_attention_step.py:386", "self_int8"),
    ("int4_matmul", "ops.quant_matmul", "int4_matmul", "launches",
     "quant_matmul.cu", "ops/quant_matmul.py:92", "int4"),
    ("nf4_matmul", "ops.quant_matmul", "nf4_matmul", "launches",
     "quant_matmul.cu", "ops/quant_matmul.py:212", "nf4"),
    ("group_asym_matmul", "ops.quant_matmul", "group_asym_matmul", "launches",
     "quant_matmul.cu", "ops/quant_matmul.py:260", "hqq"),
    ("group_asym_matmul_u8", "ops.quant_matmul", "group_asym_matmul",
     "launches_u8", "quant_matmul.cu", "ops/quant_matmul.py:260", "hqq_u8"),
]
KV8 = {"kv_int8": True, "cross_kv_int8": True}
DECODE_KERNELS = ("log_mel_cuda", "transpose_quant_kv",
                  "decode_cross_attention_grouped_int8",
                  "decode_self_attention_update_int8")
# phase-2 runs: (name, arch, weight quantization, DecodeConfig switches,
# batch, batches with EOT suppressed, EOT-allowed batch after them, kernels
# of the path); the entry of KERNELS reports the launch count of the first
# run whose path holds it
RUNS = [
    ("bf16-kv", ARCH, "int8", {}, BATCH, 3, True,
     ("log_mel_cuda", "int8_matmul", "decode_cross_attention_grouped",
      "decode_self_attention_update")),
    ("int8-kv", ARCH, "int8", KV8, HEAD_BATCH, 3, True,
     ("int8_matmul",) + DECODE_KERNELS),
    ("int4-ckv", ARCH, "int8", {"kv_int8": True, "cross_kv_int4": True},
     HEAD_BATCH, 1, False,
     ("log_mel_cuda", "int8_matmul", "decode_cross_attention_grouped_int4",
      "decode_self_attention_update_int8")),
    ("medium-int4", "medium", "int4", KV8, MEDIUM_BATCH, 3, False,
     ("int4_matmul",) + DECODE_KERNELS),
    ("small-nf4dq", ARCH, "bnb_nf4_double_quant", KV8, BATCH, 1, False,
     ("nf4_matmul",) + DECODE_KERNELS),
    ("small-hqq4", ARCH, "hqq_int4", KV8, BATCH, 1, False,
     ("group_asym_matmul",) + DECODE_KERNELS),
    ("small-hqq8", ARCH, "hqq_int8", KV8, BATCH, 1, False,
     ("group_asym_matmul_u8",) + DECODE_KERNELS),
]
# phase-3 configurations: (name, weight quantization, DecodeConfig switches)
LOGIT_RUNS = [("int8 bf16-kv", "int8", {}), ("int8 int8-kv", "int8", KV8),
              ("int4 int8-kv", "int4", KV8),
              ("nf4-dq int8-kv", "bnb_nf4_double_quant", KV8),
              ("hqq-int4 int8-kv", "hqq_int4", KV8)]
# phase-1 4-bit weight kinds: (label, quantize_params method, wrapper key,
# the RUNS entry whose decoder linears give the shapes; the kinds on no
# run's path take the run of their kernel)
FOUR_BIT = [("int4", "int4", "int4", "medium-int4"),
            ("nf4", "nf4", "nf4", "small-nf4dq"),
            ("fp4-dq", "fp4_dq", "nf4", "small-nf4dq"),
            ("hqq4", "hqq_int4", "hqq", "small-hqq4"),
            ("hqq3", "hqq_int3", "hqq", "small-hqq4"),
            ("hqq8", "hqq_int8", "hqq_u8", "small-hqq8")]

# Tolerances, card kernel vs plain version on identical inputs (the plain
# versions compute in f32 from the same bf16-rounded operands):
# - mel: f32 sums in another order, then log10 and /4, on log-mel values of
#   order 1: 1e-5 absolute (sound runs read ~1e-7; a power spectrum or mel
#   product kept in bf16 would be off by 1e-4 or more).
MEL_ATOL = 1e-5
# - bf16 outputs (int8 matmul, attention): the two sides round f32 values
#   that differ only by sum order, so they differ by at most one bf16 step
#   (2**-8 to 2**-7 of the value): 2**-7 of the reference's own largest
#   magnitude.
BF16_REL = 2.0 ** -7
# - slice, card bf16 vs CPU f32 first-step logits: bf16 activations (2**-9
#   relative rounding per op) through 24 residual blocks, int8 weights equal
#   on both sides; a few percent expected, while a layout or indexing fault
#   gives an error of order 1.
LOGITS_REL_L2 = 0.1


def check(cond, msg) -> None:
    """Fail the run (explicitly, so that `python -O` cannot drop it)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time per call over `iters` back-to-back calls. A spin
    kernel (~25 ms) runs first, so the host has enqueued every call before
    the timed region starts: the events then time the device, not the
    Python wrapper's launch rate (which bounds a 10 µs kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def phase1(dev, results: dict) -> None:
    from openai_whisper_compression_tpu_torch.audio import features
    from openai_whisper_compression_tpu_torch.audio.mel_kernel import log_mel_cuda
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        decode_cross_attention_grouped, decode_cross_attention_grouped_ref)
    from openai_whisper_compression_tpu_torch.ops.qtensor import dequantize
    from openai_whisper_compression_tpu_torch.ops.quant_matmul import (
        int8_matmul, int8_matmul_ref)
    from openai_whisper_compression_tpu_torch.ops.self_attention_step import (
        decode_self_attention_update, decode_self_attention_update_ref)
    from openai_whisper_compression_tpu_torch.quant.core import quantize_int8

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16

    # mel: 32 x 30 s, bf16 DFT (fast_mel)
    wav = torch.randn(BATCH, 480_000, generator=gen, device=dev) * 0.1
    got = log_mel_cuda(wav, 80, bf16)
    ref = features.log_mel(wav, 80, bf16)
    err = max_err(got, ref)
    check(got.shape == (BATCH, 80, 3000) and err <= MEL_ATOL,
          f"mel err {err}")
    results["mel"] = {"max_abs_err": err,
                      "ms": cuda_ms(lambda: log_mel_cuda(wav, 80, bf16)),
                      "plain_ms": cuda_ms(lambda: features.log_mel(wav, 80, bf16))}
    log(f"phase1 mel ({BATCH}, 480000) bf16 DFT: err {err:.3g} (bound {MEL_ATOL:g}) "
        f"kernel {results['mel']['ms']:.4f} ms plain {results['mel']['plain_ms']:.4f} ms")
    del wav

    # int8 matmul at every decoder linear shape, M = B (step) and 3B (prefill)
    errs, rows = [], []
    for k, n, what in ((768, 2304, "qkv"), (768, 768, "o/cross q/cross o"),
                       (768, 3072, "fc1"), (3072, 768, "fc2")):
        q = quantize_int8(torch.randn(k, n, generator=gen, device=dev) * 0.02)
        for m in (BATCH, 3 * BATCH):
            x = torch.randn(m, k, generator=gen, device=dev).to(bf16)
            got = int8_matmul(x, q.data, q.scale)
            ref = int8_matmul_ref(x, q.data, q.scale)
            err, bound = max_err(got, ref), BF16_REL * float(ref.float().abs().max())
            check(err <= bound, f"int8_matmul M={m} K={k} N={n}: err {err} > {bound}")
            errs.append(err)
            t_k = cuda_ms(lambda: int8_matmul(x, q.data, q.scale))
            t_p = cuda_ms(lambda: int8_matmul_ref(x, q.data, q.scale))
            t_d = cuda_ms(lambda: torch.matmul(x, dequantize(q, bf16)))
            rows.append((m, k, n, what, err, t_k, t_p, t_d))
            log(f"phase1 int8_matmul M={m} K={k} N={n} ({what}): err {err:.3g} "
                f"(bound {bound:.3g}) "
                f"kernel {t_k:.4f} ms plain {t_p:.4f} ms "
                f"dequant+torch.matmul {t_d:.4f} ms")
    qkv32 = rows[0]
    results["int8_matmul"] = {"max_abs_err": max(errs), "ms": qkv32[5],
                              "plain_ms": qkv32[6]}

    # grouped cross-attention: K = 1 (step) and K = 3 (prefill)
    bh, s_pad, s_valid = BATCH * 12, 1536, 1500
    k_t = torch.randn(bh, 64, s_pad, generator=gen, device=dev).to(bf16)
    v_t = torch.randn(bh, 64, s_pad, generator=gen, device=dev).to(bf16)
    errs = []
    for kq in (1, 3):
        qg = (torch.randn(bh, kq, 64, generator=gen, device=dev) * 0.125).to(bf16)
        got = decode_cross_attention_grouped(qg, k_t, v_t, s_valid=s_valid)
        ref = decode_cross_attention_grouped_ref(qg, k_t, v_t, s_valid=s_valid)
        err, bound = max_err(got, ref), BF16_REL * float(ref.float().abs().max())
        check(err <= bound, f"cross attention K={kq}: err {err} > {bound}")
        errs.append(err)
        t_k = cuda_ms(lambda: decode_cross_attention_grouped(
            qg, k_t, v_t, s_valid=s_valid))
        t_p = cuda_ms(lambda: decode_cross_attention_grouped_ref(
            qg, k_t, v_t, s_valid=s_valid))
        if kq == 1:
            results["cross"] = {"ms": t_k, "plain_ms": t_p}
        log(f"phase1 cross_attention_grouped K={kq} ({bh}, 64, {s_pad}) "
            f"s_valid {s_valid}: err {err:.3g} (bound {bound:.3g}) "
            f"kernel {t_k:.4f} ms plain {t_p:.4f} ms")
    results["cross"]["max_abs_err"] = max(errs)
    del k_t, v_t

    # self-attention update over a 64-row bf16 cache
    kc0 = torch.randn(bh, 64, 64, generator=gen, device=dev).to(bf16)
    vc0 = torch.randn(bh, 64, 64, generator=gen, device=dev).to(bf16)
    errs = []
    for pos in (3, 30, 63):
        qf = (torch.randn(bh, 64, generator=gen, device=dev) * 0.125).to(bf16)
        kn = torch.randn(bh, 64, generator=gen, device=dev).to(bf16)
        vn = torch.randn(bh, 64, generator=gen, device=dev).to(bf16)
        kc, vc, kr, vr = kc0.clone(), vc0.clone(), kc0.clone(), vc0.clone()
        got = decode_self_attention_update(qf, kn, vn, kc, vc, pos)
        ref = decode_self_attention_update_ref(qf, kn, vn, kr, vr, pos)
        err, bound = max_err(got, ref), BF16_REL * float(ref.float().abs().max())
        check(torch.equal(kc, kr) and torch.equal(vc, vr),
              f"self attention pos={pos}: cache rows differ")
        check(err <= bound, f"self attention pos={pos}: err {err} > {bound}")
        errs.append(err)
        t_k = cuda_ms(lambda: decode_self_attention_update(qf, kn, vn, kc, vc, pos))
        t_p = cuda_ms(lambda: decode_self_attention_update_ref(qf, kn, vn, kr, vr, pos))
        if pos == 30:
            results["self"] = {"ms": t_k, "plain_ms": t_p}
        log(f"phase1 self_attention_update pos={pos} ({bh}, 64, 64): err {err:.3g} "
            f"(bound {bound:.3g}) "
            f"cache rows equal; kernel {t_k:.4f} ms plain {t_p:.4f} ms")
    results["self"]["max_abs_err"] = max(errs)


def phase1_quantized(dev, results: dict) -> None:
    """The int8/int4-KV kernels at the shapes of bench.py's batch 96."""
    from openai_whisper_compression_tpu_torch.models.whisper import _quant_kv4_t
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        decode_cross_attention_grouped, decode_cross_attention_grouped_ref,
        transpose_kv, transpose_quant_kv, transpose_quant_kv_ref)
    from openai_whisper_compression_tpu_torch.ops.self_attention_step import (
        decode_self_attention_update_int8, decode_self_attention_update_int8_ref)

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf16 = torch.bfloat16
    b, s, h = HEAD_BATCH, 1500, 12
    bh = b * h

    # transpose + int8 quantize of a cross K and a cross V projection
    xk, xv = ((torch.randn(b, s, h * 64, generator=gen, device=dev) * 0.4).to(bf16)
              for _ in range(2))
    k8, ks8 = transpose_quant_kv(xk, h)
    ref_k, ref_ks = transpose_quant_kv_ref(xk, h)
    check(torch.equal(k8, ref_k) and torch.equal(ks8, ref_ks),
          "transpose_quant_kv: codes or scales differ from the plain version")
    v8, vs8 = transpose_quant_kv(xv, h)
    t_k = cuda_ms(lambda: transpose_quant_kv(xk, h))
    t_p = cuda_ms(lambda: transpose_quant_kv_ref(xk, h))
    results["tq"] = {"max_abs_err": max(max_err(k8, ref_k), max_err(ks8, ref_ks)),
                     "ms": t_k, "plain_ms": t_p}
    log(f"phase1 transpose_quant_kv ({b}, {s}, {h * 64}) bf16 -> ({bh}, 64, "
        f"{k8.shape[2]}) int8: codes and scales equal; kernel {t_k:.4f} ms "
        f"plain {t_p:.4f} ms")
    del ref_k, ref_ks
    k4, ks4 = _quant_kv4_t(transpose_kv(xk, h))
    v4, vs4 = _quant_kv4_t(transpose_kv(xv, h))
    t_q4 = cuda_ms(lambda: _quant_kv4_t(transpose_kv(xk, h)))
    log(f"phase1 int4 cross-KV transpose + quantize + pack ({b}, {s}, "
        f"{h * 64}) bf16, plain torch (no kernel, as in the JAX package): "
        f"{t_q4:.4f} ms")
    del xk, xv

    # int8 and int4 grouped cross-attention, K = 1 (step) and K = 3 (prefill)
    for key, what, kv in (("cross_int8", "int8", (k8, v8, ks8, vs8)),
                          ("cross_int4", "int4", (k4, v4, ks4, vs4))):
        errs = []
        for kq in (1, 3):
            qg = (torch.randn(bh, kq, 64, generator=gen, device=dev) * 0.125).to(bf16)
            got = decode_cross_attention_grouped(qg, *kv, s)
            ref = decode_cross_attention_grouped_ref(qg, *kv, s)
            err, bound = max_err(got, ref), BF16_REL * float(ref.float().abs().max())
            check(err <= bound, f"cross attention {what} K={kq}: err {err} > {bound}")
            errs.append(err)
            t_k = cuda_ms(lambda: decode_cross_attention_grouped(qg, *kv, s))
            t_p = cuda_ms(lambda: decode_cross_attention_grouped_ref(qg, *kv, s))
            if kq == 1:
                results[key] = {"ms": t_k, "plain_ms": t_p}
            log(f"phase1 cross_attention_grouped {what} K={kq} "
                f"{tuple(kv[0].shape)} s_valid {s}: err {err:.3g} (bound "
                f"{bound:.3g}) kernel {t_k:.4f} ms plain {t_p:.4f} ms")
        results[key]["max_abs_err"] = max(errs)
    del k8, v8, k4, v4

    # int8 self-attention update over a 64-row int8 cache
    kc0, vc0 = torch.randint(-127, 128, (2, bh, 64, 64), generator=gen,
                             device=dev, dtype=torch.int8)
    ks0, vs0 = torch.rand(2, bh, 64, generator=gen, device=dev) * 0.03 + 1e-3
    errs = []
    for pos in (3, 30, 63):
        qf = (torch.randn(bh, 64, generator=gen, device=dev) * 0.125).to(bf16)
        kn, vn = (torch.randn(2, bh, 64, generator=gen, device=dev) * 2).to(bf16)
        bufs = [t.clone() for t in (kc0, vc0, ks0, vs0)]
        refs = [t.clone() for t in (kc0, vc0, ks0, vs0)]
        got = decode_self_attention_update_int8(qf, kn, vn, *bufs, pos)
        ref = decode_self_attention_update_int8_ref(qf, kn, vn, *refs, pos)
        err, bound = max_err(got, ref), BF16_REL * float(ref.float().abs().max())
        check(all(torch.equal(a, r) for a, r in zip(bufs, refs)),
              f"self attention int8 pos={pos}: cache rows or scales differ")
        check(err <= bound, f"self attention int8 pos={pos}: err {err} > {bound}")
        errs.append(err)
        t_k = cuda_ms(lambda: decode_self_attention_update_int8(qf, kn, vn, *bufs, pos))
        t_p = cuda_ms(lambda: decode_self_attention_update_int8_ref(qf, kn, vn, *refs, pos))
        if pos == 30:
            results["self_int8"] = {"ms": t_k, "plain_ms": t_p}
        log(f"phase1 self_attention_update_int8 pos={pos} ({bh}, 64, 64): err "
            f"{err:.3g} (bound {bound:.3g}) cache rows and scales equal; "
            f"kernel {t_k:.4f} ms plain {t_p:.4f} ms")
    results["self_int8"]["max_abs_err"] = max(errs)


def linear_shapes(arch) -> tuple:
    """(K, N, what) of every decoder linear of `arch` (fused qkv)."""
    d, f = arch.d_model, arch.ffn_dim
    return ((d, 3 * d, "qkv"), (d, d, "o/cross q/cross o"), (d, f, "fc1"),
            (f, d, "fc2"))


def phase1_4bit(dev, results: dict) -> None:
    """The int4, NF4/FP4 and HQQ dequant-matmuls against their plain
    versions and beside dequant + torch.matmul, on the weights and calls
    `linear` makes (`kernel_call`): at the decoder linears of the phase-2
    run of each kind, M = batch (a decode step) and 3 x batch (the prefill
    of three prefix tokens), and at whisper-medium's linears, M = 64 and
    256, for every kind."""
    from openai_whisper_compression_tpu_torch.config import ARCHS
    from openai_whisper_compression_tpu_torch.ops.linear import kernel_call
    from openai_whisper_compression_tpu_torch.ops.qtensor import dequantize
    from openai_whisper_compression_tpu_torch.quant.core import QUANTIZERS

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    bf16 = torch.bfloat16
    runs = {r[0]: r for r in RUNS}
    counter = {key: (fn, attr) for _, _, fn, attr, _, _, key in KERNELS}
    weights, xs = {}, {}
    for label, method, key, run_name in FOUR_BIT:
        _, arch_name, _, _, batch = runs[run_name][:5]
        step = (arch_name, batch)   # the kernels line reports its qkv
        cases = dict.fromkeys([step, (arch_name, 3 * batch),
                               ("medium", MEDIUM_BATCH), ("medium", 256)])
        errs = []
        for arch_name, m in cases:
            for k, n, what in linear_shapes(ARCHS[arch_name]):
                if (k, n) not in weights:
                    weights[k, n] = torch.randn(k, n, generator=gen, device=dev) * 0.02
                if (m, k) not in xs:
                    xs[m, k] = torch.randn(m, k, generator=gen, device=dev).to(bf16)
                q, x = QUANTIZERS[method](weights[k, n]), xs[m, k]
                call = kernel_call(q)
                check(call is not None, f"{label} K={k}: no kernel on the card")
                fn, plain_fn, args = call
                kernel, plain = (lambda: fn(x, *args)), (lambda: plain_fn(x, *args))
                before = getattr(fn, counter[key][1])
                got, ref = kernel(), plain()
                check(fn.__name__ == counter[key][0]
                      and getattr(fn, counter[key][1]) == before + 1,
                      f"{label}: linear does not launch {'.'.join(counter[key])}")
                err = max_err(got, ref)
                bound = BF16_REL * float(ref.float().abs().max())
                check(got.shape == (m, n) and err <= bound,
                      f"{label} {arch_name} M={m} K={k} N={n}: err {err} > {bound}")
                errs.append(err)
                t_k, t_p = cuda_ms(kernel), cuda_ms(plain)
                t_d = cuda_ms(lambda: torch.matmul(x, dequantize(q, bf16)))
                if (arch_name, m, what) == (*step, "qkv") and key not in results:
                    results[key] = {"ms": t_k, "plain_ms": t_p}
                log(f"phase1 {label} {arch_name} M={m} K={k} N={n} ({what}): err "
                    f"{err:.3g} (bound {bound:.3g}) kernel {t_k:.4f} ms plain "
                    f"{t_p:.4f} ms dequant+torch.matmul {t_d:.4f} ms")
        results[key]["max_abs_err"] = max(errs + [results[key].get("max_abs_err", 0.0)])


def make_params(dev, arch_name: str, method: str):
    """Seeded random bf16 weights of `arch_name`, `quantize_params(method)`
    (a QUANTIZERS method or a REGISTRY name), decoder qkv fused."""
    from openai_whisper_compression_tpu_torch.config import ARCHS
    from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
    from openai_whisper_compression_tpu_torch.models.params import init_params
    from openai_whisper_compression_tpu_torch.quant.api import quantize_params

    arch = ARCHS[arch_name]
    params = init_params(arch, seed=SEED, dtype=torch.bfloat16, device=dev)
    return arch, fuse_qkv(quantize_params(params, method))


def waveforms(seed: int, batch: int) -> np.ndarray:
    """Seeded synthetic 30 s batch: noise under a few drifting tones."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(AUDIO_S * 16000), dtype=np.float32) / 16000.0
    f0 = rng.uniform(100.0, 300.0, size=(batch, 1)).astype(np.float32)
    tone = 0.3 * np.sin(2 * np.pi * f0 * t * (1 + 0.05 * np.sin(0.5 * t)))
    return (tone + 0.05 * rng.standard_normal((batch, t.size))).astype(np.float32)


def eot_twin_params(params: dict, tokens: torch.Tensor, p_len: int, eot: int):
    """Params whose EOT embedding row is 1.02 x that of one generated token,
    the twin. The output projection is tied to the embedding, so EOT then
    outscores the twin wherever the twin's logit is positive, and a row stops
    where it would have emitted the twin, or where the twin came within 2%
    of the top logit. (1.02 clears the bf16 rounding of the logits, 2**-9;
    with random weights the top logits lie so close that 1.3 stops every
    row at the first step.) `tokens` come from a
    run with EOT suppressed; the twin is the token whose first appearances
    give the rows the most distinct stopping steps. Returns the params, the
    twin and those steps (25 for a row that never emits it)."""
    gen = tokens[:, p_len: p_len + 25].numpy()

    def stops(t):
        return sorted({int(np.argmax(r == t)) + 1 if (r == t).any() else 25
                       for r in gen})

    twin = max(np.unique(gen).tolist(), key=lambda t: len(stops(t)))
    embed = params["decoder"]["embed"].clone()
    embed[eot] = 1.02 * embed[twin]
    return ({**params, "decoder": {**params["decoder"], "embed": embed}},
            twin, stops(twin))


def launch_counters() -> dict:
    """Entry name -> (wrapper, counter attribute), for every kernel."""
    import importlib

    return {name: (getattr(importlib.import_module(
        "openai_whisper_compression_tpu_torch." + mod), fn), attr)
        for name, mod, fn, attr, *_ in KERNELS}


def run_path(dev, arch, params, run, profile: bool) -> dict:
    """One phase-2 run (see RUNS): its batches, checks, walls, steady RTFx,
    peak memory, stored weight size and the launch count of every kernel
    over the run."""
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import (
        make_transcribe_fn)
    from openai_whisper_compression_tpu_torch.models.params import size_in_mb

    name, _, method, switches, batch, n_sup, eot_batch, path = run
    eot = arch.eos_token_id
    weights_mib = size_in_mb(params)
    log(f"phase2 {name}: {arch.name}, {method} weights, stored {weights_mib:.1f} "
        f"MiB (size_in_mb), batch {batch}, {json.dumps(switches)}")
    p_len = 4  # <|sot|> <|en|> <|transcribe|> <|notimestamps|>
    prefix = torch.tensor([arch.decoder_start_token_id, arch.language_en_token_id,
                           arch.task_transcribe_token_id,
                           arch.no_timestamps_token_id])

    def make(**kw):
        return make_transcribe_fn(arch, DecodeConfig(max_new_tokens=25, **switches,
                                                     **kw),
                                  fast_mel=True, fast_gelu=True, device=dev)

    fn_sup = make(suppress_tokens=(eot,))
    wavs = [torch.from_numpy(waveforms(SEED + i, batch)).to(dev) for i in range(n_sup)]
    counters = launch_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    walls, outs = [], []

    def one(fn, p, wav, what):
        t0 = time.perf_counter()
        tokens, lengths = fn(p, wav)
        tokens, lengths = tokens.cpu(), lengths.cpu()   # the timing fence
        wall = time.perf_counter() - t0
        log(f"phase2 {name} batch {len(walls)} ({what}): wall {wall:.4f} s, "
            f"{batch / wall:.2f} utt/s, RTFx {batch * AUDIO_S / wall:.2f}, "
            f"lengths min {int(lengths.min())} max {int(lengths.max())}")
        walls.append(wall)
        outs.append((tokens, lengths, what))

    for wav in wavs:
        one(fn_sup, params, wav, "EOT suppressed")
    if eot_batch:
        # batch 0's audio again with EOT allowed and made reachable
        params_eot, twin, stops = eot_twin_params(params, outs[0][0], p_len, eot)
        log(f"phase2 {name} EOT twin: token {twin}; batch 0 emitted it first at "
            f"steps {stops} (25: never)")
        one(make(), params_eot, wavs[0], "EOT allowed")
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    log(f"phase2 {name} launches {json.dumps(launches)}")
    log(f"phase2 {name} peak memory {peak_mb:.1f} MiB "
        "(torch.cuda.max_memory_allocated)")
    for k, count in launches.items():
        if k in path:
            check(count > 0, f"{name}: kernel {k} was not launched on its path")
        else:
            check(count == 0, f"{name}: kernel {k} launched outside its path")

    for tokens, lengths, what in outs:
        check(tokens.shape == (batch, 64), f"tokens shape {tuple(tokens.shape)}")
        check(int(tokens.min()) >= 0 and int(tokens.max()) < arch.vocab_size,
              "tokens outside the vocabulary")
        check(torch.equal(tokens[:, :p_len], prefix.expand(batch, -1)),
              "forced prefix not intact")
        for row, n in zip(tokens, lengths.tolist()):
            check(bool((row[n:] == eot).all()), "tokens past the length must be EOT")
            check(not bool((row[p_len: n - 1] == eot).any()),
                  "EOT inside a row's valid tokens")
        if what == "EOT suppressed":
            check(bool((lengths == p_len + 25).all()), f"lengths {lengths.tolist()}")
            check(not bool((tokens[:, p_len: p_len + 25] == eot).any()),
                  "EOT emitted although suppressed")
    if eot_batch:
        tokens, lengths, _ = outs[-1]
        check(bool(((lengths > p_len) & (lengths <= p_len + 25)).all()),
              f"lengths {lengths.tolist()}")
        for row, n in zip(tokens, lengths.tolist()):
            check(n == p_len + 25 or int(row[n - 1]) == eot,
                  "a row shorter than the limit must end in EOT")
        check(len(set(lengths.tolist())) > 1,
              f"EOT-allowed rows must stop at different steps: {lengths.tolist()}")
        same = sum(torch.equal(tokens[r, p_len: n - 1], outs[0][0][r, p_len: n - 1])
                   for r, n in enumerate(lengths.tolist()))
        log(f"phase2 {name} EOT allowed: lengths {sorted(set(lengths.tolist()))}, "
            f"{int((lengths < p_len + 25).sum())} of {batch} rows stopped early; "
            f"{same} rows equal batch 0 up to their stop")
    steady = walls[1:3] if n_sup >= 3 else walls[:1]
    summary = {"batch": batch, "walls_s": walls,
               "rtfx_steady": batch * AUDIO_S / (sum(steady) / len(steady)),
               "peak_mib": peak_mb, "weights_mib": weights_mib,
               "launches": launches}
    log(f"phase2 {name} steady ({'batches 1-2' if n_sup >= 3 else 'batch 0'}) "
        f"RTFx {summary['rtfx_steady']:.2f}")

    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile

        wav = wavs[-1]
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn_sup(params, wav)[0].cpu()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        dev_us = sum(e.self_device_time_total for e in events  # kernels only
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation)
        log(f"profile {name}: wall {wall * 1e3:.1f} ms, summed device kernel "
            f"time {dev_us / 1e3:.1f} ms, idle share "
            f"{max(0.0, 1 - dev_us / 1e6 / wall):.3f}")
        log(events.table(sort_by="self_device_time_total", row_limit=30,
                         max_name_column_width=60))
    return summary


@torch.inference_mode()
def phase3(dev, params_for) -> None:
    """First-step logits of 2 utterances, card bf16 vs CPU f32, for each
    LOGIT_RUNS configuration of whisper-small."""
    from openai_whisper_compression_tpu_torch.audio.features import preprocess
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.models.decode import first_step_logits
    from openai_whisper_compression_tpu_torch.models.params import tree_to
    from openai_whisper_compression_tpu_torch.models.whisper import encode

    wav = torch.from_numpy(waveforms(SEED, 2))
    for method in dict.fromkeys(m for _, m, _ in LOGIT_RUNS):
        arch, params = params_for(ARCH, method)
        cfgs = {name: DecodeConfig(max_new_tokens=25,
                                   suppress_tokens=(arch.eos_token_id,), **switches)
                for name, m, switches in LOGIT_RUNS if m == method}

        def logits(params, wav, dtype):
            mel = preprocess(wav, arch.num_mel_bins, dft_dtype=torch.bfloat16).to(dtype)
            enc = encode(params, arch, mel, fast_gelu=True)
            return {name: first_step_logits(params, arch, enc, cfg).float().cpu()
                    for name, cfg in cfgs.items()}

        card = logits(params, wav.to(dev), torch.bfloat16)
        ref = logits(tree_to(params, "cpu", torch.float32), wav, torch.float32)
        for name in cfgs:
            c, r = card[name], ref[name]
            rel = float((c - r).norm() / r.norm())
            agree = float((c.argmax(-1) == r.argmax(-1)).float().mean())
            log(f"phase3 {name} first-step logits card bf16 vs CPU f32: relative L2 "
                f"{rel:.4g} (bound {LOGITS_REL_L2}), max abs {max_err(c, r):.4g}, "
                f"|logits| max {float(r.abs().max()):.4g}, argmax agreement "
                f"{agree:.2f} (not checked: random weights make argmax tie-prone)")
            check(bool(torch.isfinite(c).all()) and c.shape == (2, arch.vocab_size),
                  f"{name}: card logits not finite or of shape {tuple(c.shape)}")
            check(rel <= LOGITS_REL_L2,
                  f"{name}: card logits off by {rel:.4g} relative L2")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one batch of the int8-kv and medium-int4 "
                         "runs with torch.profiler")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from openai_whisper_compression_tpu_torch.ops import kernels

    # f32 references run in full f32 on the card, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"phase0 {smi}")
    log(f"phase0 torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    kernels.lib()
    log(f"phase0 kernel library {kernels.library_path().name}: ready in "
        f"{time.perf_counter() - t0:.2f} s (nvcc build "
        f"{kernels.build_seconds if kernels.build_seconds is not None else 'cached'} s)")

    results: dict = {}
    phase1(dev, results)
    phase1_quantized(dev, results)
    phase1_4bit(dev, results)
    torch.cuda.empty_cache()
    built: dict = {}

    def params_for(arch_name: str, method: str):
        if (arch_name, method) not in built:
            built[arch_name, method] = make_params(dev, arch_name, method)
        return built[arch_name, method]

    summaries = {}
    for run in RUNS:
        name, arch_name, method = run[:3]
        summaries[name] = run_path(dev, *params_for(arch_name, method), run,
                                   args.profile and name in ("int8-kv", "medium-int4"))
        if arch_name != ARCH:
            del built[arch_name, method]
            torch.cuda.empty_cache()
    phase3(dev, params_for)

    def launches(name):  # from the first run whose path holds the kernel
        run = next(r for r in RUNS if name in r[-1])
        return summaries[run[0]]["launches"][name]

    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": CSRC + src,
         "replaces": JAX_PKG + rep, "launches": launches(name),
         "max_abs_err": results[key]["max_abs_err"],
         "ms": results[key]["ms"], "plain_ms": results[key]["plain_ms"]}
        for name, _, _, _, src, rep, key in KERNELS]}
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
