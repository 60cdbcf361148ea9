#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py              # from the repository root
    python3 chip_smoke.py --profile    # also torch.profiler kernel tables
                                       # of the int8-kv, small-w8a8-dyn,
                                       # beam5-prompt and small-b1 runs

Phase 0  prints the card and its power limit, builds the CUDA kernels from
         `openai_whisper_compression_tpu_torch/csrc` (nvcc, sm_90a, one
         process per source).
Phase 1  each kernel against its plain PyTorch version on the card, at
         main-path shapes (whisper-small batch 32 for slice 1's four
         kernels, batch 96 for the int8/int4-KV kernels; the log-mel, held
         no less exact than its plain version against the float64 log-mel,
         also at the headline's batch 96 and with the f32 DFT at 32, the whole
         call beside the kernel alone and beside two bounds, over the
         filterbank's nonzeros and with it dense; the cross-KV quantizer
         also at whisper-medium's (64, 1500, 1024); for the int4,
         NF4/FP4 and HQQ dequant-matmuls, the decoder linears of the
         phase-2 run of each kind at M = batch and 3 x batch, and
         whisper-medium's at M = 64 and 256; the encoder attention at
         whisper-small batch 96 and whisper-medium batch 64, on the strided
         layout the projections leave; the cache updates with a mixed
         `start`; the grouped cross-attention at 1, 3, 5 and 8 query slots
         over 384 and 1152 rows, and at 5 slots over the beam runs' 192; the
         w8a8 matmul, dynamic and static, at whisper-small's four linears at
         M = 96 and M = 96 x 1500, bit for bit, beside quantize +
         `torch._int_mm` + epilogue and dequant + torch.matmul, with a
         decode-M call held to one kernel and an encoder-scale call's
         quantize pass timed apart (torch.profiler); the one-query cross-attention at 12 and
         36 rows over bf16, int8 and int4 K/V, also against the grouped
         kernel at one slot; the read-only self-attention bit for bit
         against the update kernels' output; the int8 matmul also at the
         headline batch's M = 96 and 288; the f32 and f16 bodies of the
         cache update, the grouped (1 and 5 slots) and the one-query
         cross-attention at the shapes of the f32 and f16 runs), with
         CUDA-event times (the one-query cross-attention and the int8 cache
         update and its read-only body also cold: rotating over copies of
         their buffers larger than the 50 MB L2, as a decode step meets
         them); the dequant-matmuls also beside dequant +
         torch.matmul (every storage trait at M = 32, 96, 288 and 1024: where
         the two cross), the encoder attention beside the time its
         exponentials alone need, the attentions over K/V in q's type beside
         `F.scaled_dot_product_attention` (a yardstick that no path of the
         port calls), and every kernel beside its bound: the larger of its
         bytes over the card's memory rate and its operations over the
         card's peak rate.
Phase 2  decode runs at full width with seeded random weights (bf16, but
         for the f32 and f16 trees), fused
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
                        (one batch each);
           small-w8a8-dyn     `pytorch_dynamic_int8` (int8 weights, int8
                        activations per row), batch 96, int8 caches, three
                        batches: every quantized linear of encoder, cross-KV,
                        prefill and steps through the w8a8 kernel;
           small-w8a8-static, small-w4a8-static, small-fp8  batch 32, one
                        batch each after a calibration pass on the card
                        (`calibrate_static` over the first batch):
                        `static_int8_act_int8` and `static_int4_act_int8`
                        through the w8a8 kernel's static body,
                        `static_fp8_act_fp8` through the fp8 branches (plain
                        torch, as in the JAX package);
           small-b1     int8 weights and caches at batch 1 (12 (batch, head)
                        rows): the one-query cross-attention's int8 body;
           small-b3-bf16, small-b3-int4ckv  batch 3 (36 rows), bf16 caches
                        and int4 cross-KV: its other two bodies;
           small-f32    `baseline_fp32` (an f32 tree, f32 caches), batch 16:
                        the decode kernels' f32 bodies (the encoder's
                        attention in plain torch, as the JAX package leaves
                        an f32 encoder to XLA);
           small-b3-f32, small-b3-f16  `baseline_fp32` and `fp16` at batch 3:
                        the one-query cross-attention's f32 and f16 bodies.
         bf16-kv, int8-kv and small-b1 run three batches with EOT suppressed, then
         the first batch again with EOT allowed and its embedding tied to
         a generated token, so that rows stop at different steps;
         medium-int4 runs three batches with EOT suppressed. Then four
         prompt-conditioned runs of whisper-small, with int8 weights but for
         the last (a 16-token prompt window, prompt lengths mixed over 4..16, 25 new
         tokens, EOT suppressed, two batches each), through
         `beam_decode` / `greedy_decode` with `prompt_tokens`:
           beam5-prompt      beam 5, int8 self-KV and cross-KV, batch 16;
           greedy-prompt-ts  bf16 caches, batch 32, timestamp rules on;
           beam5-int4ckv     beam 5, int8 self-KV, int4 cross-KV, batch 16;
           small-f16-beam5   `fp16` (an f16 tree, f16 caches), beam 5, batch 8.
         Every launch count is set to 0 before a run and read after it:
         each kernel of the run's path must have launched (every attention
         kernel exactly as often as the path calls it: the encoder attention
         layers x batches times, the cache update layers x steps, the
         cross-attention layers x (steps + prefill launches)), and no
         other. The beam runs' output is checked against all five beams
         rescored by teacher forcing, a left-padded row against the same row
         run alone with its unpadded prompt, and the timestamp run against
         the timestamp rules. Last, `self-attn-replay`: the read-only
         self-attention has no caller in the model (nor in the JAX
         package), so four greedy decodes at batch 32 (bf16 and int8 caches,
         without and with a prompt window) call it after every cache update
         of every layer, on the cache that update wrote, and hold its output
         bit for bit against the update kernel's.
Phase 3  first-step logits of 2 utterances, card (bf16, kernels) against
         the same port run on the CPU in f32 (plain versions): whisper-small
         int8 weights with bf16 caches and with the int8 self-KV and
         cross-KV, and int4, NF4 double-quant and HQQ int4 weights with the
         int8 caches; `pytorch_dynamic_int8`, calibrated
         `static_int8_act_int8` and `static_fp8_act_fp8`; int8 weights at
         batch 1; the f32 and the f16 tree in their own types (bounds of
         their own: an f32 tree differs by sum order only); and the
         beam5-prompt configuration (prompted, five beams).

Any failure exits nonzero. On success the last stdout line is
{"ok": true, "device": {...}}; the line before it lists every kernel with
its launch count, error, times and bound. Needs torch with CUDA, numpy and nvcc;
never imports jax.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

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
    ("encoder_attention", "ops.attention", "encoder_attention", "launches",
     "encoder_attention.cu", "ops/attention.py:57", "enc_attn"),
    ("decode_self_attention_update_start", "ops.self_attention_step",
     "decode_self_attention_update", "launches_start",
     "self_attention_step.cu", "ops/self_attention_step.py:104", "self_start"),
    ("decode_self_attention_update_int8_start", "ops.self_attention_step",
     "decode_self_attention_update_int8", "launches_start",
     "self_attention_step.cu", "ops/self_attention_step.py:164",
     "self_int8_start"),
    ("decode_cross_attention_grouped_wide", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches_wide", "cross_attention.cu",
     "ops/cross_attention.py:321", "cross_wide"),
    ("decode_cross_attention_grouped_int8_wide", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches_int8_wide",
     "cross_attention.cu", "ops/cross_attention.py:306", "cross_int8_wide"),
    ("decode_cross_attention_grouped_int4_wide", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches_int4_wide",
     "cross_attention.cu", "ops/cross_attention.py:313", "cross_int4_wide"),
    ("w8a8_matmul", "ops.quant_matmul", "w8a8_matmul", "launches",
     "w8a8_matmul.cu", "ops/quant_matmul.py:341", "w8a8"),
    ("w8a8_matmul_static", "ops.quant_matmul", "w8a8_matmul", "launches_static",
     "w8a8_matmul.cu", "ops/quant_matmul.py:330", "w8a8_static"),
    ("decode_cross_attention", "ops.cross_attention", "decode_cross_attention",
     "launches", "cross_attention.cu", "ops/cross_attention.py:151", "cross1"),
    ("decode_cross_attention_int8", "ops.cross_attention",
     "decode_cross_attention", "launches_int8", "cross_attention.cu",
     "ops/cross_attention.py:99", "cross1_int8"),
    ("decode_cross_attention_int4", "ops.cross_attention",
     "decode_cross_attention", "launches_int4", "cross_attention.cu",
     "ops/cross_attention.py:133", "cross1_int4"),
    ("decode_self_attention", "ops.self_attention_step", "decode_self_attention",
     "launches", "self_attention_step.cu", "ops/self_attention_step.py:320",
     "attend"),
    ("decode_self_attention_start", "ops.self_attention_step",
     "decode_self_attention", "launches_start", "self_attention_step.cu",
     "ops/self_attention_step.py:96", "attend_start"),
    ("decode_self_attention_int8", "ops.self_attention_step",
     "decode_self_attention", "launches_int8", "self_attention_step.cu",
     "ops/self_attention_step.py:314", "attend_int8"),
    ("decode_self_attention_int8_start", "ops.self_attention_step",
     "decode_self_attention", "launches_int8_start", "self_attention_step.cu",
     "ops/self_attention_step.py:309", "attend_int8_start"),
    # the f32 and f16 bodies of the decode attention kernels
    ("decode_self_attention_update_f32", "ops.self_attention_step",
     "decode_self_attention_update", "launches_f32", "self_attention_step.cu",
     "ops/self_attention_step.py:245", "self_f32"),
    ("decode_self_attention_update_f16", "ops.self_attention_step",
     "decode_self_attention_update", "launches_f16", "self_attention_step.cu",
     "ops/self_attention_step.py:245", "self_f16"),
    ("decode_self_attention_update_f16_start", "ops.self_attention_step",
     "decode_self_attention_update", "launches_f16_start",
     "self_attention_step.cu", "ops/self_attention_step.py:104", "self_f16_start"),
    ("decode_cross_attention_grouped_f32", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches_f32", "cross_attention.cu",
     "ops/cross_attention.py:321", "cross_f32"),
    ("decode_cross_attention_grouped_f16", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches_f16", "cross_attention.cu",
     "ops/cross_attention.py:321", "cross_f16"),
    ("decode_cross_attention_grouped_f16_wide", "ops.cross_attention",
     "decode_cross_attention_grouped", "launches_f16_wide", "cross_attention.cu",
     "ops/cross_attention.py:321", "cross_f16_wide"),
    ("decode_cross_attention_f32", "ops.cross_attention", "decode_cross_attention",
     "launches_f32", "cross_attention.cu", "ops/cross_attention.py:151",
     "cross1_f32"),
    ("decode_cross_attention_f16", "ops.cross_attention", "decode_cross_attention",
     "launches_f16", "cross_attention.cu", "ops/cross_attention.py:151",
     "cross1_f16"),
]
KV8 = {"kv_int8": True, "cross_kv_int8": True}
DECODE_KERNELS = ("log_mel_cuda", "encoder_attention", "transpose_quant_kv",
                  "decode_cross_attention_grouped_int8",
                  "decode_self_attention_update_int8")
# phase-2 runs: (name, arch, weight quantization, DecodeConfig switches,
# batch, batches with EOT suppressed, EOT-allowed batch after them, kernels
# of the path); the entry of KERNELS reports the launch count of the first
# run whose path holds it
SMALL_KERNELS = ("log_mel_cuda", "encoder_attention", "int8_matmul")
RUNS = [
    ("bf16-kv", ARCH, "int8", {}, BATCH, 3, True,
     ("log_mel_cuda", "encoder_attention", "int8_matmul",
      "decode_cross_attention_grouped", "decode_self_attention_update")),
    ("int8-kv", ARCH, "int8", KV8, HEAD_BATCH, 3, True,
     ("int8_matmul",) + DECODE_KERNELS),
    ("int4-ckv", ARCH, "int8", {"kv_int8": True, "cross_kv_int4": True},
     HEAD_BATCH, 1, False,
     ("log_mel_cuda", "encoder_attention", "int8_matmul",
      "decode_cross_attention_grouped_int4",
      "decode_self_attention_update_int8")),
    ("medium-int4", "medium", "int4", KV8, MEDIUM_BATCH, 3, False,
     ("int4_matmul",) + DECODE_KERNELS),
    ("small-nf4dq", ARCH, "bnb_nf4_double_quant", KV8, BATCH, 1, False,
     ("nf4_matmul",) + DECODE_KERNELS),
    ("small-hqq4", ARCH, "hqq_int4", KV8, BATCH, 1, False,
     ("group_asym_matmul",) + DECODE_KERNELS),
    ("small-hqq8", ARCH, "hqq_int8", KV8, BATCH, 1, False,
     ("group_asym_matmul_u8",) + DECODE_KERNELS),
    ("small-w8a8-dyn", ARCH, "pytorch_dynamic_int8", KV8, HEAD_BATCH, 3, False,
     ("w8a8_matmul",) + DECODE_KERNELS),
    ("small-w8a8-static", ARCH, "static_int8_act_int8", KV8, BATCH, 1, False,
     ("w8a8_matmul_static",) + DECODE_KERNELS),
    ("small-w4a8-static", ARCH, "static_int4_act_int8", KV8, BATCH, 1, False,
     ("w8a8_matmul_static",) + DECODE_KERNELS),
    ("small-fp8", ARCH, "static_fp8_act_fp8", KV8, BATCH, 1, False, DECODE_KERNELS),
    ("small-b1", ARCH, "int8", KV8, 1, 3, True,
     SMALL_KERNELS + ("transpose_quant_kv", "decode_cross_attention_grouped_int8",
                      "decode_cross_attention_int8",
                      "decode_self_attention_update_int8")),
    ("small-b3-bf16", ARCH, "int8", {}, 3, 1, False,
     SMALL_KERNELS + ("decode_cross_attention_grouped", "decode_cross_attention",
                      "decode_self_attention_update")),
    ("small-b3-int4ckv", ARCH, "int8", {"kv_int8": True, "cross_kv_int4": True},
     3, 1, False,
     SMALL_KERNELS + ("decode_cross_attention_grouped_int4",
                      "decode_cross_attention_int4",
                      "decode_self_attention_update_int8")),
    # f32 and f16 trees (no quantized weights: no matmul kernel; an f32 or
    # f16 encoder takes plain torch, as the JAX package leaves it to XLA):
    # caches in the tree's own type
    ("small-f32", ARCH, "baseline_fp32", {}, 16, 1, False,
     ("log_mel_cuda", "decode_cross_attention_grouped_f32",
      "decode_self_attention_update_f32")),
    ("small-b3-f32", ARCH, "baseline_fp32", {}, 3, 1, False,
     ("log_mel_cuda", "decode_cross_attention_grouped_f32",
      "decode_cross_attention_f32", "decode_self_attention_update_f32")),
    ("small-b3-f16", ARCH, "fp16", {}, 3, 1, False,
     ("log_mel_cuda", "decode_cross_attention_grouped_f16",
      "decode_cross_attention_f16", "decode_self_attention_update_f16")),
]
# prompt-conditioned phase-2 runs of whisper-small: (name, DecodeConfig
# switches, batch[, weights: int8 unless given]); two batches each, EOT
# suppressed, a PROMPT_W-token prompt window with lengths mixed over
# 4..PROMPT_W
PROMPT_W = 16
NEW_TOKENS = 25
BEAM5 = {"beam_size": 5, "kv_int8": True, "cross_kv_int8": True}
PROMPT_RUNS = [
    ("beam5-prompt", BEAM5, 16),
    ("greedy-prompt-ts", {"notimestamps": False}, 32),
    ("beam5-int4ckv", {"beam_size": 5, "kv_int8": True, "cross_kv_int4": True}, 16),
    ("small-f16-beam5", {"beam_size": 5}, 8, "fp16"),
]
# the runs `--profile` profiles: the headline, the w8a8 path, beam search
PROFILED = ("int8-kv", "small-w8a8-dyn", "beam5-prompt", "small-b1")
# phase-3 configurations: (name, weight quantization, DecodeConfig switches)
LOGIT_RUNS = [("int8 bf16-kv", "int8", {}), ("int8 int8-kv", "int8", KV8),
              ("int4 int8-kv", "int4", KV8),
              ("nf4-dq int8-kv", "bnb_nf4_double_quant", KV8),
              ("hqq-int4 int8-kv", "hqq_int4", KV8),
              ("w8a8-dyn int8-kv", "pytorch_dynamic_int8", KV8),
              ("w8a8-static int8-kv", "static_int8_act_int8", KV8),
              ("fp8-fp8 int8-kv", "static_fp8_act_fp8", KV8),
              ("f32 f32-kv", "baseline_fp32", {}), ("f16 f16-kv", "fp16", {})]
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
# - mel: the kernel no less exact than its plain version. Both are held
#   against the float64 log-mel on the same operands
#   (`features.log_mel_f64`): the kernel's largest distance from it at most
#   the plain version's + 5e-6. Two f32 chains that sum in different orders
#   each stray up to ~3e-5 from the exact value on rare ill-conditioned bins
#   (an H100 80GB HBM3 at 700 W read 1.24e-5 and 1.30e-5 at batch 96, both
#   3.08e-5 under the f32 DFT), so they cannot be held to 1e-5 of each
#   other; a power spectrum or mel product kept in bf16 would stray 1e-4 or
#   more further.
MEL_EXACT_MARGIN = 5e-6
# - bf16 outputs (int8 matmul, attention): the two sides round f32 values
#   that differ only by sum order, so they differ by at most one bf16 step
#   (2**-8 to 2**-7 of the value): 2**-7 of the reference's own largest
#   magnitude.
BF16_REL = 2.0 ** -7
# - f16 outputs likewise by one f16 step (2**-11 to 2**-10 of the value), f32
#   outputs by sum order and the exponential's last bits: 2**-10 and 1e-5 of
#   the reference's largest magnitude.
KERNEL_REL = {torch.bfloat16: BF16_REL, torch.float16: 2.0 ** -10,
              torch.float32: 1e-5}
# - slice, card bf16 vs CPU f32 first-step logits: bf16 activations (2**-9
#   relative rounding per op) through 24 residual blocks, int8 weights equal
#   on both sides; a few percent expected, while a layout or indexing fault
#   gives an error of order 1.
LOGITS_REL_L2 = 0.1
# - the same with quantized activations. Every linear's input differs on the
#   two sides by its bf16 rounding (2**-9 relative), which moves a share of
#   the activation codes across a rounding boundary: an int8 code by one step
#   (1/127 of the row's or tensor's maximum), an fp8 code by one step of its
#   three mantissa bits (2**-4 to 2**-3 of the value). Those errors are not
#   shared by the two sides and add up over 150 linears. Runs on an H100
#   80GB HBM3 at 700 W read 0.027 (dynamic int8), 0.031 (static int8) and
#   0.065 (fp8), the same in every run since the weights are seeded. The
#   bounds leave a factor of about 1.5 for another torch version's kernels:
#   0.05 for int8 activations, 0.1 for fp8. A fault that only doubles the
#   error (a wrong `act_scale`, a clip placed after the cast) then fails.
ACT_LOGITS_REL_L2 = {"pytorch_dynamic_int8": 0.05, "static_int8_act_int8": 0.05,
                     "static_fp8_act_fp8": 0.1}
# - an f32 tree on the card (full f32 products, TF32 off) against the same
#   tree on the CPU differs by sum order only; an f16 tree (f16 activations,
#   2**-11 relative rounding per op, f32 sums) by less than a bf16 one. A run
#   on an H100 80GB HBM3 at 700 W read 8.732e-07 and 0.001288; the bounds
#   are twice the readings, rounded up to two digits.
TREE_LOGITS_REL_L2 = {"baseline_fp32": 1.8e-6, "fp16": 0.0026}
# - a left-padded prompt row against the same row run alone with its
#   unpadded prompt, both on the card in bf16: the same function, computed at
#   another batch size and window length (other launch shapes, so bf16
#   roundings fall elsewhere through 12 layers): a few 1e-3 expected.
PROMPT_ROW_REL_L2 = 0.03
# - a beam's summed logprob (25 tokens, of order -200) against the same
#   tokens rescored by teacher forcing at another batch shape, bf16 logits:
#   0.5% of the score (runs read 0.01-0.05%); a cache row gathered from the
#   wrong beam is off by far more.
RESCORE_REL = 0.005

# Published dense peaks of one H100 SXM (NVIDIA's data sheet), for the
# bounds: device memory bytes/s, tensor-core bf16 FLOP/s and int8 OP/s, f32
# FLOP/s outside the tensor cores.
HBM_BPS, BF16_FLOPS, F32_FLOPS, INT8_OPS = 3.35e12, 989e12, 67e12, 1979e12


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def bound(moved_bytes: float, op_seconds: float) -> dict:
    """The least time the card could take: the bytes the function must move
    (each input read once, each output written once) over the memory rate,
    or its operations over the peak rate of their type (`op_seconds`),
    whichever is larger."""
    byte_seconds = moved_bytes / HBM_BPS
    return {"bound_ms": 1e3 * max(byte_seconds, op_seconds),
            "bound_by": "bytes" if byte_seconds >= op_seconds else "operations"}


def peak_flops(dtype: torch.dtype) -> float:
    """The card's peak rate for products of `dtype`: the tensor cores' for
    bf16 and f16, the f32 rate outside them for f32."""
    return F32_FLOPS if dtype == torch.float32 else BF16_FLOPS


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale=None,
         attn_mask=None):
    """PyTorch's fused attention, timed beside the attention kernels as a
    yardstick only: nothing in the port calls it."""
    return F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, scale=scale)


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


# Bytes over which `cuda_ms_cold` rotates its copies of a call's buffers:
# more than the H100's 50 MB L2, so that each call finds its inputs in
# device memory, as a decode step finds its caches.
COLD_BYTES = 64e6


def cuda_ms_cold(fn, tensors: list, iters: int = 20) -> float:
    """Mean device time per call of fn(*copy), rotating over as many copies
    of `tensors` (every tensor argument of the call, made anew here) as
    exceed COLD_BYTES together, each copy used at least once, after a spin
    kernel as in `cuda_ms`."""
    n = int(COLD_BYTES // max(1, nbytes(*tensors))) + 2
    copies = [[t.clone() if isinstance(t, torch.Tensor) else t for t in tensors]
              for _ in range(n)]
    iters = max(iters, n)
    for c in copies:
        fn(*c)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for i in range(iters):
        fn(*copies[i % n])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check_grouped(what: str, qg: torch.Tensor, kv: tuple, s_valid: int) -> dict:
    """The grouped cross-attention kernel on q (BH, K, 64) and kv = (k_t,
    v_t, k_scale, v_scale) against its plain version, with times, its bound
    (the valid part of K/V and its scales read once) and, for K/V in q's own
    type, PyTorch's fused attention on the same tensors."""
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        decode_cross_attention_grouped, decode_cross_attention_grouped_ref)

    bh, kq, _ = qg.shape
    got = decode_cross_attention_grouped(qg, *kv, s_valid)
    ref = decode_cross_attention_grouped_ref(qg, *kv, s_valid)
    err, tol = max_err(got, ref), KERNEL_REL[qg.dtype] * float(ref.float().abs().max())
    check(got.dtype == qg.dtype and err <= tol, f"{what}: err {err} > {tol}")
    t_k = cuda_ms(lambda: decode_cross_attention_grouped(qg, *kv, s_valid))
    t_p = cuda_ms(lambda: decode_cross_attention_grouped_ref(qg, *kv, s_valid))
    k_t, v_t, k_scale, _ = kv
    valid = s_valid / k_t.shape[2]
    least = bound(nbytes(qg, got) + valid * nbytes(*kv),
                  4 * bh * kq * 64 * s_valid / peak_flops(k_t.dtype))
    t_lib = None
    if k_scale is None:
        k, v = (t[:, :, :s_valid].transpose(1, 2) for t in (k_t, v_t))
        t_lib = cuda_ms(lambda: sdpa(qg, k, v, scale=1.0))
    log(f"phase1 {what} {tuple(k_t.shape)} s_valid {s_valid}: err {err:.3g} "
        f"(bound {tol:.3g}) kernel {t_k:.4f} ms plain {t_p:.4f} ms least "
        f"{least['bound_ms']:.4f} ms ({least['bound_by']})"
        + ("" if t_lib is None else f" sdpa {t_lib:.4f} ms"))
    return {"max_abs_err": err, "ms": t_k, "plain_ms": t_p, **least,
            "library_ms": t_lib}


def check_update(what: str, bh: int, pos: int, gen, int8: bool,
                 start: torch.Tensor | None, dtype=torch.bfloat16) -> dict:
    """One of the two cache-update kernels over a 64-row cache of `bh` rows
    against its plain version, q, the fresh rows and an fp cache in `dtype`:
    caches (codes and scales) bit for bit, the output within one step of
    `dtype`; with times and its bound (the rows start..pos read once, row
    pos written)."""
    from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas

    dev = gen.device
    qf = (torch.randn(bh, 64, generator=gen, device=dev) * 0.125).to(dtype)
    kn, vn = (torch.randn(2, bh, 64, generator=gen, device=dev) * 2).to(dtype)
    if int8:
        fn, ref_fn = (sas.decode_self_attention_update_int8,
                      sas.decode_self_attention_update_int8_ref)
        kc, vc = torch.randint(-127, 128, (2, bh, 64, 64), generator=gen,
                               device=dev, dtype=torch.int8)
        ks, vs = torch.rand(2, bh, 64, generator=gen, device=dev) * 0.03 + 1e-3
        bufs = [kc, vc, ks, vs]
    else:
        fn, ref_fn = (sas.decode_self_attention_update,
                      sas.decode_self_attention_update_ref)
        bufs = [torch.randn(bh, 64, 64, generator=gen, device=dev).to(dtype)
                for _ in range(2)]
    refs = [t.clone() for t in bufs]
    got = fn(qf, kn, vn, *bufs, pos, start=start)
    ref = ref_fn(qf, kn, vn, *refs, pos, start=start)
    err, tol = max_err(got, ref), KERNEL_REL[dtype] * float(ref.float().abs().max())
    check(all(torch.equal(a, r) for a, r in zip(bufs, refs)),
          f"{what} pos={pos}: cache rows or scales differ")
    check(err <= tol, f"{what} pos={pos}: err {err} > {tol}")
    t_k = cuda_ms(lambda: fn(qf, kn, vn, *bufs, pos, start=start))
    t_p = cuda_ms(lambda: ref_fn(qf, kn, vn, *refs, pos, start=start))
    cold = ""
    if int8:   # the decode step finds its cache in device memory
        t_c = cuda_ms_cold(lambda *a: fn(*a, pos, start=start), [qf, kn, vn, *bufs])
        cold = f" (cold {t_c:.4f} ms)"
    rows = bh * (pos + 1) - (0 if start is None else int(start.sum()))
    per_row = sum(t[0, 0].numel() * t.element_size() for t in bufs)
    least = bound(nbytes(qf, kn, vn, got) + per_row * (rows + bh),
                  4 * 64 * rows / peak_flops(torch.bfloat16 if int8 else dtype))
    log(f"phase1 {what} pos={pos} ({bh}, 64, 64)"
        + ("" if start is None else f" start {int(start.min())}..{int(start.max())}")
        + f": err {err:.3g} (bound {tol:.3g}) caches equal; kernel {t_k:.4f} ms{cold} "
        f"plain {t_p:.4f} ms least {least['bound_ms']:.5f} ms ({least['bound_by']})")
    return {"max_abs_err": err, "ms": t_k, "plain_ms": t_p, **least,
            "library_ms": None}


def mel_exactness(what: str, wav: torch.Tensor, got: torch.Tensor,
                  ref: torch.Tensor, n_mels: int, dtype: torch.dtype) -> tuple:
    """The largest distances of the kernel's log-mel `got` and the plain
    version's `ref` from the float64 log-mel of the same operands; fails
    unless the kernel is within MEL_EXACT_MARGIN of the plain version's."""
    from openai_whisper_compression_tpu_torch.audio import features

    exact = features.log_mel_f64(wav, n_mels, dtype)
    err_k, err_p = (float((x.double() - exact).abs().max()) for x in (got, ref))
    log(f"mel {what}: from the float64 log-mel, kernel {err_k:.3g}, plain {err_p:.3g} "
        f"(the kernel may be {MEL_EXACT_MARGIN:g} further)")
    check(err_k <= err_p + MEL_EXACT_MARGIN,
          f"mel {what}: the kernel is {err_k} from the float64 log-mel, the plain "
          f"version {err_p}")
    return err_k, err_p


def check_mel(dev, gen, b: int, dtype: torch.dtype) -> dict:
    """`log_mel_cuda` on b seeded 30 s clips against the plain pipeline: the
    kernel no less exact than it against the float64 result; the whole call and
    the kernel alone timed beside the plain version, and two bounds: over
    the filterbank's nonzeros (what the function needs; the one the kernels
    line carries) and with the dense 201 x 80 filterbank."""
    from openai_whisper_compression_tpu_torch.audio import features, mel_kernel

    wav = torch.randn(b, 480_000, generator=gen, device=dev) * 0.1
    got = mel_kernel.log_mel_cuda(wav, 80, dtype)
    ref = features.log_mel(wav, 80, dtype)
    err = max_err(got, ref)
    what = f"({b}, 480000) {'bf16' if dtype == torch.bfloat16 else 'f32'} DFT"
    check(got.shape == (b, 80, 3000), f"mel {what}: shape {tuple(got.shape)}")
    mel_exactness(what, wav, got, ref, 80, dtype)
    ops = mel_kernel.mel_operands(wav, 80, dtype)
    frames = b * ops.n_frames   # re and im: 400 taps x 201 bins, in the DFT dtype
    dft = frames * 4 * 400 * 201 / peak_flops(dtype)
    nonzeros = int(ops.bands[:, 1].sum())
    res = {"max_abs_err": err,
           "ms": cuda_ms(lambda: mel_kernel.log_mel_cuda(wav, 80, dtype)),
           "plain_ms": cuda_ms(lambda: features.log_mel(wav, 80, dtype)),
           **bound(nbytes(wav, got), dft + frames * 2 * nonzeros / F32_FLOPS),
           "library_ms": None}
    kernel_ms = cuda_ms(lambda: mel_kernel.launch(ops, dtype))
    dense = bound(nbytes(wav, got), dft + frames * 2 * 201 * 80 / F32_FLOPS)
    log(f"phase1 mel {what}: from the plain version {err:.3g}; whole call "
        f"{res['ms']:.4f} ms, kernel alone {kernel_ms:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms; least {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}) over the filterbank's {nonzeros} nonzeros, "
        f"{dense['bound_ms']:.4f} ms ({dense['bound_by']}) with it dense")
    return res


def phase1(dev, results: dict) -> None:
    from openai_whisper_compression_tpu_torch.ops.qtensor import dequantize
    from openai_whisper_compression_tpu_torch.ops.quant_matmul import (
        int8_matmul, int8_matmul_ref)
    from openai_whisper_compression_tpu_torch.quant.core import quantize_int8

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16

    # mel: 32 x 30 s and the headline's 96 x 30 s with the bf16 DFT
    # (fast_mel), 32 x 30 s with the f32 DFT
    for b, dtype in ((BATCH, bf16), (HEAD_BATCH, bf16), (BATCH, torch.float32)):
        res = check_mel(dev, gen, b, dtype)
        if (b, dtype) == (BATCH, bf16):
            results["mel"] = res

    # int8 matmul at every decoder linear shape, M = a batch-32 step, and a
    # step and the prefill of the headline batch (96, 3 x 96)
    errs, rows = [], []
    for k, n, what in ((768, 2304, "qkv"), (768, 768, "o/cross q/cross o"),
                       (768, 3072, "fc1"), (3072, 768, "fc2")):
        q = quantize_int8(torch.randn(k, n, generator=gen, device=dev) * 0.02)
        for m in (BATCH, HEAD_BATCH, 3 * HEAD_BATCH):
            x = torch.randn(m, k, generator=gen, device=dev).to(bf16)
            got = int8_matmul(x, q.data, q.scale)
            ref = int8_matmul_ref(x, q.data, q.scale)
            err, tol = max_err(got, ref), BF16_REL * float(ref.float().abs().max())
            check(err <= tol, f"int8_matmul M={m} K={k} N={n}: err {err} > {tol}")
            errs.append(err)
            t_k = cuda_ms(lambda: int8_matmul(x, q.data, q.scale))
            t_p = cuda_ms(lambda: int8_matmul_ref(x, q.data, q.scale))
            t_d = cuda_ms(lambda: torch.matmul(x, dequantize(q, bf16)))
            least = bound(nbytes(x, q.data, q.scale, got), 2 * m * k * n / BF16_FLOPS)
            rows.append((m, k, n, what, err, t_k, t_p, t_d, least))
            log(f"phase1 int8_matmul M={m} K={k} N={n} ({what}): err {err:.3g} "
                f"(bound {tol:.3g}) "
                f"kernel {t_k:.4f} ms plain {t_p:.4f} ms "
                f"dequant+torch.matmul {t_d:.4f} ms least {least['bound_ms']:.5f} ms "
                f"({least['bound_by']})")
    qkv96 = rows[1]   # the qkv projection of a decode step of the headline batch
    check(qkv96[:4] == (HEAD_BATCH, 768, 2304, "qkv"), "not the headline's qkv")
    results["int8_matmul"] = {"max_abs_err": max(errs), "ms": qkv96[5],
                              "plain_ms": qkv96[6], **qkv96[8],
                              "library_ms": qkv96[7]}

    # grouped cross-attention: K = 1 (a greedy step), 3 (the prefix's
    # prefill), 5 (a beam-5 step) and 8 (a full launch of a prompt window)
    bh, s_pad, s_valid = BATCH * 12, 1536, 1500
    k_t = torch.randn(bh, 64, s_pad, generator=gen, device=dev).to(bf16)
    v_t = torch.randn(bh, 64, s_pad, generator=gen, device=dev).to(bf16)
    errs = []
    for kq in (1, 3, 5, 8):
        qg = (torch.randn(bh, kq, 64, generator=gen, device=dev) * 0.125).to(bf16)
        res = check_grouped(f"cross_attention_grouped K={kq}", qg,
                            (k_t, v_t, None, None), s_valid)
        if kq == 1:
            results["cross"] = res
        elif kq == 8:   # the greedy-prompt-ts prefill's full launches
            results["cross_wide"] = res
        else:
            errs.append(res["max_abs_err"])
    results["cross"]["max_abs_err"] = max(errs + [results["cross"]["max_abs_err"]])
    del k_t, v_t
    # the same widths at the headline batch's 1152 rows, and 5 slots at the
    # beam runs' 192, as the int8 and int4 bodies are timed
    bh = HEAD_BATCH * 12
    k_t, v_t = (torch.randn(bh, 64, s_pad, generator=gen, device=dev).to(bf16)
                for _ in range(2))
    for kq, rows in ((1, bh), (3, bh), (5, bh), (8, bh), (5, 16 * 12)):
        qg = (torch.randn(rows, kq, 64, generator=gen, device=dev) * 0.125).to(bf16)
        check_grouped(f"cross_attention_grouped K={kq}", qg,
                      (k_t[:rows], v_t[:rows], None, None), s_valid)
    del k_t, v_t

    # self-attention update over a 64-row bf16 cache, and with the mixed
    # `start` of the greedy-prompt-ts run (16 - prompt length: 0..12)
    errs = []
    for pos in (3, 30, 63):
        res = check_update("self_attention_update", bh, pos, gen, False, None)
        if pos == 30:
            results["self"] = res
        errs.append(res["max_abs_err"])
    results["self"]["max_abs_err"] = max(errs)
    start = (torch.arange(bh, device=dev) // 12 * 5 % 13).to(torch.int32)
    results["self_start"] = check_update("self_attention_update start", bh, 30,
                                         gen, False, start)


def check_tq(x: torch.Tensor, h: int) -> tuple:
    """`transpose_quant_kv` on x (B, S, H * 64) bit for bit against its plain
    version, timed beside it and its bound; returns the result entry, the
    codes and the scales."""
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        transpose_quant_kv, transpose_quant_kv_ref)

    q, sc = transpose_quant_kv(x, h)
    q_ref, sc_ref = transpose_quant_kv_ref(x, h)
    what = f"{tuple(x.shape)} bf16 -> {tuple(q.shape)} int8"
    check(torch.equal(q, q_ref) and torch.equal(sc, sc_ref),
          f"transpose_quant_kv {what}: codes or scales differ from the plain version")
    res = {"max_abs_err": max(max_err(q, q_ref), max_err(sc, sc_ref)),
           "ms": cuda_ms(lambda: transpose_quant_kv(x, h)),
           "plain_ms": cuda_ms(lambda: transpose_quant_kv_ref(x, h)),
           # an abs, a max, a divide and a rounding per element, f32
           **bound(nbytes(x, q, sc), 4 * x.numel() / F32_FLOPS),
           "library_ms": None}
    log(f"phase1 transpose_quant_kv {what}: codes and scales equal; kernel "
        f"{res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms least "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']})")
    return res, q, sc


def phase1_quantized(dev, results: dict) -> None:
    """The int8/int4-KV kernels at the shapes of bench.py's batch 96."""
    from openai_whisper_compression_tpu_torch.models.whisper import _quant_kv4_t
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        transpose_kv, transpose_quant_kv)

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf16 = torch.bfloat16
    b, s, h = HEAD_BATCH, 1500, 12
    bh = b * h

    # transpose + int8 quantize of a cross K and a cross V projection, and of
    # whisper-medium's at its preset's batch 64 (the medium-int4 run)
    xk, xv = ((torch.randn(b, s, h * 64, generator=gen, device=dev) * 0.4).to(bf16)
              for _ in range(2))
    results["tq"], k8, ks8 = check_tq(xk, h)
    v8, vs8 = transpose_quant_kv(xv, h)
    check_tq((torch.randn(MEDIUM_BATCH, s, 1024, generator=gen, device=dev) * 0.4)
             .to(bf16), 16)
    k4, ks4 = _quant_kv4_t(transpose_kv(xk, h))
    v4, vs4 = _quant_kv4_t(transpose_kv(xv, h))
    t_q4 = cuda_ms(lambda: _quant_kv4_t(transpose_kv(xk, h)))
    log(f"phase1 int4 cross-KV transpose + quantize + pack ({b}, {s}, "
        f"{h * 64}) bf16, plain torch (no kernel, as in the JAX package): "
        f"{t_q4:.4f} ms")
    del xk, xv

    # int8 and int4 grouped cross-attention: K = 1 (a greedy step), 3 (the
    # prefix's prefill), 5 and 8 at batch 96; then K = 5 at the beam runs'
    # batch 16 (B*H = 192), the shape their decode steps give the kernel
    beam_bh = 16 * h
    for key, what, kv in (("cross_int8", "int8", (k8, v8, ks8, vs8)),
                          ("cross_int4", "int4", (k4, v4, ks4, vs4))):
        errs = []
        for kq in (1, 3, 5, 8):
            qg = (torch.randn(bh, kq, 64, generator=gen, device=dev) * 0.125).to(bf16)
            res = check_grouped(f"cross_attention_grouped {what} K={kq}", qg, kv, s)
            if kq == 1:
                results[key] = res
            errs.append(res["max_abs_err"])
        results[key]["max_abs_err"] = max(errs)
        qg = (torch.randn(beam_bh, 5, 64, generator=gen, device=dev) * 0.125).to(bf16)
        results[key + "_wide"] = check_grouped(
            f"cross_attention_grouped {what} K=5", qg,
            tuple(t[:beam_bh] for t in kv), s)
    del k8, v8, k4, v4

    # int8 self-attention update over a 64-row int8 cache, and with the mixed
    # `start` of the beam5-prompt run at its 16 x 5 rows (B*H = 960)
    errs = []
    for pos in (3, 30, 63):
        res = check_update("self_attention_update_int8", bh, pos, gen, True, None)
        if pos == 30:
            results["self_int8"] = res
        errs.append(res["max_abs_err"])
    results["self_int8"]["max_abs_err"] = max(errs)
    rows = 16 * 5 * h
    start = (torch.arange(rows, device=dev) // (5 * h) * 5 % 13).to(torch.int32)
    results["self_int8_start"] = check_update("self_attention_update_int8 start",
                                              rows, 30, gen, True, start)


def phase1_attention(dev, results: dict) -> None:
    """The encoder attention at whisper-small batch 96 (B*H = 1152) and
    whisper-medium batch 64 (B*H = 1024), T = 1500, on (B, H, T, 64) views
    of (B, T, H*64) projections (the strided layout the model hands it),
    against its plain version on all rows (its f32 scores, 10.4 and 9.2 GB,
    fit beside the inputs), beside PyTorch's fused attention."""
    from openai_whisper_compression_tpu_torch.models.whisper import split_heads
    from openai_whisper_compression_tpu_torch.ops.attention import (
        encoder_attention, encoder_attention_ref)

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    t = 1500
    # the card's second operations bound: one exponential per score on the
    # special-function units, 16 a clock on each SM, at the card's top clock
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, b, h in (("small", HEAD_BATCH, 12), ("medium", MEDIUM_BATCH, 16)):
        q, k, v = (split_heads(torch.randn(b, t, h * 64, generator=gen, device=dev)
                               .to(torch.bfloat16), h) for _ in range(3))
        got = encoder_attention(q, k, v)
        torch.cuda.synchronize()
        ref = encoder_attention_ref(q, k, v)
        err, tol = max_err(got, ref), BF16_REL * float(ref.float().abs().max())
        check(got.shape == (b, h, t, 64) and bool(torch.isfinite(got).all()),
              f"encoder_attention {name}: output not finite or of shape "
              f"{tuple(got.shape)}")
        check(err <= tol, f"encoder_attention {name}: err {err} > {tol}")
        del ref
        t_k = cuda_ms(lambda: encoder_attention(q, k, v))
        t_p = cuda_ms(lambda: encoder_attention_ref(q, k, v), warmup=1, iters=3)
        t_lib = cuda_ms(lambda: sdpa(q, k, v))
        flop = 4 * b * h * t * t * 64
        least = bound(4 * b * h * t * 64 * 2, flop / BF16_FLOPS)
        ex2_ms = 1e3 * b * h * t * t / (sm_count * 16 * sm_mhz * 1e6)
        res = {"max_abs_err": err, "ms": t_k, "plain_ms": t_p, **least,
               "library_ms": t_lib}
        if name == "small":
            results["enc_attn"] = res
        log(f"phase1 encoder_attention {name} ({b}, {h}, {t}, 64) bf16: err "
            f"{err:.3g} (bound {tol:.3g}) kernel {t_k:.4f} ms "
            f"({flop / t_k / 1e9:.1f} TFLOP/s) plain {t_p:.4f} ms sdpa "
            f"{t_lib:.4f} ms least {least['bound_ms']:.4f} ms ({least['bound_by']}); "
            f"its exponentials alone {ex2_ms:.4f} ms ({sm_count} SMs x 16 a clock "
            f"at {sm_mhz:.0f} MHz)")
        del q, k, v, got
        torch.cuda.empty_cache()
    # times only, at a length of whole 128-key tiles: what the ragged T = 1500
    # costs the kernel and the library call
    b, h, t = HEAD_BATCH, 12, 1536
    q, k, v = (split_heads(torch.randn(b, t, h * 64, generator=gen, device=dev)
                           .to(torch.bfloat16), h) for _ in range(3))
    t_k, t_lib = cuda_ms(lambda: encoder_attention(q, k, v)), cuda_ms(lambda: sdpa(q, k, v))
    flop = 4 * b * h * t * t * 64
    log(f"phase1 encoder_attention small ({b}, {h}, {t}, 64) bf16, whole tiles: kernel "
        f"{t_k:.4f} ms ({flop / t_k / 1e9:.1f} TFLOP/s) sdpa {t_lib:.4f} ms")
    del q, k, v
    torch.cuda.empty_cache()


def int_mm_library(x, w, scale, act_scale=None):
    """The same function through PyTorch's int8 product (cuBLASLt), timed
    beside the w8a8 kernel as a yardstick only: nothing in the port calls
    it."""
    from openai_whisper_compression_tpu_torch.ops.quant_matmul import (
        quantize_act_int8)

    xq, sx = quantize_act_int8(x, act_scale)
    return (torch._int_mm(xq, w).float() * sx * scale).to(x.dtype)


def phase1_w8a8(dev, results: dict) -> None:
    """The w8a8 matmul, dynamic and static, at whisper-small's four linears
    at M = 96 (a decode step of the small-w8a8-dyn run) and M = 96 x 1500
    (its encoder), bf16 activations, on the call `linear` makes
    (`kernel_call`): bit-equal to its plain version, with times beside the
    plain version, quantize + `torch._int_mm` + epilogue, and
    `torch.matmul(x, dequantize(q, bf16))`, the call the weight-only path
    makes at that M. Under torch.profiler: a decode-M call is one kernel,
    and how an encoder-scale call's time splits between its quantize pass
    and its GEMM."""
    from openai_whisper_compression_tpu_torch.config import ARCHS
    from openai_whisper_compression_tpu_torch.ops.linear import kernel_call
    from openai_whisper_compression_tpu_torch.ops.qtensor import dequantize
    from openai_whisper_compression_tpu_torch.ops.quant_matmul import (
        w8a8_matmul, w8a8_matmul_ref)
    from openai_whisper_compression_tpu_torch.quant.core import quantize_int8
    from torch.profiler import ProfilerActivity, profile as tprofile

    def kernels_of(call) -> dict:
        """Device kernel name -> (calls, device ms) of one run of `call`."""
        call()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        return {e.key: (e.count, e.self_device_time_total / 1e3)
                for e in device_kernels(prof.key_averages())}

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    for k, n, what in linear_shapes(ARCHS[ARCH]):
        q = quantize_int8(torch.randn(k, n, generator=gen, device=dev) * 0.02)
        for m in (HEAD_BATCH, HEAD_BATCH * 1500):
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            x[m // 2] = 0.0   # an all-zero row: the scale's 1e-12 floor
            # a frozen scale as a calibration would leave it: absmax / 127
            frozen = (x.abs().max().float() / 127.0).reshape(())
            few = {"warmup": 1, "iters": 3} if m > 1024 else {}
            t_d = cuda_ms(lambda: torch.matmul(x, dequantize(q, torch.bfloat16)), **few)
            for key, qa in (("w8a8", dataclasses.replace(q, act="dynamic_int8")),
                            ("w8a8_static", dataclasses.replace(
                                q, act="static_int8", act_scale=frozen))):
                fn, plain_fn, args = kernel_call(qa)
                check(fn is w8a8_matmul and plain_fn is w8a8_matmul_ref,
                      f"{key}: linear does not launch w8a8_matmul")
                got = fn(x, *args)
                torch.cuda.synchronize()
                ref = plain_fn(x, *args)
                check(got.shape == (m, n) and got.dtype == x.dtype
                      and bool(torch.isfinite(got).all()),
                      f"{key} M={m} K={k} N={n}: output not finite or of shape "
                      f"{tuple(got.shape)}")
                check(torch.equal(got, ref),
                      f"{key} M={m} K={k} N={n}: differs from the plain version "
                      f"(max {max_err(got, ref)})")
                lib = int_mm_library(x, *args)
                lib_err = max_err(lib, ref)
                del ref, lib
                t_k = cuda_ms(lambda: fn(x, *args), **few)
                t_p = cuda_ms(lambda: plain_fn(x, *args), **few)
                t_l = cuda_ms(lambda: int_mm_library(x, *args), **few)
                least = bound(nbytes(x, got, *args), 2 * m * k * n / INT8_OPS)
                if (m, what) == (HEAD_BATCH, "qkv"):
                    results[key] = {"max_abs_err": 0.0, "ms": t_k, "plain_ms": t_p,
                                    **least, "library_ms": t_l}
                    ks = kernels_of(lambda: fn(x, *args))
                    check(sum(c for c, _ in ks.values()) == 1,
                          f"{key} M={m}: a decode-step call enqueued {ks}, not one kernel")
                    log(f"phase1 {key} M={m} ({what}): one kernel a call, "
                        f"{list(ks)[0][:60]}")
                log(f"phase1 {key} M={m} K={k} N={n} ({what}): equal to the plain "
                    f"version bit for bit; kernel {t_k:.4f} ms "
                    f"({2 * m * k * n / t_k / 1e9:.1f} TOP/s) plain {t_p:.4f} ms "
                    f"quantize+torch._int_mm+epilogue {t_l:.4f} ms (off by "
                    f"{lib_err:.3g}) dequant+torch.matmul {t_d:.4f} ms least "
                    f"{least['bound_ms']:.5f} ms ({least['bound_by']})")
                if m > 1024 and (key, what) == ("w8a8", "fc1"):
                    ks = kernels_of(lambda: fn(x, *args))
                    quant = sum(t for name, (_, t) in ks.items() if "quantize" in name)
                    total = sum(t for _, t in ks.values())
                    log(f"phase1 {key} M={m} ({what}) under torch.profiler: "
                        f"quantize pass {quant:.4f} ms of {total:.4f} ms "
                        f"({', '.join(f'{nm[:40]} {t:.4f}' for nm, (_, t) in ks.items())})")
                del got
            del x
        torch.cuda.empty_cache()


def phase1_small_batch(dev, results: dict) -> None:
    """The one-query cross-attention at 12 and 36 rows (whisper-small at
    batch 1 and 3) over bf16, int8 and int4 K/V, against its plain version
    and against the grouped kernel at one slot on the same inputs; and the
    read-only self-attention at (384, 64, 64) bf16 and (1152, 64, 64) int8,
    pos 30, without and with a mixed `start`, against its plain version and
    bit for bit against the update kernel's output."""
    from openai_whisper_compression_tpu_torch.models.whisper import _quant_kv4_t
    from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        decode_cross_attention, decode_cross_attention_grouped,
        decode_cross_attention_ref, transpose_kv, transpose_quant_kv)

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    bf16 = torch.bfloat16
    s, h = 1500, 12
    for b in (1, 3):
        bh = b * h
        xk, xv = ((torch.randn(b, s, h * 64, generator=gen, device=dev) * 0.4).to(bf16)
                  for _ in range(2))
        (k8, ks8), (v8, vs8) = (transpose_quant_kv(t, h) for t in (xk, xv))
        (k4, ks4), (v4, vs4) = (_quant_kv4_t(transpose_kv(t, h)) for t in (xk, xv))
        kb, vb = (transpose_kv(t, h) for t in (xk, xv))
        qf = (torch.randn(bh, 64, generator=gen, device=dev) * 0.125).to(bf16)
        for key, what, kv in (("cross1", "bf16", (kb, vb, None, None)),
                              ("cross1_int8", "int8", (k8, v8, ks8, vs8)),
                              ("cross1_int4", "int4", (k4, v4, ks4, vs4))):
            got = decode_cross_attention(qf, *kv, s)
            ref = decode_cross_attention_ref(qf, *kv, s)
            grouped = decode_cross_attention_grouped(qf[:, None, :].contiguous(),
                                                     *kv, s)[:, 0, :]
            err, tol = max_err(got, ref), BF16_REL * float(ref.float().abs().max())
            err_g = max_err(got, grouped)
            check(got.shape == (bh, 64) and err <= tol,
                  f"cross_attention {what} BH={bh}: err {err} > {tol}")
            check(err_g <= tol, f"cross_attention {what} BH={bh}: off by {err_g} "
                                f"from the grouped kernel at one slot (> {tol})")
            t_k = cuda_ms(lambda: decode_cross_attention(qf, *kv, s))
            t_c = cuda_ms_cold(lambda *a: decode_cross_attention(*a, s), [qf, *kv])
            t_p = cuda_ms(lambda: decode_cross_attention_ref(qf, *kv, s))
            t_g = cuda_ms(lambda: decode_cross_attention_grouped(
                qf[:, None, :], *kv, s))
            least = bound(nbytes(qf, got) + s / kv[0].shape[2] * nbytes(*kv),
                          4 * bh * 64 * s / BF16_FLOPS)
            t_lib = None
            if kv[2] is None:
                k, v = (t[:, :, :s].transpose(1, 2) for t in kv[:2])
                t_lib = cuda_ms(lambda: sdpa(qf[:, None, :], k, v, scale=1.0))
            res = {"max_abs_err": err, "ms": t_k, "plain_ms": t_p, **least,
                   "library_ms": t_lib}
            if b == 1:
                results[key] = res
            else:
                results[key]["max_abs_err"] = max(err, results[key]["max_abs_err"])
            log(f"phase1 cross_attention {what} BH={bh} s_valid {s}: err {err:.3g}, "
                f"from the grouped kernel {err_g:.3g} (bound {tol:.3g}) kernel "
                f"{t_k:.4f} ms (cold {t_c:.4f} ms) grouped kernel {t_g:.4f} ms plain "
                f"{t_p:.4f} ms least "
                f"{least['bound_ms']:.5f} ms ({least['bound_by']})"
                + ("" if t_lib is None else f" sdpa {t_lib:.4f} ms"))

    pos = 30
    for int8, bh, key in ((False, BATCH * h, "attend"), (True, HEAD_BATCH * h,
                                                         "attend_int8")):
        for with_start in (False, True):
            start = ((torch.arange(bh, device=dev) // h * 5 % 13).to(torch.int32)
                     if with_start else None)
            qf = (torch.randn(bh, 64, generator=gen, device=dev) * 0.125).to(bf16)
            kn, vn = (torch.randn(2, bh, 64, generator=gen, device=dev) * 2).to(bf16)
            if int8:
                kc, vc = torch.randint(-127, 128, (2, bh, 64, 64), generator=gen,
                                       device=dev, dtype=torch.int8)
                ks, vs = torch.rand(2, bh, 64, generator=gen, device=dev) * 0.03 + 1e-3
                bufs, scales = [kc, vc, ks, vs], {"k_scale": ks, "v_scale": vs}
                upd = sas.decode_self_attention_update_int8
            else:
                bufs = [torch.randn(bh, 64, 64, generator=gen, device=dev).to(bf16)
                        for _ in range(2)]
                scales, upd = {}, sas.decode_self_attention_update
            out_upd = upd(qf, kn, vn, *bufs, pos, start=start)
            written = [t.clone() for t in bufs]

            def attend():
                return sas.decode_self_attention(qf, bufs[0], bufs[1], pos,
                                                 start=start, **scales)

            got = attend()
            ref = sas.decode_self_attention_ref(qf, bufs[0], bufs[1], pos,
                                                start=start, **scales)
            what = f"self_attention{'_int8' if int8 else ''}" + (
                " start" if with_start else "")
            err, tol = max_err(got, ref), BF16_REL * float(ref.float().abs().max())
            check(torch.equal(got, out_upd),
                  f"{what}: differs from the update kernel's output on the cache "
                  f"it wrote (max {max_err(got, out_upd)})")
            check(all(torch.equal(a, b) for a, b in zip(bufs, written)),
                  f"{what}: the read-only kernel wrote to the cache")
            check(err <= tol, f"{what}: err {err} > {tol}")
            t_k = cuda_ms(attend)
            cold = ""
            if int8:
                t_c = cuda_ms_cold(lambda q_, *b: sas.decode_self_attention(
                    q_, b[0], b[1], pos, start=start, k_scale=b[2], v_scale=b[3]),
                    [qf, *bufs])
                cold = f" (cold {t_c:.4f} ms)"
            t_p = cuda_ms(lambda: sas.decode_self_attention_ref(
                qf, bufs[0], bufs[1], pos, start=start, **scales))
            rows = bh * (pos + 1) - (0 if start is None else int(start.sum()))
            per_row = sum(t[0, 0].numel() * t.element_size() for t in bufs)
            least = bound(nbytes(qf, got) + per_row * rows, 4 * 64 * rows / BF16_FLOPS)
            t_lib = None
            if not int8:
                # one sdpa call computes the bf16 bodies; `start` is a boolean
                # mask (True = attend), built once outside the timed call
                mask = (None if start is None else
                        (torch.arange(pos + 1, device=dev) >= start[:, None])[:, None])
                lib = sdpa(qf[:, None, :], bufs[0][:, : pos + 1], bufs[1][:, : pos + 1],
                           attn_mask=mask, scale=1.0)[:, 0]
                check(max_err(lib, ref) <= tol,
                      f"{what}: sdpa is off by {max_err(lib, ref)} (> {tol}): "
                      f"not the same function")
                t_lib = cuda_ms(lambda: sdpa(qf[:, None, :], bufs[0][:, : pos + 1],
                                             bufs[1][:, : pos + 1], attn_mask=mask,
                                             scale=1.0))
            results[key + ("_start" if with_start else "")] = {
                "max_abs_err": err, "ms": t_k, "plain_ms": t_p, **least,
                "library_ms": t_lib}
            log(f"phase1 {what} pos={pos} ({bh}, 64, 64): equal to the update "
                f"kernel's output bit for bit; err {err:.3g} (bound {tol:.3g}) kernel "
                f"{t_k:.4f} ms{cold} plain {t_p:.4f} ms least {least['bound_ms']:.5f} ms "
                f"({least['bound_by']})"
                + ("" if t_lib is None else f" sdpa {t_lib:.4f} ms"))


def phase1_dtypes(dev, results: dict) -> None:
    """The f32 and f16 bodies of the decode attention kernels against their
    plain versions, at the shapes of the runs that launch them: the cache
    update at 192 rows (small-f32, batch 16) and, with the mixed `start` of
    the small-f16-beam5 run, at its 8 x 5 x 12 = 480 rows; the grouped
    cross-attention at 1 slot over 192 rows and at 5 slots over the beam
    run's 96 rows; the one-query cross-attention at 36 rows (batch 3). Two
    bodies that no run launches are held and timed here only: the int8 cache
    update under f32 and f16 q, and the read-only self-attention over an f32
    and an f16 cache (bit for bit against the update kernel's output)."""
    from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        decode_cross_attention, decode_cross_attention_ref)

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    h, s_pad, s_valid = 12, 1536, 1500
    rows, beam_rows = 16 * h, 8 * 5 * h
    start = (torch.arange(beam_rows, device=dev) // (5 * h) * 5 % 13).to(torch.int32)
    for dtype, tag in ((torch.float32, "f32"), (torch.float16, "f16")):
        results["self_" + tag] = check_update(
            f"self_attention_update {tag}", rows, 30, gen, False, None, dtype)
        res = check_update(f"self_attention_update {tag} start", beam_rows, 30, gen,
                           False, start, dtype)
        if tag == "f16":
            results["self_f16_start"] = res
        check_update(f"self_attention_update_int8 {tag} q", rows, 30, gen, True, None,
                     dtype)
        qf = (torch.randn(rows, 64, generator=gen, device=dev) * 0.125).to(dtype)
        kn, vn = (torch.randn(2, rows, 64, generator=gen, device=dev) * 2).to(dtype)
        kc, vc = (torch.randn(rows, 64, 64, generator=gen, device=dev).to(dtype)
                  for _ in range(2))
        out_upd = sas.decode_self_attention_update(qf, kn, vn, kc, vc, 30)
        check(torch.equal(sas.decode_self_attention(qf, kc, vc, 30), out_upd),
              f"self_attention {tag}: differs from the update kernel's output on "
              "the cache it wrote")
        t_k = cuda_ms(lambda: sas.decode_self_attention(qf, kc, vc, 30))
        t_p = cuda_ms(lambda: sas.decode_self_attention_ref(qf, kc, vc, 30))
        log(f"phase1 self_attention {tag} pos=30 ({rows}, 64, 64): equal to the "
            f"update kernel's output bit for bit; kernel {t_k:.4f} ms plain "
            f"{t_p:.4f} ms")
        k_t, v_t = (torch.randn(rows, 64, s_pad, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
        for kq, bh in ((1, rows), (5, 8 * h)):
            qg = (torch.randn(bh, kq, 64, generator=gen, device=dev) * 0.125).to(dtype)
            res = check_grouped(f"cross_attention_grouped {tag} K={kq}", qg,
                                (k_t[:bh], v_t[:bh], None, None), s_valid)
            if kq == 1:
                results["cross_" + tag] = res
            elif tag == "f16":
                results["cross_f16_wide"] = res
        bh = 3 * h
        qf = (torch.randn(bh, 64, generator=gen, device=dev) * 0.125).to(dtype)
        kv = (k_t[:bh], v_t[:bh], None, None)
        got = decode_cross_attention(qf, *kv, s_valid)
        ref = decode_cross_attention_ref(qf, *kv, s_valid)
        err, tol = max_err(got, ref), KERNEL_REL[dtype] * float(ref.float().abs().max())
        check(got.shape == (bh, 64) and got.dtype == dtype and err <= tol,
              f"cross_attention {tag} BH={bh}: err {err} > {tol}")
        t_k = cuda_ms(lambda: decode_cross_attention(qf, *kv, s_valid))
        t_c = cuda_ms_cold(lambda *a: decode_cross_attention(*a, s_valid), [qf, *kv])
        t_p = cuda_ms(lambda: decode_cross_attention_ref(qf, *kv, s_valid))
        k, v = (t[:, :, :s_valid].transpose(1, 2) for t in kv[:2])
        t_lib = cuda_ms(lambda: sdpa(qf[:, None, :], k, v, scale=1.0))
        least = bound(nbytes(qf, got) + s_valid / s_pad * nbytes(*kv),
                      4 * bh * 64 * s_valid / peak_flops(dtype))
        results["cross1_" + tag] = {"max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                                    **least, "library_ms": t_lib}
        log(f"phase1 cross_attention {tag} BH={bh} s_valid {s_valid}: err {err:.3g} "
            f"(bound {tol:.3g}) kernel {t_k:.4f} ms (cold {t_c:.4f} ms) plain "
            f"{t_p:.4f} ms least "
            f"{least['bound_ms']:.5f} ms ({least['bound_by']}) sdpa {t_lib:.4f} ms")
        del k_t, v_t


def phase1_crossover(dev) -> None:
    """Every storage trait of the dequant-matmul beside dequant +
    torch.matmul at whisper-small's qkv (768 x 2304) and fc2 (3072 x 768),
    M = 32, 96, 288 and 1024 (the largest M `linear` still sends to the
    kernels): where the two cross. Times only; the checks are elsewhere."""
    from openai_whisper_compression_tpu_torch.ops.linear import kernel_call
    from openai_whisper_compression_tpu_torch.ops.qtensor import dequantize
    from openai_whisper_compression_tpu_torch.quant.core import QUANTIZERS

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf16 = torch.bfloat16
    for k, n, what in ((768, 2304, "qkv"), (3072, 768, "fc2")):
        w = torch.randn(k, n, generator=gen, device=dev) * 0.02
        for method in ("int8", "int4", "nf4", "hqq_int4", "hqq_int8"):
            q = QUANTIZERS[method](w)
            fn, _, args = kernel_call(q)
            cells = []
            for m in (32, 96, 288, 1024):
                x = torch.randn(m, k, generator=gen, device=dev).to(bf16)
                t_k = cuda_ms(lambda: fn(x, *args))
                t_d = cuda_ms(lambda: torch.matmul(x, dequantize(q, bf16)))
                cells.append(f"M={m} {t_k:.4f} vs {t_d:.4f}")
            log(f"phase1 crossover {method} {what} K={k} N={n}, kernel vs "
                f"dequant+torch.matmul ms: " + "; ".join(cells))


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
                tol = BF16_REL * float(ref.float().abs().max())
                check(got.shape == (m, n) and err <= tol,
                      f"{label} {arch_name} M={m} K={k} N={n}: err {err} > {tol}")
                errs.append(err)
                t_k, t_p = cuda_ms(kernel), cuda_ms(plain)
                t_d = cuda_ms(lambda: torch.matmul(x, dequantize(q, bf16)))
                least = bound(nbytes(x, got, *args), 2 * m * k * n / BF16_FLOPS)
                if (arch_name, m, what) == (*step, "qkv") and key not in results:
                    results[key] = {"ms": t_k, "plain_ms": t_p, **least,
                                    "library_ms": t_d}
                log(f"phase1 {label} {arch_name} M={m} K={k} N={n} ({what}): err "
                    f"{err:.3g} (bound {tol:.3g}) kernel {t_k:.4f} ms plain "
                    f"{t_p:.4f} ms dequant+torch.matmul {t_d:.4f} ms least "
                    f"{least['bound_ms']:.5f} ms ({least['bound_by']})")
        results[key]["max_abs_err"] = max(errs + [results[key].get("max_abs_err", 0.0)])


def make_params(dev, arch_name: str, method: str):
    """Seeded random bf16 weights of `arch_name`, `quantize_params(method)`
    (a QUANTIZERS method or a REGISTRY name), decoder qkv fused."""
    from openai_whisper_compression_tpu_torch.config import ARCHS
    from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
    from openai_whisper_compression_tpu_torch.models.params import init_params
    from openai_whisper_compression_tpu_torch.quant.api import (REGISTRY,
                                                                quantize_params)

    arch = ARCHS[arch_name]
    params = init_params(arch, seed=SEED, dtype=torch.bfloat16, device=dev)
    params = fuse_qkv(quantize_params(params, method))
    if method in REGISTRY and REGISTRY[method].needs_calibration:
        params = calibrate(dev, arch, params, method)
    return arch, params


def calibrate(dev, arch, params, method: str):
    """`calibrate_static` on the card: one eager transcription of a batch of
    32 (the first batch of the configuration's run; uncalibrated tensors
    quantize per row meanwhile) records every quantized linear's input
    absmax, which is frozen into its `act_scale`."""
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import (
        make_transcribe_fn)
    from openai_whisper_compression_tpu_torch.models.params import named_leaves
    from openai_whisper_compression_tpu_torch.ops.qtensor import QTensor
    from openai_whisper_compression_tpu_torch.quant.api import calibrate_static

    fn = make_transcribe_fn(arch, DecodeConfig(
        max_new_tokens=NEW_TOKENS, suppress_tokens=(arch.eos_token_id,), **KV8),
        fast_mel=True, fast_gelu=True, device=dev)
    wav = torch.from_numpy(waveforms(SEED, BATCH)).to(dev)
    t0 = time.perf_counter()
    frozen = calibrate_static(params, lambda p: fn(p, wav))
    scales = [leaf.act_scale for _, leaf in named_leaves(frozen)
              if isinstance(leaf, QTensor)]
    check(len(scales) == 6 * arch.encoder_layers + 8 * arch.decoder_layers
          and all(s is not None and s.dim() == 0 and s.is_cuda and float(s) > 0
                  for s in scales),
          f"{method}: a quantized linear was left without a positive act_scale")
    log(f"phase2 calibrate {method}: {len(scales)} activation scales in "
        f"{time.perf_counter() - t0:.2f} s, min {min(map(float, scales)):.4g} max "
        f"{max(map(float, scales)):.4g}")
    return frozen


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

    if len(gen) == 1:   # one row: the token of its 13th step, so it stops by then
        twin = int(gen[0, 12])
    else:
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


def check_launches(name: str, launches: dict, path, exact: dict) -> None:
    """Every kernel of `path` launched (exactly `exact[k]` times where
    given), and no kernel outside it."""
    for k, count in launches.items():
        if k in exact:
            check(count == exact[k],
                  f"{name}: kernel {k} launched {count} times, expected {exact[k]}")
        elif k in path:
            check(count > 0, f"{name}: kernel {k} was not launched on its path")
        else:
            check(count == 0, f"{name}: kernel {k} launched outside its path")


def expected_launches(arch, path, steps: list) -> dict:
    """How often one run's path calls the kernels whose count is known
    exactly, given the decoder steps of each batch: the encoder attention
    once per encoder layer and batch (never for an f32 or f16 tree, whose
    path does not hold it); the w8a8 matmul for every quantized
    linear (6 an encoder layer, per decoder layer the cross K and V, 6 in
    the prefill and 6 a step); the cache update once per layer and step; the
    grouped cross-attention once per layer for the prefill window and once
    per layer and step, but in a run at small batch for the prefill window
    alone: there the one-query cross-attention takes the steps."""
    n, layers, total = len(steps), arch.decoder_layers, sum(steps)
    exact = {"encoder_attention":
             arch.encoder_layers * n if "encoder_attention" in path else 0}
    for k in path:
        if k.startswith("decode_self_attention_update"):
            exact[k] = layers * total
        if k.startswith("decode_cross_attention_grouped"):
            exact[k] = layers * (n + total)
    for k in path:
        if k.startswith("w8a8_matmul"):
            exact[k] = n * (6 * arch.encoder_layers + 8 * layers) + 6 * layers * total
        if k.startswith("decode_cross_attention") and "grouped" not in k:
            exact[k] = layers * total
            exact[k.replace("attention", "attention_grouped")] = layers * n
    return exact


def prompt_window(arch, seed: int, batch: int):
    """Seeded right-aligned prompts: (batch, PROMPT_W) text-token ids, the
    left padding holding EOT, and their lengths mixed over 4..PROMPT_W."""
    rng = np.random.default_rng(seed)
    lens = 4 + (np.arange(batch) * 5) % (PROMPT_W - 3)
    prompt = rng.integers(1000, 20000, (batch, PROMPT_W))
    prompt[np.arange(PROMPT_W)[None, :] < (PROMPT_W - lens)[:, None]] = arch.eos_token_id
    return torch.from_numpy(prompt), torch.from_numpy(lens.astype(np.int32))


def expected_prompt_launches(arch, cfg, p_len: int, batches: int,
                             dtype=torch.bfloat16) -> dict:
    """How often one prompt run's path calls each attention kernel, the
    tree's activations being of `dtype`: the encoder attention once per
    encoder layer (bf16 only); per decoder layer the prefill
    window in launches of at most 8 slots and one grouped launch per step
    (of beam_size slots), one cache update per step, and the cross-KV
    quantization of K and V."""
    fp = {torch.bfloat16: "", torch.float32: "_f32", torch.float16: "_f16"}[dtype]
    cross = "decode_cross_attention_grouped" + (
        "_int4" if cfg.cross_kv_int4 else "_int8" if cfg.cross_kv_int8 else fp)
    update = "decode_self_attention_update" + ("_int8" if cfg.kv_int8 else fp)
    window = PROMPT_W + p_len - 1
    chunks = [min(8, window - j0) for j0 in range(0, window, 8)]
    wide = sum(c > 4 for c in chunks) + NEW_TOKENS * (cfg.beam_size > 4)
    narrow = sum(c <= 4 for c in chunks) + NEW_TOKENS * (cfg.beam_size <= 4)
    layers = arch.decoder_layers
    exact = {"log_mel_cuda": 1, "encoder_attention":
             arch.encoder_layers if dtype == torch.bfloat16 else 0,
             cross + "_wide": layers * wide, cross: layers * narrow,
             update + "_start": layers * NEW_TOKENS}
    if cfg.cross_kv_int8 and not cfg.cross_kv_int4:
        exact["transpose_quant_kv"] = 2 * layers
    return {k: n * batches for k, n in exact.items()}


@torch.inference_mode()
def rescore(params, arch, cfg, enc, seqs, prompt, lens, first_gen: int):
    """Summed logprob of seqs[:, first_gen: first_gen + NEW_TOKENS] under
    teacher forcing, one row per sequence (enc, prompt and lens hold that
    row's utterance), through the greedy step with cfg's caches and
    suppressions."""
    from openai_whisper_compression_tpu_torch.models import decode

    cfg1 = dataclasses.replace(cfg, beam_size=1)
    cross_kvs, cache, tokens, start, fg, _ = decode._prepare(
        params, arch, enc, cfg1, None, prompt, lens)
    check(fg == first_gen, "rescoring starts at another position")
    logits_fn, _ = decode._logits_fn(params, arch, cfg1, cross_kvs, start, fg, 1,
                                     enc.device)
    last_ts = torch.zeros(enc.shape[0], dtype=torch.long, device=enc.device)
    total = torch.zeros(enc.shape[0], dtype=torch.float32, device=enc.device)
    for pos in range(fg - 1, fg - 1 + NEW_TOKENS):
        logp = torch.log_softmax(logits_fn(seqs, cache, pos, last_ts).float(), -1)
        total += logp.gather(1, seqs[:, pos + 1: pos + 2])[:, 0]
    return total


def run_prompt_path(dev, arch, params, run, profile: bool = False) -> dict:
    """One prompt-conditioned phase-2 run (see PROMPT_RUNS): mel, encoder,
    then `beam_decode` or `greedy_decode` with a left-padded prompt window;
    exact launch counts, the output contract, and the run's own checks
    (`profile`: one more batch under torch.profiler)."""
    from openai_whisper_compression_tpu_torch.audio.features import preprocess
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.models import decode
    from openai_whisper_compression_tpu_torch.models.whisper import encode

    name, switches, batch, method = (*run, "int8")[:4]
    dtype = params["encoder"]["ln"]["g"].dtype
    eot = arch.eos_token_id
    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, suppress_tokens=(eot,), **switches)
    beam = cfg.beam_size
    prefix = decode.forced_prefix(arch, cfg)
    first_gen = PROMPT_W + len(prefix)
    log(f"phase2 {name}: {arch.name}, {method} weights, batch {batch}, prompt window "
        f"{PROMPT_W}, prefix {prefix}, {json.dumps(switches)}")
    n_batches = 2
    wavs = [torch.from_numpy(waveforms(SEED + 10 + i, batch)).to(dev)
            for i in range(n_batches)]
    prompt, lens = (t.to(dev) for t in prompt_window(arch, SEED, batch))

    @torch.inference_mode()
    def transcribe(wav, prompt, lens):
        mel = preprocess(wav, arch.num_mel_bins, dft_dtype=torch.bfloat16)
        enc = encode(params, arch, mel.to(dtype), fast_gelu=True)
        fn = decode.beam_decode if beam > 1 else decode.greedy_decode
        return enc, fn(params, arch, enc, cfg, prompt_tokens=prompt, prompt_lens=lens)

    counters = launch_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    walls, outs = [], []
    for wav in wavs:
        t0 = time.perf_counter()
        enc, (tokens, lengths) = transcribe(wav, prompt, lens)
        tokens, lengths = tokens.cpu(), lengths.cpu()   # the timing fence
        walls.append(time.perf_counter() - t0)
        outs.append((tokens, lengths))
        log(f"phase2 {name} batch {len(walls) - 1}: wall {walls[-1]:.4f} s, "
            f"{batch / walls[-1]:.2f} utt/s, RTFx {batch * AUDIO_S / walls[-1]:.2f}")
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    log(f"phase2 {name} launches {json.dumps(launches)}")
    log(f"phase2 {name} peak memory {peak_mb:.1f} MiB "
        "(torch.cuda.max_memory_allocated)")
    exact = expected_prompt_launches(arch, cfg, len(prefix), n_batches, dtype)
    check_launches(name, launches,
                   set(exact) | ({"int8_matmul"} if method == "int8" else set()), exact)

    ts_begin = arch.no_timestamps_token_id + 1
    for tokens, lengths in outs:
        check(tokens.shape == (batch, 64), f"tokens shape {tuple(tokens.shape)}")
        check(int(tokens.min()) >= 0 and int(tokens.max()) < arch.vocab_size,
              "tokens outside the vocabulary")
        check(torch.equal(tokens[:, :PROMPT_W], prompt.cpu()), "prompt window not intact")
        check(torch.equal(tokens[:, PROMPT_W: first_gen],
                          torch.tensor(prefix).expand(batch, -1)),
              "forced prefix not intact")
        check(bool((lengths == first_gen + NEW_TOKENS).all()),
              f"lengths {lengths.tolist()}")
        gen = tokens[:, first_gen: first_gen + NEW_TOKENS]
        check(not bool((gen == eot).any()), "EOT emitted although suppressed")
        check(bool((tokens[:, first_gen + NEW_TOKENS:] == eot).all()),
              "tokens past the length must be EOT")
        if not cfg.notimestamps:   # the timestamp rules
            check(bool(((gen[:, 0] >= ts_begin) & (gen[:, 0] <= ts_begin
                        + cfg.max_initial_timestamp_index)).all()),
                  f"first tokens {gen[:, 0].tolist()} are not early timestamps")
            check(not bool((gen == arch.no_timestamps_token_id).any()),
                  "<|notimestamps|> was sampled")
            for row in gen.tolist():
                stamps = [t for t in row if t >= ts_begin]
                check(stamps == sorted(stamps), f"timestamps decrease: {stamps}")
                runs = "".join("t" if t >= ts_begin else "w" for t in row)
                check("ttt" not in runs, f"three timestamps in a row: {runs}")
    if not cfg.notimestamps:
        n_ts = int((outs[0][0][:, first_gen: first_gen + NEW_TOKENS] >= ts_begin).sum())
        log(f"phase2 {name} timestamp rules hold; {n_ts} timestamps among "
            f"{batch * NEW_TOKENS} tokens of batch 0")

    # a left-padded row equals the same row run alone with its unpadded prompt
    with torch.inference_mode():
        rows = [int(i) for i in (lens.argmin(), lens.argmax())]
        full = decode.first_step_logits(params, arch, enc, cfg, prompt, lens)[::beam]
        for i in rows:
            n = int(lens[i])
            alone = decode.first_step_logits(params, arch, enc[i: i + 1], cfg,
                                             prompt[i: i + 1, PROMPT_W - n:])[0]
            rel = float((full[i] - alone).norm() / alone.norm())
            log(f"phase2 {name} row {i} (prompt length {n}) padded vs alone "
                f"first-step logits: relative L2 {rel:.4g} (bound {PROMPT_ROW_REL_L2})")
            check(rel <= PROMPT_ROW_REL_L2,
                  f"{name}: padded row {i} off by {rel:.4g} from the row alone")

    if beam > 1:   # all five beams of two utterances, rescored by teacher forcing
        with torch.inference_mode():
            sub = slice(0, 2)
            seqs, scores, gen_len, fg = decode._beam_search(
                params, arch, enc[sub], cfg, None, prompt[sub], lens[sub])
            best_t, best_l = decode.beam_decode(params, arch, enc[sub], cfg,
                                                prompt_tokens=prompt[sub],
                                                prompt_lens=lens[sub])
            again = rescore(params, arch, cfg, enc[sub].repeat_interleave(beam, 0),
                            seqs, prompt[sub].repeat_interleave(beam, 0),
                            lens[sub].repeat_interleave(beam), fg)
        adj = (scores / gen_len.float() ** cfg.length_penalty).reshape(2, beam)
        adj_again = (again / gen_len.float() ** cfg.length_penalty).reshape(2, beam)
        for u in range(2):
            pick = int(adj[u].argmax())
            check(torch.equal(best_t[u], seqs[u * beam + pick]),
                  f"{name}: utterance {u} is not its best-scoring beam")
            check(len({tuple(r.tolist()) for r in seqs[u * beam: (u + 1) * beam]})
                  == beam, f"{name}: utterance {u} holds a beam twice")
            worst = float(((again - scores).abs() / scores.abs()).reshape(2, beam)[u].max())
            check(worst <= RESCORE_REL,
                  f"{name}: utterance {u} beam scores off by {worst:.4g} of "
                  "their teacher-forced rescoring")
            slack = RESCORE_REL * float(adj_again[u].abs().max())
            check(float(adj_again[u, pick]) >= float(adj_again[u].max()) - slack,
                  f"{name}: utterance {u}'s beam is not the best when rescored")
            log(f"phase2 {name} utterance {u}: beam scores "
                f"{[round(float(x), 2) for x in scores[u * beam: (u + 1) * beam]]}, "
                f"rescored {[round(float(x), 2) for x in again[u * beam: (u + 1) * beam]]} "
                f"(off by at most {worst:.4g} of the score, bound {RESCORE_REL}); "
                f"returned beam {pick}")
    summary = {"batch": batch, "walls_s": walls,
               "rtfx_steady": batch * AUDIO_S / walls[-1],
               "peak_mib": peak_mb, "launches": launches}
    log(f"phase2 {name} batch 1 RTFx {summary['rtfx_steady']:.2f}")
    if profile:
        profile_batch(name, lambda: transcribe(wavs[-1], prompt, lens)[1][0].cpu())
    return summary


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
    check_launches(name, launches, path, expected_launches(
        arch, path, [int(lengths.max()) - p_len for _, lengths, _ in outs]))

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
        if batch > 1:
            check(len(set(lengths.tolist())) > 1,
                  f"EOT-allowed rows must stop at different steps: {lengths.tolist()}")
        else:
            check(int(lengths[0]) < p_len + 25, "the EOT-allowed row did not stop early")
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
        profile_batch(name, lambda: fn_sup(params, wavs[-1])[0].cpu())
    return summary


def device_kernels(events) -> list:
    """The device-side kernel rows of a profiler's `key_averages()`."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def profile_batch(name: str, batch) -> None:
    """One batch under torch.profiler: its wall, the summed device time of
    its kernels, the idle share and the kernel table."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in device_kernels(events))
    log(f"profile {name}: wall {wall * 1e3:.1f} ms, summed device kernel "
        f"time {dev_us / 1e3:.1f} ms, idle share "
        f"{max(0.0, 1 - dev_us / 1e6 / wall):.3f}")
    log(events.table(sort_by="self_device_time_total", row_limit=30,
                     max_name_column_width=60))


@torch.inference_mode()
def run_self_attention_replay(dev, arch, params) -> dict:
    """`decode_self_attention` on the model's own caches. The function has
    no caller in the model (as in the JAX package, whose decode step takes
    the update functions), so this run puts one behind every cache update of
    four greedy decodes of whisper-small at batch 32 (bf16 and int8 caches,
    without and with a left-padded prompt window): on the cache the update
    kernel just wrote, the read-only kernel must return that kernel's output
    bit for bit. Launch counts are exact: layers x steps for each of its
    four bodies."""
    from openai_whisper_compression_tpu_torch.audio.features import preprocess
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.models import decode
    from openai_whisper_compression_tpu_torch.models.whisper import encode
    from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas

    name, batch = "self-attn-replay", BATCH
    log(f"phase2 {name}: {arch.name}, int8 weights, batch {batch}, bf16 and int8 "
        "caches, without and with a prompt window")

    def replayed(update, int8: bool):
        def fn(q, k_new, v_new, k_cache, v_cache, *rest, start=None):
            out = update(q, k_new, v_new, k_cache, v_cache, *rest, start=start)
            scales = dict(zip(("k_scale", "v_scale"), rest[:2])) if int8 else {}
            again = sas.decode_self_attention(q, k_cache, v_cache, rest[-1],
                                              start=start, **scales)
            check(torch.equal(again, out),
                  f"{name}: decode_self_attention differs from {update.__name__} "
                  f"at position {rest[-1]} (max {max_err(again, out)})")
            return out
        return fn

    wav = torch.from_numpy(waveforms(SEED, batch)).to(dev)
    prompt, lens = (t.to(dev) for t in prompt_window(arch, SEED, batch))
    counters = launch_counters()
    originals = (decode.decode_self_attention_update,
                 decode.decode_self_attention_update_int8)
    decode.decode_self_attention_update = replayed(originals[0], False)
    decode.decode_self_attention_update_int8 = replayed(originals[1], True)
    try:
        torch.cuda.synchronize()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        t0 = time.perf_counter()
        mel = preprocess(wav, arch.num_mel_bins, dft_dtype=torch.bfloat16)
        enc = encode(params, arch, mel.to(torch.bfloat16), fast_gelu=True)
        for kv_int8 in (False, True):
            cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, kv_int8=kv_int8,
                               suppress_tokens=(arch.eos_token_id,))
            for kw in ({}, {"prompt_tokens": prompt, "prompt_lens": lens}):
                tokens, lengths = decode.greedy_decode(params, arch, enc, cfg, **kw)
                first = (PROMPT_W if kw else 0) + len(decode.forced_prefix(arch, cfg))
                check(bool((lengths == first + NEW_TOKENS).all())
                      and int(tokens.max()) < arch.vocab_size,
                      f"{name}: lengths {lengths.tolist()}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        (decode.decode_self_attention_update,
         decode.decode_self_attention_update_int8) = originals
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    log(f"phase2 {name} launches {json.dumps(launches)}")
    per_decode = arch.decoder_layers * NEW_TOKENS
    exact = {"log_mel_cuda": 1, "encoder_attention": arch.encoder_layers}
    for suffix in ("", "_start", "_int8", "_int8_start"):
        exact["decode_self_attention" + suffix] = per_decode
        exact["decode_self_attention_update" + suffix] = per_decode
    path = set(exact) | {"int8_matmul", "decode_cross_attention_grouped",
                         "decode_cross_attention_grouped_wide"}
    check_launches(name, launches, path, exact)
    log(f"phase2 {name}: {4 * per_decode} read-only calls equal to the update "
        f"kernels' outputs bit for bit; wall {wall:.2f} s")
    return {"batch": batch, "walls_s": [wall], "launches": launches}


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

        dtype = params["encoder"]["ln"]["g"].dtype   # bf16 but for the f32 and f16 trees
        tag = str(dtype).replace("torch.", "")
        card = logits(params, wav.to(dev), dtype)
        ref = logits(tree_to(params, "cpu", torch.float32), wav, torch.float32)
        for name in cfgs:
            c, r = card[name], ref[name]
            limit = {**ACT_LOGITS_REL_L2, **TREE_LOGITS_REL_L2}.get(method, LOGITS_REL_L2)
            rel = float((c - r).norm() / r.norm())
            agree = float((c.argmax(-1) == r.argmax(-1)).float().mean())
            log(f"phase3 {name} first-step logits card {tag} vs CPU f32: relative L2 "
                f"{rel:.4g} (bound {limit}), max abs {max_err(c, r):.4g}, "
                f"|logits| max {float(r.abs().max()):.4g}, argmax agreement "
                f"{agree:.2f} (not checked: random weights make argmax tie-prone)")
            check(bool(torch.isfinite(c).all()) and c.shape == (2, arch.vocab_size),
                  f"{name}: card logits not finite or of shape {tuple(c.shape)}")
            check(rel <= limit, f"{name}: card logits off by {rel:.4g} relative L2")
            if name == "int8 int8-kv":   # the small-b1 run's shapes: one utterance
                c1 = logits(params, wav[:1].to(dev), torch.bfloat16)[name]
                rel1 = float((c1 - r[:1]).norm() / r[:1].norm())
                log(f"phase3 {name} batch 1 first-step logits card bf16 vs CPU f32: "
                    f"relative L2 {rel1:.4g} (bound {LOGITS_REL_L2})")
                check(c1.shape == (1, arch.vocab_size) and rel1 <= LOGITS_REL_L2,
                      f"{name} batch 1: card logits off by {rel1:.4g} relative L2")

    # the beam5-prompt configuration: prompted, five beams per utterance
    arch, params = params_for(ARCH, "int8")
    cfg = DecodeConfig(max_new_tokens=NEW_TOKENS, suppress_tokens=(arch.eos_token_id,),
                       **BEAM5)
    prompt, lens = prompt_window(arch, SEED, 2)

    def beam_logits(params, wav, dtype):
        mel = preprocess(wav, arch.num_mel_bins, dft_dtype=torch.bfloat16).to(dtype)
        enc = encode(params, arch, mel, fast_gelu=True)
        return first_step_logits(params, arch, enc, cfg, prompt.to(wav.device),
                                 lens.to(wav.device)).float().cpu()

    c = beam_logits(params, wav.to(dev), torch.bfloat16)
    r = beam_logits(tree_to(params, "cpu", torch.float32), wav, torch.float32)
    rel = float((c - r).norm() / r.norm())
    log(f"phase3 beam5-prompt first-step logits card bf16 vs CPU f32: relative L2 "
        f"{rel:.4g} (bound {LOGITS_REL_L2}), max abs {max_err(c, r):.4g}, |logits| "
        f"max {float(r.abs().max()):.4g}")
    check(bool(torch.isfinite(c).all()) and c.shape == (2 * 5, arch.vocab_size),
          f"beam5-prompt: card logits not finite or of shape {tuple(c.shape)}")
    check(rel <= LOGITS_REL_L2, f"beam5-prompt: card logits off by {rel:.4g} relative L2")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one batch of each of the " + ", ".join(PROFILED)
                         + " runs with torch.profiler")
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
    phase1_attention(dev, results)
    torch.cuda.empty_cache()
    phase1_w8a8(dev, results)
    phase1_small_batch(dev, results)
    phase1_dtypes(dev, results)
    phase1_crossover(dev)
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
                                   args.profile and name in PROFILED)
        if arch_name != ARCH:
            del built[arch_name, method]
            torch.cuda.empty_cache()
    for run in PROMPT_RUNS:
        summaries[run[0]] = run_prompt_path(
            dev, *params_for(ARCH, (*run, "int8")[3]), run, args.profile and run[0] in PROFILED)
    summaries["self-attn-replay"] = run_self_attention_replay(
        dev, *params_for(ARCH, "int8"))
    phase3(dev, params_for)

    def launches(name):  # from the first run that launched the kernel
        return next(s["launches"][name] for s in summaries.values()
                    if s["launches"][name] > 0)

    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": CSRC + src,
         "replaces": JAX_PKG + rep, "launches": launches(name),
         **{k: results[key][k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms")}}
        for name, _, _, _, src, rep, key in KERNELS]}
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
