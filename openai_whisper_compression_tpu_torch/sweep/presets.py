"""The five headline benchmark presets (BASELINE.json configs).

Port of the JAX package's `sweep/presets.py`. Each preset = (model,
compression transform, decode settings). Unlike a sweep (one arch, many
compressions), presets span architectures:

1. whisper-tiny FP32 greedy            — the reference configuration
2. whisper-small FP16 beam-5           — + long-form 30 s chunking
3. whisper-small int8 weight-only      — WER delta vs FP32 baseline
4. whisper-medium int4 + int8 KV cache — bnb-style 4-bit configuration
5. whisper-large-v3 50% structured head/FFN pruning + int8

`arch_override` lets tests run every preset's *transform* on a tiny config.
The decode configurations of the capacity presets (int8 self-KV with int4
cross-KV) and their batches are configuration only; no throughput number
of another device is carried over.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from ..config import ARCHS, DecodeConfig, WhisperArch
from ..models.params import DEFAULT_DEVICE


def _identity(p, a):
    return p


def _quant(method, **kw):
    def f(p, a):
        from ..quant.api import quantize_params

        return quantize_params(p, method, **kw)
    return f


def _structured50_int8(p, a):
    from ..prune.structured import prune_heads_by_l1, shrink_ffn
    from ..quant.api import quantize_params

    p = prune_heads_by_l1(p, a, 0.5, physical=True)
    for comp in ("encoder", "decoder"):
        for li in range(len(p[comp]["layers"])):
            p = shrink_ffn(p, comp, li, 0.5)
    return quantize_params(p, "int8")


@dataclass
class Preset:
    name: str
    model: str
    dtype: str
    transform: Callable[[Any, WhisperArch], Any]
    decode: dict = field(default_factory=dict)
    longform: bool = False

    def build(self, arch_override: str | None = None, seed: int = 0,
              device: str | torch.device = DEFAULT_DEVICE):
        """-> (params, arch, decode_cfg): seeded weights of the preset's
        model in its dtype on `device` (the card unless told otherwise;
        `init_params`' generator, not the JAX package's draws), then its
        transform."""
        from ..models.params import init_params

        arch = ARCHS[arch_override or self.model]
        params = init_params(arch, seed, dtype=getattr(torch, self.dtype),
                             device=device)
        params = self.transform(params, arch)
        dk = dict(self.decode)
        if arch.vocab_size <= 50259:  # tiny test vocab: no lang/task tokens
            dk.update(language_token_id=None, task_token_id=None,
                      notimestamps=False)
        return params, arch, DecodeConfig(**dk)


BASELINE_PRESETS: list[Preset] = [
    Preset("tiny_fp32_greedy", "tiny", "float32", _identity),
    Preset("small_fp16_beam5_longform", "small", "float16", _identity,
           decode={"beam_size": 5}, longform=True),
    Preset("small_int8", "small", "bfloat16", _quant("int8")),
    # capacity configurations: int4 cross-KV halves the per-item decode
    # stream, so the batch can rise; int8 self-KV halves the cache
    Preset("medium_int4_kv8", "medium", "bfloat16", _quant("int4"),
           decode={"kv_int8": True, "cross_kv_int4": True}),
    Preset("largev3_structured50_int8", "large-v3", "bfloat16",
           _structured50_int8,
           decode={"kv_int8": True, "cross_kv_int4": True}),
]

# Lossy capacity variants (not in BASELINE_PRESETS, which mirrors
# BASELINE.json's lossless configs): cross-KV pool2 (models/merge.py) halves
# the per-item decode stream again on top of int4 cross-KV.
EXTRA_PRESETS: list[Preset] = [
    Preset("medium_int4_kv8_pool2", "medium", "bfloat16", _quant("int4"),
           decode={"kv_int8": True, "cross_kv_int4": True,
                   "cross_kv_pool": 2}),
    Preset("largev3_structured50_int8_pool2", "large-v3", "bfloat16",
           _structured50_int8,
           decode={"kv_int8": True, "cross_kv_int4": True,
                   "cross_kv_pool": 2}),
]

PRESETS = {p.name: p for p in BASELINE_PRESETS + EXTRA_PRESETS}
