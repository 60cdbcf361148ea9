"""PyTorch/CUDA port of `openai_whisper_compression_tpu` for NVIDIA Hopper.

Plain tensor code is PyTorch; every Pallas kernel the JAX package runs on
the ported path is a hand-written CUDA kernel under `csrc/`, built at first
use (`ops.kernels`). This package never imports jax.

Quick start::

    from openai_whisper_compression_tpu_torch import load_model, transcribe
    params, arch = load_model("tiny")              # seeded weights, on the card
    result = transcribe(params, arch, waveform)    # 16 kHz float32, any length

Every entry point runs on the card unless told otherwise: pass
``device="cpu"`` to `load_model` and `transcribe` to run on the CPU. torch
is imported inside the functions, so importing a submodule such as
`config` stays cheap.
"""

from __future__ import annotations

from typing import Any

__version__ = "0.1.0"

from .config import ARCHS, DecodeConfig, EvalConfig, RunConfig, WhisperArch  # noqa: F401

_DEFAULT_DEVICE = "cuda"   # models.params.DEFAULT_DEVICE, without importing torch here


def load_model(name_or_arch: str = "tiny", dtype: Any = None, seed: int = 0,
               hf: str | None = None, device: Any = _DEFAULT_DEVICE):
    """(params, arch) on `device`, float32 unless `dtype` says otherwise.
    `hf` loads real weights: a local path (an HF snapshot or export
    directory, an OpenAI `.pt`, a bare state dict or safetensors file), or
    a model name found in the local npz cache or a mounted HF hub cache
    (`models.convert.load_hf_model`; nothing is downloaded). Otherwise the
    named architecture with seeded random weights (`init_params`'
    generator)."""
    import os

    import torch

    dtype = dtype or torch.float32
    if hf:
        from .models.convert import load_checkpoint, load_hf_model

        if os.path.exists(hf):
            params, arch = load_checkpoint(hf, dtype, device)
            return params, arch.replace(name=hf)
        return load_hf_model(hf, dtype=dtype, device=device)
    from .models.params import init_params

    arch = ARCHS[name_or_arch]
    return init_params(arch, seed, dtype=dtype, device=device), arch


def transcribe(params, arch, audio, tokenizer=None, decode_cfg=None,
               batch_size: int = 8, timestamps: bool = False,
               word_timestamps: bool = False,
               temperatures=None, best_of: int = 1,
               initial_prompt: str | None = None,
               condition_on_previous: bool = False,
               task: str = "transcribe", language: str | int | None = None,
               clip_timestamps=None,
               hallucination_silence_threshold: float | None = None,
               device: Any = _DEFAULT_DEVICE) -> dict:
    """OpenAI-`whisper.transcribe()`-style convenience: accepts a waveform of
    any length (16 kHz float32), long-form chunks at 30 s, returns
    {"text", "chunks", ...}.

    timestamps=True switches to seek-based decoding with the OpenAI
    timestamp rules, returning {"text", "segments", ...}; word_timestamps
    additionally aligns words via cross-attention DTW ("words" key).
    temperatures (e.g. ``(0.0, 0.2, 0.4, 0.6, 0.8, 1.0)``) enables the
    OpenAI temperature-fallback ladder with compression-ratio/logprob
    quality gates (models.fallback); best_of > 1 samples that many
    candidates per sequence at each t > 0 rung and keeps the highest
    mean-logprob one (OpenAI DecodingOptions.best_of).
    task="translate" and language ("de" / a raw token id) set the decoder
    prefix tokens per-arch. condition_on_previous (OpenAI
    condition_on_previous_text) and initial_prompt work on both the chunked
    and the timestamps/seek paths (seek: a rolling `<|startofprev|>` prompt
    window; incompatible with temperatures/word_timestamps there). The
    decode runs on `device`, where the tree must live."""
    import dataclasses

    from .config import language_token_id
    from .evaluation.longform import transcribe_long, transcribe_seek
    from .evaluation.tokenizer import default_tokenizer

    if task not in ("transcribe", "translate"):
        raise ValueError(f"task must be transcribe|translate, got {task!r}")
    if best_of > 1:
        # as OpenAI: best_of is incompatible with deterministic decoding;
        # failing loudly beats returning single-candidate greedy output the
        # caller believes was sampled
        if not temperatures or not any(t > 0 for t in temperatures):
            raise ValueError("best_of needs a temperatures ladder with "
                             "t>0 rungs (greedy t=0 is deterministic)")
    if task == "translate" or language is not None:
        cfg0 = decode_cfg or DecodeConfig()
        repl = {}
        if task == "translate":
            repl["task_token_id"] = arch.task_translate_token_id
        if language is not None:
            repl["language_token_id"] = language_token_id(arch, language)
        decode_cfg = dataclasses.replace(cfg0, **repl)

    if tokenizer is None:
        tokenizer = default_tokenizer(arch)
    fallback_kw = {"best_of": best_of} if best_of > 1 else None
    if timestamps or word_timestamps:
        cfg = dataclasses.replace(decode_cfg or DecodeConfig(), notimestamps=False)
        return transcribe_seek(
            params, arch, audio, tokenizer, cfg,
            word_timestamps=word_timestamps,
            clip_timestamps=clip_timestamps,
            hallucination_silence_threshold=hallucination_silence_threshold,
            temperatures=temperatures, fallback_kw=fallback_kw,
            condition_on_previous=condition_on_previous,
            initial_prompt_ids=(list(tokenizer.encode(initial_prompt))
                                if initial_prompt else None),
            device=device)
    return transcribe_long(params, arch, audio, tokenizer,
                           cfg=decode_cfg, batch_size=batch_size,
                           condition_on_previous=condition_on_previous,
                           temperatures=temperatures, fallback_kw=fallback_kw,
                           initial_prompt=initial_prompt, device=device)


def quantize(params, method: str = "int8", **kw):
    """Pure quantization transform (see quant.api.quantize_params)."""
    from .quant.api import quantize_params

    return quantize_params(params, method, **kw)


# Import the `prune` subpackage BEFORE defining the same-named convenience
# function: a submodule's first import sets the package attribute, so
# without this a later `import ...prune.magnitude` elsewhere would rebind
# `openai_whisper_compression_tpu_torch.prune` from the function back to the
# subpackage.
from . import prune as _prune_pkg  # noqa: E402,F401


def prune(params, arch=None, amount: float | None = None,
          recipe: dict | None = None, **kw):
    """Magnitude pruning: global L1 at `amount`, or the per-component
    `recipe` (see prune.recipe)."""
    if recipe is not None:
        from .prune.recipe import apply_recipe

        return apply_recipe(params, arch, recipe)
    from .prune.magnitude import prune_global_l1

    return prune_global_l1(params, amount or 0.0, **kw)
