"""The program under test, built as a configuration file states.

Everything here calls the port (`openai_whisper_compression_tpu_torch`):
its architecture table, its quantization and qkv fusion of the seeded
weights, its decode settings and its transcription function. The port is
imported inside the functions, so the benchmark's own modules import
without it.
"""

from __future__ import annotations

import os

PORT = "openai_whisper_compression_tpu_torch"


def import_port(root: str):
    """The port's package, which has to come from the checkout at `root`:
    an installed copy elsewhere is not the tree under test."""
    import importlib

    port = importlib.import_module(PORT)
    where = os.path.realpath(port.__file__)
    if not where.startswith(os.path.realpath(root) + os.sep):
        raise RuntimeError(f"{PORT} was imported from {where}, outside the checkout {root}")
    return port


def arch_of(config: dict):
    """The port's WhisperArch named by the configuration, held to the
    configuration's published sizes and token ids."""
    from openai_whisper_compression_tpu_torch.config import ARCHS

    prog, m = config["program"], config["model"]
    arch = ARCHS[prog["arch"]]
    have = {"d_model": arch.d_model, "encoder_layers": arch.encoder_layers,
            "decoder_layers": arch.decoder_layers,
            "encoder_attention_heads": arch.encoder_heads,
            "decoder_attention_heads": arch.decoder_heads,
            "encoder_ffn_dim": arch.ffn_dim, "decoder_ffn_dim": arch.ffn_dim,
            "num_mel_bins": arch.num_mel_bins, "vocab_size": arch.vocab_size,
            "max_source_positions": arch.max_source_positions,
            "max_target_positions": arch.max_target_positions,
            "decoder_start_token_id": arch.decoder_start_token_id,
            "eos_token_id": arch.eos_token_id}
    bad = {k: (v, m[k]) for k, v in have.items() if m[k] != v}
    if bad:
        raise ValueError(f"the port's ARCHS[{prog['arch']!r}] departs from "
                         f"{config['name']}: {bad}")
    return arch


def decode_config(config: dict, new_tokens: int):
    from openai_whisper_compression_tpu_torch.config import DecodeConfig

    d = config["program"]["decode"]
    sup = (config["model"]["eos_token_id"],) if d.get("suppress_eot") else ()
    return DecodeConfig(max_new_tokens=int(new_tokens),
                        kv_int8=d["kv_int8"], cross_kv_int8=d["cross_kv_int8"],
                        suppress_tokens=sup)


def check_prefix(config: dict, arch, cfg) -> None:
    """The program's forced prefix must be the configuration's."""
    from openai_whisper_compression_tpu_torch.models.decode import forced_prefix

    got = forced_prefix(arch, cfg)
    if got != config["model"]["forced_prefix"]:
        raise ValueError(f"the port's forced prefix {got} departs from "
                         f"{config['name']}'s {config['model']['forced_prefix']}")


def build_params(config: dict, weights: dict):
    """The served tree: the seeded weights quantized by the configuration's
    method, decoder q/k/v fused."""
    from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
    from openai_whisper_compression_tpu_torch.quant.api import quantize_params

    prog = config["program"]
    params = quantize_params(weights, prog["quantize"])
    return fuse_qkv(params) if prog.get("fuse_qkv") else params


def transcribe_fn(config: dict, arch, cfg, device):
    from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn

    prog = config["program"]
    return make_transcribe_fn(arch, cfg, fast_mel=prog["mel_dft"] == "bfloat16",
                              fast_gelu=prog["encoder_mlp_gelu"] == "tanh",
                              device=device)


def enable_kernel_cache(path: str) -> str | None:
    from openai_whisper_compression_tpu_torch.utils.compile_cache import (
        enable_persistent_compilation_cache)

    os.environ.pop("OWC_NO_COMPILE_CACHE", None)
    return enable_persistent_compilation_cache(path)


def install_spans(rec) -> None:
    """Spans around the three layers the transcription function looks up at
    call time: the frontend, the encoder and the decode (cross-KV
    precompute, prefill and the step loop)."""
    from openai_whisper_compression_tpu_torch.audio import features
    from openai_whisper_compression_tpu_torch.evaluation import harness

    rec.wrap(features, "preprocess", "preprocess", rows=lambda a, k: a[0].shape[0])
    rec.wrap(harness, "encode", "encode", rows=lambda a, k: a[2].shape[0])
    rec.wrap(harness, "greedy_decode", "greedy_decode",
             rows=lambda a, k: a[2].shape[0],
             info=lambda a, k, out: {"steps": int(a[3].max_new_tokens)})
