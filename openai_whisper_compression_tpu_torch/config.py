"""Model architectures, decode and evaluation settings, audio constants.

A framework-free copy of the JAX package's `config.py` (`WhisperArch`,
`ARCHS`, the language tokens, `DecodeConfig`, `EvalConfig`, `RunConfig`,
the audio constants): importing anything from the JAX package runs its
`__init__`, which imports jax, and the port must run where jax is absent.
`tests/test_torch_config.py` holds the two copies equal field for field.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class WhisperArch:
    """Static Whisper architecture hyperparameters (HF `WhisperConfig`
    semantics)."""

    name: str = "tiny"
    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    encoder_heads: int = 6
    decoder_layers: int = 4
    decoder_heads: int = 6
    ffn_dim: int = 1536
    max_source_positions: int = 1500  # encoder frames after conv stride-2
    max_target_positions: int = 448
    layer_norm_eps: float = 1e-5

    # Special token ids (multilingual Whisper vocab).
    bos_token_id: int = 50257
    eos_token_id: int = 50257
    decoder_start_token_id: int = 50258  # <|startoftranscript|>
    no_timestamps_token_id: int = 50363
    # False for the `.en` checkpoints (no language/task tokens).
    multilingual: bool = True
    alignment_heads: tuple = ()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_heads

    # specials sit at fixed offsets below <|notimestamps|> in every vocab
    @property
    def task_transcribe_token_id(self) -> int:
        return self.no_timestamps_token_id - 4

    @property
    def task_translate_token_id(self) -> int:
        return self.no_timestamps_token_id - 5

    @property
    def no_speech_token_id(self) -> int:
        return self.no_timestamps_token_id - 1

    @property
    def language_en_token_id(self) -> int:
        return self.decoder_start_token_id + 1  # <|en|> is always first

    def replace(self, **kw: Any) -> "WhisperArch":
        return dataclasses.replace(self, **kw)


def _arch(name: str, mels: int, d: int, el: int, eh: int, dl: int, dh: int,
          vocab: int = 51865) -> WhisperArch:
    return WhisperArch(
        name=name, vocab_size=vocab, num_mel_bins=mels, d_model=d,
        encoder_layers=el, encoder_heads=eh, decoder_layers=dl,
        decoder_heads=dh, ffn_dim=4 * d,
    )


def _en(arch: WhisperArch) -> WhisperArch:
    """English-only (`.en`) variant: GPT-2 vocab (51864)."""
    return arch.replace(
        name=arch.name + ".en", vocab_size=51864, multilingual=False,
        bos_token_id=50256, eos_token_id=50256,
        decoder_start_token_id=50257, no_timestamps_token_id=50362,
    )


# Official OpenAI Whisper family dimensions.
ARCHS: dict[str, WhisperArch] = {
    "tiny": _arch("tiny", 80, 384, 4, 6, 4, 6),
    "base": _arch("base", 80, 512, 6, 8, 6, 8),
    "small": _arch("small", 80, 768, 12, 12, 12, 12),
    "medium": _arch("medium", 80, 1024, 24, 16, 24, 16),
    "large": _arch("large", 80, 1280, 32, 20, 32, 20),
    "large-v2": _arch("large-v2", 80, 1280, 32, 20, 32, 20),
    "large-v3": _arch("large-v3", 128, 1280, 32, 20, 32, 20,
                      vocab=51866).replace(no_timestamps_token_id=50364),
    "large-v3-turbo": _arch("large-v3-turbo", 128, 1280, 32, 20, 4, 20,
                            vocab=51866).replace(no_timestamps_token_id=50364),
    # Tiny test-only config (random weights, fast tests).
    "test2l": WhisperArch(
        name="test2l", vocab_size=1000, num_mel_bins=80, d_model=64,
        encoder_layers=2, encoder_heads=4, decoder_layers=2, decoder_heads=4,
        ffn_dim=128, max_source_positions=64, max_target_positions=32,
        bos_token_id=997, eos_token_id=997, decoder_start_token_id=998,
        no_timestamps_token_id=999,
    ),
}
ARCHS["test2l-ts"] = ARCHS["test2l"].replace(
    name="test2l-ts", bos_token_id=897, eos_token_id=897,
    decoder_start_token_id=898, no_timestamps_token_id=899)
ARCHS.update({a.name + ".en": _en(a) for a in
              [ARCHS[n] for n in ("tiny", "base", "small", "medium")]})
ARCHS.update({
    "distil-large-v2": ARCHS["large-v2"].replace(
        name="distil-large-v2", decoder_layers=2),
    "distil-large-v3": ARCHS["large-v3"].replace(
        name="distil-large-v3", decoder_layers=2),
    "distil-medium.en": ARCHS["medium.en"].replace(
        name="distil-medium.en", decoder_layers=2),
    "distil-small.en": ARCHS["small.en"].replace(
        name="distil-small.en", decoder_layers=4),
})


# Whisper language codes in token order: <|en|> = decoder_start + 1, ...
# (whisper tokenizer LANGUAGES dict order; v3 vocabs append "yue").
LANGUAGES = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
)


def language_code(arch: WhisperArch, token_id: int) -> str:
    """Inverse of `language_token_id`: <|xx|> token id -> code."""
    idx = int(token_id) - (arch.decoder_start_token_id + 1)
    if not 0 <= idx < len(LANGUAGES):
        raise ValueError(f"token {token_id} is not a language token")
    return LANGUAGES[idx]


def language_token_id(arch: WhisperArch, code: str | int) -> int:
    """<|xx|> token id for a language code (an int id passes through).
    Languages sit at [sot + 1, translate) in `LANGUAGES` order; v2-style
    vocabs hold 99 of them, v3 adds "yue"."""
    if isinstance(code, int):
        return code
    c = code.lower()
    if c not in LANGUAGES:
        raise ValueError(f"unknown language code {code!r}")
    tok = arch.decoder_start_token_id + 1 + LANGUAGES.index(c)
    if not arch.multilingual:
        raise ValueError(f"{arch.name} is English-only")
    if tok >= arch.task_translate_token_id:
        raise ValueError(f"language {code!r} not in {arch.name}'s vocab "
                         "(v2-style vocabs lack 'yue')")
    return tok


# Audio frontend constants (Whisper's fixed STFT/log-mel recipe).
SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_SECONDS = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_SECONDS      # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH           # 3000 mel frames


@dataclass(frozen=True)
class DecodeConfig:
    """Generation settings, field for field the JAX package's (whose
    defaults keep fp caches; `bench.py` turns on `kv_int8` and
    `cross_kv_int8`). The port decodes, greedily or with `beam_size` beams,
    with fp or int8 self-KV (`kv_int8`) and fp (bf16 on the card), int8
    (`cross_kv_int8`) or int4 (`cross_kv_int4`, which wins over int8)
    cross-KV, through the fused kernels (`self_pallas`, `cross_pallas`) or
    the unfused step (cache write, read, masked attention in torch; the
    standard-layout cross-KV). `cross_kv_pool` / `cross_kv_merge` shrink the
    attended encoder states first (`models.merge`). int4 cross-KV exists in
    the fused layout only: `models.decode.check_supported` raises
    ValueError for it with `cross_pallas=False`, as the JAX package does."""

    max_new_tokens: int = 445
    beam_size: int = 1  # 1 = greedy
    language_token_id: int | str | None = "auto"
    task_token_id: int | str | None = "auto"
    suppress_tokens: tuple[int, ...] = ()
    begin_suppress_tokens: tuple[int, ...] = ()
    notimestamps: bool = True
    length_penalty: float = 1.0
    kv_int8: bool = False
    cross_kv_int8: bool = False
    cross_kv_int4: bool = False
    cross_pallas: bool = True
    cross_kv_pool: int = 1
    cross_kv_merge: int = 0
    self_pallas: bool = True
    timestamp_rules: bool = True
    max_initial_timestamp_index: int = 50


@dataclass
class EvalConfig:
    """Evaluation harness settings, field for field the JAX package's.
    normalizer: "basic" (lowercase, strip punctuation: safe for synthetic
    token ids), "whisper" (the full OpenAI normalizer) or "none".
    length_bucketing: sort utterances by duration before batching (records
    come back in input order)."""

    split: str = "test.clean"
    num_samples: int = 100
    batch_size: int = 8
    warmup_batches: int = 1
    compute_cer: bool = True
    save_path: str | None = None
    normalizer: str = "basic"
    length_bucketing: bool = True


@dataclass
class RunConfig:
    """One experiment = model + compression + eval. Serialisable to JSON
    (the JAX package's `to_json` text for the same fields)."""

    model: str = "tiny"
    dtype: str = "float32"
    quantization: dict[str, Any] | None = None
    pruning: dict[str, Any] | None = None
    recovery: dict[str, Any] | None = None
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "RunConfig":
        d = json.loads(s)
        d["decode"] = DecodeConfig(**d.get("decode", {}))
        d["eval"] = EvalConfig(**d.get("eval", {}))
        return RunConfig(**d)
