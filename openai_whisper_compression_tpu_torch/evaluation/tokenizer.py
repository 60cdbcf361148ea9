"""Token <-> text adapters (a framework-free copy of the JAX package's
`evaluation/tokenizer.py`; `transformers` is imported only inside the HF
adapter's loader).

The reference decodes via `processor.decode(..., skip_special_tokens=True,
normalize=True)` (`data_utils.py:169-170`). Offline environments have no HF
vocab files, so two adapters exist:

- `HFTokenizerAdapter`: wraps a real `WhisperTokenizer` when one is available
  (local cache or network).
- `WordTokenizer`: deterministic synthetic-vocabulary tokenizer used by the
  self-contained eval pipeline and tests (each id is a word).
"""

from __future__ import annotations

from typing import Protocol, Sequence


class Tokenizer(Protocol):
    def decode(self, ids: Sequence[int]) -> str: ...
    def encode(self, text: str) -> list[int]: ...


class WordTokenizer:
    """Bijective id<->word tokenizer over a synthetic vocabulary.

    Special ids (>= special_start) are skipped on decode, mirroring
    `skip_special_tokens=True`.
    """

    def __init__(self, vocab_size: int, special_start: int | None = None):
        self.vocab_size = vocab_size
        self.special_start = special_start if special_start is not None else vocab_size

    def decode(self, ids: Sequence[int]) -> str:
        return " ".join(f"w{int(i)}" for i in ids
                        if 0 <= int(i) < self.special_start)

    def encode(self, text: str) -> list[int]:
        out = []
        for w in text.split():
            if w.startswith("w") and w[1:].isdigit():
                out.append(int(w[1:]))
        return out


def default_tokenizer(arch) -> WordTokenizer:
    """The offline placeholder tokenizer for `arch`: ids below the first
    special token decode as words (min(eot, sot) — on real vocabs text ids
    sit below both; the test archs put sot below eot). The single source
    for a construction previously copy-pasted across bench/cli/examples."""
    return WordTokenizer(arch.vocab_size,
                         special_start=min(arch.eos_token_id,
                                           arch.decoder_start_token_id))


class HFTokenizerAdapter:
    """Wraps an HF WhisperTokenizer; decodes with normalization like the
    reference (`data_utils.py:170`)."""

    def __init__(self, hf_tokenizer):
        self.tok = hf_tokenizer

    def decode(self, ids: Sequence[int]) -> str:
        return self.tok.decode(list(map(int, ids)), skip_special_tokens=True)

    def encode(self, text: str) -> list[int]:
        return self.tok.encode(text, add_special_tokens=False)


def load_tokenizer(model_name: str = "openai/whisper-small"):
    """Try to load a real Whisper tokenizer; returns None when offline with
    no cache (callers fall back to WordTokenizer)."""
    try:
        from transformers import WhisperTokenizer
    except Exception:
        return None
    try:  # cache hit: no network round-trips (and no 5x8s offline retries)
        return HFTokenizerAdapter(
            WhisperTokenizer.from_pretrained(model_name,
                                             local_files_only=True))
    except Exception:
        pass
    import os

    if os.environ.get("HF_HUB_OFFLINE"):
        return None
    import socket

    try:  # one-shot DNS probe: without it, an unreachable hub costs the
        # CLI 5x8s of huggingface_hub HEAD retries before the fallback
        socket.getaddrinfo("huggingface.co", 443)
    except OSError:
        return None
    try:
        return HFTokenizerAdapter(WhisperTokenizer.from_pretrained(model_name))
    except Exception:
        return None
