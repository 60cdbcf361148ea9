"""WER/CER metrics and text normalization.

A framework-free copy of the JAX package's `evaluation/metrics.py`.

Self-contained replacement for the reference's HF `evaluate` WER/CER metrics
(`evaluation.py:109-117`) and its two normalizers (tokenizer `normalize=True`
at `data_utils.py:60,170`; lowercase/strip-punct at
`openai_whisper_compression/utils.py:148-160`). Edit distance is a vectorized
numpy DP, not a Python-loop stand-in.
"""

from __future__ import annotations

import re
import string

import numpy as np


def normalize_text(text: str) -> str:
    """Basic English normalizer: lowercase, strip punctuation, collapse
    whitespace (the notebook stack's recipe,
    `openai_whisper_compression/utils.py:148-160`)."""
    text = text.lower()
    text = re.sub(rf"[{re.escape(string.punctuation)}]", " ", text)
    return " ".join(text.split())


_WHISPER_NORMALIZERS: dict = {}


def whisper_normalizer(language: str | None = "en",
                       spelling: dict | None = None):
    """Full OpenAI-style text normalizer — parity with the reference's
    `processor.tokenizer.normalize` (`data_utils.py:60,170`), which is what
    its recorded WERs (notebook baseline 4.73%) are computed under:
    contraction + abbreviation expansion, spelled numbers/currency → digits
    ("one hundred and twenty-three dollars" → "$123"), bracket removal,
    symbol stripping. Non-English uses the diacritic-preserving basic
    variant. Falls back to `normalize_text` if transformers is unavailable.

    `spelling` is the British→American dict the HF tokenizer ships as
    `english.json`; offline (no HF cache) it defaults to {} — spelled-number
    and contraction handling, the bulk of the WER delta, need no data file.

    NOT the default for synthetic-token datasets: the number normalizer
    rewrites ids like "w1" → "w one", so the harness keeps the basic
    normalizer unless EvalConfig.normalizer selects "whisper" (the
    `--hf/--librispeech` CLI path does).
    """
    key = (language,
           tuple(sorted(spelling.items())) if spelling else None)
    if key in _WHISPER_NORMALIZERS:
        return _WHISPER_NORMALIZERS[key]
    try:
        from transformers.models.whisper.english_normalizer import (
            BasicTextNormalizer, EnglishTextNormalizer)
        if language in (None, "en", "english"):
            fn = EnglishTextNormalizer(spelling or {})
        else:
            fn = BasicTextNormalizer()
    except Exception:  # transformers absent: the basic normalizer
        fn = normalize_text
    _WHISPER_NORMALIZERS[key] = fn
    return fn


def resolve_normalizer(name: str | None, language: str | None = "en"):
    """Map an EvalConfig/CLI normalizer name to a callable (or None):
    "whisper" → full OpenAI normalizer, "basic" → lowercase/strip-punct,
    "none" → identity comparison (normalize=False semantics)."""
    if name in (None, "basic"):
        return normalize_text
    if name == "whisper":
        return whisper_normalizer(language)
    if name == "none":
        return None
    raise ValueError(f"unknown normalizer {name!r}; "
                     "expected whisper|basic|none")


def edit_distance(ref: list, hyp: list) -> int:
    """Levenshtein distance with a rolling-row numpy DP (O(len_ref) memory,
    inner loop vectorized over the hypothesis axis)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    hyp_arr = np.asarray(hyp, dtype=object)
    idx = np.arange(m + 1, dtype=np.int64)
    prev = idx.copy()
    for i in range(1, n + 1):
        sub = prev[:-1] + (hyp_arr != ref[i - 1])
        ins = prev[1:] + 1
        best = np.minimum(sub, ins)
        # cur[j] = min(best[j], cur[j-1]+1) unrolled via prefix-min:
        # cur[j] = min_{k<=j}(ext[k] + (j-k)) with ext = [i, best...]
        ext = np.concatenate(([i], best))
        prev = np.minimum.accumulate(ext - idx) + idx
    return int(prev[-1])


def wer(references: list[str], hypotheses: list[str],
        normalize: bool = True, normalizer=None) -> float:
    """Corpus-level word error rate (total edits / total reference words).

    `normalizer` overrides the default basic normalizer (pass
    `whisper_normalizer()` for reference-parity scoring)."""
    norm = (normalizer or normalize_text) if normalize else None
    edits = words = 0
    for ref, hyp in zip(references, hypotheses, strict=True):
        if norm is not None:
            ref, hyp = norm(ref), norm(hyp)
        r, h = ref.split(), hyp.split()
        edits += edit_distance(r, h)
        words += len(r)
    return edits / max(words, 1)


def cer(references: list[str], hypotheses: list[str],
        normalize: bool = True, normalizer=None) -> float:
    """Corpus-level character error rate."""
    norm = (normalizer or normalize_text) if normalize else None
    edits = chars = 0
    for ref, hyp in zip(references, hypotheses, strict=True):
        if norm is not None:
            ref, hyp = norm(ref), norm(hyp)
        edits += edit_distance(list(ref), list(hyp))
        chars += len(ref)
    return edits / max(chars, 1)


def per_sample_wer(reference: str, hypothesis: str,
                   normalize: bool = True, normalizer=None) -> float:
    return wer([reference], [hypothesis], normalize, normalizer)
