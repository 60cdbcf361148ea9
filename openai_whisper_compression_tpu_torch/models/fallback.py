"""Temperature-fallback decoding with OpenAI's quality gates.

The JAX package's `models/fallback.py`. OpenAI's `whisper.transcribe`
decodes each segment at temperature 0 and retries at (0.2, 0.4, 0.6, 0.8,
1.0) when the result fails either gate: gzip compression ratio > 2.4
(degenerate repetition) or mean token logprob < -1.0 (low confidence); a
no-speech probability above its threshold marks the segment silent.

Each rung re-decodes the whole batch (`greedy_decode` with
`return_logprobs`); rows that passed keep their first passing result.
Sampling draws from one `torch.Generator` on the decode's device, seeded
once per call from `seed`, so two calls with one seed give the same tokens
(the draws are not `jax.random.categorical`'s).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable

import numpy as np
import torch

from ..config import DecodeConfig, WhisperArch
from .decode import forced_prefix, greedy_decode, no_speech_prob
from .params import Params

DEFAULT_TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


def compression_ratio(text: str) -> float:
    """len(utf8) / len(zlib(utf8)): > ~2.4 flags looped or repeated output
    (OpenAI whisper/utils.py compression_ratio)."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


@dataclasses.dataclass
class FallbackResult:
    tokens: np.ndarray          # (B, L) accepted tokens per sequence
    lengths: np.ndarray         # (B,)
    avg_logprobs: np.ndarray    # (B,) mean generated-token logprob
    temperatures: np.ndarray    # (B,) temperature that produced each row
    compression_ratios: np.ndarray  # (B,)
    no_speech_probs: np.ndarray | None  # (B,) if gated
    is_silent: np.ndarray       # (B,) no-speech gate verdict
    texts: list[str]


def needs_fallback(avg_logprob: float, ratio: float,
                   compression_ratio_threshold: float | None = 2.4,
                   logprob_threshold: float | None = -1.0) -> bool:
    """True when either OpenAI gate trips (None disables a gate)."""
    if (compression_ratio_threshold is not None
            and ratio > compression_ratio_threshold):
        return True
    if logprob_threshold is not None and avg_logprob < logprob_threshold:
        return True
    return False


def decode_with_fallback(params: Params, arch: WhisperArch,
                         enc_out: torch.Tensor,
                         decode_text: Callable[[list[int]], str],
                         cfg: DecodeConfig | None = None,
                         temperatures: tuple[float, ...] = DEFAULT_TEMPERATURES,
                         compression_ratio_threshold: float | None = 2.4,
                         logprob_threshold: float | None = -1.0,
                         no_speech_threshold: float | None = None,
                         seed: int = 0, best_of: int = 1) -> FallbackResult:
    """Decode `enc_out` through the temperature ladder until every sequence
    passes both quality gates, or the temperatures run out (then the last
    attempt is kept, like OpenAI).

    decode_text: token ids (generated slice, EOT stripped) -> text, for the
    compression-ratio gate (the tokenizer's `.decode`).
    no_speech_threshold: if set, sequences with P(<|nospeech|>) > threshold
    and avg_logprob < logprob_threshold are flagged in `is_silent` (their
    tokens are still returned, their text is "").
    best_of: at temperature > 0, sample this many candidates per sequence in
    one decode of B * best_of rows (each encoder row repeated in place) and
    keep the one of highest mean logprob; t = 0 stays one deterministic
    decode."""
    cfg = cfg or DecodeConfig()
    if cfg.beam_size > 1:
        raise ValueError("decode_with_fallback is greedy/sampling only; "
                         "beam_size > 1 is not supported on the "
                         "temperature ladder")
    b = enc_out.shape[0]
    eot = arch.eos_token_id
    p_len = len(forced_prefix(arch, cfg))  # gates run on generated text only
    generator = torch.Generator(device=enc_out.device).manual_seed(seed)

    def attempt(temp):
        n_cand = best_of if (temp > 0 and best_of > 1) else 1
        enc = enc_out.repeat_interleave(n_cand, dim=0) if n_cand > 1 else enc_out
        toks, lens, lps = greedy_decode(params, arch, enc, cfg,
                                        generator=generator, temperature=temp,
                                        return_logprobs=True)
        toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
        lps = lps.float().cpu().numpy()
        if n_cand > 1:
            idx = np.arange(b) * n_cand + lps.reshape(b, n_cand).argmax(axis=1)
            toks, lens, lps = toks[idx], lens[idx], lps[idx]
        return toks, lens, lps

    def generated(toks, lens, i):
        return [int(t) for t in toks[i, p_len: lens[i]] if int(t) != eot]

    best: dict[str, np.ndarray] = {}
    pending = np.ones((b,), bool)
    for temp in temperatures:
        toks, lens, lps = attempt(temp)
        ratios = np.zeros((b,), np.float32)
        fails = np.zeros((b,), bool)
        for i in np.flatnonzero(pending):
            ratios[i] = compression_ratio(decode_text(generated(toks, lens, i)))
            fails[i] = needs_fallback(float(lps[i]), float(ratios[i]),
                                      compression_ratio_threshold,
                                      logprob_threshold)
        new = {"tokens": toks, "lengths": lens, "lp": lps, "ratio": ratios,
               "temp": np.full((b,), temp, np.float32)}
        if not best:
            best = new
        else:  # adopt this attempt for the rows that were still pending
            for k, v in new.items():
                best[k] = np.where(pending.reshape((-1,) + (1,) * (v.ndim - 1)),
                                   v, best[k])
        pending = pending & fails
        if not pending.any():
            break

    nsp = None
    silent = np.zeros((b,), bool)
    if no_speech_threshold is not None:
        nsp = no_speech_prob(params, arch, enc_out).float().cpu().numpy()
        silent = nsp > no_speech_threshold
        if logprob_threshold is not None:
            # OpenAI: low confidence confirms the silence verdict
            silent = silent & (best["lp"] < logprob_threshold)
    texts = ["" if silent[i] else decode_text(
        generated(best["tokens"], best["lengths"], i)) for i in range(b)]
    return FallbackResult(
        tokens=best["tokens"], lengths=best["lengths"],
        avg_logprobs=best["lp"], temperatures=best["temp"],
        compression_ratios=best["ratio"], no_speech_probs=nsp,
        is_silent=silent, texts=texts)
