"""Word-level timestamps through cross-attention DTW alignment.

The JAX package's `models/alignment.py` (OpenAI whisper/timing.py
`find_alignment`): run the decoder teacher-forced over the generated tokens,
collect the cross-attention probabilities of the alignment heads, and
dynamic-time-warp the (token x audio frame) matrix into a monotonic
token -> time map.

The teacher-forced pass (`cross_attention_weights`) runs where the encoder
states live: the linears go through `ops.linear` (the int8 matmul kernel on
the card at M = B·L), the attention is plain torch over the standard-layout
cross-KV of `precompute_cross_kv`, as the JAX package leaves it to XLA. The
DTW, the median filter, the word grouping and the punctuation merge are a
framework-free numpy copy of the JAX functions, run on the host as OpenAI
runs them.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..config import WhisperArch
from ..ops.attention import matmul_f32
from ..ops.linear import linear
from .whisper import (NEG_INF, _num_heads, embed_tokens, layer_norm,
                      merge_heads, mlp, precompute_cross_kv, read_cross_kv,
                      self_attention, split_heads)

Params = dict[str, Any]

FRAME_SECONDS = 0.02  # one encoder frame = 2 mel hops = 20 ms


def _cross_attention_probs(p: Params, x: torch.Tensor, kv, head_dim: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention returning (output, probs (B, H, L, S) f32): f32
    scores, f32 softmax, the probabilities rounded to x's dtype for the
    value product."""
    h = _num_heads(p, head_dim)
    k, v = read_cross_kv(kv, x.dtype)
    q = split_heads(linear(x, p["q"]["w"], p["q"].get("b")), h)
    scores = matmul_f32(q * (head_dim ** -0.5), k.transpose(-1, -2))
    probs = torch.softmax(scores, dim=-1)
    o = torch.matmul(probs.to(q.dtype), v)
    out = linear(merge_heads(o), p["o"]["w"], p["o"].get("b"))
    return out, probs


@torch.inference_mode()
def cross_attention_weights(params: Params, arch: WhisperArch,
                            tokens: torch.Tensor, enc_out: torch.Tensor
                            ) -> torch.Tensor:
    """Teacher-forced decoder pass over tokens (B, L) returning the stacked
    cross-attention probabilities (L_layers, B, H, L, S) f32."""
    dec = params["decoder"]
    b, l = tokens.shape
    x = embed_tokens(dec, tokens.reshape(-1)).reshape(b, l, -1)
    x = x + dec["pos"][:l].to(x.dtype)
    causal = torch.triu(torch.full((l, l), NEG_INF, dtype=torch.float32,
                                   device=x.device), diagonal=1)[None, None]
    cross_kvs = precompute_cross_kv(params, arch, enc_out)
    all_probs = []
    for layer, kv in zip(dec["layers"], cross_kvs):
        x = x + self_attention(layer["attn"], layer_norm(x, layer["attn_ln"]),
                               arch.head_dim, mask=causal)
        o, probs = _cross_attention_probs(
            layer["cross"], layer_norm(x, layer["cross_ln"]), kv, arch.head_dim)
        x = x + o
        x = x + mlp(layer, layer_norm(x, layer["mlp_ln"]))
        all_probs.append(probs)
    return torch.stack(all_probs)


def default_alignment_heads(arch: WhisperArch) -> list[tuple[int, int]]:
    """(layer, head) pairs to align with. OpenAI ships a per-checkpoint mask;
    absent one, all heads of the top half of the decoder (OpenAI's fallback
    for fine-tuned checkpoints, whisper/__init__.py)."""
    lo = arch.decoder_layers // 2
    return [(li, h) for li in range(lo, arch.decoder_layers)
            for h in range(arch.decoder_heads)]


def _median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last axis (same size, edge-padded)."""
    if width <= 1:
        return x
    pad = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="edge")
    win = np.stack([xp[..., i:i + x.shape[-1]] for i in range(width)], axis=-1)
    return np.median(win, axis=-1)


def dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW through cost (N_tokens, M_frames); returns the
    (token_idx, frame_idx) backtraced path (OpenAI whisper/timing.py dtw).
    Ties prefer the diagonal, then the token step."""
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf, np.float64)
    trace = np.zeros((n + 1, m + 1), np.int8)
    acc[0, 0] = 0.0
    for i in range(1, n + 1):
        row_prev = acc[i - 1]
        row = acc[i]
        for j in range(1, m + 1):
            c0 = row_prev[j - 1]   # match (diagonal)
            c1 = row_prev[j]       # insertion (advance token)
            c2 = row[j - 1]        # deletion (advance frame)
            best = min(c0, c1, c2)
            row[j] = cost[i - 1, j - 1] + best
            trace[i, j] = 0 if best == c0 else (1 if best == c1 else 2)
    i, j = n, m
    path_i, path_j = [], []
    while i > 0 or j > 0:
        path_i.append(i - 1)
        path_j.append(j - 1)
        if i > 0 and j > 0:
            t = trace[i, j]
        elif i > 0:
            t = 1
        else:
            t = 2
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(path_i[::-1]), np.asarray(path_j[::-1])


def find_alignment(params: Params, arch: WhisperArch, enc_out: torch.Tensor,
                   tokens: np.ndarray,
                   alignment_heads: Sequence[tuple[int, int]] | None = None,
                   medfilt_width: int = 7,
                   n_frames: int | None = None) -> np.ndarray:
    """Token -> time alignment for ONE utterance.

    tokens: (L,) full decoder input (prefix + generated, no trailing pad);
    enc_out: (1, S, d) encoder states on the device the pass runs on.
    n_frames: valid encoder frames (all by default; pass the true audio
    length in frames to keep padding out of the alignment).

    Returns (L, 2) float32 [start, end] seconds per token."""
    tokens = np.asarray(tokens, np.int64)
    heads = (alignment_heads or list(arch.alignment_heads)
             or default_alignment_heads(arch))
    tok = torch.from_numpy(tokens[None]).to(enc_out.device)
    w = cross_attention_weights(params, arch, tok, enc_out).cpu().numpy()
    mats = np.stack([w[li, 0, h] for li, h in heads])    # (A, L, S)
    if n_frames is not None:
        mats = mats[..., :n_frames]

    # standardize per head over time, smooth, average heads (OpenAI recipe)
    mean = mats.mean(-2, keepdims=True)
    std = mats.std(-2, keepdims=True) + 1e-8
    mats = (mats - mean) / std
    mats = _median_filter(mats, medfilt_width)
    matrix = mats.mean(0)                                # (L, S)

    ti, fi = dtw_path(-matrix.astype(np.float64))
    # token boundaries: frames where the token index advances
    starts = np.zeros(len(tokens), np.float32)
    ends = np.zeros(len(tokens), np.float32)
    jump = np.flatnonzero(np.diff(ti, prepend=-1))       # first path idx per token
    start_frames = fi[jump]
    end_frames = np.append(start_frames[1:], fi[-1] + 1)
    starts[: len(start_frames)] = start_frames * FRAME_SECONDS
    ends[: len(end_frames)] = end_frames * FRAME_SECONDS
    return np.stack([starts, ends], axis=-1)


PREPEND_PUNCTUATIONS = "\"'\u201c\u00bf([{-"
APPEND_PUNCTUATIONS = "\"'.\u3002,\uff0c!\uff01?\uff1f:\uff1a\u201d)]}\u3001"


def merge_punctuations(words: list[dict],
                       prepended: str = PREPEND_PUNCTUATIONS,
                       appended: str = APPEND_PUNCTUATIONS) -> list[dict]:
    """Attach punctuation-only words to their neighbours (OpenAI
    whisper/timing.py merge_punctuations): a word made entirely of opening
    punctuation is glued onto the FOLLOWING word (its start time wins), one
    made of closing punctuation onto the PRECEDING word (its end time
    extends). Takes and returns [{"word", "start", "end", ...}] in order."""
    merged: list[dict] = []
    pending_prefix: dict | None = None
    for w in words:
        text = w["word"]
        if text and all(c in prepended for c in text):
            # accumulate consecutive opening punctuation
            if pending_prefix is None:
                pending_prefix = dict(w)
            else:
                pending_prefix["word"] += text
            continue
        if pending_prefix is not None:
            # the main word's extra keys ("probability") survive the merge
            w = {**w, "word": pending_prefix["word"] + text,
                 "start": pending_prefix["start"]}
            pending_prefix = None
        if merged and text and all(c in appended for c in text):
            merged[-1] = {**merged[-1], "word": merged[-1]["word"] + text,
                          "end": w["end"]}
            continue
        merged.append(dict(w))
    if pending_prefix is not None:  # a trailing orphan opener stays
        merged.append(pending_prefix)
    return merged


def word_timestamps(tokenizer, tokens: Sequence[int],
                    token_times: np.ndarray,
                    special_threshold: int | None = None,
                    offset: float = 0.0,
                    punctuations: bool = True,
                    token_logprobs: np.ndarray | None = None) -> list[dict]:
    """Group per-token times into words.

    A token whose decoded text begins with a space starts a new word.
    Special tokens (id >= special_threshold; by default the tokenizer's
    `special_start`, else 50257, the EOT id of the real vocabs) are skipped.
    punctuations=True merges punctuation-only words onto their neighbours
    (`merge_punctuations`); token_logprobs (len(tokens),) adds each word's
    "probability", exp(mean logprob of its tokens).

    Returns [{"word", "start", "end"[, "probability"]}], times offset by
    `offset` s."""
    if special_threshold is None:
        special_threshold = getattr(tokenizer, "special_start", 50257)
    lps = (None if token_logprobs is None
           else np.asarray(token_logprobs, np.float64))
    words: list[dict] = []
    cur = ""
    cur_start = cur_end = None
    cur_lp_sum, cur_lp_n = 0.0, 0

    def _flush():
        w = {"word": cur.strip(), "start": float(cur_start + offset),
             "end": float(cur_end + offset)}
        if lps is not None:
            w["probability"] = float(np.exp(cur_lp_sum / max(cur_lp_n, 1)))
        words.append(w)

    for i, (tok, (t0, t1)) in enumerate(zip(tokens, np.asarray(token_times))):
        if tok >= special_threshold:
            continue
        piece = tokenizer.decode([int(tok)])
        if not piece:
            continue
        if piece.startswith(" ") and cur.strip():
            _flush()
            cur = ""
            cur_start = None
            cur_lp_sum, cur_lp_n = 0.0, 0
        if cur_start is None:
            cur_start = t0
        cur += piece
        cur_end = t1
        if lps is not None:
            cur_lp_sum += float(lps[i])
            cur_lp_n += 1
    if cur.strip():
        _flush()
    return merge_punctuations(words) if punctuations else words
