"""Autoregressive decoding (greedy and beam) with a persistent KV cache.

The JAX package's `models/decode.py` as Python loops on the host: one
batched prefill of the [prompt +] forced-prefix window, then one
`decoder_step` per token, stopping early once every row has emitted EOT (the
host reads one flag per step). Each decoder layer's step runs the fused
self-attention kernel (cache row write + attention from each row's `start`;
the int8 kernel quantizes the row too when `kv_int8` gives an int8 cache)
and the grouped cross-attention kernel over bf16, int8 (`cross_kv_int8`) or
int4 (`cross_kv_int4`) cross-KV, the beams of an utterance riding its query
slots; the decode-step linears run the quantized-matmul kernels. Prompt
conditioning (a right-aligned, left-padded prompt window), the timestamp
rules, beam search, language detection and the no-speech probability follow
the JAX functions of the same names.

Not in the port (NotImplementedError): temperature sampling (`sample_key`,
with the fallback ladder of `models/fallback.py`), cross-KV pooling/merging,
and the non-fused (cross_pallas/self_pallas False) paths.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..config import DecodeConfig, WhisperArch
from ..ops.linear import linear
from ..ops.self_attention_step import (decode_self_attention_update,
                                       decode_self_attention_update_int8)
from . import cache as kv_cache
from .whisper import (NEG_INF, _num_heads, attention, cross_attention,
                      cross_window_attention, embed_tokens, encode,
                      grouped_cross_attention, layer_norm, merge_heads, mlp,
                      precompute_cross_kv_t, project_out, qkv_project)

Params = dict[str, Any]


def forced_prefix(arch: WhisperArch, cfg: DecodeConfig) -> list[int]:
    """[<|sot|>, lang, task, <|notimestamps|>] as the vocab allows."""
    ids = [arch.decoder_start_token_id]
    if arch.multilingual:
        real_vocab = arch.vocab_size >= 51865
        lang = cfg.language_token_id
        if lang == "auto":
            lang = arch.language_en_token_id if real_vocab else None
        task = cfg.task_token_id
        if task == "auto":
            task = arch.task_transcribe_token_id if real_vocab else None
        if lang is not None:
            ids.append(lang)
        if task is not None:
            ids.append(task)
    if cfg.notimestamps and arch.no_timestamps_token_id < arch.vocab_size:
        ids.append(arch.no_timestamps_token_id)
    return [i for i in ids if i < arch.vocab_size]


def _suppress_bias(arch: WhisperArch, ids: tuple[int, ...]) -> np.ndarray:
    bias = np.zeros((arch.vocab_size,), np.float32)
    for i in ids:
        if 0 <= i < arch.vocab_size:
            bias[i] = NEG_INF
    return bias


def check_supported(arch: WhisperArch, cfg: DecodeConfig) -> None:
    """Raise NotImplementedError for every setting outside the port."""
    unsupported = {
        "cross-KV pooling/merging": cfg.cross_kv_pool > 1 or cfg.cross_kv_merge > 0,
        "the unfused decode paths (cross_pallas/self_pallas False)":
            not (cfg.cross_pallas and cfg.self_pallas),
    }
    for what, hit in unsupported.items():
        if hit:
            raise NotImplementedError(f"{what} is not ported")


# ---------------------------------------------------------------------------
# Single decode step and batched prefill through the cache
# ---------------------------------------------------------------------------

def decoder_step(params: Params, arch: WhisperArch, tok: torch.Tensor,
                 pos: int, cache: list, cross_kvs: list,
                 start: torch.Tensor | None = None,
                 beam: int = 1) -> torch.Tensor:
    """tok (B,) current tokens at position `pos` (a host int). Writes cache
    row `pos` of every layer in place (quantized, with its scales, in an
    int8 cache); returns logits (B, V).

    start: optional (B,) int32 first valid cache position of each row (the
    left padding of a prompt window is masked out, and positions count from
    `start`). beam > 1: the rows are B/beam utterances x beam flattened
    beams sharing cross_kvs entries of batch B/beam."""
    dec = params["decoder"]
    b = tok.shape[0]
    dh = arch.head_dim
    x = embed_tokens(dec, tok)[:, None, :]
    if start is None:
        x = x + dec["pos"][pos: pos + 1][None].to(x.dtype)
    else:
        pidx = (pos - start).clamp_min(0).long()
        x = x + dec["pos"][pidx][:, None, :].to(x.dtype)
    start_bh = None
    for i, layer in enumerate(dec["layers"]):
        p = layer["attn"]
        h = _num_heads(p, dh)
        q, k, v = qkv_project(p, layer_norm(x, layer["attn_ln"]), h)
        bh = b * h
        if start is not None and (start_bh is None or start_bh.shape[0] != bh):
            start_bh = start.repeat_interleave(h)
        qf = (q.reshape(bh, dh) * (dh ** -0.5)).to(q.dtype)
        entry = cache[i]
        s = entry["k"].shape[2]
        rows = (qf.contiguous(), k.reshape(bh, dh).contiguous(),
                v.reshape(bh, dh).contiguous(), entry["k"].view(bh, s, dh),
                entry["v"].view(bh, s, dh))
        if "k_scale" in entry:
            o = decode_self_attention_update_int8(
                *rows, entry["k_scale"].view(bh, s),
                entry["v_scale"].view(bh, s), pos, start=start_bh)
        else:
            o = decode_self_attention_update(*rows, pos, start=start_bh)
        x = x + linear(o.reshape(b, 1, h * dh), p["o"]["w"], p["o"]["b"])
        hs_c = layer_norm(x, layer["cross_ln"])
        if beam > 1:
            x = x + grouped_cross_attention(layer["cross"], hs_c, cross_kvs[i],
                                            dh, beam)
        else:
            x = x + cross_attention(layer["cross"], hs_c, cross_kvs[i], dh)
        x = x + mlp(layer, layer_norm(x, layer["mlp_ln"]))
    x = layer_norm(x, dec["ln"])
    return project_out(dec, x)[:, 0, :]


def prefill(params: Params, arch: WhisperArch, tokens: torch.Tensor,
            cache: list, cross_kvs: list,
            start: torch.Tensor | None = None) -> None:
    """Run the (B, P) [prompt +] forced-prefix window through the decoder in
    one batched pass, filling cache positions [0, P) in place. `start`:
    optional (B,) first valid position (left-padded prompts). With an int8
    cache the window attends to its exact k/v and only the cache holds the
    quantized rows, as in the JAX package."""
    dec = params["decoder"]
    b, p_len = tokens.shape
    iq = torch.arange(p_len, device=tokens.device)
    x = embed_tokens(dec, tokens)
    ok = (iq[None, :] <= iq[:, None])[None]                 # causal (1, P, P)
    if start is None:
        x = x + dec["pos"][:p_len][None].to(x.dtype)
    else:
        pidx = (iq[None, :] - start[:, None]).clamp_min(0).long()
        x = x + dec["pos"][pidx].to(x.dtype)
        ok = ok & (iq[None, None, :] >= start[:, None, None])
    mask = torch.where(ok, 0.0, NEG_INF).to(torch.float32)[:, None]
    for i, layer in enumerate(dec["layers"]):
        p = layer["attn"]
        q, k, v = qkv_project(p, layer_norm(x, layer["attn_ln"]),
                              _num_heads(p, arch.head_dim))
        kv_cache.update(cache[i], k, v, 0)
        x = x + linear(merge_heads(attention(q, k, v, mask)), p["o"]["w"],
                       p["o"]["b"])
        x = x + cross_window_attention(
            layer["cross"], layer_norm(x, layer["cross_ln"]), cross_kvs[i],
            arch.head_dim)
        x = x + mlp(layer, layer_norm(x, layer["mlp_ln"]))


# ---------------------------------------------------------------------------
# Timestamp rules (OpenAI ApplyTimestampRules semantics)
# ---------------------------------------------------------------------------

def _timestamps_enabled(arch: WhisperArch, cfg: DecodeConfig) -> bool:
    """Timestamp rules apply when the prefix omits <|notimestamps|> and the
    vocab holds timestamp tokens (ids > no_timestamps)."""
    return (cfg.timestamp_rules and not cfg.notimestamps
            and arch.no_timestamps_token_id + 1 < arch.vocab_size)


def _apply_timestamp_rules(logits: torch.Tensor, tokens: torch.Tensor,
                           pos: int, first_gen: int, last_ts: torch.Tensor,
                           arch: WhisperArch, cfg: DecodeConfig) -> torch.Tensor:
    """Bias `logits` (B, V) for the token at position pos + 1 following
    OpenAI's rules, term for term the JAX package's function:

    1. <|notimestamps|> is never sampled.
    2. After a lone timestamp (its predecessor a generated non-timestamp)
       only a timestamp or EOT/special may follow; after a completed pair,
       and after the initial timestamp, text must follow.
    3. Timestamps never decrease; once a pair completes (or after the
       initial timestamp) the next must be strictly greater.
    4. The first generated token is a timestamp, at most
       max_initial_timestamp_index.
    5. If the total timestamp probability beats the best text token,
       everything below timestamp_begin (EOT and specials too) is
       suppressed.

    tokens: (B, L) buffer; last_ts: (B,) last emitted timestamp id, 0 when
    none was emitted yet. Every rule adds its own NEG_INF, so a logit two
    rules suppress ends at 2 * NEG_INF, as in JAX."""
    ts_begin = arch.no_timestamps_token_id + 1
    vocab = arch.vocab_size
    ids = torch.arange(vocab, device=logits.device)
    is_ts_id = ids >= ts_begin
    eot = arch.eos_token_id
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=logits.device)
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)

    logits = logits + torch.where(ids == arch.no_timestamps_token_id, neg, zero)  # 1

    last = tokens[:, pos]
    penult = tokens[:, max(pos - 1, 0)]
    last_is_ts = (last >= ts_begin) & (pos >= first_gen)
    # fewer than two generated tokens counts as penultimate-was-timestamp
    penult_is_ts = (penult >= ts_begin) | (pos - 1 < first_gen)

    # rule 2
    force_ts = (last_is_ts & ~penult_is_ts)[:, None]
    block_ts = (last_is_ts & penult_is_ts)[:, None]
    logits = logits + torch.where(force_ts & (ids < eot)[None, :], neg, zero)
    logits = logits + torch.where(block_ts & is_ts_id[None, :], neg, zero)

    # rule 3: no-op before the first timestamp (last_ts == 0)
    has_ts = last_ts >= ts_begin
    thresh = torch.where(has_ts, torch.where(force_ts[:, 0], last_ts, last_ts + 1),
                         torch.zeros_like(last_ts))
    logits = logits + torch.where(
        is_ts_id[None, :] & (ids[None, :] < thresh[:, None]), neg, zero)

    # rule 4
    if pos == first_gen - 1:
        max_init = min(ts_begin + cfg.max_initial_timestamp_index, vocab - 1)
        logits = logits + torch.where(~is_ts_id | (ids > max_init), neg, zero)[None, :]

    # rule 5
    logp = torch.log_softmax(logits.float(), dim=-1)
    ts_logp = torch.logsumexp(torch.where(is_ts_id[None, :], logp, neg), dim=-1)
    max_text = torch.where(is_ts_id[None, :], neg, logp).amax(dim=-1)
    ts_wins = (ts_logp > max_text)[:, None]
    return logits + torch.where(ts_wins & ~is_ts_id[None, :], neg, zero)


def timestamp_token_to_seconds(arch: WhisperArch, token: int) -> float:
    """<|t|> token id -> seconds (0.02 s per step, OpenAI convention)."""
    return (token - (arch.no_timestamps_token_id + 1)) * 0.02


# ---------------------------------------------------------------------------
# Shared set-up of greedy and beam decoding
# ---------------------------------------------------------------------------

def _auto_cache_len(arch: WhisperArch, p_len: int, cfg: DecodeConfig) -> int:
    """KV cache length for the requested decode, rounded up to 64."""
    need = p_len + cfg.max_new_tokens + 1
    return min(arch.max_target_positions, -(-need // 64) * 64)


def _gen_lengths(tokens: torch.Tensor, p_len: int, pos: int,
                 eot: int) -> torch.Tensor:
    """Generated-token count per row: through the first EOT the loop wrote,
    else every token the loop wrote (`pos` is the last written index)."""
    is_eot = tokens[:, p_len:] == eot
    gen_count = pos + 1 - p_len
    first_eot = torch.argmax(is_eot.to(torch.int32), dim=1)
    emitted = is_eot.any(dim=1) & (first_eot < gen_count)
    return torch.where(emitted, first_eot + 1, torch.full_like(first_eot, gen_count))


def _prepare(params: Params, arch: WhisperArch, enc_out: torch.Tensor,
             cfg: DecodeConfig, max_len: int | None = None,
             prompt_tokens: torch.Tensor | None = None,
             prompt_lens: torch.Tensor | None = None):
    """Cross-KV, the cache prefilled with the [prompt +] prefix window at
    batch B, the token buffer holding that window, each row's `start` (None
    without a prompt), the index of the first generated token, and the cache
    length."""
    check_supported(arch, cfg)
    b, device = enc_out.shape[0], enc_out.device
    prefix = forced_prefix(arch, cfg)
    p_len = len(prefix)
    pw = 0 if prompt_tokens is None else prompt_tokens.shape[1]
    max_len = max_len or _auto_cache_len(arch, pw + p_len, cfg)
    bits = 4 if cfg.cross_kv_int4 else 8 if cfg.cross_kv_int8 else 16
    cross_kvs = precompute_cross_kv_t(params, arch, enc_out, bits=bits)
    cache = kv_cache.init_cache(params, arch, b, max_len, dtype=enc_out.dtype,
                                device=device, int8=cfg.kv_int8)
    tokens = torch.full((b, max_len), arch.eos_token_id, dtype=torch.long,
                        device=device)
    start = None
    if pw:
        tokens[:, :pw] = torch.as_tensor(prompt_tokens, device=device).long()
        if prompt_lens is None:
            prompt_lens = torch.full((b,), pw, device=device)
        start = (pw - torch.as_tensor(prompt_lens, device=device)).to(torch.int32)
    first_gen = pw + p_len
    tokens[:, pw: first_gen] = torch.tensor(prefix, dtype=torch.long, device=device)
    if first_gen > 1:
        prefill(params, arch, tokens[:, : first_gen - 1], cache, cross_kvs,
                start=start)
    return cross_kvs, cache, tokens, start, first_gen, max_len


def _tile_beams(cache: list, tokens: torch.Tensor, start: torch.Tensor | None,
                beam: int):
    """The batch-B prefilled state repeated to B*beam rows, beams of one
    utterance consecutive (every cache field, the int8 scales included)."""
    cache = [{n: t.repeat_interleave(beam, dim=0) for n, t in e.items()}
             for e in cache]
    return (cache, tokens.repeat_interleave(beam, dim=0),
            None if start is None else start.repeat_interleave(beam))


def _logits_fn(params: Params, arch: WhisperArch, cfg: DecodeConfig,
               cross_kvs: list, start: torch.Tensor | None, first_gen: int,
               beam: int, device: torch.device):
    """fn(tokens, cache, pos, last_ts) -> (B, V) f32 logits for position
    pos + 1: a decoder step, the suppressed tokens, the begin-suppressed
    ones at the first generated position, the timestamp rules."""
    sup = torch.from_numpy(_suppress_bias(arch, tuple(cfg.suppress_tokens))).to(device)
    begin_sup = torch.from_numpy(
        _suppress_bias(arch, tuple(cfg.begin_suppress_tokens))).to(device)
    use_ts = _timestamps_enabled(arch, cfg)

    def fn(tokens, cache, pos, last_ts):
        logits = decoder_step(params, arch, tokens[:, pos], pos, cache, cross_kvs,
                              start=start, beam=beam) + sup
        if pos == first_gen - 1:
            logits = logits + begin_sup
        if use_ts:
            logits = _apply_timestamp_rules(logits, tokens, pos, first_gen,
                                            last_ts, arch, cfg)
        return logits

    return fn, use_ts


def first_step_logits(params: Params, arch: WhisperArch, enc_out: torch.Tensor,
                      cfg: DecodeConfig | None = None,
                      prompt_tokens: torch.Tensor | None = None,
                      prompt_lens: torch.Tensor | None = None) -> torch.Tensor:
    """Raw logits (B * beam_size, V) f32 of the first generated position
    (after the prefill, the caches tiled to the beams), before any
    suppression: the quantity parity checks compare, since random weights
    make argmax tie-prone."""
    cfg = cfg or DecodeConfig()
    cross_kvs, cache, tokens, start, first_gen, _ = _prepare(
        params, arch, enc_out, cfg, None, prompt_tokens, prompt_lens)
    beam = max(cfg.beam_size, 1)
    if beam > 1:
        cache, tokens, start = _tile_beams(cache, tokens, start, beam)
    return decoder_step(params, arch, tokens[:, first_gen - 1], first_gen - 1,
                        cache, cross_kvs, start=start, beam=beam).float()


# ---------------------------------------------------------------------------
# Greedy decode
# ---------------------------------------------------------------------------

def greedy_decode(params: Params, arch: WhisperArch, enc_out: torch.Tensor,
                  cfg: DecodeConfig | None = None, max_len: int | None = None,
                  prompt_tokens: torch.Tensor | None = None,
                  prompt_lens: torch.Tensor | None = None,
                  sample_key=None, temperature: float = 0.0,
                  return_logprobs: bool = False,
                  return_token_logprobs: bool = False):
    """Batched greedy decode.

    Optional prompt conditioning: `prompt_tokens` (B, P) holds right-aligned
    prompt ids; the left padding is masked out of attention through
    `prompt_lens` (B,). The forced prefix and the generated tokens follow at
    positions >= P.

    return_logprobs=True also returns the mean logprob of each row's
    generated tokens; return_token_logprobs=True the (B, max_len) f32 trace
    (0.0 at prompt, prefix and padding positions; trace[:, i] is the logprob
    of tokens[:, i]).

    Returns (tokens (B, max_len): [prompt +] prefix + generated, EOT-padded
    after stop; lengths (B,): valid tokens including the prompt window, the
    prefix and the final EOT[, avg_logprob (B,) f32][, token_logprobs
    (B, max_len) f32])."""
    if sample_key is not None or temperature != 0.0:
        raise NotImplementedError(
            "temperature sampling is not ported: it comes with the fallback "
            "ladder of models/fallback.py")
    cfg = cfg or DecodeConfig()
    eot = arch.eos_token_id
    cross_kvs, cache, tokens, start, first_gen, max_len = _prepare(
        params, arch, enc_out, cfg, max_len, prompt_tokens, prompt_lens)
    device = enc_out.device
    b = tokens.shape[0]
    logits_fn, use_ts = _logits_fn(params, arch, cfg, cross_kvs, start,
                                   first_gen, 1, device)
    ts_begin = arch.no_timestamps_token_id + 1
    limit = min(max_len, first_gen + cfg.max_new_tokens)
    pos = first_gen - 1
    finished = torch.zeros(b, dtype=torch.bool, device=device)
    last_ts = torch.zeros(b, dtype=torch.long, device=device)
    sum_lp = torch.zeros(b, dtype=torch.float32, device=device)
    lp_trace = torch.zeros((b, max_len), dtype=torch.float32, device=device)
    while pos < limit - 1 and not bool(finished.all()):
        logits = logits_fn(tokens, cache, pos, last_ts)
        nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(finished, torch.full_like(nxt, eot), nxt)
        if return_logprobs or return_token_logprobs:
            lp = torch.log_softmax(logits.float(), dim=-1)
            tok_lp = lp.gather(1, nxt[:, None])[:, 0]
            tok_lp = torch.where(finished, torch.zeros_like(tok_lp), tok_lp)
            sum_lp = sum_lp + tok_lp
            lp_trace[:, pos + 1] = tok_lp
        if use_ts:
            last_ts = torch.where(~finished & (nxt >= ts_begin), nxt, last_ts)
        tokens[:, pos + 1] = nxt
        finished = finished | (nxt == eot)
        pos += 1
    lengths = first_gen + _gen_lengths(tokens, first_gen, pos, eot)
    out = (tokens, lengths)
    if return_logprobs:
        n_gen = (lengths - first_gen).clamp_min(1).float()
        out = out + (sum_lp / n_gen,)
    if return_token_logprobs:
        out = out + (lp_trace,)
    return out


def transcribe_tokens(params: Params, arch: WhisperArch, mel: torch.Tensor,
                      cfg: DecodeConfig | None = None):
    """mel (B, n_mels, 2·T) -> (tokens, lengths): encoder + greedy decode."""
    return greedy_decode(params, arch, encode(params, arch, mel), cfg)


# ---------------------------------------------------------------------------
# Beam search (batch * beam flattened)
# ---------------------------------------------------------------------------

def _top_k(cand: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, in descending order, equal values in
    ascending index order: `lax.top_k`'s contract, which `torch.topk` does
    not give on ties (finished beams tie many candidates at NEG_INF)."""
    values, idx = torch.sort(cand, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def _beam_search(params: Params, arch: WhisperArch, enc_out: torch.Tensor,
                 cfg: DecodeConfig, max_len: int | None,
                 prompt_tokens: torch.Tensor | None,
                 prompt_lens: torch.Tensor | None):
    """The search of `beam_decode` (cfg.beam_size > 1), every beam kept:
    (tokens (B·K, max_len), scores (B·K,) f32 summed logprobs, generated
    lengths (B·K,), the index of the first generated token), the K beams of
    a batch row consecutive."""
    beam = cfg.beam_size
    eot, vocab = arch.eos_token_id, arch.vocab_size
    cross_kvs, cache, tokens, start, first_gen, max_len = _prepare(
        params, arch, enc_out, cfg, max_len, prompt_tokens, prompt_lens)
    device = enc_out.device
    b = tokens.shape[0]
    cache, tokens, start = _tile_beams(cache, tokens, start, beam)
    logits_fn, use_ts = _logits_fn(params, arch, cfg, cross_kvs, start,
                                   first_gen, beam, device)
    ts_begin = arch.no_timestamps_token_id + 1
    limit = min(max_len, first_gen + cfg.max_new_tokens)

    # beam 0 starts at 0, the others at NEG_INF: step 1 fans out from beam 0
    scores = torch.tensor([0.0] + [NEG_INF] * (beam - 1), dtype=torch.float32,
                          device=device).repeat(b)
    finished = torch.zeros(b * beam, dtype=torch.bool, device=device)
    last_ts = torch.zeros(b * beam, dtype=torch.long, device=device)
    # a finished beam: only EOT allowed, at zero cost (its score freezes)
    frozen = torch.full((vocab,), NEG_INF, dtype=torch.float32, device=device)
    frozen[eot] = 0.0
    row0 = torch.arange(b, device=device)[:, None] * beam
    pos = first_gen - 1
    while pos < limit - 1 and not bool(finished.all()):
        logits = logits_fn(tokens, cache, pos, last_ts)
        logp = torch.log_softmax(logits.float(), dim=-1)
        logp = torch.where(finished[:, None], frozen[None], logp)
        cand = (scores[:, None] + logp).reshape(b, beam * vocab)
        top_scores, top_idx = _top_k(cand, beam)              # (B, K)
        flat = (row0 + top_idx // vocab).reshape(-1)          # source beams
        nxt = (top_idx % vocab).reshape(-1)
        tokens, finished, last_ts = tokens[flat], finished[flat], last_ts[flat]
        cache = [{n: t[flat] for n, t in e.items()} for e in cache]
        tokens[:, pos + 1] = nxt
        if use_ts:
            last_ts = torch.where(~finished & (nxt >= ts_begin), nxt, last_ts)
        finished = finished | (nxt == eot)
        scores = top_scores.reshape(-1)
        pos += 1

    return tokens, scores, _gen_lengths(tokens, first_gen, pos, eot), first_gen


def beam_decode(params: Params, arch: WhisperArch, enc_out: torch.Tensor,
                cfg: DecodeConfig | None = None, max_len: int | None = None,
                prompt_tokens: torch.Tensor | None = None,
                prompt_lens: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched beam search; returns the best hypothesis of each batch row.

    All K beams advance every step; a finished beam is frozen by forcing EOT
    at zero cost. Scores are sums of logprobs, with the length penalty
    `len ** alpha` applied at selection. The prompt + prefix window is
    prefilled once at batch B (the beams are identical until the first
    generated token) and the caches tiled to B·K; the cross-KV stays at
    batch B, the K beams of an utterance sharing its entry through the
    grouped cross-attention. Each step regathers tokens, every cache field
    (int8 codes with their scales), `finished` and `last_ts` by the source
    beams of the surviving candidates."""
    cfg = cfg or DecodeConfig()
    beam = cfg.beam_size
    if beam <= 1:
        return greedy_decode(params, arch, enc_out, cfg, max_len,
                             prompt_tokens=prompt_tokens, prompt_lens=prompt_lens)
    tokens, scores, gen_len, first_gen = _beam_search(
        params, arch, enc_out, cfg, max_len, prompt_tokens, prompt_lens)
    # the best beam of each batch row, by the length-penalised score
    adj = scores / torch.pow(gen_len.float(), cfg.length_penalty)
    best = torch.argmax(adj.reshape(-1, beam), dim=1)
    flat = torch.arange(best.shape[0], device=best.device) * beam + best
    return tokens[flat], (first_gen + gen_len)[flat]


# ---------------------------------------------------------------------------
# Language identification and the no-speech probability
# ---------------------------------------------------------------------------

def _language_token_range(arch: WhisperArch) -> tuple[int, int]:
    """The language tokens' id range [<|sot|> + 1, <|translate|>), with
    <|translate|> = no_timestamps - 5 in every multilingual vocab."""
    lo = arch.decoder_start_token_id + 1
    hi = min(arch.no_timestamps_token_id - 5, arch.vocab_size)
    if hi <= lo:
        raise ValueError(f"vocab of {arch.name} has no language-token range")
    return lo, hi


def _sot_step_logits(params: Params, arch: WhisperArch, enc_out: torch.Tensor,
                     max_len: int) -> torch.Tensor:
    """Logits (B, V) of one decoder step from <|startoftranscript|> over an
    empty cache of `max_len` rows, through the fused kernels (the JAX
    functions take the unfused path here; the function is the same)."""
    b = enc_out.shape[0]
    cache = kv_cache.init_cache(params, arch, b, max_len, dtype=enc_out.dtype,
                                device=enc_out.device)
    cross_kvs = precompute_cross_kv_t(params, arch, enc_out)
    sot = torch.full((b,), arch.decoder_start_token_id, dtype=torch.long,
                     device=enc_out.device)
    return decoder_step(params, arch, sot, 0, cache, cross_kvs)


def detect_language(params: Params, arch: WhisperArch, enc_out: torch.Tensor,
                    lang_range: tuple[int, int] | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decoder step from <|startoftranscript|>, softmaxed over the
    language tokens only. Returns (probs (B, n_langs) over the
    language-token range, top_token (B,) absolute token ids)."""
    if not arch.multilingual:
        raise ValueError(
            f"{arch.name} is English-only: its vocab has no language tokens")
    lo, hi = lang_range or _language_token_range(arch)
    lang_logits = _sot_step_logits(params, arch, enc_out, 64)[:, lo:hi].float()
    return torch.softmax(lang_logits, dim=-1), torch.argmax(lang_logits, dim=-1) + lo


def no_speech_prob(params: Params, arch: WhisperArch,
                   enc_out: torch.Tensor) -> torch.Tensor:
    """P(<|nospeech|>) at the <|startoftranscript|> step, (B,) f32."""
    logits = _sot_step_logits(params, arch, enc_out, 8)
    return torch.softmax(logits.float(), dim=-1)[:, arch.no_speech_token_id]
