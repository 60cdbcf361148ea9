"""Greedy autoregressive decoding with a persistent KV cache.

The JAX package's `models/decode.py` greedy path as a Python loop on the
host: one batched prefill of the forced prefix, then one `decoder_step` per
token, stopping early once every row has emitted EOT (the host reads one
flag per step). Each decoder layer's step runs the fused self-attention
kernel (cache row write + attention; the int8 kernel quantizes the row too
when `kv_int8` gives an int8 cache) and the grouped cross-attention kernel
over bf16, int8 (`cross_kv_int8`) or int4 (`cross_kv_int4`) cross-KV; the
decode-step linears run the int8 kernel.

Not in this slice (NotImplementedError): beam search, timestamp rules,
prompt conditioning, sampling, cross-KV pooling/merging, and the non-fused
(cross_pallas/self_pallas False) paths.
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
                      embed_tokens, layer_norm, merge_heads, mlp,
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
    """Raise NotImplementedError for every setting outside the port's slice."""
    unsupported = {
        "beam search (beam_size > 1)": cfg.beam_size != 1,
        "cross-KV pooling/merging": cfg.cross_kv_pool > 1 or cfg.cross_kv_merge > 0,
        "the unfused decode paths (cross_pallas/self_pallas False)":
            not (cfg.cross_pallas and cfg.self_pallas),
        "timestamp rules": (cfg.timestamp_rules and not cfg.notimestamps
                            and arch.no_timestamps_token_id + 1 < arch.vocab_size),
    }
    for what, hit in unsupported.items():
        if hit:
            raise NotImplementedError(f"{what} is not ported")


def decoder_step(params: Params, arch: WhisperArch, tok: torch.Tensor,
                 pos: int, cache: list, cross_kvs: list) -> torch.Tensor:
    """tok (B,) current tokens at position `pos` (a host int). Writes cache
    row `pos` of every layer in place (quantized, with its scales, in an
    int8 cache); returns logits (B, V)."""
    dec = params["decoder"]
    b = tok.shape[0]
    dh = arch.head_dim
    x = embed_tokens(dec, tok)[:, None, :]
    x = x + dec["pos"][pos: pos + 1][None].to(x.dtype)
    for i, layer in enumerate(dec["layers"]):
        p = layer["attn"]
        h = _num_heads(p, dh)
        q, k, v = qkv_project(p, layer_norm(x, layer["attn_ln"]), h)
        bh = b * h
        qf = (q.reshape(bh, dh) * (dh ** -0.5)).to(q.dtype)
        entry = cache[i]
        s = entry["k"].shape[2]
        rows = (qf.contiguous(), k.reshape(bh, dh).contiguous(),
                v.reshape(bh, dh).contiguous(), entry["k"].view(bh, s, dh),
                entry["v"].view(bh, s, dh))
        if "k_scale" in entry:
            o = decode_self_attention_update_int8(
                *rows, entry["k_scale"].view(bh, s),
                entry["v_scale"].view(bh, s), pos)
        else:
            o = decode_self_attention_update(*rows, pos)
        x = x + linear(o.reshape(b, 1, h * dh), p["o"]["w"], p["o"]["b"])
        x = x + cross_attention(layer["cross"], layer_norm(x, layer["cross_ln"]),
                                cross_kvs[i], dh)
        x = x + mlp(layer, layer_norm(x, layer["mlp_ln"]))
    x = layer_norm(x, dec["ln"])
    return project_out(dec, x)[:, 0, :]


def prefill(params: Params, arch: WhisperArch, tokens: torch.Tensor,
            cache: list, cross_kvs: list) -> None:
    """Run the (B, P) forced-prefix window through the decoder in one
    batched pass, filling cache positions [0, P) in place. With an int8
    cache the window attends to its exact k/v and only the cache holds the
    quantized rows, as in the JAX package."""
    dec = params["decoder"]
    b, p_len = tokens.shape
    x = embed_tokens(dec, tokens)
    x = x + dec["pos"][:p_len][None].to(x.dtype)
    iq = torch.arange(p_len, device=tokens.device)
    mask = torch.where(iq[None, :] <= iq[:, None], 0.0, NEG_INF).to(
        torch.float32)[None, None]
    for i, layer in enumerate(dec["layers"]):
        p = layer["attn"]
        q, k, v = qkv_project(p, layer_norm(x, layer["attn_ln"]),
                              _num_heads(p, arch.head_dim))
        kv_cache.update(cache[i], k, v, 0)
        x = x + linear(merge_heads(attention(q, k, v, mask)), p["o"]["w"],
                       p["o"]["b"])
        x = x + cross_attention(layer["cross"], layer_norm(x, layer["cross_ln"]),
                                cross_kvs[i], arch.head_dim)
        x = x + mlp(layer, layer_norm(x, layer["mlp_ln"]))


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
             cfg: DecodeConfig):
    """Cross-KV, prefilled cache and the token buffer holding the prefix."""
    check_supported(arch, cfg)
    b, device = enc_out.shape[0], enc_out.device
    prefix = forced_prefix(arch, cfg)
    p_len = len(prefix)
    max_len = _auto_cache_len(arch, p_len, cfg)
    bits = 4 if cfg.cross_kv_int4 else 8 if cfg.cross_kv_int8 else 16
    cross_kvs = precompute_cross_kv_t(params, arch, enc_out, bits=bits)
    cache = kv_cache.init_cache(params, arch, b, max_len, dtype=enc_out.dtype,
                                device=device, int8=cfg.kv_int8)
    tokens = torch.full((b, max_len), arch.eos_token_id, dtype=torch.long,
                        device=device)
    tokens[:, :p_len] = torch.tensor(prefix, dtype=torch.long, device=device)
    if p_len > 1:
        prefill(params, arch, tokens[:, : p_len - 1], cache, cross_kvs)
    return cross_kvs, cache, tokens, p_len, max_len


def first_step_logits(params: Params, arch: WhisperArch, enc_out: torch.Tensor,
                      cfg: DecodeConfig | None = None) -> torch.Tensor:
    """Raw logits (B, V) f32 of the first generated position (after the
    prefill), before any suppression: the quantity parity checks compare,
    since random weights make argmax tie-prone."""
    cfg = cfg or DecodeConfig()
    cross_kvs, cache, tokens, p_len, _ = _prepare(params, arch, enc_out, cfg)
    return decoder_step(params, arch, tokens[:, p_len - 1], p_len - 1, cache,
                        cross_kvs).float()


def greedy_decode(params: Params, arch: WhisperArch, enc_out: torch.Tensor,
                  cfg: DecodeConfig | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy decode. Returns (tokens (B, max_len) — prefix +
    generated, EOT-padded after stop; lengths (B,) — valid tokens including
    the prefix and the final EOT)."""
    cfg = cfg or DecodeConfig()
    eot = arch.eos_token_id
    cross_kvs, cache, tokens, first_gen, max_len = _prepare(
        params, arch, enc_out, cfg)
    device = enc_out.device
    sup = torch.from_numpy(_suppress_bias(arch, tuple(cfg.suppress_tokens))).to(device)
    begin_sup = torch.from_numpy(
        _suppress_bias(arch, tuple(cfg.begin_suppress_tokens))).to(device)
    limit = min(max_len, first_gen + cfg.max_new_tokens)
    pos = first_gen - 1
    finished = torch.zeros(tokens.shape[0], dtype=torch.bool, device=device)
    while pos < limit - 1 and not bool(finished.all()):
        logits = decoder_step(params, arch, tokens[:, pos], pos, cache,
                              cross_kvs) + sup
        if pos == first_gen - 1:
            logits = logits + begin_sup
        nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(finished, torch.full_like(nxt, eot), nxt)
        tokens[:, pos + 1] = nxt
        finished |= nxt == eot
        pos += 1
    return tokens, first_gen + _gen_lengths(tokens, first_gen, pos, eot)
