"""Speculative greedy decoding: a small draft Whisper proposes tokens, the
target model verifies them in one batched pass.

The JAX package's `models/speculative.py`, its `lax.while_loop` and
`lax.scan` as Python loops on the host: each round reads its accept count
`n` back (one sync a round, as `greedy_decode` reads `finished` a step).

Algorithm (greedy variant of Leviathan et al., arXiv:2211.17192):
  repeat:
    d_1..d_gamma   <- gamma autoregressive steps of the draft model
    logits_0..gamma <- ONE target pass over [t_last, d_1..d_gamma]  (verify window)
    accept the longest prefix with argmax(logits_{i-1}) == d_i;
    the first mismatch (or the bonus position) emits the target's own argmax.
Accepted tokens are those target-only greedy decoding gives: in f32 on the
CPU bit for bit (tests/test_torch_speculative.py). In bf16 on the card the
verify window (plain attention over the whole cache, the grouped
cross-attention kernel over the window's positions as query slots, the
linears at M = B·(gamma + 1)) rounds otherwise than the stepped path, so a
row may part from greedy where two logits tie.

The draft's steps are `models.decode.decoder_step` (the fused cache-update
and cross-attention kernels on the card) over caches `gamma + 1` rows longer
than greedy's; the verify window writes its rows through `cache.update`
(quantized in an int8 cache) and attends over `cache.read` of the whole
cache, fresh rows included, as the JAX package does: no kernel sees a
sliced cache. `verified_greedy_decode` verifies an external draft
(streaming's self-speculation), with the timestamp rules, a prompt window,
Jacobi rounds and padding lanes. Caches are written in place.

The cross-KV of both functions is `decode.cross_kvs_for`'s, greedy's own:
the JAX module's `_make_cross_kvs` with the pooling or merging that
`cross_kv_pool` / `cross_kv_merge` ask for, which the JAX
`speculative_decode` skips (and so parts from greedy under them).
"""

from __future__ import annotations

from typing import Any

import torch

from ..config import DecodeConfig, WhisperArch
from ..ops.linear import linear
from . import cache as kv_cache
from .decode import (_apply_timestamp_rules, _auto_cache_len, _gen_lengths,
                     _suppress_bias, _timestamps_enabled, cross_kvs_for,
                     decoder_step, forced_prefix, prefill)
from .whisper import (NEG_INF, CrossKV, _num_heads, attention, cross_attention,
                      cross_window_attention, embed_tokens, layer_norm,
                      merge_heads, mlp, project_out, qkv_project)

Params = dict[str, Any]


def verify_window(params: Params, arch: WhisperArch, window: torch.Tensor,
                  pos: int, cache: list, cross_kvs: list,
                  start: torch.Tensor | None = None) -> torch.Tensor:
    """Run a (B, W) token window at positions [pos, pos + W) through the
    decoder in one pass, attending to the cache below `pos` and causally
    within the window; writes the window's rows into `cache` in place and
    returns logits (B, W, V). (The JAX function takes the cache length as
    `max_len` and returns the cache too.)

    start: optional (B,) first valid slot per sequence (a left-padded
    prompt's mask and sequence-relative positions, as in `prefill` and
    `decoder_step`). Chunked prefill at an offset: the verify pass of
    speculative decoding."""
    dec = params["decoder"]
    b, w = window.shape
    device = window.device
    max_len = cache[0]["k"].shape[2]
    x = embed_tokens(dec, window.reshape(-1)).reshape(b, w, -1)
    if start is None:
        x = x + dec["pos"][pos: pos + w][None].to(x.dtype)
    else:
        pidx = (pos + torch.arange(w, device=device)[None, :]
                - start[:, None]).clamp_min(0).long()
        x = x + dec["pos"][pidx].to(x.dtype)

    # cache slot s is visible to window row i iff s <= pos + i (and s >= start)
    slot = torch.arange(max_len, device=device)[None, :]
    row = torch.arange(w, device=device)[:, None]
    ok = (slot <= pos + row)[None]                           # (1, W, S)
    if start is not None:
        ok = ok & (slot[None] >= start[:, None, None])
    mask = torch.where(ok, 0.0, NEG_INF).to(torch.float32)[:, None]

    for i, layer in enumerate(dec["layers"]):
        p = layer["attn"]
        q, k, v = qkv_project(p, layer_norm(x, layer["attn_ln"]),
                              _num_heads(p, arch.head_dim))
        kv_cache.update(cache[i], k, v, pos)
        o = attention(q, *kv_cache.read(cache[i], q.dtype), mask)
        x = x + linear(merge_heads(o), p["o"]["w"], p["o"].get("b"))
        cross = (cross_window_attention if isinstance(cross_kvs[i], CrossKV)
                 else cross_attention)
        x = x + cross(layer["cross"], layer_norm(x, layer["cross_ln"]),
                      cross_kvs[i], arch.head_dim)
        x = x + mlp(layer, layer_norm(x, layer["mlp_ln"]))
    return project_out(dec, layer_norm(x, dec["ln"]))


def _pad_positions(params: Params, extra: int) -> Params:
    """params with the decoder position table extended by `extra` zero rows.
    Drafting may compute (never accept) tokens up to gamma positions past
    greedy's last slot; the pad keeps those reads in bounds and feeds only
    predictions the accept clamp discards. Shares every other leaf."""
    dec = params["decoder"]
    pos = dec["pos"]
    pad = torch.zeros((extra, pos.shape[-1]), dtype=pos.dtype, device=pos.device)
    return {**params, "decoder": {**dec, "pos": torch.cat([pos, pad], dim=0)}}


def _biases(arch: WhisperArch, cfg: DecodeConfig, device) -> tuple:
    """The suppressed tokens' and the begin-suppressed tokens' additive
    biases (V,) f32 on `device`."""
    return tuple(torch.from_numpy(_suppress_bias(arch, tuple(ids))).to(device)
                 for ids in (cfg.suppress_tokens, cfg.begin_suppress_tokens))


def _accepted_prefix(ok: torch.Tensor) -> torch.Tensor:
    """(B, G) bool -> (B,) length of each row's all-True prefix."""
    return ok.to(torch.int32).cumprod(dim=1).sum(dim=1)


def speculative_decode(params_t: Params, arch_t: WhisperArch,
                       params_d: Params, arch_d: WhisperArch,
                       enc_t: torch.Tensor, enc_d: torch.Tensor,
                       cfg: DecodeConfig | None = None, gamma: int = 4,
                       max_len: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Speculative greedy decode.

    params_t/arch_t/enc_t: target model and its encoder output (B, S, d_t);
    params_d/arch_d/enc_d: the draft's. Both share the vocab and special
    ids (any Whisper size pair does). gamma: draft tokens per round.

    Returns (tokens (B, max_len), lengths (B,), rounds): tokens and lengths
    are what `greedy_decode(params_t, ...)` gives (bit for bit where the
    two paths round alike), outputs that fill the position window included;
    `rounds` counts target passes.

    After a round that accepts all gamma drafts the draft first steps the
    last of them, whose cache row it has not written: the JAX function
    skips that step and drafts the next round over a stale row (same
    tokens, more rounds).

    The draft needs up to gamma slots of lookahead past greedy's last one,
    so the loop runs in a workspace gamma + 1 slots longer (caches, token
    buffer, a zero-padded position table); acceptance is clamped at greedy's
    limit and the output cut back to greedy's `max_len`."""
    cfg = cfg or DecodeConfig()
    if cfg.beam_size > 1:
        raise ValueError("speculative decoding is greedy-only")
    if _timestamps_enabled(arch_t, cfg):
        raise ValueError("speculative decoding does not apply the timestamp "
                         "rules; decode with notimestamps=True (the default) "
                         "or use greedy_decode")
    b, device = enc_t.shape[0], enc_t.device
    eot = arch_t.eos_token_id
    prefix = forced_prefix(arch_t, cfg)
    p_len = len(prefix)
    max_len = min(max_len or _auto_cache_len(arch_t, p_len, cfg),
                  arch_t.max_target_positions)
    ws_len = max_len + gamma + 1
    params_t = _pad_positions(params_t, gamma + 1)
    params_d = _pad_positions(params_d, gamma + 1)
    sup, begin_sup = _biases(arch_t, cfg, device)

    ckv_t = cross_kvs_for(params_t, arch_t, enc_t, cfg)
    ckv_d = cross_kvs_for(params_d, arch_d, enc_d, cfg)
    cache_t = kv_cache.init_cache(params_t, arch_t, b, ws_len, dtype=enc_t.dtype,
                                  device=device, int8=cfg.kv_int8)
    cache_d = kv_cache.init_cache(params_d, arch_d, b, ws_len, dtype=enc_d.dtype,
                                  device=device, int8=cfg.kv_int8)
    tokens = torch.full((b, ws_len), eot, dtype=torch.long, device=device)
    tokens[:, :p_len] = torch.tensor(prefix, dtype=torch.long, device=device)
    if p_len > 1:
        prefill(params_t, arch_t, tokens[:, : p_len - 1], cache_t, ckv_t)
        prefill(params_d, arch_d, tokens[:, : p_len - 1], cache_d, ckv_d)

    limit = min(max_len, p_len + cfg.max_new_tokens)   # greedy's limit
    first_gen = p_len

    def argmax_biased(logits, p):
        logits = logits + sup
        if p == first_gen - 1:
            logits = logits + begin_sup
        return torch.argmax(logits, dim=-1)

    pos, rounds, n = p_len - 1, 0, 0
    finished = torch.zeros(b, dtype=torch.bool, device=device)
    while pos < limit - 1 and not bool(finished.all()):
        if n == gamma:
            # the last round accepted all gamma drafts: the draft never
            # stepped d_gamma, so its cache row pos - 1 is written here (the
            # JAX function leaves it stale, and drafts over it)
            decoder_step(params_d, arch_d, tokens[:, pos - 1], pos - 1, cache_d,
                         ckv_d, self_pallas=cfg.self_pallas)
        # draft: gamma sequential steps from position pos
        for i in range(gamma):
            logits = decoder_step(params_d, arch_d, tokens[:, pos + i], pos + i,
                                  cache_d, ckv_d, self_pallas=cfg.self_pallas)
            tokens[:, pos + i + 1] = argmax_biased(logits, pos + i)
        # target: one verify pass over [t_pos, d_1..d_gamma]
        logits_w = verify_window(params_t, arch_t, tokens[:, pos: pos + gamma + 1],
                                 pos, cache_t, ckv_t)
        pred = torch.stack([argmax_biased(logits_w[:, i], pos + i)
                            for i in range(gamma + 1)], dim=1)   # (B, gamma+1)
        n_acc = _accepted_prefix(pred[:, :gamma] == tokens[:, pos + 1: pos + 1 + gamma])
        # the batch moves in lockstep: by the batch-min acceptance, clamped
        # so that the last write lands at limit - 1 as greedy's does
        n = int(torch.where(finished, gamma, n_acc).min())
        n = min(n, limit - 2 - pos)
        # the token after the accepted run is the target's own prediction
        fix = torch.where(finished, eot, pred[:, n])
        tokens[:, pos + n + 1] = fix
        # an EOT inside the accepted run finishes its row
        run = tokens[:, pos + 1: pos + gamma + 2]
        keep = torch.arange(gamma + 1, device=device)[None, :] <= n
        finished = finished | (keep & (run == eot)).any(dim=1)
        pos += n + 1
        rounds += 1
    tokens = tokens[:, :max_len].clone()   # drop the workspace pad

    # greedy's stopping semantics: EOT after a row's first generated EOT
    # (later rounds may have left draft tokens there), and a round may
    # overshoot max_new_tokens by up to gamma
    gen = tokens[:, first_gen:]
    over = torch.arange(gen.shape[1], device=device)[None, :] >= cfg.max_new_tokens
    gen = torch.where(over, eot, gen)
    is_eot = (gen == eot).to(torch.int32)
    after_first_eot = (torch.cumsum(is_eot, dim=1) - is_eot) > 0
    tokens[:, first_gen:] = torch.where(after_first_eot, eot, gen)
    lengths = first_gen + _gen_lengths(tokens, first_gen, pos, eot)
    return tokens, lengths, rounds


def _last_ts_table(draft: torch.Tensor, ts_begin: int) -> torch.Tensor:
    """(B, G) draft -> (B, G+1) table: out[:, j] is the LAST timestamp token
    among draft[:, :j] (0 when none), the `last_ts` greedy_decode would hold
    after the first j draft tokens."""
    b, g = draft.shape
    is_ts = draft >= ts_begin
    idx = torch.where(is_ts, torch.arange(g, device=draft.device)[None, :], -1)
    li = torch.cummax(idx, dim=1).values                     # inclusive
    li = torch.cat([torch.full((b, 1), -1, dtype=li.dtype, device=li.device), li],
                   dim=1)
    val = torch.gather(draft, 1, li[:, 1:].clamp_min(0))
    val = torch.cat([torch.zeros((b, 1), dtype=draft.dtype, device=draft.device),
                     val], dim=1)
    return torch.where(li >= 0, val, torch.zeros_like(val))


def verified_greedy_decode(params: Params, arch: WhisperArch,
                           enc_out: torch.Tensor, cfg: DecodeConfig,
                           draft: torch.Tensor, draft_len: torch.Tensor,
                           max_len: int | None = None,
                           prompt_tokens: torch.Tensor | None = None,
                           prompt_lens: torch.Tensor | None = None,
                           rounds: int = 2,
                           active: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy decode that consumes an EXTERNAL draft (self-speculation for
    streaming re-decodes): verify the draft's generated tokens in one
    windowed target pass, then continue greedy stepping from the batch-min
    divergence. The output is `greedy_decode(params, arch, enc_out, cfg,
    prompt_tokens=...)`'s for any draft, junk included (where the windowed
    and stepped paths round alike); the draft only moves work from the
    sequential steps into the verify pass. Supports the timestamp rules and
    a prompt window.

    draft: (B, G) proposed GENERATED tokens, 1 <= G <= cfg.max_new_tokens;
    draft_len: (B,) valid counts (0 = no draft). rounds: verify passes
    before the sequential continuation; later ones are Jacobi iterations
    (each round's predictions draft the next beyond the committed prefix).
    active: optional (B,) bool; False rows are padding lanes, counted as
    fully accepted and finished, so they never hold back the batch-min
    continuation or the loop's end (their outputs are unspecified).

    Returns (tokens (B, max_len), lengths (B,), n_accepted (B,))."""
    cfg = cfg or DecodeConfig()
    if cfg.beam_size > 1:
        raise ValueError("verified decode is greedy-only")
    b, device = enc_out.shape[0], enc_out.device
    eot = arch.eos_token_id
    g = draft.shape[1]
    if g < 1 or g > cfg.max_new_tokens:
        raise ValueError(f"draft width {g} must be in [1, max_new_tokens]")

    prefix = forced_prefix(arch, cfg)
    p_len = len(prefix)
    pw = 0 if prompt_tokens is None else prompt_tokens.shape[1]
    max_len = max_len or _auto_cache_len(arch, pw + p_len, cfg)
    sup, begin_sup = _biases(arch, cfg, device)
    cross_kvs = cross_kvs_for(params, arch, enc_out, cfg)
    cache = kv_cache.init_cache(params, arch, b, max_len, dtype=enc_out.dtype,
                                device=device, int8=cfg.kv_int8)

    # token buffer: [prompt | prefix | draft | EOT pad], greedy_decode's
    # layout with the draft in the generated region
    tokens = torch.full((b, max_len), eot, dtype=torch.long, device=device)
    start = None
    if pw:
        tokens[:, :pw] = torch.as_tensor(prompt_tokens, device=device).long()
        if prompt_lens is None:
            prompt_lens = torch.full((b,), pw, device=device)
        start = (pw - torch.as_tensor(prompt_lens, device=device)).to(torch.int32)
    tokens[:, pw: pw + p_len] = torch.tensor(prefix, dtype=torch.long, device=device)
    first_gen = pw + p_len
    limit = min(max_len, first_gen + cfg.max_new_tokens)
    # clip the draft so that a full accept never passes greedy's last
    # written index (limit - 1)
    g_eff = min(g, limit - first_gen)
    draft = torch.as_tensor(draft, device=device)[:, :g_eff].long()
    draft_len = torch.as_tensor(draft_len, device=device).clamp(max=g_eff)
    jcol = torch.arange(g_eff, device=device)[None, :]
    keep = jcol < draft_len[:, None]
    draft = torch.where(keep, draft, eot)
    tokens[:, first_gen: first_gen + g_eff] = draft

    w = first_gen + g_eff
    use_ts = _timestamps_enabled(arch, cfg)
    ts_begin = arch.no_timestamps_token_id + 1

    def verify_round(draft, keep):
        logits_w = verify_window(params, arch, tokens[:, :w], 0, cache,
                                 cross_kvs, start=start)
        # conditioning position first_gen - 1 + j predicts draft[:, j]
        lg = logits_w[:, first_gen - 1: w - 1] + sup            # (B, G, V)
        lg[:, 0] += begin_sup
        if use_ts:
            last_ts = _last_ts_table(draft, ts_begin)
            lg = torch.stack([_apply_timestamp_rules(
                lg[:, j], tokens, first_gen - 1 + j, first_gen, last_ts[:, j],
                arch, cfg) for j in range(g_eff)], dim=1)
        pred = torch.argmax(lg, dim=-1)                          # (B, G)
        # greedy forces EOT after the first emitted EOT: a position after a
        # draft EOT accepts iff the draft holds EOT there too
        is_eot = (draft == eot).to(torch.int32)
        after_eot = (torch.cumsum(is_eot, dim=1) - is_eot) > 0
        ok = torch.where(after_eot, draft == eot, pred == draft) & keep
        return pred, _accepted_prefix(ok)

    for r in range(max(int(rounds), 1)):
        pred, n_acc = verify_round(draft, keep)
        if r + 1 < rounds:
            # Jacobi update: keep the committed prefix, draft the round's own
            # predictions beyond it (junk-conditioned ones fail the next check)
            draft = torch.where(jcol < n_acc[:, None], draft, pred)
            keep = torch.ones_like(keep)
            tokens[:, first_gen: first_gen + g_eff] = draft

    # continue lockstep greedy from the batch-min divergence, the state as
    # greedy would hold it there
    if active is not None:
        n_acc = torch.where(torch.as_tensor(active, device=device), n_acc, g_eff)
    n0 = int(n_acc.min())
    pos = first_gen - 1 + n0
    finished = ((jcol < n0) & (draft == eot)).any(dim=1)
    if active is not None:
        finished = finished | ~torch.as_tensor(active, device=device)
    last_ts = (_last_ts_table(draft, ts_begin)[:, n0] if use_ts
               else torch.zeros(b, dtype=torch.long, device=device))

    while pos < limit - 1 and not bool(finished.all()):
        logits = decoder_step(params, arch, tokens[:, pos], pos, cache, cross_kvs,
                              start=start, self_pallas=cfg.self_pallas) + sup
        if pos == first_gen - 1:
            logits = logits + begin_sup
        if use_ts:
            logits = _apply_timestamp_rules(logits, tokens, pos, first_gen,
                                            last_ts, arch, cfg)
        nxt = torch.where(finished, eot, torch.argmax(logits, dim=-1))
        if use_ts:
            last_ts = torch.where(~finished & (nxt >= ts_begin), nxt, last_ts)
        tokens[:, pos + 1] = nxt
        finished = finished | (nxt == eot)
        pos += 1

    # greedy leaves EOT beyond its last position; the draft may have left
    # tokens there
    tokens = torch.where(torch.arange(max_len, device=device)[None, :] > pos,
                         eot, tokens)
    lengths = first_gen + _gen_lengths(tokens, first_gen, pos, eot)
    return tokens, lengths, n_acc


def self_speculative_draft(params: Params, arch: WhisperArch,
                           keep_encoder: int | None = None,
                           keep_decoder: int = 2) -> tuple[Params, WhisperArch]:
    """Draft = a layer-dropped view of the TARGET itself (self-speculative
    decoding): the first `keep_decoder` decoder layers (and optionally the
    first `keep_encoder` encoder layers). The draft's tensors are the
    target's own (no copy; only its KV cache is extra).

    Returns (draft_params, draft_arch) for `speculative_decode` /
    `make_speculative_transcribe_fn`."""
    from ..prune.structured import drop_layers

    draft = params
    d_layers = len(params["decoder"]["layers"])
    if keep_decoder < d_layers:
        draft = drop_layers(draft, "decoder", list(range(keep_decoder, d_layers)))
    e_layers = len(params["encoder"]["layers"])
    if keep_encoder is not None and keep_encoder < e_layers:
        draft = drop_layers(draft, "encoder", list(range(keep_encoder, e_layers)))
    arch_d = arch.replace(
        name=f"{arch.name}-selfdraft",
        decoder_layers=min(keep_decoder, d_layers),
        encoder_layers=(e_layers if keep_encoder is None
                        else min(keep_encoder, e_layers)))
    return draft, arch_d
