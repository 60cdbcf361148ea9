"""What the model needs, from its shapes: operations, bytes, least times.

The yardstick of the rooflines and of `mfu`. It counts what Whisper's
equations need for the work a cell asks for, whatever implements them, so a
later change to a kernel cannot change it. A multiply-add is 2 operations.
Counted:

- the encoder of one 30 s window: the conv stem (80 or 128 mels x 3000
  frames, stride 1; then stride 2 to 1500 positions) and every layer at all
  1500 positions (q, k, v, o, fc1, fc2; scores and the weighted sum);
- the cross-attention K and V projections of every decoder layer at the
  1500 encoder positions, once per request;
- the decoder per position it runs (the forced prefix but its last token in
  the prefill, then one position per new token): its linears, the
  self-attention over the positions so far, the cross-attention over 1500
  positions; and the logits of each new token over the vocabulary.

Not counted: the log-mel frontend (about 1 GFLOP a window as a DFT, under
0.5% of whisper-small's encoder), layer norms, GELUs, softmax and biases.

Bytes of a decode step (the least traffic a step needs): the decoder's
linear weights at their stored width (int8: 1 byte an element and a 4-byte
scale an output channel) and the tied embedding (2 bytes), each read once;
the cross-KV and the self-KV read once at their stored width with their
per-(row, head, position) scales; the logits written once in bf16.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (the data sheet's dense rates, at a 700 W limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}
DEFAULT_PEAK = PEAKS["NVIDIA H100 80GB HBM3"]


def peak_of(kind: str) -> dict:
    """The peaks of the card named `kind` (the H100 SXM's for any other)."""
    return PEAKS.get(kind, DEFAULT_PEAK)


def encoder_flops(m: dict) -> float:
    """One window through the conv stem and the encoder (`max_source_positions`
    positions: 1500 for a 30 s window, from 3000 mel frames)."""
    d, f, t, mels = m["d_model"], m["encoder_ffn_dim"], m["max_source_positions"], m["num_mel_bins"]
    stem = 2 * mels * 3 * d * 2 * t + 2 * d * 3 * d * t
    layer = 2 * t * d * d * 4 + 2 * t * d * f * 2 + 2 * 2 * t * t * d
    return float(stem + m["encoder_layers"] * layer)


def cross_kv_flops(m: dict) -> float:
    """The K and V projections of every decoder layer over one window."""
    d = m["d_model"]
    return float(m["decoder_layers"] * 2 * 2 * m["max_source_positions"] * d * d)


def decoder_position_flops(m: dict, ctx: int, logits: bool) -> float:
    """One decoder position that attends to `ctx` positions (itself
    included), with or without the logits over the vocabulary."""
    d, f = m["d_model"], m["decoder_ffn_dim"]
    linears = 2 * d * d * 6 + 2 * d * f * 2         # qkv, o, cross q, cross o; fc1, fc2
    attn = 2 * 2 * d * ctx + 2 * 2 * d * m["max_source_positions"]
    out = 2 * d * m["vocab_size"] if logits else 0
    return float(m["decoder_layers"] * (linears + attn) + out)


def request_flops(m: dict, prefix: int, new_tokens: int) -> float:
    """Model operations of one request: its window through the encoder,
    its cross-KV, the prefill of the prefix's first `prefix - 1` tokens and
    `new_tokens` decode steps."""
    total = encoder_flops(m) + cross_kv_flops(m)
    for pos in range(prefix - 1):
        total += decoder_position_flops(m, pos + 1, logits=False)
    for pos in range(prefix - 1, prefix - 1 + new_tokens):
        total += decoder_position_flops(m, pos + 1, logits=True)
    return total


def decoder_weight_bytes(m: dict, weight_bytes: float) -> float:
    """The decoder's linear weights a step reads (q, k, v, o, cross q, cross
    o, fc1, fc2 with one f32 scale an output channel) and the bf16 tied
    embedding."""
    d, f = m["d_model"], m["decoder_ffn_dim"]
    per_layer = (6 * d * d + 2 * d * f) * weight_bytes + 4 * (6 * d + f + d)
    return float(m["decoder_layers"] * per_layer + 2 * m["vocab_size"] * d)


def kv_bytes(m: dict, rows: int, positions: int, kv_bytes_el: float) -> float:
    """K and V of `positions` positions of every decoder layer for `rows`
    rows, with an f32 scale per (row, head, position) below 2 bytes an
    element."""
    d, h = m["d_model"], m["decoder_attention_heads"]
    scales = 2 * 4 * h * positions if kv_bytes_el < 2 else 0
    return float(m["decoder_layers"] * rows * (2 * positions * d * kv_bytes_el + scales))


def decode_least_seconds(m: dict, rows: int, prefix: int, new_tokens: int,
                         weight_bytes: float, kv_bytes_el: float,
                         ckv_bytes_el: float, peak: dict) -> float:
    """The least time of `models.decode.greedy_decode` over `rows` rows: its
    cross-KV projections, its prefill and each decode step, each the larger
    of its operations over the bf16 peak and its bytes over the memory
    bandwidth."""
    fl, bw = peak["bf16_flops"], peak["hbm_bytes_s"]
    d, s = m["d_model"], m["max_source_positions"]
    ckv_ops = rows * cross_kv_flops(m)
    ckv_io = (rows * s * d * 2
              + m["decoder_layers"] * 2 * d * d * weight_bytes
              + kv_bytes(m, rows, s, ckv_bytes_el))
    total = max(ckv_ops / fl, ckv_io / bw)
    pre_ops = rows * sum(decoder_position_flops(m, p + 1, False) for p in range(prefix - 1))
    pre_io = decoder_weight_bytes(m, weight_bytes) + kv_bytes(
        m, rows, prefix - 1, kv_bytes_el)
    total += max(pre_ops / fl, pre_io / bw)
    for pos in range(prefix - 1, prefix - 1 + new_tokens):
        ops = rows * decoder_position_flops(m, pos + 1, logits=True)
        io = (decoder_weight_bytes(m, weight_bytes)
              + kv_bytes(m, rows, s, ckv_bytes_el)
              + kv_bytes(m, rows, pos + 1, kv_bytes_el)
              + rows * m["vocab_size"] * 2)
        total += max(ops / fl, io / bw)
    return total
