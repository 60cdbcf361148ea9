"""Whisper encoder and the decode-side building blocks, in PyTorch.

Functions over the parameter tree of `models.params`, numerically the JAX
package's `models/whisper.py`: pre-LN blocks, q scaled by head_dim**-0.5,
k projection without bias, layer_norm eps 1e-5 in f32, exact-erf GELU in the
conv stem and decoder, tanh GELU in the encoder MLPs with `fast_gelu`,
sin|cos encoder positions, learned decoder positions, output projection
tied to the embedding. Every matmul with a weight goes through
`ops.linear.linear`.

Encoder attention on the card runs the fused kernel of `ops.attention` at
every size: the JAX package reaches `encoder_attention_pallas` only past
the byte threshold where XLA's own fusion gives way, while eager PyTorch
would materialise the (B, H, T, T) scores at every size. Not carried over:
the JAX encoder's batch chunking (`_encode_batch_chunks`), which works
around that same XLA cliff.

The full-sequence decoder (`decode_logits`, `forward`, `nll_loss`: scoring,
calibration and teacher-forced loss) reads the standard-layout cross-KV of
`precompute_cross_kv`, (B, H, S, Dh), bf16/f32 or int8 with per-(batch,
head, position) scales, in plain torch, as the JAX package leaves it to
XLA; `cross_attention` and `grouped_cross_attention` dispatch on the type
of the cross-KV entry (a `CrossKV` takes the kernels). The activation taps
of `utils.capture` sit where the JAX package's do (the MLP's post-GELU
activations; the layer norms' outputs of every encoder and decoder layer,
in its order), for SmoothQuant/AWQ calibration and activation statistics.

No kernel has a backward: every wrapper refuses an input that needs a
gradient (`ops.kernels.refuse_grad`), and `attention` sends such a call to
its plain branch, as the JAX package's `jax.grad` always runs through XLA's
einsum (its Pallas attention has no VJP).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ..config import WhisperArch
from ..ops.attention import encoder_attention, matmul_f32
from ..ops.kernels import needs_grad
from ..ops.cross_attention import (UNGROUPED_MODULUS, decode_cross_attention,
                                   decode_cross_attention_grouped,
                                   transpose_kv, transpose_quant_kv, unpack4)
from ..ops.linear import linear
from ..ops.qtensor import QTensor, dequantize, quantize_absmax
from ..utils import capture
from .fuse import qkv_split

Params = dict[str, Any]

NEG_INF = -1e9  # finite additive mask value, as in the JAX package


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    b = p.get("b")
    y = F.layer_norm(x.float(), (x.shape[-1],), p["g"].float(),
                     None if b is None else b.float(), eps)
    return y.to(x.dtype)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


def _out_width(w) -> int:
    return w.data.shape[1] if isinstance(w, QTensor) else w.shape[-1]


def _num_heads(attn_p: Params, head_dim: int) -> int:
    if "qkv" in attn_p:
        return _out_width(attn_p["qkv"]["w"]) // 3 // head_dim
    return _out_width(attn_p["q"]["w"]) // head_dim


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, H*Dh) -> (B, H, T, Dh)"""
    b, t, _ = x.shape
    return x.reshape(b, t, n_heads, -1).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, Dh) -> (B, T, H*Dh)"""
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def qkv_project(p: Params, x: torch.Tensor, n_heads: int):
    """q/k/v projections -> (B, H, T, Dh) triple (fused qkv when present)."""
    if "qkv" in p:
        q, k, v = qkv_split(linear(x, p["qkv"]["w"], p["qkv"].get("b")))
    else:
        q = linear(x, p["q"]["w"], p["q"].get("b"))
        k = linear(x, p["k"]["w"])
        v = linear(x, p["v"]["w"], p["v"].get("b"))
    return split_heads(q, n_heads), split_heads(k, n_heads), split_heads(v, n_heads)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Scaled dot-product attention over (B, H, T, Dh), as the JAX
    package's. On the card, an unmasked bf16 call with Tq = Tk >= 256 (the
    encoder's) goes to the fused `encoder_attention` kernel unless it needs
    a gradient: the kernel has no backward, and the JAX package's gradient
    too runs through its einsum path, never its Pallas kernel. Everything
    else (a call that needs a gradient, the masked prefill window, f32,
    short contexts, the CPU) is plain torch: f32 scores (plus an optional
    additive f32 mask), f32 softmax, probabilities in q's dtype, matmul."""
    dh = q.shape[-1]
    if (mask is None and q.is_cuda and q.dtype == torch.bfloat16
            and q.shape[2] == k.shape[2] >= 256 and not needs_grad(q, k, v)):
        return encoder_attention(q, k, v)
    scores = matmul_f32(q * (dh ** -0.5), k.transpose(-1, -2))
    if mask is not None:
        scores += mask
    probs = torch.softmax(scores, dim=-1)
    del scores  # at most two (B, H, Tq, Tk) f32 tensors live at once
    return torch.matmul(probs.to(q.dtype), v)


def _mask_heads(o: torch.Tensor, head_mask: torch.Tensor | None) -> torch.Tensor:
    """o (B, H, T, Dh) times an (H,) head mask (head-importance analyses)."""
    if head_mask is None:
        return o
    return o * head_mask[None, :, None, None].to(o.dtype)


def self_attention(p: Params, x: torch.Tensor, head_dim: int,
                   mask: torch.Tensor | None = None,
                   head_mask: torch.Tensor | None = None) -> torch.Tensor:
    q, k, v = qkv_project(p, x, _num_heads(p, head_dim))
    o = _mask_heads(attention(q, k, v, mask), head_mask)
    return linear(merge_heads(o), p["o"]["w"], p["o"].get("b"))


def mlp(p: Params, x: torch.Tensor, fast_gelu: bool = False) -> torch.Tensor:
    h = gelu(linear(x, p["fc1"]["w"], p["fc1"].get("b")), approximate=fast_gelu)
    if capture.active():  # activation statistics (sensitivity/activation.py)
        capture.record("ffn_act", h)
    return linear(h, p["fc2"]["w"], p["fc2"].get("b"))


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            stride: int) -> torch.Tensor:
    """x: (B, C_in, T); w: (C_out, C_in, width); padding 1."""
    y = F.conv1d(x, w.to(x.dtype), stride=stride, padding=1)
    return y + b.to(y.dtype)[None, :, None]


def encoder_layer(p: Params, x: torch.Tensor, head_dim: int,
                  head_mask: torch.Tensor | None = None,
                  fast_gelu: bool = False) -> torch.Tensor:
    ln_a = layer_norm(x, p["attn_ln"])
    x = x + self_attention(p["attn"], ln_a, head_dim, head_mask=head_mask)
    ln_m = layer_norm(x, p["mlp_ln"])
    if capture.active():  # SmoothQuant/AWQ calibration (quant/smooth.py)
        capture.record("attn_ln_out", ln_a)
        capture.record("mlp_ln_out", ln_m)
    return x + mlp(p, ln_m, fast_gelu=fast_gelu)


def encode(params: Params, arch: WhisperArch, mel: torch.Tensor,
           head_masks: torch.Tensor | None = None,
           merge_at: int | None = None, merge_factor: int = 2,
           fast_gelu: bool = False) -> torch.Tensor:
    """mel (B, n_mels, 2·T) -> encoder states (B, T, d_model).

    head_masks: optional (L, H) per-layer attention-head mask.
    merge_at / merge_factor: adjacent-token merging, the mean of each group
    of `merge_factor` frames (a ragged tail dropped) before layer
    `merge_at`, which shrinks the remaining layers and every cross-attention
    by that factor (T = 750 or 500 at whisper's 1500).
    fast_gelu: tanh-approximate GELU in the encoder MLPs (the conv stem
    keeps exact erf)."""
    enc = params["encoder"]
    x = gelu(_conv1d(mel, enc["conv1"]["w"], enc["conv1"]["b"], stride=1))
    x = gelu(_conv1d(x, enc["conv2"]["w"], enc["conv2"]["b"], stride=2))
    x = x.transpose(1, 2)
    x = x + enc["pos"][: x.shape[1]].to(x.dtype)
    for i, layer in enumerate(enc["layers"]):
        if merge_at is not None and i == merge_at:
            b, t, d = x.shape
            t2 = t - t % merge_factor
            x = x[:, :t2].reshape(b, t2 // merge_factor, merge_factor, d).mean(2)
        hm = None if head_masks is None else head_masks[i]
        x = encoder_layer(layer, x, arch.head_dim, head_mask=hm,
                          fast_gelu=fast_gelu)
    return layer_norm(x, enc["ln"])


# ---------------------------------------------------------------------------
# Decode-side cross-attention over transposed K/V
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CrossKV:
    """Per-layer cross-attention K/V in the kernel layout (B·H, Dh, S_pad),
    S padded to a multiple of 128; positions >= s_valid are padding. bf16
    (or the encoder's dtype) without scales; int8, or split-half packed
    int4 with Dh/2 rows, with per-(bh, position) absmax scales
    (B·H, 1, S_pad) f32."""

    k_t: torch.Tensor
    v_t: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None
    s_valid: int = 0  # 0 means all S_pad positions are valid

    @property
    def valid_len(self) -> int:
        return self.s_valid if self.s_valid > 0 else self.k_t.shape[2]


def _quant_kv4_t(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int4-quantize transposed K/V, split-half packed along Dh: byte row d
    holds element d (low nibble) and d + Dh/2 (high nibble), per-(bh,
    position) absmax/7 scales (B·H, 1, S)."""
    q, scale = quantize_absmax(x, dim=1, qmax=7)
    q = q.to(torch.int32)
    dh = x.shape[1]
    packed = (q[:, : dh // 2] & 0xF) | ((q[:, dh // 2:] & 0xF) << 4)
    return torch.where(packed > 127, packed - 256, packed).to(torch.int8), scale


def unpack_kv4_t(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of _quant_kv4_t's packing (without scales): (B·H, Dh/2, S)
    int8 -> (B·H, Dh, S) f32 in [-7, 7], the unpack the kernels' plain
    version uses."""
    return unpack4(packed)


def precompute_cross_kv_t(params: Params, arch: WhisperArch,
                          enc_out: torch.Tensor, bits: int = 16) -> list[CrossKV]:
    """Per-layer transposed cross K/V from the encoder states. bits: 16
    (the encoder's dtype), 8 (int8 through `transpose_quant_kv`: the kernel
    on the card) or 4 (split-half packed int4, quantized in plain torch, as
    the JAX package does outside any Pallas kernel)."""
    if bits not in (16, 8, 4):
        raise ValueError(f"cross-KV bits must be 16, 8 or 4, got {bits}")
    s = enc_out.shape[1]
    kvs = []
    for layer in params["decoder"]["layers"]:
        p = layer["cross"]
        h = _num_heads(p, arch.head_dim)
        k = linear(enc_out, p["k"]["w"])
        v = linear(enc_out, p["v"]["w"], p["v"].get("b"))
        if bits == 8:
            (k_t, ks), (v_t, vs) = (transpose_quant_kv(t.contiguous(), h)
                                    for t in (k, v))
        elif bits == 4:
            (k_t, ks), (v_t, vs) = (_quant_kv4_t(transpose_kv(t, h))
                                    for t in (k, v))
        else:
            k_t, v_t = (transpose_kv(t, h).to(enc_out.dtype) for t in (k, v))
            ks = vs = None
        kvs.append(CrossKV(k_t, v_t, ks, vs, s_valid=s))
    return kvs


def _cross_t(p: Params, x: torch.Tensor, kv: CrossKV, head_dim: int,
             rows: int, slots: int, step: bool = False) -> torch.Tensor:
    """Cross-attention of x, `rows * slots` query vectors in (row, slot)
    order along its first two axes, over the transposed K/V of `rows` batch
    entries: the `slots` queries of a (row, head) pair share its K/V entry
    and ride the grouped kernel's query slots. step: a decode step without
    beams (one slot), which takes the one-query function where B·H is no
    multiple of 16, the JAX package's rule (`cross_t_apply`); few rows then,
    and that kernel spreads each over several blocks. Returns x's shape."""
    h = _num_heads(p, head_dim)
    q = linear(x, p["q"]["w"], p["q"].get("b"))             # (.., H*Dh)
    qg = (q.reshape(rows, slots, h, head_dim).transpose(1, 2)
          .reshape(rows * h, slots, head_dim) * (head_dim ** -0.5)).to(q.dtype)
    if step and kv.k_t.shape[0] % UNGROUPED_MODULUS != 0:
        o = decode_cross_attention(qg[:, 0, :].contiguous(), kv.k_t, kv.v_t,
                                   kv.k_scale, kv.v_scale, kv.valid_len)
    else:
        o = decode_cross_attention_grouped(qg.contiguous(), kv.k_t, kv.v_t,
                                           kv.k_scale, kv.v_scale, kv.valid_len)
    o = o.reshape(rows, h, slots, head_dim).transpose(1, 2).reshape(
        *x.shape[:-1], h * head_dim)
    return linear(o.to(x.dtype), p["o"]["w"], p["o"].get("b"))


def cross_attention(p: Params, x: torch.Tensor, kv, head_dim: int,
                    head_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-attention of x (B, L, d) over one layer's cross-KV, by its type
    as in the JAX package: a `CrossKV` (the decode step, L = 1) takes the
    grouped kernel at one slot, or the one-query kernel where B·H % 16 != 0;
    a standard-layout entry of `precompute_cross_kv` takes `attention` over
    `read_cross_kv`, at any L, with an optional (H,) head mask."""
    if isinstance(kv, CrossKV):
        if head_mask is not None:
            raise ValueError("head_mask is not supported on the transposed-"
                             "KV path; use standard-layout cross-KV "
                             "(precompute_cross_kv / cross_pallas=False)")
        if x.shape[1] != 1:
            raise ValueError("cross_attention over a CrossKV takes one decode "
                             f"position (B, 1, d); got {tuple(x.shape)}: a "
                             "window goes to cross_window_attention")
        return _cross_t(p, x, kv, head_dim, x.shape[0], 1, step=True)
    q = split_heads(linear(x, p["q"]["w"], p["q"].get("b")), _num_heads(p, head_dim))
    k, v = read_cross_kv(kv, q.dtype)                 # (B, H, S, Dh)
    o = _mask_heads(attention(q, k, v), head_mask)
    return linear(merge_heads(o), p["o"]["w"], p["o"].get("b"))


def cross_window_attention(p: Params, x: torch.Tensor, kv: CrossKV,
                           head_dim: int) -> torch.Tensor:
    """Cross-attention of the (B, P, d) prompt and prefix window in prefill
    (the JAX package's `decode._cross_window_t`): the P positions of a batch
    row are the grouped kernel's slots, at every B·H."""
    return _cross_t(p, x, kv, head_dim, x.shape[0], x.shape[1])


def grouped_cross_attention(p: Params, x: torch.Tensor, kv, head_dim: int,
                            beam: int) -> torch.Tensor:
    """Beam-search decode step: x is (B*beam, 1, d), `beam` consecutive rows
    sharing one K/V entry of kv, which stays at batch B, so a step reads the
    encoder K/V once per utterance, not once per beam. A `CrossKV` takes the
    grouped kernel with the beams as its slots (the JAX package's
    `_grouped_cross_attention_t`); a standard-layout entry, `attention` of
    the (B, H, beam, Dh) queries over `read_cross_kv`."""
    if isinstance(kv, CrossKV):
        return _cross_t(p, x, kv, head_dim, x.shape[0] // beam, beam)
    h = _num_heads(p, head_dim)
    q = linear(x, p["q"]["w"], p["q"].get("b"))                  # (B*K, 1, H*Dh)
    b = x.shape[0] // beam
    qg = q.reshape(b, beam, h, head_dim).transpose(1, 2)        # (B, H, K, Dh)
    k, v = read_cross_kv(kv, q.dtype)                            # (B, H, S, Dh)
    o = attention(qg, k, v).transpose(1, 2).reshape(x.shape[0], 1, h * head_dim)
    return linear(o, p["o"]["w"], p["o"].get("b"))


# ---------------------------------------------------------------------------
# Decoder, full sequence: scoring, calibration, teacher-forced loss
# ---------------------------------------------------------------------------

def _quant_kv8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes of (B, H, S, Dh) with per-(batch, head, position) absmax
    scales (B, H, S, 1) f32, bit-equal to the jitted JAX `_quant_kv8` (a
    multiply by f32(1/127), `ops.qtensor.absmax_scale`)."""
    return quantize_absmax(x, dim=-1, qmax=127)


def precompute_cross_kv(params: Params, arch: WhisperArch,
                        enc_out: torch.Tensor, int8: bool = False) -> list[tuple]:
    """Per-layer cross-attention K/V from the encoder states, in the
    standard (B, H, S, Dh) layout: (k, v) in the encoder's dtype, or with
    int8=True ((k codes, k scales), (v codes, v scales)). The full-sequence
    decoder and the unfused decode step (`cross_pallas=False`) read it
    through `read_cross_kv`; the fused step takes `precompute_cross_kv_t`."""
    kvs = []
    for layer in params["decoder"]["layers"]:
        p = layer["cross"]
        h = _num_heads(p, arch.head_dim)
        k = split_heads(linear(enc_out, p["k"]["w"]), h)
        v = split_heads(linear(enc_out, p["v"]["w"], p["v"].get("b")), h)
        kvs.append((_quant_kv8(k), _quant_kv8(v)) if int8 else (k, v))
    return kvs


def read_cross_kv(kv: tuple, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(k, v) of a `precompute_cross_kv` entry in `dtype`, dequantized (code
    x scale in f32, then rounded) if it is int8."""
    k, v = kv
    if isinstance(k, tuple):
        return tuple((c.float() * s).to(dtype) for c, s in (k, v))
    return k.to(dtype), v.to(dtype)


def decoder_layer(p: Params, x: torch.Tensor, cross_kv, head_dim: int,
                  self_mask: torch.Tensor | None,
                  head_mask: torch.Tensor | None = None,
                  cross_head_mask: torch.Tensor | None = None) -> torch.Tensor:
    ln_a = layer_norm(x, p["attn_ln"])
    if capture.active():  # SmoothQuant/AWQ calibration (quant/smooth.py)
        capture.record("attn_ln_out", ln_a)
    x = x + self_attention(p["attn"], ln_a, head_dim, mask=self_mask,
                           head_mask=head_mask)
    ln_c = layer_norm(x, p["cross_ln"])
    if capture.active():
        capture.record("cross_ln_out", ln_c)
    x = x + cross_attention(p["cross"], ln_c, cross_kv, head_dim,
                            head_mask=cross_head_mask)
    ln_m = layer_norm(x, p["mlp_ln"])
    if capture.active():
        capture.record("mlp_ln_out", ln_m)
    return x + mlp(p, ln_m)


def decode_logits(params: Params, arch: WhisperArch, tokens: torch.Tensor,
                  enc_out: torch.Tensor,
                  self_head_masks: torch.Tensor | None = None,
                  cross_head_masks: torch.Tensor | None = None) -> torch.Tensor:
    """Teacher-forced decoder: tokens (B, L) -> logits (B, L, vocab), causal
    self-attention, standard-layout cross-KV; optional (layers, H) head
    masks."""
    dec = params["decoder"]
    l = tokens.shape[1]
    x = embed_tokens(dec, tokens)
    x = x + dec["pos"][:l].to(x.dtype)
    causal = torch.triu(torch.full((l, l), NEG_INF, dtype=torch.float32,
                                   device=x.device), diagonal=1)[None, None]
    cross_kvs = precompute_cross_kv(params, arch, enc_out)
    for i, layer in enumerate(dec["layers"]):
        hm = None if self_head_masks is None else self_head_masks[i]
        chm = None if cross_head_masks is None else cross_head_masks[i]
        x = decoder_layer(layer, x, cross_kvs[i], arch.head_dim, causal,
                          head_mask=hm, cross_head_mask=chm)
    return project_out(dec, layer_norm(x, dec["ln"]))


def embed_tokens(dec: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Token-embedding lookup; a quantized (`include_embed`) table is
    dequantized to f32 first, as the JAX package's."""
    embed = dec["embed"]
    if isinstance(embed, QTensor):
        embed = dequantize(embed, torch.float32)
    return embed[tokens]


def project_out(dec: Params, x: torch.Tensor) -> torch.Tensor:
    """Output projection tied to the token embedding; a quantized table is
    dequantized to x's dtype (embedding quantization saves storage, not
    matmul time)."""
    embed = dec["embed"]
    if isinstance(embed, QTensor):
        embed = dequantize(embed, x.dtype)
    return linear(x, embed.t())


def forward(params: Params, arch: WhisperArch, mel: torch.Tensor,
            tokens: torch.Tensor,
            enc_head_masks: torch.Tensor | None = None,
            dec_head_masks: torch.Tensor | None = None,
            cross_head_masks: torch.Tensor | None = None) -> torch.Tensor:
    """Encoder and teacher-forced decoder: mel (B, n_mels, 2·T), tokens
    (B, L) -> logits (B, L, vocab). Optional (layers, H) head masks."""
    enc = encode(params, arch, mel, head_masks=enc_head_masks)
    return decode_logits(params, arch, tokens, enc,
                         self_head_masks=dec_head_masks,
                         cross_head_masks=cross_head_masks)


def nll_loss(params: Params, arch: WhisperArch, mel: torch.Tensor,
             tokens: torch.Tensor, labels: torch.Tensor,
             label_mask: torch.Tensor | None = None,
             enc_head_masks: torch.Tensor | None = None,
             dec_head_masks: torch.Tensor | None = None,
             cross_head_masks: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy of `labels` (B, L) under `forward`'s logits (in
    f32), over the positions `label_mask` (B, L) weights when given."""
    logits = forward(params, arch, mel, tokens, enc_head_masks,
                     dec_head_masks, cross_head_masks).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    if label_mask is not None:
        m = label_mask.to(nll.dtype)
        return (nll * m).sum() / m.sum().clamp_min(1.0)
    return nll.mean()
