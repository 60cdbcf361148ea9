"""Grouped decode cross-attention over transposed K/V (`csrc/cross_attention.cu`)
and its plain version: the port of the JAX package's
`ops/cross_attention.py::decode_cross_attention_grouped` for bf16 K/V.

K query slots per (batch, head) row share one K/V entry: K = 1 in a decode
step, K = prefix length - 1 (at most 3) in prefill; beam widths wait for the
beam-search slice. The kernel takes any B·H, so the JAX package's ungrouped
fallback for B·H % 16 != 0 has no counterpart here.
"""

from __future__ import annotations

import torch

from . import kernels

NEG_INF = -1e30
HEAD_DIM = 64   # every Whisper size; the kernel is written for it
MAX_SLOTS = 4   # query slots per (batch, head) row the kernel holds


def decode_cross_attention_grouped_ref(q: torch.Tensor, k_t: torch.Tensor,
                                       v_t: torch.Tensor,
                                       s_valid: int | None = None
                                       ) -> torch.Tensor:
    """Plain version (the math of `_cross_t_ref` per query slot): f32
    scores, positions >= s_valid masked, f32 softmax, f32 value sum,
    output in q's dtype."""
    s_pad = k_t.shape[2]
    s_valid = s_pad if s_valid is None else s_valid
    scores = torch.einsum("gkd,gds->gks", q.float(), k_t.float())
    mask = torch.arange(s_pad, device=q.device) < s_valid
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("gks,gds->gkd", probs, v_t.float()).to(q.dtype)


def decode_cross_attention_grouped(q: torch.Tensor, k_t: torch.Tensor,
                                   v_t: torch.Tensor,
                                   s_valid: int | None = None) -> torch.Tensor:
    """q (BH, K, Dh) pre-scaled by Dh**-0.5; k_t/v_t (BH, Dh, S_pad), with
    positions >= s_valid treated as padding (zero probability). Returns
    (BH, K, Dh) in q's dtype. A CUDA tensor launches the kernel (bf16 only;
    counted in `decode_cross_attention_grouped.launches`); a CPU tensor
    takes the plain version."""
    if not q.is_cuda:
        return decode_cross_attention_grouped_ref(q, k_t, v_t, s_valid)
    name = "decode_cross_attention_grouped"
    bh, kq, dh = q.shape
    s_pad = k_t.shape[2]
    s_valid = s_pad if s_valid is None else s_valid
    kernels.require(dh == HEAD_DIM, name, f"head dim must be {HEAD_DIM}, got {dh}")
    kernels.require(1 <= kq <= MAX_SLOTS, name,
                    f"1..{MAX_SLOTS} query slots per row, got {kq}")
    kernels.require(k_t.shape == (bh, dh, s_pad) and v_t.shape == k_t.shape,
                    name, f"k_t/v_t must be ({bh}, {dh}, S_pad), got "
                    f"{tuple(k_t.shape)} and {tuple(v_t.shape)}")
    kernels.require(1 <= s_valid <= s_pad and s_pad % 8 == 0, name,
                    f"s_valid {s_valid} outside 1..{s_pad}, or S_pad not a "
                    "multiple of 8")
    kernels.require_bf16(name, q, k_t, v_t)
    kernels.require(k_t.device == q.device == v_t.device, name,
                    "q, k_t and v_t must share a device")
    kernels.require(q.is_contiguous() and k_t.is_contiguous()
                    and v_t.is_contiguous(), name, "inputs must be contiguous")
    kernels.require(k_t.data_ptr() % 16 == 0 and v_t.data_ptr() % 16 == 0,
                    name, "k_t/v_t must be 16-byte aligned")
    kernels.require((MAX_SLOTS * dh + kq * s_pad) * 4 <= 227 * 1024, name,
                    "scores do not fit in shared memory")
    out = torch.empty_like(q)
    err = kernels.lib().owc_cross_attention_grouped(
        q.data_ptr(), k_t.data_ptr(), v_t.data_ptr(), out.data_ptr(), bh, kq,
        s_pad, s_valid, kernels.stream_of(q))
    kernels.check(name, err)
    decode_cross_attention_grouped.launches += 1
    return out


decode_cross_attention_grouped.launches = 0


def pad_cross_len(s: int) -> int:
    """S padded to a multiple of 128 (the JAX layout's lane width)."""
    return -(-s // 128) * 128
