"""Non-causal encoder attention with the scores kept on chip
(`csrc/encoder_attention.cu`) and its plain version: the port of the JAX
package's `ops/attention.py::encoder_attention_pallas`.

The contract of both versions (the TPU kernel's `_attn_kernel`): q comes in
unscaled and is multiplied by Dh**-0.5 in its own dtype; scores and softmax
in f32 over the whole row; the UNNORMALISED exp(s - m) is rounded to v's
dtype before the value product, which accumulates in f32 and is divided by
the f32 row sum l afterwards; the output is in q's dtype. (The einsum path
of `models.whisper.attention` normalises before it rounds the
probabilities: the same function up to that rounding.)
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels

HEAD_DIM = 64   # every Whisper size; the kernel is written for it


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b over (..., M, K) x (..., K, N) with an f32 result:
    products of the inputs summed in f32 and never rounded to bf16, as a JAX
    einsum with `preferred_element_type=f32`. On the card, bf16 inputs take
    cuBLAS's bf16 GEMM with an f32 output; elsewhere they are widened."""
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())


def encoder_attention_ref(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, H, T, Dh) -> (B, H, T, Dh) in q's dtype, the
    arithmetic of the module docstring. Materialises the (B, H, T, T) f32
    scores (overwritten in place by the probabilities)."""
    dh = q.shape[-1]
    p = matmul_f32(q * (dh ** -0.5), k.transpose(-1, -2))
    p.sub_(p.amax(dim=-1, keepdim=True)).exp_()
    l = p.sum(dim=-1, keepdim=True)
    return (matmul_f32(p.to(v.dtype), v) / l).to(q.dtype)


def encoder_attention(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Full (non-causal) attention, (B, H, T, Dh) -> (B, H, T, Dh); q
    unscaled. A CUDA tensor launches the kernel (bf16, Dh = 64; counted in
    `encoder_attention.launches`); a CPU tensor takes the plain version.

    The kernel reads q, k and v through their (batch, head, row) strides,
    so the (B, T, H, Dh) memory that `split_heads` leaves is not copied, and
    it writes the output in that same layout (returned as its (B, H, T, Dh)
    view), so that `merge_heads` of the result is a view too."""
    if not q.is_cuda:
        return encoder_attention_ref(q, k, v)
    name = "encoder_attention"
    kernels.require(q.dim() == 4 and q.shape == k.shape == v.shape, name,
                    f"q, k and v must share one (B, H, T, Dh) shape, got "
                    f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, t, dh = q.shape
    kernels.require(dh == HEAD_DIM, name, f"head dim must be {HEAD_DIM}, got {dh}")
    kernels.require(t >= 1 and 1 <= b * h <= 65535, name,
                    f"T {t} must be >= 1 and B*H {b * h} lie in 1..65535")
    kernels.require_bf16(name, q, k, v)
    kernels.require(len({x.device for x in (q, k, v)}) == 1, name,
                    "q, k and v must share a device")
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    for x in (q, k, v, out):
        # 16-byte rows for the k/v copies (the 4 bytes q and out need follow)
        kernels.require(x.stride(3) == 1 and x.data_ptr() % 16 == 0
                        and all(s % 8 == 0 for s in x.stride()[:3]), name,
                        "rows of 64 contiguous values at 16-byte aligned "
                        f"addresses needed, got strides {x.stride()}")
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, out)
                                         for s in x.stride()[:3]))
    err = kernels.lib().owc_encoder_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, t,
        dh ** -0.5, strides, kernels.stream_of(q))
    kernels.check(name, err)
    encoder_attention.launches += 1
    return out


encoder_attention.launches = 0
