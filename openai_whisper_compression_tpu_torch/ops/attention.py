"""Non-causal encoder attention with the scores kept on chip
(`csrc/encoder_attention.cu`, `encoder_attention.cuh`,
`encoder_attention_f16.cu`, `encoder_attention_f32.cu`,
`encoder_attention_f32_wg.cu`, `encoder_attention_wide.cu`,
`encoder_attention_f32_wide.cu`) and its plain
version: the port of the JAX package's
`ops/attention.py::encoder_attention_pallas`, in bf16, f16 and f32 at any
head dim.

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


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b over (..., M, K) x (..., K, N) with an f32 result:
    products of the inputs summed in f32 and never rounded to bf16, as a JAX
    einsum with `preferred_element_type=f32`. On the card, bf16 inputs take
    cuBLAS's bf16 GEMM with an f32 output; elsewhere they are widened, and
    so are inputs that need a gradient (that `bmm` overload has no
    derivative): bf16 products are exact in f32 either way."""
    if (a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16
            and not kernels.needs_grad(a, b)):
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
    unscaled (the kernel multiplies it by Dh**-0.5). A CUDA tensor launches
    a kernel: bf16 and f16 up to Dh 256 the tensor-core bodies (bf16's
    whole bodies at 16, 32, 64 and 128, f16's at 64, any other width the
    RAGGED body of its capacity), past 256 the WIDE tensor-core body; f32
    the 3xTF32 bodies (f32-accurate products on the tensor cores), past 256
    the f32 WIDE one. Each launch is counted by type, in
    `encoder_attention.launches` for bf16, `.launches_f32` and
    `.launches_f16`, and a launch past head dim 256 also in
    `.launches_wide_dh` and, in f32, `.launches_f32_wide_dh`. Any B*H. A CPU
    tensor takes the plain version.
    q, k and v share one type, as the JAX `encoder_attention_pallas` takes
    any float type (its scores f32, its output in q's type).

    The kernel reads q, k and v through their (batch, head, row) strides,
    so the (B, T, H, Dh) memory that `split_heads` leaves is not copied, and
    it writes the output in that same layout (returned as its (B, H, T, Dh)
    view), so that `merge_heads` of the result is a view too. The 16-bit
    bodies' tensor maps need rows of contiguous values at 16-byte aligned
    addresses: an input without them is copied to a contiguous buffer
    first, at a whole Dh one of Dh columns, at a RAGGED one a zero-padded
    buffer of the capacity's columns, past 256 one of Dh rounded up to 8
    (whose strides the tensor maps take), a padded copy counted in
    `encoder_attention.pad_copies`. The f32 bodies read any view whose head
    dim is contiguous."""
    if not q.is_cuda:
        return encoder_attention_ref(q, k, v)
    return _launch_encoder_attention(q, k, v)


# element type -> the launch counter after `launches`
_COUNTER = {torch.bfloat16: "", torch.float32: "_f32", torch.float16: "_f16"}


def _launch_encoder_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """The card path of `encoder_attention`: its checks, then the launch. The
    CPU tests call it directly, with a recording stand-in for the kernel
    library."""
    name = "encoder_attention"
    kernels.refuse_grad(name, q, k, v)
    kernels.require(q.dim() == 4 and q.shape == k.shape == v.shape, name,
                    f"q, k and v must share one (B, H, T, Dh) shape, got "
                    f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, t, dh = q.shape
    kernels.require_head_dim(name, dh)
    kernels.require(t >= 1 and b * h >= 1, name, f"T {t} and B*H {b * h} must be >= 1")
    code = kernels.dtype_code(q, name, k, v)
    kernels.require(len({x.device for x in (q, k, v)}) == 1, name,
                    "q, k and v must share a device")
    cap = kernels.head_dim_capacity(dh)
    if q.dtype == torch.float32:
        # the f32 bodies read rows of contiguous values where they are
        q, k, v = (x if x.stride(3) == 1 else x.contiguous() for x in (q, k, v))
    else:
        # 16-byte rows for the tensor maps of k and v (the 4 bytes q and out
        # need follow); a view without them is read through a copy
        q, k, v = (x if _rows_aligned(x) else _copy_rows(x, cap) for x in (q, k, v))
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, out)
                                         for s in x.stride()[:3]))
    err = kernels.lib().owc_encoder_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, t, dh, cap,
        dh ** -0.5, strides, code, kernels.stream_of(q))
    kernels.check(name, err)
    attr = "launches" + _COUNTER[q.dtype]
    setattr(encoder_attention, attr, getattr(encoder_attention, attr) + 1)
    if cap == kernels.WIDE:
        encoder_attention.launches_wide_dh += 1
        encoder_attention.launches_f32_wide_dh += q.dtype == torch.float32
    kernels.record_cost(encoder_attention_cost(b, h, t, dh, q.element_size()))
    return out


encoder_attention.launches = 0       # bf16
encoder_attention.launches_f32 = 0
encoder_attention.launches_f16 = 0
encoder_attention.launches_wide_dh = 0   # any type, head dims past 256
encoder_attention.launches_f32_wide_dh = 0   # f32 past 256 (the f32 WIDE body)
encoder_attention.pad_copies = 0   # zero-padded copies of unaligned views


def encoder_attention_cost(b: int, h: int, t: int, dh: int, itemsize: int) -> dict:
    """What the JAX `encoder_attention_pallas`'s `pl.CostEstimate` declares:
    T padded to a multiple of 128, as its kernel pads it."""
    bh, t_pad = b * h, -(-t // 128) * 128
    return kernels.cost(4 * bh * t_pad * t_pad * dh, 4 * bh * t_pad * dh * itemsize,
                        bh * t_pad * t_pad)


def _copy_rows(x: torch.Tensor, cap: int) -> torch.Tensor:
    """A copy of x the kernel reads in place: contiguous at a whole head dim
    (and past 256 at a multiple of 8); otherwise a view of its dh columns in
    a zero-padded (B, H, T, width) buffer, width the capacity or, past 256,
    dh rounded up to 8, whose strides are multiples of 8 elements where dh's
    need not be (counted in `encoder_attention.pad_copies`)."""
    dh = x.shape[-1]
    width = -(-dh // 8) * 8 if cap == kernels.WIDE else cap
    if dh == width:
        return kernels.aligned(x)
    encoder_attention.pad_copies += 1
    buf = torch.zeros((*x.shape[:3], width), dtype=x.dtype, device=x.device)
    buf[..., :dh] = x
    return buf[..., :dh]


def _rows_aligned(x: torch.Tensor) -> bool:
    """Whether the kernel reads x in place: rows of contiguous values at
    16-byte aligned addresses, non-negative strides in multiples of 8
    elements (a contiguous copy of any view has them)."""
    return (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(s % 8 == 0 and s >= 0 for s in x.stride()[:3]))
