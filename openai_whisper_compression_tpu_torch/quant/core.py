"""Weight quantizers: `dense (K, N) -> QTensor`.

The weight-only quantizers of the JAX package's `quant/core.py`:
per-channel symmetric int8 / int4 / int2 (optimum-quanto's qint8/4/2),
blockwise NF4 / FP4 with optional double-quant (bitsandbytes' Linear4bit)
HQQ group-wise asymmetric int3 / int4 / int8, and float8_e4m3fn weights
with a per-channel scale.

Under `jax.jit` XLA compiles a division by a constant into a multiply by
the constant's f32 reciprocal, so the port multiplies wherever the JAX code
divides by a constant: codes and scales then match the jitted JAX package
bit for bit (a true division differs in the last bit for ~1% of values).
Divisions by a computed value stay true divisions, as under jit. Where the
two frameworks sum in another order (the means of double-quant and of the
HQQ solve), results agree to the last bits; `tests/test_torch_quant4.py`
states the bounds.
"""

from __future__ import annotations

import torch

from ..ops.qtensor import (CODEBOOKS, FP8_MAX, QTensor, inv_f32 as _inv,
                           pack_int_sub8)


def quantize_int8(w: torch.Tensor) -> QTensor:
    """Per-output-channel symmetric int8: scale = max(absmax / 127, 1e-12)
    over the input axis, data = clip(round(w / scale), -127, 127)."""
    w = w.to(torch.float32)
    absmax = w.abs().amax(dim=0, keepdim=True)             # (1, N)
    scale = torch.clamp(absmax * _inv(127.0), min=1e-12)
    data = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QTensor(data=data, scale=scale, kind="int8_pc", bits=8,
                   shape=tuple(w.shape))


def quantize_int_sub8(w: torch.Tensor, bits: int) -> QTensor:
    """Per-output-channel symmetric int4 / int2, split-half packed along K."""
    if bits not in (2, 4):
        raise ValueError(f"bits must be 2 or 4, got {bits}")
    w = w.to(torch.float32)
    qmax = 2 ** (bits - 1) - 1  # 7 or 1
    absmax = w.abs().amax(dim=0, keepdim=True)
    scale = torch.clamp(absmax * _inv(qmax), min=1e-12)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int32)
    return QTensor(data=pack_int_sub8(q, bits), scale=scale,
                   kind="int4_pack" if bits == 4 else "int2_pack",
                   bits=bits, shape=tuple(w.shape))


def quantize_nf4(w: torch.Tensor, block_size: int = 64,
                 double_quant: bool = False, kind: str = "nf4") -> QTensor:
    """Blockwise 4-bit codebook quantization (NF4 or FP4), bnb-style, in
    the JAX package's layout: blocks of `block_size` along K per output
    column, per-block absmax scale (K/G, N), nearest-code indices (the
    first on a tie, as both argmins take) split-half packed (K/2, N).
    Double-quant stores the scales as int8 per 256 consecutive scales of the
    row-major (K/G, N) array, with their mean as offset2 and max|centered| /
    127 as scale2, both expanded elementwise to (K/G, N)."""
    if kind not in CODEBOOKS:
        raise ValueError(f"kind must be nf4 or fp4, got {kind!r}")
    k, n = w.shape
    g = block_size
    if k % g:
        raise ValueError(f"K={k} not divisible by block {g}")
    wf = w.to(torch.float32).reshape(k // g, g, n)
    absmax = torch.clamp(wf.abs().amax(dim=1), min=1e-12)         # (K/G, N)
    code = torch.from_numpy(CODEBOOKS[kind]).to(w.device)
    idx = ((wf / absmax[:, None, :])[..., None] - code).abs().argmin(-1)
    data = pack_int_sub8(idx.reshape(k, n), 4)                   # (K/2, N)

    scale, scale2, offset2 = absmax, None, None
    if double_quant:
        dq = 256
        flat = absmax.reshape(-1)
        groups = torch.nn.functional.pad(flat, (0, (-flat.numel()) % dq)
                                         ).reshape(-1, dq)
        off = groups.mean(dim=1, keepdim=True)
        centered = groups - off
        s2 = torch.clamp(centered.abs().amax(dim=1, keepdim=True),
                         min=1e-12) * _inv(127.0)
        q = torch.clamp(torch.round(centered / s2), -127, 127).to(torch.int8)

        def expand(t):
            return t.expand(-1, dq).reshape(-1)[: flat.numel()].reshape(absmax.shape)

        scale = q.reshape(-1)[: flat.numel()].reshape(absmax.shape)
        scale2, offset2 = expand(s2), expand(off)
    return QTensor(data=data, scale=scale, scale2=scale2, offset2=offset2,
                   kind=kind, bits=4, shape=(k, n), block_size=g)


def quantize_hqq(w: torch.Tensor, bits: int = 4, group_size: int = 64,
                 iters: int = 20, lp_norm: float = 0.7, beta: float = 10.0,
                 kappa: float = 1.01) -> QTensor:
    """Half-Quadratic Quantization: group-wise asymmetric int (groups of
    `group_size` along K per column) with the zero point refined by `iters`
    alternating half-quadratic solves (an lp < 1 shrinkage of the residual),
    as the JAX package's `quantize_hqq`. Values pack split-half into
    nibbles for bits <= 4 and stay uint8 for bits 8."""
    k, n = w.shape
    if k % group_size:
        raise ValueError(f"K={k} not divisible by group={group_size}")
    wf = w.to(torch.float32).reshape(k // group_size, group_size, n)
    qmax = 2.0 ** bits - 1.0

    wmin = wf.amin(dim=1, keepdim=True)
    wmax = wf.amax(dim=1, keepdim=True)
    scale = torch.clamp((wmax - wmin) * _inv(qmax), min=1e-8)   # (G, 1, N)
    zero = -wmin / scale
    # beta is an f32 carry of the JAX scan, multiplied by kappa in f32; p /
    # beta is a true f32 division (`float / tensor` in torch would multiply
    # by the reciprocal)
    f32 = torch.float32
    p_t, beta_t, kappa_t = (torch.tensor(v, dtype=f32) for v in (lp_norm, beta, kappa))

    def shrink(x, beta):
        # generalized soft-threshold for |x|^p, p < 1 (HQQ's prox operator)
        return torch.sign(x) * torch.clamp(
            x.abs() - (p_t / beta) * torch.pow(
                torch.clamp(x.abs(), min=1e-8), lp_norm - 1.0), min=0.0)

    for _ in range(iters):
        q = torch.clamp(torch.round(wf / scale + zero), 0, qmax)
        e = shrink(wf - (q - zero) * scale, beta_t)
        zero = (q - (wf - e) / scale).mean(dim=1, keepdim=True)
        beta_t = beta_t * kappa_t
    q = torch.clamp(torch.round(wf / scale + zero), 0, qmax).reshape(k, n)
    data = (pack_int_sub8(q.to(torch.int32), 4) if bits <= 4
            else q.to(torch.uint8))
    return QTensor(data=data, scale=scale.reshape(k // group_size, n),
                   zero=zero.reshape(k // group_size, n), kind="group_asym",
                   bits=bits, shape=(k, n), block_size=group_size)


def quantize_fp8(w: torch.Tensor) -> QTensor:
    """float8_e4m3fn weights with a per-output-channel scale into the e4m3
    range: scale = max(absmax / 448, 1e-12), data = fp8(w / scale), rounded
    to nearest even (|w / scale| never exceeds 448 by more than an f32
    rounding, far below the 464 from which e4m3fn has no finite value)."""
    w = w.to(torch.float32)
    absmax = w.abs().amax(dim=0, keepdim=True)             # (1, N)
    scale = torch.clamp(absmax * _inv(FP8_MAX), min=1e-12)
    return QTensor(data=(w / scale).to(torch.float8_e4m3fn), scale=scale,
                   kind="fp8", bits=8, shape=tuple(w.shape))


QUANTIZERS = {
    "int8": quantize_int8,
    "int4": lambda w: quantize_int_sub8(w, 4),
    "int2": lambda w: quantize_int_sub8(w, 2),
    "nf4": lambda w, **kw: quantize_nf4(w, kind="nf4", **kw),
    "nf4_dq": lambda w, **kw: quantize_nf4(w, kind="nf4", double_quant=True, **kw),
    "fp4": lambda w, **kw: quantize_nf4(w, kind="fp4", **kw),
    "fp4_dq": lambda w, **kw: quantize_nf4(w, kind="fp4", double_quant=True, **kw),
    "hqq_int3": lambda w: quantize_hqq(w, bits=3),
    "hqq_int4": lambda w: quantize_hqq(w, bits=4),
    "hqq_int8": lambda w: quantize_hqq(w, bits=8, group_size=128),
    "fp8": quantize_fp8,
}
