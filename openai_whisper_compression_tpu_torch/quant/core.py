"""Weight quantizers: `dense (K, N) -> QTensor`.

Ported: per-output-channel symmetric int8 (`quantize_int8`), bit-identical
to the JAX package's `quant/core.py::quantize_int8` (both round half to
even), and the per-position absmax quantizer of the int8 self-KV cache and
the int8/int4 cross-KV (`quantize_absmax`). The other quantizers are later
slices.
"""

from __future__ import annotations

import torch

from ..ops.qtensor import QTensor


def quantize_int8(w: torch.Tensor) -> QTensor:
    """Per-output-channel symmetric int8: scale = max(absmax / 127, 1e-12)
    over the input axis, data = clip(round(w / scale), -127, 127).

    XLA compiles the division by the constant 127 into a multiply by its f32
    reciprocal, so the port multiplies too: the scales then match the JAX
    package bit for bit (a true division differs in the last bit for ~1% of
    columns)."""
    w = w.to(torch.float32)
    absmax = w.abs().amax(dim=0, keepdim=True)             # (1, N)
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=w.device)
    scale = torch.clamp(absmax * inv127, min=1e-12)
    data = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QTensor(data=data, scale=scale, kind="int8_pc",
                   shape=tuple(w.shape))


def quantize_absmax(x: torch.Tensor, dim: int,
                    qmax: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax quantization along `dim` (the KV caches' scheme):
    scale = max(absmax, 1e-12) * f32(1 / qmax), q = clip(round(x / scale),
    -qmax, qmax). Returns (q int8, scale f32 with `dim` kept as size 1).

    Under jit the JAX package's `max(absmax, 1e-12) / qmax` compiles to a
    multiply by the f32 reciprocal, so this multiplies too (a true division
    differs in the last bit for a few percent of scales); the quotient
    `x / scale` stays a true division, as it does under jit."""
    xf = x.to(torch.float32)
    # a 0-dim CPU tensor multiplies a CUDA tensor as an f32 scalar, with no
    # host-to-device copy (which would wait for the stream)
    inv = torch.tensor(1.0 / qmax, dtype=torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=dim, keepdim=True), min=1e-12) * inv
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax).to(torch.int8)
    return q, scale


QUANTIZERS = {"int8": quantize_int8}
