"""Weight quantizers: `dense (K, N) -> QTensor`.

Ported: per-output-channel symmetric int8 (`quantize_int8`), bit-identical
to the JAX package's `quant/core.py::quantize_int8` (both round half to
even). The other quantizers are later slices.
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


QUANTIZERS = {"int8": quantize_int8}
