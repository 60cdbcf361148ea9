"""QTensor: a quantized 2-D weight leaf of the parameter tree.

The port carries the `int8_pc` kind of the JAX package's `ops/qtensor.py`:
per-output-channel symmetric int8, data (K, N) int8 and scale (1, N) f32,
logical shape (in_dim, out_dim). Other kinds are later slices.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class QTensor:
    data: torch.Tensor
    scale: torch.Tensor
    kind: str = "int8_pc"
    shape: tuple = ()

    def __post_init__(self):
        if self.kind != "int8_pc":
            raise NotImplementedError(
                f"QTensor kind {self.kind!r}: the port carries int8_pc only")

    def to(self, device) -> "QTensor":
        return dataclasses.replace(self, data=self.data.to(device),
                                   scale=self.scale.to(device))


def dequantize(q: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Dense (K, N) weight: data * scale in `dtype` (the JAX reference
    dequantization)."""
    return q.data.to(dtype) * q.scale.to(dtype)
