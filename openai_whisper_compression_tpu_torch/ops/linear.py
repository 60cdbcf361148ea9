"""Dense / quantized linear contraction: the single matmul entry point.

Dispatch follows the JAX package's `ops/linear.py`: an int8_pc weight goes
through the fused int8 kernel when the activations live on the card and
have at most `KERNEL_M_THRESHOLD` rows (the decode-step and prefill
linears); otherwise (the CPU, or encoder-scale M) the weight is dequantized
to x's dtype and multiplied with `torch.matmul`.
"""

from __future__ import annotations

import math

import torch

from .qtensor import QTensor, dequantize
from .quant_matmul import int8_matmul

# The JAX package's default crossover (ops/linear.py PALLAS_M_DEFAULT). It
# was measured on a TPU; the H100 crossover is still to be measured.
KERNEL_M_THRESHOLD = 1024


def linear(x: torch.Tensor, w, b: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ w + b. x: (..., K); w: (K, N) tensor or QTensor."""
    if isinstance(w, QTensor):
        y = _quantized_matmul(x, w)
    else:
        y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _quantized_matmul(x: torch.Tensor, q: QTensor) -> torch.Tensor:
    m = math.prod(x.shape[:-1])
    if x.is_cuda and m <= KERNEL_M_THRESHOLD:
        lead = x.shape[:-1]
        y = int8_matmul(x.reshape(m, x.shape[-1]).contiguous(), q.data, q.scale)
        return y.reshape(*lead, -1)
    return torch.matmul(x, dequantize(q, x.dtype))
