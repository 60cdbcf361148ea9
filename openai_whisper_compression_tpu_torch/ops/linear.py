"""Dense / quantized linear contraction: the single matmul entry point.

Dispatch follows the JAX package's `ops/linear.py`: when the activations
live on the card and have at most `KERNEL_M_THRESHOLD` rows (the decode-step
and prefill linears), a weight of kind
- int8_pc goes through `int8_matmul`,
- int4_pack through `int4_matmul`,
- nf4 / fp4 through `nf4_matmul` (effective double-quant scale folded
  first) when `blockwise4_kernel_ok(K, G)`,
- group_asym through `group_asym_matmul` when `group_asym_kernel_ok`
  (packed (K/2, N) nibbles pass `blockwise4_kernel_ok(K, G)`, uint8 (K, N)
  values hold whole groups);
everything else (the CPU, encoder-scale M, int2_pack, nf4 / fp4 and
group_asym outside those shape conditions) dequantizes the weight to x's
dtype and multiplies with `torch.matmul`, as JAX does with XLA.
"""

from __future__ import annotations

import math

import torch

from .qtensor import QTensor, dequantize, effective_block_scale
from .quant_matmul import (blockwise4_kernel_ok, group_asym_kernel_ok,
                           group_asym_matmul, group_asym_matmul_ref, int4_matmul,
                           int4_matmul_ref, int8_matmul, int8_matmul_ref,
                           nf4_matmul, nf4_matmul_ref)

# The JAX package's default crossover (ops/linear.py PALLAS_M_DEFAULT),
# measured on a TPU. On the H100 the kernels tie dequant + cuBLAS between
# M=32 and 96 for int8, near 96 for uint8 HQQ and near 200 for the 4-bit
# kinds (PERF.md); no per-kind threshold yet.
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


def kernel_call(q: QTensor):
    """(kernel wrapper, its plain version, the arguments after x) by which
    `linear` multiplies (M, K) activations on the card by q, or None where
    q's kind and shape take dequant + torch.matmul."""
    g = q.block_size
    if q.kind == "int8_pc":
        return int8_matmul, int8_matmul_ref, (q.data, q.scale)
    if q.kind == "int4_pack":
        return int4_matmul, int4_matmul_ref, (q.data, q.scale)
    if q.kind in ("nf4", "fp4") and blockwise4_kernel_ok(q.in_dim, g):
        return nf4_matmul, nf4_matmul_ref, (q.data, effective_block_scale(q),
                                            q.kind, g)
    if q.kind == "group_asym" and group_asym_kernel_ok(q.data, q.in_dim, g):
        return group_asym_matmul, group_asym_matmul_ref, (q.data, q.scale,
                                                          q.zero, g)
    return None


def _quantized_matmul(x: torch.Tensor, q: QTensor) -> torch.Tensor:
    m = math.prod(x.shape[:-1])
    if x.is_cuda and m <= KERNEL_M_THRESHOLD:
        call = kernel_call(q)
        if call is not None:
            kernel, _, args = call
            y = kernel(x.reshape(m, x.shape[-1]).contiguous(), *args)
            return y.reshape(*x.shape[:-1], -1)
    return torch.matmul(x, dequantize(q, x.dtype))
