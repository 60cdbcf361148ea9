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
everything else (the CPU, encoder-scale M, int2_pack, fp8, nf4 / fp4 and
group_asym outside those shape conditions) dequantizes the weight to x's
dtype and multiplies with `torch.matmul`, as JAX does with XLA.

A weight with an activation mode (`q.act`) takes `_act_quant_matmul` first,
as in the JAX package. int8 activations over int8_pc or int4_pack weights go
through `w8a8_matmul` at every M on the card: the JAX package keeps its
Pallas kernel off the model path because a `pallas_call` stops XLA from
fusing the neighbouring ops, a reason eager PyTorch does not share. The fp8
branches have no kernel in the JAX package either and stay plain torch in
its order of operations.
"""

from __future__ import annotations

import math

import torch

from ..quant import calibrate
from .attention import matmul_f32
from .qtensor import (FP8_MAX, QTensor, absmax_scale, dequantize,
                      effective_block_scale, unpack_int_sub8)
from .quant_matmul import (blockwise4_kernel_ok, group_asym_kernel_ok,
                           group_asym_matmul, group_asym_matmul_ref, int4_matmul,
                           int4_matmul_ref, int8_matmul, int8_matmul_ref,
                           nf4_matmul, nf4_matmul_ref, quantize_act_int8,
                           w8a8_matmul, w8a8_matmul_ref)

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
    q's kind, shape and activation mode take plain torch (dequant +
    torch.matmul; the fp8 round trips of `_act_quant_matmul`)."""
    g = q.block_size
    if q.act is not None:
        if q.act == "static_fp8" or q.kind not in ("int8_pc", "int4_pack"):
            return None
        # w4a8: the nibbles unpack to int8 codes for the same kernel
        w_int = (q.data if q.kind == "int8_pc"
                 else unpack_int_sub8(q.data, 4, q.in_dim).to(torch.int8))
        return w8a8_matmul, w8a8_matmul_ref, (
            w_int, q.scale, q.act_scale if q.act == "static_int8" else None)
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
    if q.act is not None:
        return _act_quant_matmul(x, q)
    m = math.prod(x.shape[:-1])
    if x.is_cuda and m <= KERNEL_M_THRESHOLD:
        call = kernel_call(q)
        if call is not None:
            kernel, _, args = call
            y = kernel(x.reshape(m, x.shape[-1]).contiguous(), *args)
            return y.reshape(*x.shape[:-1], -1)
    return torch.matmul(x, dequantize(q, x.dtype))


def _act_quant_matmul(x: torch.Tensor, q: QTensor) -> torch.Tensor:
    """Weight and activation quantized matmul, branch for branch the JAX
    package's `_act_quant_matmul` under jit:

    - "static_fp8": activations divided by the calibrated scalar scale (per
      row max(absmax, 1e-12) * f32(1 / 448) when not calibrated), clipped to
      +-448 BEFORE the cast to float8_e4m3fn (which has no infinity), back to
      bf16; the weight dequantized to bf16 with its scale applied; a bf16
      product with f32 sums; times the activation scale after.
    - int8 activations ("dynamic_int8", or "static_int8" with its
      `act_scale`, dynamic per row without) over int8_pc weights, or
      int4_pack unpacked to int8 (w4a8): `w8a8_matmul`, the kernel on the
      card at every M.
    - int8 activations over any other weight kind (fp8 weights): the int8
      codes bake the activation error in and the product runs in bf16 as
      above.

    While a calibration is active, every call reports its input's absmax."""
    if calibrate.active():
        calibrate.observe(q, x)
    m = math.prod(x.shape[:-1])
    x2 = x.reshape(m, x.shape[-1])
    call = kernel_call(q)
    if call is not None:
        kernel, _, args = call
        return kernel(x2.contiguous(), *args).reshape(*x.shape[:-1], -1)
    if q.act == "static_fp8":
        sx = (q.act_scale.to(torch.float32) if q.act_scale is not None
              else absmax_scale(x2, -1, FP8_MAX))
        xr = torch.clamp(x2.to(torch.float32) / sx, -FP8_MAX,
                         FP8_MAX).to(torch.float8_e4m3fn)
    else:
        xr, sx = quantize_act_int8(
            x2, q.act_scale if q.act == "static_int8" else None)
    y = matmul_f32(xr.to(torch.bfloat16), dequantize(q, torch.bfloat16))
    return (y * sx).to(x.dtype).reshape(*x.shape[:-1], -1)
