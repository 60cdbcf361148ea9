"""Dense / quantized linear contraction: the single matmul entry point.

Dispatch follows the JAX package's `ops/linear.py`: when the activations
live on the card and have at most `kernel_m_threshold()` rows (the decode-step
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

# Below this many activation rows a quantized linear on the card launches its
# kernel; above it (encoder-scale M) it dequantizes and calls torch.matmul.
# Resolution order, as the JAX package's `pallas_m_threshold`:
# OWC_KERNEL_M_THRESHOLD > KERNEL_M_TABLE[torch.cuda.get_device_name()] >
# KERNEL_M_DEFAULT. The default is the JAX package's (PALLAS_M_DEFAULT,
# measured on a TPU). On the H100 the kernels tie dequant + cuBLAS between
# M=32 and 96 for int8, near 96 for uint8 HQQ and near 200 for the 4-bit
# kinds (PERF.md); the table stays empty until a per-device threshold is
# chosen from `measure_kernel_crossover()`.
KERNEL_M_DEFAULT = 1024
KERNEL_M_TABLE: dict[str, int] = {}
_resolved_threshold: int | None = None

# Eager activation tap (the GPTQ Hessian collection of `quant.gptq`): None
# in production; when set, every `linear` call reports (w, x) to
# `_TAP.observe` before it multiplies, so the collector can accumulate
# X^T X per weight, keyed by the weight's identity.
_TAP = None


def linear(x: torch.Tensor, w, b: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ w + b. x: (..., K); w: (K, N) tensor or QTensor."""
    if _TAP is not None:
        _TAP.observe(w, x)
    if isinstance(w, QTensor):
        y = _quantized_matmul(x, w)
    else:
        y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def kernel_m_threshold() -> int:
    """The kernel-vs-matmul crossover of this process, resolved once."""
    global _resolved_threshold
    if _resolved_threshold is None:
        import os

        env = os.environ.get("OWC_KERNEL_M_THRESHOLD")
        if env:
            _resolved_threshold = int(env)
        else:
            name = (torch.cuda.get_device_name()
                    if torch.cuda.is_available() else "")
            _resolved_threshold = KERNEL_M_TABLE.get(name, KERNEL_M_DEFAULT)
    return _resolved_threshold


def measure_kernel_crossover(k: int = 768, n: int = 3072,
                             candidates: tuple[int, ...] = (
                                 64, 128, 256, 512, 1024, 2048, 4096),
                             iters: int = 10) -> int:
    """The largest M (of `candidates`, ascending, stopping at the first
    loss) at which the int8 kernel (`int8_matmul`) is no slower than
    dequantize + `torch.matmul` on the card, for bf16 activations (the
    model path's) times a (k, n) int8 weight; installed as this process's
    threshold and returned. Each side is timed with CUDA events over
    `iters` back-to-back calls after one warm call. Needs the card."""
    from ..models.params import resolve_device
    from .qtensor import quantize_absmax

    global _resolved_threshold
    dev = resolve_device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    w = (torch.randn(k, n, generator=gen) * 0.02).to(dev)
    q, s = quantize_absmax(w, 0, 127)

    def timeit(f, x):
        f(x)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            f(x)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / iters

    best = candidates[0]
    with torch.inference_mode():
        for m in candidates:
            x = torch.randn(m, k, generator=gen).to(dev, torch.bfloat16)
            t_kernel = timeit(lambda x: int8_matmul(x, q, s), x)
            t_plain = timeit(lambda x: torch.matmul(
                x, q.to(torch.bfloat16) * s.to(torch.bfloat16)), x)
            if t_kernel <= t_plain:
                best = m
            else:
                break
    _resolved_threshold = best
    return best


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
    if x.is_cuda and m <= kernel_m_threshold():
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
