"""Quantized-weight matmuls: the weight-only dequant-matmuls
(`csrc/quant_matmul.cu`), the activation-quantized w8a8 matmul
(`csrc/w8a8_matmul.cu`), and their plain versions.

Each computes out (M, N) = bf16(x) @ W with f32 accumulation, output in x's
dtype, the semantics of the JAX package's `ops/quant_matmul.py` kernels:

- `int8_matmul`      (`int8_matmul_pallas`): W = int8 codes, times the
  column scale after the sum;
- `int4_matmul`      (`int4_matmul_pallas`): split-half signed nibbles
  (K/2, N), times the column scale after the sum;
- `nf4_matmul`       (`nf4_matmul_pallas`): split-half unsigned nibbles
  indexing the NF4 or FP4 code, W = bf16(code · blockscale) in f32;
- `group_asym_matmul` (`group_asym_matmul_pallas`): HQQ values, W =
  bf16((v − zero) · scale) in f32, v split-half nibbles (K/2, N) or uint8
  (K, N).

`w8a8_matmul` (`w8a8_matmul_pallas`) quantizes x to int8 first, per row at
run time or by one frozen scalar, multiplies int8 by int8 into exact int32
sums and scales the result: out = f32(xq @ W) * sx * scale, in x's dtype.

A CUDA tensor launches the kernel (and counts the launch on the wrapper);
a CPU tensor takes the plain version, which multiplies the same bf16-rounded
operands in f32 (the same int8 codes exactly, for `w8a8_matmul`).
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .qtensor import (CODEBOOKS, codebook_select, quantize_absmax,
                      unpack_int_sub8)

_BM, _BN, _BK = 32, 64, 32   # output tile and stored-row depth of the kernel
_TARGET_BLOCKS = 264         # about two blocks per H100 SM


def _bf16_f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def int8_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain version: x rounded to bf16, W (integer codes) exact in f32,
    f32 products and sums, times the per-column scale, cast to x's
    dtype."""
    acc = _bf16_f32(x) @ w.to(torch.float32)
    return (acc * scale.reshape(1, -1).to(torch.float32)).to(x.dtype)


def int4_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain version of `int4_matmul`: unpack, then as `int8_matmul_ref`."""
    return int8_matmul_ref(x, unpack_int_sub8(w, 4, x.shape[1]), scale)


def _grouped(vals: torch.Tensor, g: int, fn) -> torch.Tensor:
    """fn(vals (K/G, G, N)) back to (K, N)."""
    k, n = vals.shape
    return fn(vals.reshape(k // g, g, n)).reshape(k, n)


def nf4_matmul_ref(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   kind: str, g: int) -> torch.Tensor:
    """Plain version of `nf4_matmul`: code[idx] · scale in f32, rounded to
    bf16, times bf16(x) in f32."""
    idx = unpack_int_sub8(w, 4, x.shape[1], signed=False)
    wq = _grouped(codebook_select(idx, kind), g,
                  lambda v: v * scale.to(torch.float32)[:, None, :])
    return (_bf16_f32(x) @ _bf16_f32(wq)).to(x.dtype)


def group_asym_matmul_ref(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                          zero: torch.Tensor, g: int) -> torch.Tensor:
    """Plain version of `group_asym_matmul`: (v − zero) · scale in f32,
    rounded to bf16, times bf16(x) in f32."""
    k = x.shape[1]
    vals = (unpack_int_sub8(w, 4, k, signed=False).to(torch.float32)
            if group_asym_packed(w, k) else w.to(torch.float32))
    wq = _grouped(vals, g, lambda v: (v - zero.to(torch.float32)[:, None, :])
                  * scale.to(torch.float32)[:, None, :])
    return (_bf16_f32(x) @ _bf16_f32(wq)).to(x.dtype)


def blockwise4_kernel_ok(k: int, block_size: int) -> bool:
    """The JAX package's `blockwise4_pallas_ok`: the split-half packed
    layout leaves no room for K padding between the halves, so the kernel
    takes K/2 a multiple of 128 and K a whole number of scale groups. Holds
    for every projection of whisper base/small/medium/large; whisper-tiny's
    d_model 384 and the test dims take dequant + matmul."""
    return k % 256 == 0 and k % block_size == 0


def group_asym_packed(w: torch.Tensor, k: int) -> bool:
    """Whether HQQ values `w` of a K-row weight are split-half nibbles
    (K/2, N) rather than uint8 values (K, N)."""
    return w.shape[0] != k


def group_asym_kernel_ok(w: torch.Tensor, k: int, block_size: int) -> bool:
    """The JAX package's group-asym dispatch rule: packed nibbles need
    `blockwise4_kernel_ok(K, G)`, uint8 values a whole number of groups."""
    return (blockwise4_kernel_ok(k, block_size) if group_asym_packed(w, k)
            else k % block_size == 0)


def _splits(m: int, n: int, ktiles: int) -> int:
    """K splits so that a skinny M still puts ~2 blocks on every SM."""
    tiles = (n // _BN) * (-(-m // _BM))
    want = max(1, min(ktiles, -(-_TARGET_BLOCKS // tiles)))
    per = -(-ktiles // want)
    return -(-ktiles // per)


def _check(name: str, x: torch.Tensor, w: torch.Tensor, stored_rows: int,
           params: list[torch.Tensor]) -> tuple[int, int, int]:
    """Raise on what the kernel does not take; return (M, N, K)."""
    kernels.require(x.dim() == 2, name, f"x must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    kernels.require(w.dim() == 2 and w.shape[0] == stored_rows, name,
                    f"w {tuple(w.shape)} does not match x {tuple(x.shape)}")
    n = w.shape[1]
    kernels.require(stored_rows % _BK == 0 and n % _BN == 0, name,
                    f"stored rows % {_BK} and N % {_BN} must be 0 "
                    f"(rows={stored_rows}, N={n})")
    kernels.require(all(t.is_cuda and t.device == x.device for t in (w, *params)),
                    name, "x, the weight and its scales must share a device")
    kernels.require(all(t.is_contiguous() for t in (x, w, *params)), name,
                    "inputs must be contiguous")
    kernels.require(all(t.data_ptr() % 16 == 0 for t in (w, *params)), name,
                    "weight and scales must be 16-byte aligned "
                    "(the kernel reads them in 16-byte loads)")
    return m, n, k


def _run(name: str, launcher: str, x: torch.Tensor, n: int, ktiles: int,
         before: tuple, after: tuple) -> torch.Tensor:
    """Allocate the split-K workspace and the output and launch:
    `launcher(*before, part, out, M, N, K, *after, splits, dtype, stream)`."""
    m, k = x.shape
    code = kernels.dtype_code(x, name)
    splits = _splits(m, n, ktiles)
    part = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = getattr(kernels.lib(), launcher)(
        *before, part.data_ptr(), out.data_ptr(), m, n, k, *after, splits, code,
        kernels.stream_of(x))
    kernels.check(name, err)
    return out


def _colscale_ok(name: str, scale: torch.Tensor, n: int) -> None:
    kernels.require(scale.numel() == n and scale.dtype == torch.float32, name,
                    "scale must hold N float32 values")


def _group_ok(name: str, k: int, g: int, params: list[torch.Tensor], n: int) -> None:
    kernels.require(g > 0 and k % g == 0, name, f"K={k} is not a whole number "
                    f"of groups of {g}")
    for t in params:
        kernels.require(t.shape == (k // g, n) and t.dtype == torch.float32, name,
                        f"group parameters must be ({k // g}, {n}) float32, got "
                        f"{tuple(t.shape)} {t.dtype}")


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) f32/bf16 • w (K, N) int8 • scale (1, N) or (N,) f32 ->
    (M, N) in x's dtype; counts launches in `int8_matmul.launches`."""
    if not x.is_cuda:
        return int8_matmul_ref(x, w, scale)
    name = "int8_matmul"
    m, n, k = _check(name, x, w, x.shape[-1], [scale])
    kernels.require(w.dtype == torch.int8, name, f"w must be int8, got {w.dtype}")
    _colscale_ok(name, scale, n)
    out = _run(name, "owc_int8_matmul", x, n, k // _BK,
               (x.data_ptr(), w.data_ptr(), scale.data_ptr()), ())
    int8_matmul.launches += 1
    return out


def int4_matmul(x: torch.Tensor, w: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) f32/bf16 • w (K/2, N) int8 split-half signed nibbles •
    scale (1, N) or (N,) f32 -> (M, N) in x's dtype; counts launches in
    `int4_matmul.launches`."""
    if not x.is_cuda:
        return int4_matmul_ref(x, w, scale)
    name = "int4_matmul"
    m, n, k = _check(name, x, w, x.shape[-1] // 2, [scale])
    kernels.require(k % 2 == 0 and w.dtype == torch.int8, name,
                    f"w must be int8 nibbles of an even K, got {w.dtype}, K={k}")
    _colscale_ok(name, scale, n)
    out = _run(name, "owc_int4_matmul", x, n, k // 2 // _BK,
               (x.data_ptr(), w.data_ptr(), scale.data_ptr()), ())
    int4_matmul.launches += 1
    return out


def nf4_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               kind: str, g: int) -> torch.Tensor:
    """x (M, K) f32/bf16 • w (K/2, N) int8 split-half code indices • scale
    (K/G, N) f32 effective block scale (double-quant already folded) ->
    (M, N) in x's dtype; `kind` "nf4" or "fp4" picks the code. Counts
    launches in `nf4_matmul.launches`."""
    if not x.is_cuda:
        return nf4_matmul_ref(x, w, scale, kind, g)
    name = "nf4_matmul"
    kernels.require(kind in CODEBOOKS, name, f"kind must be nf4 or fp4, got {kind!r}")
    m, n, k = _check(name, x, w, x.shape[-1] // 2, [scale])
    kernels.require(k % 2 == 0 and w.dtype == torch.int8, name,
                    f"w must be int8 nibbles of an even K, got {w.dtype}, K={k}")
    _group_ok(name, k, g, [scale], n)
    code = (ctypes.c_float * 16)(*CODEBOOKS[kind].tolist())
    out = _run(name, "owc_nf4_matmul", x, n, k // 2 // _BK,
               (x.data_ptr(), w.data_ptr(), code, scale.data_ptr()), (g,))
    nf4_matmul.launches += 1
    return out


def group_asym_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      zero: torch.Tensor, g: int) -> torch.Tensor:
    """x (M, K) f32/bf16 • HQQ values w, (K/2, N) int8 split-half nibbles
    or (K, N) uint8 • scale, zero (K/G, N) f32 -> (M, N) in x's dtype.
    Counts launches in `group_asym_matmul.launches` (nibbles) and
    `.launches_u8` (uint8)."""
    if not x.is_cuda:
        return group_asym_matmul_ref(x, w, scale, zero, g)
    name = "group_asym_matmul"
    k = x.shape[-1]
    packed = w.dim() == 2 and group_asym_packed(w, k)
    kernels.require(w.dtype == (torch.int8 if packed else torch.uint8), name,
                    "w must be int8 nibbles (K/2, N) or uint8 values (K, N), "
                    f"got {w.dtype} {tuple(w.shape)}")
    m, n, k = _check(name, x, w, k // 2 if packed else k, [scale, zero])
    kernels.require(k % 2 == 0 or not packed, name, f"K={k} must be even")
    _group_ok(name, k, g, [scale, zero], n)
    out = _run(name, "owc_group_asym_matmul", x, n,
               (k // 2 if packed else k) // _BK,
               (x.data_ptr(), w.data_ptr(), scale.data_ptr(), zero.data_ptr()),
               (g, int(packed)))
    if packed:
        group_asym_matmul.launches += 1
    else:
        group_asym_matmul.launches_u8 += 1
    return out


def quantize_act_int8(x: torch.Tensor, act_scale: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes of the activations x (..., K) and their scale
    sx, as the JAX package's jitted `_act_quant_matmul` computes them: the
    frozen scalar `act_scale`, or per row max(absmax, 1e-12) * f32(1 / 127)
    (keepdim); xq = clip(round(f32(x) / sx), -127, 127), a true division
    rounded half to even. Returns (xq int8, sx f32)."""
    if act_scale is None:
        return quantize_absmax(x, dim=-1, qmax=127)
    sx = act_scale.to(torch.float32)
    xq = torch.clamp(torch.round(x.to(torch.float32) / sx), -127, 127)
    return xq.to(torch.int8), sx


def w8a8_matmul_ref(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    act_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of `w8a8_matmul`: `quantize_act_int8`, the integer
    product summed exactly (in f64: |sums| < 2**53), rounded once to f32 as
    an int32 converts, then (acc * sx) * scale left to right, cast to x's
    dtype."""
    xq, sx = quantize_act_int8(x, act_scale)
    acc = (xq.to(torch.float64) @ w.to(torch.float64)).to(torch.float32)
    return (acc * sx * scale.reshape(1, -1).to(torch.float32)).to(x.dtype)


def w8a8_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                act_scale: torch.Tensor | None = None) -> torch.Tensor:
    """x (M, K) f32/bf16 • w (K, N) int8 • scale (1, N) or (N,) f32 ->
    (M, N) in x's dtype, x quantized to int8 per row at run time, or by the
    frozen 0-dim f32 `act_scale`. Counts launches in `w8a8_matmul.launches`
    (dynamic) and `.launches_static`."""
    if not x.is_cuda:
        return w8a8_matmul_ref(x, w, scale, act_scale)
    name = "w8a8_matmul"
    kernels.require(x.dim() == 2, name, f"x must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    kernels.require(w.dim() == 2 and w.shape[0] == k and w.dtype == torch.int8,
                    name, f"w must be ({k}, N) int8, got {tuple(w.shape)} {w.dtype}")
    n = w.shape[1]
    kernels.require(k % 16 == 0 and n % 16 == 0 and 1 <= m <= 65535 * 32, name,
                    f"K and N must be multiples of 16 and M lie in 1..{65535 * 32} "
                    f"(M={m}, K={k}, N={n})")
    _colscale_ok(name, scale, n)
    tensors = [x, w, scale]
    if act_scale is not None:
        kernels.require(act_scale.numel() == 1 and act_scale.dtype == torch.float32,
                        name, "act_scale must hold one float32")
        tensors.append(act_scale)
    kernels.require(all(t.is_cuda and t.device == x.device for t in tensors),
                    name, "x, the weight and the scales must share a device")
    kernels.require(all(t.is_contiguous() for t in tensors), name,
                    "inputs must be contiguous")
    code = kernels.dtype_code(x, name)
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    wt = torch.empty((n, k), dtype=torch.int8, device=x.device)
    sx = (torch.empty((m,), dtype=torch.float32, device=x.device)
          if act_scale is None else None)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = kernels.lib().owc_w8a8_matmul(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(),
        None if act_scale is None else act_scale.data_ptr(), xq.data_ptr(),
        wt.data_ptr(), None if sx is None else sx.data_ptr(), out.data_ptr(),
        m, n, k, code, kernels.stream_of(x))
    kernels.check(name, err)
    if act_scale is None:
        w8a8_matmul.launches += 1
    else:
        w8a8_matmul.launches_static += 1
    return out


w8a8_matmul.launches = 0          # dynamic per-row scales
w8a8_matmul.launches_static = 0   # one frozen scale
int8_matmul.launches = 0
int4_matmul.launches = 0
nf4_matmul.launches = 0
group_asym_matmul.launches = 0
group_asym_matmul.launches_u8 = 0
