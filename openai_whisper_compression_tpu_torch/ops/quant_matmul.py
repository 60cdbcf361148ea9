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

A weight-only kernel's block owns 64 output columns for up to 128 rows of x;
a skinny M gives few such strips, so K is split over the blocks of a thread
block cluster, which sum their partial tiles through shared memory in one
launch. `_splits` is that rule; `_w8a8_splits` is the w8a8 kernel's, whose
block holds 32 rows x 128 columns and its K range of the rows as int8 codes
up to M = `W8A8_SMALL_M` (above, a quantize pass and a wgmma GEMM).
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .qtensor import (CODEBOOKS, codebook_select, quantize_absmax,
                      unpack_int_sub8)

_BM, _BN, _BK = 128, 64, 32  # output tile and stored-row depth of the kernel
_TARGET_BLOCKS = 100         # most of the H100's 132 SMs get a block
_MAX_CLUSTER = 8             # blocks of one cluster (the portable limit)
W8A8_SMALL_M = 1024          # w8a8: one fused launch up to here, wgmma above
_W8A8_BK = 64                # w8a8: K depth of a stage of the fused kernel
_W8A8_KLEN = 4096            # w8a8: longest K range a fused block holds


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
    """K splits of one output tile, i.e. the size of its thread block
    cluster: the smallest divisor of the K tiles, at most `_MAX_CLUSTER`,
    that puts `_TARGET_BLOCKS` blocks in flight, or the largest such divisor
    where none does. A pure function of M, N and the K tiles."""
    tiles = -(-n // _BN) * (-(-m // _BM))
    divisors = [s for s in range(1, _MAX_CLUSTER + 1) if ktiles % s == 0]
    return next((s for s in divisors if tiles * s >= _TARGET_BLOCKS),
                divisors[-1])


def _ktiles(stored_rows: int) -> int:
    """K tiles of `_BK` stored rows, the last one partial where K is ragged."""
    return -(-stored_rows // _BK)


def _check(name: str, x: torch.Tensor, w: torch.Tensor, stored_rows: int,
           params: list[torch.Tensor]) -> tuple[int, int, int]:
    """Raise on what the kernel does not take; return (M, N, K). Any N and
    any K the storage holds: the kernel predicates its last N and K tiles."""
    kernels.require(x.dim() == 2, name, f"x must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    kernels.require(w.dim() == 2 and w.shape[0] == stored_rows and stored_rows > 0,
                    name, f"w {tuple(w.shape)} does not match x {tuple(x.shape)}")
    n = w.shape[1]
    kernels.require(n > 0, name, "N must be positive")
    kernels.require(all(t.is_cuda and t.device == x.device for t in (w, *params)),
                    name, "x, the weight and its scales must share a device")
    kernels.require(all(t.is_contiguous() for t in (x, w, *params)), name,
                    "inputs must be contiguous")
    kernels.require(all(t.data_ptr() % 16 == 0 for t in (x, w, *params)), name,
                    "x, weight and scales must be 16-byte aligned "
                    "(the kernel copies them in 16-byte pieces)")
    return m, n, k


def _run(name: str, launcher: str, x: torch.Tensor, n: int, ktiles: int,
         before: tuple, after: tuple, cost: dict) -> torch.Tensor:
    """Allocate the output and launch (one kernel):
    `launcher(*before, out, M, N, K, *after, splits, dtype, stream)`; record
    the launch's `cost` (`kernels.record_cost`)."""
    m, k = x.shape
    kernels.require(1 <= m <= 65535 * _BM, name, f"M {m} outside 1..{65535 * _BM}")
    code = kernels.dtype_code(x, name)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = getattr(kernels.lib(), launcher)(
        *before, out.data_ptr(), m, n, k, *after, _splits(m, n, ktiles), code,
        kernels.stream_of(x))
    kernels.check(name, err)
    kernels.record_cost(cost)
    return out


# The costs the JAX Pallas matmuls' `pl.CostEstimate`s declare, with their
# padded extents: M to the row block (256 rows, or M rounded up to 16), N to
# the column block (256, or N rounded up to 128), K to 128 where they pad it.
# x is counted as 2-byte elements whatever its type, as JAX counts it.

def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def _padded_mn(m: int, n: int, block_m: int = 256) -> tuple[int, int]:
    bm, bn = min(block_m, _pad(m, 16)), min(256, _pad(n, 128))
    return _pad(m, bm), _pad(n, bn)


def int8_matmul_cost(m: int, n: int, k: int) -> dict:
    """`int8_matmul_pallas`'s cost at x (M, K), w (K, N)."""
    mp, np_ = _padded_mn(m, n)
    kp = _pad(k, 128)
    return kernels.cost(2 * mp * np_ * kp, mp * kp * 2 + kp * np_ + mp * np_ * 2, 0)


def int4_matmul_cost(m: int, n: int, k: int) -> dict:
    """`int4_matmul_pallas`'s cost at x (M, K), packed w (K/2, N)."""
    mp, np_ = _padded_mn(m, n)
    khp = _pad(k // 2, 128)
    return kernels.cost(2 * mp * np_ * 2 * khp, mp * khp * 4 + khp * np_ + mp * np_ * 2, 0)


def nf4_matmul_cost(m: int, n: int, k: int, g: int) -> dict:
    """`nf4_matmul_pallas`'s cost at x (M, K), packed w (K/2, N), scales
    (K/G, N)."""
    mp, np_ = _padded_mn(m, n)
    return kernels.cost(2 * mp * np_ * k, mp * k * 2 + (k // 2) * np_ + (k // g) * np_ * 4
                        + mp * np_ * 2, 0)


def group_asym_matmul_cost(m: int, n: int, k: int, g: int, stored_rows: int) -> dict:
    """`group_asym_matmul_pallas`'s cost at x (M, K), values of `stored_rows`
    rows (K/2 nibbles or K uint8), scales and zeros (K/G, N)."""
    mp, np_ = _padded_mn(m, n)
    return kernels.cost(2 * mp * np_ * k, mp * k * 2 + stored_rows * np_
                        + 2 * (k // g) * np_ * 4 + mp * np_ * 2, 0)


def w8a8_matmul_cost(m: int, n: int, k: int) -> dict:
    """`w8a8_matmul_pallas`'s cost at x (M, K), w (K, N): 128-row blocks, N
    rounded up to 128."""
    mp = _pad(m, min(128, _pad(m, 16)))
    kp, np_ = _pad(k, 128), _pad(n, 128)
    return kernels.cost(2 * mp * np_ * kp, mp * kp * 2 + kp * np_ + mp * np_ * 2, 0)


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
    """x (M, K) f32/bf16/f16 • w (K, N) int8 • scale (1, N) or (N,) f32 ->
    (M, N) in x's dtype; counts launches in `int8_matmul.launches`."""
    if not x.is_cuda:
        return int8_matmul_ref(x, w, scale)
    name = "int8_matmul"
    kernels.refuse_grad(name, x, w, scale)
    m, n, k = _check(name, x, w, x.shape[-1], [scale])
    kernels.require(w.dtype == torch.int8, name, f"w must be int8, got {w.dtype}")
    _colscale_ok(name, scale, n)
    out = _run(name, "owc_int8_matmul", x, n, _ktiles(k),
               (x.data_ptr(), w.data_ptr(), scale.data_ptr()), (),
               int8_matmul_cost(m, n, k))
    int8_matmul.launches += 1
    return out


def int4_matmul(x: torch.Tensor, w: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) f32/bf16/f16 • w (K/2, N) int8 split-half signed nibbles •
    scale (1, N) or (N,) f32 -> (M, N) in x's dtype; counts launches in
    `int4_matmul.launches`."""
    if not x.is_cuda:
        return int4_matmul_ref(x, w, scale)
    name = "int4_matmul"
    kernels.refuse_grad(name, x, w, scale)
    m, n, k = _check(name, x, w, x.shape[-1] // 2, [scale])
    kernels.require(k % 2 == 0 and w.dtype == torch.int8, name,
                    f"w must be int8 nibbles of an even K, got {w.dtype}, K={k}")
    _colscale_ok(name, scale, n)
    out = _run(name, "owc_int4_matmul", x, n, _ktiles(k // 2),
               (x.data_ptr(), w.data_ptr(), scale.data_ptr()), (),
               int4_matmul_cost(m, n, k))
    int4_matmul.launches += 1
    return out


def nf4_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               kind: str, g: int) -> torch.Tensor:
    """x (M, K) f32/bf16/f16 • w (K/2, N) int8 split-half code indices • scale
    (K/G, N) f32 effective block scale (double-quant already folded) ->
    (M, N) in x's dtype; `kind` "nf4" or "fp4" picks the code. Counts
    launches in `nf4_matmul.launches`."""
    if not x.is_cuda:
        return nf4_matmul_ref(x, w, scale, kind, g)
    name = "nf4_matmul"
    kernels.refuse_grad(name, x, w, scale)
    kernels.require(kind in CODEBOOKS, name, f"kind must be nf4 or fp4, got {kind!r}")
    m, n, k = _check(name, x, w, x.shape[-1] // 2, [scale])
    kernels.require(k % 2 == 0 and w.dtype == torch.int8, name,
                    f"w must be int8 nibbles of an even K, got {w.dtype}, K={k}")
    _group_ok(name, k, g, [scale], n)
    code = (ctypes.c_float * 16)(*CODEBOOKS[kind].tolist())
    out = _run(name, "owc_nf4_matmul", x, n, _ktiles(k // 2),
               (x.data_ptr(), w.data_ptr(), code, scale.data_ptr()), (g,),
               nf4_matmul_cost(m, n, k, g))
    nf4_matmul.launches += 1
    return out


def group_asym_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      zero: torch.Tensor, g: int) -> torch.Tensor:
    """x (M, K) f32/bf16/f16 • HQQ values w, (K/2, N) int8 split-half nibbles
    or (K, N) uint8 • scale, zero (K/G, N) f32 -> (M, N) in x's dtype.
    Counts launches in `group_asym_matmul.launches` (nibbles) and
    `.launches_u8` (uint8)."""
    if not x.is_cuda:
        return group_asym_matmul_ref(x, w, scale, zero, g)
    name = "group_asym_matmul"
    kernels.refuse_grad(name, x, w, scale, zero)
    k = x.shape[-1]
    packed = w.dim() == 2 and group_asym_packed(w, k)
    kernels.require(w.dtype == (torch.int8 if packed else torch.uint8), name,
                    "w must be int8 nibbles (K/2, N) or uint8 values (K, N), "
                    f"got {w.dtype} {tuple(w.shape)}")
    m, n, k = _check(name, x, w, k // 2 if packed else k, [scale, zero])
    kernels.require(k % 2 == 0 or not packed, name, f"K={k} must be even")
    _group_ok(name, k, g, [scale, zero], n)
    out = _run(name, "owc_group_asym_matmul", x, n,
               _ktiles(k // 2 if packed else k),
               (x.data_ptr(), w.data_ptr(), scale.data_ptr(), zero.data_ptr()),
               (g, int(packed)), group_asym_matmul_cost(m, n, k, g, w.shape[0]))
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


def _w8a8_splits(m: int, n: int, k: int) -> int | None:
    """K splits of a w8a8 output tile at M <= `W8A8_SMALL_M`, i.e. the size
    of its thread block cluster: the smallest divisor of the 64-row K tiles,
    at most `_MAX_CLUSTER`, that puts `_TARGET_BLOCKS` blocks of 32 x 128
    outputs in flight, or the largest where none does, among those whose K
    range (held as int8 codes for 32 rows in shared memory) is at most
    `_W8A8_KLEN` bytes; None where no split keeps it that short."""
    ktiles = -(-k // _W8A8_BK)
    tiles = -(-n // 128) * -(-m // 32)
    fits = [s for s in range(1, _MAX_CLUSTER + 1)
            if ktiles % s == 0 and ktiles // s * _W8A8_BK <= _W8A8_KLEN]
    if not fits:
        return None
    return next((s for s in fits if tiles * s >= _TARGET_BLOCKS), fits[-1])


def w8a8_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                act_scale: torch.Tensor | None = None) -> torch.Tensor:
    """x (M, K) f32/bf16/f16 • w (K, N) int8 • scale (1, N) or (N,) f32 ->
    (M, N) in x's dtype, x quantized to int8 per row at run time, or by the
    frozen 0-dim f32 `act_scale`. One kernel at M <= `W8A8_SMALL_M` (K split
    over a cluster by `_w8a8_splits`), a quantize pass and the wgmma GEMM
    above. Any K and N: widths off 16 take the kernels' ragged
    instantiation. Counts calls in `w8a8_matmul.launches` (dynamic) and
    `.launches_static`."""
    if not x.is_cuda:
        return w8a8_matmul_ref(x, w, scale, act_scale)
    name = "w8a8_matmul"
    kernels.refuse_grad(name, x, w, scale, act_scale)
    kernels.require(x.dim() == 2, name, f"x must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    kernels.require(w.dim() == 2 and w.shape[0] == k and w.dtype == torch.int8,
                    name, f"w must be ({k}, N) int8, got {tuple(w.shape)} {w.dtype}")
    n = w.shape[1]
    kernels.require(k >= 1 and n >= 1 and 1 <= m < 2 ** 31, name,
                    f"M, K and N must be positive (M={m}, K={k}, N={n})")
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
    kernels.require(x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0, name,
                    "x and w must be 16-byte aligned (the kernels copy them in "
                    "16-byte pieces)")
    code = kernels.dtype_code(x, name)
    xq = sx = None
    splits = 0
    if m <= W8A8_SMALL_M:
        splits = _w8a8_splits(m, n, k)
        kernels.require(splits is not None, name,
                        f"K={k}: no split of at most {_MAX_CLUSTER} keeps a K range "
                        f"within {_W8A8_KLEN}")
    else:   # the quantize pass's output, read by the GEMM through a tensor
        # map whose rows must be 16-byte strides: K padded with zero codes
        xq = torch.empty((m, -(-k // 16) * 16), dtype=torch.int8, device=x.device)
        if act_scale is None:
            sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = kernels.lib().owc_w8a8_matmul(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(),
        None if act_scale is None else act_scale.data_ptr(),
        None if xq is None else xq.data_ptr(), None if sx is None else sx.data_ptr(),
        out.data_ptr(), m, n, k, splits, code, kernels.stream_of(x))
    kernels.check(name, err)
    kernels.record_cost(w8a8_matmul_cost(m, n, k))
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
