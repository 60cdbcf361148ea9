"""QTensor: a quantized 2-D weight leaf of the parameter tree.

The weight-only kinds of the JAX package's `ops/qtensor.py`, logical shape
(in_dim K, out_dim N), N always the last axis of every stored array:

- "int8_pc": per-output-channel symmetric int8. data (K, N) int8, scale
  (1, N) f32.
- "int4_pack" / "int2_pack": per-channel symmetric int4 / int2, split-half
  packed along K (`pack_int_sub8`). data (K·bits/8, N) int8, scale (1, N).
- "nf4" / "fp4": blockwise 4-bit codebook along K per column, split-half
  packed indices (K/2, N) int8, per-block absmax scale (K/G, N) f32; with
  double-quant the scale is int8 and scale2/offset2 (K/G, N) f32 hold the
  second-level scale and offset, expanded elementwise.
- "group_asym": HQQ group-wise asymmetric int, scale and zero (K/G, N) f32;
  data (K, N) uint8 for bits 8, split-half packed nibbles (K/2, N) int8 for
  bits <= 4 (3-bit values sit in a nibble).

- "fp8": float8_e4m3fn weights (K, N) with a per-channel scale (1, N) f32
  into the e4m3 range (largest normal 448).

`act` is the activation mode of a quantized linear: None (weight-only),
"dynamic_int8" (per-row absmax at run time), "static_int8" or "static_fp8"
(the frozen scalar `act_scale` of a calibration pass; without one they
scale per row at run time).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

# The 16 NormalFloat4 levels (bitsandbytes' nf4), as the JAX package.
NF4_CODE = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=np.float32,
)

# FP4 (e2m1) codebook of bitsandbytes' fp4 quant type, as the JAX package
# (its -0.0 and 0.0052 entries included).
FP4_CODE = np.array(
    [0.0, 0.0052083334, 0.6666667, 1.0, 0.3333333, 0.5, 0.16666667, 0.25,
     -0.0, -0.0052083334, -0.6666667, -1.0, -0.3333333, -0.5, -0.16666667,
     -0.25],
    dtype=np.float32,
)

CODEBOOKS = {"nf4": NF4_CODE, "fp4": FP4_CODE}
KINDS = ("int8_pc", "int4_pack", "int2_pack", "nf4", "fp4", "group_asym", "fp8")
ACT_MODES = (None, "dynamic_int8", "static_int8", "static_fp8")
FP8_MAX = 448.0   # largest normal of float8_e4m3fn
_TENSOR_FIELDS = ("data", "scale", "zero", "scale2", "offset2", "act_scale")


@dataclasses.dataclass
class QTensor:
    data: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor | None = None
    scale2: torch.Tensor | None = None   # double-quant second-level scale
    offset2: torch.Tensor | None = None  # double-quant second-level offset
    act_scale: torch.Tensor | None = None  # static activation scale, 0-dim f32
    kind: str = "int8_pc"
    bits: int = 8
    shape: tuple = ()
    block_size: int = 64
    act: str | None = None   # activation mode, one of ACT_MODES

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown QTensor kind {self.kind!r}; have {KINDS}")
        if self.act not in ACT_MODES:
            raise ValueError(f"unknown activation mode {self.act!r}; have "
                             f"{ACT_MODES}")

    @property
    def in_dim(self) -> int:
        return self.shape[0]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._tensors())

    def to(self, device) -> "QTensor":
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in _TENSOR_FIELDS
            if getattr(self, f) is not None})

    def _tensors(self) -> list[torch.Tensor]:
        return [getattr(self, f) for f in _TENSOR_FIELDS
                if getattr(self, f) is not None]


def dequantize(q: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Dense (K, N) weight in `dtype`, computed in `dtype` as the JAX
    package's reference (non-kernel) dequantization."""
    k, n = q.shape
    if q.kind in ("int8_pc", "fp8"):
        return q.data.to(dtype) * q.scale.to(dtype)
    if q.kind in ("int4_pack", "int2_pack"):
        return unpack_int_sub8(q.data, q.bits, k).to(dtype) * q.scale.to(dtype)
    g = q.block_size
    if q.kind in ("nf4", "fp4"):
        idx = unpack_int_sub8(q.data, 4, k, signed=False)
        vals = codebook_select(idx, q.kind).to(dtype)
        scale = effective_block_scale(q, dtype)
        return (vals.reshape(k // g, g, n) * scale[:, None, :]).reshape(k, n)
    vals = (q.data.to(dtype) if q.data.shape[0] == k
            else unpack_int_sub8(q.data, 4, k, signed=False).to(dtype))
    w = ((vals.reshape(k // g, g, n) - q.zero.to(dtype)[:, None, :])
         * q.scale.to(dtype)[:, None, :])
    return w.reshape(k, n)


def effective_block_scale(q: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Per-block absmax scale (K/G, N) in `dtype`, undoing double-quant
    (scale·scale2 + offset2, a multiply then an add) if present."""
    scale = q.scale
    if q.scale2 is not None:
        scale = scale.to(dtype) * q.scale2.to(dtype) + q.offset2.to(dtype)
    return scale.to(dtype)


def codebook_select(idx: torch.Tensor, kind: str) -> torch.Tensor:
    """16-entry codebook lookup of the "nf4" or "fp4" table, f32:
    `code[idx]`."""
    return codebook_table(kind, idx.device)[idx.long()]


@functools.cache
def codebook_table(kind: str, device: torch.device) -> torch.Tensor:
    """The codebook as an f32 tensor on `device`, made once per device (a
    copy to the card in every call would wait for the stream)."""
    return torch.from_numpy(CODEBOOKS[kind]).to(device)


def pack_int_sub8(w_int: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack sub-byte ints along axis 0 into int8, split-half layout: byte k
    holds w[k], w[k + K/p], ... in its bit groups (p = 8/bits values per
    byte), as the JAX package's `pack_int_sub8`."""
    per = 8 // bits
    k, n = w_int.shape
    if k % per:
        raise ValueError(f"K={k} not divisible by {per}")
    u = (w_int.to(torch.int32) & ((1 << bits) - 1)).reshape(per, k // per, n)
    shifts = torch.arange(per, dtype=torch.int32, device=w_int.device) * bits
    packed = (u << shifts[:, None, None]).sum(0)
    return packed.to(torch.uint8).view(torch.int8)


def unpack_int_sub8(packed: torch.Tensor, bits: int, k: int,
                    signed: bool = True) -> torch.Tensor:
    """Inverse of `pack_int_sub8` -> (K, N) int32, sign-extended when
    `signed` (codebook indices and asymmetric values unpack unsigned)."""
    per = 8 // bits
    if packed.shape[0] * per != k:
        raise ValueError(f"{tuple(packed.shape)} packed rows do not hold K={k}")
    u = packed.view(torch.uint8).to(torch.int32)
    mask, sign_bit = (1 << bits) - 1, 1 << (bits - 1)
    parts = []
    for j in range(per):
        vals = (u >> (bits * j)) & mask
        if signed:
            vals = torch.where(vals >= sign_bit, vals - (1 << bits), vals)
        parts.append(vals)
    return torch.cat(parts, dim=0)


def inv_f32(c: float) -> torch.Tensor:
    """f32(1 / c) as a 0-dim CPU tensor: it multiplies a CUDA tensor as an
    f32 scalar, with no copy to the card (which would wait for the
    stream). Under `jax.jit` XLA compiles a division by a constant into this
    multiply, so the port multiplies wherever the JAX code divides by a
    constant."""
    return torch.tensor(1.0 / c, dtype=torch.float32)


def absmax_scale(x: torch.Tensor, dim: int, qmax: float) -> torch.Tensor:
    """max(absmax along `dim`, 1e-12) * f32(1 / qmax), f32 with `dim` kept
    as size 1: the scale that maps x into [-qmax, qmax]."""
    absmax = x.to(torch.float32).abs().amax(dim=dim, keepdim=True)
    return torch.clamp(absmax, min=1e-12) * inv_f32(qmax)


def quantize_absmax(x: torch.Tensor, dim: int,
                    qmax: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax quantization along `dim` (the KV caches' scheme and
    the dynamic int8 activations'): scale = `absmax_scale`, q = clip(round(x
    / scale), -qmax, qmax). Returns (q int8, scale f32)."""
    scale = absmax_scale(x, dim, qmax)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -qmax, qmax)
    return q.to(torch.int8), scale
