"""Weight-only int8 matmul: `csrc/int8_matmul.cu` and its plain version.

out (M, N) = (bf16(x) @ bf16(W_int8)) * scale[N], f32 accumulation, output
in x's dtype: the semantics of the JAX package's
`ops/quant_matmul.py::int8_matmul_pallas`.
"""

from __future__ import annotations

import torch

from . import kernels

_BM, _BN, _BK = 32, 64, 32   # output tile and K depth of csrc/int8_matmul.cu
_TARGET_BLOCKS = 264         # about two blocks per H100 SM


def int8_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain version: x rounded to bf16, W exact in f32, f32 products and
    sums, times the per-column scale, cast to x's dtype."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    acc = xb @ w.to(torch.float32)
    return (acc * scale.reshape(1, -1).to(torch.float32)).to(x.dtype)


def _splits(m: int, n: int, k: int) -> int:
    """K splits so that a skinny M still puts ~2 blocks on every SM."""
    tiles = (n // _BN) * (-(-m // _BM))
    ktiles = k // _BK
    want = max(1, min(ktiles, -(-_TARGET_BLOCKS // tiles)))
    per = -(-ktiles // want)
    return -(-ktiles // per)


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) f32/bf16 • w (K, N) int8 • scale (1, N) or (N,) f32 ->
    (M, N) in x's dtype. A CUDA tensor launches the kernel (and counts the
    launch in `int8_matmul.launches`); a CPU tensor takes the plain
    version."""
    if not x.is_cuda:
        return int8_matmul_ref(x, w, scale)
    name = "int8_matmul"
    m, k = x.shape
    kernels.require(w.dim() == 2 and w.shape[0] == k, name,
                    f"w {tuple(w.shape)} does not match x {tuple(x.shape)}")
    n = w.shape[1]
    kernels.require(w.dtype == torch.int8, name, f"w must be int8, got {w.dtype}")
    kernels.require(scale.numel() == n and scale.dtype == torch.float32, name,
                    "scale must hold N float32 values")
    kernels.require(k % _BK == 0 and n % _BN == 0, name,
                    f"K % {_BK} and N % {_BN} must be 0 (K={k}, N={n})")
    kernels.require(w.is_cuda and scale.is_cuda and x.device == w.device
                    == scale.device, name, "x, w and scale must share a device")
    kernels.require(x.is_contiguous() and w.is_contiguous()
                    and scale.is_contiguous(), name, "inputs must be contiguous")
    kernels.require(w.data_ptr() % 16 == 0, name,
                    "w must be 16-byte aligned (the kernel reads it in 16-byte loads)")
    code = kernels.dtype_code(x, name)
    splits = _splits(m, n, k)
    part = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = kernels.lib().owc_int8_matmul(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), part.data_ptr(),
        out.data_ptr(), m, n, k, splits, code, kernels.stream_of(x))
    kernels.check(name, err)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
