"""Static-shape decoder self-attention KV cache, written in place: the JAX
package's `models/cache.py`. One (B, H, S, Dh) k/v pair per decoder layer,
fp, or int8 with per-(batch, head, position) absmax scales (B, H, S) f32,
position on the minor axis as in the JAX layout."""

from __future__ import annotations

from typing import Any

import torch

from ..config import WhisperArch
from ..ops.qtensor import quantize_absmax
from .params import DEFAULT_DEVICE, resolve_device
from .whisper import _num_heads

Params = dict[str, Any]


def init_cache(params: Params, arch: WhisperArch, batch: int,
               max_len: int | None = None, dtype=torch.float32,
               device: str | torch.device = DEFAULT_DEVICE,
               int8: bool = False) -> list[dict[str, torch.Tensor]]:
    """Zeroed buffers per decoder layer, head count read from each layer's
    weights: {k, v} in `dtype`, or with int8=True int8 {k, v} plus f32
    {k_scale, v_scale}."""
    device = resolve_device(device)
    max_len = max_len or arch.max_target_positions
    cache = []
    for layer in params["decoder"]["layers"]:
        shape = (batch, _num_heads(layer["attn"], arch.head_dim), max_len,
                 arch.head_dim)
        if int8:
            cache.append({
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
            })
        else:
            cache.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)})
    return cache


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, head, position) absmax int8 quantization over Dh."""
    return quantize_absmax(x, dim=-1, qmax=127)


def update(entry: dict[str, torch.Tensor], k_new: torch.Tensor,
           v_new: torch.Tensor, pos: int) -> None:
    """Write (B, H, T, Dh) keys/values at time offset `pos`, in place
    (quantized, with their scales, in an int8 cache)."""
    t = k_new.shape[2]
    if "k_scale" in entry:
        for name, x in (("k", k_new), ("v", v_new)):
            q, scale = _quantize_kv(x)
            entry[name][:, :, pos: pos + t] = q
            entry[name + "_scale"][:, :, pos: pos + t] = scale[..., 0]
        return
    entry["k"][:, :, pos: pos + t] = k_new.to(entry["k"].dtype)
    entry["v"][:, :, pos: pos + t] = v_new.to(entry["v"].dtype)


def read(entry: dict[str, torch.Tensor], dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(k, v) in `dtype`, dequantized if the cache is int8."""
    if "k_scale" in entry:
        return tuple((entry[n].float() * entry[n + "_scale"][..., None]).to(dtype)
                     for n in ("k", "v"))
    return entry["k"].to(dtype), entry["v"].to(dtype)
