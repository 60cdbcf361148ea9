"""Static-shape decoder self-attention KV cache: one (B, H, S, Dh) k/v pair
per decoder layer, written in place (the JAX package's `models/cache.py`
for fp caches; the int8 cache is a later slice)."""

from __future__ import annotations

from typing import Any

import torch

from ..config import WhisperArch
from .whisper import _num_heads

Params = dict[str, Any]


def init_cache(params: Params, arch: WhisperArch, batch: int,
               max_len: int | None = None, dtype=torch.float32,
               device: str | torch.device = "cpu") -> list[dict[str, torch.Tensor]]:
    """Zeroed {k, v} buffers per decoder layer; head count read from each
    layer's weights."""
    max_len = max_len or arch.max_target_positions
    cache = []
    for layer in params["decoder"]["layers"]:
        shape = (batch, _num_heads(layer["attn"], arch.head_dim), max_len,
                 arch.head_dim)
        cache.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)})
    return cache


def update(entry: dict[str, torch.Tensor], k_new: torch.Tensor,
           v_new: torch.Tensor, pos: int) -> None:
    """Write (B, H, T, Dh) keys/values at time offset `pos`, in place."""
    t = k_new.shape[2]
    entry["k"][:, :, pos: pos + t] = k_new.to(entry["k"].dtype)
    entry["v"][:, :, pos: pos + t] = v_new.to(entry["v"].dtype)
