"""Decode-time fusion of the decoder self-attention q/k/v projections into
one (d, 3·H·Dh) matmul, on dense weights or int8_pc QTensors (data and
per-channel scales concatenate along the output axis). Apply after
quantization, as in the JAX package's `models/fuse.py`."""

from __future__ import annotations

from typing import Any

import torch

from ..ops.qtensor import QTensor
from .params import copy_tree


def _fuse_attn(attn: dict) -> dict:
    qw, kw, vw = attn["q"]["w"], attn["k"]["w"], attn["v"]["w"]
    ws = (qw, kw, vw)
    if any(isinstance(w, QTensor) for w in ws):
        if not all(isinstance(w, QTensor) for w in ws):
            raise NotImplementedError("fusing mixed dense/quantized q/k/v")
        w = QTensor(data=torch.cat([t.data for t in ws], dim=1),
                    scale=torch.cat([t.scale for t in ws], dim=1),
                    kind=qw.kind,
                    shape=(qw.shape[0], sum(t.shape[1] for t in ws)))
    else:
        w = torch.cat(ws, dim=1)
    qb, vb = attn["q"]["b"], attn["v"]["b"]
    b = torch.cat([qb, torch.zeros_like(qb), vb])  # k has no bias
    return {"qkv": {"w": w, "b": b}, "o": attn["o"]}


def fuse_qkv(params: Any, components: tuple[str, ...] = ("decoder",)) -> Any:
    """Fuse self-attention q/k/v per layer of the given components."""
    out = copy_tree(params)
    for comp in components:
        for layer in out[comp]["layers"]:
            layer["attn"] = _fuse_attn(layer["attn"])
    return out


def qkv_split(fused_out: torch.Tensor) -> tuple:
    """(.., 3*H*Dh) -> three (.., H*Dh) projections."""
    d = fused_out.shape[-1] // 3
    return (fused_out[..., :d], fused_out[..., d: 2 * d],
            fused_out[..., 2 * d:])
