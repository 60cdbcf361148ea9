"""Decode-time fusion of the decoder self-attention q/k/v projections into
one (d, 3·H·Dh) matmul, as the JAX package's `models/fuse.py`: dense
weights concatenate along the output axis, and so do QTensors of one kind
(every stored array keeps N as its last axis: data, scales, zeros and the
double-quant scale2/offset2). Layers whose q/k/v cannot fuse (mixed dense
and quantized, or mixed kinds) stay unfused; every kind fuses, fp8 included
(the JAX package's FUSABLE_KINDS holds them all). The fused QTensor keeps
the first tensor's activation mode and `act_scale`, as JAX's does, so
calibrate after fusing. Apply after quantization. `unfuse_qkv` is the
inverse for dense weights."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops.qtensor import QTensor
from .params import copy_tree


def _concat_qtensors(tensors: list[QTensor]) -> QTensor | None:
    t0 = tensors[0]
    if {t.kind for t in tensors} != {t0.kind}:
        return None

    def cat(field):
        vals = [getattr(t, field) for t in tensors]
        return None if any(v is None for v in vals) else torch.cat(vals, dim=1)

    return dataclasses.replace(
        t0, data=cat("data"), scale=cat("scale"), zero=cat("zero"),
        scale2=cat("scale2"), offset2=cat("offset2"),
        shape=(t0.shape[0], sum(t.shape[1] for t in tensors)))


def _fuse_attn(attn: dict) -> dict | None:
    """{q, k, v, o} -> {qkv, o}, or None when the weights cannot fuse."""
    ws = (attn["q"]["w"], attn["k"]["w"], attn["v"]["w"])
    quantized = [isinstance(w, QTensor) for w in ws]
    if all(quantized):
        w = _concat_qtensors(list(ws))
        if w is None:
            return None
    elif any(quantized):
        return None
    else:
        w = torch.cat(ws, dim=1)
    data = w.data if isinstance(w, QTensor) else w
    qb, vb = attn["q"].get("b"), attn["v"].get("b")

    def zeros(dtype):   # an absent bias, as in the JAX package; k has none
        return torch.zeros(data.shape[1] // 3, dtype=dtype, device=data.device)

    b = torch.cat([qb if qb is not None else zeros(torch.float32),
                   zeros(torch.float32 if qb is None else qb.dtype),
                   vb if vb is not None else zeros(torch.float32)])
    return {"qkv": {"w": w, "b": b}, "o": attn["o"]}


def fuse_qkv(params: Any, components: tuple[str, ...] = ("decoder",)) -> Any:
    """Fuse self-attention q/k/v per layer of the given components."""
    out = copy_tree(params)
    for comp in components:
        for layer in out[comp]["layers"]:
            fused = _fuse_attn(layer["attn"])
            if fused is not None:
                layer["attn"] = fused
    return out


def unfuse_qkv(params: Any) -> Any:
    """Inverse of `fuse_qkv` for dense weights (dequantize first): splits
    each fused qkv of the encoder and the decoder back into q/k/v with
    Whisper's bias layout (k has none: its fused share is structurally
    zero). `unfuse_qkv(fuse_qkv(p))` gives p's tensors bit for bit."""
    out = copy_tree(params)
    for comp in ("encoder", "decoder"):
        for layer in out[comp]["layers"]:
            attn = layer["attn"]
            if "qkv" not in attn:
                continue
            w = attn["qkv"]["w"]
            if isinstance(w, QTensor):
                raise ValueError("dequantize before unfusing")
            d = w.shape[1] // 3
            b = attn["qkv"]["b"]
            layer["attn"] = {"q": {"w": w[:, :d], "b": b[:d]},
                             "k": {"w": w[:, d: 2 * d]},
                             "v": {"w": w[:, 2 * d:], "b": b[2 * d:]},
                             "o": attn["o"]}
    return out


def qkv_split(fused_out: torch.Tensor) -> tuple:
    """(.., 3*H*Dh) -> three (.., H*Dh) projections."""
    d = fused_out.shape[-1] // 3
    return (fused_out[..., :d], fused_out[..., d: 2 * d],
            fused_out[..., 2 * d:])
