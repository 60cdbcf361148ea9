"""Attention-head importance by masked-head loss deltas, the JAX package's
`sensitivity/heads.py`: the loss over the batches with every head, and
with each head masked out in turn ((L, H) head masks of
`models.whisper.nll_loss`); importance = the loss increase. Forwards only,
under `torch.no_grad()`, so they take the kernels on the card.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch

from ..config import WhisperArch
from ..models.whisper import nll_loss
from .gradient import tree_device

ATTN_KINDS = ("encoder", "decoder", "cross")


def head_importance(params: Any, arch: WhisperArch, batches: Iterable[tuple],
                    kind: str = "encoder") -> np.ndarray:
    """(L, H) importance for one attention family: "encoder" (encoder
    self-attention), "decoder" (decoder self-attention) or "cross"."""
    assert kind in ATTN_KINDS
    comp = "encoder" if kind == "encoder" else "decoder"
    n_layers = len(params[comp]["layers"])
    n_heads = arch.encoder_heads if comp == "encoder" else arch.decoder_heads
    mask_kw = {"encoder": "enc_head_masks", "decoder": "dec_head_masks",
               "cross": "cross_head_masks"}[kind]
    dev = tree_device(params)
    batches = [(torch.as_tensor(m, device=dev), torch.as_tensor(t, device=dev).long(),
                torch.as_tensor(l, device=dev).long()) for m, t, l in batches]
    ones = torch.ones((n_layers, n_heads), dtype=torch.float32, device=dev)

    def total_loss(masks: torch.Tensor) -> float:
        # the f32 sum of the batch losses, as the JAX package adds them
        return float(sum(nll_loss(params, arch, m, t, l, **{mask_kw: masks})
                         for m, t, l in batches))

    with torch.no_grad():
        base = total_loss(ones)
        imp = np.zeros((n_layers, n_heads), np.float32)
        for li in range(n_layers):
            for h in range(n_heads):
                masks = ones.clone()
                masks[li, h] = 0.0
                imp[li, h] = total_loss(masks) - base
    return imp


def least_important_heads(importance: np.ndarray, amount: float,
                          min_keep: int = 1) -> dict[int, list[int]]:
    """Per-layer drop lists for `prune.structured.prune_heads`: the `amount`
    fraction of lowest-importance heads (at least `min_keep` kept a layer)."""
    n_layers, n_heads = importance.shape
    n_drop = min(int(round(amount * n_heads)), n_heads - min_keep)
    out = {}
    for li in range(n_layers):
        if n_drop > 0:
            out[li] = list(np.argsort(importance[li])[:n_drop])
    return out
