"""Structured pruning that physically shrinks tensors.

Port of the JAX package's `prune/structured.py`. The reference's structured
variants only zero rows or heads (masked reparameterization,
`structured_L2_baseline.py:461-528`, `attention_head_pruning.py:168-264`,
layer dropping `experimental_pruning.py:441-505`); here the primary API
slices weights for real, and the model reads per-layer head counts, FFN
widths and layer lists from the tree's shapes, so the same code runs the
smaller matmuls, attentions and caches. Zeroing variants are kept for
accuracy-parity studies with the reference.

Every transform returns a new tree: `copy_tree` copies the dict/list
structure (leaves shared), each changed leaf is a new tensor on the leaf's
device, and no input tensor is written. Scores and norms are taken in f32;
the head order comes from numpy's `argsort` of those scores, as in JAX, and
the FFN order from a stable descending sort, as JAX's `jnp.argsort`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..config import WhisperArch
from ..models.params import copy_tree, named_leaves, set_leaf


# ---------------------------------------------------------------------------
# L2 structured (zeroing, reference-parity:
# `prune.ln_structured(n=2, dim=0)` zeroes output channels)
# ---------------------------------------------------------------------------

def prune_l2_structured(params: Any, amount: float,
                        name_filter=None) -> Any:
    """Zero the lowest-L2-norm output channels (columns of our (in, out)
    weights) per linear (`structured_L2_baseline.py:461-528`)."""
    from .magnitude import linear_weights

    name_filter = name_filter or linear_weights
    out = copy_tree(params)
    for n, l in named_leaves(params):
        if not isinstance(l, torch.Tensor) or l.dim() != 2 or not name_filter(n):
            continue
        k = int(round(amount * l.shape[1]))
        if k <= 0:
            continue
        norms = l.float().square().sum(dim=0).sqrt()          # per output channel
        thresh = torch.sort(norms).values[max(k - 1, 0)]
        set_leaf(out, n, (l * (norms > thresh)[None, :]).to(l.dtype))
    return out


# ---------------------------------------------------------------------------
# Attention-head pruning
# ---------------------------------------------------------------------------

def head_l1_scores(layer: dict, head_dim: int) -> torch.Tensor:
    """Per-head L1 mass of the q/k/v/o slices, f32 (≈ head pruning by L1
    norm, `experimental_pruning.py:2220-2351`)."""
    qw = layer["q"]["w"]
    n_heads = qw.shape[1] // head_dim
    score = torch.zeros((n_heads,), dtype=torch.float32, device=qw.device)
    for proj in ("q", "k", "v"):
        w = layer[proj]["w"].float()
        score = score + w.reshape(w.shape[0], n_heads, head_dim).abs().sum(dim=(0, 2))
    ow = layer["o"]["w"].float()
    return score + ow.reshape(n_heads, head_dim, -1).abs().sum(dim=(1, 2))


def _index(keep: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(keep, np.int64), device=like.device)


def _slice_head_cols(p: dict, keep: np.ndarray, head_dim: int) -> dict:
    """Keep selected head column-blocks of a column-parallel projection."""
    w = p["w"]
    n_heads = w.shape[1] // head_dim
    idx = _index(keep, w)
    out = {"w": w.reshape(w.shape[0], n_heads, head_dim)[:, idx, :].reshape(w.shape[0], -1)}
    if "b" in p:
        out["b"] = p["b"].reshape(n_heads, head_dim)[idx].reshape(-1)
    return out


def _slice_head_rows(p: dict, keep: np.ndarray, head_dim: int) -> dict:
    w = p["w"]
    n_heads = w.shape[0] // head_dim
    rows = w.reshape(n_heads, head_dim, w.shape[1])[_index(keep, w)]
    out = {"w": rows.reshape(-1, w.shape[1])}
    if "b" in p:
        out["b"] = p["b"]
    return out


def prune_heads(params: Any, arch: WhisperArch,
                drop: dict[str, dict[int, list[int]]],
                physical: bool = True) -> Any:
    """Remove attention heads.

    drop: {"encoder.attn" | "decoder.attn" | "decoder.cross":
           {layer_idx: [head, ...]}}.
    physical=True slices q/k/v columns + o rows (smaller matmuls, smaller KV
    cache); False zeroes the slices (reference behavior,
    `attention_head_pruning.py:168-264`). The zeroing mask is cast to each
    weight's type, so a weight keeps its dtype (the JAX function multiplies
    by an f32 mask, which turns a bf16 weight into f32).
    """
    out = copy_tree(params)
    hd = arch.head_dim
    for key, layer_map in drop.items():
        comp, attn_name = key.split(".")
        for li, heads in layer_map.items():
            layer = out[comp]["layers"][li][attn_name]
            n_heads = layer["q"]["w"].shape[1] // hd
            dropped = set(int(h) for h in heads)
            keep = np.asarray([h for h in range(n_heads) if h not in dropped])
            if len(keep) == 0:
                raise ValueError(f"cannot drop all heads of {key} layer {li}")
            if physical:
                for proj in ("q", "k", "v"):
                    layer[proj] = _slice_head_cols(layer[proj], keep, hd)
                layer["o"] = _slice_head_rows(layer["o"], keep, hd)
            else:
                mask = np.zeros((n_heads,), np.float32)
                mask[keep] = 1.0
                m = torch.from_numpy(np.repeat(mask, hd))
                for proj in ("q", "k", "v"):
                    w = layer[proj]["w"]
                    layer[proj]["w"] = w * m.to(w.device, w.dtype)[None, :]
                    if "b" in layer[proj]:
                        b = layer[proj]["b"]
                        layer[proj]["b"] = b * m.to(b.device, b.dtype)
                w = layer["o"]["w"]
                layer["o"]["w"] = w * m.to(w.device, w.dtype)[:, None]
    return out


def prune_heads_by_l1(params: Any, arch: WhisperArch, amount: float,
                      components: tuple[str, ...] = ("encoder.attn",
                                                     "decoder.attn",
                                                     "decoder.cross"),
                      physical: bool = True) -> Any:
    """Drop the `amount` fraction of lowest-L1 heads per attention module
    (at least one head kept)."""
    drop: dict[str, dict[int, list[int]]] = {}
    for key in components:
        comp, attn_name = key.split(".")
        layer_map = {}
        for li, layer in enumerate(params[comp]["layers"]):
            scores = head_l1_scores(layer[attn_name], arch.head_dim).cpu().numpy()
            n_drop = int(round(amount * scores.size))
            n_drop = min(n_drop, scores.size - 1)  # keep >= 1 head
            if n_drop > 0:
                layer_map[li] = list(np.argsort(scores)[:n_drop])
        if layer_map:
            drop[key] = layer_map
    return prune_heads(params, arch, drop, physical=physical)


# ---------------------------------------------------------------------------
# FFN shrinking / MLP removal
# ---------------------------------------------------------------------------

def shrink_ffn(params: Any, component: str, layer_idx: int,
               keep_fraction: float) -> Any:
    """Physically shrink one layer's FFN: rank hidden units by
    |fc1 col| + |fc2 row| L1 and slice (≈ activation/magnitude-guided MLP
    pruning, `experimental_pruning.py:1427-1562`, but with real slicing).
    The kept units stay in their order."""
    out = copy_tree(params)
    layer = out[component]["layers"][layer_idx]
    fc1, fc2 = layer["fc1"], layer["fc2"]
    w1, w2 = fc1["w"], fc2["w"]
    ffn = w1.shape[1]
    n_keep = max(int(round(keep_fraction * ffn)), 1)
    score = w1.float().abs().sum(dim=0) + w2.float().abs().sum(dim=1)
    keep = torch.sort(torch.argsort(-score, stable=True)[:n_keep]).values
    layer["fc1"] = {"w": w1[:, keep], **({"b": fc1["b"][keep]} if "b" in fc1 else {})}
    layer["fc2"] = {"w": w2[keep, :], **({"b": fc2["b"]} if "b" in fc2 else {})}
    return out


def remove_mlp(params: Any, component: str, layer_indices: list[int]) -> Any:
    """Remove the MLP contribution of the given layers (fc2 zeroed, so the
    residual passes through; ≈ MLP removal,
    `experimental_pruning.py:2899-2975`)."""
    out = copy_tree(params)
    for li in layer_indices:
        layer = out[component]["layers"][li]
        layer["fc2"] = {k: torch.zeros_like(v) for k, v in layer["fc2"].items()}
    return out


# ---------------------------------------------------------------------------
# Layer dropping
# ---------------------------------------------------------------------------

def drop_layers(params: Any, component: str, indices: list[int]) -> Any:
    """Physically remove whole transformer layers (layer dropping): the
    layer list of `component` ("encoder" or "decoder") shrinks, so the model
    runs fewer layers (and keeps a smaller KV cache). The kept layers'
    tensors are the input's own, not copies."""
    out = copy_tree(params)
    drop = set(indices)
    keep = [layer for i, layer in enumerate(out[component]["layers"])
            if i not in drop]
    if not keep:
        raise ValueError("cannot drop all layers")
    out[component]["layers"] = keep
    return out
