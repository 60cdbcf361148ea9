"""Structured pruning: layer dropping.

Of the JAX package's `prune/structured.py` only `drop_layers` is here, the
surgery `models.speculative.self_speculative_draft` makes. The JAX
module's `_copy_tree` (from `prune/magnitude.py`) is `models.params.
copy_tree`: a copy of the dict/list structure whose leaves stay shared.
"""

from __future__ import annotations

from typing import Any

from ..models.params import copy_tree


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
