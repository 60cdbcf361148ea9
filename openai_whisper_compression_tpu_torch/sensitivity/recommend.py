"""Sensitivity -> pruning-recipe recommendation, the JAX package's
`sensitivity/recommend.py`: normalised importance maps to per-category
pruning rates (low importance, an aggressive rate), with the decoder FFN
split into early/middle/late rates; the result is a JSON-able config for
`prune.recipe.apply_recipe`.
"""

from __future__ import annotations

import json
import os
from typing import Any

from ..config import WhisperArch
from .gradient import aggregate, normalize_scores

# importance quantile -> pruning rate
RATE_BANDS = [
    (0.2, 0.60),   # the least important fifth: prune 60%
    (0.4, 0.45),
    (0.6, 0.30),
    (0.8, 0.15),
    (1.01, 0.05),  # the most important: prune 5%
]


def _band_rate(rank_q: float) -> float:
    for hi, rate in RATE_BANDS:
        if rank_q < hi:
            return rate
    return 0.05


def generate_pruning_config(scores: dict[str, float], arch: WhisperArch,
                            protect: tuple[str, ...] = ("layernorm", "positional",
                                                        "bias")) -> dict[str, Any]:
    """{"recipe": {category: rate}, "analysis": aggregates, "model": name}."""
    agg = aggregate(normalize_scores(scores))
    cats = agg["by_category"]
    order = sorted(cats, key=cats.get)  # least important first
    recipe: dict[str, float] = {}
    for i, cat in enumerate(order):
        recipe[cat] = (0.0 if any(p in cat for p in protect)
                       else _band_rate((i + 0.5) / len(order)))
    if "decoder_ffn" in recipe:  # the decoder FFN's positional split
        base = recipe.pop("decoder_ffn")
        recipe["decoder_ffn_first"] = round(base * 0.7, 3)
        recipe["decoder_ffn_middle"] = round(base * 1.1, 3)
        recipe["decoder_ffn_last"] = round(base * 0.85, 3)
    for cat in ("layernorm", "positional", "bias"):
        recipe.setdefault(cat, 0.0)
    recipe = {k: float(min(max(v, 0.0), 0.95)) for k, v in recipe.items()}
    return {"recipe": recipe, "analysis": agg, "model": arch.name}


def save_pruning_config(config: dict[str, Any], path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(config, f, indent=2)
    return path
