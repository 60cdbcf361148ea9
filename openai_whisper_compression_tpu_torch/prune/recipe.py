"""Per-component pruning recipe engine — the thesis-final compression recipe.

Port of the JAX package's `prune/recipe.py` (framework-free but for the
tree it walks). Parity with `determine_pruning_amount`
(`pruning/final_pruning_script/pruning_and_storing_as_sparse.py:29-111`) and
its config (:590-604): each parameter gets a rate by component category and
decoder-depth third; `apply_recipe` ≈ `apply_custom_l1_pruning` (:114-259).
"""

from __future__ import annotations

from typing import Any

from ..config import WhisperArch
from . import targeted
from .magnitude import prune_per_module_l1

# Thesis-final recipe (reference :590-604).
DEFAULT_RECIPE: dict[str, float] = {
    "encoder_ffn": 0.50,
    "decoder_ffn_first": 0.25,
    "decoder_ffn_middle": 0.45,
    "decoder_ffn_last": 0.30,
    "encoder_self_attention": 0.40,
    "decoder_self_attention": 0.50,
    "cross_attention": 0.45,
    "token_embedding": 0.25,
    "conv_stem": 0.30,
    "proj_out": 0.25,  # tied to token_embedding; kept for config parity
    "layernorm": 0.0,
    "positional": 0.0,
    "bias": 0.0,
}

# `--increase_pruning` variant (reference :607-623).
INCREASED_RECIPE: dict[str, float] = {
    **DEFAULT_RECIPE,
    "encoder_ffn": 0.60,
    "decoder_ffn_first": 0.35,
    "decoder_ffn_middle": 0.55,
    "decoder_ffn_last": 0.40,
    "encoder_self_attention": 0.50,
    "decoder_self_attention": 0.60,
    "cross_attention": 0.55,
    "token_embedding": 0.35,
    "conv_stem": 0.40,
}


def determine_pruning_amount(name: str, arch: WhisperArch,
                             recipe: dict[str, float] | None = None) -> float:
    """Rate for one parameter leaf by category; decoder FFN rates depend on
    depth third (first/middle/last), mirroring the reference's layer-position
    logic."""
    recipe = recipe or DEFAULT_RECIPE
    cat = targeted.categorize(name)
    if cat.endswith("_layernorm"):
        return recipe.get("layernorm", 0.0)
    if cat.endswith("_positional"):
        return recipe.get("positional", 0.0)
    if name.endswith(".b"):
        return recipe.get("bias", 0.0)
    if cat == "decoder_ffn":
        li = targeted.layer_index(name)
        third = max(arch.decoder_layers // 3, 1)
        if li is None or li < third:
            return recipe.get("decoder_ffn_first", 0.0)
        if li < 2 * third:
            return recipe.get("decoder_ffn_middle", 0.0)
        return recipe.get("decoder_ffn_last", 0.0)
    return recipe.get(cat, 0.0)


def apply_recipe(params: Any, arch: WhisperArch,
                 recipe: dict[str, float] | None = None) -> Any:
    """Per-module L1 pruning with per-component rates
    (≈ `apply_custom_l1_pruning`, reference :114-259)."""
    from ..models.params import named_leaves
    from ..ops.qtensor import QTensor

    amounts = {}
    for n, l in named_leaves(params):
        if isinstance(l, QTensor):
            continue
        a = determine_pruning_amount(n, arch, recipe)
        if a > 0:
            amounts[n] = a
    return prune_per_module_l1(params, 0.0, name_filter=lambda n: n in amounts,
                               amounts=amounts)
