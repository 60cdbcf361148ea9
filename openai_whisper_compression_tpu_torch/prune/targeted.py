"""Component-targeted name filters + parameter taxonomy.

A copy of the JAX package's framework-free `prune/targeted.py` (the port
imports nothing of that package). Each filter is a predicate on dotted leaf
names, composable with any pruner; the reference's per-component experiment
scripts each differed only in such a filter
(`pruning/targeted_component_scripts/*.py`, SURVEY.md §2a).
"""

from __future__ import annotations

import re
from typing import Callable

NameFilter = Callable[[str], bool]

LINEAR_RE = re.compile(r"\.(attn|cross)\.(q|k|v|o)\.w$|\.fc[12]\.w$")


# --- component filters (names mirror the reference scripts) ----------------

def encoder_only(n: str) -> bool:
    """`pruning/targeted_component_scripts/encoder.py:465-497`"""
    return n.startswith("encoder.") and bool(LINEAR_RE.search(n))


def decoder_only(n: str) -> bool:
    """`pruning/targeted_component_scripts/decoder.py:465-497`"""
    return n.startswith("decoder.") and bool(LINEAR_RE.search(n))


def self_attn_encoder(n: str) -> bool:
    """`self_attn_encoder.py:475-560` (q/k/v/out projections)"""
    return n.startswith("encoder.") and ".attn." in n and n.endswith(".w")


def self_attn_decoder(n: str) -> bool:
    """`self_attn_decoder.py:489-553`"""
    return n.startswith("decoder.") and ".attn." in n and n.endswith(".w")


def cross_attn_decoder(n: str) -> bool:
    """`cross_attn_decoder.py:474-533` ('decoder' + 'encoder_attn' in name)"""
    return n.startswith("decoder.") and ".cross." in n and n.endswith(".w")


def ffn_encoder(n: str) -> bool:
    """`ffns_encoder.py:475` (fc1/fc2)"""
    return n.startswith("encoder.") and bool(re.search(r"\.fc[12]\.w$", n))


def ffn_decoder(n: str) -> bool:
    """`ffns_decoder.py:474-571`"""
    return n.startswith("decoder.") and bool(re.search(r"\.fc[12]\.w$", n))


def conv_layers(n: str) -> bool:
    """`conv_layers.py:526-575` (encoder conv stem)"""
    return bool(re.match(r"encoder\.conv[12]\.w$", n))


def token_embeddings(n: str) -> bool:
    """`token_embeddings.py:471-500`"""
    return n == "decoder.embed"


def positional_embeddings(n: str) -> bool:
    """`positional_embeddings.py:474-530` (learned decoder positions; encoder
    sinusoids are functional constants here and excluded on purpose)"""
    return n == "decoder.pos"


def token_positional_embeddings(n: str) -> bool:
    """`token_positional_embeddings.py:480`"""
    return token_embeddings(n) or positional_embeddings(n)


def qkv_projections_only(n: str) -> bool:
    """q/k/v projections without out_proj (QKV-projection-specific pruning,
    `experimental_pruning.py` QKV configs)."""
    return bool(re.search(r"\.(attn|cross)\.(q|k|v)\.w$", n))


def bias_only(n: str) -> bool:
    """`bias.py:499-545` (all bias vectors)"""
    return bool(re.search(r"\.(q|v|o|fc1|fc2|conv1|conv2)\.b$", n))


def layernorm_only(n: str) -> bool:
    """`layer_norm.py:556-610` (LayerNorm weight+bias)"""
    return bool(re.search(r"(_ln|\.ln)\.(g|b)$", n))


def proj_out(n: str) -> bool:
    """`final_output_projection.py:467-510`. proj_out is weight-tied to the
    token embedding (HF does the same), so this targets the shared table."""
    return n == "decoder.embed"


# --- layer-position filters (layer-analysis scripts) ------------------------

def layer_section(component: str, section: str, n_layers: int,
                  window: int = 4) -> NameFilter:
    """early/middle/late `window`-layer slices of encoder or decoder
    (`layer_pruning.py:464-537`)."""
    if section == "early":
        lo = 0
    elif section == "middle":
        lo = max((n_layers - window) // 2, 0)
    elif section == "late":
        lo = max(n_layers - window, 0)
    else:
        raise ValueError(section)
    sel = set(range(lo, min(lo + window, n_layers)))

    def f(n: str) -> bool:
        m = re.match(rf"{component}\.layers\.(\d+)\.", n)
        return bool(m and int(m.group(1)) in sel and LINEAR_RE.search(n))

    return f


def first_last_layer(component: str, which: str, n_layers: int) -> NameFilter:
    """Single first/last layer of a component (`first_last_layers.py:459-548`)."""
    idx = 0 if which == "first" else n_layers - 1

    def f(n: str) -> bool:
        return n.startswith(f"{component}.layers.{idx}.") and bool(
            LINEAR_RE.search(n))

    return f


def layers_of(component: str, indices: set[int]) -> NameFilter:
    def f(n: str) -> bool:
        m = re.match(rf"{component}\.layers\.(\d+)\.", n)
        return bool(m and int(m.group(1)) in indices and LINEAR_RE.search(n))

    return f


def union(*filters: NameFilter) -> NameFilter:
    return lambda n: any(f(n) for f in filters)


# --- taxonomy (≈ architecture analyzer categories,
#     `architecture_analysis.py:77-98`, `gradient_sensitivity_test.py:103-154`)

def categorize(name: str) -> str:
    comp = "encoder" if name.startswith("encoder.") else "decoder"
    if ".conv" in name:
        return "conv_stem"
    if name.endswith(".embed"):
        return "token_embedding"
    if name.endswith(".pos"):
        return f"{comp}_positional"
    if re.search(r"(_ln|\.ln)\.", name):
        return f"{comp}_layernorm"
    if ".cross." in name:
        return "cross_attention"
    if ".attn." in name:
        return f"{comp}_self_attention"
    if re.search(r"\.fc[12]\.", name):
        return f"{comp}_ffn"
    return f"{comp}_other"


def layer_index(name: str) -> int | None:
    m = re.search(r"\.layers\.(\d+)\.", name)
    return int(m.group(1)) if m else None
