"""Sensitivity-driven mixed-precision quantization, the JAX package's
`quant/mixed.py`: per-leaf weight bit-widths under an average-bits budget.

Every quantizable linear weight starts at the ladder's widest rung; leaves
are demoted a rung at a time in ascending importance (least important
first, wave by wave) until the parameter-weighted average bit-width meets
the target. Importance ties demote larger leaves first. `apply_quant_config`
runs one `quantize_params` pass a method, so every leaf takes the QTensor
kinds (and kernels) of uniform quantization.
"""

from __future__ import annotations

import json
import math
from typing import Any

from ..models.params import named_leaves
from ..ops.qtensor import QTensor
from .api import LINEAR_WEIGHT_RE, quantize_params
from .core import QUANTIZERS

# nominal stored bits a weight per QUANTIZERS method (scale and zero
# metadata are O(1 / group) and the same across rungs, so they cancel)
METHOD_BITS: dict[str, float] = {
    "int2": 2, "hqq_int3": 3, "int4": 4, "nf4": 4, "fp4": 4, "hqq_int4": 4,
    "nf4_dq": 4, "fp4_dq": 4, "int8": 8, "hqq_int8": 8, "fp8": 8,
}
# every rung must be a QUANTIZERS method, or a config could name a rung
# that apply_quant_config cannot apply
assert set(METHOD_BITS) <= set(QUANTIZERS)

DEFAULT_LADDER = ("int4", "int8")


def quantizable_leaves(params: Any) -> list[tuple[str, int]]:
    """(name, parameter count) of every linear weight a config governs."""
    return [(name, math.prod(leaf.shape)) for name, leaf in named_leaves(params)
            if not isinstance(leaf, QTensor) and LINEAR_WEIGHT_RE.search(name)]


def generate_quant_config(params: Any, scores: dict[str, float],
                          target_bits: float = 6.0,
                          ladder: tuple[str, ...] = DEFAULT_LADDER) -> dict:
    """Assign each linear weight a rung of `ladder` (ascending bits) so that
    the parameter-weighted average is at most `target_bits`, keeping the
    most sensitive leaves wide. `scores`: {leaf name: sensitivity} (a name
    missing ranks least important). Raises below the ladder's floor."""
    for m in ladder:
        if m not in METHOD_BITS:
            raise KeyError(f"unknown ladder method {m!r}; have {sorted(METHOD_BITS)}")
    if len(ladder) < 2 or any(METHOD_BITS[a] >= METHOD_BITS[b]
                              for a, b in zip(ladder, ladder[1:])):
        raise ValueError("ladder must list >= 2 methods in ascending bits")
    leaves = quantizable_leaves(params)
    if not leaves:
        raise ValueError("no quantizable linear weights in params")
    total = sum(n for _, n in leaves)
    floor = METHOD_BITS[ladder[0]]
    if target_bits < floor:
        raise ValueError(f"target_bits={target_bits} below ladder floor "
                         f"{floor} ({ladder[0]})")
    # ascending importance; ties demote big leaves first (the cheapest bits)
    order = sorted(leaves, key=lambda kv: (scores.get(kv[0], 0.0), -kv[1]))
    rung = {name: len(ladder) - 1 for name, _ in leaves}

    def avg_bits() -> float:
        return sum(METHOD_BITS[ladder[rung[n]]] * c for n, c in leaves) / total

    while avg_bits() > target_bits:
        demoted = False
        for name, _ in order:
            if rung[name] > 0:
                rung[name] -= 1
                demoted = True
                if avg_bits() <= target_bits:
                    break
        if not demoted:        # everything at the floor already
            break
    assignments = {name: ladder[rung[name]] for name, _ in leaves}
    return {
        "assignments": assignments,
        "ladder": list(ladder),
        "target_bits": float(target_bits),
        "avg_bits": round(avg_bits(), 4),
        "counts": {m: sum(1 for v in assignments.values() if v == m) for m in ladder},
    }


def apply_quant_config(params: Any, config: dict) -> Any:
    """Apply a `generate_quant_config` result: one `quantize_params` pass a
    distinct method, scoped by name. Raises where the config names leaves
    the tree lacks (a config of another model)."""
    assignments: dict[str, str] = config["assignments"]
    present = {n for n, _ in quantizable_leaves(params)}
    missing = sorted(set(assignments) - present)
    if missing:
        raise KeyError(f"{len(missing)} assigned leaves absent from params (config "
                       f"from a different model?), e.g. {missing[:3]}")
    out = params
    for method in dict.fromkeys(assignments.values()):
        names = {n for n, m in assignments.items() if m == method}
        out = quantize_params(out, method, name_filter=lambda n, s=names: n in s)
    return out


def save_quant_config(config: dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(config, f, indent=2)
    return path


def load_quant_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
