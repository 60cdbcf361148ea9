"""Architecture introspection, the JAX package's
`sensitivity/architecture.py`: every leaf of the parameter tree with its
category, layer, shape, parameter count and type; totals by category; a
text table and a per-leaf CSV.
"""

from __future__ import annotations

import csv
import io
import math
from typing import Any

from ..models.params import named_leaves, size_in_mb
from ..ops.qtensor import QTensor
from ..prune.targeted import categorize, layer_index


def analyze_model(params: Any) -> dict[str, Any]:
    rows = []
    for name, leaf in named_leaves(params):
        if isinstance(leaf, QTensor):
            shape, dtype = tuple(leaf.shape), f"q:{leaf.kind}"
        else:  # the dtype named as numpy names it ("float32"), as in the JAX tables
            shape, dtype = tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")
        rows.append({"name": name, "category": categorize(name),
                     "layer": layer_index(name), "shape": shape,
                     "params": math.prod(shape), "dtype": dtype})
    total = sum(r["params"] for r in rows)
    by_cat: dict[str, int] = {}
    for r in rows:
        by_cat[r["category"]] = by_cat.get(r["category"], 0) + r["params"]
    return {
        "total_params": total,
        "size_mb": size_in_mb(params),
        "by_category": {k: {"params": v, "pct": 100.0 * v / total}
                        for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "leaves": rows,
    }


def format_table(analysis: dict[str, Any]) -> str:
    lines = [f"{'category':<28} {'params':>14} {'%':>7}"]
    for cat, d in analysis["by_category"].items():
        lines.append(f"{cat:<28} {d['params']:>14,} {d['pct']:>6.2f}%")
    lines.append(f"{'TOTAL':<28} {analysis['total_params']:>14,} "
                 f"({analysis['size_mb']:.1f} MB)")
    return "\n".join(lines)


def to_csv(analysis: dict[str, Any], path: str | None = None) -> str:
    """Per-leaf CSV."""
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=["name", "category", "layer", "shape",
                                        "params", "dtype"])
    w.writeheader()
    for r in analysis["leaves"]:
        w.writerow(r)
    text = buf.getvalue()
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text
