"""Sensitivity visualization (the port's copy of the JAX package's
`sensitivity/plots.py`; matplotlib is imported at the first plot, since the
card's machine has none).

Parity with the reference's sensitivity charts (`create_summary_plot`
`gradient_sensitivity_test.py:376`, per-layer detail plots :826, Fisher
charts `hessian_sensitivity_test.py:106,870`): category bar chart +
(component × layer) heat map from aggregated scores.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np


def plot_sensitivity(aggregated: dict[str, Any], save_dir: str,
                     prefix: str = "sensitivity") -> list[str]:
    """aggregated = sensitivity.gradient.aggregate(...) output."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(save_dir, exist_ok=True)
    paths = []

    cats = aggregated["by_category"]
    fig, ax = plt.subplots(figsize=(9, 4.5))
    names = list(cats)
    ax.barh(range(len(names)), [cats[n] for n in names])
    ax.set_yticks(range(len(names)))
    ax.set_yticklabels(names, fontsize=7)
    ax.set_xlabel("normalized importance")
    ax.set_title("parameter sensitivity by component")
    p = os.path.join(save_dir, f"{prefix}_by_category.png")
    fig.tight_layout()
    fig.savefig(p, dpi=110)
    plt.close(fig)
    paths.append(p)

    by_layer = aggregated.get("by_layer", {})
    if by_layer:
        comps = sorted({k.split(".")[0] for k in by_layer})
        max_layer = max(int(k.split(".")[1]) for k in by_layer) + 1
        grid = np.full((len(comps), max_layer), np.nan)
        for k, v in by_layer.items():
            c, i = k.split(".")
            grid[comps.index(c), int(i)] = v
        fig, ax = plt.subplots(figsize=(9, 2.5 + 0.5 * len(comps)))
        im = ax.imshow(grid, aspect="auto", cmap="viridis")
        ax.set_yticks(range(len(comps)))
        ax.set_yticklabels(comps)
        ax.set_xlabel("layer")
        ax.set_title("per-layer sensitivity")
        fig.colorbar(im, ax=ax)
        p = os.path.join(save_dir, f"{prefix}_by_layer.png")
        fig.tight_layout()
        fig.savefig(p, dpi=110)
        plt.close(fig)
        paths.append(p)
    return paths
