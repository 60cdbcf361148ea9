"""Result plots (matplotlib, headless; imported at the first plot).

The port's copy of the JAX package's `sweep/plots.py`.

Parity with the reference's plotting blocks
(`unstructured_L1_baseline.py:871-1126`, `openai_whisper_compression/utils.py:271-317`):
WER/CER vs sparsity, model size vs WER, RTFx per config.
"""

from __future__ import annotations

import os
from typing import Any


def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported at the first plot
    (the card's machine has no matplotlib; nothing else here needs it)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _ok(results: dict[str, Any]) -> dict[str, Any]:
    return {k: v for k, v in results.items() if "error" not in v and v.get("splits")}


def _first_split(r: dict) -> dict:
    return next(iter(r["splits"].values()), {})


def plot_sweep(results: dict[str, Any], save_dir: str,
               prefix: str = "sweep") -> list[str]:
    os.makedirs(save_dir, exist_ok=True)
    ok = _ok(results)
    if not ok:
        return []
    names = list(ok)
    wers = [_first_split(ok[n]).get("wer") for n in names]
    rtfx = [_first_split(ok[n]).get("rtfx") for n in names]
    sizes = [ok[n]["model_size_mb"] for n in names]
    sparsity = [ok[n]["sparsity"] for n in names]
    paths = []
    plt = _pyplot()

    def save(fig, suffix):
        p = os.path.join(save_dir, f"{prefix}_{suffix}.png")
        fig.tight_layout()
        fig.savefig(p, dpi=110)
        plt.close(fig)
        paths.append(p)

    fig, ax = plt.subplots(figsize=(9, 4.5))
    ax.scatter(sparsity, wers)
    for n, x, y in zip(names, sparsity, wers):
        if y is not None:
            ax.annotate(n, (x, y), fontsize=6, rotation=20)
    ax.set_xlabel("sparsity")
    ax.set_ylabel("WER")
    ax.set_title("WER vs sparsity")
    save(fig, "wer_vs_sparsity")

    fig, ax = plt.subplots(figsize=(9, 4.5))
    ax.scatter(sizes, wers)
    for n, x, y in zip(names, sizes, wers):
        if y is not None:
            ax.annotate(n, (x, y), fontsize=6, rotation=20)
    ax.set_xlabel("model size (MB)")
    ax.set_ylabel("WER")
    ax.set_title("WER vs model size")
    save(fig, "wer_vs_size")

    fig, ax = plt.subplots(figsize=(10, 4.5))
    ax.bar(range(len(names)), [r or 0 for r in rtfx])
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=75, fontsize=6, ha="right")
    ax.set_ylabel("RTFx (higher is better)")
    ax.set_title("Throughput per config")
    save(fig, "rtfx")

    # offline accuracy axis: WER against the baseline config's transcripts
    vsb = [_first_split(ok[n]).get("wer_vs_baseline") for n in names]
    if any(v is not None for v in vsb):
        fig, ax = plt.subplots(figsize=(10, 4.5))
        ax.bar(range(len(names)), [v if v is not None else 0 for v in vsb])
        ax.set_xticks(range(len(names)))
        ax.set_xticklabels(names, rotation=75, fontsize=6, ha="right")
        ax.set_ylabel("WER vs baseline transcripts")
        ax.set_title("Transcript drift vs baseline (0 = compression-neutral)")
        save(fig, "wer_vs_baseline")
    return paths


DEFAULT_CURVE_METRICS = ("wer", "cer", "rtf", "rtfx",
                         "avg_latency_per_batch_s")


def plot_metric_curves(results: dict[str, Any], save_dir: str,
                       metrics: tuple[str, ...] = DEFAULT_CURVE_METRICS,
                       prefix: str = "curves") -> list[str]:
    """Per-metric curves over the config axis with one line per split —
    parity with the reference's per-experiment `create_plots`
    (`unstructured_L1_baseline.py:871-1126`: each metric vs pruning %,
    clean/other split lines). The x axis is each config's sparsity when the
    sweep varies it (pruning ladders), else the config index."""
    os.makedirs(save_dir, exist_ok=True)
    ok = _ok(results)
    if not ok:
        return []
    names = list(ok)
    sparsities = [ok[n]["sparsity"] for n in names]
    varies = len({round(s, 3) for s in sparsities}) > 1
    if varies:  # sort by sparsity so curves don't double back
        names = [n for _, n in sorted(zip(sparsities, names))]
        x = sorted(sparsities)
    else:
        x = list(range(len(names)))
    xlabel = "sparsity" if varies else "config"
    splits = sorted({s for n in names for s in ok[n]["splits"]})
    paths = []
    plt = _pyplot()
    for metric in metrics:
        fig, ax = plt.subplots(figsize=(9, 4.5))
        plotted = False
        for split in splits:
            y = [ok[n]["splits"].get(split, {}).get(metric) for n in names]
            if any(v is not None for v in y):
                ax.plot(x, [v if v is not None else float("nan") for v in y],
                        marker="o", label=f"{split} split")
                plotted = True
        if not plotted:
            plt.close(fig)
            continue
        if not varies:
            ax.set_xticks(x)
            ax.set_xticklabels(names, rotation=75, fontsize=6, ha="right")
        ax.set_xlabel(xlabel)
        ax.set_ylabel(metric)
        ax.set_title(f"{metric} vs {xlabel}")
        ax.legend()
        p = os.path.join(save_dir, f"{prefix}_{metric}.png")
        fig.tight_layout()
        fig.savefig(p, dpi=110)
        plt.close(fig)
        paths.append(p)
    return paths
