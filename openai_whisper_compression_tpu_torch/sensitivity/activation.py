"""Activation-statistics sensitivity (FFN hidden-unit utilisation), the JAX
package's `sensitivity/activation.py`: batches run through `forward` under
`utils.capture`, the MLP's post-GELU records aggregate per layer and unit,
and the most active units give the keep-sets of FFN shrinking.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch

from ..config import WhisperArch
from ..models.params import copy_tree
from ..models.whisper import forward
from ..utils import capture
from .gradient import tree_device


def collect_ffn_stats(params: Any, arch: WhisperArch,
                      batches: Iterable[tuple]) -> list[dict]:
    """One record per MLP call, in call order (encoder layers 0..E-1, then
    decoder layers 0..D-1), each averaged over the batches: mean |act|,
    the active fraction, and per-unit mean |act| (numpy)."""
    n_enc = len(params["encoder"]["layers"])
    n_dec = len(params["decoder"]["layers"])
    dev = tree_device(params)
    per_call: list[dict] | None = None
    n_batches = 0
    for mel, tokens, _ in batches:
        with capture.capturing() as store, torch.no_grad():
            forward(params, arch, torch.as_tensor(mel, device=dev),
                    torch.as_tensor(tokens, device=dev).long())
        records = [r for r in store if r["tag"] == "ffn_act"]
        assert len(records) == n_enc + n_dec
        units = [r["per_unit_mean_abs"].cpu().numpy() for r in records]
        if per_call is None:
            per_call = [{"mean_abs": 0.0, "frac_active": 0.0,
                         "per_unit_mean_abs": np.zeros_like(u)} for u in units]
        for agg, r, u in zip(per_call, records, units):
            agg["mean_abs"] += r["mean_abs"]
            agg["frac_active"] += r["frac_active"]
            agg["per_unit_mean_abs"] += u
        n_batches += 1
    out = []
    for i, agg in enumerate(per_call or []):
        comp = "encoder" if i < n_enc else "decoder"
        out.append({
            "component": comp, "layer": i if i < n_enc else i - n_enc,
            "mean_abs": agg["mean_abs"] / n_batches,
            "frac_active": agg["frac_active"] / n_batches,
            "per_unit_mean_abs": agg["per_unit_mean_abs"] / n_batches,
        })
    return out


def activation_guided_ffn_prune(params: Any, arch: WhisperArch,
                                batches: Iterable[tuple],
                                keep_fraction: float = 0.5) -> Any:
    """Shrink every FFN to its most active hidden units: round(keep_fraction
    x ffn) of them (at least 1), kept in their order, fc1's columns and
    fc2's rows sliced (new tensors; the input tree is left alone)."""
    stats = collect_ffn_stats(params, arch, batches)
    out = copy_tree(params)
    for rec in stats:
        layer = out[rec["component"]]["layers"][rec["layer"]]
        w1, w2 = layer["fc1"]["w"], layer["fc2"]["w"]
        n_keep = max(int(round(keep_fraction * w1.shape[1])), 1)
        keep = np.sort(np.argsort(-rec["per_unit_mean_abs"])[:n_keep])
        idx = torch.as_tensor(keep, dtype=torch.int64, device=w1.device)
        layer["fc1"] = {"w": w1[:, idx], "b": layer["fc1"]["b"][idx]}
        layer["fc2"] = {"w": w2[idx, :], "b": layer["fc2"]["b"]}
    return out
