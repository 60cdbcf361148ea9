"""Gradient-based parameter sensitivity (first-order |grad| and the Fisher
diagonal grad²), the JAX package's `sensitivity/gradient.py`:
`torch.autograd.grad` of the teacher-forced NLL over every floating leaf,
then mean(|g|^power) per leaf, averaged over the batches.

No kernel has a backward, so the loss runs the model's plain paths where a
gradient flows (`models.whisper.attention` sends the encoder attention to
its plain branch; the linears of a dense tree are `torch.matmul`).
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch

from ..config import WhisperArch
from ..models.params import (DEFAULT_DEVICE, copy_tree, named_leaves,
                             resolve_device, set_leaf)
from ..models.whisper import nll_loss
from ..prune.targeted import categorize, layer_index


def tree_device(params: Any) -> torch.device:
    return params["encoder"]["ln"]["g"].device


def _batch_stats(params: Any, arch: WhisperArch, mel, tokens, labels,
                 power: float) -> dict[str, torch.Tensor]:
    """{leaf name: mean(|d nll / d leaf|^power)} of one batch, 0-dim f32
    tensors on the tree's device (no host read)."""
    dev = tree_device(params)
    tree = copy_tree(params)
    leaves = {}
    for name, t in named_leaves(params):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            leaves[name] = t.detach().requires_grad_(True)
            set_leaf(tree, name, leaves[name])
    with torch.enable_grad():
        loss = nll_loss(tree, arch, torch.as_tensor(mel, device=dev),
                        torch.as_tensor(tokens, device=dev).long(),
                        torch.as_tensor(labels, device=dev).long())
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {name: (torch.zeros((), device=dev) if g is None
                   else torch.mean(g.to(torch.float32).abs() ** power))
            for name, g in zip(leaves, grads)}


def compute_sensitivity(params: Any, arch: WhisperArch, batches: Iterable[tuple],
                        power: float = 1.0) -> dict[str, float]:
    """power = 1: mean |grad| (the gradient test); power = 2: the Fisher
    diagonal proxy. batches: (mel, tokens, labels) triples (numpy or
    tensors). Returns {leaf name: score}, one host read a leaf a batch."""
    acc: dict[str, float] = {}
    n = 0
    for mel, tokens, labels in batches:
        for name, v in _batch_stats(params, arch, mel, tokens, labels, power).items():
            acc[name] = acc.get(name, 0.0) + float(v)
        n += 1
    return {k: v / max(n, 1) for k, v in acc.items()}


def compute_fisher_sensitivity(params: Any, arch: WhisperArch,
                               batches: Iterable[tuple]) -> dict[str, float]:
    """Fisher diagonal ~ E[grad²]."""
    return compute_sensitivity(params, arch, batches, power=2.0)


def normalize_scores(scores: dict[str, float]) -> dict[str, float]:
    """Importance normalised to [0, 1]."""
    vals = np.asarray(list(scores.values()))
    lo, hi = float(vals.min()), float(vals.max())
    rng = max(hi - lo, 1e-12)
    return {k: (v - lo) / rng for k, v in scores.items()}


def aggregate(scores: dict[str, float]) -> dict[str, Any]:
    """Means by component category and by (component, layer)."""
    by_cat: dict[str, list[float]] = {}
    by_layer: dict[tuple[str, int], list[float]] = {}
    for name, s in scores.items():
        by_cat.setdefault(categorize(name), []).append(s)
        li = layer_index(name)
        if li is not None:
            by_layer.setdefault((name.split(".")[0], li), []).append(s)
    return {
        "by_category": {k: float(np.mean(v)) for k, v in sorted(by_cat.items())},
        "by_layer": {f"{c}.{i}": float(np.mean(v))
                     for (c, i), v in sorted(by_layer.items())},
    }


def batches_from_dataset(arch: WhisperArch, dataset, tokenizer, batch: int = 2,
                         max_seq: int = 32,
                         device: str | torch.device = DEFAULT_DEVICE) -> list[tuple]:
    """(mel, tokens, labels) numpy batches from real utterances: the log-mel
    of each waveform (computed on `device`) and teacher-forced targets from
    its reference text, EOT-padded."""
    from ..audio import features
    from ..evaluation.harness import samples_for_arch

    device = resolve_device(device)
    n_samples = samples_for_arch(arch)
    out = []
    for i in range(0, len(dataset) - batch + 1, batch):
        utts = dataset[i: i + batch]
        wav = np.zeros((batch, n_samples), np.float32)
        toks = np.full((batch, max_seq), arch.eos_token_id, np.int32)
        labels = np.full((batch, max_seq), arch.eos_token_id, np.int32)
        for j, u in enumerate(utts):
            n = min(len(u.audio), n_samples)
            wav[j, :n] = u.audio[:n]
            ids = [arch.decoder_start_token_id] + tokenizer.encode(u.text)
            ids = ids[: max_seq + 1]
            toks[j, : len(ids) - 1] = ids[:-1]
            labels[j, : len(ids) - 1] = ids[1:]
        mel = features.preprocess(torch.from_numpy(wav).to(device),
                                  arch.num_mel_bins, length=n_samples)
        out.append((mel.cpu().numpy(), toks, labels))
    return out


def make_synthetic_batches(arch: WhisperArch, n_batches: int = 2, batch: int = 2,
                           seq: int = 8, seed: int = 0,
                           mel_frames: int | None = None) -> list[tuple]:
    """Random (mel, tokens, labels) numpy batches, the JAX package's draws
    from `np.random.default_rng(seed)`."""
    g = np.random.default_rng(seed)
    mel_frames = mel_frames or 2 * arch.max_source_positions
    out = []
    for _ in range(n_batches):
        mel = g.standard_normal((batch, arch.num_mel_bins, mel_frames)).astype(np.float32)
        toks = g.integers(0, arch.vocab_size, (batch, seq))
        labels = g.integers(0, arch.vocab_size, (batch, seq))
        out.append((mel, toks, labels))
    return out
