"""Unstructured pruning: global/per-module L1, random, 4x4 block-structured,
the positional-table pruners, and the sparsity reports.

Port of the JAX package's `prune/magnitude.py` (itself the reference's
`torch.nn.utils.prune` usage made a pure tensor transform: masks are made
permanent at once). Every transform returns a new tree: its dict/list
structure is copied (`copy_tree`), each pruned leaf is a new tensor built
on the leaf's own device, and no input tensor is written. Magnitudes,
norms and thresholds are taken in f32, as in JAX, so an L1 threshold is the
same sorted f32 value bit for bit. QTensor leaves are skipped.

Unstructured sparsity does not speed up a dense matmul; it serves
accuracy-vs-sparsity studies and compressed storage. The structured
variants that physically shrink matmuls live in `prune.structured`.
"""

from __future__ import annotations

import re
from typing import Any, Callable

import torch

from ..models.params import copy_tree, named_leaves, set_leaf
from ..ops.qtensor import QTensor

# Default scope = every linear weight (reference global L1 targets all
# nn.Linear, `unstructured_L1_baseline.py:465-500`).
LINEAR_RE = re.compile(r"\.(attn|cross)\.(q|k|v|o)\.w$|\.fc[12]\.w$")


def linear_weights(name: str) -> bool:
    return bool(LINEAR_RE.search(name))


def _targets(params: Any, name_filter: Callable[[str], bool]) -> list[tuple[str, torch.Tensor]]:
    return [(n, l) for n, l in named_leaves(params)
            if not isinstance(l, QTensor) and name_filter(n)]


def _mask_below(leaf: torch.Tensor, thresh) -> torch.Tensor:
    """A new tensor: `leaf` where |leaf| (in f32) exceeds `thresh`, else 0."""
    return torch.where(leaf.float().abs() > thresh, leaf,
                       torch.zeros((), dtype=leaf.dtype, device=leaf.device))


def _kth_smallest(values: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th smallest (1-based) of a flat f32 tensor: sorted[k - 1]."""
    return torch.sort(values).values[max(k - 1, 0)]


def _l1_prune_leaf(leaf: torch.Tensor, k: int) -> torch.Tensor:
    return _mask_below(leaf, _kth_smallest(leaf.float().abs().reshape(-1), k))


def prune_global_l1(params: Any, amount: float,
                    name_filter: Callable[[str], bool] = linear_weights) -> Any:
    """Global magnitude pruning: one |w| threshold across all target leaves
    (≈ `prune.global_unstructured(..., L1Unstructured)`)."""
    targets = _targets(params, name_filter)
    if not targets or amount <= 0:
        return params
    total = sum(l.numel() for _, l in targets)
    k = int(round(amount * total))
    if k <= 0:
        return params
    dev = targets[0][1].device
    thresh = _kth_smallest(torch.cat([l.float().abs().reshape(-1).to(dev)
                                      for _, l in targets]), k)
    out = copy_tree(params)
    for n, l in targets:
        set_leaf(out, n, _mask_below(l, thresh.to(l.device)))
    return out


def prune_per_module_l1(params: Any, amount: float,
                        name_filter: Callable[[str], bool] = linear_weights,
                        amounts: dict[str, float] | None = None) -> Any:
    """Per-leaf L1 pruning (≈ `prune.l1_unstructured` per module). `amounts`
    optionally maps leaf name -> rate (the recipe engine feeds this)."""
    out = copy_tree(params)
    for n, l in _targets(params, name_filter):
        a = amounts.get(n, amount) if amounts else amount
        k = int(round(a * l.numel()))
        if a <= 0 or k <= 0:
            continue
        set_leaf(out, n, _l1_prune_leaf(l, k))
    return out


def prune_random(params: Any, amount: float, seed: int = 0,
                 name_filter: Callable[[str], bool] = linear_weights) -> Any:
    """Random unstructured pruning (≈ `prune.RandomUnstructured`): each
    target entry is kept where a uniform draw is >= `amount`. The draws come
    from one `torch.Generator` seeded with `seed` per device, taken leaf by
    leaf in tree order, so one seed gives one result; they are not the JAX
    package's draws."""
    out = copy_tree(params)
    gens: dict = {}
    for n, l in _targets(params, name_filter):
        if l.device not in gens:
            gens[l.device] = torch.Generator(device=l.device).manual_seed(seed)
        keep = torch.rand(l.shape, generator=gens[l.device], device=l.device) >= amount
        set_leaf(out, n, torch.where(keep, l, torch.zeros((), dtype=l.dtype,
                                                          device=l.device)))
    return out


def prune_blocks(params: Any, amount: float, block: tuple[int, int] = (4, 4),
                 name_filter: Callable[[str], bool] = linear_weights) -> Any:
    """Block-structured pruning: zero the lowest-Frobenius-norm (bh, bw)
    blocks per weight (≈ reference 4x4 block pruning,
    `experimental_pruning.py:1334-1425`)."""
    bh, bw = block
    out = copy_tree(params)
    for n, l in _targets(params, name_filter):
        if l.dim() != 2 or l.shape[0] % bh or l.shape[1] % bw:
            continue
        k = int(round(amount * (l.numel() // (bh * bw))))
        if k <= 0:
            continue
        r, c = l.shape
        blocks = l.reshape(r // bh, bh, c // bw, bw)
        norms = blocks.float().square().sum(dim=(1, 3)).sqrt()
        mask = (norms > _kth_smallest(norms.reshape(-1), k))[:, None, :, None]
        set_leaf(out, n, (blocks * mask).reshape(r, c).to(l.dtype))
    return out


def _rows_at_rates(pos: torch.Tensor, rates: torch.Tensor) -> torch.Tensor:
    """Per-row magnitude pruning of a (T, d) table at per-row `rates` (f32):
    row t keeps the entries above its k_t-th smallest magnitude,
    k_t = clip(round(rates[t] * d), 0, d - 1), and all of them where k_t = 0."""
    d = pos.shape[1]
    mags = pos.float().abs()
    sorted_mags = torch.sort(mags, dim=1).values
    k = torch.clamp(torch.round(rates * d).to(torch.int64), 0, d - 1)
    thresh = torch.gather(sorted_mags, 1, k[:, None])
    keep = (mags > thresh) | (k == 0)[:, None]
    return torch.where(keep, pos, torch.zeros((), dtype=pos.dtype, device=pos.device))


def _ramp(t: int, device) -> torch.Tensor:
    """f32 (i / (t - 1)) for i < t, the last exactly 1: `jnp.linspace(0, 1,
    t)` as JAX computes it."""
    if t == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    return torch.arange(t, dtype=torch.float32, device=device) / float(t - 1)


def prune_positional_progressive(params: Any, max_amount: float = 0.5) -> Any:
    """Position-dependent pruning of the learned decoder positions: later
    (rarely used) positions pruned harder, ramping linearly from 0 to
    `max_amount` (`experimental_pruning.py:1100-1186`)."""
    out = copy_tree(params)
    pos = params["decoder"]["pos"]
    rates = _ramp(pos.shape[0], pos.device) * torch.tensor(
        max_amount, dtype=torch.float32, device=pos.device)
    out["decoder"]["pos"] = _rows_at_rates(pos, rates)
    return out


def _position_rates(t: int, early: float, late: float, device) -> torch.Tensor:
    """First third of positions at `early`, last third at `late`, linear in
    the middle third, in f32 as JAX computes it (reference schedule,
    `experimental_pruning.py:1139-1161`)."""
    lo, hi = t // 3, 2 * t // 3
    idx = torch.arange(t, device=device)
    frac = torch.clamp((idx - lo).to(torch.float32) / float(max(hi - lo, 1)), 0.0, 1.0)
    e = torch.tensor(early, dtype=torch.float32, device=device)
    la = torch.tensor(late, dtype=torch.float32, device=device)
    return torch.where(idx < lo, e, torch.where(idx >= hi, la, e + frac * (la - e)))


def prune_positional_position_dependent(params: Any, early: float = 0.4,
                                        late: float = 0.2) -> Any:
    """Reference-parity position-dependent embedding pruning
    (`custom_position_based_pruning`, `experimental_pruning.py:1100-1186`):
    EARLY positions pruned harder (`early`), late positions lighter
    (`late`), linear ramp across the middle third. Applied to every
    positional table (encoder sinusoids included, as the reference hits
    every `embed_positions` module)."""
    out = copy_tree(params)
    for comp in ("encoder", "decoder"):
        if "pos" in out[comp]:
            pos = params[comp]["pos"]
            out[comp]["pos"] = _rows_at_rates(
                pos, _position_rates(pos.shape[0], early, late, pos.device))
    return out


# ---------------------------------------------------------------------------
# Reporting (≈ reference `calculate_sparsity` `unstructured_L1_baseline.py:534`
# and `calculate_pruned_dense_size` :31-97)
# ---------------------------------------------------------------------------

def _count_zeros(leaf: torch.Tensor) -> int:
    return int((leaf == 0).sum())


def sparsity_report(params: Any,
                    name_filter: Callable[[str], bool] | None = None) -> dict:
    per_leaf: dict[str, dict] = {}
    total = zeros = 0
    weights_total = weights_zeros = 0
    bias_total = bias_zeros = 0
    for n, l in named_leaves(params):
        if isinstance(l, QTensor):
            continue
        if name_filter is not None and not name_filter(n):
            continue
        z = _count_zeros(l)
        s = l.numel()
        per_leaf[n] = {"sparsity": z / max(s, 1), "zeros": z, "size": s}
        total += s
        zeros += z
        if n.endswith(".b") or n.endswith("_ln.g") or n.endswith("_ln.b"):
            bias_total += s
            bias_zeros += z
        else:
            weights_total += s
            weights_zeros += z
    nnz = total - zeros
    return {
        "overall_sparsity": zeros / max(total, 1),
        "weight_sparsity": weights_zeros / max(weights_total, 1),
        "bias_sparsity": bias_zeros / max(bias_total, 1),
        "total_params": total,
        "nonzero_params": nnz,
        "theoretical_dense_pruned_mb": nnz * 4 / (1024 ** 2),
        "per_leaf": per_leaf,
    }


def component_sparsity(params: Any) -> dict[str, float]:
    """Sparsity rolled up by component category (≈ the component-sparsity
    reporter at `experimental_pruning.py:603`)."""
    from .targeted import categorize

    agg: dict[str, list[int]] = {}
    for n, l in named_leaves(params):
        if isinstance(l, QTensor):
            continue
        cat = categorize(n)
        z, s = _count_zeros(l), l.numel()
        tz, ts = agg.setdefault(cat, [0, 0])
        agg[cat] = [tz + z, ts + s]
    return {c: z / max(s, 1) for c, (z, s) in sorted(agg.items())}
