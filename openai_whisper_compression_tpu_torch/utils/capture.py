"""Activation capture for eager calibration: the JAX package's
`utils/capture.py`.

Model code calls `record(tag, value)` at its taps (the MLP's post-GELU
activations, the layer norms' outputs of encoder and decoder layers); it is
a no-op unless a `capturing()` context is active, so the decode paths pay
one context-variable read a tap. Inside the context each call appends the
value's statistics to the context's list: three scalars read back to the
host (mean |v|, max |v|, the fraction above 1e-6), and, left on the value's
device, the per-unit (last axis) mean and max of |v| and a strided
subsample of at most 64 of its rows, the same rows as the JAX package's.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_STORE: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "capture", default=None)

ROWS = 64  # rows of the flattened (tokens, channels) view kept a record


def record(tag: str, value: torch.Tensor) -> None:
    store = _STORE.get()
    if store is None:
        return
    with torch.no_grad():
        a = value.detach().to(torch.float32).abs()
        lead = tuple(range(a.dim() - 1))
        store.append({
            "tag": tag,
            "index": len(store),
            "mean_abs": float(a.mean()),
            "max_abs": float(a.max()),
            "frac_active": float((a > 1e-6).to(torch.float32).mean()),
            # per hidden unit: activation-guided FFN pruning
            "per_unit_mean_abs": a.mean(dim=lead),
            # per channel: the SmoothQuant / AWQ smoothing scales
            "per_unit_max_abs": a.amax(dim=lead),
            # strided, not the first rows: the first frames of an utterance
            # are often near-silence (AWQ's search evaluates on these rows)
            "rows": _subsample_rows(
                value.detach().to(torch.float32).reshape(-1, value.shape[-1]), ROWS),
        })


def _subsample_rows(x2: torch.Tensor, cap: int) -> torch.Tensor:
    stride = max(1, x2.shape[0] // cap)
    return x2[::stride][:cap]


def active() -> bool:
    return _STORE.get() is not None


@contextlib.contextmanager
def capturing():
    store: list = []
    token = _STORE.set(store)
    try:
        yield store
    finally:
        _STORE.reset(token)
