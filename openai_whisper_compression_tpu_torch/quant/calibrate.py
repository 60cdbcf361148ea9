"""Static activation-quant calibration: the JAX package's
`quant/calibrate.py`.

Representative batches run through the model while a context records the
input absmax of every quantized linear (`ops.linear` calls `observe`); the
maxima are then frozen into per-tensor activation scales. A QTensor is
keyed by its identity, so the pass must run on the very tree that `freeze`
is given.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

import torch

from ..ops.qtensor import FP8_MAX, QTensor

_CALIB: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "calibration", default=None)


def observe(q: QTensor, x: torch.Tensor) -> None:
    """Record max|x| for q (called by `ops.linear` for every quantized
    matmul with an activation mode while a calibration is active). The
    maximum of a bf16 tensor is exact in f32, so reducing in x's dtype
    gives what reducing its f32 copy would."""
    store = _CALIB.get()
    if store is None:
        return
    store[id(q)] = max(store.get(id(q), 0.0), float(x.abs().max()))


def active() -> bool:
    return _CALIB.get() is not None


@contextlib.contextmanager
def calibration():
    """Context manager collecting the activation absmax per QTensor."""
    store: dict[int, float] = {}
    token = _CALIB.set(store)
    try:
        yield store
    finally:
        _CALIB.reset(token)


def freeze(params: Any, store: dict[int, float]) -> Any:
    """Params with the observed activation scales written into each
    calibrated QTensor as a 0-dim f32 `act_scale` on the weight's device:
    absmax / 127 for "static_int8", absmax / 448 for "static_fp8" (the
    quotient taken in double precision and rounded once, as JAX's). A
    QTensor never observed (a layer that did not run), or one that saw only
    zeros, keeps its dynamic behaviour."""
    if isinstance(params, dict):
        return {k: freeze(v, store) for k, v in params.items()}
    if isinstance(params, list):
        return [freeze(v, store) for v in params]
    if isinstance(params, QTensor) and params.act in ("static_int8", "static_fp8"):
        amax = store.get(id(params))
        if amax is not None and amax > 0:
            div = 127.0 if params.act == "static_int8" else FP8_MAX
            return dataclasses.replace(params, act_scale=torch.tensor(
                amax / div, dtype=torch.float32, device=params.data.device))
    return params
