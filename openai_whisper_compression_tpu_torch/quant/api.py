"""Quantization API: `params -> params'` with every linear weight quantized,
and the named configurations of the JAX package's `quant/api.py` REGISTRY:
all 22 (baselines and fp16 casts, quanto int2/4/8, HQQ int3/4/8, the five
bitsandbytes NF4/FP4 ones, `pytorch_dynamic_int8`, the static matrix of
{int4, int8, fp8} weights x {int8, fp8} activations, `static_fp8`), with the
JAX package's `LINEAR_WEIGHT_RE` (attention q/k/v/o and FFN weights; conv
stem, layernorms, biases, positions stay dense, and the embedding too
unless `include_embed`), and the data-aware methods that need a
calibration callable (`DATA_AWARE`, `quantize_data_aware`: GPTQ in
`quant.gptq`, SmoothQuant and AWQ in `quant.smooth`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable

import torch

from ..models.params import copy_tree, named_leaves, set_leaf, tree_cast
from ..ops.qtensor import QTensor, dequantize
from . import calibrate
from .core import QUANTIZERS

LINEAR_WEIGHT_RE = re.compile(
    r"\.(attn|cross)\.(q|k|v|o)\.w$|\.fc[12]\.w$")
EMBED_RE = re.compile(r"^decoder\.embed$")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    name: str
    method: str | None          # None = no weight quant (dtype cast only)
    act: str | None = None
    dtype: str | None = None    # cast the model to this dtype first
    needs_calibration: bool = False
    kwargs: tuple = ()          # (name, value) pairs for the quantizer

    def apply(self, params: Any) -> Any:
        p = tree_cast(params, getattr(torch, self.dtype)) if self.dtype else params
        if self.method:
            p = quantize_params(p, self.method, act=self.act, **dict(self.kwargs))
        return p


REGISTRY: dict[str, QuantConfig] = {c.name: c for c in [
    # the JAX package's REGISTRY, in its order
    QuantConfig("baseline_fp32", None, dtype="float32"),
    QuantConfig("baseline_bf16", None, dtype="bfloat16"),
    QuantConfig("fp16", None, dtype="float16"),
    QuantConfig("pytorch_dynamic_int8", "int8", act="dynamic_int8"),
    QuantConfig("quanto_int2", "int2"),
    QuantConfig("quanto_int4", "int4"),
    QuantConfig("quanto_int8", "int8"),
    QuantConfig("hqq_int3", "hqq_int3"),
    QuantConfig("hqq_int4", "hqq_int4"),
    QuantConfig("hqq_int8", "hqq_int8"),
    QuantConfig("static_int8_act_int8", "int8", act="static_int8",
                needs_calibration=True),
    QuantConfig("static_int4_act_int8", "int4", act="static_int8",
                needs_calibration=True),
    QuantConfig("static_int8_act_fp8", "int8", act="static_fp8",
                needs_calibration=True),
    QuantConfig("static_int4_act_fp8", "int4", act="static_fp8",
                needs_calibration=True),
    QuantConfig("static_fp8_act_int8", "fp8", act="static_int8",
                needs_calibration=True),
    QuantConfig("static_fp8_act_fp8", "fp8", act="static_fp8",
                needs_calibration=True),
    QuantConfig("static_fp8", "fp8"),
    QuantConfig("bnb_fp4", "fp4"),
    QuantConfig("bnb_fp4_double_quant", "fp4_dq"),
    QuantConfig("bnb_nf4", "nf4"),
    QuantConfig("bnb_nf4_double_quant", "nf4_dq"),
    QuantConfig("bnb_nf4_bf16_compute", "nf4_dq", dtype="bfloat16"),
]}


def quantize_params(params: Any, method: str = "int8", act: str | None = None,
                    include_embed: bool = False,
                    name_filter: Callable[[str], bool] | None = None,
                    **kw: Any) -> Any:
    """Quantize every linear weight with QUANTIZERS[method](w, **kw).

    act: None, "dynamic_int8", "static_int8" or "static_fp8": the activation
    mode written into every quantized linear weight. include_embed: also
    quantize `decoder.embed` in its (V, d) orientation, without an
    activation mode (`models.whisper.embed_tokens` / `project_out`
    dequantize it). name_filter: an optional predicate on dotted leaf names
    that restricts the scope.

    `method` may also be a REGISTRY name: the named configuration's dtype
    cast, then its quantizer and activation mode, with `act`, `name_filter`
    and `kw` still honoured on the quantizing step."""
    if method not in QUANTIZERS and method in REGISTRY:
        cfg = REGISTRY[method]
        p = tree_cast(params, getattr(torch, cfg.dtype)) if cfg.dtype else params
        if not cfg.method:
            return p
        return quantize_params(p, cfg.method,
                               act=act if act is not None else cfg.act,
                               include_embed=include_embed,
                               name_filter=name_filter,
                               **{**dict(cfg.kwargs), **kw})
    if method not in QUANTIZERS:
        raise KeyError(f"unknown quant method {method!r}; quantizers: "
                       f"{sorted(QUANTIZERS)}; named configs: {sorted(REGISTRY)}")
    quantizer = QUANTIZERS[method]
    out = copy_tree(params)
    for name, leaf in named_leaves(params):
        if isinstance(leaf, QTensor):
            continue
        is_linear = bool(LINEAR_WEIGHT_RE.search(name))
        if not (is_linear or (include_embed and EMBED_RE.match(name))):
            continue
        if name_filter is not None and not name_filter(name):
            continue
        q = quantizer(leaf, **kw)
        set_leaf(out, name, dataclasses.replace(q, act=act)
                 if act is not None and is_linear else q)
    return out


def apply_named_config(params: Any, name: str) -> Any:
    return REGISTRY[name].apply(params)


def dequantize_params(params: Any, dtype=torch.float32) -> Any:
    """Every QTensor back to a dense tensor in `dtype`: the quantization
    error baked in, plain storage (activation modes are dropped with the
    QTensors)."""
    if isinstance(params, dict):
        return {k: dequantize_params(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [dequantize_params(v, dtype) for v in params]
    return dequantize(params, dtype) if isinstance(params, QTensor) else params


def calibrate_static(params: Any, run_fn: Callable[[Any], None]) -> Any:
    """Static-quant calibration: `run_fn(params)` runs representative
    batches through the model; returns params with the observed activation
    scales frozen into every "static_int8" / "static_fp8" QTensor."""
    with calibrate.calibration() as store:
        run_fn(params)
    return calibrate.freeze(params, store)


# ---------------------------------------------------------------------------
# Data-aware methods (a calibration callable, not just the weights): GPTQ,
# SmoothQuant, AWQ, as in the JAX package's DATA_AWARE
# ---------------------------------------------------------------------------

def _da_gptq(bits: int):
    def f(params, arch, run_cal):
        from .gptq import gptq_quantize_params

        return gptq_quantize_params(params, run_cal, bits=bits)
    return f


def _da_smooth(method: str, act: str | None = None, alpha: float = 0.5):
    def f(params, arch, run_cal):
        from .smooth import smoothquant_params

        return quantize_params(smoothquant_params(params, arch, run_cal, alpha=alpha),
                               method, act=act)
    return f


def _da_awq(method: str):
    def f(params, arch, run_cal):
        from .smooth import awq_quantize_params

        return awq_quantize_params(params, arch, run_cal, method=method)
    return f


DATA_AWARE: dict[str, Callable[..., Any]] = {
    "gptq_int2": _da_gptq(2),
    "gptq_int4": _da_gptq(4),
    "gptq_int8": _da_gptq(8),
    "smoothquant_int4": _da_smooth("int4"),
    "smoothquant_int8": _da_smooth("int8"),
    "smoothquant_w8a8": _da_smooth("int8", act="dynamic_int8"),
    "awq_int4": _da_awq("int4"),
    "awq_nf4": _da_awq("nf4"),
}


def quantize_data_aware(params: Any, arch: Any, name: str,
                        run_calibration: Callable[[Any], Any]) -> Any:
    """Apply DATA_AWARE[name]. `run_calibration(params)` must drive full
    teacher-forced forwards on params' device
    (`evaluation.harness.make_calibration_fn` builds one)."""
    try:
        fn = DATA_AWARE[name]
    except KeyError:
        raise KeyError(f"unknown data-aware config {name!r}; "
                       f"have {sorted(DATA_AWARE)}") from None
    return fn(params, arch, run_calibration)
