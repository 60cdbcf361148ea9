"""Quantization API: `params -> params'` with every linear weight quantized,
and the named configurations of the JAX package's `quant/api.py` REGISTRY.

Ported: the weight-only configurations (baselines and fp16 casts,
quanto int2/4/8, HQQ int3/4/8, the five bitsandbytes NF4/FP4 ones) with the
JAX package's `LINEAR_WEIGHT_RE` (attention q/k/v/o and FFN weights; conv
stem, layernorms, biases, positions and the embedding stay dense). The
configurations with activation quantization or fp8 weights come with the
w8a8 kernel (a later slice) and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch

from ..models.params import copy_tree, named_leaves, set_leaf, tree_cast
from ..ops.qtensor import QTensor
from .core import QUANTIZERS

LINEAR_WEIGHT_RE = re.compile(
    r"\.(attn|cross)\.(q|k|v|o)\.w$|\.fc[12]\.w$")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    name: str
    method: str | None          # None = no weight quant (dtype cast only)
    act: str | None = None
    dtype: str | None = None    # cast the model to this dtype first

    @property
    def ported(self) -> bool:
        return self.act is None and self.method != "fp8"


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
    QuantConfig("static_int8_act_int8", "int8", act="static_int8"),
    QuantConfig("static_int4_act_int8", "int4", act="static_int8"),
    QuantConfig("static_int8_act_fp8", "int8", act="static_fp8"),
    QuantConfig("static_int4_act_fp8", "int4", act="static_fp8"),
    QuantConfig("static_fp8_act_int8", "fp8", act="static_int8"),
    QuantConfig("static_fp8_act_fp8", "fp8", act="static_fp8"),
    QuantConfig("static_fp8", "fp8"),
    QuantConfig("bnb_fp4", "fp4"),
    QuantConfig("bnb_fp4_double_quant", "fp4_dq"),
    QuantConfig("bnb_nf4", "nf4"),
    QuantConfig("bnb_nf4_double_quant", "nf4_dq"),
    QuantConfig("bnb_nf4_bf16_compute", "nf4_dq", dtype="bfloat16"),
]}


def quantize_params(params: Any, method: str = "int8") -> Any:
    """Quantize every linear weight with QUANTIZERS[method] (weight-only).
    `method` may also be a REGISTRY name: the named configuration's dtype
    cast, then its quantizer."""
    if method not in QUANTIZERS and method in REGISTRY:
        cfg = REGISTRY[method]
        if not cfg.ported:
            raise NotImplementedError(
                f"quant config {method!r} (activations {cfg.act}, weights "
                f"{cfg.method}): activation and fp8 quantization come with "
                "the w8a8 kernel, a later slice of the port")
        p = tree_cast(params, getattr(torch, cfg.dtype)) if cfg.dtype else params
        return quantize_params(p, cfg.method) if cfg.method else p
    if method not in QUANTIZERS:
        raise NotImplementedError(
            f"quant method {method!r}: the port carries {sorted(QUANTIZERS)} "
            f"and the named configs {sorted(REGISTRY)}")
    quantizer = QUANTIZERS[method]
    out = copy_tree(params)
    for name, leaf in named_leaves(params):
        if isinstance(leaf, QTensor) or not LINEAR_WEIGHT_RE.search(name):
            continue
        set_leaf(out, name, quantizer(leaf))
    return out
