"""Quantization API: `params -> params'` with every linear weight quantized.

Ported: `quantize_params(method="int8")` with the JAX package's
`LINEAR_WEIGHT_RE` (attention q/k/v/o and FFN weights; conv stem,
layernorms, biases, positions and the embedding stay dense).
"""

from __future__ import annotations

import re
from typing import Any

from ..models.params import copy_tree, named_leaves, set_leaf
from ..ops.qtensor import QTensor
from .core import QUANTIZERS

LINEAR_WEIGHT_RE = re.compile(
    r"\.(attn|cross)\.(q|k|v|o)\.w$|\.fc[12]\.w$")


def quantize_params(params: Any, method: str = "int8") -> Any:
    """Quantize every linear weight with QUANTIZERS[method] (weight-only;
    activation and embedding quantization are not in the port yet)."""
    if method not in QUANTIZERS:
        raise NotImplementedError(
            f"quant method {method!r}: the port carries {sorted(QUANTIZERS)}")
    quantizer = QUANTIZERS[method]
    out = copy_tree(params)
    for name, leaf in named_leaves(params):
        if isinstance(leaf, QTensor) or not LINEAR_WEIGHT_RE.search(name):
            continue
        set_leaf(out, name, quantizer(leaf))
    return out
