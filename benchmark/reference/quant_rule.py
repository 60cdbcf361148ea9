"""The weight quantization rule of the configurations, frozen here.

Per-output-channel symmetric integers (optimum-quanto's qint8 / qint4): for a
linear weight w (in, out) in f32, scale = max(absmax over the input axis x
f32(1 / qmax), 1e-12) and codes = clip(round_half_even(w / scale), -qmax,
qmax), with qmax 127 for 8 bits and 7 for 4. The dequantized weight is
codes x scale. Which weights: every attention q, k, v and o weight (self and
cross) and both feed-forward weights; conv stem, embeddings, positions,
layer norms and biases stay as they are.
"""

from __future__ import annotations

import re

import torch

LINEAR_WEIGHT_RE = re.compile(r"\.(attn|cross)\.(q|k|v|o)\.w$|\.fc[12]\.w$")


def fake_quant(w: torch.Tensor, bits: int) -> torch.Tensor:
    """w rounded to its per-channel `bits`-bit grid, in f32."""
    qmax = {8: 127.0, 4: 7.0}[bits]
    w = w.to(torch.float32)
    inv = torch.tensor(1.0 / qmax, dtype=torch.float32)
    scale = torch.clamp(w.abs().amax(dim=0, keepdim=True) * inv.to(w.device), min=1e-12)
    return torch.clamp(torch.round(w / scale), -qmax, qmax) * scale


def is_quantized(path: str) -> bool:
    return bool(LINEAR_WEIGHT_RE.search(path))
