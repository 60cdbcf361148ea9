"""Analytic GFLOPs estimator for (pruned) Whisper inference.

Port of the JAX package's `prune/flops.py`, the reference's estimator
semantics (`unstructured_L1_baseline.py:100-177`): multiply-accumulate
counts from *non-zero* linear weights; the encoder runs its full
1500-frame context, the decoder is weighted by an assumed 25-token
generation; conv stem and attention score/value matmuls included.

One departure: a quantized linear counts as dense (K x N), as the JAX
module's `_nnz` intends. The JAX function tests `hasattr(leaf, "ndim")`
first, which its QTensor lacks, so it leaves every quantized linear out.
"""

from __future__ import annotations

from typing import Any

import torch

from ..config import WhisperArch
from ..models.params import named_leaves
from ..ops.qtensor import QTensor

DECODER_TOKENS_ASSUMED = 25  # reference assumption (:114)


def _nnz(leaf) -> int:
    if isinstance(leaf, QTensor):
        k, n = leaf.shape
        return k * n  # quantized weights are dense
    return int((leaf != 0).sum())


def _matrix(leaf) -> bool:
    return isinstance(leaf, QTensor) or (isinstance(leaf, torch.Tensor)
                                         and leaf.dim() == 2)


def model_gflops(params: Any, arch: WhisperArch,
                 decoder_tokens: int = DECODER_TOKENS_ASSUMED) -> dict[str, float]:
    enc_t = arch.max_source_positions          # 1500
    mel_t = 2 * enc_t                          # 3000
    flops_enc = 0.0
    flops_dec = 0.0

    for n, l in named_leaves(params):
        if n.endswith(".b") or n.endswith(".g") or l is None:
            continue
        if n.startswith("encoder.conv1"):
            flops_enc += 2.0 * _nnz(l) * mel_t
        elif n.startswith("encoder.conv2"):
            flops_enc += 2.0 * _nnz(l) * enc_t
        elif n == "decoder.embed":
            # tied proj_out matmul per generated token
            flops_dec += 2.0 * _nnz(l) * decoder_tokens
        elif n.endswith(".pos"):
            continue
        elif n.startswith("encoder.") and _matrix(l):
            flops_enc += 2.0 * _nnz(l) * enc_t
        elif n.startswith("decoder.") and _matrix(l):
            flops_dec += 2.0 * _nnz(l) * decoder_tokens

    # attention score/value matmuls (dense, from shapes)
    def width(attn: dict) -> int:   # heads x head_dim of q (fused qkv: a third)
        return attn["q"]["w"].shape[1] if "q" in attn else attn["qkv"]["w"].shape[1] // 3

    for layer in params["encoder"]["layers"]:
        flops_enc += 2.0 * 2 * enc_t * enc_t * width(layer["attn"])
    for layer in params["decoder"]["layers"]:
        flops_dec += 2.0 * 2 * decoder_tokens * decoder_tokens * width(layer["attn"])
        flops_dec += 2.0 * 2 * decoder_tokens * enc_t * width(layer["cross"])

    total = flops_enc + flops_dec
    return {"encoder_gflops": flops_enc / 1e9,
            "decoder_gflops": flops_dec / 1e9,
            "total_gflops": total / 1e9}
