"""Compression-accuracy agreement harness.

Port of the JAX package's `evaluation/agreement.py`. With no pretrained
weights or labelled data at hand, a WER delta cannot be measured directly;
this measures how faithfully a compressed model tracks its uncompressed
baseline on shared inputs: greedy-token agreement, top-1 logit agreement,
mean KL of the output distributions and the logits' relative error. A
compressed model with ~100% token agreement is WER-neutral by construction.
(No reference counterpart: the reference re-evaluates WER on LibriSpeech,
`quantization.py:149-208`.)

The JAX module jits encode, teacher-forced logits and greedy decode; here
they run eagerly under `torch.inference_mode()`, on the device the mels and
trees live on.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..config import DecodeConfig, WhisperArch
from ..models import decode
from ..models.whisper import decode_logits, encode


@torch.inference_mode()
def model_agreement(base_params: Any, comp_params: Any, arch: WhisperArch,
                    mels: torch.Tensor, decode_cfg: DecodeConfig | None = None,
                    teacher_tokens: torch.Tensor | None = None,
                    comp_cfg: DecodeConfig | None = None) -> dict[str, float]:
    """-> {token_agreement, top1_agreement, mean_kl, logit_rel_err}.

    comp_cfg: optional decode config for the COMPRESSED side only, to score
    decode-time lossy knobs (encoder token merging, `models/merge.py`)
    against the dense, unmerged baseline decode."""
    decode_cfg = decode_cfg or DecodeConfig(
        max_new_tokens=16, language_token_id=None, task_token_id=None,
        notimestamps=False)
    comp_cfg = comp_cfg or decode_cfg

    enc_b = encode(base_params, arch, mels)
    enc_c = encode(comp_params, arch, mels)
    # teacher-forced comp logits must see the same merged sequence the comp
    # decode attends to (greedy_decode merges internally from cfg)
    enc_c_tf = enc_c
    if comp_cfg.cross_kv_pool > 1 or comp_cfg.cross_kv_merge > 0:
        from ..models.merge import merge_encoder_tokens

        enc_c_tf = merge_encoder_tokens(enc_c, pool=comp_cfg.cross_kv_pool,
                                        merge_r=comp_cfg.cross_kv_merge)

    t_b, l_b = decode.greedy_decode(base_params, arch, enc_b, decode_cfg)
    t_c, l_c = decode.greedy_decode(comp_params, arch, enc_c, comp_cfg)
    t_b, t_c = t_b.cpu().numpy(), t_c.cpu().numpy()
    l_b, l_c = l_b.cpu().numpy(), l_c.cpu().numpy()
    agree = []
    for i in range(t_b.shape[0]):
        n = int(min(l_b[i], l_c[i]))
        agree.append(float(np.mean(t_b[i, :n] == t_c[i, :n])))
    token_agreement = float(np.mean(agree))

    if teacher_tokens is None:
        width = min(8, t_b.shape[1])
        teacher_tokens = torch.from_numpy(t_b[:, :width].copy())
    teacher_tokens = teacher_tokens.to(mels.device, torch.long)
    lg_b = decode_logits(base_params, arch, teacher_tokens, enc_b).float()
    lg_c = decode_logits(comp_params, arch, teacher_tokens, enc_c_tf).float()
    p = torch.log_softmax(lg_b, dim=-1)
    q = torch.log_softmax(lg_c, dim=-1)
    kl = torch.sum(torch.exp(p) * (p - q), dim=-1)
    top1 = (lg_b.argmax(-1) == lg_c.argmax(-1)).float().mean()
    rel = torch.linalg.vector_norm(lg_b - lg_c) / torch.linalg.vector_norm(lg_b)
    return {
        "token_agreement": token_agreement,
        "top1_agreement": float(top1),
        "mean_kl": float(kl.mean()),
        "logit_rel_err": float(rel),
    }
