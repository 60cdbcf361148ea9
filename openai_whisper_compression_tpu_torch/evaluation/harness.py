"""End-to-end transcription entry point: waveform batch -> token ids.

The port of the JAX package's `evaluation/harness.py::make_transcribe_fn`:
log-mel frontend (fused mel kernel), encoder, then
`models.decode.greedy_decode`, or `beam_decode` when `cfg.beam_size > 1`.
PyTorch runs eagerly, so the returned function is plain Python around the
kernels, run under inference mode.
"""

from __future__ import annotations

import numpy as np
import torch

from ..audio import features
from ..config import HOP_LENGTH, DecodeConfig, WhisperArch
from ..models.decode import beam_decode, check_supported, greedy_decode
from ..models.whisper import encode


def samples_for_arch(arch: WhisperArch) -> int:
    """Waveform samples the encoder consumes: max_source_positions frames
    after the stride-2 conv (480_000 for the real Whisper family)."""
    return arch.max_source_positions * 2 * HOP_LENGTH


def make_transcribe_fn(arch: WhisperArch, cfg: DecodeConfig,
                       fast_mel: bool = False, fast_gelu: bool = False,
                       device: str | torch.device = "cpu",
                       token_logprobs: bool = False):
    """Build fn(params, wav) -> (tokens (B, L), lengths (B,)) running on
    `device`. fast_mel: bf16 DFT operands (f32 sums); fast_gelu:
    tanh-approximate GELU in the encoder MLPs; token_logprobs: append the
    greedy per-position logprob trace (B, L) to the outputs (greedy only).
    `params` must already live on `device`; `wav` (B, T) f32 may be a numpy
    array or a tensor anywhere."""
    if token_logprobs and cfg.beam_size > 1:
        raise ValueError("token_logprobs is only available for greedy "
                         "decoding (beam_size == 1)")
    check_supported(arch, cfg)
    device = torch.device(device)
    n_samples = samples_for_arch(arch)
    dft_dtype = torch.bfloat16 if fast_mel else torch.float32

    @torch.inference_mode()
    def fn(params, wav):
        if isinstance(wav, np.ndarray):
            wav = torch.from_numpy(wav)
        wav = wav.to(device=device, dtype=torch.float32)
        mel = features.preprocess(wav, n_mels=arch.num_mel_bins,
                                  length=n_samples, dft_dtype=dft_dtype)
        mel = mel.to(params["encoder"]["ln"]["g"].dtype)
        enc = encode(params, arch, mel, fast_gelu=fast_gelu)
        if cfg.beam_size > 1:
            return beam_decode(params, arch, enc, cfg)
        return greedy_decode(params, arch, enc, cfg,
                             return_token_logprobs=token_logprobs)

    return fn
