"""Fused log-mel kernel (`csrc/mel.cu`): windowed DFT -> power -> mel ->
log10 in one pass, the port of the JAX package's
`audio/mel_pallas.py::log_mel_pallas`. Its plain version is
`features.mel_log10_ref`."""

from __future__ import annotations

import torch

from ..ops import kernels
from .features import finish_log_mel, frame_waveform, mel_log10_ref, torch_bases


def log_mel_cuda(wav: torch.Tensor, n_mels: int = 80,
                 dft_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Waveform (B, T) -> log-mel (B, n_mels, T // 160), the output of
    `features.log_mel`. On a CUDA tensor the DFT/power/mel/log10 core runs
    in the kernel (counted in `log_mel_cuda.launches`); on a CPU tensor it
    runs the plain version."""
    frames = frame_waveform(wav)                      # (B, F, N_FFT) view
    if not wav.is_cuda:
        return finish_log_mel(mel_log10_ref(frames, n_mels, dft_dtype))
    name = "log_mel_cuda"
    kernels.require(wav.dim() == 2, name, f"wav must be (B, T), got {tuple(wav.shape)}")
    kernels.require(dft_dtype in (torch.float32, torch.bfloat16), name,
                    f"the DFT runs in float32 or bfloat16, got {dft_dtype}")
    b, n_frames, _ = frames.shape
    frames = frames.to(dft_dtype).contiguous()
    cos_b, sin_b, mel_fb = torch_bases(n_mels, dft_dtype, wav.device)
    n_freq = cos_b.shape[1]
    code = kernels.dtype_code(frames, name)
    rows = b * n_frames
    out = torch.empty((rows, n_mels), dtype=torch.float32, device=wav.device)
    err = kernels.lib().owc_mel_log10(
        frames.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(),
        mel_fb.data_ptr(), out.data_ptr(), rows, n_freq, n_mels, code,
        kernels.stream_of(frames))
    kernels.check(name, err)
    log_mel_cuda.launches += 1
    return finish_log_mel(out.reshape(b, n_frames, n_mels))


log_mel_cuda.launches = 0
