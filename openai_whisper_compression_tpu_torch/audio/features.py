"""Whisper log-mel frontend: pad/trim -> framed STFT -> mel -> log.

The recipe of the JAX package's `audio/features.py` (HF
`WhisperFeatureExtractor`: periodic hann(400), hop 160, power spectrum,
slaney mel filterbank, log10, per-utterance clamp to max-8, (x+4)/4), with
the STFT written as products against windowed cos/sin DFT bases.
`log_mel` is the plain PyTorch pipeline; `preprocess` runs the fused CUDA
kernel through `audio.mel_kernel.log_mel_cuda`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import HOP_LENGTH, N_FFT, N_SAMPLES, SAMPLE_RATE


def hann_window_periodic(n: int) -> np.ndarray:
    """Periodic Hann window (HF `window_function(n, 'hann')`)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float64)


def mel_filter_bank(n_freq: int = N_FFT // 2 + 1, n_mels: int = 80,
                    f_min: float = 0.0, f_max: float = 8000.0,
                    sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular filterbank (n_freq, n_mels)."""
    min_log_hz = 1000.0
    min_log_mel = min_log_hz * 3.0 / 200.0
    logstep = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                        / logstep,
                        f * 3.0 / 200.0)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        m * 200.0 / 3.0)

    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freq)
    hz_pts = mel_to_hz(np.linspace(hz_to_mel(f_min), hz_to_mel(f_max),
                                   n_mels + 2))
    fdiff = np.diff(hz_pts)
    slopes = hz_pts[None, :] - fft_freqs[:, None]
    lower = -slopes[:, :-2] / fdiff[None, :-1]
    upper = slopes[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    fb *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=4)
def dft_mel_bases(n_mels: int = 80) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cos_basis, sin_basis, mel_fb): cos/sin (N_FFT, n_freq) with the hann
    window folded in, so power[f] = (frame·cosB)² + (frame·sinB)²."""
    n_freq = N_FFT // 2 + 1
    window = hann_window_periodic(N_FFT)
    ang = 2.0 * np.pi * np.arange(N_FFT)[:, None] * np.arange(n_freq)[None, :] / N_FFT
    cos_b = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_b = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_b, sin_b, mel_filter_bank(n_freq, n_mels)


@functools.lru_cache(maxsize=8)
def torch_bases(n_mels: int, dft_dtype: torch.dtype, device: torch.device):
    """dft_mel_bases as tensors on `device`: cos/sin in the DFT dtype, the
    filterbank in f32."""
    cos_b, sin_b, mel_fb = dft_mel_bases(n_mels)
    return (torch.from_numpy(cos_b).to(device, dft_dtype),
            torch.from_numpy(sin_b).to(device, dft_dtype),
            torch.from_numpy(mel_fb).to(device))


def pad_or_trim(wav: torch.Tensor, length: int = N_SAMPLES) -> torch.Tensor:
    """Zero-pad or trim the last axis to exactly `length` samples."""
    n = wav.shape[-1]
    if n > length:
        return wav[..., :length]
    if n < length:
        return F.pad(wav, (0, length - n))
    return wav


def frame_waveform(wav: torch.Tensor) -> torch.Tensor:
    """Reflect-pad by N_FFT/2 and cut overlapping frames:
    (B, T) -> (B, 1 + T // HOP_LENGTH, N_FFT), a strided view."""
    half = N_FFT // 2
    x = F.pad(wav, (half, half), mode="reflect")
    return x.unfold(-1, N_FFT, HOP_LENGTH)


def mel_log10_ref(frames: torch.Tensor, n_mels: int = 80,
                  dft_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the mel kernel: frames (B, F, N_FFT) ->
    log10(max(mel power, 1e-10)) (B, F, n_mels) f32. Frames and bases are
    rounded to the DFT dtype; products and sums run in f32."""
    cos_b, sin_b, mel_fb = torch_bases(n_mels, dft_dtype, frames.device)
    f = frames.to(dft_dtype).to(torch.float32)
    re = f @ cos_b.to(torch.float32)
    im = f @ sin_b.to(torch.float32)
    mel = (re * re + im * im) @ mel_fb
    return torch.log10(torch.clamp(mel, min=1e-10))


def log_mel_f64(wav: torch.Tensor, n_mels: int = 80,
                dft_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`log_mel` on the same operands (samples and bases rounded to the DFT
    dtype) with every product and sum in float64: the result that the f32
    versions approximate, to measure how far each lies from it. Eight clips
    at a time, to bound the float64 frames."""
    cos_b, sin_b, mel_fb = (t.double() for t in torch_bases(n_mels, dft_dtype, wav.device))
    out = []
    for part in wav.split(8):
        f = frame_waveform(part).to(dft_dtype).double()
        re, im = f @ cos_b, f @ sin_b
        out.append(torch.log10(torch.clamp((re * re + im * im) @ mel_fb, min=1e-10)))
    return finish_log_mel(torch.cat(out))


def finish_log_mel(log_spec: torch.Tensor) -> torch.Tensor:
    """(B, F, n_mels) log10 mel -> (B, n_mels, F - 1): drop the trailing
    frame (HF parity), clamp to max - 8 per utterance, scale (x + 4) / 4."""
    log_spec = log_spec[:, :-1, :]
    peak = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    return ((log_spec + 4.0) / 4.0).transpose(1, 2)


def log_mel(wav: torch.Tensor, n_mels: int = 80,
            dft_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain pipeline: waveform (B, T) f32 -> log-mel (B, n_mels, T // 160)."""
    return finish_log_mel(mel_log10_ref(frame_waveform(wav), n_mels, dft_dtype))


def preprocess(wav: torch.Tensor, n_mels: int = 80, length: int = N_SAMPLES,
               dft_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Full frontend for a (B, T) batch: pad/trim to `length` samples, then
    the fused log-mel (`log_mel_cuda`: the kernel on the card, its plain
    version on the CPU)."""
    from .mel_kernel import log_mel_cuda

    return log_mel_cuda(pad_or_trim(wav, length), n_mels, dft_dtype)
