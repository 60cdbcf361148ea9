"""Fused log-mel kernel (`csrc/mel.cu`): windowed DFT -> power -> mel ->
log10 in one pass, the port of the JAX package's
`audio/mel_pallas.py::log_mel_pallas`. Its plain version is
`features.mel_log10_ref`.

The kernel reads the reflect-padded waveform in place (a frame is 400
samples at a hop of 160, never copied out), takes the DFT bases with the
cos and sin columns of each bin side by side, and multiplies the power
spectrum by the mel filterbank as bands of nonzero bins. `mel_operands`
builds all of that in PyTorch, where the CPU tests reach it."""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import HOP_LENGTH, N_FFT
from ..ops import kernels
from .features import dft_mel_bases, finish_log_mel, frame_waveform, mel_log10_ref

N_FREQ = N_FFT // 2 + 1
N_COLS = 416   # cos/sin columns 2f and 2f + 1 of 201 bins, zero padded to 2 x 208
MAX_MELS = 128


class MelOperands(NamedTuple):
    wav: torch.Tensor       # (B, stride) f32: reflect padded, stride % 4 == 0
    n_frames: int           # 1 + T // HOP_LENGTH
    bases: torch.Tensor     # bf16 (N_COLS, N_FFT) or f32 (N_FFT, N_COLS)
    bands: torch.Tensor     # (n_mels, 2) int32: first bin, width
    weights: torch.Tensor   # (n_mels, band_w) f32, zeros past each width


def padded_waveform(wav: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(B, T) -> the reflect-padded waveform (B, stride) f32 and the frame
    count: frame r is columns 160 r .. 160 r + 399, as in `frame_waveform`.
    The row stride is T + 400 rounded up to a multiple of 4 samples (zeros
    past T + 400), so every frame starts on a 16-byte boundary."""
    half = N_FFT // 2
    x = F.pad(wav.float(), (half, half), mode="reflect")
    extra = -x.shape[-1] % 4
    if extra:
        x = F.pad(x, (0, extra))
    return x.contiguous(), 1 + wav.shape[-1] // HOP_LENGTH


def interleaved_bases(dft_dtype: torch.dtype, device) -> torch.Tensor:
    """The windowed DFT bases (N_FFT, N_COLS) in the DFT dtype: column 2f
    is bin f's cos basis, 2f + 1 its sin basis, columns from 402 zero."""
    cos_b, sin_b, _ = dft_mel_bases(80)
    cols = np.zeros((N_FFT, N_COLS), np.float32)
    cols[:, 0:2 * N_FREQ:2] = cos_b
    cols[:, 1:2 * N_FREQ:2] = sin_b
    return torch.from_numpy(cols).to(device, dft_dtype)


@functools.lru_cache(maxsize=4)
def mel_bands(n_mels: int) -> tuple[np.ndarray, np.ndarray]:
    """The slaney filterbank of `dft_mel_bases(n_mels)` as bands: (n_mels, 2)
    int32 (first bin, width from the first nonzero weight to the last) and
    (n_mels, band_w) f32 weights, zero past each width; band_w is the
    widest band (14 at 80 mels)."""
    fb = dft_mel_bases(n_mels)[2]
    spans = []
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        spans.append((int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0))
    band_w = max(1, max(w for _, w in spans))
    bands = np.asarray(spans, np.int32)
    weights = np.zeros((n_mels, band_w), np.float32)
    for m, (first, width) in enumerate(spans):
        weights[m, :width] = fb[first:first + width, m]
    return bands, weights


def banded_mel(power: torch.Tensor, n_mels: int) -> torch.Tensor:
    """Plain mel product over the bands: power (..., N_FREQ) f32 ->
    (..., n_mels), each mel summed over its band only (what the kernel
    computes; equal to `power @ mel_fb` but for sum order)."""
    bands, weights = (torch.from_numpy(a).to(power.device) for a in mel_bands(n_mels))
    idx = (bands[:, :1] + torch.arange(weights.shape[1], device=power.device)
           ).clamp(max=N_FREQ - 1)
    return (power[..., idx] * weights).sum(-1)


@functools.lru_cache(maxsize=8)
def _device_operands(n_mels: int, dft_dtype: torch.dtype, device):
    bases = interleaved_bases(dft_dtype, device)
    if dft_dtype == torch.bfloat16:   # the tensor-core body reads [column][tap]
        bases = bases.t().contiguous()
    bands, weights = mel_bands(n_mels)
    return bases, torch.from_numpy(bands).to(device), torch.from_numpy(weights).to(device)


def mel_operands(wav: torch.Tensor, n_mels: int = 80,
                 dft_dtype: torch.dtype = torch.float32) -> MelOperands:
    """What `log_mel_cuda` hands the kernel for waveform (B, T)."""
    xp, n_frames = padded_waveform(wav)
    return MelOperands(xp, n_frames, *_device_operands(n_mels, dft_dtype, wav.device))


def log_mel_cuda(wav: torch.Tensor, n_mels: int = 80,
                 dft_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Waveform (B, T) -> log-mel (B, n_mels, T // 160), the output of
    `features.log_mel`. On a CUDA tensor the DFT/power/mel/log10 core runs
    in the kernel (counted in `log_mel_cuda.launches`); on a CPU tensor it
    runs the plain version."""
    if not wav.is_cuda:
        return finish_log_mel(mel_log10_ref(frame_waveform(wav), n_mels, dft_dtype))
    return _launch_log_mel(wav, n_mels, dft_dtype)


def _launch_log_mel(wav: torch.Tensor, n_mels: int,
                    dft_dtype: torch.dtype) -> torch.Tensor:
    """The card path of `log_mel_cuda`: its checks, the operands, then the
    launch. The CPU tests call it directly, with a recording stand-in for
    the kernel library."""
    name = "log_mel_cuda"
    kernels.refuse_grad(name, wav)
    kernels.require(wav.dim() == 2 and wav.shape[0] >= 1, name,
                    f"wav must be (B, T) with B >= 1, got {tuple(wav.shape)}")
    kernels.require(wav.shape[1] > N_FFT // 2, name,
                    f"the reflect pad needs T > {N_FFT // 2}, got {wav.shape[1]}")
    kernels.require(dft_dtype in (torch.float32, torch.bfloat16), name,
                    f"the DFT runs in float32 or bfloat16, got {dft_dtype}")
    kernels.require(1 <= n_mels <= MAX_MELS, name,
                    f"n_mels must lie in 1..{MAX_MELS}, got {n_mels}")
    if wav.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"{name}: the waveform must be float32, bfloat16 or "
                        f"float16, got {wav.dtype}")
    ops = mel_operands(wav, n_mels, dft_dtype)
    return finish_log_mel(launch(ops, dft_dtype))


log_mel_cuda.launches = 0


def launch(ops: MelOperands, dft_dtype: torch.dtype) -> torch.Tensor:
    """One launch of the kernel on `mel_operands`' output: log10 of the mel
    power (B, n_frames, n_mels) f32 of every frame, counted in
    `log_mel_cuda.launches`."""
    b, n_mels = ops.wav.shape[0], ops.bands.shape[0]
    out = torch.empty((b, ops.n_frames, n_mels), dtype=torch.float32,
                      device=ops.wav.device)
    err = kernels.lib().owc_mel_log10(
        ops.wav.data_ptr(), ops.bases.data_ptr(), ops.bands.data_ptr(),
        ops.weights.data_ptr(), out.data_ptr(), b, ops.wav.shape[1], ops.n_frames,
        n_mels, ops.weights.shape[1], kernels.DTYPE_CODES[dft_dtype],
        kernels.stream_of(ops.wav))
    kernels.check("log_mel_cuda", err)
    log_mel_cuda.launches += 1
    kernels.record_cost(log_mel_cost(b, ops.n_frames))
    return out


def log_mel_cost(b: int, n_frames: int) -> dict:
    """What the JAX `log_mel_pallas`'s `pl.CostEstimate` declares: frames
    padded to 256 a grid step, the 400-tap DFT to 512 taps and 256 bins, the
    mel bins to 128, whatever the dtype and mel count."""
    fp = -(-n_frames // 256) * 256
    return kernels.cost(2 * b * fp * 512 * 256 * 2 + 2 * b * fp * 256 * 128,
                        b * fp * 512 * 4 + b * fp * 128 * 4, b * fp * 128)
