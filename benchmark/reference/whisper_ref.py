"""Whisper in plain PyTorch, float32, TF32 off: the benchmark's reference.

Follows the published model (openai/whisper `model.py` and `audio.py`):

- log-mel: the 30 s window zero padded, a centred STFT (n_fft 400, hop 160,
  periodic Hann, reflect padding), the power spectrum without its last
  frame, a Slaney mel filterbank (librosa's `filters.mel`), log10 of at least
  1e-10, clamped to 8 below each clip's maximum, (x + 4) / 4; worked out in
  float64 and handed to the encoder in float32, so that the reference's own
  rounding takes no share of what the program is allowed;
- encoder: two convolutions (width 3, padding 1, the second of stride 2)
  each followed by exact GELU, sinusoidal positions, pre-LN blocks of
  self-attention (no key bias) and an MLP, a final layer norm;
- decoder: token embedding plus learned positions, pre-LN blocks of causal
  self-attention, cross-attention over the encoder states and an MLP with
  exact GELU, a final layer norm, logits through the tied embedding.

One departure, stated by the configuration and not a precision choice: the
encoder's MLPs use the GELU the configuration names (`encoder_mlp_gelu`,
"tanh" for the approximation). The linear weights are quantized by the
configuration's rule (`quant_rule.py`), from the same seeded weights that
the program is given, and dequantized to f32; caches are not quantized.
Imports only torch and numpy.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from .quant_rule import fake_quant, is_quantized

SAMPLE_RATE, N_FFT, HOP = 16000, 400, 160


@contextlib.contextmanager
def exact_f32():
    """float32 matmuls and convolutions without TF32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def mel_filters(n_mels: int, sr: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """librosa.filters.mel(sr, n_fft, n_mels) (Slaney scale and norm):
    (n_mels, 1 + n_fft // 2) float64."""
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, math.log(6.4) / 27.0

    def hz_to_mel(f):
        return min_log_mel + math.log(f / min_log_hz) / logstep if f >= min_log_hz else f / f_sp

    def mel_to_hz(m):
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        f_sp * m)

    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights


class WhisperReference:
    """The reference model over a seeded tree (the port's layout, any dtype,
    any device): an f32 copy with the linear weights rounded to
    `weight_bits` (8 for the configuration, 4 for the control)."""

    def __init__(self, model: dict, tree: dict, weight_bits: int = 8,
                 encoder_mlp_gelu: str = "none"):
        self.m = model
        self.heads_enc = model["encoder_attention_heads"]
        self.heads_dec = model["decoder_attention_heads"]
        self.enc_gelu = encoder_mlp_gelu
        self.window_samples = model["max_source_positions"] * 2 * HOP   # 30 s
        self.p = self._f32(tree, "", weight_bits)
        dev = self.p["decoder"]["embed"].device
        self.fb = torch.from_numpy(mel_filters(model["num_mel_bins"])).to(dev, torch.float64)
        self.window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=dev)

    def _f32(self, node, path: str, bits: int):
        if isinstance(node, dict):
            return {k: self._f32(v, f"{path}.{k}" if path else k, bits) for k, v in node.items()}
        if isinstance(node, list):
            return [self._f32(v, f"{path}.{i}", bits) for i, v in enumerate(node)]
        w = node.to(torch.float32)
        return fake_quant(w, bits) if is_quantized(path) else w

    # frontend -----------------------------------------------------------
    def log_mel(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T) f32 at 16 kHz -> (B, n_mels, 3000) f32 (a 30 s window)."""
        n = self.window_samples
        wav = F.pad(wav.to(torch.float64), (0, max(0, n - wav.shape[-1])))[:, :n]
        spec = torch.stft(wav, N_FFT, HOP, window=self.window, center=True,
                          pad_mode="reflect", return_complex=True)
        power = spec[..., :-1].abs() ** 2
        log_spec = torch.clamp(self.fb @ power, min=1e-10).log10()
        peak = log_spec.amax(dim=(1, 2), keepdim=True)
        return ((torch.maximum(log_spec, peak - 8.0) + 4.0) / 4.0).float()

    # blocks -------------------------------------------------------------
    @staticmethod
    def _ln(x, p):
        return F.layer_norm(x, (x.shape[-1],), p["g"], p["b"], 1e-5)

    @staticmethod
    def _lin(x, p):
        y = x @ p["w"]
        return y + p["b"] if "b" in p else y

    def _attn(self, p, x, kv, heads, causal: bool):
        b, tq, d = x.shape
        dh = d // heads
        q = self._lin(x, p["q"]).view(b, tq, heads, dh).transpose(1, 2)
        k = self._lin(kv, p["k"]).view(b, -1, heads, dh).transpose(1, 2)
        v = self._lin(kv, p["v"]).view(b, -1, heads, dh).transpose(1, 2)
        s = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
        if causal:
            s = s + torch.full((tq, tq), float("-inf"), device=x.device).triu(1)
        o = torch.softmax(s, dim=-1) @ v
        return self._lin(o.transpose(1, 2).reshape(b, tq, d), p["o"])

    def _mlp(self, p, x, gelu: str):
        return self._lin(F.gelu(self._lin(x, p["fc1"]), approximate=gelu), p["fc2"])

    # model --------------------------------------------------------------
    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, 3000) -> (B, 1500, d) for a 30 s window."""
        e = self.p["encoder"]
        with exact_f32():
            x = F.gelu(F.conv1d(mel, e["conv1"]["w"], e["conv1"]["b"], padding=1))
            x = F.gelu(F.conv1d(x, e["conv2"]["w"], e["conv2"]["b"], stride=2, padding=1))
            x = x.transpose(1, 2) + e["pos"][: x.shape[2]]
            for layer in e["layers"]:
                h = self._ln(x, layer["attn_ln"])
                x = x + self._attn(layer["attn"], h, h, self.heads_enc, causal=False)
                x = x + self._mlp(layer, self._ln(x, layer["mlp_ln"]), self.enc_gelu)
            return self._ln(x, e["ln"])

    def logits(self, enc: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder: enc (B, 1500, d), tokens (B, L) -> (B, L, V)."""
        dec = self.p["decoder"]
        with exact_f32():
            x = dec["embed"][tokens] + dec["pos"][: tokens.shape[1]]
            for layer in dec["layers"]:
                h = self._ln(x, layer["attn_ln"])
                x = x + self._attn(layer["attn"], h, h, self.heads_dec, causal=True)
                x = x + self._attn(layer["cross"], self._ln(x, layer["cross_ln"]), enc,
                                   self.heads_dec, causal=False)
                x = x + self._mlp(layer, self._ln(x, layer["mlp_ln"]), "none")
            return self._ln(x, dec["ln"]) @ dec["embed"].t()
