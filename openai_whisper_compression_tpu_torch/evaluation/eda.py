"""Dataset EDA utilities (the port's copy of the JAX package's
`evaluation/eda.py`; the log-mel of `plot_sample` is the port's frontend,
on the CPU).

Parity with the reference package-layer EDA
(`openai_whisper_compression/data.py:10-175`): dataset statistics, duration /
text-length distributions, waveform & log-mel spectrogram plots (headless
PNG instead of notebook display).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from ..config import SAMPLE_RATE
from .data import Utterance


def examine_dataset(dataset: list[Utterance]) -> dict[str, Any]:
    """Summary stats ≈ reference `examine_dataset` (`data.py:31-75`)."""
    durs = np.asarray([u.duration for u in dataset])
    words = np.asarray([len(u.text.split()) for u in dataset])
    chars = np.asarray([len(u.text) for u in dataset])
    amps = np.asarray([float(np.abs(u.audio).max()) for u in dataset])

    def stats(x):
        return {"mean": float(x.mean()), "std": float(x.std()),
                "min": float(x.min()), "max": float(x.max()),
                "median": float(np.median(x))} if x.size else {}

    return {
        "num_samples": len(dataset),
        "total_audio_hours": float(durs.sum() / 3600.0),
        "duration_s": stats(durs),
        "words_per_utterance": stats(words),
        "chars_per_utterance": stats(chars),
        "peak_amplitude": stats(amps),
        "sample_rate": SAMPLE_RATE,
    }


def plot_dataset_distributions(dataset: list[Utterance],
                               save_dir: str) -> list[str]:
    """Duration/word-count histograms (`data.py:78-116`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(save_dir, exist_ok=True)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].hist([u.duration for u in dataset], bins=20)
    axes[0].set_xlabel("duration (s)")
    axes[0].set_title("utterance durations")
    axes[1].hist([len(u.text.split()) for u in dataset], bins=20)
    axes[1].set_xlabel("words")
    axes[1].set_title("transcript lengths")
    path = os.path.join(save_dir, "dataset_distributions.png")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return [path]


def plot_sample(utt: Utterance, save_dir: str,
                n_mels: int = 80) -> list[str]:
    """Waveform + log-mel spectrogram of one utterance
    (`data.py:119-156`)."""
    import matplotlib
    import torch

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..audio import features

    os.makedirs(save_dir, exist_ok=True)
    wav = torch.from_numpy(np.asarray(utt.audio, np.float32))[None]
    mel = features.preprocess(wav, n_mels)[0].numpy()
    fig, axes = plt.subplots(2, 1, figsize=(10, 6))
    t = np.arange(len(utt.audio)) / SAMPLE_RATE
    axes[0].plot(t, utt.audio, lw=0.4)
    axes[0].set_xlabel("time (s)")
    axes[0].set_title(f"waveform — {utt.uid} ({utt.duration:.1f}s)")
    im = axes[1].imshow(mel, aspect="auto", origin="lower", cmap="magma")
    axes[1].set_title("log-mel spectrogram")
    fig.colorbar(im, ax=axes[1])
    path = os.path.join(save_dir, f"sample_{utt.uid}.png")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return [path]


def export_sample(utt: Utterance, save_dir: str) -> str:
    """Headless stand-in for the reference's notebook audio playback
    (`play_sample`, `openai_whisper_compression/data.py:158-175`, which
    uses IPython.display.Audio): writes the utterance as a 16-bit PCM WAV
    next to the EDA plots so it can be listened to off-box."""
    import wave

    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"sample_{utt.uid}.wav")
    pcm = np.clip(np.asarray(utt.audio, np.float32), -1.0, 1.0)
    pcm16 = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(SAMPLE_RATE)
        f.writeframes(pcm16.tobytes())
    return path
