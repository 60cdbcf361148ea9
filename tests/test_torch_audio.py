"""The port's log-mel frontend against the JAX package: framing and bases
exactly, the mel kernel's plain version (what `log_mel_cuda` runs on a CPU
tensor) against `log_mel_pallas` in interpret mode, f32 and bf16 DFT."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.audio import features as jf
from openai_whisper_compression_tpu.audio.mel_pallas import log_mel_pallas
from openai_whisper_compression_tpu_torch.audio import features as tf
from openai_whisper_compression_tpu_torch.audio.mel_kernel import log_mel_cuda

torch.set_num_threads(2)

N = 20480  # test2l's waveform length (64 encoder frames)


def _wav(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, N)) * np.linspace(0.01, 0.5, b)[:, None]
            ).astype(np.float32)


def test_frames_and_bases_identical():
    wav = _wav()
    np.testing.assert_array_equal(
        tf.frame_waveform(torch.from_numpy(wav)).numpy(),
        np.asarray(jf.frame_waveform(jnp.asarray(wav))))
    for got, ref in zip(tf.dft_mel_bases(80), jf.dft_mel_bases(80)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dft", ["float32", "bfloat16"])
def test_log_mel_cuda_plain_matches_pallas(dft):
    """Same operands rounded to the DFT dtype, f32 sums in another order:
    log-mel within 1e-4 (f32) / 1e-3 (bf16) absolute on values of order 1."""
    wav = _wav(1)
    ref = np.asarray(log_mel_pallas(jnp.asarray(wav), 80,
                                    dft_dtype=getattr(jnp, dft)))
    got = log_mel_cuda(torch.from_numpy(wav), 80, getattr(torch, dft))
    assert got.shape == ref.shape == (2, 80, N // 160)
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=1e-4 if dft == "float32" else 1e-3)


@pytest.mark.parametrize("length", [N - 3000, N + 777])
def test_preprocess_matches_jax(length):
    """pad/trim + fused frontend, against JAX's Pallas preprocess."""
    wav = np.random.default_rng(2).standard_normal((2, length)).astype(np.float32)
    ref = np.asarray(jf.preprocess(jnp.asarray(wav), 80, use_pallas=True,
                                   length=N))
    got = tf.preprocess(torch.from_numpy(wav), 80, length=N)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_plain_log_mel_matches_xla_path():
    wav = _wav(3)
    ref = np.asarray(jf.log_mel(jnp.asarray(wav), 80))
    np.testing.assert_allclose(tf.log_mel(torch.from_numpy(wav), 80).numpy(),
                               ref, atol=1e-4)
