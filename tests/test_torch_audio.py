"""The port's log-mel frontend against the JAX package: framing and bases
exactly, the mel kernel's plain version (what `log_mel_cuda` runs on a CPU
tensor) against `log_mel_pallas` in interpret mode, f32 and bf16 DFT; and
what the kernel is handed (`mel_operands`): the band table of the mel
filterbank, the banded mel product, the padded waveform read in place and
the interleaved bases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.audio import features as jf
from openai_whisper_compression_tpu.audio.mel_pallas import log_mel_pallas
from openai_whisper_compression_tpu_torch.audio import features as tf
from openai_whisper_compression_tpu_torch.audio.mel_kernel import (
    N_COLS, banded_mel, log_mel_cuda, mel_bands, mel_operands)

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


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_bands_scatter_back(n_mels):
    """The band table scatters back to the filterbank bit for bit: every
    nonzero weight lies in its mel's band, each band starts and ends on a
    nonzero, and the weights past a band's width are zeros."""
    fb = tf.dft_mel_bases(n_mels)[2]
    bands, weights = mel_bands(n_mels)
    assert bands.shape == (n_mels, 2) and weights.shape[0] == n_mels
    back = np.zeros_like(fb)
    for m, (first, width) in enumerate(bands):
        back[first:first + width, m] = weights[m, :width]
        assert not weights[m, width:].any()
        assert width >= 1 and weights[m, 0] != 0 and weights[m, width - 1] != 0
    np.testing.assert_array_equal(back, fb)
    assert int(bands[:, 1].sum()) == {80: 391, 128: 394}[n_mels] == np.count_nonzero(fb)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_banded_mel_matches_dense(n_mels):
    """The mel product over the bands equals power @ mel_fb within 1e-6
    relative: the same nonnegative terms, summed in another order."""
    rng = np.random.default_rng(n_mels)
    power = torch.from_numpy((rng.standard_normal((3, 50, 201)) ** 2
                              * rng.uniform(0.0, 4.0, (3, 50, 1))).astype(np.float32))
    fb = torch.from_numpy(tf.dft_mel_bases(n_mels)[2])
    np.testing.assert_allclose(banded_mel(power, n_mels).numpy(),
                               (power @ fb).numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dft", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [480_000, N, N + 3])
def test_mel_operands(t, dft):
    """The kernel's operands: frame r of the padded waveform (columns 160 r
    .. 160 r + 399, in a row whose stride is a multiple of 4 samples) is
    exactly frame_waveform's frame r, for every r of the frame count, and
    rounds to the DFT dtype alike; the interleaved bases hold cos and sin of
    each bin in the DFT dtype, zeros past bin 200; the bands are
    `mel_bands`'."""
    dtype = getattr(torch, dft)
    rng = np.random.default_rng(t)
    wav = torch.from_numpy(rng.standard_normal((1 if t > N + 3 else 2, t))
                           .astype(np.float32))
    ops = mel_operands(wav, 80, dtype)
    ref = tf.frame_waveform(wav)
    stride = ops.wav.shape[1]
    assert ops.wav.dtype == torch.float32 and ops.wav.is_contiguous()
    assert stride % 4 == 0 and t + 400 <= stride < t + 404
    assert ops.n_frames == ref.shape[1] == 1 + t // 160
    assert (ops.n_frames - 1) * 160 + 400 <= t + 400
    got = ops.wav.unfold(-1, 400, 160)[:, :ops.n_frames]
    assert torch.equal(got, ref)
    assert torch.equal(got.to(dtype), ref.to(dtype))
    assert not ops.wav[:, t + 400:].any()
    cos_b, sin_b, _ = tf.torch_bases(80, dtype, torch.device("cpu"))
    cols = ops.bases.t() if dtype == torch.bfloat16 else ops.bases
    assert ops.bases.dtype == dtype and cols.shape == (400, N_COLS)
    assert torch.equal(cols[:, 0:402:2], cos_b) and torch.equal(cols[:, 1:402:2], sin_b)
    assert not cols[:, 402:].any()
    bands, weights = mel_bands(80)
    np.testing.assert_array_equal(ops.bands.numpy(), bands)
    np.testing.assert_array_equal(ops.weights.numpy(), weights)


@pytest.mark.parametrize("dft", ["float32", "bfloat16"])
def test_log_mel_f64_is_the_same_function(dft):
    """The float64 yardstick computes what `log_mel` computes, from the same
    rounded operands: within 1e-5 of it on log-mel values of order 1 (the
    f32 sums' own error), and of the same shape and type."""
    wav = torch.from_numpy(_wav(4))
    dtype = getattr(torch, dft)
    exact = tf.log_mel_f64(wav, 80, dtype)
    assert exact.dtype == torch.float64 and exact.shape == (2, 80, N // 160)
    np.testing.assert_allclose(tf.log_mel(wav, 80, dtype).numpy(), exact.numpy(),
                               rtol=0, atol=1e-5)
