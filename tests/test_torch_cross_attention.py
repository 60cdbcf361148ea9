"""The grouped cross-attention kernel's plain version (what the wrapper runs
on a CPU tensor) against the JAX package's
`decode_cross_attention_grouped` in interpret mode, at K = 1 (decode step)
and K = 3 (prefill of whisper-small's 4-token prefix), for bf16, int8 and
int4 K/V; and the cross-KV transpose + int8 quantize and the int4 packing
against the JAX package's, bit for bit; and the rule that splits a row of
the grouped kernel over a thread block cluster."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.models import whisper as jax_whisper
from openai_whisper_compression_tpu.ops.cross_attention import (
    decode_cross_attention_grouped as jax_grouped)
from openai_whisper_compression_tpu.ops.cross_attention import (
    transpose_quant_kv as jax_transpose_quant_kv)
from openai_whisper_compression_tpu_torch.models import whisper
from openai_whisper_compression_tpu_torch.ops.cross_attention import (
    GROUPED_CHUNK, decode_cross_attention_grouped, grouped_splits, pad_cross_len,
    transpose_quant_kv)

torch.set_num_threads(2)


def _inputs(bh, kq, s, seed):
    rng = np.random.default_rng(seed)
    sp = pad_cross_len(s)
    q = (rng.standard_normal((bh, kq, 64)) * 0.125).astype(np.float32)
    k = rng.standard_normal((bh, 64, sp)).astype(np.float32)
    v = rng.standard_normal((bh, 64, sp)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("kq", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_plain_matches_pallas(kq, dtype):
    """f32 math on identical operands: f32 output within 1e-5; bf16 output
    within one bf16 rounding of values of order 1 (2**-8 relative)."""
    s = 100
    q, k, v = _inputs(8, kq, s, kq)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_grouped(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                      s_valid=s)
    ref = np.asarray(ref.astype(jnp.float32))
    got = decode_cross_attention_grouped(torch.from_numpy(q).to(td),
                                         torch.from_numpy(k).to(td),
                                         torch.from_numpy(v).to(td), s_valid=s)
    assert got.dtype == td and got.shape == (8, kq, 64)
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("kq", [1, 3])
def test_padding_gets_zero_probability(kq):
    """Garbage past s_valid must not change a single output bit."""
    s = 70
    q, k, v = _inputs(4, kq, s, 9)
    kp, vp = k.copy(), v.copy()
    kp[:, :, s:] = 100.0
    vp[:, :, s:] = -77.0
    t = torch.from_numpy
    a = decode_cross_attention_grouped(t(q), t(k), t(v), s_valid=s)
    b = decode_cross_attention_grouped(t(q), t(kp), t(vp), s_valid=s)
    assert torch.equal(a, b)


def _proj(b, s, h, seed, dtype):
    """A (B, S, H*64) projection output of order 1 (std 0.4, as the JAX
    package's own test), in `dtype` on both sides."""
    x = np.random.default_rng(seed).standard_normal((b, s, h * 64)) * 0.4
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("s,h", [pytest.param(200, 2, id="200"),
                                 pytest.param(64, 2, id="64")]
                         + [pytest.param(s, h, id=f"{s}-h{h}")
                            for s in (1, 127, 128, 129, 200, 1500)
                            for h in (1, 5, 12, 20)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transpose_quant_kv_matches_jax(s, h, dtype):
    """int8 bytes and f32 scales equal bit for bit to the Pallas kernel
    (interpret mode) and to the jitted transpose -> pad -> quantize chain
    of the JAX package's precompute (both multiply by the f32 reciprocal
    of 127 under jit), for S ending a 128-position tile anywhere and H up
    to large-v3's 20."""
    b = 3
    xj, xt = _proj(b, s, h, s, dtype)
    q, sc = transpose_quant_kv(xt, h)
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    assert q.shape == (b * h, 64, pad_cross_len(s)) and sc.shape == (
        b * h, 1, pad_cross_len(s))
    chain = jax.jit(lambda x: jax_whisper._quant_kv8_t(
        jax_whisper._transpose_kv(x, h)))
    for qj, scj in (jax_transpose_quant_kv(xj, h), chain(xj)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(scj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_packing_matches_jax(dtype):
    """Split-half int4 bytes and absmax/7 scales equal the jitted JAX
    `_quant_kv4_t`; the unpacked nibbles equal JAX's `unpack_kv4_t`."""
    xj, xt = _proj(2, 200, 2, 4, dtype)
    kj, sj = jax.jit(lambda x: jax_whisper._quant_kv4_t(
        jax_whisper._transpose_kv(x, 2)))(xj)
    kt, st = whisper._quant_kv4_t(whisper.transpose_kv(xt, 2))
    assert kt.dtype == torch.int8 and kt.shape == (4, 32, 256)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(whisper.unpack_kv4_t(kt).numpy(),
                                  np.asarray(jax_whisper.unpack_kv4_t(kj)))


def _quantized_inputs(bits, bh, kq, s, seed, poison):
    """(q, k_t, v_t, k_scale, v_scale): seeded K/V quantized to int8 or
    int4 by the jitted JAX package; with `poison`, finite garbage past
    s_valid in the codes and the scales (what a kernel must never let
    through)."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((bh, kq, 64)) * 0.125).astype(np.float32)
    quant = jax_whisper._quant_kv4_t if bits == 4 else jax_whisper._quant_kv8_t
    data_scales = []
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal((bh, 64, pad_cross_len(s))),
                        jnp.float32)
        data, scale = (np.asarray(a).copy() for a in jax.jit(quant)(x))
        if poison:
            data[:, :, s:] = 100
            scale[:, :, s:] = 3.0
        data_scales.append((data, scale))
    (k, ks), (v, vs) = data_scales
    return q, k, v, ks, vs


@pytest.mark.parametrize("kq", [1, 3])
@pytest.mark.parametrize("bits", [8, 4])
def test_grouped_quantized_plain_matches_pallas(bits, kq):
    """f32 output within 1e-5 absolute of the int8 / int4 Pallas bodies
    (interpret mode) on the same poisoned inputs, s_valid < S_pad."""
    s = 100
    inputs = _quantized_inputs(bits, 8, kq, s, bits + kq, poison=True)
    ref = jax_grouped(*(jnp.asarray(a) for a in inputs), s_valid=s)
    got = decode_cross_attention_grouped(*(torch.from_numpy(a) for a in inputs),
                                         s_valid=s)
    assert got.dtype == torch.float32 and got.shape == (8, kq, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_padding_gets_zero_probability(bits):
    """Garbage past s_valid, in the data and in the scales, must not change
    a single output bit of the int8 / int4 plain version."""
    t = torch.from_numpy
    clean = _quantized_inputs(bits, 4, 3, 70, 5, poison=False)
    dirty = _quantized_inputs(bits, 4, 3, 70, 5, poison=True)
    a = decode_cross_attention_grouped(*(t(x) for x in clean), s_valid=70)
    b = decode_cross_attention_grouped(*(t(x) for x in dirty), s_valid=70)
    assert torch.equal(a, b)


H100_SMS = 132


@pytest.mark.parametrize("s_valid", [1, 16, 1500, 1536])
@pytest.mark.parametrize("bh", [12, 192, 384, 1152])
def test_grouped_split_gives_every_block_a_chunk(bh, s_valid):
    """The cluster holds 1-8 blocks, and 2-8 wherever the rows alone leave
    the card short of two blocks an SM and the row has two chunks to share;
    every block of a row gets at least one 32-position chunk (the kernel's
    own share-out, reproduced); and the grid covers the card's SMs unless
    the split is already as wide as it may be."""
    splits = grouped_splits(bh, s_valid)
    chunks = -(-s_valid // GROUPED_CHUNK)
    assert 1 <= splits <= 8
    if bh < 2 * H100_SMS and chunks >= 2:
        assert splits >= 2
    shares = [(r + 1) * chunks // splits - r * chunks // splits for r in range(splits)]
    assert sum(shares) == chunks and min(shares) >= 1
    assert bh * splits >= H100_SMS or splits == min(8, chunks)
