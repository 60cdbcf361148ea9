"""The plain versions of the encoder-attention kernel, of the cache-update
kernels' `start` variants and of the grouped cross-attention at beam and
window widths (what the wrappers run on a CPU tensor), against the JAX
package's Pallas kernels in interpret mode on the same numpy-seeded
inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.models import whisper as jax_whisper
from openai_whisper_compression_tpu.ops.attention import encoder_attention_pallas
from openai_whisper_compression_tpu.ops.cross_attention import (
    decode_cross_attention_grouped as jax_grouped)
from openai_whisper_compression_tpu.ops.self_attention_step import (
    decode_self_attention_update as jax_update)
from openai_whisper_compression_tpu.ops.self_attention_step import (
    decode_self_attention_update_int8 as jax_update_int8)
from openai_whisper_compression_tpu_torch.models import whisper
from openai_whisper_compression_tpu_torch.ops.attention import (
    encoder_attention, encoder_attention_ref, matmul_f32)
from openai_whisper_compression_tpu_torch.ops.cross_attention import (
    MAX_SLOTS, decode_cross_attention_grouped, pad_cross_len)
from openai_whisper_compression_tpu_torch.ops.self_attention_step import (
    decode_self_attention_update, decode_self_attention_update_int8)

torch.set_num_threads(2)


def _qkv(b, h, t, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((3, b, h, t, 64)).astype(np.float32)


@pytest.mark.parametrize("t", [256, 300, 1500])
def test_encoder_attention_plain_matches_pallas_f32(t):
    """f32: 2e-5, the tolerance of the JAX package's own kernel test (the
    two sides sum in other orders)."""
    q, k, v = _qkv(2, 4, t, t)
    ref = encoder_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = encoder_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == (2, 4, t, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_encoder_attention_plain_matches_pallas_bf16():
    """bf16 at T = 384: both sides round q * scale, the unnormalised
    probabilities and the output to bf16 at the same places, so they differ
    by sum order only: one bf16 step (2**-7) of the largest output."""
    q, k, v = _qkv(1, 2, 384, 7)
    ref = encoder_attention_pallas(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    ref = np.asarray(ref.astype(jnp.float32))
    got = encoder_attention_ref(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - ref).max() <= 2 ** -7 * np.abs(ref).max()


def test_encoder_attention_wrapper_on_cpu_is_the_plain_version():
    """A CPU tensor takes the plain version, strided (B, T, H, Dh) memory
    included, and counts no launch."""
    q, k, v = (torch.from_numpy(x).permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
               for x in _qkv(1, 2, 260, 3))
    before = encoder_attention.launches
    got = encoder_attention(q, k, v)
    assert encoder_attention.launches == before
    assert torch.equal(got, encoder_attention_ref(q.contiguous(), k.contiguous(),
                                                  v.contiguous()))


@pytest.mark.parametrize("t", [64, 300])
def test_model_attention_matches_jax_on_cpu(t):
    """`attention()` on the CPU stays plain torch at every length, as the
    JAX package's stays on its einsum path off the TPU: f32 within 1e-5."""
    q, k, v = _qkv(1, 2, t, 11)
    ref = jax_whisper.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = whisper.attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_matmul_f32_widens_bf16():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((2, 3, 5, 8)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((2, 3, 8, 4)).astype(np.float32)).bfloat16()
    got = matmul_f32(a, b)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 5, 4)
    assert torch.equal(got, a.float() @ b.float())


def _mixed_start(bh, pos):
    """(BH,) starts covering 0 (row 0), pos itself (row 1) and values
    between."""
    start = np.arange(bh) * 3 % (pos + 1)
    start[1] = pos
    return start.astype(np.int32)


@pytest.mark.parametrize("pos", [0, 5, 15])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_with_start_plain_matches_pallas(pos, dtype):
    """The fp `start` body (`_kernel_upd`): caches bit-identical, output
    within 1e-5 (f32) or one bf16 rounding (2**-8) of values of order 1;
    and `start` is honoured (the result differs from the run without it)."""
    bh, s, dh = 8, 16, 64
    rng = np.random.default_rng(pos)
    q = (rng.standard_normal((bh, dh)) * 0.125).astype(np.float32)
    kn, vn = rng.standard_normal((2, bh, dh)).astype(np.float32)
    kc, vc = rng.standard_normal((2, bh, s, dh)).astype(np.float32)
    start = _mixed_start(bh, pos)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref_out, ref_k, ref_v = jax_update(
        jnp.asarray(q, jd), jnp.asarray(kn, jd), jnp.asarray(vn, jd),
        jnp.asarray(kc, jd), jnp.asarray(vc, jd), jnp.asarray(pos),
        start=jnp.asarray(start))
    k_cache, v_cache = torch.from_numpy(kc).to(td), torch.from_numpy(vc).to(td)
    args = [torch.from_numpy(x).to(td) for x in (q, kn, vn)]
    out = decode_self_attention_update(*args, k_cache, v_cache, pos,
                                       start=torch.from_numpy(start))
    assert out.dtype == td
    np.testing.assert_array_equal(k_cache.float().numpy(),
                                  np.asarray(ref_k.astype(jnp.float32)))
    np.testing.assert_array_equal(v_cache.float().numpy(),
                                  np.asarray(ref_v.astype(jnp.float32)))
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref_out.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    if pos:
        plain = decode_self_attention_update(*args, k_cache.clone(),
                                             v_cache.clone(), pos)
        assert not torch.equal(plain, out)
        # a row whose start is pos attends to the fresh row alone: out = v_new
        lone = np.flatnonzero(start == pos)
        assert lone.size
        np.testing.assert_allclose(out[lone].float().numpy(),
                                   args[2][lone].float().numpy(), atol=tol)


@pytest.mark.parametrize("pos", [0, 7, 15])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_int8_with_start_plain_matches_pallas(pos, dtype):
    """The int8 `start` body (`_kernel_upd_i8`): int8 rows and f32 scales
    equal bit for bit after the in-place row quantize + write; output within
    1e-5 absolute (f32) or one bf16 rounding (2**-8)."""
    bh, s, dh = 16, 16, 64
    rng = np.random.default_rng(100 + pos)
    q = (rng.standard_normal((bh, dh)) * 0.125).astype(np.float32)
    kn, vn = rng.standard_normal((2, bh, dh)).astype(np.float32)
    kc, vc = rng.integers(-127, 128, (2, bh, s, dh)).astype(np.int8)
    ks, vs = rng.uniform(0.005, 0.03, (2, bh, s)).astype(np.float32)
    start = _mixed_start(bh, pos)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_update_int8(jnp.asarray(q, jd), jnp.asarray(kn, jd),
                          jnp.asarray(vn, jd), jnp.asarray(kc), jnp.asarray(vc),
                          jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(pos),
                          start=jnp.asarray(start))
    bufs = [torch.from_numpy(a.copy()) for a in (kc, vc, ks, vs)]
    out = decode_self_attention_update_int8(
        torch.from_numpy(q).to(td), torch.from_numpy(kn).to(td),
        torch.from_numpy(vn).to(td), *bufs, pos, start=torch.from_numpy(start))
    assert out.dtype == td
    kc_t, vc_t, ks_t, vs_t = bufs   # JAX returns (out, kc, ks, vc, vs)
    for got, want in zip((kc_t, ks_t, vc_t, vs_t), ref[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref[0].astype(jnp.float32)),
                               rtol=0 if dtype == "float32" else tol, atol=tol)


def _grouped_inputs(bh, kq, s, seed):
    rng = np.random.default_rng(seed)
    sp = pad_cross_len(s)
    q = (rng.standard_normal((bh, kq, 64)) * 0.125).astype(np.float32)
    k, v = rng.standard_normal((2, bh, 64, sp)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("kq", [5, 8, 19])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_beam_and_window_widths_match_pallas(kq, dtype):
    """Beam widths 5 and 8 and a 19-slot prompt window (more than one
    launch holds on the card) through the wrapper: f32 within 1e-5, bf16
    within one bf16 rounding (2**-8) of values of order 1."""
    assert kq <= MAX_SLOTS or kq > 2 * MAX_SLOTS
    s = 100
    q, k, v = _grouped_inputs(8, kq, s, kq)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_grouped(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                      s_valid=s)
    got = decode_cross_attention_grouped(*(torch.from_numpy(x).to(td)
                                           for x in (q, k, v)), s_valid=s)
    assert got.dtype == td and got.shape == (8, kq, 64)
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("kq", [5, 8, 19])
@pytest.mark.parametrize("bits", [8, 4])
def test_grouped_quantized_beam_and_window_widths_match_pallas(bits, kq):
    """The int8 / int4 bodies at the same widths, K/V quantized by the JAX
    package: f32 output within 1e-5 absolute."""
    s = 100
    q, k, v = _grouped_inputs(8, kq, s, bits + kq)
    quant = jax_whisper._quant_kv4_t if bits == 4 else jax_whisper._quant_kv8_t
    (kq_, ks), (vq_, vs) = (quant(jnp.asarray(x)) for x in (k, v))
    ref = jax_grouped(jnp.asarray(q), kq_, vq_, ks, vs, s_valid=s)
    got = decode_cross_attention_grouped(
        torch.from_numpy(q), *(torch.from_numpy(np.array(a))
                               for a in (kq_, vq_, ks, vs)), s_valid=s)
    assert got.shape == (8, kq, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
