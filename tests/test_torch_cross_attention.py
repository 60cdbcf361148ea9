"""The grouped cross-attention kernel's plain version (what the wrapper runs
on a CPU tensor) against the JAX package's
`decode_cross_attention_grouped` in interpret mode, at K = 1 (decode step)
and K = 3 (prefill of whisper-small's 4-token prefix)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.ops.cross_attention import (
    decode_cross_attention_grouped as jax_grouped)
from openai_whisper_compression_tpu_torch.ops.cross_attention import (
    decode_cross_attention_grouped, pad_cross_len)

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
