"""The fused cache-row-write + decode self-attention's plain versions (what
the wrappers run on a CPU tensor) against the JAX package's
`decode_self_attention_update` and `decode_self_attention_update_int8` in
interpret mode: the output and the written caches (and scales)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.ops.self_attention_step import (
    decode_self_attention_update as jax_update)
from openai_whisper_compression_tpu.ops.self_attention_step import (
    decode_self_attention_update_int8 as jax_update_int8)
from openai_whisper_compression_tpu_torch.ops.self_attention_step import (
    decode_self_attention_update, decode_self_attention_update_int8)

torch.set_num_threads(2)


def _mixed_start(bh: int, pos: int) -> np.ndarray:
    """(BH,) int32 starts: 0, pos itself (that row attends to the fresh row
    alone) and values between."""
    start = np.arange(bh) * 3 % (pos + 1)
    start[1] = pos
    return start.astype(np.int32)


@pytest.mark.parametrize("pos", [0, 5, 15, 40, 79])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_update_plain_matches_pallas(pos, dtype):
    """Without `start` and with a mixed one (a row whose start is pos among
    them): caches bit-identical (the row write is a copy); output within
    1e-5 (f32), one bf16 rounding (2**-8) or one f16 step (2**-10) of values
    of order 1. pos 40 and 79 over an 80-row cache (past a 32-position pass
    of the kernel), the others over 16 rows."""
    bh, s, dh = 8, 16 if pos < 16 else 80, 64
    rng = np.random.default_rng(pos)
    q = (rng.standard_normal((bh, dh)) * 0.125).astype(np.float32)
    kn, vn = (rng.standard_normal((2, bh, dh))).astype(np.float32)
    kc, vc = (rng.standard_normal((2, bh, s, dh))).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = {"float32": 1e-5, "bfloat16": 2 ** -8, "float16": 2 ** -10}[dtype]
    for start in (None, _mixed_start(bh, pos)):
        ref_out, ref_k, ref_v = jax_update(
            jnp.asarray(q, jd), jnp.asarray(kn, jd), jnp.asarray(vn, jd),
            jnp.asarray(kc, jd), jnp.asarray(vc, jd), jnp.asarray(pos),
            None if start is None else jnp.asarray(start))
        k_cache = torch.from_numpy(kc).to(td)
        v_cache = torch.from_numpy(vc).to(td)
        out = decode_self_attention_update(
            torch.from_numpy(q).to(td), torch.from_numpy(kn).to(td),
            torch.from_numpy(vn).to(td), k_cache, v_cache, pos,
            None if start is None else torch.from_numpy(start))
        assert out.dtype == td
        np.testing.assert_array_equal(k_cache.float().numpy(),
                                      np.asarray(ref_k.astype(jnp.float32)))
        np.testing.assert_array_equal(v_cache.float().numpy(),
                                      np.asarray(ref_v.astype(jnp.float32)))
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref_out.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("pos", [0, 7, 15])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_int8_plain_matches_pallas(pos, dtype):
    """int8 cache rows and f32 scales equal bit for bit after the in-place
    row quantize + write (both multiply by the f32 reciprocal of 127);
    output within 1e-5 absolute (f32, values of order 1), or one bf16
    rounding (2**-8) for bf16. B·H = 16, a block size the interpret-mode
    kernel fits."""
    bh, s, dh = 16, 16, 64
    rng = np.random.default_rng(100 + pos)
    q = (rng.standard_normal((bh, dh)) * 0.125).astype(np.float32)
    kn, vn = (rng.standard_normal((2, bh, dh))).astype(np.float32)
    kc, vc = rng.integers(-127, 128, (2, bh, s, dh)).astype(np.int8)
    ks, vs = rng.uniform(0.005, 0.03, (2, bh, s)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_update_int8(jnp.asarray(q, jd), jnp.asarray(kn, jd),
                          jnp.asarray(vn, jd), jnp.asarray(kc), jnp.asarray(vc),
                          jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(pos))
    bufs = [torch.from_numpy(a.copy()) for a in (kc, vc, ks, vs)]
    out = decode_self_attention_update_int8(
        torch.from_numpy(q).to(td), torch.from_numpy(kn).to(td),
        torch.from_numpy(vn).to(td), *bufs, pos)
    assert out.dtype == td
    kc_t, vc_t, ks_t, vs_t = bufs   # JAX returns (out, kc, ks, vc, vs)
    for got, want in zip((kc_t, ks_t, vc_t, vs_t), ref[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(bufs[0][:, pos].numpy(), kc[:, pos])
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref[0].astype(jnp.float32)),
                               rtol=0 if dtype == "float32" else tol, atol=tol)
