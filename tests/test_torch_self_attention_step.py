"""The fused cache-row-write + decode self-attention's plain version (what
the wrapper runs on a CPU tensor) against the JAX package's
`decode_self_attention_update` in interpret mode: the output and the
written caches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.ops.self_attention_step import (
    decode_self_attention_update as jax_update)
from openai_whisper_compression_tpu_torch.ops.self_attention_step import (
    decode_self_attention_update)

torch.set_num_threads(2)


@pytest.mark.parametrize("pos", [0, 5, 15])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_plain_matches_pallas(pos, dtype):
    """Caches bit-identical (the row write is a copy); output within 1e-5
    (f32) or one bf16 rounding (2**-8) of values of order 1."""
    bh, s, dh = 8, 16, 64
    rng = np.random.default_rng(pos)
    q = (rng.standard_normal((bh, dh)) * 0.125).astype(np.float32)
    kn, vn = (rng.standard_normal((2, bh, dh))).astype(np.float32)
    kc, vc = (rng.standard_normal((2, bh, s, dh))).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref_out, ref_k, ref_v = jax_update(
        jnp.asarray(q, jd), jnp.asarray(kn, jd), jnp.asarray(vn, jd),
        jnp.asarray(kc, jd), jnp.asarray(vc, jd), jnp.asarray(pos))
    k_cache = torch.from_numpy(kc).to(td)
    v_cache = torch.from_numpy(vc).to(td)
    out = decode_self_attention_update(
        torch.from_numpy(q).to(td), torch.from_numpy(kn).to(td),
        torch.from_numpy(vn).to(td), k_cache, v_cache, pos)
    assert out.dtype == td
    np.testing.assert_array_equal(k_cache.float().numpy(),
                                  np.asarray(ref_k.astype(jnp.float32)))
    np.testing.assert_array_equal(v_cache.float().numpy(),
                                  np.asarray(ref_v.astype(jnp.float32)))
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref_out.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_start_variant_is_not_ported():
    x = torch.zeros(4, 64)
    cache = torch.zeros(4, 8, 64)
    with pytest.raises(NotImplementedError):
        decode_self_attention_update(x, x, x, cache, cache.clone(), 1,
                                     start=torch.zeros(4, dtype=torch.int32))
