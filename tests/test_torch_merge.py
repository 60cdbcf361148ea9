"""The port's `models/merge.py` and the decode's `cross_kv_pool` /
`cross_kv_merge` against the JAX package on `test2l`: `pool_tokens` (with a
ragged tail), `tome_merge` (including similarities tied exactly, where the
pair choice rests on the first-index argmax and the stable argsort), and
`merge_encoder_tokens`, within 1e-6 relative of values of order 1 (f32,
sums in another order); the greedy tokens and lengths of pooled and merged
decodes equal to the jitted JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.models import decode as jax_decode
from openai_whisper_compression_tpu.models import merge as jax_merge
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.models.fuse import fuse_qkv as jax_fuse_qkv
from openai_whisper_compression_tpu.quant.api import quantize_params as jax_quantize
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.models import decode, merge
from openai_whisper_compression_tpu_torch.models.params import from_numpy

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

ARCH = JAX_ARCHS["test2l"]
RTOL, ATOL = 1e-6, 1e-6


def _x(seed, b=2, s=64, d=16):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _same(got, ref):
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stride", [1, 2, 3, 4])
@pytest.mark.parametrize("s", [64, 65, 1500])
def test_pool_tokens_matches_jax(stride, s):
    x = _x(s + stride, s=s)
    _same(merge.pool_tokens(torch.from_numpy(x), stride),
          jax_merge.pool_tokens(jnp.asarray(x), stride))


@pytest.mark.parametrize("r", [0, 1, 7, 20, 32])
@pytest.mark.parametrize("s", [64, 65])
def test_tome_merge_matches_jax(r, s):
    x = _x(100 + r, s=s)
    _same(merge.tome_merge(torch.from_numpy(x), r),
          jax.jit(jax_merge.tome_merge, static_argnums=1)(jnp.asarray(x), r))


def _tied(seed):
    """Frames made of one-hot rows (whose cosine similarities are exact, so
    equal values tie bit for bit) at distinct scales: several A frames share
    the best similarity, several B frames tie as one A frame's partner, and
    a wrong choice among them moves different values."""
    rng = np.random.default_rng(seed)
    s, d = 24, 6
    hot = np.eye(d, dtype=np.float32)[rng.integers(0, d, s)]
    scale = rng.choice([1.0, 2.0, 4.0, 8.0], size=(s, 1)).astype(np.float32)
    return (hot * scale)[None]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("r", [1, 3, 6, 12])
def test_tome_merge_ties_match_jax(seed, r):
    x = _tied(seed)
    a = x[0, 0::2] / (np.linalg.norm(x[0, 0::2], axis=-1, keepdims=True) + 1e-6)
    b = x[0, 1::2] / (np.linalg.norm(x[0, 1::2], axis=-1, keepdims=True) + 1e-6)
    best = (a @ b.T).max(axis=-1)
    assert len(best) > len(np.unique(best))   # the ranking has ties
    _same(merge.tome_merge(torch.from_numpy(x), r),
          jax.jit(jax_merge.tome_merge, static_argnums=1)(jnp.asarray(x), r))


def test_tome_merge_bounds():
    x = torch.from_numpy(_x(5, s=10))
    assert merge.tome_merge(x, 5).shape == (2, 5, 16)
    with pytest.raises(ValueError, match="bipartite"):
        merge.tome_merge(x, 6)


@pytest.mark.parametrize("pool,r", [(1, 0), (2, 0), (3, 0), (2, 9), (1, 9)])
def test_merge_encoder_tokens_matches_jax(pool, r):
    x = _x(7)
    got = merge.merge_encoder_tokens(torch.from_numpy(x), pool=pool, merge_r=r)
    _same(got, jax_merge.merge_encoder_tokens(jnp.asarray(x), pool=pool, merge_r=r))
    if pool == 1 and r == 0:
        assert np.array_equal(got.numpy(), x)


@pytest.fixture(scope="module")
def trees():
    p = JP.init_params_jit(ARCH, jax.random.PRNGKey(0), std=0.5)
    jp = jax_fuse_qkv(jax_quantize(p, "int8"))
    return jp, from_numpy(jax.tree.map(np.asarray, jp), device=DEV)


@pytest.mark.parametrize("switches", [
    {"cross_kv_pool": 2}, {"cross_kv_pool": 3, "cross_kv_int8": True},
    {"cross_kv_merge": 10}, {"cross_kv_merge": 20, "cross_kv_int8": True},
    {"cross_kv_pool": 2, "cross_kv_int4": True, "kv_int8": True},
    {"cross_kv_merge": 10, "cross_pallas": False, "self_pallas": False},
    {"cross_kv_pool": 2, "beam_size": 5}],
    ids=["pool2", "pool3-ckv8", "merge10", "merge20-ckv8", "pool2-ckv4",
         "merge10-unfused", "pool2-beam5"])
def test_pooled_and_merged_decode_tokens_match_jax(trees, switches):
    jp, tp = trees
    enc = np.random.default_rng(8).standard_normal((3, 64, 64)).astype(np.float32)
    cfg = dict(max_new_tokens=10, **switches)
    fn = "beam_decode" if cfg.get("beam_size", 1) > 1 else "greedy_decode"
    ref = jax.jit(lambda p, e: getattr(jax_decode, fn)(
        p, ARCH, e, JaxDecodeConfig(**cfg)))(jp, jnp.asarray(enc))
    got = getattr(decode, fn)(tp, ARCHS["test2l"], torch.from_numpy(enc),
                              DecodeConfig(**cfg))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    kvs = decode.cross_kvs_for(tp, ARCHS["test2l"], torch.from_numpy(enc),
                               DecodeConfig(**cfg))
    s = (64 - cfg.get("cross_kv_merge", 0) if cfg.get("cross_kv_merge")
         else -(-64 // cfg.get("cross_kv_pool", 1)))
    length = kvs[0].valid_len if cfg.get("cross_pallas", True) else kvs[0][0].shape[2]
    assert length == s
