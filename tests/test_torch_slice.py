"""The port's slice as a whole against the JAX package on `test2l`:
int8 weights + fused decoder qkv, f32, the JAX transcription function with
the Pallas mel kernel (interpret mode on the CPU), with fp caches and with
`bench.py`'s int8 self-KV / int8 cross-KV (and int4 cross-KV). Tokens and
lengths must match exactly; the quantized cross-KV and the int8 cache's
row quantize + write bit for bit; encoder states, the int8 cache after the
whole prefill and first-step logits within stated bounds. Also: the port imports without jax, options outside the
slice raise, and a CPU call to a kernel wrapper never loads the CUDA
library."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.evaluation.harness import (
    make_transcribe_fn as jax_make_transcribe_fn)
from openai_whisper_compression_tpu.models import cache as jax_cache
from openai_whisper_compression_tpu.models import decode as jax_decode
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.models import whisper as jax_whisper
from openai_whisper_compression_tpu.models.fuse import fuse_qkv as jax_fuse_qkv
from openai_whisper_compression_tpu.quant.api import quantize_params as jax_quantize
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
from openai_whisper_compression_tpu_torch.models import cache as kv_cache
from openai_whisper_compression_tpu_torch.models import decode, whisper
from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
from openai_whisper_compression_tpu_torch.models.params import from_numpy
from openai_whisper_compression_tpu_torch.ops import kernels
from openai_whisper_compression_tpu_torch.quant.api import quantize_params

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
ARCH = JAX_ARCHS["test2l"]
N = 20480  # test2l's waveform samples
# std 0.5 weights give varied tokens per utterance (std 0.02 repeats one
# token); EOT's embedding row is tied to token 611's so some rows stop early
STD, EOT_TWIN = 0.5, 611
# the quantized-KV settings: bench.py's default pair, each alone, and int4
# cross-KV over the int8 cache
KV_CONFIGS = {"kv8": {"kv_int8": True}, "ckv8": {"cross_kv_int8": True},
              "kv8-ckv8": {"kv_int8": True, "cross_kv_int8": True},
              "kv8-ckv4": {"kv_int8": True, "cross_kv_int4": True}}
# the 4-bit weight kinds: bench.py's medium_int4_kv8 preset, and the
# REGISTRY's double-quant NF4 and HQQ int4 (each with its own kernel)
WEIGHT_METHODS = ["int4", "bnb_nf4_double_quant", "hqq_int4"]


@pytest.fixture(scope="module")
def dense_params():
    """The JAX tree before quantization: std 0.5, EOT tied to its twin."""
    p = JP.init_params_jit(ARCH, jax.random.PRNGKey(0), std=STD)
    embed = np.asarray(p["decoder"]["embed"]).copy()
    embed[ARCH.eos_token_id] = 1.3 * embed[EOT_TWIN]
    p["decoder"] = {**p["decoder"], "embed": jnp.asarray(embed)}
    return p


@pytest.fixture(scope="module")
def slice_params(dense_params):
    p = dense_params
    jp = jax_fuse_qkv(jax_quantize(p, "int8"))
    tp = from_numpy(jax.tree.map(np.asarray, jp), device=DEV)
    # the port's own quantize + fuse gives the same tree (bytes pinned in
    # test_torch_quant.py); run the slice on the port-built one
    tp_own = fuse_qkv(quantize_params(from_numpy(jax.tree.map(np.asarray, p), device=DEV),
                                      "int8"))
    assert torch.equal(tp_own["decoder"]["layers"][0]["attn"]["qkv"]["w"].data,
                       tp["decoder"]["layers"][0]["attn"]["qkv"]["w"].data)
    return jp, tp_own


def _wav(b=4):
    rng = np.random.default_rng(0)
    amp = np.array([0.01, 0.1, 0.5, 1.0])[:b, None]
    return (rng.standard_normal((b, N)) * amp).astype(np.float32)


@pytest.mark.parametrize("suppress_eot", [True, False])
def test_transcribe_tokens_match_jax(slice_params, suppress_eot):
    jp, tp = slice_params
    sup = (ARCH.eos_token_id,) if suppress_eot else ()
    wav = _wav()
    jt, jl = jax_make_transcribe_fn(
        ARCH, JaxDecodeConfig(max_new_tokens=12, suppress_tokens=sup),
        use_pallas_mel=True)(jp, jnp.asarray(wav))
    tt, tl = make_transcribe_fn(ARCHS["test2l"],
                                DecodeConfig(max_new_tokens=12,
                                             suppress_tokens=sup), device=DEV)(tp, wav)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    if not suppress_eot:  # the EOT twin makes rows stop at different steps
        assert len(set(tl.tolist())) > 1


@pytest.mark.parametrize("fast_gelu", [False, True])
def test_encoder_matches_jax(slice_params, fast_gelu):
    """f32 encoder states within 1e-4 of layer-normed values of order 1."""
    jp, tp = slice_params
    mel = np.random.default_rng(1).standard_normal((2, 80, 128)).astype(np.float32)
    ref = jax_whisper.encode(jp, ARCH, jnp.asarray(mel), fast_gelu=fast_gelu)
    got = whisper.encode(tp, ARCHS["test2l"], torch.from_numpy(mel),
                         fast_gelu=fast_gelu)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_first_step_logits_match_jax(slice_params):
    """Logits after the batched prefill, f32: within 1e-3 absolute on
    logits of order 10 (the summation order differs)."""
    jp, tp = slice_params
    enc = np.random.default_rng(2).standard_normal((2, 64, 64)).astype(np.float32)
    cfg = JaxDecodeConfig(max_new_tokens=12)
    enc_j = jnp.asarray(enc)
    prefix = jax_decode.forced_prefix(ARCH, cfg)
    p_len = len(prefix)
    max_len = jax_decode._auto_cache_len(ARCH, p_len, cfg)
    kvs = jax_whisper.precompute_cross_kv_t(jp, ARCH, enc_j)
    cache = jax_cache.init_cache(jp, ARCH, 2, max_len)
    toks = jnp.asarray([prefix] * 2, jnp.int32)
    cache = jax_decode.prefill(jp, ARCH, toks[:, : p_len - 1], cache, kvs)
    ref, _ = jax_decode.decoder_step(jp, ARCH, toks[:, p_len - 1],
                                     jnp.asarray(p_len - 1), cache, kvs,
                                     max_len)
    got = decode.first_step_logits(tp, ARCHS["test2l"], torch.from_numpy(enc),
                                   DecodeConfig(max_new_tokens=12))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3)


@pytest.mark.parametrize("change", [
    {"cross_kv_pool": 2}, {"cross_kv_merge": 4},
    {"cross_pallas": False}, {"self_pallas": False}])
def test_options_outside_the_slice_raise(change):
    with pytest.raises(NotImplementedError):
        make_transcribe_fn(ARCHS["test2l"], DecodeConfig(**change), device=DEV)


@pytest.mark.parametrize("kw", [{"sample_key": 0}, {"temperature": 0.2}])
def test_sampling_raises(kw):
    """Temperature sampling comes with the fallback ladder, a later slice."""
    enc = torch.zeros(1, 64, 64)
    with pytest.raises(NotImplementedError, match="fallback"):
        decode.greedy_decode({}, ARCHS["test2l"], enc, DecodeConfig(), **kw)


@pytest.mark.parametrize("kv", KV_CONFIGS)
def test_quantized_kv_tokens_match_jax(slice_params, kv):
    """Greedy tokens and lengths equal to the jitted JAX transcription
    function's with the int8 / int4 caches (EOT allowed: its twin makes
    rows stop at different steps)."""
    jp, tp = slice_params
    wav = _wav()
    jt, jl = jax_make_transcribe_fn(
        ARCH, JaxDecodeConfig(max_new_tokens=12, **KV_CONFIGS[kv]),
        use_pallas_mel=True)(jp, jnp.asarray(wav))
    tt, tl = make_transcribe_fn(ARCHS["test2l"], DecodeConfig(
        max_new_tokens=12, **KV_CONFIGS[kv]), device=DEV)(tp, wav)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("kv", KV_CONFIGS)
def test_quantized_kv_state_and_logits_match_jax(slice_params, kv):
    """The quantized cross-KV (bytes and scales) is bit-identical to the
    jitted JAX package's. The int8 self-KV cache after the batched prefill
    holds the same codes and scales up to the last bit of its inputs: the
    two frameworks' f32 layer norms round their sums differently (2.4e-7
    apart), which the projections carry into k/v, so a scale may differ by
    a few ulps (1e-6 relative) and a code by one step (the quantizer alone
    is bit-identical, test_int8_cache_update_matches_jax).
    The first-step logits lie within 1e-3 absolute of logits of order
    10."""
    jp, tp = slice_params
    kw = KV_CONFIGS[kv]
    enc = np.random.default_rng(3).standard_normal((2, 64, 64)).astype(np.float32)
    cfg = JaxDecodeConfig(max_new_tokens=12, **kw)
    bits = 4 if cfg.cross_kv_int4 else 8 if cfg.cross_kv_int8 else 16
    prefix = jax_decode.forced_prefix(ARCH, cfg)
    p_len = len(prefix)
    max_len = jax_decode._auto_cache_len(ARCH, p_len, cfg)
    toks = jnp.asarray([prefix] * 2, jnp.int32)

    @jax.jit
    def jax_state(p, e):
        kvs = jax_whisper.precompute_cross_kv_t(p, ARCH, e, bits=bits)
        cache = jax_cache.init_cache(p, ARCH, 2, max_len, int8=cfg.kv_int8)
        cache = jax_decode.prefill(p, ARCH, toks[:, : p_len - 1], cache, kvs)
        logits, _ = jax_decode.decoder_step(p, ARCH, toks[:, p_len - 1],
                                            jnp.asarray(p_len - 1), cache, kvs,
                                            max_len)
        return kvs, cache, logits

    j_kvs, j_cache, ref = jax_state(jp, jnp.asarray(enc))
    t_kvs, t_cache, tokens, *_ = decode._prepare(
        tp, ARCHS["test2l"], torch.from_numpy(enc),
        DecodeConfig(max_new_tokens=12, **kw))
    for jk, tk in zip(j_kvs, t_kvs):
        if bits == 16:
            assert tk.k_scale is None and tk.v_scale is None
            continue
        for name in ("k_t", "v_t", "k_scale", "v_scale"):
            np.testing.assert_array_equal(getattr(tk, name).numpy(),
                                          np.asarray(getattr(jk, name)))
    assert set(t_cache[0]) == set(j_cache[0])
    if cfg.kv_int8:
        for je, te in zip(j_cache, t_cache):
            for name in ("k", "v"):
                np.testing.assert_allclose(te[name].numpy(), np.asarray(je[name]),
                                           rtol=0, atol=1)
            for name in ("k_scale", "v_scale"):
                np.testing.assert_allclose(te[name].numpy(), np.asarray(je[name]),
                                           rtol=1e-6, atol=0)
    got = decode.decoder_step(tp, ARCHS["test2l"], tokens[:, p_len - 1],
                              p_len - 1, t_cache, t_kvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3)


@pytest.mark.parametrize("method", WEIGHT_METHODS)
def test_4bit_weights_tokens_match_jax(dense_params, method):
    """The 4-bit weight kinds through the whole slice (fused qkv, int8
    self-KV and cross-KV, EOT allowed), f32: greedy tokens and lengths equal
    to the jitted JAX transcription function's, from JAX's quantized tree
    carried over and from the port's own quantize + fuse (whose codes equal
    JAX's, and whose second-level scales and HQQ zeros differ in the last
    bits, `test_torch_quant4.py`)."""
    wav = _wav()
    cfg = dict(max_new_tokens=12, kv_int8=True, cross_kv_int8=True)
    jp = jax_fuse_qkv(jax_quantize(dense_params, method))
    jt, jl = jax_make_transcribe_fn(ARCH, JaxDecodeConfig(**cfg),
                                    use_pallas_mel=True)(jp, jnp.asarray(wav))
    fn = make_transcribe_fn(ARCHS["test2l"], DecodeConfig(**cfg), device=DEV)
    carried = from_numpy(jax.tree.map(np.asarray, jp), device=DEV)
    own = fuse_qkv(quantize_params(from_numpy(jax.tree.map(np.asarray,
                                                           dense_params), device=DEV), method))
    for tp in (carried, own):
        qkv = tp["decoder"]["layers"][0]["attn"]["qkv"]["w"]
        assert qkv.kind == jp["decoder"]["layers"][0]["attn"]["qkv"]["w"].kind
        tt, tl = fn(tp, wav)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("pos,t", [(0, 3), (5, 1), (28, 4)])
def test_int8_cache_update_matches_jax(pos, t):
    """The int8 cache's write of (B, H, T, Dh) rows (the prefill's path):
    codes and scales bit-identical to the jitted JAX `cache.update`, and
    `read` dequantizes as JAX's does."""
    rng = np.random.default_rng(pos)
    k, v = (rng.standard_normal((2, 2, 4, t, 16)) * 3).astype(np.float32)
    j_entry = jax_cache.init_cache(JP.init_params(ARCH, jax.random.PRNGKey(0)),
                                   ARCH, 2, 32, int8=True)[0]
    j_entry = jax.jit(jax_cache.update)(j_entry, jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(pos))
    t_entry = kv_cache.init_cache({"decoder": {"layers": [
        {"attn": {"q": {"w": torch.zeros(64, 64)}}}]}}, ARCHS["test2l"], 2, 32,
        int8=True, device=DEV)[0]
    kv_cache.update(t_entry, torch.from_numpy(k), torch.from_numpy(v), pos)
    assert set(t_entry) == set(j_entry)
    for name in t_entry:
        want = np.asarray(j_entry[name])
        assert t_entry[name].numpy().dtype == want.dtype
        np.testing.assert_array_equal(t_entry[name].numpy(), want)
    for got, want in zip(kv_cache.read(t_entry, torch.float32),
                         jax.jit(jax_cache.read, static_argnums=1)(
                             j_entry, jnp.float32)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import openai_whisper_compression_tpu_torch.evaluation.harness, "
            "openai_whisper_compression_tpu_torch.audio.mel_kernel, "
            "openai_whisper_compression_tpu_torch.ops.attention; "
            "assert 'openai_whisper_compression_tpu' not in sys.modules; "
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cpu_wrappers_never_load_the_library(monkeypatch):
    from openai_whisper_compression_tpu_torch.audio.mel_kernel import log_mel_cuda
    from openai_whisper_compression_tpu_torch.ops.attention import encoder_attention
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        decode_cross_attention_grouped, transpose_quant_kv)
    from openai_whisper_compression_tpu_torch.ops.quant_matmul import (
        group_asym_matmul, int4_matmul, int8_matmul, nf4_matmul)
    from openai_whisper_compression_tpu_torch.ops.self_attention_step import (
        decode_self_attention_update, decode_self_attention_update_int8)

    def refuse():
        raise AssertionError("a CPU call reached the CUDA kernel library")

    monkeypatch.setattr(kernels, "lib", refuse)
    monkeypatch.setattr(kernels, "build", refuse)
    counters = [(log_mel_cuda, "launches"), (int8_matmul, "launches"),
                (int4_matmul, "launches"), (nf4_matmul, "launches"),
                (group_asym_matmul, "launches"),
                (group_asym_matmul, "launches_u8"),
                (decode_cross_attention_grouped, "launches"),
                (decode_cross_attention_grouped, "launches_int8"),
                (decode_cross_attention_grouped, "launches_int4"),
                (transpose_quant_kv, "launches"),
                (decode_cross_attention_grouped, "launches_int8_wide"),
                (decode_self_attention_update, "launches"),
                (decode_self_attention_update, "launches_start"),
                (decode_self_attention_update_int8, "launches"),
                (decode_self_attention_update_int8, "launches_start"),
                (encoder_attention, "launches")]
    counts = [getattr(f, a) for f, a in counters]
    log_mel_cuda(torch.zeros(1, N), 80)
    int8_matmul(torch.ones(2, 64), torch.ones(64, 64, dtype=torch.int8),
                torch.ones(1, 64))
    x, nib, g = torch.ones(2, 256), torch.ones(128, 64, dtype=torch.int8), torch.ones(4, 64)
    int4_matmul(x, nib, torch.ones(1, 64))
    nf4_matmul(x, nib, g, "nf4", 64)
    group_asym_matmul(x, nib, g, g, 64)
    group_asym_matmul(x, torch.ones(256, 64, dtype=torch.uint8), g[:2], g[:2], 128)
    decode_cross_attention_grouped(torch.ones(4, 1, 64), torch.ones(4, 64, 128),
                                   torch.ones(4, 64, 128), s_valid=100)
    k8, s8 = transpose_quant_kv(torch.ones(2, 100, 128), 2)
    decode_cross_attention_grouped(torch.ones(4, 3, 64), k8, k8, s8, s8, 100)
    decode_cross_attention_grouped(torch.ones(4, 19, 64), k8, k8, s8, s8, 100)
    encoder_attention(*torch.ones(3, 1, 2, 256, 64))
    k4 = k8[:, :32].contiguous()
    decode_cross_attention_grouped(torch.ones(4, 1, 64), k4, k4, s8, s8, 100)
    decode_self_attention_update(torch.ones(4, 64), torch.ones(4, 64),
                                 torch.ones(4, 64), torch.zeros(4, 8, 64),
                                 torch.zeros(4, 8, 64), 3,
                                 start=torch.ones(4, dtype=torch.int32))
    decode_self_attention_update_int8(
        torch.ones(4, 64), torch.ones(4, 64), torch.ones(4, 64),
        torch.zeros(4, 8, 64, dtype=torch.int8),
        torch.zeros(4, 8, 64, dtype=torch.int8), torch.zeros(4, 8),
        torch.zeros(4, 8), 3, start=torch.ones(4, dtype=torch.int32))
    assert counts == [getattr(f, a) for f, a in counters]
