"""The port's slice as a whole against the JAX package on `test2l`:
int8 weights + fused decoder qkv, f32, the JAX transcription function with
the Pallas mel kernel (interpret mode on the CPU). Tokens and lengths must
match exactly; encoder states and first-step logits within stated bounds.
Also: the port imports without jax, options outside the slice raise, and a
CPU call to a kernel wrapper never loads the CUDA library."""

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
from openai_whisper_compression_tpu_torch.models import decode, whisper
from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
from openai_whisper_compression_tpu_torch.models.params import from_numpy
from openai_whisper_compression_tpu_torch.ops import kernels
from openai_whisper_compression_tpu_torch.quant.api import quantize_params

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
ARCH = JAX_ARCHS["test2l"]
N = 20480  # test2l's waveform samples
# std 0.5 weights give varied tokens per utterance (std 0.02 repeats one
# token); EOT's embedding row is tied to token 611's so some rows stop early
STD, EOT_TWIN = 0.5, 611


@pytest.fixture(scope="module")
def slice_params():
    p = JP.init_params_jit(ARCH, jax.random.PRNGKey(0), std=STD)
    embed = np.asarray(p["decoder"]["embed"]).copy()
    embed[ARCH.eos_token_id] = 1.3 * embed[EOT_TWIN]
    p["decoder"] = {**p["decoder"], "embed": jnp.asarray(embed)}
    jp = jax_fuse_qkv(jax_quantize(p, "int8"))
    tp = from_numpy(jax.tree.map(np.asarray, jp))
    # the port's own quantize + fuse gives the same tree (bytes pinned in
    # test_torch_quant.py); run the slice on the port-built one
    tp_own = fuse_qkv(quantize_params(from_numpy(jax.tree.map(np.asarray, p)),
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
                                             suppress_tokens=sup))(tp, wav)
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
    {"beam_size": 2}, {"kv_int8": True}, {"cross_kv_int8": True},
    {"cross_kv_int4": True}, {"cross_kv_pool": 2}, {"cross_kv_merge": 4},
    {"cross_pallas": False}, {"self_pallas": False}])
def test_options_outside_the_slice_raise(change):
    with pytest.raises(NotImplementedError):
        make_transcribe_fn(ARCHS["test2l"], DecodeConfig(**change))


def test_timestamps_raise():
    with pytest.raises(NotImplementedError):
        make_transcribe_fn(ARCHS["test2l-ts"], DecodeConfig(notimestamps=False))


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import openai_whisper_compression_tpu_torch.evaluation.harness, "
            "openai_whisper_compression_tpu_torch.audio.mel_kernel; "
            "assert 'openai_whisper_compression_tpu' not in sys.modules; "
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cpu_wrappers_never_load_the_library(monkeypatch):
    from openai_whisper_compression_tpu_torch.audio.mel_kernel import log_mel_cuda
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        decode_cross_attention_grouped)
    from openai_whisper_compression_tpu_torch.ops.quant_matmul import int8_matmul
    from openai_whisper_compression_tpu_torch.ops.self_attention_step import (
        decode_self_attention_update)

    def refuse():
        raise AssertionError("a CPU call reached the CUDA kernel library")

    monkeypatch.setattr(kernels, "lib", refuse)
    monkeypatch.setattr(kernels, "build", refuse)
    counts = [f.launches for f in (log_mel_cuda, int8_matmul,
                                   decode_cross_attention_grouped,
                                   decode_self_attention_update)]
    log_mel_cuda(torch.zeros(1, N), 80)
    int8_matmul(torch.ones(2, 64), torch.ones(64, 64, dtype=torch.int8),
                torch.ones(1, 64))
    decode_cross_attention_grouped(torch.ones(4, 1, 64), torch.ones(4, 64, 128),
                                   torch.ones(4, 64, 128), 100)
    decode_self_attention_update(torch.ones(4, 64), torch.ones(4, 64),
                                 torch.ones(4, 64), torch.zeros(4, 8, 64),
                                 torch.zeros(4, 8, 64), 3)
    assert counts == [f.launches for f in (log_mel_cuda, int8_matmul,
                                           decode_cross_attention_grouped,
                                           decode_self_attention_update)]
