"""Transcription at small batches and the read-only self-attention, the port
against the JAX package: the one-query cross-attention's plain version
against the Pallas `decode_cross_attention` in interpret mode (bf16, int8 and
int4 K/V), the rule that sends a decode step to it (B·H % 16 != 0) against
JAX's own dispatch, `decode_self_attention`'s plain version against the
Pallas kernel's four bodies and against the port's update functions, and
batch-1 and batch-3 greedy tokens on `test2l` against the jitted JAX
transcription function. Tolerances are stated in each test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.evaluation.harness import (
    make_transcribe_fn as jax_make_transcribe_fn)
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.models import whisper as jax_whisper
from openai_whisper_compression_tpu.models.fuse import fuse_qkv as jax_fuse_qkv
from openai_whisper_compression_tpu.ops import cross_attention as jax_cross
from openai_whisper_compression_tpu.ops import linear as jax_linear_mod
from openai_whisper_compression_tpu.ops.self_attention_step import (
    decode_self_attention as jax_self_attention)
from openai_whisper_compression_tpu.quant.api import quantize_params as jax_quantize
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
from openai_whisper_compression_tpu_torch.models import decode, whisper
from openai_whisper_compression_tpu_torch.models.params import from_numpy
from openai_whisper_compression_tpu_torch.ops import cross_attention as xattn
from openai_whisper_compression_tpu_torch.ops import kernels
from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas
from openai_whisper_compression_tpu_torch.ops.cross_attention import (
    decode_cross_attention, decode_cross_attention_grouped,
    decode_cross_attention_ref, pad_cross_len)
from openai_whisper_compression_tpu_torch.ops.self_attention_step import (
    decode_self_attention, decode_self_attention_ref,
    decode_self_attention_update, decode_self_attention_update_int8)

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

ARCH = JAX_ARCHS["test2l"]
N = 20480  # test2l's waveform samples
STD, EOT_TWIN = 0.5, 611   # as tests/test_torch_slice.py: varied tokens, early stops


def _cross_inputs(kind, bh, s, seed, poison=True):
    """(q (BH, 64), k_t, v_t, k_scale, v_scale) as numpy: seeded K/V, for
    int8 / int4 quantized by the jitted JAX package; finite garbage past
    s_valid where `poison`."""
    rng = np.random.default_rng(seed)
    sp = pad_cross_len(s)
    q = (rng.standard_normal((bh, 64)) * 0.125).astype(np.float32)
    if kind == "bf16":
        k, v = rng.standard_normal((2, bh, 64, sp)).astype(np.float32)
        if poison:
            k[:, :, s:], v[:, :, s:] = 100.0, -77.0
        return q, k, v, None, None
    quant = jax_whisper._quant_kv4_t if kind == "int4" else jax_whisper._quant_kv8_t
    out = []
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal((bh, 64, sp)), jnp.float32)
        data, scale = (np.asarray(a).copy() for a in jax.jit(quant)(x))
        if poison:
            data[:, :, s:] = 100
            scale[:, :, s:] = 3.0
        out.append((data, scale))
    (k, ks), (v, vs) = out
    return q, k, v, ks, vs


def _t(a, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(a)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


@pytest.mark.parametrize("bh", [12, 36])
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_cross_attention_plain_matches_pallas(kind, bh):
    """`decode_cross_attention_ref` against the Pallas kernel's three bodies
    in interpret mode at the row counts of whisper-small at batch 1 and 3,
    s_valid < S_pad with garbage in the padding: f32 math on identical
    operands in another sum order, 1e-5 absolute on outputs of order 0.1-1.
    The wrapper on a CPU tensor is the plain version, and equals the grouped
    function at one slot."""
    s = 100
    q, k, v, ks, vs = _cross_inputs(kind, bh, s, bh)
    args = [jnp.asarray(a) for a in (q, k, v)]
    scales = {} if ks is None else {"k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)}
    ref = np.asarray(jax_cross.decode_cross_attention(*args, **scales, s_valid=s))
    targs = (_t(q), _t(k), _t(v), _t(ks), _t(vs), s)
    got = decode_cross_attention_ref(*targs)
    assert got.shape == (bh, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    before = (decode_cross_attention.launches, decode_cross_attention.launches_int8,
              decode_cross_attention.launches_int4)
    assert torch.equal(decode_cross_attention(*targs), got)
    assert before == (decode_cross_attention.launches,
                      decode_cross_attention.launches_int8,
                      decode_cross_attention.launches_int4)
    grouped = decode_cross_attention_grouped(targs[0][:, None, :], *targs[1:])
    assert torch.equal(grouped[:, 0, :], got)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_cross_attention_plain_bf16_and_padding(kind):
    """bf16 q and K/V: within one bf16 rounding (2**-8) of the Pallas output;
    and garbage past s_valid changes no output bit."""
    s, bh = 70, 12
    q, k, v, ks, vs = _cross_inputs(kind, bh, s, 5)
    jd = jnp.bfloat16
    args = [jnp.asarray(q, jd)] + [jnp.asarray(a, jd) if kind == "bf16" else jnp.asarray(a)
                                   for a in (k, v)]
    scales = {} if ks is None else {"k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)}
    ref = np.asarray(jax_cross.decode_cross_attention(*args, **scales, s_valid=s)
                     .astype(jnp.float32))
    bf = torch.bfloat16
    dirty = (_t(q, bf), _t(k, bf), _t(v, bf), _t(ks), _t(vs), s)
    got = decode_cross_attention(*dirty)
    assert got.dtype == bf
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -8, atol=2 ** -8)
    qc, kc, vc, ksc, vsc = _cross_inputs(kind, bh, s, 5, poison=False)
    clean = (_t(qc, bf), _t(kc, bf), _t(vc, bf), _t(ksc), _t(vsc), s)
    assert torch.equal(decode_cross_attention(*clean), got)


# ---------------------------------------------------------------------------
# the dispatch rule
# ---------------------------------------------------------------------------

def _dense_cross_params(seed=0):
    rng = np.random.default_rng(seed)
    d = 64
    w = lambda: (rng.standard_normal((d, d)) * 0.1).astype(np.float32)   # noqa: E731
    b = lambda: (rng.standard_normal(d) * 0.1).astype(np.float32)        # noqa: E731
    return {"q": {"w": w(), "b": b()}, "k": {"w": w()}, "v": {"w": w(), "b": b()},
            "o": {"w": w(), "b": b()}}


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 5, 8, 9, 12, 16])
def test_step_dispatch_rule_matches_jax(monkeypatch, batch):
    """A decode step (one position, no beams) over K/V of B·H rows goes to
    the one-query function exactly where the JAX package's `cross_t_apply`
    does on a TPU (B·H % 16 != 0; `test2l` has 4 heads, so batches 4, 8, 12
    and 16 stay grouped), on the CPU as on the card; the prefill window and
    the beams stay grouped at every B·H. Both routes give the same values
    (1e-5: the JAX side runs its Pallas kernels in interpret mode)."""
    arch = ARCHS["test2l"]
    dh, h = arch.head_dim, arch.decoder_heads
    p = _dense_cross_params()
    rng = np.random.default_rng(batch)
    enc = rng.standard_normal((batch, 40, 64)).astype(np.float32)
    x = rng.standard_normal((batch, 1, 64)).astype(np.float32)

    # the JAX package, made to take its TPU route (Pallas in interpret mode)
    jax_calls = []
    monkeypatch.setattr(jax_linear_mod, "_on_tpu", lambda: True)
    for name in ("decode_cross_attention", "decode_cross_attention_grouped"):
        orig = getattr(jax_cross, name)
        monkeypatch.setattr(jax_cross, name, lambda *a, _o=orig, _n=name, **k: (
            jax_calls.append(_n), _o(*a, **k))[1])
    jp = jax.tree.map(jnp.asarray, p)
    jkv = jax_whisper.precompute_cross_kv_t({"decoder": {"layers": [{"cross": jp}]}},
                                            JAX_ARCHS["test2l"], jnp.asarray(enc))[0]
    ref = jax_whisper.cross_attention(jp, jnp.asarray(x), jkv, dh)

    calls = []
    for name in ("decode_cross_attention", "decode_cross_attention_grouped"):
        orig = getattr(whisper, name)
        monkeypatch.setattr(whisper, name, lambda *a, _o=orig, _n=name, **k: (
            calls.append(_n), _o(*a, **k))[1])
    tp = from_numpy(p, device=DEV)
    kv = whisper.precompute_cross_kv_t({"decoder": {"layers": [{"cross": tp}]}}, arch,
                                       torch.from_numpy(enc))[0]
    got = whisper.cross_attention(tp, torch.from_numpy(x), kv, dh)
    assert kv.k_t.shape[0] == batch * h
    expected = ("decode_cross_attention_grouped" if (batch * h) % 16 == 0
                else "decode_cross_attention")
    assert calls == [expected] and jax_calls == [expected]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)

    calls.clear()
    window = torch.from_numpy(rng.standard_normal((batch, 3, 64)).astype(np.float32))
    whisper.cross_window_attention(tp, window, kv, dh)
    whisper.cross_window_attention(tp, window[:, :1], kv, dh)   # a one-position window
    beams = torch.from_numpy(rng.standard_normal((batch * 2, 1, 64)).astype(np.float32))
    whisper.grouped_cross_attention(tp, beams, kv, dh, 2)
    assert calls == ["decode_cross_attention_grouped"] * 3
    with pytest.raises(ValueError, match="one decode position"):
        whisper.cross_attention(tp, window, kv, dh)


# ---------------------------------------------------------------------------
# the read-only self-attention
# ---------------------------------------------------------------------------

def _mixed_start(bh, pos):
    start = np.arange(bh) * 3 % (pos + 1)
    start[1] = pos
    return start.astype(np.int32)


@pytest.mark.parametrize("with_start", [False, True], ids=["nostart", "start"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("pos", [0, 7, 15])
def test_self_attention_plain_matches_pallas(pos, int8, with_start):
    """`decode_self_attention_ref` against the Pallas kernel's four bodies
    (`_kernel`, `_kernel_nostart`, `_kernel_int8`, `_kernel_int8_nostart`) in
    interpret mode over a 16-row cache whose rows past `pos` hold garbage:
    f32 within 1e-5 absolute; nothing is written; and on the cache that the
    port's update function wrote it returns that function's output bit for
    bit."""
    bh, s, dh = 16, 16, 64
    rng = np.random.default_rng(10 * pos + int8)
    q = (rng.standard_normal((bh, dh)) * 0.125).astype(np.float32)
    kn, vn = rng.standard_normal((2, bh, dh)).astype(np.float32)
    start = _mixed_start(bh, pos) if with_start else None
    if int8:
        kc, vc = rng.integers(-127, 128, (2, bh, s, dh)).astype(np.int8)
        ks, vs = rng.uniform(0.005, 0.03, (2, bh, s)).astype(np.float32)
        bufs = [torch.from_numpy(a.copy()) for a in (kc, vc, ks, vs)]
        upd = decode_self_attention_update_int8
    else:
        kc, vc = rng.standard_normal((2, bh, s, dh)).astype(np.float32)
        bufs = [torch.from_numpy(a.copy()) for a in (kc, vc)]
        upd = decode_self_attention_update
    t_start = None if start is None else torch.from_numpy(start)
    # the update writes row pos (quantized in the int8 cache) and attends
    out_upd = upd(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
                  *bufs, pos, start=t_start)
    written = [b.clone() for b in bufs]
    scales = {} if not int8 else {"k_scale": bufs[2], "v_scale": bufs[3]}
    got = decode_self_attention_ref(torch.from_numpy(q), bufs[0], bufs[1], pos,
                                    start=t_start, **scales)
    assert got.shape == (bh, dh) and got.dtype == torch.float32
    assert torch.equal(got, out_upd)
    before = [getattr(decode_self_attention, a) for a in
              ("launches", "launches_start", "launches_int8", "launches_int8_start")]
    assert torch.equal(decode_self_attention(torch.from_numpy(q), bufs[0], bufs[1], pos,
                                             start=t_start, **scales), got)
    assert before == [getattr(decode_self_attention, a) for a in
                      ("launches", "launches_start", "launches_int8",
                       "launches_int8_start")]
    assert all(torch.equal(a, b) for a, b in zip(bufs, written))
    jscales = {} if not int8 else {"k_scale": jnp.asarray(bufs[2].numpy()),
                                   "v_scale": jnp.asarray(bufs[3].numpy())}
    ref = jax_self_attention(jnp.asarray(q), jnp.asarray(bufs[0].numpy()),
                             jnp.asarray(bufs[1].numpy()), jnp.asarray(pos),
                             start=None if start is None else jnp.asarray(start),
                             **jscales)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    if with_start and pos:
        plain = decode_self_attention_ref(torch.from_numpy(q), bufs[0], bufs[1], pos,
                                          **scales)
        assert not torch.equal(plain, got)   # `start` is honoured


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_self_attention_plain_bf16(int8):
    """bf16 q (and cache): within one bf16 rounding (2**-8) of the Pallas
    kernel's output of order 1."""
    bh, s, dh, pos = 8, 16, 64, 9
    rng = np.random.default_rng(3 + int8)
    q = (rng.standard_normal((bh, dh)) * 0.125).astype(np.float32)
    start = _mixed_start(bh, pos)
    bf = torch.bfloat16
    if int8:
        kc, vc = rng.integers(-127, 128, (2, bh, s, dh)).astype(np.int8)
        ks, vs = rng.uniform(0.005, 0.03, (2, bh, s)).astype(np.float32)
        caches_j, caches_t = [jnp.asarray(kc), jnp.asarray(vc)], [_t(kc), _t(vc)]
        js = {"k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)}
        ts = {"k_scale": _t(ks), "v_scale": _t(vs)}
    else:
        kc, vc = rng.standard_normal((2, bh, s, dh)).astype(np.float32)
        caches_j = [jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16)]
        caches_t = [_t(kc, bf), _t(vc, bf)]
        js, ts = {}, {}
    ref = jax_self_attention(jnp.asarray(q, jnp.bfloat16), *caches_j, jnp.asarray(pos),
                             start=jnp.asarray(start), **js)
    got = decode_self_attention(_t(q, bf), *caches_t, pos, start=_t(start), **ts)
    assert got.dtype == bf
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -8, atol=2 ** -8)


def test_new_cpu_wrappers_never_load_the_library(monkeypatch):
    """On CPU tensors the w8a8, one-query and read-only wrappers take
    their plain versions: the CUDA library is neither built nor loaded, no
    launch is counted."""
    from openai_whisper_compression_tpu_torch.ops.quant_matmul import w8a8_matmul

    def refuse():
        raise AssertionError("a CPU call reached the CUDA kernel library")

    monkeypatch.setattr(kernels, "lib", refuse)
    monkeypatch.setattr(kernels, "build", refuse)
    counters = [(w8a8_matmul, "launches"), (w8a8_matmul, "launches_static"),
                (xattn.decode_cross_attention, "launches"),
                (xattn.decode_cross_attention, "launches_int8"),
                (xattn.decode_cross_attention, "launches_int4"),
                (sas.decode_self_attention, "launches"),
                (sas.decode_self_attention, "launches_start"),
                (sas.decode_self_attention, "launches_int8"),
                (sas.decode_self_attention, "launches_int8_start")]
    counts = [getattr(f, a) for f, a in counters]
    w = torch.ones(64, 32, dtype=torch.int8)
    w8a8_matmul(torch.ones(2, 64), w, torch.ones(1, 32))
    w8a8_matmul(torch.ones(2, 64).bfloat16(), w, torch.ones(1, 32), torch.tensor(0.5))
    k8 = torch.ones(12, 64, 128, dtype=torch.int8)
    s8 = torch.ones(12, 1, 128)
    xattn.decode_cross_attention(torch.ones(12, 64), torch.ones(12, 64, 128),
                                 torch.ones(12, 64, 128), s_valid=100)
    xattn.decode_cross_attention(torch.ones(12, 64), k8, k8, s8, s8, 100)
    k4 = k8[:, :32].contiguous()
    xattn.decode_cross_attention(torch.ones(12, 64), k4, k4, s8, s8, 100)
    start = torch.ones(4, dtype=torch.int32)
    for st in (None, start):
        sas.decode_self_attention(torch.ones(4, 64), torch.zeros(4, 8, 64),
                                  torch.zeros(4, 8, 64), 3, start=st)
        sas.decode_self_attention(torch.ones(4, 64),
                                  torch.zeros(4, 8, 64, dtype=torch.int8),
                                  torch.zeros(4, 8, 64, dtype=torch.int8), 3, start=st,
                                  k_scale=torch.ones(4, 8), v_scale=torch.ones(4, 8))
    assert counts == [getattr(f, a) for f, a in counters]


# ---------------------------------------------------------------------------
# the slice at batch 1 and 3
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slice_params():
    p = JP.init_params_jit(ARCH, jax.random.PRNGKey(0), std=STD)
    embed = np.asarray(p["decoder"]["embed"]).copy()
    embed[ARCH.eos_token_id] = 1.3 * embed[EOT_TWIN]
    p["decoder"] = {**p["decoder"], "embed": jnp.asarray(embed)}
    jp = jax_fuse_qkv(jax_quantize(p, "int8"))
    return jp, from_numpy(jax.tree.map(np.asarray, jp), device=DEV)


SMALL_KV = {"bf16": {}, "kv8-ckv8": {"kv_int8": True, "cross_kv_int8": True},
            "kv8-ckv4": {"kv_int8": True, "cross_kv_int4": True}}


@pytest.mark.parametrize("kv", SMALL_KV)
@pytest.mark.parametrize("batch", [1, 3])
def test_small_batch_tokens_match_jax(slice_params, monkeypatch, batch, kv):
    """Greedy tokens and lengths at batch 1 and 3 (B·H = 4 and 12: every
    decode step takes the one-query cross-attention, the prefill the grouped
    one) equal to the jitted JAX transcription function's, for bf16, int8 and
    int4 cross-KV (f32, int8 weights, EOT allowed)."""
    jp, tp = slice_params
    rng = np.random.default_rng(batch)
    wav = (rng.standard_normal((batch, N)) * np.array([1.0, 0.1, 0.5])[:batch, None]
           ).astype(np.float32)
    cfg = dict(max_new_tokens=12, **SMALL_KV[kv])
    jt, jl = jax_make_transcribe_fn(ARCH, JaxDecodeConfig(**cfg),
                                    use_pallas_mel=True)(jp, jnp.asarray(wav))
    calls = []
    for name in ("decode_cross_attention", "decode_cross_attention_grouped"):
        orig = getattr(whisper, name)
        monkeypatch.setattr(whisper, name, lambda *a, _o=orig, _n=name, **k: (
            calls.append(_n), _o(*a, **k))[1])
    tt, tl = make_transcribe_fn(ARCHS["test2l"], DecodeConfig(**cfg), device=DEV)(tp, wav)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    layers = ARCH.decoder_layers
    p_len = len(decode.forced_prefix(ARCHS["test2l"], DecodeConfig(**cfg)))
    steps = int(tl.max()) - p_len   # the loop ends once every row has stopped
    assert calls.count("decode_cross_attention_grouped") == (layers if p_len > 1 else 0)
    assert calls.count("decode_cross_attention") == layers * steps
