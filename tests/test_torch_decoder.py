"""The port's full-sequence decoder and unfused decode step against the
jitted JAX package on `test2l` in f32: `decode_logits`, `forward` and
`nll_loss` (dense and int8 weights, with and without head masks), the
standard-layout cross-KV (`precompute_cross_kv`, `read_cross_kv`,
`cross_attention`, `grouped_cross_attention`), the unfused step
(`self_pallas` / `cross_pallas` False) for greedy and beam 5 over fp and
int8 caches, `encode(merge_at=)` and `unfuse_qkv`. Integers (cross-KV
codes, tokens, lengths) must be equal; float bounds are stated per test.
Weights come from `init_params_jit` (std 0.5, EOT tied to a token so some
rows stop early) through `from_numpy`; inputs from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.models import decode as jax_decode
from openai_whisper_compression_tpu.models import fuse as jax_fuse
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.models import whisper as jax_whisper
from openai_whisper_compression_tpu.quant.api import quantize_params as jax_quantize
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.models import decode, whisper
from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv, unfuse_qkv
from openai_whisper_compression_tpu_torch.models.params import from_numpy, named_leaves
from openai_whisper_compression_tpu_torch.ops.qtensor import QTensor
from openai_whisper_compression_tpu_torch.quant.api import quantize_params

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

ARCH, T_ARCH = JAX_ARCHS["test2l"], ARCHS["test2l"]
STD, EOT_TWIN = 0.5, 611
CACHES = {"fp": {}, "kv8-ckv8": {"kv_int8": True, "cross_kv_int8": True}}
# the unfused settings: the self-attention, the cross-KV layout, both
UNFUSED = {"self": {"self_pallas": False}, "cross": {"cross_pallas": False},
           "both": {"self_pallas": False, "cross_pallas": False}}
# logits of order 15 from f32 sums in another order: 1e-3 absolute
LOGITS_ATOL = 1e-3


@pytest.fixture(scope="module")
def trees():
    """{"f32": (JAX tree, torch tree), "int8": ...}, the dense tree with
    EOT's embedding tied to 1.3 x token 611's."""
    p = JP.init_params_jit(ARCH, jax.random.PRNGKey(0), std=STD)
    embed = np.asarray(p["decoder"]["embed"]).copy()
    embed[ARCH.eos_token_id] = 1.3 * embed[EOT_TWIN]
    p["decoder"] = {**p["decoder"], "embed": jnp.asarray(embed)}
    out = {}
    for name, jp in (("f32", p), ("int8", jax_quantize(p, "int8"))):
        out[name] = (jp, from_numpy(jax.tree.map(np.asarray, jp), device=DEV))
    return out


def _enc(seed=2, b=3, s=64):
    return np.random.default_rng(seed).standard_normal((b, s, 64)).astype(np.float32)


def _tokens(seed=3, b=3, l=9):
    return np.random.default_rng(seed).integers(0, 997, (b, l)).astype(np.int32)


def _head_masks(seed, masked):
    if not masked:
        return None
    rng = np.random.default_rng(seed)
    return rng.choice([0.0, 0.5, 1.0], size=(2, 4)).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "headmask"])
@pytest.mark.parametrize("weights", ["f32", "int8"])
def test_decode_logits_matches_jax(trees, weights, masked):
    jp, tp = trees[weights]
    enc, toks = _enc(), _tokens()
    sm, cm = _head_masks(1, masked), _head_masks(2, masked)
    ref = jax.jit(lambda p, t, e, a, c: jax_whisper.decode_logits(
        p, ARCH, t, e, a, c))(jp, jnp.asarray(toks), jnp.asarray(enc), _j(sm), _j(cm))
    got = whisper.decode_logits(tp, T_ARCH, torch.from_numpy(toks).long(),
                                torch.from_numpy(enc), _t(sm), _t(cm))
    assert got.shape == (3, 9, T_ARCH.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LOGITS_ATOL)


def _mel(seed=4, b=2):
    return np.random.default_rng(seed).standard_normal((b, 80, 128)).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "headmask"])
@pytest.mark.parametrize("weights", ["f32", "int8"])
def test_forward_and_nll_loss_match_jax(trees, weights, masked):
    """forward's logits within LOGITS_ATOL; nll_loss, with and without a
    label mask, within 1e-5 relative (a mean of log-softmax terms)."""
    jp, tp = trees[weights]
    mel, toks = _mel(), _tokens(5, b=2, l=7)
    labels = np.roll(toks, -1, axis=1)
    lmask = (np.arange(7)[None, :] < np.array([[5], [7]])).astype(np.float32)
    em, dm, cm = (_head_masks(s, masked) for s in (6, 7, 8))
    args_j = (jnp.asarray(mel), jnp.asarray(toks))
    args_t = (torch.from_numpy(mel), torch.from_numpy(toks).long())
    ref = jax.jit(lambda p, m, t, a, b, c: jax_whisper.forward(
        p, ARCH, m, t, a, b, c))(jp, *args_j, _j(em), _j(dm), _j(cm))
    got = whisper.forward(tp, T_ARCH, *args_t, _t(em), _t(dm), _t(cm))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LOGITS_ATOL)
    for lm in (None, lmask):
        nll_j = jax.jit(lambda p, m, t, l, k, a, b, c: jax_whisper.nll_loss(
            p, ARCH, m, t, l, k, a, b, c))(jp, *args_j, jnp.asarray(labels), _j(lm),
                                           _j(em), _j(dm), _j(cm))
        nll_t = whisper.nll_loss(tp, T_ARCH, *args_t, torch.from_numpy(labels),
                                 _t(lm), _t(em), _t(dm), _t(cm))
        assert nll_t.dim() == 0
        np.testing.assert_allclose(float(nll_t), float(nll_j), rtol=1e-5)


@pytest.mark.parametrize("weights", ["f32", "int8"])
def test_precompute_cross_kv_int8_matches_jax(trees, weights):
    """The standard-layout cross-KV: int8 codes and scales bit-equal to the
    jitted JAX package's, the dense K/V within 1e-5, and `read_cross_kv`'s
    dequantization bit-equal on the same entries."""
    jp, tp = trees[weights]
    enc = _enc(11)
    for int8 in (False, True):
        kj = jax.jit(lambda p, e: jax_whisper.precompute_cross_kv(
            p, ARCH, e, int8=int8))(jp, jnp.asarray(enc))
        kt = whisper.precompute_cross_kv(tp, T_ARCH, torch.from_numpy(enc), int8=int8)
        assert len(kt) == len(kj) == 2
        for ej, et in zip(kj, kt):
            for j, t in zip(jax.tree.leaves(ej), (x for kv in et for x in
                                                  (kv if int8 else (kv,)))):
                assert t.shape == j.shape and t.numpy().dtype == np.asarray(j).dtype
                if int8:
                    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
                else:
                    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
        if int8:   # read_cross_kv of JAX's own entries, in both dtypes
            for ej in kj:
                et = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ej,
                                  is_leaf=lambda a: isinstance(a, jax.Array))
                for jd, td in ((jnp.float32, torch.float32),
                               (jnp.bfloat16, torch.bfloat16)):
                    rj = jax.jit(lambda e: jax_whisper.read_cross_kv(e, jd))(ej)
                    rt = whisper.read_cross_kv(et, td)
                    for a, b in zip(rt, rj):
                        np.testing.assert_array_equal(a.float().numpy(),
                                                      np.asarray(b, np.float32))


def test_quant_kv8_bit_equal_to_jax():
    x = (np.random.default_rng(12).standard_normal((2, 3, 37, 64)) * 4).astype(np.float32)
    x[0, 0, 3] = 0.0   # an all-zero row takes the 1e-12 floor
    qj, sj = jax.jit(jax_whisper._quant_kv8)(jnp.asarray(x))
    qt, st = whisper._quant_kv8(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "headmask"])
def test_standard_layout_cross_attention_matches_jax(trees, int8, masked):
    """`cross_attention` (a window of 5 positions, with an optional head
    mask) and `grouped_cross_attention` (3 utterances x 4 beams) over
    standard-layout cross-KV: within 1e-5 of the reference's largest
    magnitude (outputs of order 30; f32 sums in another order)."""
    jp, tp = trees["f32"]
    layer_j = jp["decoder"]["layers"][0]["cross"]
    layer_t = tp["decoder"]["layers"][0]["cross"]
    enc = _enc(13)
    kv_j = jax_whisper.precompute_cross_kv(jp, ARCH, jnp.asarray(enc), int8=int8)[0]
    kv_t = whisper.precompute_cross_kv(tp, T_ARCH, torch.from_numpy(enc), int8=int8)[0]
    x = np.random.default_rng(14).standard_normal((3, 5, 64)).astype(np.float32)
    hm = _head_masks(15, masked)
    ref = jax.jit(lambda x, kv, m: jax_whisper.cross_attention(
        layer_j, x, kv, 16, head_mask=m))(jnp.asarray(x), kv_j,
                                          None if hm is None else jnp.asarray(hm[0]))
    got = whisper.cross_attention(layer_t, torch.from_numpy(x), kv_t, 16,
                                  head_mask=None if hm is None else torch.from_numpy(hm[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=1e-5 * float(np.abs(ref).max()))
    xb = np.random.default_rng(16).standard_normal((12, 1, 64)).astype(np.float32)
    ref = jax.jit(lambda x, kv: jax_whisper.grouped_cross_attention(
        layer_j, x, kv, 16, 4))(jnp.asarray(xb), kv_j)
    got = whisper.grouped_cross_attention(layer_t, torch.from_numpy(xb), kv_t, 16, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=1e-5 * float(np.abs(ref).max()))


def test_cross_attention_refuses_a_head_mask_on_the_fused_layout(trees):
    _, tp = trees["f32"]
    kv = whisper.precompute_cross_kv_t(tp, T_ARCH, torch.from_numpy(_enc(1)))[0]
    with pytest.raises(ValueError, match="head_mask"):
        whisper.cross_attention(tp["decoder"]["layers"][0]["cross"],
                                torch.zeros(3, 1, 64), kv, 16,
                                head_mask=torch.ones(4))


def _decode(fn_name, jp, tp, cfg_kw, enc):
    ref = jax.jit(lambda p, e: getattr(jax_decode, fn_name)(
        p, ARCH, e, JaxDecodeConfig(**cfg_kw)))(jp, jnp.asarray(enc))
    with torch.inference_mode():
        got = getattr(decode, fn_name)(tp, T_ARCH, torch.from_numpy(enc),
                                       DecodeConfig(**cfg_kw))
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


@pytest.mark.parametrize("unfused", UNFUSED)
@pytest.mark.parametrize("caches", CACHES)
@pytest.mark.parametrize("fn_name", ["greedy_decode", "beam_decode"])
def test_unfused_step_tokens_match_fused_and_jax(trees, fn_name, caches, unfused):
    """The unfused step's tokens and lengths equal the jitted JAX
    package's for the same configuration, and equal the port's fused step's
    wherever JAX's fused and unfused configurations agree (beam 5 for
    `beam_decode`; int8 weights, fused qkv)."""
    jp, tp = trees["int8"]
    jp, tp = jax_fuse.fuse_qkv(jp), fuse_qkv(tp)
    enc = _enc(17, b=4)
    base = dict(max_new_tokens=10, beam_size=5 if fn_name == "beam_decode" else 1,
                **CACHES[caches])
    ref_u, got_u = _decode(fn_name, jp, tp, {**base, **UNFUSED[unfused]}, enc)
    ref_f, got_f = _decode(fn_name, jp, tp, base, enc)
    for ref, got in ((ref_u, got_u), (ref_f, got_f)):
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[0], ref[0])
    if all(np.array_equal(a, b) for a, b in zip(ref_u, ref_f)):
        for a, b in zip(got_u, got_f):
            np.testing.assert_array_equal(a, b)
    if fn_name == "greedy_decode" and caches == "fp":  # the EOT twin stops rows
        assert len(set(got_u[1].tolist())) > 1


def test_cross_kv_int4_without_cross_pallas_raises_as_jax(trees):
    jp, tp = trees["int8"]
    cfg = dict(max_new_tokens=4, cross_kv_int4=True, cross_pallas=False)
    with pytest.raises(ValueError) as ej:
        jax_decode.greedy_decode(jp, ARCH, jnp.asarray(_enc()), JaxDecodeConfig(**cfg))
    with pytest.raises(ValueError) as et:
        decode.greedy_decode(tp, T_ARCH, torch.from_numpy(_enc()), DecodeConfig(**cfg))
    assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError):
        decode.check_supported(T_ARCH, DecodeConfig(**cfg))


@pytest.mark.parametrize("merge_at,factor", [(0, 2), (1, 2), (1, 3)])
def test_encode_merge_at_matches_jax(trees, merge_at, factor):
    """Encoder states within 1e-4 of layer-normed values of order 1, at the
    merged length T // factor."""
    jp, tp = trees["int8"]
    mel = _mel(18)
    ref = jax.jit(lambda p, m: jax_whisper.encode(
        p, ARCH, m, merge_at=merge_at, merge_factor=factor))(jp, jnp.asarray(mel))
    got = whisper.encode(tp, T_ARCH, torch.from_numpy(mel), merge_at=merge_at,
                         merge_factor=factor)
    assert got.shape == (2, 64 // factor, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_encode_head_masks_match_jax(trees):
    jp, tp = trees["f32"]
    mel, hm = _mel(19), _head_masks(20, True)
    ref = jax_whisper.encode(jp, ARCH, jnp.asarray(mel), head_masks=jnp.asarray(hm))
    got = whisper.encode(tp, T_ARCH, torch.from_numpy(mel), head_masks=torch.from_numpy(hm))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    assert not np.allclose(got.numpy(), whisper.encode(
        tp, T_ARCH, torch.from_numpy(mel)).numpy(), atol=1e-3)


def test_unfuse_qkv_inverts_fuse_qkv(trees):
    """unfuse_qkv(fuse_qkv(p)) gives p's leaves bit for bit (encoder and
    decoder fused), and the same tree as the JAX package's `unfuse_qkv` of
    the same fused tree; a quantized qkv refuses, as in JAX."""
    jp, tp = trees["f32"]
    comps = ("encoder", "decoder")
    back = unfuse_qkv(fuse_qkv(tp, comps))
    want = dict(named_leaves(tp))
    got = dict(named_leaves(back))
    assert got.keys() == want.keys()
    for name, leaf in want.items():
        assert torch.equal(got[name], leaf), name
    assert "qkv" in fuse_qkv(tp, comps)["encoder"]["layers"][0]["attn"]
    j_back = jax_fuse.unfuse_qkv(jax_fuse.fuse_qkv(jp, comps))
    j_leaves = dict(named_leaves(from_numpy(jax.tree.map(np.asarray, j_back),
                                            device=DEV)))
    assert j_leaves.keys() == got.keys()
    for name, leaf in j_leaves.items():
        assert torch.equal(got[name], leaf), name
    with pytest.raises(ValueError, match="dequantize"):
        unfuse_qkv(fuse_qkv(quantize_params(tp, "int8")))
    assert isinstance(fuse_qkv(quantize_params(tp, "int8"))["decoder"]["layers"][0][
        "attn"]["qkv"]["w"], QTensor)


def test_biases_may_be_absent(trees):
    """Every linear bias is read with `.get("b")`, as in the JAX package: a
    tree without the biases decodes (the logits equal those of zero
    biases)."""
    _, tp = trees["f32"]

    def strip(t, zero):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                if k == "b" and "w" in t:   # linear biases, not layer norms
                    if zero:
                        out[k] = torch.zeros_like(v)
                    continue
                out[k] = strip(v, zero)
            return out
        if isinstance(t, list):
            return [strip(v, zero) for v in t]
        return t

    enc, toks = torch.from_numpy(_enc(21)), torch.from_numpy(_tokens(22)).long()
    a = whisper.decode_logits(strip(tp, False), T_ARCH, toks, enc)
    b = whisper.decode_logits(strip(tp, True), T_ARCH, toks, enc)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    cfg = DecodeConfig(max_new_tokens=4, self_pallas=False)
    got = decode.greedy_decode(fuse_qkv(strip(tp, False)), T_ARCH, enc, cfg)
    assert got[0].shape[0] == 3



@pytest.mark.parametrize("self_pallas", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("start", [None, (0, 30)], ids=["nostart", "start"])
def test_decoder_step_past_the_position_table_matches_jax(trees, start, self_pallas):
    """A step whose position (pos - start, or pos without `start`) lies past
    test2l's 32-row position table reads the table's last row, as JAX's
    clamped gather and dynamic slice do: continuous batching's idle slots
    get there. Logits within LOGITS_ATOL of jitted JAX's; the cache row
    written at `pos` equal to JAX's to 1e-6."""
    jp, tp = trees["f32"]
    pos, max_len, b = 40, 64, 2
    assert pos - (start or (0,))[0] >= T_ARCH.max_target_positions
    from openai_whisper_compression_tpu.models import cache as jax_cache
    from openai_whisper_compression_tpu_torch.models import cache as kv_cache

    enc = _enc(5, b=b)
    tok = np.asarray([611, 7], np.int32)
    st = None if start is None else np.asarray(start, np.int32)

    def jax_step(p, e, t, s):
        kv = jax_whisper.precompute_cross_kv(p, ARCH, e)
        c = jax_cache.init_cache(p, ARCH, b, max_len)
        return jax_decode.decoder_step(p, ARCH, t, pos, c, kv, max_len, start=s)

    ref_logits, ref_cache = jax.jit(jax_step)(jp, jnp.asarray(enc), jnp.asarray(tok), _j(st))
    kv = whisper.precompute_cross_kv(tp, T_ARCH, torch.from_numpy(enc))
    cache = kv_cache.init_cache(tp, T_ARCH, b, max_len, device=DEV)
    with torch.inference_mode():
        got = decode.decoder_step(tp, T_ARCH, torch.from_numpy(tok).long(), pos, cache, kv,
                                  start=_t(st), self_pallas=self_pallas)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_logits), atol=LOGITS_ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[0][name][:, :, pos].numpy(),
                                   np.asarray(ref_cache[0][name])[:, :, pos], atol=1e-5, rtol=0)
