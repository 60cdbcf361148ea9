"""f32 and f16 trees through the port against the jitted JAX package on
`test2l` (`REGISTRY["baseline_fp32"]` and `"fp16"`): greedy and beam-5
tokens and lengths over fp and int8 caches from the same numpy-seeded
weights and encoder states; the plain versions of the decode attention
kernels (the fused cache update, the grouped and the one-query
cross-attention) in f32 and f16 against the JAX functions (Pallas in
interpret mode); the dequant-matmuls' plain versions at the ragged M of the
beam runs and at the prefill's M; and the rule that splits K over a thread
block cluster, at every decoder linear of whisper-small and whisper-medium.

f32 tokens must be equal. f16 greedy tokens must be equal too, or each
mismatch proved a top-2 tie by a third path: the port's f32 logits,
teacher-forced on the common prefix, must rank the two tokens first and
second, closer than an f16 rounding of the logits could decide. A beam
search can drop a hypothesis on such a tie many steps before the output
shows it, so an f16 beam row that differs from the JAX package's f16 row
must instead equal the third path's row: the f32 beam search, on which the
two packages agree token for token."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.models import decode as jax_decode
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.ops import cross_attention as jax_cross
from openai_whisper_compression_tpu.ops.quant_matmul import (int4_matmul_pallas,
                                                             int8_matmul_pallas)
from openai_whisper_compression_tpu.ops.self_attention_step import (
    decode_self_attention_update as jax_update)
from openai_whisper_compression_tpu.quant import core as jax_core
from openai_whisper_compression_tpu.quant.api import (
    apply_named_config as jax_apply_named_config)
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.models import decode
from openai_whisper_compression_tpu_torch.models.params import from_numpy, tree_cast
from openai_whisper_compression_tpu_torch.ops import quant_matmul
from openai_whisper_compression_tpu_torch.ops.cross_attention import (
    decode_cross_attention, decode_cross_attention_grouped, pad_cross_len)
from openai_whisper_compression_tpu_torch.ops.quant_matmul import (int4_matmul,
                                                                   int8_matmul)
from openai_whisper_compression_tpu_torch.ops.self_attention_step import (
    decode_self_attention_update)
from openai_whisper_compression_tpu_torch.quant.api import apply_named_config

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

B = 4
STD, EOT_TWIN = 0.5, 611
TREES = {"baseline_fp32": ("float32", 1e-5), "fp16": ("float16", 2.0 ** -10)}
CACHES = {"fp": {}, "kv8-ckv8": {"kv_int8": True, "cross_kv_int8": True}}
DECODES = {"greedy": ("greedy_decode", {"max_new_tokens": 12}),
           "beam5": ("beam_decode", {"max_new_tokens": 10, "beam_size": 5})}


@pytest.fixture(scope="module")
def trees():
    """REGISTRY name -> (JAX tree, torch tree) from one f32 tree: std 0.5 so
    that tokens vary, EOT's embedding tied to token 611's so that some rows
    stop early."""
    arch = JAX_ARCHS["test2l"]
    p = JP.init_params_jit(arch, jax.random.PRNGKey(0), std=STD)
    embed = np.asarray(p["decoder"]["embed"]).copy()
    embed[arch.eos_token_id] = 1.3 * embed[EOT_TWIN]
    p["decoder"] = {**p["decoder"], "embed": jnp.asarray(embed)}
    tp = from_numpy(jax.tree.map(np.asarray, p), device=DEV)
    return {name: (jax_apply_named_config(p, name), apply_named_config(tp, name))
            for name in TREES}


def _enc(seed=2):
    return np.random.default_rng(seed).standard_normal((B, 64, 64)).astype(np.float32)


def _decode_both(tree, dtype, fn_name, cfg_kw, enc):
    jp, tp = tree
    ref = jax.jit(lambda p, e: getattr(jax_decode, fn_name)(
        p, JAX_ARCHS["test2l"], e, JaxDecodeConfig(**cfg_kw)))(
            jp, jnp.asarray(enc).astype(getattr(jnp, dtype)))
    with torch.inference_mode():
        got = getattr(decode, fn_name)(
            tp, ARCHS["test2l"], torch.from_numpy(enc).to(getattr(torch, dtype)),
            DecodeConfig(**cfg_kw))
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


@torch.inference_mode()
def _teacher_forced_logits(tp32, cfg_kw, enc_row, seq, pos):
    """The third path: f32 logits for position `pos` of one utterance after
    the tokens seq[:pos], through the greedy step of the port's f32 tree."""
    arch = ARCHS["test2l"]
    cfg = DecodeConfig(**{**cfg_kw, "beam_size": 1})
    cross_kvs, cache, tokens, start, first_gen, _ = decode._prepare(
        tp32, arch, torch.from_numpy(enc_row[None]), cfg)
    assert pos >= first_gen
    logits_fn, _ = decode._logits_fn(tp32, arch, cfg, cross_kvs, start, first_gen,
                                     1, torch.device("cpu"))
    tokens[0, :pos] = torch.from_numpy(seq[:pos].astype(np.int64))
    last_ts = torch.zeros(1, dtype=torch.long)
    for p in range(first_gen - 1, pos):
        logits = logits_fn(tokens, cache, p, last_ts)
    return logits[0].float().numpy()


def _assert_equal_or_tie(ref, got, tp, cfg_kw, enc, step):
    """Tokens and lengths equal, or every row's first mismatch a top-2 tie
    of the f32 recompute: the two tokens ranked first and second, their
    logits closer than `step` (one rounding of the working type) of the
    largest logit."""
    if np.array_equal(ref[0], got[0]):
        np.testing.assert_array_equal(got[1], ref[1])
        return 0
    tp32 = tree_cast(tp, torch.float32)
    proved = 0
    for i in np.flatnonzero((ref[0] != got[0]).any(axis=1)):
        pos = int(np.argmax(ref[0][i] != got[0][i]))
        logits = _teacher_forced_logits(tp32, cfg_kw, enc[i], ref[0][i], pos)
        top2 = set(np.argsort(logits)[-2:].tolist())
        pair = {int(ref[0][i, pos]), int(got[0][i, pos])}
        gap = abs(float(logits[ref[0][i, pos]]) - float(logits[got[0][i, pos]]))
        assert pair == top2 and gap <= step * float(np.abs(logits).max()), (
            f"row {i} position {pos}: tokens {pair} are no top-2 tie of the f32 "
            f"recompute (top 2 {top2}, gap {gap})")
        proved += 1
    return proved


@pytest.mark.parametrize("caches", CACHES)
@pytest.mark.parametrize("how", DECODES)
@pytest.mark.parametrize("name", TREES)
def test_tree_tokens_match_jax(trees, name, how, caches):
    dtype, step = TREES[name]
    fn_name, cfg_kw = DECODES[how]
    cfg_kw = {**cfg_kw, **CACHES[caches]}
    enc = _enc()
    ref, got = _decode_both(trees[name], dtype, fn_name, cfg_kw, enc)
    assert got[0].shape == ref[0].shape == (B, 32)
    if name == "baseline_fp32":
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[0], ref[0])
    elif how == "greedy":
        _assert_equal_or_tie(ref, got, trees[name][1], cfg_kw, enc, step)
    else:
        differ = np.flatnonzero((ref[0] != got[0]).any(axis=1))
        if differ.size:   # the third path: the f32 beam search
            with torch.inference_mode():
                tok32, len32 = decode.beam_decode(
                    tree_cast(trees[name][1], torch.float32), ARCHS["test2l"],
                    torch.from_numpy(enc), DecodeConfig(**cfg_kw))
            np.testing.assert_array_equal(got[0][differ], tok32.numpy()[differ])
            np.testing.assert_array_equal(got[1][differ], len32.numpy()[differ])
        same = np.setdiff1d(np.arange(B), differ)
        np.testing.assert_array_equal(got[1][same], ref[1][same])
        assert same.size >= B // 2   # most rows agree outright
    assert len(set(got[1].tolist())) > 1   # rows stop at different steps


def test_tie_proof_refuses_a_real_mismatch(trees):
    """The tie proof accepts equal tokens, and refuses a row whose token was
    swapped for one the f32 logits rank far from the top."""
    cfg_kw = DECODES["greedy"][1]
    enc = _enc()
    ref, got = _decode_both(trees["fp16"], "float16", "greedy_decode", cfg_kw, enc)
    tp = trees["fp16"][1]
    assert _assert_equal_or_tie(ref, [ref[0].copy(), ref[1]], tp, cfg_kw, enc,
                                2.0 ** -10) == 0
    first_gen = len(decode.forced_prefix(ARCHS["test2l"], DecodeConfig(**cfg_kw)))
    logits = _teacher_forced_logits(tree_cast(tp, torch.float32), cfg_kw, enc[0],
                                    ref[0][0], first_gen)
    assert int(np.argmax(logits)) == int(ref[0][0, first_gen])
    wrong = ref[0].copy()
    wrong[0, first_gen] = int(np.argsort(logits)[len(logits) // 2])
    with pytest.raises(AssertionError, match="no top-2 tie"):
        _assert_equal_or_tie(ref, [wrong, ref[1]], tp, cfg_kw, enc, 2.0 ** -10)


def _tol(dtype, ref):
    """f32: 1e-5 of the largest output (sum order); f16: one f16 step of
    it (2**-10)."""
    return TREES["baseline_fp32" if dtype == "float32" else "fp16"][1] * float(
        np.abs(ref).max())


@pytest.mark.parametrize("pos", [0, 5, 15])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_update_plain_matches_pallas(pos, dtype):
    """Caches bit-identical (the row write is a copy); the output within the
    type's step."""
    bh, s, dh = 8, 16, 64
    rng = np.random.default_rng(pos)
    q = (rng.standard_normal((bh, dh)) * 0.125).astype(np.float32)
    kn, vn = (rng.standard_normal((2, bh, dh))).astype(np.float32)
    kc, vc = (rng.standard_normal((2, bh, s, dh))).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref_out, ref_k, ref_v = jax_update(
        jnp.asarray(q, jd), jnp.asarray(kn, jd), jnp.asarray(vn, jd),
        jnp.asarray(kc, jd), jnp.asarray(vc, jd), jnp.asarray(pos))
    k_cache, v_cache = torch.from_numpy(kc).to(td), torch.from_numpy(vc).to(td)
    out = decode_self_attention_update(
        torch.from_numpy(q).to(td), torch.from_numpy(kn).to(td),
        torch.from_numpy(vn).to(td), k_cache, v_cache, pos)
    assert out.dtype == td
    np.testing.assert_array_equal(k_cache.float().numpy(),
                                  np.asarray(ref_k.astype(jnp.float32)))
    np.testing.assert_array_equal(v_cache.float().numpy(),
                                  np.asarray(ref_v.astype(jnp.float32)))
    ref = np.asarray(ref_out.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=_tol(dtype, ref))


def _cross_inputs(bh, kq, s, seed):
    rng = np.random.default_rng(seed)
    sp = pad_cross_len(s)
    q = (rng.standard_normal((bh, kq, 64)) * 0.125).astype(np.float32)
    k = rng.standard_normal((bh, 64, sp)).astype(np.float32)
    v = rng.standard_normal((bh, 64, sp)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("kq", [1, 3, 5])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_grouped_plain_matches_pallas(kq, dtype):
    s = 100
    q, k, v = _cross_inputs(8, kq, s, kq)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jax_cross.decode_cross_attention_grouped(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        s_valid=s).astype(jnp.float32))
    got = decode_cross_attention_grouped(torch.from_numpy(q).to(td),
                                         torch.from_numpy(k).to(td),
                                         torch.from_numpy(v).to(td), s_valid=s)
    assert got.dtype == td and got.shape == (8, kq, 64)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=_tol(dtype, ref))


@pytest.mark.parametrize("bh", [12, 36])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_one_query_plain_matches_pallas(bh, dtype):
    """At the row counts of whisper-small at batch 1 and 3."""
    s = 100
    q, k, v = _cross_inputs(bh, 1, s, bh)
    q = q[:, 0]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jax_cross.decode_cross_attention(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        s_valid=s).astype(jnp.float32))
    got = decode_cross_attention(torch.from_numpy(q).to(td),
                                 torch.from_numpy(k).to(td),
                                 torch.from_numpy(v).to(td), s_valid=s)
    assert got.dtype == td and got.shape == (bh, 64)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=_tol(dtype, ref))


@pytest.mark.parametrize("m", [80, 288])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_matmul_plain_matches_pallas_at_beam_and_prefill_m(bits, m, dtype):
    """`int8_matmul_ref` and `int4_matmul_ref` (the wrappers on a CPU
    tensor) against the Pallas kernels in interpret mode at M = 80 (16
    utterances x 5 beams) and 288 (3 prefix tokens x 96): the same
    bf16-rounded operands, f32 sums in another order; f32 output within
    1e-5 of the largest output, bf16 within 2**-8, f16 within 2**-10."""
    rng = np.random.default_rng(m + bits)
    k, n = 256, 128
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = jnp.asarray((rng.standard_normal((k, n)) * 0.02).astype(np.float32))
    if bits == 8:
        q = jax_core.quantize_int8(w)
        ref = int8_matmul_pallas(jnp.asarray(x, dtype), q.data, q.scale)
        fn = int8_matmul
    else:
        q = jax_core.QUANTIZERS["int4"](w)
        ref = int4_matmul_pallas(jnp.asarray(x, dtype), q.data, q.scale, k)
        fn = int4_matmul
    ref = np.asarray(ref.astype(jnp.float32))
    td = getattr(torch, dtype)
    got = fn(torch.from_numpy(x).to(td), torch.from_numpy(np.array(q.data)),
             torch.from_numpy(np.array(q.scale)))
    assert got.dtype == td and got.shape == (m, n)
    step = {"float32": 1e-5, "bfloat16": 2.0 ** -8, "float16": 2.0 ** -10}[dtype]
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=step * float(np.abs(ref).max()))


def _linear_shapes(arch):
    d, f = arch.d_model, arch.ffn_dim
    return [(d, 3 * d), (d, d), (d, f), (f, d)]


@pytest.mark.parametrize("m", [1, 32, 80, 96, 288, 1024])
@pytest.mark.parametrize("halves", [1, 2], ids=["bytes", "nibbles"])
@pytest.mark.parametrize("k,n", sorted({kn for a in ("small", "medium")
                                        for kn in _linear_shapes(ARCHS[a])}))
def test_split_rule(k, n, halves, m):
    """The K splits of one output tile (the size of its thread block
    cluster): they divide the K tiles of 32 stored rows, are at most 8, put
    100 blocks in flight where a divisor can, with the smallest divisor that
    does, and else take the largest divisor."""
    ktiles = k // halves // 32
    splits = quant_matmul._splits(m, n, ktiles)
    tiles = (n // 64) * -(-m // 128)
    divisors = [s for s in range(1, 9) if ktiles % s == 0]
    assert splits in divisors
    reaching = [s for s in divisors if tiles * s >= 100]
    assert splits == (reaching[0] if reaching else divisors[-1])
    assert tiles * splits >= 100 or splits == divisors[-1]
    assert quant_matmul._splits(m, n, ktiles) == splits   # a pure function
