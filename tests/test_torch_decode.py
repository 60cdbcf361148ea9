"""The port's `models/decode.py` against the jitted JAX package on `test2l`
and `test2l-ts` in f32: greedy decoding with a left-padded prompt and with
the timestamp rules, beam search at widths 2, 5 and 8 over fp and int8
caches with and without a prompt, language detection, the no-speech
probability and the logprob traces. Tokens and lengths must be equal; the
float outputs lie within stated bounds. Weights come from `init_params_jit`
(std 0.5, so tokens vary) through `from_numpy`; inputs from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.evaluation.harness import (
    make_transcribe_fn as jax_make_transcribe_fn)
from openai_whisper_compression_tpu.models import decode as jax_decode
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
from openai_whisper_compression_tpu_torch.models import decode
from openai_whisper_compression_tpu_torch.models.params import from_numpy

torch.set_num_threads(2)

B, PW = 3, 5           # batch, prompt window
STD, EOT_TWIN = 0.5, 611
# fp caches (f32 here, bf16 on the card) and bench.py's int8 pair
CACHES = {"fp": {}, "kv8-ckv8": {"kv_int8": True, "cross_kv_int8": True}}
NO_LANG = {"language_token_id": None, "task_token_id": None}


def _params(arch_name):
    """(JAX tree, torch tree): std 0.5, EOT's embedding tied to token 611's
    so that some rows stop early."""
    arch = JAX_ARCHS[arch_name]
    p = JP.init_params_jit(arch, jax.random.PRNGKey(0), std=STD)
    embed = np.asarray(p["decoder"]["embed"]).copy()
    embed[arch.eos_token_id] = 1.3 * embed[EOT_TWIN]
    p["decoder"] = {**p["decoder"], "embed": jnp.asarray(embed)}
    return p, from_numpy(jax.tree.map(np.asarray, p))


@pytest.fixture(scope="module")
def plain():
    return _params("test2l")


@pytest.fixture(scope="module")
def ts():
    return _params("test2l-ts")


def _enc(seed=2, b=B):
    return np.random.default_rng(seed).standard_normal((b, 64, 64)).astype(np.float32)


def _prompt(seed=7, b=B):
    """Right-aligned prompt window with lengths 0 (all padding), PW (full)
    and values between; the padding holds EOT ids, as the JAX tests'."""
    rng = np.random.default_rng(seed)
    lens = np.array([0, PW, 2, 3, 1, 4][:b], np.int32)
    prompt = rng.integers(5, 800, (b, PW)).astype(np.int32)
    for i, n in enumerate(lens):
        prompt[i, : PW - n] = 997
    return prompt, lens


def _both(arch_name, jp, tp, fn_name, cfg_kw, enc, prompt=None, lens=None, **kw):
    """(JAX outputs as numpy, port outputs as numpy) of decode.<fn_name>."""
    j_arch, t_arch = JAX_ARCHS[arch_name], ARCHS[arch_name]
    jkw = dict(kw)
    tkw = dict(kw)
    if prompt is not None:
        jkw.update(prompt_tokens=jnp.asarray(prompt), prompt_lens=jnp.asarray(lens))
        tkw.update(prompt_tokens=torch.from_numpy(prompt),
                   prompt_lens=torch.from_numpy(lens))
    ref = jax.jit(lambda p, e: getattr(jax_decode, fn_name)(
        p, j_arch, e, JaxDecodeConfig(**cfg_kw), **jkw))(jp, jnp.asarray(enc))
    with torch.inference_mode():
        got = getattr(decode, fn_name)(tp, t_arch, torch.from_numpy(enc),
                                       DecodeConfig(**cfg_kw), **tkw)
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


def _assert_tokens_equal(ref, got):
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0], ref[0])


@pytest.mark.parametrize("caches", CACHES)
def test_greedy_with_left_padded_prompt_matches_jax(plain, caches):
    ref, got = _both("test2l", *plain, "greedy_decode",
                     dict(max_new_tokens=10, **CACHES[caches]), _enc(), *_prompt())
    _assert_tokens_equal(ref, got)
    assert got[0].shape == (B, 32)   # test2l's max_target_positions
    np.testing.assert_array_equal(got[0][:, :PW], _prompt()[0])
    assert len(set(got[1].tolist())) > 1   # rows stop at different steps


@pytest.mark.parametrize("caches", CACHES)
@pytest.mark.parametrize("prompted", [False, True])
def test_greedy_with_timestamps_matches_jax(ts, caches, prompted):
    cfg = dict(max_new_tokens=12, notimestamps=False,
               max_initial_timestamp_index=20, **NO_LANG, **CACHES[caches])
    extra = _prompt() if prompted else ()
    ref, got = _both("test2l-ts", *ts, "greedy_decode", cfg, _enc(3), *extra)
    _assert_tokens_equal(ref, got)
    arch = ARCHS["test2l-ts"]
    first_gen = (PW if prompted else 0) + 1
    first = got[0][:, first_gen]
    assert ((first > arch.no_timestamps_token_id)
            & (first <= arch.no_timestamps_token_id + 1 + 20)).all()


@pytest.mark.parametrize("beam", [2, 5, 8])
@pytest.mark.parametrize("caches", CACHES)
@pytest.mark.parametrize("prompted", [False, True])
def test_beam_decode_matches_jax(plain, beam, caches, prompted):
    cfg = dict(max_new_tokens=8, beam_size=beam, **CACHES[caches])
    extra = _prompt() if prompted else ()
    ref, got = _both("test2l", *plain, "beam_decode", cfg, _enc(4), *extra)
    _assert_tokens_equal(ref, got)


@pytest.mark.parametrize("beam", [2, 5])
def test_beam_decode_with_timestamps_and_prompt_matches_jax(ts, beam):
    cfg = dict(max_new_tokens=10, beam_size=beam, notimestamps=False,
               max_initial_timestamp_index=20, **NO_LANG)
    ref, got = _both("test2l-ts", *ts, "beam_decode", cfg, _enc(5), *_prompt())
    _assert_tokens_equal(ref, got)


def test_beam_decode_int4_cross_kv_matches_jax(plain):
    cfg = dict(max_new_tokens=8, beam_size=5, kv_int8=True, cross_kv_int4=True)
    ref, got = _both("test2l", *plain, "beam_decode", cfg, _enc(6), *_prompt())
    _assert_tokens_equal(ref, got)


def test_beam_one_is_greedy(plain):
    _, tp = plain
    cfg = DecodeConfig(max_new_tokens=6, beam_size=1)
    enc, (prompt, lens) = torch.from_numpy(_enc()), _prompt()
    kw = dict(prompt_tokens=torch.from_numpy(prompt),
              prompt_lens=torch.from_numpy(lens))
    a = decode.greedy_decode(tp, ARCHS["test2l"], enc, cfg, **kw)
    b = decode.beam_decode(tp, ARCHS["test2l"], enc, cfg, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_beam_all_padding_prompt_equals_no_prompt(plain):
    """A window of padding only (prompt_lens 0) changes nothing: positions
    restart at 0 and the padding is masked out."""
    _, tp = plain
    arch = ARCHS["test2l"]
    cfg = DecodeConfig(max_new_tokens=8, beam_size=3)
    enc = torch.from_numpy(_enc())
    t0, l0 = decode.beam_decode(tp, arch, enc, cfg)
    prompt = torch.full((B, 4), arch.eos_token_id)
    t1, l1 = decode.beam_decode(tp, arch, enc, cfg, prompt_tokens=prompt,
                                prompt_lens=torch.zeros(B, dtype=torch.int32))
    p_len = len(decode.forced_prefix(arch, cfg))
    for i in range(B):
        assert (t0[i, p_len: l0[i]].tolist()
                == t1[i, 4 + p_len: l1[i]].tolist())


def test_beam_rows_are_the_best_of_their_beams(plain):
    """With EOT suppressed every hypothesis has the same length, so the
    beam-5 result, rescored by teacher forcing, must score at least the
    greedy hypothesis (which its search space holds) on these inputs."""
    _, tp = plain
    arch = ARCHS["test2l"]
    enc = torch.from_numpy(_enc(8))
    cfg = DecodeConfig(max_new_tokens=6, suppress_tokens=(arch.eos_token_id,))
    tg, lg, avg_g = decode.greedy_decode(tp, arch, enc, cfg, return_logprobs=True)
    tb, lb = decode.beam_decode(
        tp, arch, enc, DecodeConfig(max_new_tokens=6, beam_size=5,
                                    suppress_tokens=(arch.eos_token_id,)))
    # rescore the beam result by forcing its tokens through the greedy loop
    p_len = len(decode.forced_prefix(arch, cfg))
    for i in range(B):
        score = _sequence_logprob(tp, arch, enc[i: i + 1], tb[i, : lb[i]], p_len)
        assert score >= float(avg_g[i]) * (int(lg[i]) - p_len) - 1e-4


def _sequence_logprob(tp, arch, enc, seq, p_len):
    """Sum of logprobs of seq[p_len:] under teacher forcing (EOT suppressed,
    as in the decodes above)."""
    cfg = DecodeConfig(max_new_tokens=len(seq) - p_len)
    cross_kvs, cache, tokens, start, first_gen, _ = decode._prepare(
        tp, arch, enc, cfg)
    total = 0.0
    for pos in range(first_gen - 1, len(seq) - 1):
        logits = decode.decoder_step(tp, arch, seq[pos: pos + 1], pos, cache,
                                     cross_kvs).float()
        logits[:, arch.eos_token_id] += decode.NEG_INF
        total += float(torch.log_softmax(logits, -1)[0, seq[pos + 1]])
    return total


def test_logprob_traces_match_jax(plain):
    """Mean generated-token logprob and the per-position trace: 1e-4
    absolute on logprobs of order 1 to 10 (f32 sums in another order)."""
    cfg = dict(max_new_tokens=10)
    ref, got = _both("test2l", *plain, "greedy_decode", cfg, _enc(), *_prompt(),
                     return_logprobs=True, return_token_logprobs=True)
    _assert_tokens_equal(ref, got)
    assert got[2].shape == (B,) and got[3].shape == (B, 32)
    np.testing.assert_allclose(got[2], ref[2], atol=1e-4)
    np.testing.assert_allclose(got[3], ref[3], atol=1e-4)
    assert (got[3][:, : PW + 1] == 0).all() and (got[3] <= 0).all()


def test_detect_language_and_no_speech_prob_match_jax(plain):
    """Probabilities within 1e-5; the top language token equal."""
    jp, tp = plain
    # a vocab layout with a language range: <|sot|> 100, languages 101..894
    ids = dict(decoder_start_token_id=100, no_timestamps_token_id=900)
    j_arch, t_arch = JAX_ARCHS["test2l"].replace(**ids), ARCHS["test2l"].replace(**ids)
    enc = _enc(9)
    lang_range = (200, 260)
    for rng_arg in (None, lang_range):
        probs_j, top_j = jax.jit(lambda p, e: jax_decode.detect_language(
            p, j_arch, e, rng_arg))(jp, jnp.asarray(enc))
        probs_t, top_t = decode.detect_language(tp, t_arch, torch.from_numpy(enc),
                                                rng_arg)
        assert probs_t.shape == probs_j.shape
        np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j), atol=1e-5)
        np.testing.assert_array_equal(top_t.numpy(), np.asarray(top_j))
    ns_j = jax.jit(lambda p, e: jax_decode.no_speech_prob(p, j_arch, e))(
        jp, jnp.asarray(enc))
    ns_t = decode.no_speech_prob(tp, t_arch, torch.from_numpy(enc))
    np.testing.assert_allclose(ns_t.numpy(), np.asarray(ns_j), atol=1e-5)
    assert decode._language_token_range(t_arch) == jax_decode._language_token_range(j_arch)
    with pytest.raises(ValueError):
        decode.detect_language(tp, ARCHS["small.en"], torch.from_numpy(enc))
    with pytest.raises(ValueError):   # test2l's vocab has no language range
        decode._language_token_range(ARCHS["test2l"])


def test_padded_prompt_row_equals_the_row_alone(plain):
    """A left-padded row's first-step logits equal those of the same row
    run alone with its unpadded prompt: the padding acts only through the
    mask and the positions counted from `start` (1e-4 on logits of order
    10)."""
    _, tp = plain
    arch = ARCHS["test2l"]
    cfg = DecodeConfig(max_new_tokens=4)
    enc, (prompt, lens) = torch.from_numpy(_enc()), _prompt()
    full = decode.first_step_logits(tp, arch, enc, cfg, torch.from_numpy(prompt),
                                    torch.from_numpy(lens))
    for i, n in enumerate(lens.tolist()):
        alone = decode.first_step_logits(
            tp, arch, enc[i: i + 1], cfg,
            torch.from_numpy(prompt[i: i + 1, PW - n:]) if n else None)
        np.testing.assert_allclose(full[i].numpy(), alone[0].numpy(), atol=1e-4)
    beams = decode.first_step_logits(tp, arch, enc, DecodeConfig(beam_size=3),
                                     torch.from_numpy(prompt), torch.from_numpy(lens))
    assert beams.shape == (3 * B, arch.vocab_size)
    np.testing.assert_allclose(beams[::3].numpy(), full.numpy(), atol=1e-4)


# (generated history before the step, as offsets: t<n> = timestamp
# ts_begin + n, w = a text token) -> every branch of the five rules
RULE_CASES = {
    "first": [], "after-initial-ts": ["t3"], "text": ["t3", "w"],
    "lone-ts": ["t3", "w", "t9"], "closed-pair": ["t3", "w", "t9", "t9"],
    "two-texts": ["t3", "w", "w"], "pair-then-text": ["t0", "t0", "w"],
    "eot-last": ["t3", "w", "e"],
}


@pytest.mark.parametrize("case", RULE_CASES)
@pytest.mark.parametrize("first_gen", [1, 4])
def test_apply_timestamp_rules_matches_jax(case, first_gen):
    """Same logits out of both `_apply_timestamp_rules` (each rule adds its
    own -1e9, so doubly suppressed entries agree too): 1e-6 relative. Two
    rows share the history; one has its timestamp mass boosted so that rule
    5 fires for it."""
    j_arch, t_arch = JAX_ARCHS["test2l-ts"], ARCHS["test2l-ts"]
    ts_begin = t_arch.no_timestamps_token_id + 1
    hist = [ts_begin + int(h[1:]) if h[0] == "t" else
            t_arch.eos_token_id if h == "e" else 17 for h in RULE_CASES[case]]
    rng = np.random.default_rng(len(hist) + first_gen)
    logits = rng.standard_normal((2, t_arch.vocab_size)).astype(np.float32) * 3
    logits[1, ts_begin:] += 6.0
    tokens = np.full((2, 16), t_arch.eos_token_id, np.int64)
    tokens[:, :first_gen] = 5
    tokens[:, first_gen: first_gen + len(hist)] = hist
    pos = first_gen - 1 + len(hist)
    seen = [t for t in hist if t >= ts_begin]
    last_ts = np.full((2,), seen[-1] if seen else 0, np.int64)
    for kw in ({}, {"max_initial_timestamp_index": 7}):
        ref = jax_decode._apply_timestamp_rules(
            jnp.asarray(logits), jnp.asarray(tokens, jnp.int32), jnp.asarray(pos),
            first_gen, jnp.asarray(last_ts, jnp.int32), j_arch,
            JaxDecodeConfig(notimestamps=False, **kw))
        got = decode._apply_timestamp_rules(
            torch.from_numpy(logits), torch.from_numpy(tokens), pos, first_gen,
            torch.from_numpy(last_ts), t_arch, DecodeConfig(notimestamps=False, **kw))
        ref = np.asarray(ref)
        np.testing.assert_array_equal(got.numpy() < -1e8, ref < -1e8)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    assert (ref[1, :ts_begin] < -1e8).all() or case in ("after-initial-ts",
                                                        "closed-pair")


def test_timestamp_helpers():
    arch = ARCHS["test2l-ts"]
    assert decode._timestamps_enabled(arch, DecodeConfig(notimestamps=False))
    assert not decode._timestamps_enabled(arch, DecodeConfig())
    assert not decode._timestamps_enabled(
        arch, DecodeConfig(notimestamps=False, timestamp_rules=False))
    assert not decode._timestamps_enabled(ARCHS["test2l"],
                                          DecodeConfig(notimestamps=False))
    assert decode.timestamp_token_to_seconds(arch, 900 + 50) == pytest.approx(1.0)


def test_top_k_breaks_ties_as_lax_top_k():
    """Equal candidates come out in ascending index order, as `lax.top_k`
    gives them (finished beams tie whole rows at -1e9)."""
    x = np.full((2, 40), -1e9, np.float32)
    x[0, [7, 30]] = 1.5
    x[1, 11] = 0.25
    ref_v, ref_i = lax.top_k(jnp.asarray(x), 5)
    got_v, got_i = decode._top_k(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))


N = 20480  # test2l's waveform samples


def _wav(b=2):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((b, N)) * np.array([0.1, 1.0])[:b, None]).astype(
        np.float32)


def test_transcribe_fn_with_beams_matches_jax(plain):
    jp, tp = plain
    cfg = dict(max_new_tokens=8, beam_size=3, kv_int8=True, cross_kv_int8=True)
    jt, jl = jax_make_transcribe_fn(JAX_ARCHS["test2l"], JaxDecodeConfig(**cfg),
                                    use_pallas_mel=True)(jp, jnp.asarray(_wav()))
    tt, tl = make_transcribe_fn(ARCHS["test2l"], DecodeConfig(**cfg))(tp, _wav())
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_transcribe_fn_token_logprobs_match_jax(plain):
    jp, tp = plain
    cfg = dict(max_new_tokens=8)
    ref = jax_make_transcribe_fn(JAX_ARCHS["test2l"], JaxDecodeConfig(**cfg),
                                 use_pallas_mel=True, token_logprobs=True)(
        jp, jnp.asarray(_wav()))
    got = make_transcribe_fn(ARCHS["test2l"], DecodeConfig(**cfg),
                             token_logprobs=True)(tp, _wav())
    assert len(got) == len(ref) == 3
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-4)
    with pytest.raises(ValueError):
        make_transcribe_fn(ARCHS["test2l"], DecodeConfig(beam_size=2),
                           token_logprobs=True)


def test_transcribe_tokens_matches_jax(plain):
    jp, tp = plain
    mel = np.random.default_rng(1).standard_normal((2, 80, 128)).astype(np.float32)
    cfg = dict(max_new_tokens=6)
    jt, jl = jax.jit(lambda p, m: jax_decode.transcribe_tokens(
        p, JAX_ARCHS["test2l"], m, JaxDecodeConfig(**cfg)))(jp, jnp.asarray(mel))
    tt, tl = decode.transcribe_tokens(tp, ARCHS["test2l"], torch.from_numpy(mel),
                                      DecodeConfig(**cfg))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
