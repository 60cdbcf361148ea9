"""The port's temperature sampling and `models/fallback.py` against the JAX
package on `test2l` (f32, `init_params` weights at their default std, so
the sampled distributions are wide). `torch.multinomial` cannot draw what
`jax.random.categorical` draws, so sampling is held to its own contract
(temperature 0 bit-equal to greedy, one seed one result, the logprobs of
the untempered logits) and the ladder's control flow to JAX's with an
injected sampler that both packages call alike; `compression_ratio`,
`needs_fallback` and the no-speech gate against JAX's directly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.models import decode as jax_decode
from openai_whisper_compression_tpu.models import fallback as jax_fallback
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.models import decode, fallback, whisper
from openai_whisper_compression_tpu_torch.models.params import from_numpy

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

ARCH, T_ARCH = JAX_ARCHS["test2l"], ARCHS["test2l"]
CFG_KW = dict(max_new_tokens=8)
CFG = DecodeConfig(**CFG_KW)


@pytest.fixture(scope="module")
def setup():
    jp = JP.init_params(ARCH, jax.random.PRNGKey(0))
    tp = from_numpy(jax.tree.map(np.asarray, jp), device=DEV)
    enc = (np.random.default_rng(0).standard_normal((3, 64, 64)) * 0.5).astype(np.float32)
    return jp, tp, enc


def _greedy(tp, enc, **kw):
    return decode.greedy_decode(tp, T_ARCH, torch.from_numpy(enc), CFG, **kw)


def test_temperature_zero_is_greedy_bit_for_bit(setup):
    _, tp, enc = setup
    t0, l0, lp0 = _greedy(tp, enc, return_logprobs=True)
    gen = torch.Generator().manual_seed(7)
    t1, l1, lp1 = _greedy(tp, enc, generator=gen, temperature=0.0,
                          return_logprobs=True)
    assert torch.equal(t0, t1) and torch.equal(l0, l1) and torch.equal(lp0, lp1)
    assert bool((lp1 <= 0).all())
    # without a generator the temperature is ignored, as JAX ignores it
    # without a key
    t2, l2 = _greedy(tp, enc, temperature=0.7)
    assert torch.equal(t0, t2) and torch.equal(l0, l2)


def test_sampling_is_one_result_per_seed(setup):
    _, tp, enc = setup
    runs = [_greedy(tp, enc, generator=torch.Generator().manual_seed(s),
                    temperature=1.0, return_logprobs=True) for s in (3, 3, 4)]
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    greedy = _greedy(tp, enc)[0]
    assert not torch.equal(runs[0][0], greedy)       # wide distributions
    assert not torch.equal(runs[0][0], runs[2][0])   # another seed, other draws
    assert int(runs[0][0].max()) < T_ARCH.vocab_size


def test_sampling_follows_the_tempered_distribution(setup):
    """Over 600 rows of one utterance, the first sampled token's frequencies
    follow softmax(logits / T) (total variation below 0.15, where a flat or
    an argmax draw is above 0.5)."""
    _, tp, enc = setup
    cfg = DecodeConfig(max_new_tokens=1)
    e = torch.from_numpy(enc[:1]).repeat(600, 1, 1)
    temp = 0.05
    logits = decode.first_step_logits(tp, T_ARCH, e[:1], cfg)[0]
    p = torch.softmax(logits / temp, dim=-1)
    toks, _ = decode.greedy_decode(tp, T_ARCH, e, cfg, temperature=temp,
                                   generator=torch.Generator().manual_seed(0))
    first = toks[:, len(decode.forced_prefix(T_ARCH, cfg))]
    freq = torch.bincount(first, minlength=T_ARCH.vocab_size).float() / 600
    assert float((freq - p).abs().sum()) / 2 < 0.15


def test_avg_logprob_matches_teacher_forcing(setup):
    """The in-loop mean logprob equals a teacher-forced recompute through
    `decode_logits` (1e-4)."""
    _, tp, enc = setup
    toks, lens, lp = _greedy(tp, enc, return_logprobs=True)
    p_len = len(decode.forced_prefix(T_ARCH, CFG))
    for i in range(3):
        n = int(lens[i])
        logits = whisper.decode_logits(tp, T_ARCH, toks[i: i + 1, :n],
                                       torch.from_numpy(enc[i: i + 1]))
        lps = torch.log_softmax(logits.float(), dim=-1)
        want = float(np.mean([float(lps[0, t - 1, int(toks[i, t])])
                              for t in range(p_len, n)]))
        assert abs(want - float(lp[i])) < 1e-4


@pytest.mark.parametrize("text", [
    "", "hello", "hello hello hello hello hello hello hello hello hello hello",
    "the quick brown fox jumps over one lazy dog near a river",
    "w1 w2 w3 w1 w2 w3 w1 w2 w3 w1 w2 w3", "ünïcödé ✓ " * 7])
def test_compression_ratio_matches_jax(text):
    assert fallback.compression_ratio(text) == jax_fallback.compression_ratio(text)


@pytest.mark.parametrize("lp,ratio", [(-2.0, 1.0), (-0.1, 3.0), (-0.1, 1.0),
                                      (-1.0, 2.4), (-99.0, 99.0)])
@pytest.mark.parametrize("thresholds", [(2.4, -1.0), (None, -1.0), (2.4, None),
                                        (None, None)])
def test_needs_fallback_matches_jax(lp, ratio, thresholds):
    assert (fallback.needs_fallback(lp, ratio, *thresholds)
            == jax_fallback.needs_fallback(lp, ratio, *thresholds))


P_LEN = 2  # test2l's forced prefix: <|sot|> <|notimestamps|>


def _fake_rung(enc: np.ndarray, temp: float):
    """A deterministic stand-in for one rung's decode, a function of the
    encoder rows (their order included) and the temperature only: some rows
    repeat one token (compression ratio above 2.4), logprobs spread over
    [-2, 0], lengths vary."""
    n = enc.shape[0]
    v = enc.reshape(n, -1)[:, :4].sum(axis=1).astype(np.float64)
    k = np.arange(n)
    lp = (-2.0 * np.abs(np.sin(v * 3.0 + 5.0 * temp + 0.7 * k))).astype(np.float32)
    lens = (P_LEN + 3 + (k * 7 + int(temp * 10)) % 7).astype(np.int32)
    toks = np.full((n, 16), 997, np.int32)
    toks[:, 0], toks[:, 1] = 998, 999
    for i in range(n):
        rep = (i + int(temp * 10)) % 3 == 0
        body = ([5] * 14 if rep else list(range(10 + i, 24 + i)))
        toks[i, P_LEN: lens[i]] = body[: lens[i] - P_LEN]
    return toks, lens, lp


def _text(ids):
    return " ".join(f"w{i}" for i in ids)


@pytest.mark.parametrize("kw", [
    dict(), dict(compression_ratio_threshold=None),
    dict(logprob_threshold=-0.5), dict(logprob_threshold=0.0),
    dict(best_of=3), dict(best_of=2, temperatures=(0.0, 0.5, 1.0)),
    dict(compression_ratio_threshold=1.5, logprob_threshold=-1.5, best_of=4)],
    ids=["default", "no-ratio", "lp-0.5", "unpassable", "best3", "best2-3rungs",
         "strict-best4"])
def test_ladder_control_flow_matches_jax(setup, monkeypatch, kw):
    """With the same injected rung decode in both packages, every field of
    the result (tokens, lengths, logprobs, the temperature and compression
    ratio of each row, its text) equals JAX's."""
    jp, tp, enc = setup
    calls = {"jax": [], "port": []}

    def jax_fn(p, e, key, t):   # JAX hands the temperature over as f32
        t = round(float(t), 6)
        calls["jax"].append((e.shape[0], t))
        return tuple(jnp.asarray(a) for a in _fake_rung(np.asarray(e), t))

    def port_rung(params, arch, e, cfg, generator=None, temperature=0.0,
                  return_logprobs=False):
        t = round(float(temperature), 6)
        calls["port"].append((e.shape[0], t))
        return tuple(torch.from_numpy(a) for a in _fake_rung(e.numpy(), t))

    monkeypatch.setattr(jax_fallback, "_ladder_fns", lambda a, c: (jax_fn, None))
    monkeypatch.setattr(fallback, "greedy_decode", port_rung)
    rj = jax_fallback.decode_with_fallback(jp, ARCH, jnp.asarray(enc), _text,
                                           cfg=JaxDecodeConfig(**CFG_KW), **kw)
    rt = fallback.decode_with_fallback(tp, T_ARCH, torch.from_numpy(enc), _text,
                                       cfg=CFG, **kw)
    assert calls["port"] == calls["jax"]
    for name in ("tokens", "lengths", "avg_logprobs", "temperatures",
                 "compression_ratios", "is_silent"):
        np.testing.assert_array_equal(getattr(rt, name), getattr(rj, name), name)
    assert rt.texts == rj.texts and rt.no_speech_probs is None
    if kw.get("logprob_threshold") == 0.0:
        assert len(calls["port"]) == 6 and (rt.temperatures == 1.0).all()


def test_real_ladder_keeps_the_first_passing_rung(setup):
    """A real ladder (flat logits: mean logprobs near -6.9, so a threshold
    of -6.8 sends the rows to different rungs): a row kept below the last
    rung passed both gates there; t = 0 rows equal plain greedy; texts are
    the generated tokens' words."""
    _, tp, enc = setup
    greedy_toks, _, greedy_lp = (x.numpy() for x in _greedy(tp, enc, return_logprobs=True))
    res = fallback.decode_with_fallback(tp, T_ARCH, torch.from_numpy(enc), _text,
                                        cfg=CFG, logprob_threshold=-6.8, seed=1)
    passes = [not fallback.needs_fallback(float(lp), float(r), 2.4, -6.8)
              for lp, r in zip(res.avg_logprobs, res.compression_ratios)]
    for i, t in enumerate(res.temperatures):
        if t == 0.0:
            np.testing.assert_array_equal(res.tokens[i], greedy_toks[i])
            assert res.avg_logprobs[i] == greedy_lp[i]
        if t < 1.0:
            assert passes[i]
        gen = [int(x) for x in res.tokens[i, P_LEN: res.lengths[i]] if x != 997]
        assert res.texts[i] == _text(gen)
    assert len(set(res.temperatures.tolist())) > 1


def test_one_seed_one_ladder(setup):
    _, tp, enc = setup
    kw = dict(cfg=CFG, logprob_threshold=0.0, temperatures=(0.0, 0.7, 1.0),
              best_of=2, seed=5)
    a = fallback.decode_with_fallback(tp, T_ARCH, torch.from_numpy(enc), _text, **kw)
    b = fallback.decode_with_fallback(tp, T_ARCH, torch.from_numpy(enc), _text, **kw)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.avg_logprobs, b.avg_logprobs)
    assert (a.temperatures == 1.0).all()


def test_no_speech_gate_matches_jax(setup):
    jp, tp, enc = setup
    kw = dict(compression_ratio_threshold=None, logprob_threshold=None)
    for thr in (1.1, -1.0):
        rj = jax_fallback.decode_with_fallback(
            jp, ARCH, jnp.asarray(enc), _text, cfg=JaxDecodeConfig(**CFG_KW),
            no_speech_threshold=thr, **kw)
        rt = fallback.decode_with_fallback(
            tp, T_ARCH, torch.from_numpy(enc), _text, cfg=CFG,
            no_speech_threshold=thr, **kw)
        np.testing.assert_allclose(rt.no_speech_probs, rj.no_speech_probs, atol=1e-6)
        np.testing.assert_array_equal(rt.is_silent, rj.is_silent)
        np.testing.assert_array_equal(rt.tokens, rj.tokens)
        assert rt.texts == rj.texts
        assert (rt.is_silent == (thr < 0)).all()
    # a low-confidence verdict confirms silence only where the logprob is low
    rt = fallback.decode_with_fallback(tp, T_ARCH, torch.from_numpy(enc), _text,
                                       cfg=CFG, compression_ratio_threshold=None,
                                       logprob_threshold=-1e9, temperatures=(0.0,),
                                       no_speech_threshold=-1.0)
    assert not rt.is_silent.any()


def test_fallback_rejects_beam(setup):
    _, tp, enc = setup
    with pytest.raises(ValueError, match="beam_size"):
        fallback.decode_with_fallback(tp, T_ARCH, torch.from_numpy(enc), _text,
                                      cfg=DecodeConfig(beam_size=5))


def test_default_ladder_is_jax_ones():
    assert fallback.DEFAULT_TEMPERATURES == jax_fallback.DEFAULT_TEMPERATURES
