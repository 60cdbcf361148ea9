"""The port's `evaluation/longform.py` against the JAX package on `test2l` /
`test2l-ts` in f32: `chunk_waveform`, `transcribe_long` in each branch
(batched, the fallback ladder, conditioned, an initial prompt),
`segments_from_tokens`, `_parse_clips`, `_seed_prompt`, the hallucination
rules and anomaly scores, `transcribe_seek` with clips, word timestamps,
the hallucination rules, the fallback ladder and conditioning, and
`transcribe_seek_batch` (f32 and int16 staging, word timestamps, an
injected logprob function): result dicts equal to JAX's (integers and
strings exactly, floats within 1e-5). The port's idle batch rows are zeros
(silence), which the JAX function does not give them (it decodes stream
0's window there); no test pins that. `torch.multinomial` does not draw what
`jax.random.categorical` draws, so where the ladder samples only the
result's form is held. `chip_smoke.craft_ts_embeddings` is held equal to
`bench._craft_ts_embeddings`."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.evaluation import longform as jax_longform
from openai_whisper_compression_tpu.evaluation.harness import (
    make_transcribe_fn as jax_make_transcribe_fn)
from openai_whisper_compression_tpu.evaluation.tokenizer import (
    WordTokenizer as JaxWordTokenizer)
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.evaluation import longform
from openai_whisper_compression_tpu_torch.evaluation.harness import (
    make_transcribe_fn, samples_for_arch)
from openai_whisper_compression_tpu_torch.evaluation.tokenizer import WordTokenizer
from openai_whisper_compression_tpu_torch.models.params import from_numpy, tree_cast

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
WIN = 2 * 64 * 160          # test2l's window: 64 encoder frames, 20480 samples
TS = dict(language_token_id=None, task_token_id=None, notimestamps=False,
          max_initial_timestamp_index=20)
# result floats (times, logprobs, ratios, probabilities) from f32 sums in
# another order than XLA's
FLOAT_ATOL = 1e-5


def _tree(j_arch, seed):
    jp = JP.init_params_jit(j_arch, jax.random.PRNGKey(seed))
    return jp, from_numpy(jax.tree.map(np.asarray, jp), device=DEV)


@pytest.fixture(scope="module")
def ts900():
    """test2l with <|notimestamps|> at 900 (timestamps 901..999), seed 21,
    the JAX seek tests' model: (JAX arch, port arch, JAX tree, torch tree)."""
    j_arch = JAX_ARCHS["test2l"].replace(no_timestamps_token_id=900)
    arch = ARCHS["test2l"].replace(no_timestamps_token_id=900)
    return (j_arch, arch, *_tree(j_arch, 21))


@pytest.fixture(scope="module")
def plain():
    """test2l, seed 0: (JAX arch, port arch, JAX tree, torch tree)."""
    return (JAX_ARCHS["test2l"], ARCHS["test2l"], *_tree(JAX_ARCHS["test2l"], 0))


def _toks(special=897):
    return WordTokenizer(1000, special_start=special), JaxWordTokenizer(1000, special_start=special)


def _wav(seed, n, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(int(n)) * scale).astype(np.float32)


def _same(got, ref, where="result"):
    """Equal structures: integers and strings exactly, floats within
    FLOAT_ATOL (numpy scalars compared as Python numbers)."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), where
        for k in ref:
            _same(got[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), where
        for i, (a, b) in enumerate(zip(got, ref)):
            _same(a, b, f"{where}[{i}]")
    elif isinstance(ref, (float, np.floating)):
        assert got == pytest.approx(float(ref), abs=FLOAT_ATOL), where
    else:
        assert got == ref, where


def _seek_both(tree, wav, cfg_kw, **kw):
    j_arch, arch, jp, tp = tree
    tok, jtok = _toks()
    got = longform.transcribe_seek(tp, arch, wav, tok, DecodeConfig(**cfg_kw),
                                   device=DEV, **kw)
    ref = jax_longform.transcribe_seek(jp, j_arch, wav, jtok, JaxDecodeConfig(**cfg_kw),
                                       **kw)
    return got, ref


def test_chunking():
    n = 1000
    wav = np.ones(3 * n + 17, np.float32)
    chunks = longform.chunk_waveform(wav, n)
    assert len(chunks) == 4 and sum(len(c) for c in chunks) == len(wav)
    assert len(longform.chunk_waveform(np.ones(5, np.float32), n)) == 1
    assert len(longform.chunk_waveform(wav, n, overlap=0.5)) > 4
    for args in ((wav, n), (wav, n, 0.5), (np.ones(5, np.float32), n),
                 (np.zeros(0, np.float32), n)):
        got, ref = longform.chunk_waveform(*args), jax_longform.chunk_waveform(*args)
        assert [c.tolist() for c in got] == [c.tolist() for c in ref]
    assert longform.SOT_PREV == jax_longform.SOT_PREV


def test_transcribe_long_api(plain):
    """The batched branch, 2.5 windows at batch 2: chunks and text equal
    JAX's."""
    j_arch, arch, jp, tp = plain
    wav = _wav(0, 2.5 * WIN)
    cfg_kw = dict(max_new_tokens=4, **TS)
    tok, jtok = _toks(997)
    got = longform.transcribe_long(tp, arch, wav, tok, DecodeConfig(**cfg_kw),
                                   batch_size=2, device=DEV)
    ref = jax_longform.transcribe_long(jp, j_arch, wav, jtok, JaxDecodeConfig(**cfg_kw),
                                       batch_size=2)
    _same(got, ref)
    assert got["num_chunks"] == 3 and len(got["chunks"]) == 3
    assert got["audio_seconds"] == pytest.approx(len(wav) / 16000.0)


def test_transcribe_long_temperatures(plain):
    """The fallback branch with gates every decode passes: the t = 0 rung
    for every chunk, texts equal JAX's and the batched branch's."""
    j_arch, arch, jp, tp = plain
    wav = _wav(1, 2.2 * WIN)
    cfg_kw = dict(max_new_tokens=4, language_token_id=None, task_token_id=None)
    tok, jtok = _toks(997)
    fkw = {"compression_ratio_threshold": None, "logprob_threshold": None}
    got = longform.transcribe_long(tp, arch, wav, tok, DecodeConfig(**cfg_kw),
                                   batch_size=2, temperatures=(0.0, 0.5),
                                   fallback_kw=fkw, device=DEV)
    ref = jax_longform.transcribe_long(jp, j_arch, wav, jtok, JaxDecodeConfig(**cfg_kw),
                                       batch_size=2, temperatures=(0.0, 0.5),
                                       fallback_kw=fkw)
    _same(got, ref)
    plain_run = longform.transcribe_long(tp, arch, wav, tok, DecodeConfig(**cfg_kw),
                                         batch_size=2, device=DEV)
    assert got["chunks"] == plain_run["chunks"]
    with pytest.raises(ValueError, match="condition_on_previous"):
        longform.transcribe_long(tp, arch, wav, tok, DecodeConfig(**cfg_kw),
                                 condition_on_previous=True, temperatures=(0.0,),
                                 device=DEV)


def test_transcribe_long_conditioned(plain):
    j_arch, arch, jp, tp = plain
    wav = _wav(0, 2.2 * WIN)
    cfg_kw = dict(max_new_tokens=4, **TS)
    tok, jtok = _toks(997)
    got = longform.transcribe_long(tp, arch, wav, tok, DecodeConfig(**cfg_kw),
                                   condition_on_previous=True, prompt_window=8,
                                   device=DEV)
    ref = jax_longform.transcribe_long(jp, j_arch, wav, jtok, JaxDecodeConfig(**cfg_kw),
                                       condition_on_previous=True, prompt_window=8)
    _same(got, ref)
    assert got["num_chunks"] == 3 and len(got["chunks"]) == 3


def test_initial_prompt_paths(plain):
    """An initial prompt: the batched path prompts the first window only;
    the conditioned path seeds the rolling window. Both equal JAX's."""
    j_arch, arch, jp, tp = plain
    wav = _wav(2, WIN + 500, 0.05)
    cfg_kw = dict(max_new_tokens=3, self_pallas=False, cross_pallas=False)
    tok, jtok = _toks(997)
    for kw in ({"batch_size": 2, "prompt_window": 8},
               {"condition_on_previous": True, "prompt_window": 8}):
        got = longform.transcribe_long(tp, arch, wav, tok, DecodeConfig(**cfg_kw),
                                       initial_prompt="w5 w17 w300", device=DEV, **kw)
        ref = jax_longform.transcribe_long(jp, j_arch, wav, jtok,
                                           JaxDecodeConfig(**cfg_kw),
                                           initial_prompt="w5 w17 w300", **kw)
        _same(got, ref)
        assert len(got["chunks"]) == 2


def test_segments_from_tokens(ts900):
    """Every ending (pair, single timestamp, none, <|0.00|> only, empty) as
    JAX parses it."""
    j_arch, arch = ts900[:2]
    t = 901
    cases = [[t, 5, 6, t + 10, t + 10, 7, t + 20, t + 20, 8, t + 30],
             [t, 5, t + 4, t + 4, 6, t + 9, 897],
             [5, 6, 7], [t, 5, 6], [t, 5, 6, t + 7], [897, 5], [],
             [t + 3, t + 3, t + 5, 9, t + 8, t + 8]]
    for gen in cases:
        got = longform.segments_from_tokens(arch, np.asarray(gen, np.int64))
        ref = jax_longform.segments_from_tokens(j_arch, np.asarray(gen, np.int32))
        _same(list(got), list(ref), str(gen))


def test_top_level_transcribe_timestamps(ts900):
    """transcribe_seek with words: segments carry OpenAI's metadata (the
    no-speech probability since the encoder output is at hand); without
    words no_speech_prob is None and avg_logprob comes from the greedy
    trace. Both results equal JAX's."""
    wav = _wav(3, WIN)
    cfg_kw = dict(max_new_tokens=8, **TS)
    got, ref = _seek_both(ts900, wav, cfg_kw, word_timestamps=True)
    _same(got, ref)
    for w in got["words"]:
        assert w["end"] >= w["start"] >= 0
    for s in got["segments"]:
        assert s["avg_logprob"] is None or s["avg_logprob"] <= 0.0
        assert s["compression_ratio"] >= 0.0 and 0.0 <= s["no_speech_prob"] <= 1.0
    got2, ref2 = _seek_both(ts900, wav, cfg_kw)
    _same(got2, ref2)
    assert all(s["no_speech_prob"] is None for s in got2["segments"])
    assert all(s["avg_logprob"] is not None and s["avg_logprob"] <= 0.0
               for s in got2["segments"] if s["text"])


def test_seed_prompt_window():
    cases = [([10, 20, 30], 4, 50257, 51865), (list(range(100)), 4, 50257, 51865),
             ([5, 9999], 4, 997, 1000), ([], 6, 997, 1000), ([1, 2, 3], 1, 997, 1000)]
    for args in cases:
        got, ref = longform._seed_prompt(*args), jax_longform._seed_prompt(*args)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
    prompt, plen = longform._seed_prompt([10, 20, 30], pw=4, eot=50257, vocab=51865)
    assert prompt[0].tolist() == [longform.SOT_PREV, 10, 20, 30] and plen[0] == 4


def test_parse_clips():
    for clips in (None, "0", "1,3", "2", "1,3,5", [0.5, 99.0], "", [], 0):
        assert longform._parse_clips(clips, 10.0) == jax_longform._parse_clips(clips, 10.0)
    assert longform._parse_clips("1,3,5", 10.0) == [(1.0, 3.0), (5.0, 10.0)]
    with pytest.raises(ValueError):
        longform._parse_clips("8,3", 10.0)


def test_transcribe_seek_clip_timestamps(ts900):
    wav = _wav(3, 3 * WIN)
    win_s = WIN / 16000.0
    clip = (0.25 * win_s, 1.25 * win_s)
    got, ref = _seek_both(ts900, wav, dict(max_new_tokens=6, **TS),
                          clip_timestamps=f"{clip[0]},{clip[1]}")
    _same(got, ref)
    for s in got["segments"]:
        assert clip[0] - 1e-6 <= s["start"] <= clip[1] + win_s
    assert got["num_windows"] <= 2


def _w(word, start, end, prob=1.0):
    return {"word": word, "start": start, "end": end, "probability": prob}


def _seg(start, end, text="x"):
    return {"start": start, "end": end, "text": text}


def _rules_both(segs, words, *args, **kw):
    got = longform.apply_hallucination_rules(segs, words, *args, **kw)
    ref = jax_longform.apply_hallucination_rules(segs, words, *args, **kw)
    assert got == ref
    return got


def test_hallucination_rules_benign_window_untouched():
    segs = [_seg(0.0, 2.0), _seg(2.0, 4.0)]
    words = [_w("a", 0.1, 0.5), _w("b", 0.6, 1.1), _w("c", 2.2, 2.8), _w("d", 3.0, 3.6)]
    ks, kw, seek = _rules_both(segs, words, 0.0, 4.0, 2.0)
    assert ks == segs and kw == words and seek is None


def test_hallucination_rules_leading_silence_skip():
    segs = [_seg(5.0, 7.0)]
    words = [_w("ghost", 5.0, 5.4, prob=0.01), _w("words", 5.4, 5.8, prob=0.02)]
    ks, kw, seek = _rules_both(segs, words, 0.0, 30.0, 2.0)
    assert ks == [] and kw == [] and seek == 5.0


def test_hallucination_rules_surrounded_by_silence_dropped():
    segs = [_seg(10.0, 12.0), _seg(20.0, 21.0)]
    words = [_w("real", 10.1, 10.6), _w("talk", 10.7, 11.3),
             _w("spooky", 20.0, 20.3, prob=0.01), _w("echo", 20.3, 20.6, prob=0.02)]
    ks, kw, seek = _rules_both(segs, words, 10.0, 40.0, 2.0, last_speech_end=10.0)
    assert ks == [segs[0]] and [w["word"] for w in kw] == ["real", "talk"]
    assert seek == 20.0


def test_hallucination_rules_trailing_silence_seek():
    segs = [_seg(0.0, 3.0)]
    words = [_w("short", 0.2, 0.8), _w("talk", 0.9, 1.5)]
    ks, kw, seek = _rules_both(segs, words, 0.0, 30.0, 2.0)
    assert ks == segs and kw == words and seek == 1.5
    # a segment without an end, hallucinated at the content's end
    segs2 = [_seg(1.0, None), _seg(26.0, 28.5)]
    words2 = [_w("a", 1.1, 1.5), _w("ghost", 26.0, 26.01, prob=0.01)]
    _rules_both(segs2, words2, 0.0, 30.0, 2.0)


def test_anomaly_scoring():
    cases = [_w("ok", 0.0, 0.5), _w("low", 0.0, 0.5, prob=0.05), _w("long", 0.0, 3.5),
             _w("short", 0.0, 0.01), {"word": "np", "start": 0.0, "end": 0.2}]
    for w in cases:
        assert longform._word_anomaly_score(w) == jax_longform._word_anomaly_score(w)
    assert longform._word_anomaly_score(cases[1]) == 1.0
    for ws in ([], None, [_w("a", 0.0, 0.4), _w("b", 0.5, 0.9)],
               [_w("a", 0.0, 0.01, prob=0.01)], cases):
        assert longform._is_segment_anomaly(ws) == jax_longform._is_segment_anomaly(ws)
    assert longform._is_segment_anomaly([_w("a", 0.0, 0.01, prob=0.01)])
    seg = {"start": 1.0, "end": None}
    assert longform._segment_words(seg, cases) == jax_longform._segment_words(seg, cases)


def test_transcribe_seek_hallucination_path_runs(ts900):
    """The hallucination-gated path (logprob trace, word probabilities, the
    rules) end to end: the result equals JAX's."""
    j_arch, arch, jp, tp = ts900
    wav = _wav(3, 2 * WIN)
    cfg_kw = dict(max_new_tokens=6, **TS)
    tok, _ = _toks()
    with pytest.raises(ValueError, match="word_timestamps"):
        longform.transcribe_seek(tp, arch, wav, tok, DecodeConfig(**cfg_kw),
                                 hallucination_silence_threshold=2.0, device=DEV)
    got, ref = _seek_both(ts900, wav, cfg_kw, word_timestamps=True,
                          hallucination_silence_threshold=2.0)
    _same(got, ref)
    for w in got["words"]:
        assert 0.0 <= w["probability"] <= 1.0


def test_transcribe_seek_batch_matches_single_stream(ts900):
    """Multi-stream seek at batch 2 over three streams (0.6, 1.7 and 2.3
    windows): per stream equal to transcribe_seek with a batch-1 function
    and to JAX's transcribe_seek_batch."""
    j_arch, arch, jp, tp = ts900
    g = np.random.default_rng(5)
    wavs = [(g.standard_normal(int(k * WIN)) * 0.1).astype(np.float32)
            for k in (0.6, 1.7, 2.3)]
    cfg_kw = dict(max_new_tokens=6, **TS)
    tok, jtok = _toks()
    got = longform.transcribe_seek_batch(tp, arch, wavs, tok, DecodeConfig(**cfg_kw),
                                         batch_size=2, device=DEV)
    ref = jax_longform.transcribe_seek_batch(jp, j_arch, wavs, jtok,
                                             JaxDecodeConfig(**cfg_kw), batch_size=2)
    _same(got, ref)
    fn1 = make_transcribe_fn(arch, DecodeConfig(**cfg_kw), device=DEV)
    singles = [longform.transcribe_seek(tp, arch, w, tok, DecodeConfig(**cfg_kw),
                                        transcribe_fn=fn1, device=DEV) for w in wavs]
    for b, s in zip(got, singles):
        assert b["num_windows"] == s["num_windows"] and b["text"] == s["text"]
        assert [x["text"] for x in b["segments"]] == [x["text"] for x in s["segments"]]
        np.testing.assert_allclose([x["start"] for x in b["segments"]],
                                   [x["start"] for x in s["segments"]], atol=1e-6)


@pytest.mark.parametrize("stage_int16", [False, True])
def test_seek_batch_idle_rows_are_silence(ts900, stage_int16):
    """Fewer streams than batch rows: every window batch the decode gets
    holds each active stream's slice of the staged pool (an int16 pool
    dequantized by * f32(1/32767), bit for bit) and zeros in every other
    row, and the per-stream results equal JAX's."""
    from openai_whisper_compression_tpu_torch.models.decode import forced_prefix

    j_arch, arch, jp, tp = ts900
    wavs = [_wav(6, 1.3 * WIN), _wav(7, 0.4 * WIN)]
    cfg_kw = dict(max_new_tokens=5, **TS)
    tok, jtok = _toks()
    fn = make_transcribe_fn(arch, DecodeConfig(**cfg_kw), token_logprobs=True,
                            device=DEV)
    seen = []

    def recording(params, wav):
        out = fn(params, wav)
        seen.append((wav.clone(), out[0].numpy(), out[1].numpy()))
        return out

    got = longform.transcribe_seek_batch(tp, arch, wavs, tok, DecodeConfig(**cfg_kw),
                                         batch_size=4, transcribe_fn=recording,
                                         stage_int16=stage_int16, device=DEV)
    ref = jax_longform.transcribe_seek_batch(
        jp, j_arch, wavs, jtok, JaxDecodeConfig(**cfg_kw), batch_size=4,
        transcribe_fn=jax_make_transcribe_fn(j_arch, JaxDecodeConfig(**cfg_kw),
                                             token_logprobs=True),
        stage_int16=stage_int16)
    _same(got, ref)
    assert len(seen) == max(r["num_windows"] for r in got) >= 2
    fg = len(forced_prefix(arch, DecodeConfig(**cfg_kw)))
    pos = [0, 0]
    for it, (buf, tokens, lengths) in enumerate(seen):
        assert buf.shape == (4, WIN) and buf.dtype == torch.float32
        active = [s for s in range(2) if it < got[s]["num_windows"]]
        for r, s in enumerate(active):
            src = wavs[s][pos[s]: pos[s] + WIN]
            if stage_int16:
                src = (np.clip(src * 32767.0, -32768, 32767).astype(np.int16)
                       .astype(np.float32) * np.float32(1.0 / 32767.0))
            piece = np.zeros(WIN, np.float32)
            piece[: len(src)] = src
            np.testing.assert_array_equal(buf[r].numpy(), piece)
            _, seek_s = longform.segments_from_tokens(arch, tokens[r, fg: lengths[r]])
            pos[s] += max(WIN if seek_s is None else int(seek_s * 16000), 1)
        assert not bool(buf[len(active):].any())        # idle rows: silence


def test_transcribe_seek_batch_word_timestamps(ts900):
    j_arch, arch, jp, tp = ts900
    g = np.random.default_rng(7)
    wavs = [(g.standard_normal(int(k * WIN)) * 0.1).astype(np.float32) for k in (1.4, 0.5)]
    cfg_kw = dict(max_new_tokens=6, **TS)
    tok, jtok = _toks()
    got = longform.transcribe_seek_batch(tp, arch, wavs, tok, DecodeConfig(**cfg_kw),
                                         batch_size=4, word_timestamps=True, device=DEV)
    ref = jax_longform.transcribe_seek_batch(jp, j_arch, wavs, jtok,
                                             JaxDecodeConfig(**cfg_kw), batch_size=4,
                                             word_timestamps=True)
    _same(got, ref)
    assert len(got) == 2 and all("words" in r for r in got)
    for r in got:
        for w in r["words"]:
            assert w["end"] >= w["start"] >= 0


def test_seek_batch_accepts_logprob_fn():
    """An injected function with the logprob trace (three outputs): the
    results equal JAX's with its own such function."""
    j_arch = JAX_ARCHS["test2l"].replace(no_timestamps_token_id=900)
    arch = ARCHS["test2l"].replace(no_timestamps_token_id=900)
    jp, tp = _tree(j_arch, 30)
    cfg_kw = dict(max_new_tokens=5, **TS)
    tok, jtok = _toks()
    n = samples_for_arch(arch)
    wavs = [_wav(61, 1.2 * n), _wav(62, n // 2)]
    got = longform.transcribe_seek_batch(
        tp, arch, wavs, tok, DecodeConfig(**cfg_kw), batch_size=2,
        transcribe_fn=make_transcribe_fn(arch, DecodeConfig(**cfg_kw),
                                         token_logprobs=True, device=DEV), device=DEV)
    ref = jax_longform.transcribe_seek_batch(
        jp, j_arch, wavs, jtok, JaxDecodeConfig(**cfg_kw), batch_size=2,
        transcribe_fn=jax_make_transcribe_fn(j_arch, JaxDecodeConfig(**cfg_kw),
                                             token_logprobs=True))
    _same(got, ref)
    assert all(isinstance(r["text"], str) for r in got)


def test_seek_word_timestamps_single_encoder_pass(ts900, monkeypatch):
    """With its own transcription function, transcribe_seek aligns with the
    function's encoder output: no second `encode` call."""
    from openai_whisper_compression_tpu_torch.models import whisper

    j_arch, arch, jp, tp = ts900
    calls = {"n": 0}
    real_encode = whisper.encode

    def counting_encode(*a, **kw):
        calls["n"] += 1
        return real_encode(*a, **kw)

    monkeypatch.setattr(whisper, "encode", counting_encode)
    tok, _ = _toks()
    res = longform.transcribe_seek(tp, arch, _wav(7, WIN // 2), tok,
                                   DecodeConfig(max_new_tokens=5, **TS),
                                   word_timestamps=True, device=DEV)
    assert "words" in res
    # harness.make_transcribe_fn bound `encode` at import, so its one pass
    # is not counted; a second pass for the alignment would be
    assert calls["n"] == 0


def test_transcribe_seek_temperature_fallback(ts900):
    """The ladder per window: gates every decode passes give the t = 0
    rung, results equal JAX's and the plain seek's; an unpassable logprob
    gate keeps the last rung (the port's own draws) with its temperature
    and window avg_logprob stamped on every segment; incompatible options
    raise."""
    j_arch, arch, jp, tp = ts900
    wav = _wav(3, WIN)
    cfg_kw = dict(max_new_tokens=8, **TS)
    tok, _ = _toks()
    passable = {"compression_ratio_threshold": None, "logprob_threshold": None}
    got, ref = _seek_both(ts900, wav, cfg_kw, temperatures=(0.0, 0.7),
                          fallback_kw=passable)
    _same(got, ref)
    plain_run = longform.transcribe_seek(tp, arch, wav, tok, DecodeConfig(**cfg_kw),
                                         device=DEV)
    assert got["text"] == plain_run["text"]
    assert all(s["temperature"] == 0.0 for s in got["segments"])
    res = longform.transcribe_seek(
        tp, arch, wav, tok, DecodeConfig(**cfg_kw), temperatures=(0.0, 0.7),
        fallback_kw={"compression_ratio_threshold": None, "logprob_threshold": 0.0},
        device=DEV)
    assert res["num_windows"] >= 1
    for s in res["segments"]:
        assert s["temperature"] == pytest.approx(0.7)
        assert s["avg_logprob"] is not None and s["avg_logprob"] <= 0.0
    with pytest.raises(ValueError):
        longform.transcribe_seek(tp, arch, wav, tok, DecodeConfig(**cfg_kw),
                                 temperatures=(0.0, 0.5), word_timestamps=True,
                                 hallucination_silence_threshold=1.0, device=DEV)
    with pytest.raises(ValueError, match="transcribe_fn"):
        longform.transcribe_seek(tp, arch, wav, tok, DecodeConfig(**cfg_kw),
                                 temperatures=(0.0,), transcribe_fn=lambda p, w: None,
                                 device=DEV)


def test_transcribe_seek_temperatures_best_of(ts900):
    """temperatures with best_of 2: every segment carries a temperature of
    the ladder."""
    j_arch, arch, jp, tp = ts900
    tok, _ = _toks()
    res = longform.transcribe_seek(tp, arch, _wav(4, WIN), tok,
                                   DecodeConfig(max_new_tokens=6, **TS),
                                   temperatures=(0.0, 1.0), fallback_kw={"best_of": 2},
                                   device=DEV)
    assert "segments" in res
    for s in res["segments"]:
        assert s["temperature"] in (0.0, 1.0)


def test_transcribe_seek_conditioned(ts900):
    """condition_on_previous: a rolling <|startofprev|> prompt; the result
    equals JAX's, with and without initial_prompt_ids; exclusive options
    raise."""
    j_arch, arch, jp, tp = ts900
    wav = _wav(9, 2.4 * WIN)
    cfg_kw = dict(max_new_tokens=6, **TS)
    got, ref = _seek_both(ts900, wav, cfg_kw, condition_on_previous=True, prompt_window=8)
    _same(got, ref)
    assert got["num_windows"] >= 2
    assert all(s["avg_logprob"] is not None for s in got["segments"] if s["text"])
    got2, ref2 = _seek_both(ts900, wav, cfg_kw, condition_on_previous=True,
                            prompt_window=8, initial_prompt_ids=[5, 6, 7])
    _same(got2, ref2)
    tok, _ = _toks()
    for bad in ({"temperatures": (0.0, 0.5)}, {"word_timestamps": True}):
        with pytest.raises(ValueError):
            longform.transcribe_seek(tp, arch, wav, tok, DecodeConfig(**cfg_kw),
                                     condition_on_previous=True, device=DEV, **bad)


def test_seek_initial_prompt_without_conditioning_first_window_only(ts900):
    got, ref = _seek_both(ts900, _wav(11, 2.2 * WIN), dict(max_new_tokens=6, **TS),
                          initial_prompt_ids=[5, 6, 7], prompt_window=8)
    _same(got, ref)
    assert got["num_windows"] >= 2


def test_crafted_ts_fixture_advances():
    """`chip_smoke.craft_ts_embeddings` (the torch copy of
    `bench._craft_ts_embeddings`) gives JAX's crafted embedding (within
    1e-5: one probe's f32 logits) on test2l-ts, and on it
    `transcribe_seek_batch` equals JAX's (the embedding in f32 on both
    sides); on the tree in bf16, as the card runs it, segments close deep in
    the window and the cuts depend on the stream."""
    sys.path.insert(0, str(ROOT))
    import bench
    import chip_smoke

    from openai_whisper_compression_tpu.audio import features as jax_features
    from openai_whisper_compression_tpu_torch.audio import features

    j_arch, arch = JAX_ARCHS["test2l-ts"], ARCHS["test2l-ts"]
    jp = JP.init_params(j_arch, jax.random.PRNGKey(0))      # the JAX test's tree
    tp = from_numpy(jax.tree.map(np.asarray, jp), device=DEV)
    cfg_kw = dict(max_new_tokens=20, **TS)
    rng = np.random.default_rng(3)
    wavs = [rng.standard_normal(int(3.0 * WIN)).astype(np.float32) * 0.1 for _ in range(4)]
    probe = np.stack([w[:WIN] for w in wavs])
    j_pm = jax_features.preprocess(jnp.asarray(probe), j_arch.num_mel_bins, length=WIN,
                                   use_pallas=False)
    t_pm = features.preprocess(torch.from_numpy(probe), arch.num_mel_bins, length=WIN)
    j_lf = bench._craft_ts_embeddings(jp, j_arch, j_pm, peak=1.0)
    t_lf = chip_smoke.craft_ts_embeddings(tp, arch, t_pm, peak=1.0)
    assert t_lf["decoder"]["embed"].dtype == torch.bfloat16
    assert t_lf["decoder"]["layers"] is tp["decoder"]["layers"]
    np.testing.assert_allclose(t_lf["decoder"]["embed"].float().numpy(),
                               np.asarray(j_lf["decoder"]["embed"].astype(jnp.float32)),
                               atol=1e-5)
    # the same crafted tree on both sides for the parity: JAX's embedding in
    # the tree's f32 (bf16 values), as bf16 rows would put the port's f32
    # linears in bf16 where JAX promotes them to f32
    embed = np.array(j_lf["decoder"]["embed"].astype(jnp.float32))
    j_f32 = {**j_lf, "decoder": {**j_lf["decoder"], "embed": jnp.asarray(embed)}}
    t_f32 = {**t_lf, "decoder": {**t_lf["decoder"], "embed": torch.from_numpy(embed)}}
    tok, jtok = _toks()
    got = longform.transcribe_seek_batch(t_f32, arch, wavs, tok, DecodeConfig(**cfg_kw),
                                         batch_size=4, device=DEV)
    ref = jax_longform.transcribe_seek_batch(j_f32, j_arch, wavs, jtok,
                                             JaxDecodeConfig(**cfg_kw), batch_size=4)
    _same(got, ref)
    # the fixture's purpose, on the tree in bf16 as the card runs it
    t_bf16 = chip_smoke.craft_ts_embeddings(tree_cast(tp, torch.bfloat16), arch,
                                            t_pm, peak=1.0)
    res = longform.transcribe_seek_batch(t_bf16, arch, wavs, tok, DecodeConfig(**cfg_kw),
                                         batch_size=4, device=DEV)
    win_s = WIN / 16000.0
    all_ends = []
    for r in res:
        assert r["num_windows"] <= 8, r["num_windows"]
        ends = [s["end"] for s in r["segments"] if s["end"] is not None]
        assert ends
        assert max(e % win_s if e % win_s > 1e-6 else win_s for e in ends) > 0.3 * win_s
        all_ends.append(tuple(round(e, 2) for e in ends))
    assert len(set(all_ends)) > 1, all_ends
