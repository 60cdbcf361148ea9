"""The port's `models/alignment.py` against the JAX package on `test2l` in
f32: `dtw_path` and `_median_filter` equal to JAX's, the DTW's properties,
`cross_attention_weights` within 1e-5 of the jitted JAX pass (dense and
int8 weights), `find_alignment`'s token times equal to JAX's, the word
grouping and `merge_punctuations` equal to JAX's, word probabilities, and
`transcribe_seek(word_timestamps=True)`'s words equal to JAX's. Weights
come from `init_params_jit` through `from_numpy`; inputs from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.evaluation import longform as jax_longform
from openai_whisper_compression_tpu.evaluation.tokenizer import (
    WordTokenizer as JaxWordTokenizer)
from openai_whisper_compression_tpu.models import alignment as jax_alignment
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.quant.api import quantize_params as jax_quantize
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.evaluation import longform
from openai_whisper_compression_tpu_torch.evaluation.tokenizer import WordTokenizer
from openai_whisper_compression_tpu_torch.models import alignment
from openai_whisper_compression_tpu_torch.models.params import from_numpy

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

# probabilities in [0, 1] from f32 sums in another order than XLA's
PROBS_ATOL = 1e-5


@pytest.fixture(scope="module")
def tree():
    """test2l at JAX's default weight scale: (JAX tree, torch tree)."""
    jp = JP.init_params_jit(JAX_ARCHS["test2l"], jax.random.PRNGKey(0))
    return jp, from_numpy(jax.tree.map(np.asarray, jp), device=DEV)


def _enc(seed, b=1):
    return (np.random.default_rng(seed).standard_normal((b, 64, 64)) * 0.1
            ).astype(np.float32)


def test_dtw_diagonal():
    """A strongly diagonal similarity aligns about diagonally, monotonic and
    covering every token and frame; the path equals JAX's."""
    n, m = 10, 40
    sim = np.zeros((n, m))
    for i in range(n):
        sim[i, i * 4: i * 4 + 4] = 1.0
    ti, fi = alignment.dtw_path(-sim)
    rti, rfi = jax_alignment.dtw_path(-sim)
    np.testing.assert_array_equal(ti, rti)
    np.testing.assert_array_equal(fi, rfi)
    assert (np.diff(ti) >= 0).all() and (np.diff(fi) >= 0).all()
    assert ti[0] == 0 and fi[0] == 0 and ti[-1] == n - 1 and fi[-1] == m - 1
    for tok in range(n):
        f = fi[np.flatnonzero(ti == tok)[0]]
        assert abs(int(f) - tok * 4) <= 1


@pytest.mark.parametrize("shape", [(7, 19), (1, 5), (12, 3), (9, 64)])
def test_dtw_path_steps(shape):
    """On random costs: only (0, 1), (1, 0), (1, 1) steps, and the path
    equal to JAX's (ties included: costs of 0 and 1 only in one case)."""
    rng = np.random.default_rng(shape[0])
    cost = rng.random(shape)
    if shape == (9, 64):
        cost = np.round(cost)          # many exact ties
    ti, fi = alignment.dtw_path(cost)
    rti, rfi = jax_alignment.dtw_path(cost)
    np.testing.assert_array_equal(ti, rti)
    np.testing.assert_array_equal(fi, rfi)
    steps = set(zip(np.diff(ti).tolist(), np.diff(fi).tolist()))
    assert steps <= {(0, 1), (1, 0), (1, 1)}


@pytest.mark.parametrize("width", [1, 3, 7])
def test_median_filter(width):
    x = np.asarray([[1.0, 100.0, 1.0, 1.0, 1.0]])
    out = alignment._median_filter(x, width)
    assert out.shape == x.shape
    if width == 3:
        assert out[0, 1] == 1.0  # spike removed
    r = np.random.default_rng(width).standard_normal((3, 4, 50))
    np.testing.assert_array_equal(alignment._median_filter(r, width),
                                  jax_alignment._median_filter(r, width))


def test_word_grouping():
    class Tok:
        def decode(self, ids):
            return {1: " hello", 2: "world", 3: " there"}.get(ids[0], "")

    times = np.asarray([[0.0, 0.2], [0.2, 0.5], [0.5, 0.9]])
    words = alignment.word_timestamps(Tok(), [1, 2, 3], times)
    assert [w["word"] for w in words] == ["helloworld", "there"]
    assert words[0]["start"] == 0.0 and words[0]["end"] == 0.5
    assert words[1]["start"] == 0.5 and words[1]["end"] == 0.9
    assert words == jax_alignment.word_timestamps(Tok(), [1, 2, 3], times)
    assert (alignment.word_timestamps(Tok(), [1, 2, 3], times, offset=2.5,
                                      punctuations=False)
            == jax_alignment.word_timestamps(Tok(), [1, 2, 3], times, offset=2.5,
                                             punctuations=False))


def test_find_alignment_end_to_end(tree):
    """Token times equal JAX's (same DTW over the same standardized,
    filtered matrix), well formed: start <= end, monotonic starts, inside
    the window; with n_frames and explicit heads too."""
    jp, tp = tree
    arch, j_arch = ARCHS["test2l"], JAX_ARCHS["test2l"]
    enc = _enc(1)
    tokens = np.asarray([arch.decoder_start_token_id, 5, 9, 13, 21], np.int32)
    for kw in ({}, {"n_frames": 40, "alignment_heads": [(0, 1), (1, 3)]}):
        tt = alignment.find_alignment(tp, arch, torch.from_numpy(enc), tokens, **kw)
        ref = jax_alignment.find_alignment(jp, j_arch, jnp.asarray(enc), tokens, **kw)
        np.testing.assert_array_equal(tt, ref)
        assert tt.shape == (len(tokens), 2) and tt.dtype == np.float32
        assert (tt[:, 0] <= tt[:, 1]).all() and (np.diff(tt[:, 0]) >= 0).all()
        max_t = kw.get("n_frames", 64) * alignment.FRAME_SECONDS
        assert (tt >= 0).all() and (tt <= max_t + 1e-6).all()
    assert alignment.default_alignment_heads(arch) == \
        jax_alignment.default_alignment_heads(j_arch)
    assert alignment.FRAME_SECONDS == jax_alignment.FRAME_SECONDS


def test_transcribe_seek_word_timestamps():
    """transcribe_seek with word timestamps over 1.5 windows: the result
    (segments, metadata and words) equals JAX's; words well formed."""
    j_arch = JAX_ARCHS["test2l"].replace(no_timestamps_token_id=900)
    arch = ARCHS["test2l"].replace(no_timestamps_token_id=900)
    jp = JP.init_params_jit(j_arch, jax.random.PRNGKey(21))
    tp = from_numpy(jax.tree.map(np.asarray, jp), device=DEV)
    n_win = 2 * 64 * 160
    wav = (np.random.default_rng(3).standard_normal(int(1.5 * n_win)) * 0.1
           ).astype(np.float32)
    cfg_kw = dict(max_new_tokens=10, language_token_id=None, task_token_id=None,
                  notimestamps=False, max_initial_timestamp_index=20)
    res = longform.transcribe_seek(tp, arch, wav, WordTokenizer(1000, special_start=897),
                                   DecodeConfig(**cfg_kw), word_timestamps=True,
                                   device=DEV)
    ref = jax_longform.transcribe_seek(jp, j_arch, wav,
                                       JaxWordTokenizer(1000, special_start=897),
                                       JaxDecodeConfig(**cfg_kw), word_timestamps=True)
    _same_result(res, ref)
    assert res["words"]
    for w in res["words"]:
        assert w["end"] >= w["start"] >= 0
        assert w["start"] <= res["audio_seconds"] + 30.0
        assert isinstance(w["word"], str) and w["word"]


def _same_result(got: dict, ref: dict, fl=1e-5) -> None:
    """Result dicts equal: every key, integers and strings exactly, floats
    (times, logprobs, ratios, probabilities) within `fl`."""
    assert set(got) == set(ref)

    def same(a, b, where):
        if isinstance(b, dict):
            assert set(a) == set(b), where
            for k in b:
                same(a[k], b[k], f"{where}.{k}")
        elif isinstance(b, (list, tuple)):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        elif isinstance(b, float) and not isinstance(b, bool):
            assert a == pytest.approx(b, abs=fl), where
        else:
            assert a == b, where
    same(got, ref, "result")


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_cross_attention_weights_shape_and_softmax(tree, kind):
    """(L_layers, B, H, L, S) f32 rows that sum to 1, within PROBS_ATOL of
    the jitted JAX pass, for dense and int8 weights."""
    jp, tp = tree
    if kind == "int8":
        jp = jax_quantize(jp, "int8")
        tp = from_numpy(jax.tree.map(np.asarray, jp), device=DEV)
    arch, j_arch = ARCHS["test2l"], JAX_ARCHS["test2l"]
    rng = np.random.default_rng(2)
    enc = (rng.standard_normal((2, 64, 64)) * 0.1).astype(np.float32)
    toks = rng.integers(0, 900, (2, 4))
    w = alignment.cross_attention_weights(tp, arch, torch.from_numpy(toks),
                                          torch.from_numpy(enc))
    assert w.shape == (2, 2, 4, 4, 64) and w.dtype == torch.float32
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-4)
    ref = jax.jit(lambda p, t, e: jax_alignment.cross_attention_weights(
        p, j_arch, t, e))(jp, jnp.asarray(toks, jnp.int32), jnp.asarray(enc))
    np.testing.assert_allclose(w.numpy(), np.asarray(ref), atol=PROBS_ATOL)


def test_merge_punctuations_append():
    words = [{"word": "hello", "start": 0.0, "end": 0.5},
             {"word": ",", "start": 0.5, "end": 0.6},
             {"word": "world", "start": 0.6, "end": 1.0},
             {"word": "!", "start": 1.0, "end": 1.1}]
    out = alignment.merge_punctuations(words)
    assert out == [{"word": "hello,", "start": 0.0, "end": 0.6},
                   {"word": "world!", "start": 0.6, "end": 1.1}]
    assert out == jax_alignment.merge_punctuations(words)


def test_merge_punctuations_prepend():
    words = [{"word": "¿", "start": 0.0, "end": 0.1},
             {"word": "qué", "start": 0.1, "end": 0.4, "probability": 0.7},
             {"word": "?", "start": 0.4, "end": 0.5}]
    out = alignment.merge_punctuations(words)
    assert out == [{"word": "¿qué?", "start": 0.0, "end": 0.5, "probability": 0.7}]
    assert out == jax_alignment.merge_punctuations(words)


def test_merge_punctuations_consecutive_and_orphan():
    # consecutive openers accumulate; a trailing orphan opener is kept
    words = [{"word": '"', "start": 0.0, "end": 0.1},
             {"word": "(", "start": 0.1, "end": 0.2},
             {"word": "hi", "start": 0.2, "end": 0.5},
             {"word": "-", "start": 0.6, "end": 0.7}]
    out = alignment.merge_punctuations(words)
    assert out[0] == {"word": '"(hi', "start": 0.0, "end": 0.5}
    assert out[1]["word"] == "-"
    assert out == jax_alignment.merge_punctuations(words)
    assert alignment.PREPEND_PUNCTUATIONS == jax_alignment.PREPEND_PUNCTUATIONS
    assert alignment.APPEND_PUNCTUATIONS == jax_alignment.APPEND_PUNCTUATIONS


def test_merge_punctuations_no_op_on_plain_words():
    words = [{"word": "a", "start": 0.0, "end": 0.1},
             {"word": "b", "start": 0.1, "end": 0.2}]
    assert alignment.merge_punctuations(words) == words
    assert alignment.merge_punctuations([]) == jax_alignment.merge_punctuations([]) == []


def test_word_probabilities_from_token_logprobs():
    class SpacedTok:  # BPE-like: a leading space starts a new word
        special_start = 900

        def decode(self, ids):
            return "".join({10: " he", 11: "llo", 12: " there"}[i] for i in ids)

    tok = SpacedTok()
    ids = [950, 10, 11, 12]  # a special, then "hello" (2 tokens), "there"
    times = np.asarray([[0.0, 0.1], [0.1, 0.5], [0.5, 0.9], [0.9, 1.3]])
    lps = np.log(np.asarray([1.0, 0.8, 0.2, 0.5]))
    words = alignment.word_timestamps(tok, ids, times, token_logprobs=lps)
    assert [w["word"] for w in words] == ["hello", "there"]
    np.testing.assert_allclose(words[0]["probability"], (0.8 * 0.2) ** 0.5, rtol=1e-6)
    np.testing.assert_allclose(words[1]["probability"], 0.5, rtol=1e-6)
    assert words == jax_alignment.word_timestamps(tok, ids, times, token_logprobs=lps)
    words2 = alignment.word_timestamps(tok, ids, times)
    assert "probability" not in words2[0]
    assert words2 == jax_alignment.word_timestamps(tok, ids, times)
