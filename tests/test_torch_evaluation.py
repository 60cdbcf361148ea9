"""The port's evaluation layer against the JAX package: the metrics (on
the cases of `tests/test_evaluation.py`), the tokenizer, the synthetic
dataset (bit for bit), the audio readers and the native batch loader, the
memory tracker's analytic figure, `make_calibration_fn` (which drives
`forward`), and `evaluate_model` on `test2l` with the arguments of
`test_evaluate_model_end_to_end`: the same records (ids, hypotheses,
per-sample WER) and the same corpus WER/CER, exactly; length bucketing
keeps them. `load_librispeech` is held to its offline refusal only, with
the `datasets` import blocked, so no test reaches the network."""

import json
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu import runtime_native as jax_rt
from openai_whisper_compression_tpu.audio import features as jax_features
from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.config import EvalConfig as JaxEvalConfig
from openai_whisper_compression_tpu.evaluation import data as jax_data
from openai_whisper_compression_tpu.evaluation import harness as jax_harness
from openai_whisper_compression_tpu.evaluation import memory as jax_memory
from openai_whisper_compression_tpu.evaluation import metrics as jax_metrics
from openai_whisper_compression_tpu.evaluation import tokenizer as jax_tokenizer
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.models import whisper as jax_whisper
from openai_whisper_compression_tpu_torch import runtime_native as rt
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig, EvalConfig
from openai_whisper_compression_tpu_torch.evaluation import (data, harness, memory,
                                                             metrics, tokenizer)
from openai_whisper_compression_tpu_torch.models.params import from_numpy

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

ARCH, T_ARCH = JAX_ARCHS["test2l"], ARCHS["test2l"]
# test_evaluate_model_end_to_end's decode: 6 new tokens, no language or task
# token, timestamps on
DCFG = dict(max_new_tokens=6, language_token_id=None, task_token_id=None,
            notimestamps=False)


# ---------------------------------------------------------------------------
# metrics and tokenizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ref,hyp", [
    (list("kitten"), list("sitting")), ([], list("ab")), (list("abc"), []),
    (list("abc"), list("abc")), ("a man a plan".split(), "a plan".split())])
def test_edit_distance_matches_jax(ref, hyp):
    assert metrics.edit_distance(ref, hyp) == jax_metrics.edit_distance(ref, hyp)


def test_edit_distance_random_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(25):
        r = list(rng.integers(0, 5, rng.integers(0, 12)))
        h = list(rng.integers(0, 5, rng.integers(0, 12)))
        assert metrics.edit_distance(r, h) == jax_metrics.edit_distance(r, h)


REFS = ["the cat sat on the mat", "hello world", "Hello, World!  ",
        "It's twenty-two dollars", "Mr. Smith won't go"]
HYPS = ["the cat sat on mat", "hello word", "hello world", "it is $22",
        "mister smith will not go"]


@pytest.mark.parametrize("name", [None, "basic", "whisper", "none"])
def test_wer_cer_match_jax(name):
    nt, nj = metrics.resolve_normalizer(name), jax_metrics.resolve_normalizer(name)
    normalize = nj is not None
    assert metrics.wer(REFS, HYPS, normalize, nt) == jax_metrics.wer(REFS, HYPS, normalize, nj)
    assert metrics.cer(REFS, HYPS, normalize, nt) == jax_metrics.cer(REFS, HYPS, normalize, nj)
    for r, h in zip(REFS, HYPS):
        assert (metrics.per_sample_wer(r, h, normalize, nt)
                == jax_metrics.per_sample_wer(r, h, normalize, nj))
    assert metrics.wer(REFS[:2], HYPS[:2]) == pytest.approx(2 / 8)


def test_normalizers_match_jax():
    texts = ["Hello, World!  ", "It's one hundred and twenty-three dollars! [laughs]",
             "Mr. Smith won't go", "Füße!"]
    for t in texts:
        assert metrics.normalize_text(t) == jax_metrics.normalize_text(t)
        for lang in ("en", "de"):
            assert (metrics.whisper_normalizer(lang)(t)
                    == jax_metrics.whisper_normalizer(lang)(t))
    assert metrics.whisper_normalizer() is metrics.whisper_normalizer()
    assert metrics.resolve_normalizer("basic") is metrics.normalize_text
    with pytest.raises(ValueError, match="unknown normalizer"):
        metrics.resolve_normalizer("bogus")


def test_word_tokenizer_matches_jax():
    for special in (None, 997):
        t = tokenizer.WordTokenizer(1000, special_start=special)
        j = jax_tokenizer.WordTokenizer(1000, special_start=special)
        ids = [3, 999, 997, 12, 998, 0]
        assert t.decode(ids) == j.decode(ids)
        assert t.encode("w3 x w12 w0 wq") == j.encode("w3 x w12 w0 wq")
    for name in ("test2l", "small", "small.en"):
        a = tokenizer.default_tokenizer(ARCHS[name])
        b = jax_tokenizer.default_tokenizer(JAX_ARCHS[name])
        assert (a.vocab_size, a.special_start) == (b.vocab_size, b.special_start)


# ---------------------------------------------------------------------------
# data, audio readers, native loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(num_samples=4, seed=3),
                                dict(num_samples=6, seed=1, vocab_size=500,
                                     min_dur=0.5, max_dur=1.2),
                                dict(num_samples=3, seed=9, min_words=1, max_words=2)])
def test_synthetic_dataset_is_jax_bit_for_bit(kw):
    a, b = data.synthetic_dataset(**kw), jax_data.synthetic_dataset(**kw)
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert (u.uid, u.text, u.duration) == (v.uid, v.text, v.duration)
        assert u.audio.dtype == v.audio.dtype
        np.testing.assert_array_equal(u.audio, v.audio)


def test_prepare_datasets_and_batches_match_jax():
    a = data.prepare_datasets(num_cal=2, num_test=3)
    b = jax_data.prepare_datasets(num_cal=2, num_test=3)
    assert list(a) == list(b)
    for k in a:
        assert [u.uid for u in a[k]] == [u.uid for u in b[k]]
    batches = list(data.batch_iterator(a["test_clean"], 2))
    assert [len(x) for x in batches] == [2, 1]


def test_audio_readers_match_jax(tmp_path):
    """A 16-bit .wav at 8 kHz (resampled by the native loader) and a .npy;
    `load_audio_dir` with a sidecar transcript."""
    rng = np.random.default_rng(4)
    pcm = (rng.standard_normal(4000) * 3000).astype(np.int16)
    with wave.open(str(tmp_path / "a.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(pcm.tobytes())
    np.save(tmp_path / "b.npy", rng.standard_normal(3000).astype(np.float32))
    (tmp_path / "b.txt").write_text("w1 w2")
    for name in ("a.wav", "b.npy"):
        np.testing.assert_array_equal(data.read_audio_file(str(tmp_path / name)),
                                      jax_data.read_audio_file(str(tmp_path / name)))
    got, want = data.load_audio_dir(str(tmp_path)), jax_data.load_audio_dir(str(tmp_path))
    assert [(u.uid, u.text, u.duration) for u in got] == \
        [(u.uid, u.text, u.duration) for u in want]
    assert got[1].text == "w1 w2"
    with pytest.raises(FileNotFoundError):
        data.load_audio_dir(str(tmp_path / "missing"))


def test_batch_loader_matches_jax():
    rng = np.random.default_rng(5)
    waves = [rng.standard_normal(n).astype(np.float32) for n in (500, 1500)]
    a, b = rt.BatchLoader(3, 1000, n_threads=2), jax_rt.BatchLoader(3, 1000, n_threads=2)
    for loader in (a, b):
        loader.submit(0, waves[0])
        loader.submit(1, waves[1], sample_rate=8000)
        loader.clear(2)
    np.testing.assert_array_equal(a.flush(), b.flush())
    assert rt.available() == jax_rt.available()


def test_load_librispeech_refuses_offline(monkeypatch):
    """With no `datasets` package to load from, the loader raises its
    RuntimeError naming the offline fallback (the import is blocked, so the
    test never reaches the network)."""
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(RuntimeError, match="synthetic_dataset"):
        data.load_librispeech(2)


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trees():
    """test_evaluate_model_end_to_end's tree: init_params(PRNGKey(0))."""
    jp = JP.init_params(ARCH, jax.random.PRNGKey(0))
    return jp, from_numpy(jax.tree.map(np.asarray, jp), device=DEV)


@pytest.mark.parametrize("kw", [dict(), dict(kv_int8=True, cross_kv_bytes=1.0,
                                             cache_len=128, beam=5),
                                dict(audio_resident=False, cross_s=750)])
def test_analytic_memory_matches_jax(trees, kw):
    jp, tp = trees
    for name in ("test2l", "small"):
        got = memory.analytic_hbm_mb(tp, ARCHS[name], 4, **kw)
        assert got == jax_memory.analytic_hbm_mb(jp, JAX_ARCHS[name], 4, **kw)


def test_memory_tracker_on_the_cpu(trees, tmp_path):
    """No card: device stats are empty, so a tracker with the analytic
    model reports it, flagged, equal to the JAX tracker's on the CPU."""
    jp, tp = trees
    assert memory.device_memory_stats(DEV) == {}
    t = memory.MemoryTracker("m", save_path=str(tmp_path / "mem.json"), device=DEV)
    j = jax_memory.MemoryTracker("m")
    for tr, p, a in ((t, tp, T_ARCH), (j, jp, ARCH)):
        tr.set_analytic(p, a, 4, kv_int8=True, cross_kv_bytes=1.0)
        for i in range(3):
            tr.log_memory(split="clean", batch_idx=i, batch_size=4,
                          audio_duration=10.0, latency=0.5)
    st, sj = t.get_memory_summary(), j.get_memory_summary()
    assert t.analytic_mb == j.analytic_mb
    assert st["hbm_peak_mb"] == sj["hbm_peak_mb"] and st["hbm_analytic"]
    assert st["num_samples"] == 3 and st["rss_mb"]["mean"] > 0
    t.close()
    assert len(json.loads((tmp_path / "mem.json").read_text())["samples"]) == 3


def test_cpu_evaluation_reads_no_card(trees, monkeypatch):
    """On a machine with a card, a CPU evaluation's tracker (made for the
    card by default) reads the memory of the params' device: it never asks
    the card's allocator and reports the analytic figure, flagged."""
    def no_card_reading(*a, **k):
        raise AssertionError("the card's allocator was read")

    tracker = memory.MemoryTracker("test2l")
    assert tracker.device.type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", no_card_reading)
    monkeypatch.setattr(torch.cuda, "mem_get_info", no_card_reading)
    _, tp = trees
    ttok = tokenizer.WordTokenizer(T_ARCH.vocab_size, special_start=997)
    scores, _ = harness.evaluate_model(
        tp, T_ARCH, data.synthetic_dataset(num_samples=2, seed=3, vocab_size=500,
                                           min_dur=0.5, max_dur=1.0),
        ttok, eval_cfg=EvalConfig(batch_size=2, num_samples=2, warmup_batches=0),
        decode_cfg=DecodeConfig(**DCFG), memory_tracker=tracker, device=DEV)
    assert tracker.device == torch.device(DEV)
    assert scores["memory"]["hbm_analytic"]
    assert scores["memory"]["hbm_peak_mb"]["max"] == tracker.analytic_mb


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------

def _evaluate_both(trees, dataset_kw, eval_kw, tracker=False):
    jp, tp = trees
    jd, td = (jax_data.synthetic_dataset(**dataset_kw),
              data.synthetic_dataset(**dataset_kw))
    jtok = jax_tokenizer.WordTokenizer(ARCH.vocab_size, special_start=997)
    ttok = tokenizer.WordTokenizer(T_ARCH.vocab_size, special_start=997)
    js, jr = jax_harness.evaluate_model(
        jp, ARCH, jd, jtok, eval_cfg=JaxEvalConfig(**eval_kw),
        decode_cfg=JaxDecodeConfig(**DCFG),
        memory_tracker=jax_memory.MemoryTracker("test2l") if tracker else None)
    ts, tr = harness.evaluate_model(
        tp, T_ARCH, td, ttok, eval_cfg=EvalConfig(**eval_kw),
        decode_cfg=DecodeConfig(**DCFG),
        memory_tracker=memory.MemoryTracker("test2l") if tracker else None,
        device=DEV)
    return (js, jr), (ts, tr)


def test_evaluate_model_matches_jax(trees, tmp_path):
    (js, jr), (ts, tr) = _evaluate_both(
        trees, dict(num_samples=6, seed=1, vocab_size=500, min_dur=0.5, max_dur=1.2),
        dict(batch_size=4, num_samples=6, warmup_batches=1), tracker=True)
    assert tr == jr   # ids, references, hypotheses, durations, per-sample WER
    for k in ("num_samples", "wer", "cer", "total_audio_duration_s",
              "batch_size", "split", "normalizer"):
        assert ts[k] == js[k], k
    assert ts["wer"] > 0 and ts["rtfx"] > 0 and ts["rtf"] > 0
    assert len(ts["batch_latencies_s"]) == 2
    assert ts["avg_latency_per_batch_s"] == pytest.approx(np.mean(ts["batch_latencies_s"]))
    assert ts["memory"]["num_samples"] == 2
    assert ts["memory"]["hbm_peak_mb"] == js["memory"]["hbm_peak_mb"]
    paths = harness.save_evaluation_results(ts, tr, "test2l", str(tmp_path))
    saved = json.loads(open(paths["metrics"]).read())
    assert saved["model"] == "test2l" and saved["metrics"]["wer"] == ts["wer"]
    assert json.loads(open(paths["transcriptions"]).read()) == tr
    out = harness.print_evaluation_summary({"test2l": ts})
    assert out == jax_harness.print_evaluation_summary(
        {"test2l": {**ts, "rtfx": ts["rtfx"]}})
    assert "WER" in out and f"{ts['wer']:.4f}" in out


def test_length_bucketing_keeps_the_results(trees):
    """Bucketed and unbucketed runs give the same records in input order
    and JAX's, with shuffled durations (0.5-6 s)."""
    kw = dict(num_samples=8, seed=5, vocab_size=500, min_dur=0.5, max_dur=6.0)
    results = {b: _evaluate_both(trees, kw, dict(batch_size=4, warmup_batches=0,
                                                 length_bucketing=b))
               for b in (False, True)}
    ids = [u.uid for u in data.synthetic_dataset(**kw)]
    for b, ((js, jr), (ts, tr)) in results.items():
        assert tr == jr and ts["wer"] == js["wer"] and ts["cer"] == js["cer"]
        assert [r["id"] for r in tr] == ids
    assert results[False][1][1] == results[True][1][1]


def test_transcribe_batch_pads_and_times(trees):
    _, tp = trees
    utts = data.synthetic_dataset(3, seed=2, min_dur=0.5, max_dur=1.0)
    fn = harness.make_transcribe_fn(T_ARCH, DecodeConfig(**DCFG), device=DEV)
    tok = tokenizer.WordTokenizer(T_ARCH.vocab_size, special_start=997)
    texts, dt = harness.transcribe_batch(fn, tp, utts, tok, 4,
                                         harness.samples_for_arch(T_ARCH))
    assert len(texts) == 3 and dt > 0
    wav = np.zeros((4, harness.samples_for_arch(T_ARCH)), np.float32)
    for i, u in enumerate(utts):
        wav[i, : len(u.audio)] = u.audio[: wav.shape[1]]
    tokens, lengths = fn(tp, wav)
    assert texts == [tok.decode(tokens[i, : lengths[i]].tolist()) for i in range(3)]


def test_transcribe_fn_options_match_jax(trees):
    """n_mels, merge_at / merge_factor and return_enc: tokens and lengths
    equal, the encoder output within 1e-4."""
    jp, tp = trees
    wav = (np.random.default_rng(6).standard_normal((2, 20480)) * 0.3).astype(np.float32)
    kw = dict(n_mels=80, merge_at=1, merge_factor=2, return_enc=True)
    jt, jl, je = jax_harness.make_transcribe_fn(
        ARCH, JaxDecodeConfig(**DCFG), use_pallas_mel=False, **kw)(jp, jnp.asarray(wav))
    tt, tl, te = harness.make_transcribe_fn(T_ARCH, DecodeConfig(**DCFG), device=DEV,
                                            **kw)(tp, wav)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert te.shape == (2, 32, 64)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-4)


def test_calibration_fn_drives_forward(trees, monkeypatch):
    """The calibration callable runs `forward` once a call over its fixed
    batch (capped at batch_size, <|sot|> then the reference's words, EOT
    padding) and returns its logits, within 1e-3 of the JAX forward of the
    same batch (logits of order 1)."""
    jp, tp = trees
    utts = data.synthetic_dataset(5, seed=7, vocab_size=500, min_dur=0.5, max_dur=1.2)
    tok = tokenizer.WordTokenizer(T_ARCH.vocab_size, special_start=997)
    seen = []
    real = harness.forward
    monkeypatch.setattr(harness, "forward", lambda *a, **k: seen.append(a[3]) or real(*a, **k))
    run = harness.make_calibration_fn(T_ARCH, utts, tok, batch_size=4, n_tokens=8,
                                      device=DEV)
    logits = run(tp)
    assert len(seen) == 1 and logits.shape == (4, 8, T_ARCH.vocab_size)
    toks = seen[0].numpy()
    assert (toks[:, 0] == T_ARCH.decoder_start_token_id).all()
    for i, u in enumerate(utts[:4]):
        ids = tok.encode(u.text)[:7]
        assert toks[i, 1: 1 + len(ids)].tolist() == ids
        assert (toks[i, 1 + len(ids):] == T_ARCH.eos_token_id).all()
    wavs = np.zeros((4, harness.samples_for_arch(T_ARCH)), np.float32)
    for i, u in enumerate(utts[:4]):
        a = u.audio[: wavs.shape[1]]
        wavs[i, : len(a)] = a
    mel = jax_features.preprocess(jnp.asarray(wavs), n_mels=80, length=wavs.shape[1])
    ref = jax_whisper.forward(jp, ARCH, mel, jnp.asarray(toks.astype(np.int32)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=1e-3)
    run(tp)
    assert len(seen) == 2
    with pytest.raises(ValueError):
        harness.make_calibration_fn(T_ARCH, [], device=DEV)
