"""The port's dynamic-batching service (`serving.py`), its FLAC wire
(`runtime_native.BatchLoader.submit_flac`, `flush(raise_on_error=)`,
`take_error_slots`, `flac_native_available`) and `audio/flac_encode.py`,
against direct calls of the port's `make_transcribe_fn` and against the
JAX package's service on test2l in f32.

Held: tokens and texts equal to a direct call's (row 0 of a batch-sized
buffer, as the JAX tests hold theirs) and to the JAX service's on the same
audio; the int16 wire exact on PCM-valued audio; mu-law codes bit-equal to
JAX's and the decode within MULAW_ATOL of JAX's, above the JAX test's 30 dB
SNR; long audio chunked and reassembled; a corrupt FLAC stream failing only
its own request; pipelined equal to fenced; the bucketed dispatch; the
stats. Every service is closed by the `services` fixture's finalizer (and
checked to leave no worker thread), every wait has a timeout."""

import threading

import jax
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu import serving as jax_serving
from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.evaluation.tokenizer import (
    WordTokenizer as JaxWordTokenizer)
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu_torch import runtime_native, serving
from openai_whisper_compression_tpu_torch.audio.flac import parse_stream_info
from openai_whisper_compression_tpu_torch.audio.flac_encode import (encode_flac,
                                                                    encode_waveform)
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.evaluation.harness import (
    make_transcribe_fn, samples_for_arch)
from openai_whisper_compression_tpu_torch.evaluation.longform import chunk_waveform
from openai_whisper_compression_tpu_torch.evaluation.tokenizer import WordTokenizer
from openai_whisper_compression_tpu_torch.models.decode import forced_prefix
from openai_whisper_compression_tpu_torch.models.params import from_numpy
from openai_whisper_compression_tpu_torch.serving import TranscriptionService

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

ARCH, J_ARCH = ARCHS["test2l"], JAX_ARCHS["test2l"]
N = samples_for_arch(ARCH)
CFG = dict(max_new_tokens=6, language_token_id=None, task_token_id=None)
WAIT = 300.0          # every Future.result's timeout, s
# mu-law expansion: torch's f32 pow against XLA's, a few ulps of values <= 1
MULAW_ATOL = 1e-6


@pytest.fixture(scope="module")
def svc_setup():
    """(port tree, JAX tree, port tokenizer, port cfg): the JAX serving
    tests' model (seed 0)."""
    jp = JP.init_params(J_ARCH, jax.random.PRNGKey(0))
    return (from_numpy(jax.tree.map(np.asarray, jp), device=DEV), jp,
            WordTokenizer(ARCH.vocab_size, special_start=897), DecodeConfig(**CFG))


@pytest.fixture
def services(svc_setup):
    """make(**kw) -> a port service (or JAX's with jax=True); every one is
    closed at teardown, and no port worker thread may outlive it."""
    made = []

    def make(jax_side=False, **kw):
        tp, jp, tok, cfg = svc_setup
        if jax_side:
            svc = jax_serving.TranscriptionService(
                jp, J_ARCH, JaxWordTokenizer(J_ARCH.vocab_size, special_start=897),
                JaxDecodeConfig(**CFG), **kw)
        else:
            svc = TranscriptionService(tp, ARCH, tok, cfg, device=DEV, **kw)
        made.append(svc)
        return svc

    yield make
    for svc in made:
        svc.close(timeout=WAIT)
    for svc in made:
        if isinstance(svc, TranscriptionService):
            assert not svc._worker.is_alive()


def _noise(seed, n, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(int(n)) * scale).astype(np.float32)


def _direct_ids(svc_setup, wav, batch=4):
    """The direct reference: `make_transcribe_fn` on a batch-sized buffer
    holding `wav` (trimmed to the window) in row 0."""
    tp, _, _, cfg = svc_setup
    buf = np.zeros((batch, N), np.float32)
    buf[0, : min(len(wav), N)] = wav[:N]
    toks, lens = make_transcribe_fn(ARCH, cfg, device=DEV)(tp, buf)
    ids = toks[0, len(forced_prefix(ARCH, cfg)): int(lens[0])].numpy()
    return ids[ids != ARCH.eos_token_id].tolist()


def test_results_match_direct_and_jax(svc_setup, services):
    _, _, tok, _ = svc_setup
    svc = services(batch_size=4, max_wait_ms=30)
    wavs = [_noise(k, N * f) for k, f in enumerate((0.3, 0.7, 1.0))]
    results = [f.result(timeout=WAIT) for f in [svc.submit(w) for w in wavs]]
    jsvc = services(jax_side=True, batch_size=4, max_wait_ms=30)
    jres = [f.result(timeout=WAIT) for f in [jsvc.submit(w) for w in wavs]]
    svc.close(timeout=WAIT)
    for w, res, jr in zip(wavs, results, jres):
        ids = _direct_ids(svc_setup, w)
        assert res["tokens"] == ids == jr["tokens"]
        assert res["text"] == tok.decode(ids) == jr["text"]
        assert res["latency_s"] >= 0 and res["audio_seconds"] == jr["audio_seconds"]
    stats = svc.stats.snapshot()
    assert set(stats) == set(jsvc.stats.snapshot())
    assert stats["requests"] == 3 and stats["batches"] >= 1
    assert 0 < stats["mean_batch_occupancy"] <= 1
    assert 0 < stats["latency_p50_ms"] <= stats["latency_p95_ms"] <= stats["latency_max_ms"]


def test_concurrent_submitters(services):
    svc = services(batch_size=4, max_wait_ms=20)
    results, wavs = {}, [_noise(100 + i, N // 2) for i in range(6)]

    def client(i):
        results[i] = svc.transcribe(wavs[i], timeout=WAIT)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert len(results) == 6 and all(isinstance(r["text"], str) for r in results.values())
    assert svc.stats.snapshot()["requests"] == 6


def test_submit_after_close_raises(services):
    svc = services(batch_size=2)
    svc.close()
    assert not svc._worker.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        svc.submit(np.zeros(100, np.float32))


def test_transfer_int16_pcm_exact(services):
    """The int16 wire (x 1/32768 on the device): PCM-valued audio gives the
    float32 wire's tokens, and JAX's int16 service's."""
    pcm = np.random.default_rng(4).integers(-2000, 2000, N // 2).astype(np.float32) / 32768.0
    r_f = services(batch_size=2).transcribe(pcm, timeout=WAIT)
    r_i = services(batch_size=2, transfer_int16=True).transcribe(pcm, timeout=WAIT)
    r_j = services(jax_side=True, batch_size=2, transfer_int16=True).transcribe(
        pcm, timeout=WAIT)
    assert r_f["tokens"] == r_i["tokens"] == r_j["tokens"]


def test_mulaw_codec_matches_jax_and_roundtrips():
    """u-law codes bit-equal to JAX's (one host table); the torch expansion
    within MULAW_ATOL of JAX's; above 30 dB SNR on speech-scale noise; +-1
    exact and 0 within half a code step (the JAX test's bounds)."""
    import jax.numpy as jnp

    x = (np.random.default_rng(5).standard_normal(16000) * 0.1).clip(-1, 1).astype(np.float32)
    u = serving.mulaw_encode(x)
    assert u.dtype == np.uint8
    np.testing.assert_array_equal(u, jax_serving.mulaw_encode(x))
    np.testing.assert_array_equal(serving._pcm16(x), jax_serving._pcm16(x))
    codes = np.arange(256, dtype=np.uint8)
    got = serving.mulaw_decode(torch.from_numpy(codes)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jax_serving.mulaw_decode(jnp.asarray(codes))),
                               atol=MULAW_ATOL, rtol=0)
    y = serving.mulaw_decode(torch.from_numpy(u)).numpy()
    assert 10 * np.log10(np.mean(x ** 2) / np.mean((x - y) ** 2)) > 30.0
    ends = serving.mulaw_decode(torch.from_numpy(serving.mulaw_encode(
        np.asarray([0.0, 1.0, -1.0], np.float32)))).numpy()
    np.testing.assert_allclose(ends, [0.0, 1.0, -1.0], atol=1e-4)


def test_transfer_mulaw_end_to_end(services):
    """The mu-law wire serves transcriptions (tokens equal JAX's mu-law
    service's); an unknown codec fails fast."""
    wav = _noise(6, N // 2)
    r = services(batch_size=2, transfer="mulaw").transcribe(wav, timeout=WAIT)
    r_j = services(jax_side=True, batch_size=2, transfer="mulaw").transcribe(wav, timeout=WAIT)
    assert isinstance(r["tokens"], list) and r["audio_seconds"] > 0
    assert r["tokens"] == r_j["tokens"]
    with pytest.raises(ValueError, match="transfer"):
        services(batch_size=2, transfer="opus")


def test_long_audio_transparent_chunking(svc_setup, services):
    """2.4 windows: split, batched, reassembled in order; tokens and text
    equal the direct per-window decodes'."""
    _, _, tok, _ = svc_setup
    svc = services(batch_size=4, max_wait_ms=20)
    wav = _noise(4, 2.4 * N)
    res = svc.submit(wav).result(timeout=WAIT)
    assert res["num_chunks"] == 3
    assert res["audio_seconds"] == pytest.approx(len(wav) / 16000.0)
    all_ids, texts = [], []
    for c in chunk_waveform(wav, N):
        ids = _direct_ids(svc_setup, c)
        all_ids += ids
        if tok.decode(ids):
            texts.append(tok.decode(ids))
    assert res["tokens"] == all_ids and res["text"] == " ".join(texts)


def test_long_audio_interleaves_with_short_requests(services):
    svc = services(batch_size=4, max_wait_ms=20)
    long_fut = svc.submit(_noise(9, 3.2 * N))
    short_futs = [svc.submit(_noise(20 + k, N // 2)) for k in range(3)]
    long_res = long_fut.result(timeout=WAIT)
    short_res = [f.result(timeout=WAIT) for f in short_futs]
    assert long_res["num_chunks"] == 4
    assert all("num_chunks" not in r and isinstance(r["text"], str) for r in short_res)
    assert svc.stats.snapshot()["requests"] == 7


def test_cancelled_future_does_not_kill_worker(services):
    svc = services(batch_size=2, max_wait_ms=10)
    wav = _noise(3, N // 2)
    f1 = svc.submit(wav)
    f1.cancel()                       # may or may not win the race
    assert svc.submit(wav).result(timeout=WAIT)["tokens"] is not None
    assert svc._worker.is_alive()


def test_chunked_request_stats_user_facing(services):
    """A chunked submit counts as ONE user request with its aggregate
    latency; its windows count in `requests`."""
    svc = services(batch_size=2, max_wait_ms=10)
    res = svc.submit(_noise(4, 2.5 * N)).result(timeout=WAIT)
    assert res["num_chunks"] == 3
    stats = svc.stats.snapshot()
    assert stats["requests"] == 3 and stats["user_requests"] == 1
    assert stats["latency_p50_ms"] == pytest.approx(res["latency_s"] * 1e3, rel=0.25)


def test_transcribe_auto_timeout_scales(services):
    """timeout=None waits max(120 s, 4x the audio's duration)."""
    svc = services(batch_size=2, max_wait_ms=10)
    seen = []
    real_submit = svc.submit

    def submit(wav, sample_rate=16000):
        fut = real_submit(wav, sample_rate)
        real_result = fut.result

        def result(timeout=None):
            seen.append(timeout)
            return real_result(timeout=timeout)
        fut.result = result
        return fut

    svc.submit = submit
    assert svc.transcribe(_noise(5, N // 2))["audio_seconds"] > 0
    svc.transcribe(np.zeros(16000 * 40, np.float32))
    assert seen == [120.0, 160.0]


def test_flac_encode_bytes_equal_jax():
    """`flac_encode` is a copy: its streams are byte-equal to JAX's (mono
    and stereo PCM, a float waveform, a tail padded to whole blocks), and
    the port's decoder reads them back exactly."""
    from openai_whisper_compression_tpu.audio import flac_encode as jax_fe

    rng = np.random.default_rng(13)
    mono = rng.integers(-20000, 20000, 4096, dtype=np.int64)
    stereo = rng.integers(-3000, 3000, (2048, 2), dtype=np.int64)
    quiet = (np.sin(np.arange(3072) / 7.0) * 900).astype(np.int64)
    for pcm in (mono, stereo, quiet):
        data = encode_flac(pcm)
        assert data == jax_fe.encode_flac(pcm)
        samples, sr, bits = runtime_native.flac_decode(data)
        np.testing.assert_array_equal(samples.reshape(pcm.shape[0], -1),
                                      pcm.reshape(pcm.shape[0], -1))
    wav = _noise(14, 5000, 0.3)
    assert encode_waveform(wav) == jax_fe.encode_waveform(wav)


@pytest.fixture(scope="module")
def native_library():
    """A finished native library before either package's loader is asked
    (as in tests/test_torch_storage.py: the reference's in-place `make` can
    race a loader in another process, which then remembers the failure)."""
    import time

    from openai_whisper_compression_tpu import runtime_native as jax_rn

    built = runtime_native.build()
    for _ in range(120):
        jax_rn._lib.cache_clear()
        if not built or jax_rn._lib() is not None:
            break
        time.sleep(0.5)


def test_loader_flac_wire_matches_jax(native_library):
    """`BatchLoader.submit_flac` + `flush(raise_on_error=False)` +
    `take_error_slots`: rows equal to the JAX package's loader, a corrupt
    stream's slot flagged and zeroed, `flush()` raising on it by default;
    `flac_native_available` as JAX's."""
    from openai_whisper_compression_tpu import runtime_native as jax_rn

    assert runtime_native.flac_native_available() == jax_rn.flac_native_available()
    pcm = np.random.default_rng(11).integers(-20000, 20000, 4096, dtype=np.int64)
    good = encode_flac(pcm)
    _, off = parse_stream_info(good)
    corrupt = good[: off + 2]
    n = 8192
    rows = []
    for rn in (runtime_native, jax_rn):
        loader = rn.BatchLoader(3, n)
        for slot in range(3):
            loader.clear(slot)
        loader.submit_flac(0, good)
        loader.submit(2, pcm.astype(np.float32) / 32768.0)
        if rn.flac_native_available():
            loader.submit_flac(1, corrupt)
            rows.append((loader.flush(raise_on_error=False), loader.take_error_slots()))
            assert loader.take_error_slots() == []
            loader.submit_flac(1, corrupt)
            with pytest.raises(RuntimeError, match="FLAC"):
                loader.flush()
        else:
            with pytest.raises(Exception):
                loader.submit_flac(1, corrupt)
            rows.append((loader.flush(raise_on_error=False), [1]))
    (got, got_err), (ref, ref_err) = rows
    np.testing.assert_array_equal(got, ref)
    assert got_err == ref_err == [1]
    assert not got[1].any()
    np.testing.assert_array_equal(got[0], got[2])


def test_submit_flac_matches_submit(services):
    """FLAC-wire requests (decoded in the loader pool) give the tokens and
    text of the pre-decoded waveform; junk raises ValueError at once."""
    svc = services(batch_size=2, max_wait_ms=30)
    pcm = np.random.default_rng(7).integers(-20000, 20000, 4096, dtype=np.int64)
    r_wav = svc.submit(pcm.astype(np.float32) / 32768.0).result(timeout=WAIT)
    r_flac = svc.submit_flac(encode_flac(pcm)).result(timeout=WAIT)
    assert r_flac["tokens"] == r_wav["tokens"] and r_flac["text"] == r_wav["text"]
    assert r_flac["audio_seconds"] == pytest.approx(4096 / 16000.0)
    with pytest.raises(ValueError):
        svc.submit_flac(b"junk that is not flac")


def test_corrupt_flac_fails_only_its_own_request(services):
    """A truncated frame section fails only its own future; its co-riders
    complete with the right tokens; truncated metadata raises ValueError at
    once; the service keeps serving."""
    svc = services(batch_size=4, max_wait_ms=200)
    pcm = np.random.default_rng(11).integers(-20000, 20000, 4096, dtype=np.int64)
    wav = pcm.astype(np.float32) / 32768.0
    good = encode_flac(pcm)
    _, off = parse_stream_info(good)
    f_wav, f_bad, f_good = (svc.submit(wav), svc.submit_flac(good[: off + 2]),
                            svc.submit_flac(good))
    r_wav, r_good = f_wav.result(timeout=WAIT), f_good.result(timeout=WAIT)
    with pytest.raises(Exception):
        f_bad.result(timeout=WAIT)
    assert r_good["tokens"] == r_wav["tokens"] and r_good["text"] == r_wav["text"]
    with pytest.raises(ValueError):
        svc.submit_flac(good[:10])
    assert svc.transcribe(wav, timeout=WAIT)["tokens"] == r_wav["tokens"]


def test_submit_flac_long_audio_chunks(services):
    """FLAC longer than one window decodes up front and rides the chunked
    path: tokens equal the float submit's."""
    n = ((2 * N + 1023) // 1024) * 1024
    pcm = np.random.default_rng(8).integers(-20000, 20000, n, dtype=np.int64)
    svc = services(batch_size=2, max_wait_ms=30)
    res = svc.submit_flac(encode_flac(pcm)).result(timeout=WAIT)
    assert res["num_chunks"] >= 2
    direct = svc.submit(pcm.astype(np.float32) / 32768.0).result(timeout=WAIT)
    assert res["tokens"] == direct["tokens"]


def test_pipelined_matches_fenced(services):
    """pipeline=2 gives pipeline=1's results over a 5-batch burst; merged
    busy seconds never exceed the wall."""
    import time

    wavs = [_noise(200 + k, N // 2) for k in range(10)]
    results = {}
    for depth in (1, 2):
        svc = services(batch_size=2, max_wait_ms=10, pipeline=depth)
        t0 = time.perf_counter()
        results[depth] = [f.result(timeout=WAIT)["tokens"]
                          for f in [svc.submit(w) for w in wavs]]
        wall = time.perf_counter() - t0
        svc.close(timeout=WAIT)
        stats = svc.stats.snapshot()
        assert stats["requests"] == 10 and stats["batches"] == 5
        assert 0 < stats["busy_seconds"] <= wall + 0.5
    assert results[1] == results[2]


def test_close_drains_inflight_batches(services):
    """close() right after a burst retires every pipelined batch."""
    svc = services(batch_size=2, max_wait_ms=5, pipeline=2)
    futs = [svc.submit(_noise(300 + k, N // 2)) for k in range(6)]
    svc.close(timeout=WAIT)
    assert not svc._worker.is_alive()
    for f in futs:
        assert f.result(timeout=1)["tokens"] is not None


def test_bucketed_dispatch_partial_batches(services):
    """Buckets (2, 4, 8) at batch 8; warmup runs each; a lone request rides
    the 2-row bucket and equals a batch-2 service's result."""
    svc = services(batch_size=8, max_wait_ms=5)
    assert svc.buckets == (2, 4, 8)
    seen = []
    real = svc._fn

    def fn(params, wire):
        seen.append(wire.shape[0])
        return real(params, wire)

    svc._fn = fn
    svc.warmup()
    assert seen == [2, 4, 8]
    wav = _noise(3, 8000)
    ref = svc.transcribe(wav, timeout=WAIT)
    assert seen[-1] == 2
    got = services(batch_size=2, max_wait_ms=5).transcribe(wav, timeout=WAIT)
    assert ref["text"] == got["text"] and ref["tokens"] == got["tokens"]
