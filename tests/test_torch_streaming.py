"""The port's `streaming.py` against the JAX package's on test2l with
timestamp tokens (<|notimestamps|> at 900), f32: `StreamingTranscriber`
(LocalAgreement-n commitment, min_step, slides and buffer trimming, the
energy VAD, `<|startofprev|>` conditioning, the self-draft of the verified
decode, `feed` and `flush`) and `StreamingPool` (`open`, `feed`, `tick`,
`close`, `stats`, `reset_stats`, the device window mirror, row reuse).

Every `feed` / `tick` / `flush` output (committed, pending, segments with
their times, buffered seconds) equals the jitted JAX package's at each step
of the same feeds: the times are sums of the same Python floats, so they
are held exactly too. The pool's mirror is held bit for bit against each
session's host window after every `_sync_mirrors`. The CLI's `--stream`
waits for the port of `cli.py`."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu import streaming as jax_streaming
from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.evaluation.tokenizer import (
    WordTokenizer as JaxWordTokenizer)
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu_torch import streaming
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.evaluation.harness import samples_for_arch
from openai_whisper_compression_tpu_torch.evaluation.tokenizer import WordTokenizer
from openai_whisper_compression_tpu_torch.models.params import from_numpy
from openai_whisper_compression_tpu_torch.streaming import (StreamingPool,
                                                            StreamingTranscriber, _lcp)

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

J_ARCH = JAX_ARCHS["test2l"].replace(no_timestamps_token_id=900)
ARCH = ARCHS["test2l"].replace(no_timestamps_token_id=900)
N = samples_for_arch(ARCH)
CFG = dict(max_new_tokens=8, language_token_id=None, task_token_id=None,
           notimestamps=False, max_initial_timestamp_index=20)


@pytest.fixture(scope="module")
def setup():
    """(JAX tree, torch tree, port tokenizer, JAX tokenizer, port cfg, JAX
    cfg): the JAX streaming tests' model (seed 7)."""
    jp = JP.init_params(J_ARCH, jax.random.PRNGKey(7))
    tp = from_numpy(jax.tree.map(np.asarray, jp), device=DEV)
    return (jp, tp, WordTokenizer(ARCH.vocab_size, special_start=897),
            JaxWordTokenizer(J_ARCH.vocab_size, special_start=897),
            DecodeConfig(**CFG), JaxDecodeConfig(**CFG))


def _pair(setup, **kw):
    """A port and a JAX transcriber over the same model and options."""
    jp, tp, tok, jtok, cfg, jcfg = setup
    return (StreamingTranscriber(tp, ARCH, tok, cfg, device=DEV, **kw),
            jax_streaming.StreamingTranscriber(jp, J_ARCH, jtok, jcfg, **kw))


def _noise(seed, n, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(int(n)) * scale).astype(np.float32)


def _drive(st, jst, wav, chunk):
    """Feed both transcribers the same chunks, holding each output equal;
    then flush both. Returns the port's outputs, the flush's last."""
    outs = []
    for i in range(0, len(wav), chunk):
        got, ref = st.feed(wav[i: i + chunk]), jst.feed(wav[i: i + chunk])
        assert got == ref, (i, got, ref)
        outs.append(got)
    got, ref = st.flush(), jst.flush()
    assert got == ref
    return outs + [got]


def _checked_mirror(pool):
    """Wrap the pool's `_sync_mirrors` so that after every call each synced
    row of the device mirror equals its session's host window bit for bit,
    zero past it. Returns the list of rows checked a call."""
    seen = []
    real = pool._sync_mirrors

    def sync(rows):
        real(rows)
        mirror = pool._mirror.cpu().numpy()
        for sid, r in rows:
            win = pool.sessions[sid]._window()
            assert np.array_equal(mirror[r, : len(win)], win), (sid, r)
            assert not mirror[r, len(win):].any(), (sid, r)
            assert pool._mlen[r] == len(win)
        seen.append(len(rows))

    pool._sync_mirrors = sync
    return seen


def test_lcp_matches_jax():
    for seqs in ([(1, 2, 3), (1, 2, 4)], [(1, 2), (1, 2)], [(), (1,)], [], [(5, 6, 7)],
                 [(1, 2, 3), (1, 2, 3, 4), (1, 2)]):
        assert _lcp(seqs) == jax_streaming._lcp(seqs)
    assert _lcp([(1, 2, 3), (1, 2, 4)]) == 2 and _lcp([]) == 0


def test_validation(setup):
    _, tp, tok, _, cfg, _ = setup
    with pytest.raises(ValueError, match="agreement"):
        StreamingTranscriber(tp, ARCH, tok, cfg, agreement=0, device=DEV)
    with pytest.raises(ValueError, match="timestamp"):
        StreamingTranscriber(tp, ARCH, tok, DecodeConfig(notimestamps=True), device=DEV)
    with pytest.raises(ValueError, match="max_streams"):
        StreamingPool(tp, ARCH, tok, cfg, max_streams=0, device=DEV)


def test_feed_monotonic_commit_and_flush(setup):
    """2.4 windows in quarter-window feeds: every output equal to JAX's,
    committed text only grows, the window slid, flush empties pending,
    finalized segments in order, the stream fully consumed."""
    st, jst = _pair(setup, agreement=2, min_step_s=0.5)
    outs = _drive(st, jst, _noise(0, 2.4 * N), N // 4)
    assert all(set(o) == {"committed", "pending", "segments", "buffered_s"} for o in outs)
    for a, b in zip(outs, outs[1:]):
        assert b["committed"].startswith(a["committed"])
    assert outs[-1]["pending"] == ""
    starts = [s["start"] for s in outs[-1]["segments"]]
    assert starts == sorted(starts)
    assert st._window_start == st._total and st._window_start == jst._window_start


@pytest.mark.parametrize("agreement", [1, 2, 3])
def test_agreement_levels_match_jax(setup, agreement):
    """agreement 1 commits every decode at once (nothing pending); 2 and 3
    hold text back until that many hypotheses agree."""
    st, jst = _pair(setup, agreement=agreement, min_step_s=0.25)
    outs = _drive(st, jst, _noise(1, 0.75 * N), N // 4)
    if agreement == 1:
        assert all(o["pending"] == "" for o in outs)


def test_min_step_gates_decoding(setup):
    """Feeds below min_step_s don't decode; enough audio does."""
    st, jst = _pair(setup, min_step_s=5.0)
    for x in (np.zeros(16000, np.float32), np.zeros(5 * 16000, np.float32)):
        assert st.feed(x) == jst.feed(x)
        assert st._decoded_until == jst._decoded_until
    assert st._decoded_until == st._total


def test_flush_equals_offline_tail(setup):
    """flush() on a sub-window stream decodes once and commits everything,
    with and without conditioning; two runs agree with each other and JAX."""
    wav = _noise(2, N // 3)
    for cond in (False, True):
        a, ja = _pair(setup, condition_on_previous_text=cond)
        b, _ = _pair(setup, condition_on_previous_text=cond)
        ra = _drive(a, ja, wav, len(wav))[-1]
        b.feed(wav)
        assert b.flush() == ra and ra["pending"] == ""


def test_divergent_redecode_never_retracts(setup):
    """Commitment is stored as tokens: a disagreeing hypothesis cannot
    rewrite committed text (white-box, the JAX test's states)."""
    _, tp, tok, _, cfg, _ = setup
    st = StreamingTranscriber(tp, ARCH, tok, cfg, agreement=2, device=DEV)
    st._exposed_ids = [1, 2, 3, 4, 5]
    st._win_segments = [{"start": 0.0, "end": 0.5, "tokens": [1, 2]},
                        {"start": 0.5, "end": None, "tokens": [9, 9]}]
    out = st._texts()
    assert out["committed"] == tok.decode([1, 2, 3, 4, 5])
    assert out["pending"] == tok.decode([9, 9])
    st._total = st.n_samples + 1
    st._buf = np.zeros(st._total, np.float32)
    st._slide()
    assert st._final_ids == [1, 2] and st._exposed_ids == [3, 4, 5]
    assert st._texts()["committed"] == tok.decode([1, 2, 3, 4, 5])
    st2 = StreamingTranscriber(tp, ARCH, tok, cfg, agreement=2, device=DEV)
    st2._exposed_ids = [1, 2]
    st2._hyps.extend([(1, 2, 7, 8), (1, 2, 7, 9)])
    st2._win_segments = [{"start": 0.0, "end": None, "tokens": [1, 2, 7, 9]}]
    assert _lcp(list(st2._hyps)) == 3 and st2._common() == 2


def test_buffer_trimmed_on_slide(setup):
    """Audio before the live window is dropped: the buffer stays within a
    window and a half over 3 windows of half-window feeds (outputs = JAX's)."""
    st, jst = _pair(setup, min_step_s=0.5)
    for k in range(6):
        x = _noise(50 + k, N // 2)
        assert st.feed(x) == jst.feed(x)
        assert (st._base, len(st._buf)) == (jst._base, len(jst._buf))
    assert st._window_start > 0 and st._base == st._window_start
    assert len(st._buf) == st._total - st._base <= N + N // 2


def test_vad_skips_silent_windows(setup, monkeypatch):
    """vad_threshold: a silence stream never decodes (multi-window
    fast-forward and flush included); a loud one decodes as JAX's does."""
    st, jst = _pair(setup, min_step_s=0.25, vad_threshold=1e-3)
    calls = {"n": 0}
    real = st._decode_window

    def counted():
        calls["n"] += 1
        real()
    monkeypatch.setattr(st, "_decode_window", counted)
    for _ in range(5):
        x = np.zeros(N // 2, np.float32)
        assert st.feed(x) == jst.feed(x)
    out = st.flush()
    assert out == jst.flush() and calls["n"] == 0
    assert out["committed"] == "" and out["segments"] == []
    assert st._window_start == st._total
    st2, jst2 = _pair(setup, min_step_s=0.25, vad_threshold=1e-3)
    x = _noise(6, N // 2)
    assert st2.feed(x) == jst2.feed(x)
    assert st2._decoded_until == st2._total


def test_streaming_with_quantized_model(setup):
    """int8 weights (the port's quantizer against JAX's) and an int8 cache:
    every output equal to JAX's over 1.2 windows."""
    from openai_whisper_compression_tpu.quant.api import quantize_params as jax_quantize

    jp, _, tok, jtok, cfg, jcfg = setup
    jq = jax_quantize(jp, "int8")
    tq = from_numpy(jax.tree.map(np.asarray, jq), device=DEV)
    qcfg, jqcfg = (dataclasses.replace(c, kv_int8=True) for c in (cfg, jcfg))
    st = StreamingTranscriber(tq, ARCH, tok, qcfg, min_step_s=0.5, device=DEV)
    jst = jax_streaming.StreamingTranscriber(jq, J_ARCH, jtok, jqcfg, min_step_s=0.5)
    out = _drive(st, jst, _noise(10, 1.2 * N), N // 2)[-1]
    assert out["pending"] == "" and isinstance(out["committed"], str)


def test_beam_config_matches_jax(setup):
    """A beam configuration runs `beam_decode` in the step (no draft):
    outputs equal to JAX's over 1.3 windows."""
    jp, tp, tok, jtok, cfg, jcfg = setup
    bcfg, jbcfg = (dataclasses.replace(c, beam_size=2) for c in (cfg, jcfg))
    st = StreamingTranscriber(tp, ARCH, tok, bcfg, min_step_s=0.5, device=DEV)
    jst = jax_streaming.StreamingTranscriber(jp, J_ARCH, jtok, jbcfg, min_step_s=0.5)
    _drive(st, jst, _noise(12, 1.3 * N), N // 2)


def test_min_step_zero_terminates(setup):
    """min_step_s=0 is clamped to one sample: feed() terminates."""
    st, jst = _pair(setup, min_step_s=0.0)
    assert st.min_step == 1
    for k in range(2):
        x = _noise(11 + k, 4000)
        assert st.feed(x) == jst.feed(x)


def test_divergent_fallback_does_not_duplicate(setup):
    """Window-full fallback with a hypothesis diverging inside the committed
    prefix finalizes the committed tokens only."""
    _, tp, tok, _, cfg, _ = setup
    st = StreamingTranscriber(tp, ARCH, tok, cfg, device=DEV)
    st._exposed_ids = [1, 2, 3]
    st._win_segments = [{"start": 0.0, "end": None, "tokens": [1, 9]}]
    st._hyps.append((1, 9))
    st._total = st.n_samples + 1
    st._buf = np.zeros(st._total, np.float32)
    st._slide()
    assert st._final_ids == [1, 2, 3] and st._exposed_ids == []


def test_vad_never_discards_decoded_speech(setup):
    """A silent full window with a decoded hypothesis still slides and
    finalizes it: the VAD fast-forward skips undecoded windows only."""
    _, tp, tok, _, cfg, _ = setup
    st = StreamingTranscriber(tp, ARCH, tok, cfg, vad_threshold=1e-3, device=DEV)
    st._exposed_ids = [5, 6]
    st._win_segments = [{"start": 0.0, "end": 0.4, "tokens": [5, 6]}]
    st._hyps.append((5, 6))
    st._total = st.n_samples + 1600
    st._buf = np.zeros(st._total, np.float32)
    st._pump()
    assert st._final_ids == [5, 6]
    assert st.flush()["committed"] == tok.decode([5, 6])


def test_self_draft_mechanics(setup):
    """The self-draft: set after every decode (the raw generated tokens, a
    timestamp first), re-anchored across a slide, equal to JAX's at each
    step; clearing it before every decode changes no output."""
    st, jst = _pair(setup, agreement=1, min_step_s=0.5)
    wav = _noise(3, 1.5 * N)
    assert st.feed(wav[: N // 2]) == jst.feed(wav[: N // 2])
    assert st._draft is not None and st._draft[0] >= ARCH.no_timestamps_token_id + 1
    np.testing.assert_array_equal(st._draft, jst._draft)
    assert st.feed(wav[N // 2:]) == jst.feed(wav[N // 2:])
    assert st._window_start > 0
    assert (st._draft is None) == (jst._draft is None)
    if st._draft is not None:
        np.testing.assert_array_equal(st._draft, jst._draft)
        assert all(int(t) < ARCH.vocab_size for t in st._draft)
    a, _ = _pair(setup, agreement=1, min_step_s=0.5)
    b, _ = _pair(setup, agreement=1, min_step_s=0.5)
    orig = a._decode_window

    def no_draft():
        a._draft = None
        orig()

    a._decode_window = no_draft
    for i in range(0, len(wav), N // 4):
        assert a.feed(wav[i: i + N // 4]) == b.feed(wav[i: i + N // 4])
    assert a.flush() == b.flush()


def _pool_pair(setup, max_streams, **kw):
    jp, tp, tok, jtok, cfg, jcfg = setup
    pool = StreamingPool(tp, ARCH, tok, cfg, max_streams=max_streams, device=DEV, **kw)
    return pool, jax_streaming.StreamingPool(jp, J_ARCH, jtok, jcfg,
                                             max_streams=max_streams, **kw)


def test_streaming_pool_matches_standalone(setup):
    """Three sessions through a 4-row pool: each tick's partials equal a
    standalone transcriber fed identically and JAX's pool; finals too; the
    mirror equals every host window before each batched call."""
    _, tp, tok, _, cfg, _ = setup
    streams = {sid: _noise(8 + k, 1.5 * N) for k, sid in enumerate("abc")}
    pool, jpool = _pool_pair(setup, 4, min_step_s=0.5)
    checked = _checked_mirror(pool)
    solo = {sid: StreamingTranscriber(tp, ARCH, tok, cfg, min_step_s=0.5, device=DEV)
            for sid in streams}
    for sid in streams:
        pool.open(sid)
        jpool.open(sid)
    chunk = N // 3
    for i in range(0, int(1.5 * N), chunk):
        for sid, wav in streams.items():
            assert pool.feed(sid, wav[i: i + chunk]) == jpool.feed(sid, wav[i: i + chunk])
        ticked = pool.tick()
        assert ticked == jpool.tick()
        for sid, wav in streams.items():
            ref = solo[sid].feed(wav[i: i + chunk])
            assert ticked[sid] == ref, sid
    for sid in streams:
        final = pool.close(sid)
        assert final == jpool.close(sid) == solo[sid].flush()
    assert not pool.sessions and checked and max(checked) == 3


def test_streaming_pool_limits(setup):
    _, tp, tok, _, cfg, _ = setup
    pool = StreamingPool(tp, ARCH, tok, cfg, max_streams=1, device=DEV)
    pool.open("x")
    with pytest.raises(KeyError, match="already open"):
        pool.open("x")
    with pytest.raises(RuntimeError, match="full"):
        pool.open("y")
    pool.close("x")
    pool.open("y")                      # row freed


def test_pool_churn_at_scale(setup):
    """A 16-row pool with four sessions closed and reopened every round:
    every closed session returns its finals (equal to JAX's), the survivor
    equals a standalone transcriber and JAX's pool, reused rows hold their
    new session's audio and zeros (the mirror check), stats consistent."""
    _, tp, tok, _, cfg, _ = setup
    g = np.random.default_rng(10)
    B = 16
    pool, jpool = _pool_pair(setup, B, min_step_s=0.5)
    checked = _checked_mirror(pool)
    keeper = (g.standard_normal(int(1.5 * N)) * 0.1).astype(np.float32)
    solo = StreamingTranscriber(tp, ARCH, tok, cfg, min_step_s=0.5, device=DEV)
    for p in (pool, jpool):
        p.open("keeper")
        for i in range(B - 1):
            p.open(i)
    next_id, finals = B - 1, []
    chunk = N // 3
    for step, i in enumerate(range(0, int(1.5 * N), chunk)):
        if step > 0:
            for _ in range(4):
                victim = next(s for s in pool.sessions if s != "keeper")
                got = pool.close(victim)
                assert got == jpool.close(victim)
                finals.append(got)
                pool.open(next_id)
                jpool.open(next_id)
                next_id += 1
        for sid in list(pool.sessions):
            x = keeper[i: i + chunk] if sid == "keeper" else \
                (g.standard_normal(chunk) * 0.1).astype(np.float32)
            assert pool.feed(sid, x) == jpool.feed(sid, x)
        ticked = pool.tick()
        assert ticked == jpool.tick()
        assert ticked["keeper"] == solo.feed(keeper[i: i + chunk])
    assert len(finals) >= 8 and all("committed" in f for f in finals)
    assert len(pool.sessions) == B and max(checked) > 4
    assert pool.close("keeper") == solo.flush()
    st = pool.stats()
    assert st["decodes"] > 0 and 0 < st["mean_batch_occupancy"] <= 1


def test_pool_stats(setup):
    """The counters equal JAX's (ticks, batched calls, decodes, occupancy,
    audio seconds, drafts); busy seconds and rtfx positive; reset_stats
    zeroes them and keeps the sessions."""
    pool, jpool = _pool_pair(setup, 4, min_step_s=0.25)
    for p in (pool, jpool):
        p.open("a")
        p.open("b")
    for sid, seed in (("a", 9), ("b", 19)):
        x = _noise(seed, N // 2)
        pool.feed(sid, x)
        jpool.feed(sid, x)
    assert pool.tick() == jpool.tick()
    s, js = pool.stats(), jpool.stats()
    for k in ("open_streams", "ticks", "batched_calls", "decodes", "mean_batch_occupancy",
              "audio_seconds", "draft_proposed", "draft_accepted"):
        assert s[k] == js[k], k
    assert set(s) == set(js)
    assert s["ticks"] == 1 and s["decodes"] >= 2 and s["busy_seconds"] > 0 and s["rtfx"] > 0
    assert s["audio_seconds"] == pytest.approx(2 * (N // 2) / 16000.0)
    pool.reset_stats()
    s2 = pool.stats()
    assert s2["ticks"] == 0 and s2["busy_seconds"] == 0.0 and s2["open_streams"] == 2


def test_pool_draft_acceptance_stats(setup):
    """A re-decode carries the previous tick's draft: proposed > 0 and the
    accepted count equal to JAX's."""
    pool, jpool = _pool_pair(setup, 2, agreement=2, min_step_s=0.25)
    wav = _noise(5, N // 2)
    for p in (pool, jpool):
        p.open("a")
        p.feed("a", wav[: N // 4])
        p.tick()
        p.feed("a", wav[N // 4:])
        p.tick()
    s, js = pool.stats(), jpool.stats()
    assert s["draft_proposed"] == js["draft_proposed"] > 0
    assert s["draft_accepted"] == js["draft_accepted"]
    assert 0 <= s["draft_accepted"] <= s["draft_proposed"]
    assert pool.close("a") == jpool.close("a")


def test_pool_row_reuse_zero_flush(setup):
    """A session opened on a previously used row sees its own audio and
    zeros past it (the loud previous owner flushed): its partials equal a
    standalone transcriber's, and the mirror check holds."""
    _, tp, tok, _, cfg, _ = setup
    g = np.random.default_rng(11)
    pool = StreamingPool(tp, ARCH, tok, cfg, max_streams=1, min_step_s=0.25, device=DEV)
    checked = _checked_mirror(pool)
    pool.open("a")
    pool.feed("a", (g.standard_normal(N) * 0.5).astype(np.float32))
    pool.tick()
    pool.close("a")
    assert pool._mirror.abs().sum() > 0        # the loud row is still resident
    short = (g.standard_normal(N // 4) * 0.1).astype(np.float32)
    ref = StreamingTranscriber(tp, ARCH, tok, cfg, min_step_s=0.25, device=DEV).feed(short)
    pool.open("b")                             # the same pinned row
    pool.feed("b", short)
    assert pool.tick()["b"] == ref and len(checked) >= 2
    assert not pool._mirror[0, N // 4:].any()


def test_advance_matches_the_jax_mirror_update(setup):
    """`_advance` (in place, per row: shift out, zero-fill, append) equals
    the JAX pool's jitted `_advance` on the same rows, shifts and chunks
    (test2l's 20480-sample window, 2 s appends clamped to it)."""
    import jax.numpy as jnp

    _, jpool = _pool_pair(setup, 4)
    A = jpool._append_w
    rng = np.random.default_rng(4)
    buf = rng.standard_normal((4, N)).astype(np.float32)
    shifts = np.array([0, 5, N, 4000])
    offs = np.array([10, 0, 0, N - 300])
    nvalid = np.array([6, A, 3, 300])
    chunk = rng.standard_normal((4, A)).astype(np.float32)
    got = torch.from_numpy(buf.copy())
    streaming._advance(got, shifts, chunk, offs, nvalid)
    want = jpool._advance(jnp.asarray(buf), jnp.asarray(shifts, jnp.int32), jnp.asarray(chunk),
                          jnp.asarray(offs, jnp.int32), jnp.asarray(nvalid, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
