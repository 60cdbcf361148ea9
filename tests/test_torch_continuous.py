"""The port's continuous batching (`models/continuous.py`, `continuous.py`)
against the JAX package's on a test2l-shaped model in f32.

The contract: every request's token sequence equals the standalone
`greedy_decode` output for that utterance, whichever requests shared the
slot pool, wherever in the global window its slot ran, however many
rebases happened. Each case holds the port's tokens equal to the port's
standalone greedy (batch 1, `make_transcribe_fn`) and to the jitted JAX
`ContinuousBatcher` on the same requests, and the `CBStats` counters
(admits, rebases, device steps, chunks, slot steps, generated tokens)
equal to JAX's: the port's chunk stops where JAX's while loop stops.

Ragged lengths come from the JAX test's fixture: the EOT output-embedding
row crafted on the JAX side inside the span of the other rows (its first
principal component), carried over through `from_numpy`, so greedy ends at
different steps per utterance. A floating pool under transfer="int16"
raises in the port (the JAX admit scales it into near-silence); no test
pins the JAX behaviour."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.audio import features as jax_features
from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.continuous import CBStats as JaxCBStats
from openai_whisper_compression_tpu.continuous import (
    ContinuousBatcher as JaxContinuousBatcher)
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.models import whisper as jax_whisper
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.continuous import CBStats, ContinuousBatcher
from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
from openai_whisper_compression_tpu_torch.models import continuous as cbm
from openai_whisper_compression_tpu_torch.models.params import from_numpy

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

CB = dict(name="test2l-cb", vocab_size=24, bos_token_id=21, eos_token_id=21,
          decoder_start_token_id=22, no_timestamps_token_id=23)
J_ARCH = JAX_ARCHS["test2l"].replace(**CB)
ARCH = ARCHS["test2l"].replace(**CB)
N_SAMPLES = ARCH.max_source_positions * 2 * 160
STAT_KEYS = ("requests", "admits", "admit_passes", "rebases", "chunks", "device_steps",
             "slot_steps_busy", "slot_steps_total", "gen_tokens")


def _wavs(n, seed=0):
    """The JAX test's utterances: random sine pairs + noise, ragged lengths."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ln = int(rng.integers(4000, N_SAMPLES))
        t = np.arange(ln) / 16000.0
        f1, f2 = rng.uniform(100, 4000, 2)
        out.append((np.sin(2 * np.pi * f1 * t) + np.sin(2 * np.pi * f2 * t)
                    + 0.3 * rng.standard_normal(ln)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def model():
    """(JAX tree, torch tree): the JAX test's model with its crafted EOT row."""
    params = JP.init_params(J_ARCH, jax.random.PRNGKey(3))
    wavs = _wavs(12, seed=99)
    padded = np.zeros((len(wavs), N_SAMPLES), np.float32)
    for i, w in enumerate(wavs):
        padded[i, : len(w)] = w
    mel = jax_features.preprocess(jnp.asarray(padded), n_mels=J_ARCH.num_mel_bins,
                                  length=N_SAMPLES)
    logits = np.asarray(jax_whisper.forward(
        params, J_ARCH, mel.astype(jnp.float32),
        jnp.asarray([[22, 23]] * len(wavs))))[:, -1]
    text = list(range(21))
    A = logits[:, text]
    Z = A - A.mean(axis=0, keepdims=True)
    c = np.linalg.svd(Z, full_matrices=False)[2][0]
    m = A.mean(axis=0)
    c = c - ((A @ c).mean() / (A @ m).mean()) * m
    gamma = 3.0 / max(float((A @ c).std()), 1e-9)
    dom = int(np.bincount(logits.argmax(axis=1)).argmax())
    emb = np.array(params["decoder"]["embed"])
    emb[21] = (emb[dom] + gamma * (c[:, None] * emb[text]).sum(axis=0)).astype(emb.dtype)
    params["decoder"]["embed"] = jnp.asarray(emb)
    return params, from_numpy(jax.tree.map(np.asarray, params), device=DEV)


def _standalone(tp, cfg, wavs):
    """The port's per-utterance greedy reference (batch 1)."""
    fn = make_transcribe_fn(ARCH, cfg, fast_mel=True, device=DEV)
    out = []
    for w in wavs:
        padded = np.zeros((1, N_SAMPLES), np.float32)
        padded[0, : len(w)] = w
        tokens, lengths = fn(tp, padded)[:2]
        out.append(tokens[0, : int(lengths[0])].numpy())
    return out


def _jax_cfg(cfg):
    return JaxDecodeConfig(**dataclasses.asdict(cfg))


def _pair(model, cfg, **kw):
    """The JAX and the port's batchers over one model and configuration."""
    jp, tp = model
    return (JaxContinuousBatcher(jp, J_ARCH, _jax_cfg(cfg), **kw),
            ContinuousBatcher(tp, ARCH, cfg, device=DEV, **kw))


def _run_both(jcb, cb, wavs, **kw):
    """Run both batchers over the same requests: (port tokens, JAX tokens,
    port stats, JAX stats)."""
    js, ts = JaxCBStats(), CBStats()
    ref = jcb.transcribe_all(wavs, stats=js, **kw)
    got = cb.transcribe_all(wavs, stats=ts, **kw)
    return got, ref, ts, js


def _assert_equal(got, *refs):
    for ref in refs:
        assert len(got) == len(ref)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert np.array_equal(np.asarray(g), np.asarray(r)), (
                f"request {i}: port={np.asarray(g).tolist()} ref={np.asarray(r).tolist()}")


def _assert_stats(ts, js):
    for k in STAT_KEYS:
        assert getattr(ts, k) == getattr(js, k), (k, getattr(ts, k), getattr(js, k))
    assert ts.occupancy == js.occupancy


def test_cb_bit_exact_vs_standalone_ragged(model):
    """Mid-flight admits and several rebases (30 requests through 4 slots
    of a 24-position window): tokens equal the standalone greedy's and the
    JAX batcher's, counters equal JAX's."""
    cfg = DecodeConfig(max_new_tokens=16)
    wavs = _wavs(30, seed=99)
    ref = _standalone(model[1], cfg, wavs)
    assert len({len(r) for r in ref}) >= 2, "fixture lost its raggedness"
    got, jref, ts, js = _run_both(*_pair(model, cfg, batch=4, chunk=5, admit_lanes=2,
                                         cache_len=24), wavs)
    assert ts.admits == len(wavs) and ts.rebases >= 1
    _assert_equal(got, ref, jref)
    _assert_stats(ts, js)


def test_cb_pool_reuse_and_order(model):
    """A second run on the same batcher (recycled state, the window where
    the first run left it) stays exact; results come back in order."""
    cfg = DecodeConfig(max_new_tokens=12)
    jcb, cb = _pair(model, cfg, batch=3, chunk=4, admit_lanes=3)
    for seed in (1, 2):
        wavs = _wavs(7, seed=seed)
        got, jref, ts, js = _run_both(jcb, cb, wavs)
        _assert_equal(got, _standalone(model[1], cfg, wavs), jref)
        _assert_stats(ts, js)


@pytest.mark.parametrize("switches", [{"cross_kv_pool": 2},
                                      {"kv_int8": True, "cross_kv_int8": True}],
                         ids=["cross_kv_pool2", "kv8-ckv8"])
def test_cb_cache_variants(model, switches):
    """The pooled cross-KV rides through admission as in the standalone
    path; int8 self-KV and int8 cross-KV keep the contract (their scales
    copied with the rows)."""
    cfg = DecodeConfig(max_new_tokens=10, **switches)
    wavs = _wavs(5, seed=4 if "cross_kv_pool" in switches else 5)
    got, jref, ts, js = _run_both(*_pair(model, cfg, batch=2, chunk=4, admit_lanes=2),
                                  wavs)
    _assert_equal(got, _standalone(model[1], cfg, wavs), jref)
    _assert_stats(ts, js)


@pytest.mark.parametrize("overlap", [False, True], ids=["fenced", "overlap"])
def test_cb_per_request_budgets(model, overlap):
    """Per-request `max_new`: request i equals standalone greedy with
    max_new_tokens=caps[i] (budget exhaustion appends no EOT; a natural EOT
    inside the budget is kept), with and without the overlapped loop."""
    wavs = _wavs(9, seed=7)
    caps = [2, 5, 9, 3, 12, 4, 7, 2, 6]
    refs = [_standalone(model[1], DecodeConfig(max_new_tokens=c), [w])[0]
            for w, c in zip(wavs, caps)]
    got, jref, ts, js = _run_both(
        *_pair(model, DecodeConfig(max_new_tokens=16), batch=3, chunk=4,
               admit_lanes=3 if overlap else 2, overlap=overlap), wavs, max_new=caps)
    _assert_equal(got, refs, jref)
    _assert_stats(ts, js)


def test_cb_wave_mode_matches_continuous(model):
    """Wave scheduling returns the tokens continuous scheduling returns and
    pays more device steps on a ragged set (EOT suppressed, so the budgets
    set the lengths); both counters equal JAX's."""
    cfg = DecodeConfig(max_new_tokens=16, suppress_tokens=(ARCH.eos_token_id,))
    wavs = _wavs(12, seed=11)
    caps = [2, 14, 3, 4, 13, 2, 5, 12, 3, 2, 11, 4]
    jcb, cb = _pair(model, cfg, batch=4, chunk=4, admit_lanes=4)
    wave, jwave, w_ts, w_js = _run_both(jcb, cb, wavs, max_new=caps, wave=True)
    cont, jcont, c_ts, c_js = _run_both(jcb, cb, wavs, max_new=caps)
    _assert_equal(cont, wave, jcont)
    _assert_equal(wave, jwave)
    _assert_stats(w_ts, w_js)
    _assert_stats(c_ts, c_js)
    assert c_ts.device_steps < w_ts.device_steps
    assert w_ts.admits == c_ts.admits == len(wavs)


def test_cb_overlap_pipeline_exact(model):
    """overlap=True (retirement one chunk late, from the snapshot's own
    start and tokens) across mid-flight admits and rebases, then a second
    run on the recycled pool: tokens equal the standalone greedy's and
    JAX's, counters equal JAX's."""
    cfg = DecodeConfig(max_new_tokens=16)
    jcb, cb = _pair(model, cfg, batch=4, chunk=5, admit_lanes=2, cache_len=32,
                    overlap=True)
    for wavs in (_wavs(30, seed=99), _wavs(9, seed=3)):
        got, jref, ts, js = _run_both(jcb, cb, wavs)
        _assert_equal(got, _standalone(model[1], cfg, wavs), jref)
        _assert_stats(ts, js)
        assert ts.rebases >= 1 or len(wavs) < 30


def test_cb_int16_transfer(model):
    """transfer="int16" equals the float32 path on PCM16-round-tripped
    audio (scaled by 1/32767 both ways), and JAX's int16 batcher."""
    cfg = DecodeConfig(max_new_tokens=10)
    wavs = _wavs(5, seed=6)
    rt = [np.clip(w * 32767.0, -32768, 32767).astype(np.int16).astype(np.float32)
          / 32767.0 for w in wavs]
    got, jref, ts, js = _run_both(*_pair(model, cfg, batch=2, chunk=4, admit_lanes=2,
                                         transfer="int16"), wavs)
    _assert_equal(got, _standalone(model[1], cfg, rt), jref)
    _assert_stats(ts, js)


@pytest.mark.parametrize("stage_encode", [True, False], ids=["stage_encode", "per_admit"])
@pytest.mark.parametrize("transfer", ["float32", "int16"])
def test_cb_staged_pool_matches_list(model, transfer, stage_encode):
    """stage() + device-gather admits return what the per-admit upload path
    returns, with and without prefill disaggregation, in both wires; the
    int16 pool holds the PCM16 codes `_pad_wav` makes."""
    cfg = DecodeConfig(max_new_tokens=10)
    wavs = _wavs(6, seed=8)
    caps = [3, 8, 2, 6, 10, 4]
    cb = ContinuousBatcher(model[1], ARCH, cfg, batch=2, chunk=4, admit_lanes=2,
                           transfer=transfer, stage_encode=stage_encode, device=DEV)
    ref = cb.transcribe_all(wavs, max_new=caps)
    pool = cb.stage(wavs)
    assert pool.dtype == (torch.int16 if transfer == "int16" else torch.float32)
    assert pool.shape == (len(wavs), N_SAMPLES)
    got = cb.transcribe_all(pool, max_new=caps)
    _assert_equal(got, ref)


def test_cb_int16_refuses_a_float_pool(model):
    """A floating pool under transfer="int16" raises in transcribe_all, in
    admit and in encode_stage, before anything decodes."""
    cfg = DecodeConfig(max_new_tokens=4)
    cb = ContinuousBatcher(model[1], ARCH, cfg, batch=2, chunk=4, admit_lanes=2,
                           transfer="int16", device=DEV)
    floats = torch.from_numpy(np.stack([np.resize(w, N_SAMPLES) for w in _wavs(3, 1)]))
    with pytest.raises(ValueError, match="int16"):
        cb.transcribe_all(floats)
    plan, fns = cbm.make_cb_fns(ARCH, cfg, 2, chunk=4, admit_lanes=2, transfer="int16",
                                device=DEV)
    state = fns["init"](model[1])
    with pytest.raises(ValueError, match="int16"):
        fns["admit"](model[1], state, floats[:2], np.arange(2), np.ones(2, bool),
                     np.full(2, 4))
    with pytest.raises(ValueError, match="int16"):
        fns["encode_stage"](model[1], floats[:2])


def test_cb_rejects_unsupported_modes(model):
    with pytest.raises(ValueError, match="greedy-only"):
        ContinuousBatcher(model[1], ARCH, DecodeConfig(beam_size=2), batch=2, device=DEV)
    ts_arch = ARCHS["test2l-ts"]
    from openai_whisper_compression_tpu_torch.models.params import init_params

    with pytest.raises(ValueError, match="timestamp"):
        ContinuousBatcher(init_params(ts_arch, 0, device=DEV), ts_arch,
                          DecodeConfig(notimestamps=False), batch=2, device=DEV)
    with pytest.raises(ValueError, match="cross_pallas"):
        ContinuousBatcher(model[1], ARCH, DecodeConfig(cross_pallas=False), batch=2,
                          device=DEV)
    with pytest.raises(ValueError, match="transfer"):
        ContinuousBatcher(model[1], ARCH, DecodeConfig(), batch=2, transfer="mulaw",
                          device=DEV)
    with pytest.raises(ValueError, match="cache_len"):
        ContinuousBatcher(model[1], ARCH, DecodeConfig(max_new_tokens=16), batch=2,
                          chunk=4, cache_len=16, device=DEV)


def test_cb_occupancy_beats_lockstep_accounting(model):
    """Device steps track the SUM of lengths, not waves x max length;
    occupancy and generated tokens as JAX counts them."""
    cfg = DecodeConfig(max_new_tokens=16)
    wavs = _wavs(12, seed=99)
    ref = _standalone(model[1], cfg, wavs)
    lens = np.array([len(r) for r in ref])
    assert lens.std() > 0
    jcb, cb = _pair(model, cfg, batch=4, chunk=4, admit_lanes=4)
    got, jref, ts, js = _run_both(jcb, cb, wavs)
    _assert_equal(got, ref, jref)
    _assert_stats(ts, js)
    waves = [lens[i: i + 4] for i in range(0, len(lens), 4)]
    lockstep_steps = sum(int(w.max()) - 1 for w in waves)
    assert ts.device_steps <= lockstep_steps + 2 * cb.plan.chunk
    assert 0.0 < ts.occupancy <= 1.0
    assert ts.gen_tokens == int((lens - cb.plan.p_len).sum())


def test_cb_plan_and_snapshot_match_jax(model):
    """make_cb_fns's plan (cache_len rounded to 64, with and without
    overlap; max_new clipped to the table) and `CBStats.snapshot` keys."""
    from openai_whisper_compression_tpu.models import continuous as jax_cbm

    for kw in ({"chunk": 8}, {"chunk": 8, "overlap": True},
               {"chunk": 4, "cache_len": 40}):
        cfg = DecodeConfig(max_new_tokens=64)
        jplan, _ = jax_cbm.make_cb_fns(J_ARCH, _jax_cfg(cfg), 3, **kw)
        plan, _ = cbm.make_cb_fns(ARCH, cfg, 3, device=DEV, **kw)
        assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
        assert plan.max_rel == jplan.max_rel
    assert set(CBStats().snapshot()) == set(JaxCBStats().snapshot())


@pytest.mark.parametrize("cap", [1, 3, 8])
@pytest.mark.parametrize("emitted", [None, 0, 2, 5])
def test_gen_tokens_of_row_matches_jax(cap, emitted):
    from openai_whisper_compression_tpu.models.continuous import (
        gen_tokens_of_row as jax_gen)

    row = np.arange(100, 120, dtype=np.int64)
    if emitted is not None:
        row[3 + 2 + emitted] = 21
    got = cbm.gen_tokens_of_row(row, 3, 2, cap, 21)
    np.testing.assert_array_equal(got, jax_gen(row, 3, 2, cap, 21))


def test_rebase_rolls_the_window_in_place(model):
    """rebase shifts tokens and every cache tensor (int8 codes and scales
    too) down the position axis in place, lowers pos and clamps start."""
    cfg = DecodeConfig(max_new_tokens=8, kv_int8=True, cross_kv_int8=True)
    plan, fns = cbm.make_cb_fns(ARCH, cfg, 2, chunk=4, admit_lanes=2, device=DEV)
    state = fns["init"](model[1])
    g = torch.Generator().manual_seed(0)
    with torch.inference_mode():      # the state's tensors are inference tensors
        for entry in state["cache"]:
            for t in entry.values():
                t.copy_(torch.randint(-100, 100, t.shape, generator=g).to(t.dtype))
        state["tokens"].copy_(torch.randint(0, 20, state["tokens"].shape, generator=g))
        state["pos"], state["start"][:] = 20, torch.tensor([3, 9], dtype=torch.int32)
    before = {"tokens": state["tokens"].clone(),
              "cache": [{k: t.clone() for k, t in e.items()} for e in state["cache"]]}
    ptrs = [t.data_ptr() for e in state["cache"] for t in e.values()]
    out = fns["rebase"](state, 5)
    assert out is state and ptrs == [t.data_ptr() for e in state["cache"] for t in e.values()]
    assert state["pos"] == 15 and state["start"].tolist() == [0, 4]
    assert torch.equal(state["tokens"], torch.roll(before["tokens"], -5, dims=1))
    for e, b in zip(state["cache"], before["cache"]):
        for k in e:
            assert torch.equal(e[k], torch.roll(b[k], -5, dims=2))


def test_masked_lanes_leave_their_slots_untouched(model):
    """An admit whose mask is partly off copies cross-KV rows and arms only
    the masked lanes' slots; the others keep their rows and state."""
    cfg = DecodeConfig(max_new_tokens=8, cross_kv_int8=True)
    plan, fns = cbm.make_cb_fns(ARCH, cfg, 3, chunk=4, admit_lanes=2, device=DEV)
    tp = model[1]
    state = fns["init"](tp)
    before = [(kv.k_t.clone(), kv.k_scale.clone()) for kv in state["cross"]]
    wav = torch.from_numpy(np.stack([np.resize(w, N_SAMPLES) for w in _wavs(2, 5)]))
    fns["admit"](tp, state, wav, np.array([2, 0]), np.array([True, False]),
                 np.array([5, 5]))
    h = state["cross"][0].k_t.shape[0] // 3
    stage = fns["encode_stage"](tp, wav)
    for (k0, s0), kv, skv in zip(before, state["cross"], stage):
        assert torch.equal(kv.k_t[: 2 * h], k0[: 2 * h])        # slots 0, 1 untouched
        assert torch.equal(kv.k_t[2 * h:], skv.k_t[:h])          # lane 0 -> slot 2
        assert torch.equal(kv.k_scale[2 * h:], skv.k_scale[:h])
    assert state["finished"].tolist() == [True, True, False]
    assert state["cap"].tolist() == [8, 8, 5]
    assert int(state["tokens"][2, 0]) == plan.prefix[0]
