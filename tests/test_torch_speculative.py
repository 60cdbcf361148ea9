"""The port's `models/speculative.py`, `prune/structured.py::drop_layers` and
`evaluation/harness.py::make_speculative_transcribe_fn` against the jitted
JAX package on `test2l` / `test2l-ts` in f32: the verify window against
sequential steps (fp and int8 caches), `speculative_decode` with a self
draft, a divergent draft, a smaller draft arch and at the position cap,
`verified_greedy_decode` with exact, partial, junk and empty drafts, the
timestamp rules, a padded prompt, int8 caches, ragged EOT drafts, Jacobi
rounds and padding lanes, `_last_ts_table`, `self_speculative_draft`.
Tokens, lengths, `rounds` and `n_acc` must equal JAX's and the port's
`greedy_decode`; float bounds are stated per test. Weights come from
`init_params_jit` (std 0.5, so that tokens vary) through `from_numpy`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.evaluation import harness as jax_harness
from openai_whisper_compression_tpu.models import cache as jax_cache
from openai_whisper_compression_tpu.models import decode as jax_decode
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.models import speculative as jax_spec
from openai_whisper_compression_tpu.models import whisper as jax_whisper
from openai_whisper_compression_tpu.ops import self_attention_step as jax_sas
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.evaluation import harness
from openai_whisper_compression_tpu_torch.models import cache as kv_cache
from openai_whisper_compression_tpu_torch.models import decode, speculative, whisper
from openai_whisper_compression_tpu_torch.models.params import from_numpy
from openai_whisper_compression_tpu_torch.prune.structured import drop_layers

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

STD = 0.5
NO_LANG = {"language_token_id": None, "task_token_id": None}
CACHES = {"fp": {}, "kv8-ckv8": {"kv_int8": True, "cross_kv_int8": True}}
# logits (up to ~40 at std 0.5) from f32 sums in another order (window vs
# steps, port vs XLA): 5e-5 of the reference's largest magnitude
LOGITS_REL = 5e-5


def _close(got, ref):
    np.testing.assert_allclose(got, ref, atol=LOGITS_REL * float(np.abs(ref).max()))


def _tree(arch_name, seed=0, std=STD):
    jp = JP.init_params_jit(JAX_ARCHS[arch_name], jax.random.PRNGKey(seed), std=std)
    return jp, from_numpy(jax.tree.map(np.asarray, jp), device=DEV)


@pytest.fixture(scope="module")
def plain():
    """test2l: (JAX tree, torch tree, encoder states (2, 64, 64) f32)."""
    jp, tp = _tree("test2l")
    enc = np.random.default_rng(1).standard_normal((2, 64, 64)).astype(np.float32)
    return jp, tp, enc


@pytest.fixture(scope="module")
def ts():
    """test2l-ts: the timestamp-capable twin, three rows."""
    jp, tp = _tree("test2l-ts", seed=7)
    enc = np.random.default_rng(3).standard_normal((3, 64, 64)).astype(np.float32)
    return jp, tp, enc


def _greedy(tp, arch_name, enc, cfg_kw, **kw):
    with torch.inference_mode():
        t, l = decode.greedy_decode(tp, ARCHS[arch_name], torch.from_numpy(enc),
                                    DecodeConfig(**cfg_kw), **kw)[:2]
    return t.numpy(), l.numpy()


def _spec_both(jp_t, tp_t, jp_d, tp_d, enc_t, enc_d, cfg_kw, gamma,
               arch="test2l", arch_d=None):
    """(JAX (tokens, lengths, rounds), port's) of speculative_decode."""
    ja, ta = JAX_ARCHS[arch], ARCHS[arch]
    jd, td = (JAX_ARCHS[arch], ARCHS[arch]) if arch_d is None else arch_d
    ref = jax.jit(lambda pt, pd, et, ed: jax_spec.speculative_decode(
        pt, ja, pd, jd, et, ed, JaxDecodeConfig(**cfg_kw), gamma=gamma))(
        jp_t, jp_d, jnp.asarray(enc_t), jnp.asarray(enc_d))
    with torch.inference_mode():
        got = speculative.speculative_decode(
            tp_t, ta, tp_d, td, torch.from_numpy(enc_t), torch.from_numpy(enc_d),
            DecodeConfig(**cfg_kw), gamma=gamma)
    return ([np.asarray(ref[0]), np.asarray(ref[1]), int(ref[2])],
            [got[0].numpy(), got[1].numpy(), got[2]])


def _assert_same(ref, got, greedy):
    assert got[0].shape == ref[0].shape == greedy[0].shape
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0], greedy[0])
    np.testing.assert_array_equal(got[1], greedy[1])


@pytest.mark.parametrize("cache", list(CACHES))
def test_verify_window_matches_sequential(plain, cache):
    """One verify_window pass at an offset equals stepping the same tokens
    one by one through `decoder_step` (the fused step's plain versions), and
    JAX's verify_window, within LOGITS_REL; over an int8 cache both attend
    to the quantized rows, and the rows they write are equal."""
    jp, tp, enc = plain
    arch, cfg = ARCHS["test2l"], DecodeConfig(**CACHES[cache])
    b, max_len, pos, w = 2, 13, 3, 5     # a cache length no multiple of 64
    toks = np.random.default_rng(2).integers(0, 900, (b, pos + w))
    e = torch.from_numpy(enc)
    with torch.inference_mode():
        kvs = decode.cross_kvs_for(tp, arch, e, cfg)
        c_win = kv_cache.init_cache(tp, arch, b, max_len, device=DEV, int8=cfg.kv_int8)
        c_step = kv_cache.init_cache(tp, arch, b, max_len, device=DEV, int8=cfg.kv_int8)
        t = torch.from_numpy(toks)
        for i in range(pos):      # the same history in both caches
            decode.decoder_step(tp, arch, t[:, i], i, c_win, kvs)
        lw = speculative.verify_window(tp, arch, t[:, pos:], pos, c_win, kvs)
        steps = []
        for i in range(pos + w):
            logits = decode.decoder_step(tp, arch, t[:, i], i, c_step, kvs)
            if i >= pos:
                steps.append(logits)
    ls = torch.stack(steps, dim=1)
    _close(lw.numpy(), ls.numpy())
    for a, s in zip(c_win, c_step):
        for name in a:
            if a[name].dtype == torch.int8:
                # one code where the two f32 layer norms part in the last bit
                assert int((a[name].int() - s[name].int()).abs().max()) <= 1
            else:   # f32 rows from sums in another order: 1e-5 of their scale
                np.testing.assert_allclose(a[name].numpy(), s[name].numpy(),
                                           atol=1e-5 * float(s[name].abs().max()))

    j_arch = JAX_ARCHS["test2l"]
    jcfg = JaxDecodeConfig(**CACHES[cache])

    def run(p, e):
        kv = jax_spec._make_cross_kvs(p, j_arch, e, jcfg)
        c = jax_cache.init_cache(p, j_arch, b, max_len, dtype=e.dtype,
                                 int8=jcfg.kv_int8)
        for i in range(pos):
            _, c = jax_decode.decoder_step(p, j_arch, jnp.asarray(toks[:, i]),
                                           jnp.asarray(i), c, kv, max_len)
        return jax_spec.verify_window(p, j_arch, jnp.asarray(toks[:, pos:]),
                                      jnp.asarray(pos), c, kv, max_len)[0]

    ref = np.asarray(jax.jit(run)(jp, jnp.asarray(enc)))
    _close(lw.numpy(), ref)


def test_int8_step_attends_the_quantized_row():
    """JAX's fused int8 step (Pallas, interpret mode) attends to the fresh
    row as the cache stores it, quantized, not to the exact row: its output
    equals the port's plain version (which attends the written codes) to
    f32 sum order, and the attention over the exact row differs by far
    more. The verify window attends to the dequantized cache, fresh rows
    included, so both paths see the same rows."""
    from openai_whisper_compression_tpu_torch.ops.self_attention_step import (
        _attend_ref, decode_self_attention_update_int8)

    rng = np.random.default_rng(4)
    bh, s, dh, pos = 8, 16, 64, 6
    q = (rng.standard_normal((bh, dh)) * 0.125).astype(np.float32)
    kn, vn = (rng.standard_normal((2, bh, dh)) * 3).astype(np.float32)
    kc = rng.integers(-127, 128, (bh, s, dh)).astype(np.int8)
    vc = rng.integers(-127, 128, (bh, s, dh)).astype(np.int8)
    ks, vs = (rng.random((2, bh, s)) * 0.05).astype(np.float32)
    ref = jax_sas.decode_self_attention_update_int8(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(pos))
    ref_out = np.asarray(ref[0] if isinstance(ref, tuple) else ref)
    t = [torch.from_numpy(x.copy()) for x in (kc, vc, ks, vs)]
    got = decode_self_attention_update_int8(torch.from_numpy(q), torch.from_numpy(kn),
                                            torch.from_numpy(vn), *t, pos)
    np.testing.assert_allclose(got.numpy(), ref_out, atol=1e-5)
    # attention over the same cache with the EXACT fresh row at pos
    k_deq = t[0].float() * t[2][..., None]
    v_deq = t[1].float() * t[3][..., None]
    k_deq[:, pos], v_deq[:, pos] = torch.from_numpy(kn), torch.from_numpy(vn)
    exact = _attend_ref(torch.from_numpy(q), k_deq, v_deq, pos, None)
    assert float((exact - got).abs().max()) > 100 * 1e-5


@pytest.mark.parametrize("std", [0.02, STD])
def test_speculative_equals_greedy_selfdraft(plain, std):
    """Draft == target: every draft token is accepted and the output is
    greedy's and JAX's, in at most ceil(12 / 4) + 1 rounds. At the JAX
    test's weight scale (std 0.02) the rounds equal JAX's; at std 0.5 the
    JAX function, which drafts over a stale cache row after a full accept,
    needs more (9 here), and the port does not copy that."""
    jp, tp = _tree("test2l", std=std)
    enc = plain[2]
    cfg_kw = dict(max_new_tokens=12, **NO_LANG)
    ref, got = _spec_both(jp, tp, jp, tp, enc, enc, cfg_kw, gamma=3)
    _assert_same(ref, got, _greedy(tp, "test2l", enc, cfg_kw))
    assert got[2] <= -(-12 // 4) + 1
    if std == 0.02:
        assert got[2] == ref[2]


@pytest.mark.parametrize("cache", list(CACHES))
def test_speculative_divergent_draft_still_exact(plain, cache):
    """A DIFFERENT draft model (another seed): acceptance is low, the output
    is still target-only greedy; tokens, lengths and rounds equal JAX's."""
    jp, tp, enc = plain
    jd, td = _tree("test2l", seed=99)
    enc_d = np.random.default_rng(5).standard_normal((2, 64, 64)).astype(np.float32)
    cfg_kw = dict(max_new_tokens=10, **NO_LANG, **CACHES[cache])
    ref, got = _spec_both(jp, tp, jd, td, enc, enc_d, cfg_kw, gamma=3)
    _assert_same(ref, got, _greedy(tp, "test2l", enc, cfg_kw))
    assert 1 <= got[2] <= ref[2]


def test_speculative_transcribe_fn_cross_arch():
    """The harness function with a SMALLER draft arch (one layer each side):
    its tokens and lengths equal JAX's and the port's `make_transcribe_fn`."""
    j_arch, arch = JAX_ARCHS["test2l"], ARCHS["test2l"]
    jd_arch = j_arch.replace(name="test1l", encoder_layers=1, decoder_layers=1)
    td_arch = arch.replace(name="test1l", encoder_layers=1, decoder_layers=1)
    jp, tp = _tree("test2l")
    jd = JP.init_params_jit(jd_arch, jax.random.PRNGKey(7), std=STD)
    td = from_numpy(jax.tree.map(np.asarray, jd), device=DEV)
    cfg_kw = dict(max_new_tokens=8, **NO_LANG)
    wav = (np.random.default_rng(4).standard_normal((2, 64 * 2 * 160)) * 0.1
           ).astype(np.float32)
    ref = jax_harness.make_speculative_transcribe_fn(
        j_arch, jd_arch, JaxDecodeConfig(**cfg_kw), gamma=3)(jp, jd, jnp.asarray(wav))
    got = harness.make_speculative_transcribe_fn(
        arch, td_arch, DecodeConfig(**cfg_kw), gamma=3, device=DEV)(tp, td, wav)
    plain_fn = harness.make_transcribe_fn(arch, DecodeConfig(**cfg_kw), device=DEV)
    greedy = [x.numpy() for x in plain_fn(tp, wav)]
    _assert_same([np.asarray(x) for x in ref], [x.numpy() for x in got], greedy)


@pytest.mark.parametrize("gamma", [3, 4])
def test_max_length_exactness(plain, gamma):
    """A decode that fills the position window to the brim (EOT suppressed,
    max_new_tokens past the cap): tokens and lengths equal greedy's over
    the whole buffer, and JAX's; the workspace pad never shifts a token."""
    jp, tp, enc = plain
    assert ARCHS["test2l"].max_target_positions == 32
    cfg_kw = dict(max_new_tokens=40, suppress_tokens=(997,), **NO_LANG)
    ref, got = _spec_both(jp, tp, jp, tp, enc, enc, cfg_kw, gamma=gamma)
    _assert_same(ref, got, _greedy(tp, "test2l", enc, cfg_kw))
    assert got[2] <= ref[2]


@pytest.mark.parametrize("switches", [{"cross_kv_pool": 2},
                                      {"cross_kv_merge": 20, "cross_kv_int8": True}])
def test_speculative_pools_as_greedy(plain, switches):
    """Pooled or merged cross-KV: the target and the draft attend to the
    encoder states greedy attends to, so the tokens are greedy's (the JAX
    function builds its cross-KV unpooled, and parts from greedy here)."""
    _, tp, enc = plain
    td = _tree("test2l", seed=99)[1]
    arch, e = ARCHS["test2l"], torch.from_numpy(enc)
    cfg_kw = dict(max_new_tokens=10, **NO_LANG, **switches)
    with torch.inference_mode():
        got = speculative.speculative_decode(tp, arch, td, arch, e, e,
                                             DecodeConfig(**cfg_kw), gamma=3)
    greedy = _greedy(tp, "test2l", enc, cfg_kw)
    np.testing.assert_array_equal(got[0].numpy(), greedy[0])
    np.testing.assert_array_equal(got[1].numpy(), greedy[1])


def test_speculative_rejects_beam_and_timestamps(plain, ts):
    _, tp, enc = plain
    e, arch = torch.from_numpy(enc), ARCHS["test2l"]
    with pytest.raises(ValueError, match="greedy-only"):
        speculative.speculative_decode(tp, arch, tp, arch, e, e,
                                       DecodeConfig(beam_size=2))
    _, tp_ts, enc_ts = ts
    e_ts, arch_ts = torch.from_numpy(enc_ts), ARCHS["test2l-ts"]
    with pytest.raises(ValueError, match="timestamp"):
        speculative.speculative_decode(tp_ts, arch_ts, tp_ts, arch_ts, e_ts, e_ts,
                                       DecodeConfig(notimestamps=False))


def test_self_speculative_draft(plain):
    """Layer-dropped self draft: the kept layers are the target's own
    tensors (`is`), drop_layers refuses to drop every layer, and the
    speculative transcription equals the plain one and JAX's."""
    jp, tp, _ = plain
    arch, j_arch = ARCHS["test2l"], JAX_ARCHS["test2l"]
    draft, arch_d = speculative.self_speculative_draft(tp, arch, keep_decoder=1)
    assert len(draft["decoder"]["layers"]) == 1 and arch_d.decoder_layers == 1
    assert draft["decoder"]["layers"][0]["fc1"]["w"] is tp["decoder"]["layers"][0]["fc1"]["w"]
    assert draft["encoder"] is not tp["encoder"] and len(tp["decoder"]["layers"]) == 2
    d2, a2 = speculative.self_speculative_draft(tp, arch, keep_encoder=1, keep_decoder=5)
    assert (len(d2["encoder"]["layers"]), a2.encoder_layers, a2.decoder_layers) == (1, 1, 2)
    with pytest.raises(ValueError, match="all layers"):
        drop_layers(tp, "decoder", [0, 1])
    jd, jd_arch = jax_spec.self_speculative_draft(jp, j_arch, keep_decoder=1)
    assert jd_arch.name == arch_d.name

    cfg_kw = dict(max_new_tokens=8, **NO_LANG)
    wav = (np.random.default_rng(6).standard_normal((2, 64 * 2 * 160)) * 0.1
           ).astype(np.float32)
    ref = jax_harness.make_speculative_transcribe_fn(
        j_arch, jd_arch, JaxDecodeConfig(**cfg_kw), gamma=3)(jp, jd, jnp.asarray(wav))
    got = harness.make_speculative_transcribe_fn(
        arch, arch_d, DecodeConfig(**cfg_kw), gamma=3, device=DEV)(tp, draft, wav)
    greedy = [x.numpy() for x in harness.make_transcribe_fn(
        arch, DecodeConfig(**cfg_kw), device=DEV)(tp, wav)]
    _assert_same([np.asarray(x) for x in ref], [x.numpy() for x in got], greedy)


def test_last_ts_table_and_pad_positions():
    """`_last_ts_table` equals JAX's on random drafts with and without
    timestamps; `_pad_positions` appends zero rows and shares the rest."""
    rng = np.random.default_rng(8)
    draft = rng.integers(850, 1000, (6, 9)).astype(np.int64)
    draft[0] = 10                                   # no timestamp at all
    got = speculative._last_ts_table(torch.from_numpy(draft), 900)
    ref = jax_spec._last_ts_table(jnp.asarray(draft, jnp.int32), 900)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    _, tp = _tree("test2l")
    padded = speculative._pad_positions(tp, 5)
    pos = padded["decoder"]["pos"]
    assert pos.shape == (32 + 5, 64) and not bool(pos[32:].any())
    assert torch.equal(pos[:32], tp["decoder"]["pos"])
    assert padded["decoder"]["layers"] is tp["decoder"]["layers"]


# ---------------------------------------------------------------------------
# verified_greedy_decode
# ---------------------------------------------------------------------------

def _drafts_from(tokens, lens, first_gen, g_width, eot, mode, rng):
    """(draft, draft_len) from greedy's tokens in a corruption mode (the
    JAX test's)."""
    b = tokens.shape[0]
    draft = np.full((b, g_width), eot, np.int32)
    dlen = np.zeros((b,), np.int32)
    for i in range(b):
        gen = tokens[i, first_gen: lens[i]]
        n = min(len(gen), g_width)
        draft[i, :n] = gen[:n]
        dlen[i] = n
        if mode == "empty":
            dlen[i] = 0
        elif mode == "junk":
            draft[i, :] = rng.integers(0, 800, g_width)
            dlen[i] = g_width
        elif mode == "partial":
            k = n // 2
            if k < n:
                draft[i, k:n] = rng.integers(0, 800, n - k)
    return draft, dlen


def _verified_both(jp, tp, enc, cfg_kw, draft, dlen, prompt=None, plen=None, **kw):
    """(JAX (tokens, lengths, n_acc), port's) of verified_greedy_decode."""
    j_arch, arch = JAX_ARCHS["test2l-ts"], ARCHS["test2l-ts"]
    jkw, tkw = dict(kw), dict(kw)
    if "active" in kw:
        jkw["active"] = jnp.asarray(kw["active"])
        tkw["active"] = torch.from_numpy(kw["active"])
    if prompt is not None:
        jkw.update(prompt_tokens=jnp.asarray(prompt), prompt_lens=jnp.asarray(plen))
        tkw.update(prompt_tokens=torch.from_numpy(prompt), prompt_lens=torch.from_numpy(plen))
    ref = jax.jit(lambda p, e, d, dl: jax_spec.verified_greedy_decode(
        p, j_arch, e, JaxDecodeConfig(**cfg_kw), d, dl, **jkw))(
        jp, jnp.asarray(enc), jnp.asarray(draft), jnp.asarray(dlen))
    with torch.inference_mode():
        got = speculative.verified_greedy_decode(
            tp, arch, torch.from_numpy(enc), DecodeConfig(**cfg_kw),
            torch.from_numpy(draft), torch.from_numpy(dlen), **tkw)
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


@pytest.mark.parametrize("mode", ["exact", "partial", "junk", "empty"])
@pytest.mark.parametrize("timestamps", [False, True])
def test_verified_equals_greedy(ts, mode, timestamps):
    jp, tp, enc = ts
    cfg_kw = dict(notimestamps=not timestamps, max_new_tokens=16,
                  max_initial_timestamp_index=20)
    ref_t, ref_l = _greedy(tp, "test2l-ts", enc, cfg_kw)
    first_gen = len(decode.forced_prefix(ARCHS["test2l-ts"], DecodeConfig(**cfg_kw)))
    draft, dlen = _drafts_from(ref_t, ref_l, first_gen, 16, 897, mode,
                               np.random.default_rng(11))
    ref, got = _verified_both(jp, tp, enc, cfg_kw, draft, dlen)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got[0], ref_t)
    np.testing.assert_array_equal(got[1], ref_l)
    if mode == "exact":
        assert (got[2] >= dlen).all()
    if mode == "empty":
        assert (got[2] >= 1).all()


@pytest.mark.parametrize("rounds", [1, 3])
def test_verified_with_prompt(ts, rounds):
    """A left-padded prompt window (lengths 3, 0, 6) rides the verify
    window's start mask; one round and three (Jacobi) rounds."""
    jp, tp, enc = ts
    cfg_kw = dict(notimestamps=False, max_new_tokens=12, max_initial_timestamp_index=20)
    pw, rng = 8, np.random.default_rng(5)
    prompt = np.full((3, pw), 897, np.int32)
    plen = np.asarray([3, 0, 6], np.int32)
    for i, n in enumerate(plen):
        prompt[i, pw - n:] = rng.integers(0, 800, n)
    ref_t, ref_l = _greedy(tp, "test2l-ts", enc, cfg_kw,
                           prompt_tokens=torch.from_numpy(prompt),
                           prompt_lens=torch.from_numpy(plen))
    first_gen = pw + len(decode.forced_prefix(ARCHS["test2l-ts"], DecodeConfig(**cfg_kw)))
    draft, dlen = _drafts_from(ref_t, ref_l, first_gen, 12, 897, "partial", rng)
    ref, got = _verified_both(jp, tp, enc, cfg_kw, draft, dlen, prompt, plen,
                              rounds=rounds)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got[0], ref_t)
    np.testing.assert_array_equal(got[1], ref_l)


def test_verified_kv_int8():
    """int8 caches at the JAX test's weight scale (std 0.02). The verify
    window attends to the quantized rows of the prompt and prefix too, where
    greedy's prefill attends to their exact rows; at std 0.5 that moves
    argmaxes, in the port and in JAX alike."""
    jp, tp = _tree("test2l-ts", seed=7, std=0.02)
    enc = np.random.default_rng(3).standard_normal((3, 64, 64)).astype(np.float32)
    cfg_kw = dict(notimestamps=True, max_new_tokens=12, kv_int8=True)
    ref_t, ref_l = _greedy(tp, "test2l-ts", enc, cfg_kw)
    first_gen = len(decode.forced_prefix(ARCHS["test2l-ts"], DecodeConfig(**cfg_kw)))
    draft, dlen = _drafts_from(ref_t, ref_l, first_gen, 12, 897, "partial",
                               np.random.default_rng(9))
    ref, got = _verified_both(jp, tp, enc, cfg_kw, draft, dlen)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got[0], ref_t)
    np.testing.assert_array_equal(got[1], ref_l)


def test_verified_ragged_eot_drafts(ts):
    """Drafts holding the true EOT and junk beyond it: the junk after an
    accepted EOT is not accepted (greedy pads EOT there)."""
    jp, tp, enc = ts
    cfg_kw = dict(notimestamps=True, max_new_tokens=16)
    ref_t, ref_l = _greedy(tp, "test2l-ts", enc, cfg_kw)
    first_gen = len(decode.forced_prefix(ARCHS["test2l-ts"], DecodeConfig(**cfg_kw)))
    rng = np.random.default_rng(13)
    draft = np.full((3, 16), 897, np.int32)
    for i in range(3):
        gen = ref_t[i, first_gen: ref_l[i]]
        n = min(len(gen), 16)
        draft[i, :n] = gen[:n]
        if n + 2 <= 16:
            draft[i, n: n + 2] = rng.integers(0, 800, 2)
    ref, got = _verified_both(jp, tp, enc, cfg_kw, draft, np.full((3,), 16, np.int32))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got[0], ref_t)
    np.testing.assert_array_equal(got[1], ref_l)


def test_verified_empty_then_real_draft(ts):
    """One configuration called twice, an all-EOT draft of length 0 and then
    greedy's own tokens: both give greedy's output (the JAX test's
    compile-once case)."""
    jp, tp, enc = ts
    cfg_kw = dict(notimestamps=False, max_new_tokens=10, max_initial_timestamp_index=20)
    ref_t, ref_l = _greedy(tp, "test2l-ts", enc, cfg_kw)
    fg = len(decode.forced_prefix(ARCHS["test2l-ts"], DecodeConfig(**cfg_kw)))
    for draft, dlen in ((np.full((3, 10), 897, np.int32), np.zeros((3,), np.int32)),
                        (ref_t[:, fg: fg + 10].astype(np.int32),
                         np.full((3,), 10, np.int32))):
        ref, got = _verified_both(jp, tp, enc, cfg_kw, draft, dlen)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(got[0], ref_t)


def test_active_mask_padding_lanes_do_not_constrain(ts):
    """Padding lanes (active False, draft_len 0, zero encoder states) do not
    drag the batch-min continuation to zero: the active rows' outputs are
    greedy's, the padding lane reports a full accept, as in JAX, and the
    sequential loop runs no more steps than the active rows' accepts leave."""
    jp, tp, enc = ts
    cfg_kw = dict(notimestamps=False, max_new_tokens=10, max_initial_timestamp_index=20)
    ref_t, ref_l = _greedy(tp, "test2l-ts", enc, cfg_kw)
    fg = len(decode.forced_prefix(ARCHS["test2l-ts"], DecodeConfig(**cfg_kw)))
    enc_b = np.concatenate([enc, np.zeros_like(enc[:1])])
    draft = np.full((4, 10), 897, np.int32)
    dlen = np.zeros((4,), np.int32)
    for i in range(3):
        gen = ref_t[i, fg: ref_l[i]][:10]
        draft[i, : len(gen)] = gen
        dlen[i] = len(gen)
    active = np.asarray([True, True, True, False])
    steps = []
    real_step = decode.decoder_step

    def counting_step(*a, **kw):
        steps.append(a[3])
        return real_step(*a, **kw)

    speculative.decoder_step = counting_step
    try:
        ref, got = _verified_both(jp, tp, enc_b, cfg_kw, draft, dlen, active=active)
    finally:
        speculative.decoder_step = real_step
    np.testing.assert_array_equal(got[0][:3], ref_t)
    np.testing.assert_array_equal(got[1][:3], ref_l)
    np.testing.assert_array_equal(got[2], ref[2])
    assert int(got[2][3]) == 10
    n0 = int(got[2][:3].min())
    limit = fg + 10
    assert len(steps) <= limit - 1 - (fg - 1 + n0)
