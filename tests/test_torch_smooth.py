"""The port's SmoothQuant and AWQ (`quant/smooth.py`) and the `DATA_AWARE`
smoothing names against the JAX package on `test2l` in f32: the same
weights on both sides (carried over by `from_numpy`) and the same
calibration mel and tokens.

Tolerances: the LN statistics within 1e-6 relative (the layer norms' last
bit, 2.4e-7), the captured rows within 1e-6 of their largest magnitude.
Given JAX's statistics, the folded layer norms and weights within 2e-7
relative (one f32 rounding of the same quotient or product), and the
smoothed float model's logits equal to the unsmoothed ones within 1e-5
(an exact rewrite, up to f32 rounding). AWQ's alpha of each site equal to
JAX's, except where the grid's best two candidates tie: there both
candidates' errors lie within 1e-6 relative (printed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.evaluation.harness import (
    make_transcribe_fn as jax_make_transcribe_fn)
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.models import whisper as jax_whisper
from openai_whisper_compression_tpu.quant import api as jax_api
from openai_whisper_compression_tpu.quant import smooth as jax_smooth
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
from openai_whisper_compression_tpu_torch.models import params as P
from openai_whisper_compression_tpu_torch.models import whisper
from openai_whisper_compression_tpu_torch.ops.qtensor import QTensor
from openai_whisper_compression_tpu_torch.quant import api, smooth

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

J_ARCH, ARCH = JAX_ARCHS["test2l"], ARCHS["test2l"]
STAT_RTOL = 1e-6
FOLD_RTOL = 2e-7
LOGIT_ATOL = 1e-5
TIE_RTOL = 1e-6


@pytest.fixture(scope="module")
def trees():
    jp = JP.init_params_jit(J_ARCH, jax.random.PRNGKey(0))
    return jp, P.from_numpy(jax.tree.map(np.asarray, jp), device=DEV)


def _cal_inputs(seed=11):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((3, 80, 2 * J_ARCH.max_source_positions)).astype(np.float32)
    return mel, rng.integers(0, J_ARCH.vocab_size, (3, 8))


def jax_run_cal(p):
    for seed in (11, 12):   # two passes: the rows of a site concatenate
        mel, tok = _cal_inputs(seed)
        jax_whisper.forward(p, J_ARCH, jnp.asarray(mel), jnp.asarray(tok, jnp.int32))


def torch_run_cal(p):
    for seed in (11, 12):
        mel, tok = _cal_inputs(seed)
        whisper.forward(p, ARCH, torch.from_numpy(mel), torch.from_numpy(tok))


@pytest.fixture(scope="module")
def stats(trees):
    jp, tp = trees
    return (jax_smooth.collect_ln_stats(jp, J_ARCH, jax_run_cal),
            smooth.collect_ln_stats(tp, ARCH, torch_run_cal))


def test_ln_stats_match_jax(stats):
    js, ts = stats
    assert list(ts) == list(js) and len(ts) == 2 * 2 + 3 * 2
    for key in js:
        ja, ta = np.asarray(js[key]["amax"]), ts[key]["amax"]
        assert ta.dtype == np.float32 and ta.shape == ja.shape
        assert np.all(np.abs(ta - ja) <= STAT_RTOL * ja), key
        jr, tr = np.asarray(js[key]["rows"]), ts[key]["rows"]
        # 2 passes: 64 rows each of the encoder's, 24 of the decoder's
        assert tr.shape == jr.shape and len(tr) == (128 if key.startswith("enc") else 48)
        assert np.abs(tr - jr).max() <= STAT_RTOL * np.abs(jr).max(), key


def test_ln_stats_refuse_a_broken_stream(trees):
    """A calibration that is no whole number of full forwards raises."""
    _, tp = trees
    mel, tok = _cal_inputs()
    with pytest.raises(ValueError, match="not a multiple"):
        smooth.collect_ln_stats(tp, ARCH, lambda p: whisper.encode(
            p, ARCH, torch.from_numpy(mel)))


def _carry(stats):
    """JAX's statistics as the port's (numpy f32)."""
    return {k: {f: np.asarray(v, np.float32) for f, v in d.items()} for k, d in stats.items()}


def _assert_folded(got, want, rtol=FOLD_RTOL):
    for (gn, g), (wn, w) in zip(P.named_leaves(got), JP.named_leaves(want)):
        assert gn == wn
        w = np.asarray(w)
        diff = np.abs(g.numpy() - w)
        assert np.all(diff <= rtol * np.abs(w)), (gn, float(diff.max()))


@pytest.mark.parametrize("alpha", [0.5, 0.8])
def test_smoothquant_folds_like_jax(trees, stats, alpha):
    """Given JAX's statistics: the folded tree within FOLD_RTOL of JAX's,
    the input tree untouched, and the smoothed float model's logits equal
    to the unsmoothed model's within LOGIT_ATOL."""
    jp, tp = trees
    js = stats[0]
    want = jax_smooth.smoothquant_params(jp, J_ARCH, stats=js, alpha=alpha)
    before = {n: t.clone() for n, t in P.named_leaves(tp)}
    got = smooth.smoothquant_params(tp, ARCH, stats=_carry(js), alpha=alpha)
    assert all(torch.equal(t, before[n]) for n, t in P.named_leaves(tp))
    _assert_folded(got, want)
    assert not torch.equal(got["encoder"]["layers"][0]["attn_ln"]["g"],
                           tp["encoder"]["layers"][0]["attn_ln"]["g"])
    mel, tok = _cal_inputs(5)
    ref = whisper.forward(tp, ARCH, torch.from_numpy(mel), torch.from_numpy(tok))
    out = whisper.forward(got, ARCH, torch.from_numpy(mel), torch.from_numpy(tok))
    torch.testing.assert_close(out, ref, rtol=0, atol=LOGIT_ATOL)


def test_smoothquant_keeps_bf16_leaves_bf16(trees, stats):
    """The fold runs in f32 and casts back to each leaf's dtype."""
    _, tp = trees
    got = smooth.smoothquant_params(P.tree_cast(tp, torch.bfloat16), ARCH,
                                    stats=stats[1])
    assert all(t.dtype == torch.bfloat16 for _, t in P.named_leaves(got))


def test_smoothing_refuses_quantized_consumers(trees, stats):
    _, tp = trees
    with pytest.raises(ValueError, match="smooth before quantizing"):
        smooth.smoothquant_params(api.quantize_params(tp, "int8"), ARCH, stats=stats[1])
    with pytest.raises(ValueError, match="run_calibration or precollected stats"):
        smooth.smoothquant_params(tp, ARCH)
    with pytest.raises(KeyError, match="unknown quant method"):
        smooth.awq_search(tp, ARCH, stats=stats[1], method="int5")


def _site_errors(tp, stats, key, method, alphas):
    """The port's error of `key` at each of `alphas` (the tie printout)."""
    quantizer = smooth._resolve_quantizer(method)
    site = next(s for s in smooth._sites(P.copy_tree(tp)) if s[0] == key)
    ws = [c["w"].float() for c in site[2]]
    x = torch.from_numpy(stats[key]["rows"])
    exacts = [x @ w for w in ws]
    ax = np.maximum(stats[key]["amax"], 1e-8)
    out = []
    for a in alphas:
        s = ax ** a
        s = smooth._safe_scale(s / np.exp(np.mean(np.log(np.maximum(s, 1e-8)))))
        out.append(smooth._site_quant_error(x, ws, exacts, s, quantizer))
    return out


@pytest.mark.parametrize("method", ["int4", "nf4", "quanto_int8"])
def test_awq_alphas_match_jax(trees, stats, method):
    """Given JAX's statistics: each site's alpha equal to JAX's or a proven
    tie; the smoothed tree (where every alpha agrees) within FOLD_RTOL."""
    jp, tp = trees
    js = _carry(stats[0])
    want_tree, want = jax_smooth.awq_search(jp, J_ARCH, stats=stats[0], method=method)
    got_tree, got = smooth.awq_search(tp, ARCH, stats=js, method=method)
    assert list(got) == list(want)
    ties = 0
    for key in want:
        if got[key] != want[key]:
            errs = _site_errors(tp, js, key, method, (got[key], want[key]))
            print(f"{method} {key}: alpha {got[key]} vs JAX {want[key]}, errors {errs}")
            assert abs(errs[0] - errs[1]) <= TIE_RTOL * max(errs), (key, errs)
            ties += 1
    if not ties:
        _assert_folded(got_tree, want_tree)
    assert ties <= 1


DCFG = dict(max_new_tokens=10, kv_int8=True, cross_kv_int8=True)


@pytest.mark.parametrize("name", ["smoothquant_int4", "smoothquant_int8",
                                  "smoothquant_w8a8", "awq_int4", "awq_nf4"])
def test_data_aware_smoothing_decodes_jax_tokens(trees, name):
    """`quantize_data_aware` end to end (each side collecting its own
    statistics): the quantized kinds and activation modes of JAX's tree,
    and greedy tokens (int8 caches) equal to JAX's transcription."""
    jp, tp = trees
    jq = jax_api.quantize_data_aware(jp, J_ARCH, name, jax_run_cal)
    tq = api.quantize_data_aware(tp, ARCH, name, torch_run_cal)
    for (n, g), (_, w) in zip(P.named_leaves(tq), JP.named_leaves(jq)):
        assert isinstance(g, QTensor) == hasattr(w, "kind"), n
        if isinstance(g, QTensor):
            assert (g.kind, g.act) == (w.kind, w.act), n
    wav = (np.random.default_rng(4).standard_normal((3, 20480)) * 0.1).astype(np.float32)
    jt, jl = jax_make_transcribe_fn(J_ARCH, JaxDecodeConfig(**DCFG),
                                    use_pallas_mel=True)(jq, jnp.asarray(wav))
    tt, tl = make_transcribe_fn(ARCH, DecodeConfig(**DCFG), device=DEV)(tq, wav)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
