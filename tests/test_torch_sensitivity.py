"""The port's sensitivity package (`sensitivity/{gradient,heads,activation,
recommend,architecture}.py`) against the JAX package on `test2l` in f32,
the same weights on both sides (carried over by `from_numpy`) and the same
seeded batches.

Tolerances: gradient and Fisher scores within 1e-4 relative per leaf
(autograd and XLA sum the backward in other orders); head importances
within 1e-5 absolute (differences of f32 loss sums of ~14); FFN activation
statistics within 1e-6 relative; the recommendation, the architecture
tables and the synthetic batches equal."""

import jax
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.evaluation import data as jax_data
from openai_whisper_compression_tpu.evaluation import tokenizer as jax_tokenizer
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.sensitivity import activation as jax_activation
from openai_whisper_compression_tpu.sensitivity import architecture as jax_architecture
from openai_whisper_compression_tpu.sensitivity import gradient as jax_gradient
from openai_whisper_compression_tpu.sensitivity import heads as jax_heads
from openai_whisper_compression_tpu.sensitivity import recommend as jax_recommend
from openai_whisper_compression_tpu_torch.config import ARCHS
from openai_whisper_compression_tpu_torch.evaluation import tokenizer
from openai_whisper_compression_tpu_torch.models import params as P
from openai_whisper_compression_tpu_torch.quant.api import quantize_params
from openai_whisper_compression_tpu_torch.sensitivity import (activation, architecture,
                                                              gradient, heads, recommend)

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

J_ARCH, ARCH = JAX_ARCHS["test2l"], ARCHS["test2l"]
SCORE_RTOL = 1e-4
HEAD_ATOL = 1e-5
STAT_RTOL = 1e-6


@pytest.fixture(scope="module")
def trees():
    jp = JP.init_params_jit(J_ARCH, jax.random.PRNGKey(0))
    return jp, P.from_numpy(jax.tree.map(np.asarray, jp), device=DEV)


@pytest.fixture(scope="module")
def batches():
    return jax_gradient.make_synthetic_batches(J_ARCH, n_batches=2, batch=2, seq=6, seed=3)


def test_synthetic_batches_equal_jax():
    want = jax_gradient.make_synthetic_batches(J_ARCH, 3, 2, 5, seed=9, mel_frames=40)
    got = gradient.make_synthetic_batches(ARCH, 3, 2, 5, seed=9, mel_frames=40)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("power", [1.0, 2.0])
def test_scores_match_jax(trees, batches, power):
    """mean |grad|^power of every leaf, averaged over the batches (power 2:
    `compute_fisher_sensitivity`); non-zero on every leaf; the input tree
    untouched and no gradient left on it."""
    jp, tp = trees
    want = jax_gradient.compute_sensitivity(jp, J_ARCH, batches, power=power)
    got = (gradient.compute_fisher_sensitivity(tp, ARCH, batches) if power == 2
           else gradient.compute_sensitivity(tp, ARCH, batches))
    assert list(got) == list(want) and len(got) == len(P.named_leaves(tp))
    for name, w in want.items():
        assert got[name] > 0 and abs(got[name] - w) <= SCORE_RTOL * w, (name, got[name], w)
    assert all(not t.requires_grad and t.grad is None for _, t in P.named_leaves(tp))


def test_score_rollups_match_jax(trees, batches):
    """normalize_scores, aggregate and generate_pruning_config over the
    same scores (JAX's) give JAX's dicts."""
    jp, _ = trees
    scores = jax_gradient.compute_sensitivity(jp, J_ARCH, batches)
    assert gradient.normalize_scores(scores) == jax_gradient.normalize_scores(scores)
    assert gradient.aggregate(scores) == jax_gradient.aggregate(scores)
    assert (recommend.generate_pruning_config(scores, ARCH)
            == jax_recommend.generate_pruning_config(scores, J_ARCH))


def test_save_pruning_config(tmp_path):
    cfg = {"recipe": {"encoder_ffn": 0.3}, "model": "test2l"}
    path = recommend.save_pruning_config(cfg, str(tmp_path / "sub" / "cfg.json"))
    import json
    assert json.load(open(path)) == cfg


@pytest.mark.parametrize("kind", ["encoder", "decoder", "cross"])
def test_head_importance_matches_jax(trees, batches, kind):
    jp, tp = trees
    want = jax_heads.head_importance(jp, J_ARCH, batches, kind=kind)
    got = heads.head_importance(tp, ARCH, batches, kind=kind)
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=HEAD_ATOL)
    for amount in (0.25, 0.5, 1.0):
        assert (heads.least_important_heads(want, amount)
                == jax_heads.least_important_heads(want, amount))


def test_ffn_stats_match_jax(trees, batches):
    jp, tp = trees
    want = jax_activation.collect_ffn_stats(jp, J_ARCH, batches)
    got = activation.collect_ffn_stats(tp, ARCH, batches)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert (g["component"], g["layer"]) == (w["component"], w["layer"])
        for f in ("mean_abs", "frac_active"):
            assert abs(g[f] - w[f]) <= STAT_RTOL * abs(w[f]), f
        pu, wu = g["per_unit_mean_abs"], np.asarray(w["per_unit_mean_abs"])
        assert isinstance(pu, np.ndarray) and np.all(np.abs(pu - wu) <= STAT_RTOL * wu)


@pytest.mark.parametrize("keep", [0.3, 0.5])
def test_activation_guided_ffn_prune_matches_jax(trees, batches, keep):
    """The kept units (the most active, in order) and the sliced tree equal
    to JAX's; the input tree untouched."""
    jp, tp = trees
    want = jax_activation.activation_guided_ffn_prune(jp, J_ARCH, batches, keep)
    got = activation.activation_guided_ffn_prune(tp, ARCH, batches, keep)
    assert got["encoder"]["layers"][0]["fc1"]["w"].shape == (64, round(keep * 128))
    assert tp["encoder"]["layers"][0]["fc1"]["w"].shape == (64, 128)
    for (gn, g), (wn, w) in zip(P.named_leaves(got), JP.named_leaves(want)):
        assert gn == wn
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_architecture_tables_match_jax(trees):
    """The per-leaf rows, totals and category shares, the text table and
    the CSV as JAX's, for a dense and a quantized tree."""
    jp, tp = trees
    for jt, tt in ((jp, tp), (quantize_params_jax(jp), quantize_params(tp, "int4"))):
        want, got = jax_architecture.analyze_model(jt), architecture.analyze_model(tt)
        assert got["total_params"] == want["total_params"]
        assert got["by_category"] == want["by_category"]
        assert got["leaves"] == want["leaves"]
        assert architecture.format_table(got) == jax_architecture.format_table(want)
        assert architecture.to_csv(got) == jax_architecture.to_csv(want)


def quantize_params_jax(jp):
    from openai_whisper_compression_tpu.quant.api import quantize_params as jq

    return jq(jp, "int4")


def test_batches_from_dataset_match_jax(trees):
    """Real-utterance batches (a word tokenizer as the stub): tokens and
    labels equal to JAX's, the mel within 1e-4 (the frontends' DFTs)."""
    utts = jax_data.synthetic_dataset(5, seed=2, vocab_size=500, min_dur=0.5, max_dur=1.2)
    want = jax_gradient.batches_from_dataset(
        J_ARCH, utts, jax_tokenizer.WordTokenizer(J_ARCH.vocab_size, special_start=997),
        batch=2, max_seq=6)
    got = gradient.batches_from_dataset(
        ARCH, utts, tokenizer.WordTokenizer(ARCH.vocab_size, special_start=997),
        batch=2, max_seq=6, device=DEV)
    assert len(got) == len(want) == 2
    for (gm, gt, gl), (wm, wt, wl) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gm, np.asarray(wm), atol=1e-4)


def test_kernel_guard_rule():
    """`ops.kernels.refuse_grad`, which every kernel wrapper calls before a
    launch: raises (naming the kernel) on an input that requires grad while
    grad mode is on; passes under no_grad, under inference mode, on inputs
    that do not require grad, and on None and non-tensor arguments."""
    from openai_whisper_compression_tpu_torch.ops import kernels

    x = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="int8_matmul"):
        kernels.refuse_grad("int8_matmul", torch.ones(2), None, 3, x)
    with torch.no_grad():
        kernels.refuse_grad("int8_matmul", x)
    with torch.inference_mode():
        kernels.refuse_grad("int8_matmul", x)
    kernels.refuse_grad("int8_matmul", torch.ones(2), None, 3)
    assert kernels.needs_grad(x) and not kernels.needs_grad(x.detach(), None)


def test_loss_gradient_reaches_every_leaf(trees, batches):
    """The gradient of `nll_loss` reaches every leaf of the tree (no path
    cut): each score is positive, conv stem and positions included."""
    _, tp = trees
    stats = gradient._batch_stats(tp, ARCH, *batches[0], power=1.0)
    assert {"encoder.conv1.w", "encoder.pos", "decoder.pos"} <= set(stats)
    assert all(float(v) > 0 for v in stats.values())
