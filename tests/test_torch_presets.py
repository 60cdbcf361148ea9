"""The port's presets, agreement harness and package API against the JAX
package on `test2l`, the same weights on both sides (`init_params_jit`,
carried over by `from_numpy`):

- `sweep/presets.py`: the preset lists and fields; every preset's
  transform on the same tree in the preset's dtype, trees equal bit for bit;
  `Preset.build`'s decode configuration (the tiny-vocabulary rule and
  without it). Whole builds are not compared: `init_params` does not draw
  JAX's random bits.
- `evaluation/agreement.py::model_agreement`: token and top-1 agreement
  equal to JAX's, mean KL and logit relative error within 1e-5, against
  the structured-50 int8 preset and under a pooled cross-KV.
- the package API: `transcribe` (chunked, and `timestamps=True`) with
  result dicts equal to JAX's (floats within 1e-5), `quantize` and `prune`
  (global L1 and a recipe) trees equal, `load_model` shapes and its refusal
  of an `hf=` name found in neither checkpoint cache (nothing is fetched;
  `tests/test_torch_convert.py` holds the loads)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openai_whisper_compression_tpu as jax_pkg
import openai_whisper_compression_tpu_torch as pkg
from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.evaluation.agreement import (
    model_agreement as jax_model_agreement)
from openai_whisper_compression_tpu.evaluation.tokenizer import (
    WordTokenizer as JaxWordTokenizer)
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.prune import recipe as jax_recipe
from openai_whisper_compression_tpu.sweep import presets as jax_presets
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.evaluation.agreement import model_agreement
from openai_whisper_compression_tpu_torch.evaluation.tokenizer import WordTokenizer
from openai_whisper_compression_tpu_torch.models import params as P
from openai_whisper_compression_tpu_torch.prune import recipe
from openai_whisper_compression_tpu_torch.sweep import presets
from test_torch_prune import Unchanged, assert_trees_equal

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

J_ARCH, ARCH = JAX_ARCHS["test2l"], ARCHS["test2l"]
AGREE_ATOL = 1e-5    # mean KL and logit relative error: f32 sums in another order
FLOAT_ATOL = 1e-5    # result floats of `transcribe` (times, logprobs, ratios)
WIN = 2 * 64 * 160   # test2l's window: 64 encoder frames, 20480 samples


def _port(jtree):
    return P.from_numpy(jax.tree.map(np.asarray, jtree), device=DEV)


@pytest.fixture(scope="module")
def trees():
    """(JAX tree, port tree) of test2l, seed 0, f32."""
    jp = JP.init_params_jit(J_ARCH, jax.random.PRNGKey(0))
    return jp, _port(jp)


def _same(got, ref, where="result"):
    """Equal structures: integers and strings exactly, floats within
    FLOAT_ATOL."""
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


# --------------------------------------------------------------------------
# sweep/presets.py
# --------------------------------------------------------------------------

def test_preset_lists_match_jax():
    assert [p.name for p in presets.BASELINE_PRESETS] == [
        p.name for p in jax_presets.BASELINE_PRESETS]
    assert [p.name for p in presets.EXTRA_PRESETS] == [
        p.name for p in jax_presets.EXTRA_PRESETS]
    assert list(presets.PRESETS) == list(jax_presets.PRESETS)
    for name, p in presets.PRESETS.items():
        j = jax_presets.PRESETS[name]
        assert (p.model, p.dtype, p.decode, p.longform) == (
            j.model, j.dtype, j.decode, j.longform), name


@pytest.mark.parametrize("name", list(jax_presets.PRESETS))
def test_preset_transform_matches_jax(trees, name):
    """The preset's transform on test2l in the preset's dtype: the same tree
    in, equal trees out, the input left alone."""
    p, j = presets.PRESETS[name], jax_presets.PRESETS[name]
    jp = JP.tree_cast(trees[0], jnp.dtype(j.dtype))
    tp = _port(jp)
    before = Unchanged(tp)
    assert_trees_equal(p.transform(tp, ARCH), j.transform(jp, J_ARCH))
    before.check()


@pytest.mark.parametrize("name", list(jax_presets.PRESETS))
@pytest.mark.parametrize("vocab", [1000, 51865], ids=["tiny-vocab", "full-vocab"])
def test_preset_build_decode_config_matches_jax(name, vocab, monkeypatch):
    """`Preset.build`'s decode configuration on a test2l-sized model: with
    test2l's vocabulary the language and task tokens are dropped and
    timestamps allowed, as in JAX; with a full vocabulary the preset's own
    switches stand. The tree has the arch's layout in the preset's dtype."""
    from openai_whisper_compression_tpu_torch import config as cfg_mod
    from openai_whisper_compression_tpu import config as jcfg_mod

    arch = ARCH.replace(name="test2l-v", vocab_size=vocab)
    monkeypatch.setitem(cfg_mod.ARCHS, "test2l-v", arch)
    monkeypatch.setitem(jcfg_mod.ARCHS, "test2l-v", J_ARCH.replace(name="test2l-v",
                                                                    vocab_size=vocab))
    params, got_arch, cfg = presets.PRESETS[name].build(arch_override="test2l-v",
                                                         seed=1, device=DEV)
    _, j_arch, jcfg = jax_presets.PRESETS[name].build(arch_override="test2l-v", seed=1)
    assert got_arch == arch and dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert params["decoder"]["embed"].shape == (vocab, ARCH.d_model)
    if presets.PRESETS[name].transform is presets._identity:
        assert params["decoder"]["embed"].dtype == getattr(torch, presets.PRESETS[name].dtype)


# --------------------------------------------------------------------------
# evaluation/agreement.py
# --------------------------------------------------------------------------

def _agreement_case(trees, comp_cfg=None, teacher=False):
    jp, tp = trees
    jc = jax_presets.PRESETS["largev3_structured50_int8"].transform(jp, J_ARCH)
    tc = presets.PRESETS["largev3_structured50_int8"].transform(tp, ARCH)
    mels = np.random.default_rng(3).standard_normal((3, 80, 128)).astype(np.float32)
    teach = (np.random.default_rng(4).integers(0, 990, (3, 6)).astype(np.int32)
             if teacher else None)
    kw = {} if comp_cfg is None else {"comp_cfg": DecodeConfig(**comp_cfg)}
    jkw = {} if comp_cfg is None else {"comp_cfg": JaxDecodeConfig(**comp_cfg)}
    got = model_agreement(tp, tc, ARCH, torch.from_numpy(mels),
                          teacher_tokens=None if teach is None else torch.from_numpy(teach),
                          **kw)
    want = jax_model_agreement(jp, jc, J_ARCH, jnp.asarray(mels),
                               teacher_tokens=None if teach is None else jnp.asarray(teach),
                               **jkw)
    return got, want


@pytest.mark.parametrize("case", ["structured50", "pool2", "teacher"])
def test_model_agreement_matches_jax(trees, case):
    comp_cfg = (dict(max_new_tokens=16, language_token_id=None, task_token_id=None,
                     notimestamps=False, cross_kv_pool=2) if case == "pool2" else None)
    got, want = _agreement_case(trees, comp_cfg, teacher=case == "teacher")
    assert set(got) == set(want)
    assert got["token_agreement"] == want["token_agreement"]
    assert got["top1_agreement"] == want["top1_agreement"]
    for k in ("mean_kl", "logit_rel_err"):
        assert got[k] == pytest.approx(want[k], abs=AGREE_ATOL), k
    assert 0.0 <= got["token_agreement"] <= 1.0 and got["logit_rel_err"] > 0


def test_model_agreement_of_a_tree_with_itself(trees):
    got = model_agreement(trees[1], trees[1], ARCH,
                          torch.zeros(2, 80, 128) + 0.1)
    assert got["token_agreement"] == 1.0 and got["top1_agreement"] == 1.0
    assert got["mean_kl"] == pytest.approx(0.0, abs=1e-7) and got["logit_rel_err"] == 0.0


# --------------------------------------------------------------------------
# The package API
# --------------------------------------------------------------------------

def _wav(seed, n, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(int(n)) * scale).astype(np.float32)


def test_transcribe_chunked_matches_jax(trees):
    jp, tp = trees
    wav = _wav(0, 2.5 * WIN)
    cfg_kw = dict(max_new_tokens=4, language_token_id=None, task_token_id=None)
    got = pkg.transcribe(tp, ARCH, wav, WordTokenizer(1000, special_start=997),
                         DecodeConfig(**cfg_kw), batch_size=2, device=DEV)
    ref = jax_pkg.transcribe(jp, J_ARCH, wav, JaxWordTokenizer(1000, special_start=997),
                             JaxDecodeConfig(**cfg_kw), batch_size=2)
    _same(got, ref)
    assert got["num_chunks"] == 3


def test_transcribe_timestamps_matches_jax():
    """`timestamps=True` takes the seek path with the timestamp rules on
    (test2l with <|notimestamps|> at 900, the JAX seek tests' model)."""
    j_arch = JAX_ARCHS["test2l"].replace(no_timestamps_token_id=900)
    arch = ARCHS["test2l"].replace(no_timestamps_token_id=900)
    jp = JP.init_params_jit(j_arch, jax.random.PRNGKey(21))
    tp = _port(jp)
    wav = _wav(7, 2.3 * WIN)
    cfg_kw = dict(max_new_tokens=6, language_token_id=None, task_token_id=None,
                  max_initial_timestamp_index=20)
    got = pkg.transcribe(tp, arch, wav, WordTokenizer(1000, special_start=897),
                         DecodeConfig(**cfg_kw), timestamps=True, device=DEV)
    ref = jax_pkg.transcribe(jp, j_arch, wav, JaxWordTokenizer(1000, special_start=897),
                             JaxDecodeConfig(**cfg_kw), timestamps=True)
    _same(got, ref)
    assert "segments" in got


def test_transcribe_refusals(trees):
    tp = trees[1]
    with pytest.raises(ValueError, match="task"):
        pkg.transcribe(tp, ARCH, _wav(0, WIN), task="summarize", device=DEV)
    with pytest.raises(ValueError, match="best_of"):
        pkg.transcribe(tp, ARCH, _wav(0, WIN), best_of=2, device=DEV)


@pytest.mark.parametrize("method", ["int8", "int4", "nf4", "fp4", "pytorch_dynamic_int8",
                                    "fp16"])
def test_quantize_matches_jax(trees, method):
    """Bit for bit. HQQ and double-quant are left out: their zeros and
    second-level offsets are f32 means that XLA sums in another order (a
    last bit, or one code, may move; `tests/test_torch_quant4.py` holds
    them to that)."""
    jp, tp = trees
    before = Unchanged(tp)
    assert_trees_equal(pkg.quantize(tp, method), jax_pkg.quantize(jp, method))
    before.check()


def test_prune_matches_jax(trees):
    jp, tp = trees
    before = Unchanged(tp)
    assert_trees_equal(pkg.prune(tp, amount=0.3), jax_pkg.prune(jp, amount=0.3))
    assert_trees_equal(pkg.prune(tp, ARCH, recipe=recipe.INCREASED_RECIPE),
                       jax_pkg.prune(jp, J_ARCH, recipe=jax_recipe.INCREASED_RECIPE))
    assert pkg.prune(tp) is tp
    before.check()
    assert callable(pkg.prune) and pkg._prune_pkg.__name__.endswith(".prune")


def test_load_model_matches_jax_layout(tmp_path, monkeypatch):
    params, arch = pkg.load_model("test2l", seed=3, device=DEV)
    jparams, j_arch = jax_pkg.load_model("test2l", seed=3)
    assert arch == ARCH and j_arch == J_ARCH
    got = {n: (tuple(l.shape), l.dtype) for n, l in P.named_leaves(params)}
    want = {n: tuple(l.shape) for n, l in JP.named_leaves(jparams)}
    assert {n: s for n, (s, _) in got.items()} == want
    assert all(dt == torch.float32 for _, dt in got.values())
    bf, _ = pkg.load_model("test2l", dtype=torch.bfloat16, device=DEV)
    assert bf["decoder"]["embed"].dtype == torch.bfloat16
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    monkeypatch.setenv("WHISPER_TPU_CACHE", str(tmp_path / "npz"))
    monkeypatch.delenv("HF_HOME", raising=False)
    with pytest.raises(FileNotFoundError, match="neither checkpoint cache"):
        pkg.load_model("tiny", hf="openai/whisper-tiny", device=DEV)
