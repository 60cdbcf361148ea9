"""The port's mixed-precision allocation (`quant/mixed.py`) against the JAX
package on `test2l` in f32, the same weights on both sides: for the same
scores the assignments, `avg_bits` and `counts` equal to JAX's; the
applied tree equal to JAX's bit for bit (the quantizers' codes and scales
are, `test_torch_quant.py` / `test_torch_quant4.py`); a config saved and
loaded; the budget and ladder refusals; and a config's leaves served by
the kernels' plain versions (int4 and int8 in one tree decoding JAX's
tokens)."""

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
from openai_whisper_compression_tpu.quant import mixed as jax_mixed
from openai_whisper_compression_tpu.quant.core import QUANTIZERS as JAX_QUANTIZERS
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
from openai_whisper_compression_tpu_torch.models import params as P
from openai_whisper_compression_tpu_torch.ops.qtensor import QTensor
from openai_whisper_compression_tpu_torch.quant import mixed
from openai_whisper_compression_tpu_torch.quant.core import QUANTIZERS

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

J_ARCH, ARCH = JAX_ARCHS["test2l"], ARCHS["test2l"]
_QFIELDS = ("data", "scale", "zero", "scale2", "offset2")


@pytest.fixture(scope="module")
def trees():
    jp = JP.init_params_jit(J_ARCH, jax.random.PRNGKey(0))
    return jp, P.from_numpy(jax.tree.map(np.asarray, jp), device=DEV)


def _scores(jp, seed=0, ties=False):
    """Seeded scores of the linear weights (some left out: they rank least
    important), or scores with ties (which demote the larger leaf first)."""
    rng = np.random.default_rng(seed)
    names = [n for n, _ in jax_mixed.quantizable_leaves(jp)]
    vals = rng.integers(0, 3, len(names)) if ties else rng.random(len(names))
    return {n: float(v) for i, (n, v) in enumerate(zip(names, vals)) if i % 7}


def test_method_bits_are_quantizers():
    assert mixed.METHOD_BITS == jax_mixed.METHOD_BITS
    assert set(mixed.METHOD_BITS) <= set(QUANTIZERS) == set(JAX_QUANTIZERS)
    assert mixed.DEFAULT_LADDER == jax_mixed.DEFAULT_LADDER


@pytest.mark.parametrize("target", [4.0, 5.0, 6.0, 7.5, 8.0])
@pytest.mark.parametrize("ladder", [("int4", "int8"), ("int2", "int4", "int8"),
                                    ("hqq_int3", "nf4", "fp8")])
@pytest.mark.parametrize("ties", [False, True])
def test_config_matches_jax(trees, target, ladder, ties):
    jp, tp = trees
    scores = _scores(jp, seed=int(target * 10), ties=ties)
    want = jax_mixed.generate_quant_config(jp, scores, target, ladder)
    got = mixed.generate_quant_config(tp, scores, target, ladder)
    assert got == want
    assert got["avg_bits"] <= target and sum(got["counts"].values()) == 32


def test_budget_refusals(trees):
    _, tp = trees
    with pytest.raises(ValueError, match="below ladder floor"):
        mixed.generate_quant_config(tp, {}, 3.0)
    with pytest.raises(KeyError, match="unknown ladder method"):
        mixed.generate_quant_config(tp, {}, 6.0, ("int4", "int16"))
    with pytest.raises(ValueError, match="ascending"):
        mixed.generate_quant_config(tp, {}, 6.0, ("int8", "int4"))
    with pytest.raises(ValueError, match="no quantizable"):
        mixed.generate_quant_config({"encoder": {}, "decoder": {}}, {}, 6.0)


def test_apply_matches_jax_and_round_trips(trees, tmp_path):
    """JAX's config applied by the port gives JAX's tree bit for bit, with
    int4 and int8 leaves in one tree; saved and loaded, the same; a config
    of another model refused."""
    jp, tp = trees
    cfg = jax_mixed.generate_quant_config(jp, _scores(jp), 6.0)
    path = mixed.save_quant_config(cfg, str(tmp_path / "mixed.json"))
    loaded = mixed.load_quant_config(path)
    assert loaded == jax_mixed.load_quant_config(path)
    want = jax_mixed.apply_quant_config(jp, cfg)
    got = mixed.apply_quant_config(tp, loaded)
    kinds = set()
    for (gn, g), (wn, w) in zip(P.named_leaves(got), JP.named_leaves(want)):
        assert gn == wn
        if isinstance(g, QTensor):
            assert (g.kind, g.bits, g.shape) == (w.kind, w.bits, tuple(w.shape)), gn
            for f in _QFIELDS:
                if getattr(g, f) is not None:
                    np.testing.assert_array_equal(getattr(g, f).numpy(),
                                                  np.asarray(getattr(w, f)))
            kinds.add(g.kind)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert kinds == {"int4_pack", "int8_pc"}
    with pytest.raises(KeyError, match="absent from params"):
        mixed.apply_quant_config(tp, {"assignments": {"decoder.layers.7.fc1.w": "int4"}})


def test_mixed_tree_decodes_jax_tokens(trees):
    jp, tp = trees
    cfg = jax_mixed.generate_quant_config(jp, _scores(jp, 1), 6.0)
    jq, tq = jax_mixed.apply_quant_config(jp, cfg), mixed.apply_quant_config(tp, cfg)
    dcfg = dict(max_new_tokens=10, kv_int8=True, cross_kv_int8=True)
    wav = (np.random.default_rng(4).standard_normal((3, 20480)) * 0.1).astype(np.float32)
    jt, jl = jax_make_transcribe_fn(J_ARCH, JaxDecodeConfig(**dcfg),
                                    use_pallas_mel=True)(jq, jnp.asarray(wav))
    tt, tl = make_transcribe_fn(ARCH, DecodeConfig(**dcfg), device=DEV)(tq, wav)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
