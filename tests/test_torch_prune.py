"""The port's pruning lab against the JAX package on `test2l` in f32, the
same weights on both sides (`init_params_jit`, carried over by
`from_numpy`): `models/params.py`'s `leaf_count`, `size_in_bytes` and
`get_leaf`; `prune/targeted.py`'s filters and taxonomy; `prune/magnitude.py`
(global and per-module L1, blocks, the positional pruners, the reports;
`prune_random` by its own properties, since torch does not draw JAX's
bits); `prune/recipe.py`; `prune/structured.py` (L2 channels, head scores,
physical and zeroing head pruning, FFN shrinking, MLP removal);
`prune/flops.py`; and test2l's greedy tokens after head pruning, FFN
shrinking, int8 and fused qkv, equal to jitted JAX's.

Masks and trees are equal bit for bit, with two stated exceptions: the L2
and block norms are f32 sums that torch and XLA take in other orders, so an
entry whose norm lies within 1e-6 relative of its threshold may fall the
other way (such entries are named and counted, and none is expected here);
the head scores are held within 1e-6 relative and the dropped heads equal.
Every transform leaves its input tree as it was."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.models import decode as jax_decode
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.models.fuse import fuse_qkv as jax_fuse_qkv
from openai_whisper_compression_tpu.models.whisper import encode as jax_encode
from openai_whisper_compression_tpu.ops.qtensor import QTensor as JaxQTensor
from openai_whisper_compression_tpu.prune import flops as jax_flops
from openai_whisper_compression_tpu.prune import magnitude as jax_mag
from openai_whisper_compression_tpu.prune import recipe as jax_recipe
from openai_whisper_compression_tpu.prune import structured as jax_struct
from openai_whisper_compression_tpu.prune import targeted as jax_targeted
from openai_whisper_compression_tpu.quant.api import quantize_params as jax_quantize
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.models import decode
from openai_whisper_compression_tpu_torch.models import params as P
from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
from openai_whisper_compression_tpu_torch.models.whisper import encode
from openai_whisper_compression_tpu_torch.ops.qtensor import QTensor
from openai_whisper_compression_tpu_torch.prune import flops, magnitude, recipe
from openai_whisper_compression_tpu_torch.prune import structured, targeted
from openai_whisper_compression_tpu_torch.quant.api import quantize_params

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

J_ARCH, ARCH = JAX_ARCHS["test2l"], ARCHS["test2l"]
NORM_RTOL = 1e-6       # f32 norms and scores summed in another order than XLA's
_QFIELDS = ("data", "scale", "zero", "scale2", "offset2", "act_scale")


def _port(jtree):
    return P.from_numpy(jax.tree.map(np.asarray, jtree), device=DEV)


@pytest.fixture(scope="module")
def trees():
    """(JAX tree, port tree) of test2l, seed 0, f32."""
    jp = JP.init_params_jit(J_ARCH, jax.random.PRNGKey(0))
    return jp, _port(jp)


def _np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _t(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def assert_trees_equal(got, ref):
    """Port tree `got` equal to JAX tree `ref`: the same leaf names, every
    array (and every QTensor field) equal bit for bit."""
    g, r = dict(P.named_leaves(got)), dict(JP.named_leaves(ref))
    assert sorted(g) == sorted(r)   # (jax.tree.map sorts dict keys)
    for n, leaf in g.items():
        want = r[n]
        if isinstance(want, JaxQTensor):
            assert isinstance(leaf, QTensor) and leaf.kind == want.kind, n
            assert tuple(leaf.shape) == tuple(want.shape), n
            for f in _QFIELDS:
                a, b = getattr(leaf, f), getattr(want, f)
                assert (a is None) == (b is None), (n, f)
                if a is not None:
                    np.testing.assert_array_equal(_t(a), _np(b), err_msg=f"{n}.{f}")
        else:
            np.testing.assert_array_equal(_t(leaf), _np(want), err_msg=n)


class Unchanged:
    """Snapshot of a port tree's structure and values, to show a transform
    left its input alone."""

    def __init__(self, tree):
        self.tree = tree
        self.leaves = [(n, l, (l.clone() if isinstance(l, torch.Tensor) else
                               {f: getattr(l, f).clone() for f in _QFIELDS
                                if getattr(l, f) is not None}))
                       for n, l in P.named_leaves(tree)]

    def check(self):
        now = P.named_leaves(self.tree)
        assert [n for n, _ in now] == [n for n, _, _ in self.leaves]
        for (n, obj), (_, obj0, copy) in zip(now, self.leaves):
            assert obj is obj0, n
            if isinstance(obj, torch.Tensor):
                assert torch.equal(obj, copy), n
            else:
                assert all(torch.equal(getattr(obj, f), c) for f, c in copy.items()), n


def _near_threshold(values: np.ndarray, thresh: float) -> np.ndarray:
    return np.abs(values - thresh) <= NORM_RTOL * abs(thresh)


# --------------------------------------------------------------------------
# models/params.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("method", [None, "int8", "int4", "nf4", "hqq_int4"])
def test_leaf_count_size_in_bytes_get_leaf(trees, method):
    jp = trees[0] if method is None else jax_quantize(trees[0], method)
    tp = _port(jp)
    assert P.leaf_count(tp) == JP.leaf_count(jp)
    assert P.size_in_bytes(tp) == JP.size_in_bytes(jp)
    assert P.size_in_mb(tp) == JP.size_in_mb(jp)
    for n, _ in JP.named_leaves(jp):
        got, want = P.get_leaf(tp, n), JP.get_leaf(jp, n)
        if isinstance(want, JaxQTensor):
            np.testing.assert_array_equal(_t(got.data), _np(want.data))
        else:
            np.testing.assert_array_equal(_t(got), _np(want))


# --------------------------------------------------------------------------
# prune/targeted.py (a copy)
# --------------------------------------------------------------------------

FILTERS = ["encoder_only", "decoder_only", "self_attn_encoder", "self_attn_decoder",
           "cross_attn_decoder", "ffn_encoder", "ffn_decoder", "conv_layers",
           "token_embeddings", "positional_embeddings", "token_positional_embeddings",
           "qkv_projections_only", "bias_only", "layernorm_only", "proj_out"]


def _names(trees):
    names = [n for n, _ in JP.named_leaves(trees[0])]
    return names + ["encoder.layers.5.fc1.w", "decoder.layers.11.cross.q.w",
                    "decoder.layers.3.attn.qkv.w", "encoder.ln.g", "other"]


@pytest.mark.parametrize("name", FILTERS)
def test_targeted_filters_match_jax(trees, name):
    for n in _names(trees):
        assert getattr(targeted, name)(n) == getattr(jax_targeted, name)(n), n


def test_targeted_layer_filters_and_taxonomy_match_jax(trees):
    names = _names(trees)
    for comp in ("encoder", "decoder"):
        for section in ("early", "middle", "late"):
            for n_layers, window in ((2, 4), (12, 4), (32, 3)):
                f = targeted.layer_section(comp, section, n_layers, window)
                g = jax_targeted.layer_section(comp, section, n_layers, window)
                assert [f(n) for n in names] == [g(n) for n in names]
        for which in ("first", "last"):
            f = targeted.first_last_layer(comp, which, 2)
            g = jax_targeted.first_last_layer(comp, which, 2)
            assert [f(n) for n in names] == [g(n) for n in names]
        f, g = targeted.layers_of(comp, {1, 5}), jax_targeted.layers_of(comp, {1, 5})
        assert [f(n) for n in names] == [g(n) for n in names]
    with pytest.raises(ValueError):
        targeted.layer_section("encoder", "nowhere", 4)
    u = targeted.union(targeted.conv_layers, targeted.bias_only)
    v = jax_targeted.union(jax_targeted.conv_layers, jax_targeted.bias_only)
    assert [u(n) for n in names] == [v(n) for n in names]
    assert [targeted.categorize(n) for n in names] == [jax_targeted.categorize(n)
                                                        for n in names]
    assert [targeted.layer_index(n) for n in names] == [jax_targeted.layer_index(n)
                                                         for n in names]
    assert targeted.LINEAR_RE.pattern == jax_targeted.LINEAR_RE.pattern


# --------------------------------------------------------------------------
# prune/magnitude.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("amount", [0.0, 0.1, 0.5, 0.9])
def test_prune_global_l1_matches_jax(trees, amount):
    jp, tp = trees
    before = Unchanged(tp)
    got = magnitude.prune_global_l1(tp, amount)
    assert_trees_equal(got, jax_mag.prune_global_l1(jp, amount))
    before.check()
    if amount == 0.0:
        assert got is tp


def test_prune_global_l1_with_a_filter_matches_jax(trees):
    jp, tp = trees
    got = magnitude.prune_global_l1(tp, 0.3, name_filter=targeted.union(
        targeted.ffn_decoder, targeted.token_embeddings))
    assert_trees_equal(got, jax_mag.prune_global_l1(jp, 0.3, name_filter=jax_targeted.union(
        jax_targeted.ffn_decoder, jax_targeted.token_embeddings)))


@pytest.mark.parametrize("amount", [0.2, 0.5, 0.95])
def test_prune_per_module_l1_matches_jax(trees, amount):
    jp, tp = trees
    before = Unchanged(tp)
    assert_trees_equal(magnitude.prune_per_module_l1(tp, amount),
                       jax_mag.prune_per_module_l1(jp, amount))
    amounts = {n: 0.1 * (i % 9) for i, (n, _) in enumerate(JP.named_leaves(jp))
               if jax_mag.linear_weights(n)}
    assert_trees_equal(magnitude.prune_per_module_l1(tp, 0.0, amounts=amounts),
                       jax_mag.prune_per_module_l1(jp, 0.0, amounts=amounts))
    before.check()


def test_quantized_leaves_are_skipped(trees):
    """QTensor leaves pass every magnitude pruner untouched, as in JAX."""
    jq = jax_quantize(trees[0], "int8")
    tq = _port(jq)
    for fn, jfn in ((lambda t: magnitude.prune_global_l1(t, 0.5),
                     lambda t: jax_mag.prune_global_l1(t, 0.5)),
                    (lambda t: magnitude.prune_per_module_l1(t, 0.5),
                     lambda t: jax_mag.prune_per_module_l1(t, 0.5)),
                    (lambda t: magnitude.prune_blocks(t, 0.5),
                     lambda t: jax_mag.prune_blocks(t, 0.5))):
        got = fn(tq)
        assert_trees_equal(got, jfn(jq))
        for (n, a), (_, b) in zip(P.named_leaves(got), P.named_leaves(tq)):
            if isinstance(b, QTensor):
                assert a is b, n
    got = magnitude.prune_random(tq, 0.5)
    assert all(a is b for (_, a), (_, b) in zip(P.named_leaves(got), P.named_leaves(tq))
               if isinstance(b, QTensor))


@pytest.mark.parametrize("amount", [0.1, 0.5, 0.8])
def test_prune_random_properties(trees, amount):
    """Each target leaf keeps its values where it is not zeroed; its zeros
    follow Binomial(size, amount) within 5 standard deviations (the leaves
    hold no zeros before); one seed gives one result, two seeds two masks;
    the non-targets are the input's own tensors."""
    tp = trees[1]
    before = Unchanged(tp)
    got = magnitude.prune_random(tp, amount, seed=3)
    again = magnitude.prune_random(tp, amount, seed=3)
    other = magnitude.prune_random(tp, amount, seed=4)
    total = zeros = 0
    for (n, g), (_, a), (_, o), (_, w) in zip(*(P.named_leaves(t) for t in
                                                (got, again, other, tp))):
        if not magnitude.linear_weights(n):
            assert g is w, n
            continue
        assert torch.equal(g, a), n
        kept = g != 0
        assert torch.equal(g[kept], w[kept]) and not bool((w == 0).any()), n
        z, s = int((~kept).sum()), g.numel()
        sd = (s * amount * (1 - amount)) ** 0.5
        assert abs(z - s * amount) <= 5 * sd, (n, z, s)
        assert not torch.equal(g == 0, o == 0), n
        total, zeros = total + s, zeros + z
    assert abs(zeros - total * amount) <= 5 * (total * amount * (1 - amount)) ** 0.5
    before.check()


@pytest.mark.parametrize("amount", [0.25, 0.5])
def test_prune_blocks_matches_jax(trees, amount):
    jp, tp = trees
    before = Unchanged(tp)
    got = magnitude.prune_blocks(tp, amount)
    ref = jax_mag.prune_blocks(jp, amount)
    parted = []
    for (n, g), (_, r), (_, w) in zip(P.named_leaves(got), JP.named_leaves(ref),
                                      P.named_leaves(tp)):
        g, r = _t(g), _np(r)
        if np.array_equal(g, r):
            continue
        wn = w.numpy()
        rows, cols = wn.shape
        norms = np.sqrt((wn.reshape(rows // 4, 4, cols // 4, 4).astype(np.float64) ** 2
                         ).sum(axis=(1, 3)))
        k = int(round(amount * norms.size))
        thresh = np.sort(norms.reshape(-1))[k - 1]
        blocks = np.argwhere((g != r).reshape(rows // 4, 4, cols // 4, 4).any(axis=(1, 3)))
        for bi, bj in blocks:
            assert _near_threshold(norms[bi, bj], thresh), (n, bi, bj)
            parted.append((n, int(bi), int(bj)))
    assert parted == [], f"blocks on the other side of their threshold: {parted}"
    before.check()


@pytest.mark.parametrize("max_amount", [0.0, 0.3, 0.5, 1.0])
def test_prune_positional_progressive_matches_jax(trees, max_amount):
    jp, tp = trees
    before = Unchanged(tp)
    assert_trees_equal(magnitude.prune_positional_progressive(tp, max_amount),
                       jax_mag.prune_positional_progressive(jp, max_amount))
    before.check()


@pytest.mark.parametrize("early,late", [(0.4, 0.2), (0.0, 0.9), (0.7, 0.7)])
def test_prune_positional_position_dependent_matches_jax(trees, early, late):
    jp, tp = trees
    before = Unchanged(tp)
    assert_trees_equal(magnitude.prune_positional_position_dependent(tp, early, late),
                       jax_mag.prune_positional_position_dependent(jp, early, late))
    before.check()


def test_sparsity_reports_match_jax(trees):
    jp, tp = trees
    jpruned = jax_recipe.apply_recipe(jp, J_ARCH)
    tpruned = _port(jpruned)
    for filt in (None, jax_mag.linear_weights):
        assert magnitude.sparsity_report(tpruned, filt) == jax_mag.sparsity_report(
            jpruned, filt)
    assert magnitude.component_sparsity(tpruned) == jax_mag.component_sparsity(jpruned)
    jq = jax_quantize(jpruned, "int8")
    assert magnitude.sparsity_report(_port(jq)) == jax_mag.sparsity_report(jq)
    assert magnitude.component_sparsity(_port(jq)) == jax_mag.component_sparsity(jq)


# --------------------------------------------------------------------------
# prune/recipe.py
# --------------------------------------------------------------------------

def test_recipe_amounts_and_apply_match_jax(trees):
    jp, tp = trees
    assert recipe.DEFAULT_RECIPE == jax_recipe.DEFAULT_RECIPE
    assert recipe.INCREASED_RECIPE == jax_recipe.INCREASED_RECIPE
    for arch_name in ("test2l", "small", "large-v3"):
        for n in _names(trees) + ["decoder.layers.%d.fc1.w" % i for i in range(32)]:
            for rec in (None, recipe.INCREASED_RECIPE):
                assert recipe.determine_pruning_amount(n, ARCHS[arch_name], rec) == \
                    jax_recipe.determine_pruning_amount(n, JAX_ARCHS[arch_name], rec), n
    before = Unchanged(tp)
    for rec in (None, recipe.INCREASED_RECIPE):
        assert_trees_equal(recipe.apply_recipe(tp, ARCH, rec),
                           jax_recipe.apply_recipe(jp, J_ARCH, rec))
    before.check()


# --------------------------------------------------------------------------
# prune/structured.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("amount", [0.25, 0.5])
def test_prune_l2_structured_matches_jax(trees, amount):
    jp, tp = trees
    before = Unchanged(tp)
    got = structured.prune_l2_structured(tp, amount)
    ref = jax_struct.prune_l2_structured(jp, amount)
    parted = []
    for (n, g), (_, r), (_, w) in zip(P.named_leaves(got), JP.named_leaves(ref),
                                      P.named_leaves(tp)):
        g, r = _t(g), _np(r)
        if np.array_equal(g, r):
            continue
        norms = np.sqrt((w.numpy().astype(np.float64) ** 2).sum(axis=0))
        thresh = np.sort(norms)[int(round(amount * norms.size)) - 1]
        for c in np.flatnonzero((g != r).any(axis=0)):
            assert _near_threshold(norms[c], thresh), (n, c)
            parted.append((n, int(c)))
    assert parted == [], f"channels on the other side of their threshold: {parted}"
    before.check()


def test_head_l1_scores_match_jax(trees):
    jp, tp = trees
    for comp, attn in (("encoder", "attn"), ("decoder", "attn"), ("decoder", "cross")):
        for jl, tl in zip(jp[comp]["layers"], tp[comp]["layers"]):
            got = structured.head_l1_scores(tl[attn], ARCH.head_dim).numpy()
            want = np.asarray(jax_struct.head_l1_scores(jl[attn], J_ARCH.head_dim))
            np.testing.assert_allclose(got, want, rtol=NORM_RTOL, atol=0)
            assert list(np.argsort(got)) == list(np.argsort(want))


@pytest.mark.parametrize("physical", [True, False], ids=["physical", "zeroing"])
@pytest.mark.parametrize("amount", [0.25, 0.5, 0.75, 1.0])
def test_prune_heads_by_l1_matches_jax(trees, amount, physical):
    """test2l's 4 heads: 1, 2, 3 dropped per module (never all: 1.0 keeps
    one)."""
    jp, tp = trees
    before = Unchanged(tp)
    got = structured.prune_heads_by_l1(tp, ARCH, amount, physical=physical)
    assert_trees_equal(got, jax_struct.prune_heads_by_l1(jp, J_ARCH, amount,
                                                         physical=physical))
    before.check()
    if physical:
        keep = ARCH.decoder_heads - min(int(round(amount * ARCH.decoder_heads)),
                                        ARCH.decoder_heads - 1)
        assert got["decoder"]["layers"][0]["cross"]["q"]["w"].shape == (
            ARCH.d_model, keep * ARCH.head_dim)


def test_prune_heads_explicit_and_components_match_jax(trees):
    jp, tp = trees
    drop = {"encoder.attn": {0: [1, 3]}, "decoder.cross": {1: [0]}}
    for physical in (True, False):
        assert_trees_equal(structured.prune_heads(tp, ARCH, drop, physical=physical),
                           jax_struct.prune_heads(jp, J_ARCH, drop, physical=physical))
    assert_trees_equal(
        structured.prune_heads_by_l1(tp, ARCH, 0.5, components=("decoder.attn",)),
        jax_struct.prune_heads_by_l1(jp, J_ARCH, 0.5, components=("decoder.attn",)))
    with pytest.raises(ValueError, match="cannot drop all heads"):
        structured.prune_heads(tp, ARCH, {"decoder.attn": {0: [0, 1, 2, 3]}})


def test_zeroing_head_pruning_keeps_a_bf16_weight_bf16(trees):
    """The zeroing mask takes each weight's type: a bf16 tree stays bf16
    (the JAX function's f32 mask turns such a weight into f32), with the
    values JAX computes."""
    jb = JP.tree_cast(trees[0], jnp.bfloat16)
    tb = _port(jb)
    got = structured.prune_heads_by_l1(tb, ARCH, 0.5, physical=False)
    ref = jax_struct.prune_heads_by_l1(jb, J_ARCH, 0.5, physical=False)
    for (n, g), (_, r) in zip(P.named_leaves(got), JP.named_leaves(ref)):
        assert g.dtype == torch.bfloat16, n
        np.testing.assert_array_equal(_t(g), _np(r).astype(np.float32), err_msg=n)


@pytest.mark.parametrize("keep", [0.0, 0.3, 0.5, 0.9, 1.0])
def test_shrink_ffn_matches_jax(trees, keep):
    jp, tp = trees
    before = Unchanged(tp)
    got, ref = tp, jp
    for comp in ("encoder", "decoder"):
        for li in range(2):
            got = structured.shrink_ffn(got, comp, li, keep)
            ref = jax_struct.shrink_ffn(ref, comp, li, keep)
    assert_trees_equal(got, ref)
    before.check()
    n_keep = max(int(round(keep * ARCH.ffn_dim)), 1)
    assert got["encoder"]["layers"][1]["fc2"]["w"].shape == (n_keep, ARCH.d_model)


def test_remove_mlp_and_drop_layers_match_jax(trees):
    jp, tp = trees
    before = Unchanged(tp)
    assert_trees_equal(structured.remove_mlp(tp, "decoder", [1]),
                       jax_struct.remove_mlp(jp, "decoder", [1]))
    assert_trees_equal(structured.drop_layers(tp, "encoder", [0]),
                       jax_struct.drop_layers(jp, "encoder", [0]))
    before.check()


# --------------------------------------------------------------------------
# prune/flops.py
# --------------------------------------------------------------------------

def test_model_gflops_matches_jax(trees):
    jp, tp = trees
    assert flops.DECODER_TOKENS_ASSUMED == jax_flops.DECODER_TOKENS_ASSUMED
    cases = [(tp, jp)]
    jpr = jax_struct.prune_heads_by_l1(jax_mag.prune_global_l1(jp, 0.5), J_ARCH, 0.5)
    jpr = jax_struct.shrink_ffn(jpr, "decoder", 0, 0.5)
    cases.append((_port(jpr), jpr))
    for (t, j) in cases:
        for tokens in (25, 7):
            got = flops.model_gflops(t, ARCH, tokens)
            want = jax_flops.model_gflops(j, J_ARCH, tokens)
            assert got == pytest.approx(want, rel=1e-12)


def test_model_gflops_counts_quantized_linears_dense(trees):
    """A quantized linear counts as dense K x N: the port's count on an int8
    tree (fused qkv too) equals JAX's on the float tree it came from (which
    holds no zero weight); the JAX function leaves quantized linears out."""
    jp, tp = trees
    want = jax_flops.model_gflops(jp, J_ARCH)
    for t in (quantize_params(tp, "int8"), fuse_qkv(quantize_params(tp, "int8"))):
        assert flops.model_gflops(t, ARCH) == pytest.approx(want, rel=1e-12)
    assert jax_flops.model_gflops(jax_quantize(jp, "int8"), J_ARCH)["total_gflops"] < \
        want["total_gflops"]


# --------------------------------------------------------------------------
# The pruned, quantized and fused model: tokens
# --------------------------------------------------------------------------

def _structured(tree, s, heads=0.5, ffn=0.5):
    tree = s.prune_heads_by_l1(tree, ARCH if s is structured else J_ARCH, heads)
    for comp in ("encoder", "decoder"):
        for li in range(2):
            tree = s.shrink_ffn(tree, comp, li, ffn)
    return tree


@pytest.mark.parametrize("switches", [{}, {"kv_int8": True, "cross_kv_int8": True},
                                      {"kv_int8": True, "cross_kv_int4": True}],
                         ids=["fp-kv", "kv8", "ckv4"])
def test_pruned_int8_fused_tokens_match_jax(trees, switches):
    """test2l after `prune_heads_by_l1(0.5)` (2 of 4 heads in every
    attention) and `shrink_ffn(0.5)`, int8 weights, fused decoder qkv:
    greedy tokens and lengths equal to jitted JAX's, over fp, int8 and int8
    self-KV with int4 cross-KV caches."""
    jp, tp = trees
    jq = jax_fuse_qkv(jax_quantize(_structured(jp, jax_struct), "int8"))
    tq = fuse_qkv(quantize_params(_structured(tp, structured), "int8"))
    assert_trees_equal(tq, jq)
    mel = np.random.default_rng(5).standard_normal((3, 80, 128)).astype(np.float32)
    kw = dict(max_new_tokens=8, suppress_tokens=(J_ARCH.eos_token_id,), **switches)
    jcfg = JaxDecodeConfig(**kw)
    jt, jl = jax.jit(lambda p, m: jax_decode.greedy_decode(
        p, J_ARCH, jax_encode(p, J_ARCH, m), jcfg))(jq, jnp.asarray(mel))
    with torch.inference_mode():
        tt, tl = decode.greedy_decode(tq, ARCH, encode(tq, ARCH, torch.from_numpy(mel)),
                                      DecodeConfig(**kw))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
