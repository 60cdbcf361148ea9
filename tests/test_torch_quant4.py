"""The port's 4-bit weight kinds against the JAX package: int4/int2
(quanto), NF4/FP4 with and without double-quant (bitsandbytes) and HQQ
int3/int4/int8 group-asym. Quantized codes and scales against the jitted
JAX quantizers, dequantization, each kernel's plain version against its
Pallas kernel run in interpret mode on the CPU, `linear`, `fuse_qkv`,
`quantize_params` by method and by REGISTRY name, and `from_numpy`.

Bounds where the frameworks round differently (measured on these inputs
far inside them): double-quant's second-level scale and offset are means
and maxima over 256 scales summed in another order (within 1e-6
relative); HQQ's zero point comes out of a 20-step solve whose `pow` and
`mean` round differently (within 1e-6 relative for 3 and 4 bits; for 8 bits
at most 1e-5 of a weight's codes may move, by one step, and the zero within
1e-4; over a whole tree of narrow weights, 1e-4 of the codes and the zero
within 1e-3). The port cannot reproduce XLA's summation order: after one
solve step the values averaged are bit-identical, yet about half of the
means differ in the last bit under every order tried (sequential,
pairwise, 2-32 lanes).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.models.fuse import fuse_qkv as jax_fuse_qkv
from openai_whisper_compression_tpu.ops import qtensor as JQ
from openai_whisper_compression_tpu.ops.linear import linear as jax_linear
from openai_whisper_compression_tpu.ops.quant_matmul import (
    group_asym_matmul_pallas, int4_matmul_pallas, nf4_matmul_pallas)
from openai_whisper_compression_tpu.quant import api as jax_api
from openai_whisper_compression_tpu.quant import core as jax_core
from openai_whisper_compression_tpu_torch.models import params as TP
from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
from openai_whisper_compression_tpu_torch.ops import qtensor as TQ
from openai_whisper_compression_tpu_torch.ops.linear import kernel_call, linear
from openai_whisper_compression_tpu_torch.ops.quant_matmul import (
    blockwise4_kernel_ok, group_asym_matmul, int4_matmul, int8_matmul, nf4_matmul)
from openai_whisper_compression_tpu_torch.quant import api as torch_api
from openai_whisper_compression_tpu_torch.quant import core as torch_core

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

WEIGHT_METHODS = ["int4", "int2", "nf4", "fp4", "nf4_dq", "fp4_dq",
                  "hqq_int3", "hqq_int4", "hqq_int8"]
# the weight-only REGISTRY entries (the activation-quantized and fp8 ones are
# held against JAX in test_torch_actquant.py)
PORTED = ["baseline_fp32", "baseline_bf16", "fp16", "quanto_int2",
          "quanto_int4", "quanto_int8", "hqq_int3", "hqq_int4", "hqq_int8",
          "bnb_fp4", "bnb_fp4_double_quant", "bnb_nf4", "bnb_nf4_double_quant",
          "bnb_nf4_bf16_compute"]
# d_model 128 so that every projection holds whole 128-row HQQ int8 groups
ARCH = ARCHS["test2l"].replace(d_model=128, ffn_dim=256)


def _weight(k, n, seed, zero_column=False):
    w = (np.random.default_rng(seed).standard_normal((k, n)) * 0.02).astype(np.float32)
    if zero_column:
        w[:, 3] = 0.0
    return w


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_bits(got, ref, what):
    got, ref = _np(got), _np(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8), what)


def _assert_qtensor_close(got: TQ.QTensor, ref, method: str,
                          zero_rtol8: float = 1e-4) -> int:
    """got (port) against ref (a JAX QTensor) within the module's bounds
    (`zero_rtol8`: HQQ int8's zero); returns the number of codes that
    differ (HQQ int8 only, each by one step; the caller bounds their
    share)."""
    assert (got.kind, got.bits, got.shape, got.block_size) == (
        ref.kind, ref.bits, tuple(ref.shape), ref.block_size), method
    for f in ("scale2", "offset2", "zero"):
        assert (getattr(got, f) is None) == (getattr(ref, f) is None), (method, f)
    moved = 0
    if method == "hqq_int8":
        gd, rd = got.data.numpy().astype(int), np.asarray(ref.data).astype(int)
        assert np.abs(gd - rd).max() <= 1, method
        moved = int((gd != rd).sum())
    else:
        _assert_bits(got.data, ref.data, method)
    if method.endswith("_dq"):
        _assert_bits(got.scale, ref.scale, method)   # the int8 scale codes
        for f in ("scale2", "offset2"):
            np.testing.assert_allclose(_np(getattr(got, f)), _np(getattr(ref, f)),
                                       rtol=1e-6, atol=0, err_msg=f)
    else:
        _assert_bits(got.scale, ref.scale, method)
    if got.zero is not None:
        rtol = zero_rtol8 if method == "hqq_int8" else 1e-6
        np.testing.assert_allclose(got.zero.numpy(), np.asarray(ref.zero),
                                   rtol=rtol, atol=0)
    return moved


@pytest.mark.parametrize("bits", [2, 4])
def test_pack_unpack_match_jax(bits):
    rng = np.random.default_rng(bits)
    lo = -(1 << (bits - 1))
    w = rng.integers(lo, -lo, size=(64, 24)).astype(np.int32)
    packed = TQ.pack_int_sub8(torch.from_numpy(w), bits)
    _assert_bits(packed, JQ.pack_int_sub8(jnp.asarray(w), bits), "pack")
    for signed in (True, False):
        got = TQ.unpack_int_sub8(packed, bits, 64, signed=signed)
        ref = JQ.unpack_int_sub8(jnp.asarray(packed.numpy()), bits, 64, signed=signed)
        _assert_bits(got, ref, f"unpack signed={signed}")
    np.testing.assert_array_equal(TQ.unpack_int_sub8(packed, bits, 64).numpy(), w)


@pytest.mark.parametrize("method", WEIGHT_METHODS)
@pytest.mark.parametrize("shape,zero_column", [((512, 384), False),
                                               ((256, 200), True)])
def test_quantizers_match_jax(method, shape, zero_column):
    """Codes and scales bit-identical to the jitted JAX quantizers; the
    double-quant second level and HQQ zeros within the module's bounds.
    (256, 200): 400 or 800 block scales, not a whole number of 256-groups."""
    w = _weight(*shape, seed=shape[1], zero_column=zero_column)
    ref = jax_core.QUANTIZERS[method](jnp.asarray(w))
    got = torch_core.QUANTIZERS[method](torch.from_numpy(w))
    assert _assert_qtensor_close(got, ref, method) <= 1e-5 * w.size


@pytest.mark.parametrize("method", WEIGHT_METHODS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_matches_jax(method, dtype):
    """From the same stored arrays: f32 within f32 rounding (1e-6 of the
    largest weight: double-quant's multiply-add may fuse on one side); bf16
    computes in bf16 on both sides, within one bf16 step (2**-8)."""
    ref_q = jax_core.QUANTIZERS[method](jnp.asarray(_weight(256, 128, 1)))
    got_q = TP.from_numpy(jax.tree.map(np.asarray, ref_q), device=DEV)
    ref = np.asarray(JQ.dequantize(ref_q, jnp.dtype(dtype)).astype(jnp.float32))
    got = TQ.dequantize(got_q, getattr(torch, dtype)).float().numpy()
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _pallas(q, x, k):
    if q.kind == "int4_pack":
        return int4_matmul_pallas(x, q.data, q.scale, k)
    if q.kind in ("nf4", "fp4"):
        scale = JQ._effective_block_scale(q, jnp.float32)
        return nf4_matmul_pallas(x, q.data, scale, q.kind, k, q.block_size)
    return group_asym_matmul_pallas(x, q.data, q.scale, q.zero, k, q.block_size)


def _plain(q: TQ.QTensor, x: torch.Tensor) -> torch.Tensor:
    """The wrapper `linear` calls for q, on a CPU tensor: its plain
    version."""
    fn, _, args = kernel_call(q)
    return fn(x, *args)


@pytest.mark.parametrize("method", ["int4", "nf4", "fp4_dq", "hqq_int3",
                                    "hqq_int4", "hqq_int8"])
@pytest.mark.parametrize("k,n", [(256, 128), (256, 384), (512, 128), (512, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_kernel_matches_pallas(method, k, n, dtype):
    """Each kernel's plain version against its Pallas kernel (interpret mode)
    for M in {1, 9, 64}: the same bf16-rounded operands and bit-identical
    dequantized weights, f32 sums in another order: f32 output within 1e-5
    of the largest output; bf16 output within one bf16 rounding (2**-8)."""
    ref_q = jax_core.QUANTIZERS[method](jnp.asarray(_weight(k, n, k + n)))
    got_q = TP.from_numpy(jax.tree.map(np.asarray, ref_q), device=DEV)
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    for m in (1, 9, 64):
        x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
        ref = np.asarray(_pallas(ref_q, jnp.asarray(x, dtype), k)
                         .astype(jnp.float32))
        got = _plain(got_q, torch.from_numpy(x).to(getattr(torch, dtype)))
        assert got.dtype == getattr(torch, dtype) and got.shape == (m, n)
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol,
                                   atol=tol * np.abs(ref).max(), err_msg=f"M={m}")


@pytest.mark.parametrize("method", WEIGHT_METHODS)
def test_linear_matches_jax(method):
    """`linear` on the CPU (dequant + matmul, as JAX off the TPU) against
    JAX's, f32, from the same stored arrays: within 1e-5 of the largest
    output (sum order)."""
    rng = np.random.default_rng(7)
    ref_q = jax_core.QUANTIZERS[method](jnp.asarray(_weight(256, 128, 2)))
    got_q = TP.from_numpy(jax.tree.map(np.asarray, ref_q), device=DEV)
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    ref = np.asarray(jax_linear(jnp.asarray(x), ref_q, jnp.asarray(b)))
    got = linear(torch.from_numpy(x), got_q, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_blockwise4_kernel_ok_is_jax_rule():
    from openai_whisper_compression_tpu.ops.quant_matmul import blockwise4_pallas_ok

    for k in (64, 256, 384, 512, 768, 1024, 1280, 4096, 5120):
        for g in (32, 64, 128, 256):
            assert blockwise4_kernel_ok(k, g) == blockwise4_pallas_ok(k, g)


@pytest.mark.parametrize("method", ["int8"] + WEIGHT_METHODS)
@pytest.mark.parametrize("k", [256, 384])
def test_kernel_call_follows_jax_dispatch(method, k):
    """`kernel_call` picks the kernel JAX's `linear` picks on the TPU
    (int2 and the blockwise kinds outside `blockwise4_pallas_ok` take
    dequant + matmul), and the plain version beside it is the wrapper's
    CPU route."""
    from openai_whisper_compression_tpu.ops.quant_matmul import blockwise4_pallas_ok

    q = torch_core.QUANTIZERS[method](torch.from_numpy(_weight(k, 128, k)))
    g = q.block_size
    want = {"int8_pc": int8_matmul, "int4_pack": int4_matmul,
            "int2_pack": None,
            "nf4": nf4_matmul if blockwise4_pallas_ok(k, g) else None,
            "fp4": nf4_matmul if blockwise4_pallas_ok(k, g) else None,
            "group_asym": group_asym_matmul if (
                blockwise4_pallas_ok(k, g) if q.data.shape[0] != k
                else k % g == 0) else None}[q.kind]
    call = kernel_call(q)
    assert (call and call[0]) is want
    if call is not None:
        fn, plain, args = call
        x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, k))
                             .astype(np.float32))
        assert torch.equal(fn(x, *args), plain(x, *args))


def _jax_params(arch=ARCH):
    return JP.init_params_jit(arch, jax.random.PRNGKey(0))


def _leaves(tree):
    return dict(TP.named_leaves(tree))


@pytest.mark.parametrize("method", ["int4", "nf4_dq", "hqq_int4"])
def test_fuse_qkv_matches_jax(method):
    """Fusing the same quantized tree: every field concatenates as JAX's
    does (bit for bit), and JAX's fused tree and the port's have the same
    layers fused."""
    jq = jax_api.quantize_params(_jax_params(), method)
    ref = TP.from_numpy(jax.tree.map(np.asarray, jax_fuse_qkv(jq)), device=DEV)
    got = fuse_qkv(TP.from_numpy(jax.tree.map(np.asarray, jq), device=DEV))
    ref_l, got_l = _leaves(ref), _leaves(got)
    assert ref_l.keys() == got_l.keys()
    assert any(name.endswith("attn.qkv.w") for name in got_l)
    for name, r in ref_l.items():
        g = got_l[name]
        if isinstance(r, TQ.QTensor):
            assert dataclasses.replace(g, **{f: None for f in
                                             ("data", "scale", "zero", "scale2",
                                              "offset2")}) == \
                dataclasses.replace(r, **{f: None for f in
                                          ("data", "scale", "zero", "scale2",
                                           "offset2")}), name
            for a, b in zip(g._tensors(), r._tensors()):
                _assert_bits(a, b, name)
        else:
            _assert_bits(g, r, name)
    # the port's own quantize + fuse agrees within the quantizers' bounds
    own = _leaves(fuse_qkv(torch_api.quantize_params(
        TP.from_numpy(jax.tree.map(np.asarray, _jax_params()), device=DEV), method)))
    for name, r in _leaves(jax.tree.map(np.asarray, jax_fuse_qkv(jq))).items():
        if isinstance(r, JQ.QTensor):
            _assert_qtensor_close(own[name], r, method)


def test_fuse_leaves_mixed_kinds_unfused():
    tp = TP.from_numpy(jax.tree.map(np.asarray, _jax_params()), device=DEV)
    attn = tp["decoder"]["layers"][0]["attn"]
    attn["q"]["w"] = torch_core.quantize_int_sub8(attn["q"]["w"], 4)
    attn["k"]["w"] = torch_core.quantize_int8(attn["k"]["w"])
    tp["decoder"]["layers"][1]["attn"]["v"]["w"] = torch_core.quantize_int8(
        tp["decoder"]["layers"][1]["attn"]["v"]["w"])
    fused = fuse_qkv(tp)
    assert [set(layer["attn"]) for layer in fused["decoder"]["layers"]] == \
        [{"q", "k", "v", "o"}] * 2


@pytest.mark.parametrize("name", PORTED + [m for m in WEIGHT_METHODS
                                            if m not in PORTED])
def test_quantize_params_matches_jax(name):
    """By REGISTRY name and by method name: the same leaves as JAX's, of the
    same kinds and dtypes, within the quantizers' bounds; dense leaves
    (cast by the named configs) bit-identical; the same stored size."""
    jp = _jax_params()
    ref = jax.tree.map(np.asarray, jax_api.quantize_params(jp, name))
    got = torch_api.quantize_params(TP.from_numpy(jax.tree.map(np.asarray, jp), device=DEV), name)
    ref_l, got_l = _leaves(ref), _leaves(got)
    assert ref_l.keys() == got_l.keys()
    method = jax_api.REGISTRY[name].method if name in jax_api.REGISTRY else name
    moved = codes = 0
    for leaf_name, r in ref_l.items():
        g = got_l[leaf_name]
        if isinstance(r, JQ.QTensor):
            assert isinstance(g, TQ.QTensor), leaf_name
            moved += _assert_qtensor_close(g, r, method, zero_rtol8=1e-3)
            codes += r.shape[0] * r.shape[1]
        else:
            assert not isinstance(g, TQ.QTensor), leaf_name
            _assert_bits(g.float() if g.dtype == torch.bfloat16 else g,
                         r.astype(np.float32) if r.dtype.name == "bfloat16" else r,
                         leaf_name)
    # HQQ int8 over a whole tree of narrow weights: 9 of 655,360 codes move
    # (1.4e-5): a code flipped in an early solve step shifts its group's
    # zero by 1/128 of a step (zeros of ~130 then differ by up to 2.2e-4
    # relative), so flips come in clusters and a few narrow weights spread
    # wider than one large one
    assert moved <= 1e-4 * codes, (moved, codes)
    assert TP.size_in_mb(got) == JP.size_in_mb(ref)


def test_registry_names_match_jax():
    assert list(torch_api.REGISTRY) == list(jax_api.REGISTRY)
    for name, cfg in torch_api.REGISTRY.items():
        ref = jax_api.REGISTRY[name]
        assert (cfg.method, cfg.act, cfg.dtype, cfg.needs_calibration,
                cfg.kwargs) == (ref.method, ref.act, ref.dtype,
                                ref.needs_calibration, ref.kwargs)


@pytest.mark.parametrize("method", ["int4", "nf4_dq", "hqq_int4", "hqq_int8"])
def test_from_numpy_carries_every_field(method):
    ref = jax_core.QUANTIZERS[method](jnp.asarray(_weight(256, 128, 3)))
    got = TP.from_numpy(jax.tree.map(np.asarray, ref), device=DEV)
    assert (got.kind, got.bits, got.shape, got.block_size) == (
        ref.kind, ref.bits, tuple(ref.shape), ref.block_size)
    for f in ("data", "scale", "zero", "scale2", "offset2"):
        r = getattr(ref, f)
        if r is None:
            assert getattr(got, f) is None, f
        else:
            _assert_bits(getattr(got, f), r, f)
    assert got.nbytes() == ref.nbytes()
    moved = got.to("cpu")
    assert len(moved._tensors()) == len(got._tensors())
    assert all(torch.equal(a, b) for a, b in zip(moved._tensors(), got._tensors()))


def test_tree_cast_matches_jax():
    jp = jax_api.quantize_params(_jax_params(), "int4")
    ref = jax.tree.map(np.asarray, JP.tree_cast(jp, jnp.bfloat16))
    got = TP.tree_cast(TP.from_numpy(jax.tree.map(np.asarray, jp), device=DEV), torch.bfloat16)
    for name, r in _leaves(ref).items():
        g = _leaves(got)[name]
        if isinstance(r, JQ.QTensor):
            assert g.data.dtype == torch.int8 and g.scale.dtype == torch.float32
        else:
            assert str(g.dtype).split(".")[-1] == r.dtype.name, name
