"""The port's activation-quantized and fp8 configurations against the JAX
package: `quantize_fp8`, the `act` / `act_scale` fields through `from_numpy`,
`w8a8_matmul`'s plain version against the jitted in-model path
(`ops/linear.py::_act_quant_matmul`) and against the Pallas kernel in
interpret mode, every branch of `_act_quant_matmul` for the 8 REGISTRY names
that quantize activations or store fp8 weights, `calibrate_static`,
`dequantize_params`, and greedy tokens on `test2l`.

Bounds, each stated where it is used: the int8 activation codes, the fp8
bytes and the weight scales are bit-identical; the int8 x int8 product is
summed in integers, so an f32 output equals jitted JAX's bit for bit and a
bf16 output too; the branches that contract in bf16 (fp8 activations or fp8
weights) sum f32 products in another order than XLA, 1e-6 of the largest
output for f32 and one bf16 step for bf16 outputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.evaluation.harness import (
    make_transcribe_fn as jax_make_transcribe_fn)
from openai_whisper_compression_tpu.models import cache as jax_cache
from openai_whisper_compression_tpu.models import decode as jax_decode
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.models import whisper as jax_whisper
from openai_whisper_compression_tpu.models.fuse import fuse_qkv as jax_fuse_qkv
from openai_whisper_compression_tpu.ops import qtensor as JQ
from openai_whisper_compression_tpu.ops.linear import linear as jax_linear
from openai_whisper_compression_tpu.ops.quant_matmul import w8a8_matmul_pallas
from openai_whisper_compression_tpu.quant import api as jax_api
from openai_whisper_compression_tpu.quant import core as jax_core
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
from openai_whisper_compression_tpu_torch.models import decode, whisper
from openai_whisper_compression_tpu_torch.models import params as TP
from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
from openai_whisper_compression_tpu_torch.ops import qtensor as TQ
from openai_whisper_compression_tpu_torch.ops.linear import kernel_call, linear
from openai_whisper_compression_tpu_torch.ops.quant_matmul import (
    quantize_act_int8, w8a8_matmul, w8a8_matmul_ref)
from openai_whisper_compression_tpu_torch.quant import api as torch_api
from openai_whisper_compression_tpu_torch.quant import calibrate
from openai_whisper_compression_tpu_torch.quant import core as torch_core

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

ARCH = JAX_ARCHS["test2l"]
N = 20480  # test2l's waveform samples
STD, EOT_TWIN = 0.5, 611   # as tests/test_torch_slice.py: varied tokens, early stops
# the REGISTRY entries that quantize activations or store fp8 weights
ACT_CONFIGS = ["pytorch_dynamic_int8", "static_int8_act_int8",
               "static_int4_act_int8", "static_int8_act_fp8",
               "static_int4_act_fp8", "static_fp8_act_int8", "static_fp8_act_fp8",
               "static_fp8"]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _weight(k, n, seed, zero_column=False):
    w = (np.random.default_rng(seed).standard_normal((k, n)) * 0.02).astype(np.float32)
    if zero_column:
        w[:, 3] = 0.0
    return w


def _np(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.float8_e4m3fn:
            return t.view(torch.uint8).numpy()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    if a.dtype.name == "float8_e4m3fn":
        return a.view(np.uint8)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _assert_bits(got, ref, what=""):
    got, ref = _np(got), _np(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8),
                                  np.atleast_1d(ref).view(np.uint8), what)


def _carry(tree):
    """A JAX tree (QTensors included) as the port's tree."""
    return TP.from_numpy(jax.tree.map(np.asarray, tree), device=DEV)


def _x(m, k, seed, dtype, zero_row=False):
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32) * 1.7
    if zero_row:
        x[1] = 0.0
    jx = jnp.asarray(x).astype(dtype)
    return jx, torch.from_numpy(x).to(TORCH_DTYPES[dtype])


def _bf16_steps(got, ref) -> float:
    """Largest difference of two bf16 tensors in bf16 steps of the
    reference's largest magnitude (a step is 2**-8 of a value's power of 2;
    2**-7 of the value covers it)."""
    got, ref = _np(got), _np(ref)
    return float(np.abs(got - ref).max() / (2.0 ** -7 * np.abs(ref).max()))


# ---------------------------------------------------------------------------
# fp8 weights and the QTensor fields
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n,zero_column", [(256, 96, False), (64, 64, True),
                                             (80, 48, False)])
def test_quantize_fp8_bits_match_jax(k, n, zero_column):
    """fp8 bytes and f32 scales bit-identical to the jitted JAX quantizer's
    (a zero column takes the 1e-12 floor)."""
    w = _weight(k, n, k + n, zero_column)
    ref = jax.jit(jax_core.quantize_fp8)(jnp.asarray(w))
    got = torch_core.quantize_fp8(torch.from_numpy(w))
    assert got.data.dtype == torch.float8_e4m3fn and got.scale.shape == (1, n)
    assert (got.kind, got.bits, got.shape) == (ref.kind, ref.bits, tuple(ref.shape))
    _assert_bits(got.scale, ref.scale, "scale")
    _assert_bits(got.data, ref.data, "data")
    assert got.nbytes() == ref.nbytes()
    assert torch_core.QUANTIZERS["fp8"] is torch_core.quantize_fp8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_cast_and_decode_match_xla(dtype):
    """`.to(torch.float8_e4m3fn)` gives XLA's bytes (round to nearest even)
    on values clipped to +-448 as `_act_quant_matmul` clips them, from f32
    and from bf16, subnormals and ties included; and every byte decodes to
    the same f32."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(100_000).astype(np.float32) * 150,
        np.linspace(-500, 500, 50_001, dtype=np.float32),
        (rng.standard_normal(50_000) * 1e-2).astype(np.float32),
        np.arange(-2 ** 9, 2 ** 9, dtype=np.float32) * 2.0 ** -10])   # subnormals, ties
    jx = jnp.clip(jnp.asarray(x), -448.0, 448.0).astype(dtype)
    ref = jax.jit(lambda a: a.astype(jnp.float8_e4m3fn))(jx)
    tx = torch.clamp(torch.from_numpy(x), -448.0, 448.0).to(TORCH_DTYPES[dtype])
    _assert_bits(tx.to(torch.float8_e4m3fn), ref)
    every = np.arange(256, dtype=np.uint8)
    ref_f = np.asarray(jnp.asarray(every).view(jnp.float8_e4m3fn).astype(jnp.float32))
    got_f = torch.from_numpy(every).view(torch.float8_e4m3fn).float().numpy()
    np.testing.assert_array_equal(got_f, ref_f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_fp8_matches_jax(dtype):
    w = _weight(128, 64, 7)
    ref_q = jax.jit(jax_core.quantize_fp8)(jnp.asarray(w))
    ref = jax.jit(JQ.dequantize, static_argnums=1)(ref_q, jnp.dtype(dtype))
    got = TQ.dequantize(_carry(ref_q), TORCH_DTYPES[dtype])
    _assert_bits(got, ref)


@pytest.mark.parametrize("case", ["dynamic", "static", "static-uncalibrated",
                                  "fp8", "fp8-bytes", "fp8-static-fp8"])
def test_from_numpy_carries_act_and_fp8(case):
    """`act`, `act_scale` and fp8 data (as ml_dtypes' float8_e4m3fn, or as
    its uint8 bytes) carry over; sizes count the activation scale."""
    w = jnp.asarray(_weight(64, 48, 11))
    if case.startswith("fp8"):
        q = jax_core.quantize_fp8(w)
        if case == "fp8-static-fp8":
            q = dataclasses.replace(q, act="static_fp8",
                                    act_scale=jnp.asarray(0.0125, jnp.float32))
    else:
        q = dataclasses.replace(jax_core.quantize_int8(w), act={
            "dynamic": "dynamic_int8"}.get(case, "static_int8"))
        if case == "static":
            q = dataclasses.replace(q, act_scale=jnp.asarray(0.031, jnp.float32))
    leaf = jax.tree.map(np.asarray, q)
    if case == "fp8-bytes":
        leaf = dataclasses.replace(leaf, data=np.asarray(q.data).view(np.uint8))
    got = TP.from_numpy({"w": leaf}, device=DEV)["w"]
    assert (got.kind, got.bits, got.shape, got.act) == (q.kind, q.bits,
                                                        tuple(q.shape), q.act)
    _assert_bits(got.data, q.data, "data")
    _assert_bits(got.scale, q.scale, "scale")
    if q.act_scale is None:
        assert got.act_scale is None
    else:
        assert got.act_scale.dtype == torch.float32 and got.act_scale.dim() == 0
        _assert_bits(got.act_scale, q.act_scale, "act_scale")
    assert got.nbytes() == q.nbytes()
    assert TP.size_in_mb({"w": got}) == JP.size_in_mb({"w": q})
    if q.kind == "fp8":
        assert got.data.dtype == torch.float8_e4m3fn
    # tree_cast leaves the stored arrays of a QTensor alone, as JAX's
    cast = TP.tree_cast({"w": got}, torch.bfloat16)["w"]
    ref_cast = JP.tree_cast({"w": q}, jnp.bfloat16)["w"]
    assert cast.data.dtype == got.data.dtype and cast.scale.dtype == torch.float32
    assert ref_cast.data.dtype == q.data.dtype


def test_qtensor_refuses_unknown_kind_and_mode():
    data, scale = torch.zeros(4, 4, dtype=torch.int8), torch.ones(1, 4)
    with pytest.raises(ValueError, match="kind"):
        TQ.QTensor(data=data, scale=scale, kind="int5")
    with pytest.raises(ValueError, match="activation mode"):
        TQ.QTensor(data=data, scale=scale, act="static_int4")


# ---------------------------------------------------------------------------
# w8a8_matmul's plain version
# ---------------------------------------------------------------------------

def _jax_codes(x, act_scale=None):
    """The int8 activation codes and scales of the JAX in-model path, jitted
    (the expressions of `_act_quant_matmul`)."""
    def f(x, s):
        xf = x.astype(jnp.float32)
        sx = (jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12) / 127.0
              if s is None else s.astype(jnp.float32))
        return jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8), sx
    return jax.jit(f)(x, act_scale)


W8A8_SHAPES = [(48, 128, 256), (5, 80, 48), (1, 3072, 64)]


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", W8A8_SHAPES)
def test_w8a8_ref_matches_jitted_jax(m, k, n, dtype, static):
    """`w8a8_matmul_ref` (what `w8a8_matmul` returns on the CPU) against the
    jitted JAX `linear` on an int8 weight with int8 activations: activation
    codes and scales exact, outputs bit-identical in f32 and in bf16 (integer
    sums have no order; the epilogue multiplies left to right as XLA does).
    K = 80 is no multiple of 128, row 1 is all zero (the 1e-12 floor), and
    the static scale lets some values clip at +-127."""
    jx, tx = _x(m, k, m + k, dtype, zero_row=m > 1)
    jq = jax.jit(jax_core.quantize_int8)(jnp.asarray(_weight(k, n, n)))
    s = 0.031 if static else None
    jq = dataclasses.replace(jq, act="static_int8" if static else "dynamic_int8",
                             act_scale=None if s is None else jnp.asarray(s, jnp.float32))
    tq = _carry(jq)
    ref_codes, ref_sx = _jax_codes(jx, jq.act_scale)
    got_codes, got_sx = quantize_act_int8(tx, tq.act_scale)
    _assert_bits(got_codes, ref_codes, "activation codes")
    _assert_bits(got_sx.reshape(np.asarray(ref_sx).shape), ref_sx, "activation scales")
    if static:
        assert int(np.abs(np.asarray(ref_codes)).max()) == 127
    ref = jax.jit(jax_linear)(jx, jq)
    got = w8a8_matmul_ref(tx, tq.data, tq.scale, tq.act_scale)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (m, n)
    _assert_bits(got, ref, "output")
    _assert_bits(w8a8_matmul(tx, tq.data, tq.scale, tq.act_scale), ref, "wrapper")
    _assert_bits(linear(tx, tq), ref, "linear")


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", W8A8_SHAPES[:2])
def test_w8a8_ref_matches_pallas_interpret(m, k, n, dtype, static):
    """Against `w8a8_matmul_pallas` run in interpret mode on the CPU. The
    Pallas body divides by 127 inside the kernel, where XLA may or may not
    turn the division into the reciprocal multiply the in-model path gets,
    so a row's scale may differ in its last bit and a code on a rounding
    boundary by one step: 2 f32 ulps plus one code step of the row
    (|w| <= 127 over K terms) for f32, one bf16 step more for bf16."""
    jx, tx = _x(m, k, m + k + 1, dtype, zero_row=True)
    wq = np.random.default_rng(n).integers(-127, 128, (k, n)).astype(np.int8)
    sw = (np.random.default_rng(n + 1).random((1, n)) * 1e-2 + 1e-3).astype(np.float32)
    s = jnp.asarray(0.031, jnp.float32) if static else None
    ref = _np(w8a8_matmul_pallas(jx, jnp.asarray(wq), jnp.asarray(sw), act_scale=s))
    got = _np(w8a8_matmul_ref(tx, torch.from_numpy(wq), torch.from_numpy(sw),
                              None if s is None else torch.tensor(0.031)))
    assert got.shape == ref.shape == (m, n)
    if dtype == "float32":
        if not np.array_equal(got, ref):
            sx = _np(quantize_act_int8(tx, None if s is None else torch.tensor(0.031))[1])
            step = np.broadcast_to(sx.reshape(-1, 1) if sx.ndim else sx, (m, 1)) * sw
            assert np.all(np.abs(got - ref) <= 4e-7 * np.abs(ref) + 127 * step)
    else:
        assert _bf16_steps(got, ref) <= 1.0


def test_w8a8_wrapper_counts_only_card_launches():
    x, w, s = torch.ones(3, 32), torch.ones(32, 16, dtype=torch.int8), torch.ones(1, 16)
    before = (w8a8_matmul.launches, w8a8_matmul.launches_static)
    w8a8_matmul(x, w, s)
    w8a8_matmul(x, w, s, torch.tensor(0.5))
    assert before == (w8a8_matmul.launches, w8a8_matmul.launches_static)


# ---------------------------------------------------------------------------
# every branch of _act_quant_matmul, by REGISTRY name
# ---------------------------------------------------------------------------

def _jax_qweight(name, k, n, seed, act_scale):
    cfg = jax_api.REGISTRY[name]
    q = jax.jit(jax_core.QUANTIZERS[cfg.method])(jnp.asarray(_weight(k, n, seed)))
    q = dataclasses.replace(q, act=cfg.act)
    if act_scale is not None and cfg.act in ("static_int8", "static_fp8"):
        q = dataclasses.replace(q, act_scale=jnp.asarray(act_scale, jnp.float32))
    return q


@pytest.mark.parametrize("calibrated", [True, False], ids=["calibrated", "dynamic"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ACT_CONFIGS)
def test_act_quant_linear_matches_jax(name, dtype, calibrated):
    """`linear` on a weight of each of the 8 configurations against the
    jitted JAX `linear`: (B, T, K) activations with a zero row and a bias,
    with a frozen activation scale (small enough that values clip: +-127 or
    +-448 before the fp8 cast) and without one (the dynamic per-row scale),
    without and with a bias.
    The int8 x int8 branches (int8 and int4 weights under int8 activations)
    are bit-identical; the branches that contract in bf16 (fp8 activations,
    fp8 weights) sum their f32 products in another order than XLA: 1e-6 of
    the largest output in f32, one bf16 step in bf16."""
    cfg = jax_api.REGISTRY[name]
    k, n = 128, 96
    scale = {"static_int8": 0.02, "static_fp8": 0.006}.get(cfg.act) if calibrated else None
    jq = _jax_qweight(name, k, n, 3, scale)
    tq = _carry(jq)
    assert tq.act == cfg.act and (tq.act_scale is None) == (jq.act_scale is None)
    jx, tx = _x(2 * 7, k, 5, dtype, zero_row=True)
    jx, tx = jx.reshape(2, 7, k), tx.reshape(2, 7, k)
    ref = jax.jit(jax_linear)(jx, jq)
    got = linear(tx, tq)
    assert got.shape == (2, 7, n) and got.dtype == TORCH_DTYPES[dtype]
    exact = cfg.act in ("dynamic_int8", "static_int8") and cfg.method in ("int8", "int4")
    if exact:
        _assert_bits(got, ref)
    elif dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(ref), rtol=0,
                                   atol=1e-6 * float(np.abs(_np(ref)).max()))
    else:
        assert _bf16_steps(got, ref) <= 1.0
    # with a bias XLA may fuse the last multiply and the add into one rounding
    b = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    ref_b = _np(jax.jit(jax_linear)(jx, jq, jnp.asarray(b)))
    got_b = _np(linear(tx, tq, torch.from_numpy(b)))
    if dtype == "float32":
        np.testing.assert_allclose(got_b, ref_b, rtol=0,
                                   atol=1e-6 * float(np.abs(ref_b).max()))
    else:
        assert _bf16_steps(got_b, ref_b) <= 1.0
    # the kernel map: int8 activations over int8 / int4 codes reach w8a8_matmul
    call = kernel_call(tq)
    if cfg.act is None:
        assert call is None and tq.kind == "fp8"   # fp8 weight-only: dequant + matmul
    elif exact:
        fn, plain, args = call
        assert (fn, plain) == (w8a8_matmul, w8a8_matmul_ref)
        assert args[0].dtype == torch.int8 and args[0].shape == (k, n)
        assert (args[2] is None) == (tq.act_scale is None)
        _assert_bits(plain(tx.reshape(-1, k), *args), got.reshape(-1, n))
    else:
        assert call is None


@pytest.mark.parametrize("name", ACT_CONFIGS)
def test_quantize_params_act_configs_match_jax(name):
    """`quantize_params` by each of the 8 names, through `QuantConfig.apply`
    and `apply_named_config`: the same leaves as JAX's with the same kind,
    activation mode and bytes (these quantizers are bit-identical), dense
    leaves untouched, the same stored size."""
    jp = JP.init_params_jit(ARCH, jax.random.PRNGKey(1), std=0.1)
    ref = jax_api.quantize_params(jp, name)
    tp = _carry(jp)
    got = torch_api.quantize_params(tp, name)
    ref_l = dict(JP.named_leaves(ref))
    got_l = dict(TP.named_leaves(got))
    assert ref_l.keys() == got_l.keys()
    n_q = 0
    for leaf_name, r in ref_l.items():
        g = got_l[leaf_name]
        if isinstance(r, JQ.QTensor):
            assert isinstance(g, TQ.QTensor), leaf_name
            assert (g.kind, g.bits, g.shape, g.act, g.act_scale) == (
                r.kind, r.bits, tuple(r.shape), r.act, None), leaf_name
            _assert_bits(g.data, r.data, leaf_name)
            _assert_bits(g.scale, r.scale, leaf_name)
            n_q += 1
        else:
            assert not isinstance(g, TQ.QTensor), leaf_name
            _assert_bits(g, r, leaf_name)
    assert n_q == 6 * 2 + 10 * 2   # q/k/v/o + fc1/fc2 an encoder layer, cross too a decoder layer
    assert TP.size_in_mb(got) == JP.size_in_mb(ref)
    cfg = torch_api.REGISTRY[name]
    for other in (cfg.apply(tp), torch_api.apply_named_config(tp, name)):
        for leaf_name, g in got_l.items():
            o = dict(TP.named_leaves(other))[leaf_name]
            if isinstance(g, TQ.QTensor):
                assert o.act == g.act and torch.equal(o.data.view(torch.uint8),
                                                      g.data.view(torch.uint8))


def test_quantize_params_act_filter_and_unknown_method():
    """`act=` and `name_filter=` on the quantizing step, as JAX's; an unknown
    method is a KeyError naming what exists."""
    jp = JP.init_params_jit(ARCH, jax.random.PRNGKey(1), std=0.1)
    only_dec = lambda n: n.startswith("decoder")   # noqa: E731
    ref = jax_api.quantize_params(jp, "int4", act="dynamic_int8", name_filter=only_dec)
    got = torch_api.quantize_params(_carry(jp), "int4", act="dynamic_int8",
                                    name_filter=only_dec)
    kinds = lambda leaves, qt: {n: (l.kind, l.act) for n, l in leaves   # noqa: E731
                                if isinstance(l, qt)}
    assert kinds(TP.named_leaves(got), TQ.QTensor) == kinds(JP.named_leaves(ref),
                                                            JQ.QTensor)
    assert all(n.startswith("decoder") for n in kinds(TP.named_leaves(got), TQ.QTensor))
    with pytest.raises(KeyError, match="unknown quant method"):
        torch_api.quantize_params(_carry(jp), "int5")


@pytest.mark.parametrize("name", ["pytorch_dynamic_int8", "static_fp8_act_fp8",
                                  "static_int4_act_int8"])
def test_dequantize_params_matches_jax(name):
    """Every QTensor back to a dense f32 tensor with JAX's bits (codes times
    scale, one rounding); dense leaves pass through."""
    jp = JP.init_params_jit(ARCH, jax.random.PRNGKey(2), std=0.1)
    jq = jax_api.quantize_params(jp, name)
    ref = jax_api.dequantize_params(jq)
    got = torch_api.dequantize_params(_carry(jq))
    ref_l, got_l = dict(JP.named_leaves(ref)), dict(TP.named_leaves(got))
    assert ref_l.keys() == got_l.keys()
    for leaf_name, r in ref_l.items():
        assert isinstance(got_l[leaf_name], torch.Tensor)
        _assert_bits(got_l[leaf_name], r, leaf_name)


@pytest.mark.parametrize("name", ["static_int8_act_int8", "static_fp8"])
def test_fuse_qkv_keeps_activation_mode(name):
    """A fused qkv keeps the first tensor's `act` and `act_scale`, as JAX's
    `dataclasses.replace(t0, ...)`; fp8 weights fuse too."""
    jp = JP.init_params_jit(ARCH, jax.random.PRNGKey(3), std=0.1)
    jq = jax_api.quantize_params(jp, name)
    layer = jq["decoder"]["layers"][0]["attn"]
    for i, proj in enumerate(("q", "k", "v")):
        if layer[proj]["w"].act is not None:
            layer[proj]["w"] = dataclasses.replace(
                layer[proj]["w"], act_scale=jnp.asarray(0.01 * (i + 1), jnp.float32))
    ref = jax_fuse_qkv(jq)["decoder"]["layers"][0]["attn"]["qkv"]["w"]
    got = fuse_qkv(_carry(jq))["decoder"]["layers"][0]["attn"]["qkv"]["w"]
    assert (got.kind, got.shape, got.act) == (ref.kind, tuple(ref.shape), ref.act)
    _assert_bits(got.data, ref.data)
    _assert_bits(got.scale, ref.scale)
    if ref.act_scale is None:
        assert got.act_scale is None
    else:
        _assert_bits(got.act_scale, ref.act_scale)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense_params():
    """The JAX tree before quantization: std 0.5, EOT tied to its twin."""
    p = JP.init_params_jit(ARCH, jax.random.PRNGKey(0), std=STD)
    embed = np.asarray(p["decoder"]["embed"]).copy()
    embed[ARCH.eos_token_id] = 1.3 * embed[EOT_TWIN]
    p["decoder"] = {**p["decoder"], "embed": jnp.asarray(embed)}
    return p


CAL_TOKENS = [[50258, 50259, 50359, 50363, 611, 17, 902],
              [50258, 50259, 50359, 50363, 33, 611, 5]]


def _cal_inputs():
    rng = np.random.default_rng(21)
    mel = rng.standard_normal((2, ARCH.num_mel_bins, 128)).astype(np.float32)
    toks = np.minimum(np.asarray(CAL_TOKENS), ARCH.vocab_size - 1)
    return mel, toks


def _jax_forward(p):
    """Eager JAX forward for calibration: the encoder, the cross-KV, a
    prefill of three positions and three decoder steps on fixed tokens."""
    mel, toks = _cal_inputs()
    enc = jax_whisper.encode(p, ARCH, jnp.asarray(mel))
    kvs = jax_whisper.precompute_cross_kv_t(p, ARCH, enc)
    cache = jax_cache.init_cache(p, ARCH, 2, 64)
    toks = jnp.asarray(toks, jnp.int32)
    cache = jax_decode.prefill(p, ARCH, toks[:, :3], cache, kvs)
    for pos in range(3, 6):
        _, cache = jax_decode.decoder_step(p, ARCH, toks[:, pos], jnp.asarray(pos),
                                           cache, kvs, 64)


def _torch_forward(p):
    from openai_whisper_compression_tpu_torch.models import cache as kv_cache

    arch = ARCHS["test2l"]
    mel, toks = _cal_inputs()
    enc = whisper.encode(p, arch, torch.from_numpy(mel))
    kvs = whisper.precompute_cross_kv_t(p, arch, enc)
    cache = kv_cache.init_cache(p, arch, 2, 64, device=DEV)
    toks = torch.from_numpy(toks).long()
    decode.prefill(p, arch, toks[:, :3], cache, kvs)
    for pos in range(3, 6):
        decode.decoder_step(p, arch, toks[:, pos], pos, cache, kvs)


@pytest.fixture(scope="module")
def calibrated(dense_params):
    """name -> (JAX tree, the same tree carried over, the port's own
    quantize + fuse + calibrate), each calibrated on the same forward."""
    out = {}
    for name in ("static_int8_act_int8", "static_fp8_act_fp8"):
        jq = jax_fuse_qkv(jax_api.quantize_params(dense_params, name))
        jq = jax_api.calibrate_static(jq, _jax_forward)
        own = fuse_qkv(torch_api.quantize_params(_carry(dense_params), name))
        own = torch_api.calibrate_static(own, _torch_forward)
        out[name] = (jq, _carry(jq), own)
    return out


@pytest.mark.parametrize("name", ["static_int8_act_int8", "static_fp8_act_fp8"])
def test_calibrate_static_matches_jax(calibrated, name):
    """The same `act_scale` per tensor as JAX's `calibrate_static` on the
    same eager forward: every quantized leaf is calibrated and positive,
    within 2e-6 relative for int8 activations (the frameworks' f32 layer
    norms and matmuls round their sums differently, and an absmax carries
    that). Under fp8 activations such a last-bit difference can move an
    activation across an fp8 rounding boundary, a step of 2**-4 of its
    value, which the layers behind it carry into their maxima: within 1e-2
    (0.2% was the most seen)."""
    rtol = 2e-6 if name == "static_int8_act_int8" else 1e-2
    jq, _, own = calibrated[name]
    ref_l = {n: l for n, l in JP.named_leaves(jq) if isinstance(l, JQ.QTensor)}
    got_l = {n: l for n, l in TP.named_leaves(own) if isinstance(l, TQ.QTensor)}
    assert ref_l.keys() == got_l.keys() and len(got_l) == 6 * 2 + 8 * 2
    for leaf_name, r in ref_l.items():
        g = got_l[leaf_name]
        assert g.act == r.act and g.act_scale is not None, leaf_name
        assert g.act_scale.dtype == torch.float32 and g.act_scale.dim() == 0
        assert float(g.act_scale) > 0
        np.testing.assert_allclose(float(g.act_scale), float(r.act_scale),
                                   rtol=rtol, err_msg=leaf_name)
    assert not calibrate.active()


def test_freeze_leaves_unobserved_tensors_dynamic():
    """A QTensor that the pass never reached, one that saw only zeros, and
    a dynamic one keep `act_scale` None; an observed static one gets
    absmax / 127 (absmax / 448 for fp8 activations) rounded once."""
    def q(act):
        return dataclasses.replace(torch_core.quantize_int8(torch.from_numpy(
            _weight(32, 16, 1))), act=act)

    tree = {"seen": q("static_int8"), "seen8": q("static_fp8"),
            "unseen": q("static_int8"), "zeros": q("static_int8"),
            "dyn": q("dynamic_int8")}
    x = torch.tensor([[0.5, -3.25] + [0.0] * 30])
    with calibrate.calibration() as store:
        assert calibrate.active()
        for key in ("seen", "seen8", "dyn"):
            linear(x, tree[key])
            linear(x * 0.5, tree[key])       # the maximum over calls is kept
        linear(torch.zeros(1, 32), tree["zeros"])
    assert not calibrate.active()
    frozen = calibrate.freeze(tree, store)
    assert float(frozen["seen"].act_scale) == np.float32(3.25 / 127.0)
    assert float(frozen["seen8"].act_scale) == np.float32(3.25 / 448.0)
    assert all(frozen[k].act_scale is None for k in ("unseen", "zeros", "dyn"))
    assert frozen["seen"].data is tree["seen"].data   # weights are not copied


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def _wav(b=4):
    rng = np.random.default_rng(0)
    amp = np.array([0.01, 0.1, 0.5, 1.0])[:b, None]
    return (rng.standard_normal((b, N)) * amp).astype(np.float32)


@pytest.mark.parametrize("name", ["pytorch_dynamic_int8", "static_int8_act_int8",
                                  "static_fp8_act_fp8"])
def test_actquant_tokens_match_jax(dense_params, calibrated, name):
    """Greedy tokens and lengths on `test2l` (f32, fused qkv, int8 self-KV
    and cross-KV, EOT allowed) equal to the jitted JAX transcription
    function's: from JAX's quantized (and calibrated) tree carried over, and
    from the port's own quantize + fuse + calibrate. Not the latter under
    fp8 activations: its calibrated scales differ from JAX's by up to 0.2%
    (`test_calibrate_static_matches_jax`), which is another model."""
    wav = _wav()
    cfg = dict(max_new_tokens=12, kv_int8=True, cross_kv_int8=True)
    if name in calibrated:
        jp, carried, own = calibrated[name]
    else:
        jp = jax_fuse_qkv(jax_api.quantize_params(dense_params, name))
        carried = _carry(jp)
        own = fuse_qkv(torch_api.quantize_params(_carry(dense_params), name))
    jt, jl = jax_make_transcribe_fn(ARCH, JaxDecodeConfig(**cfg),
                                    use_pallas_mel=True)(jp, jnp.asarray(wav))
    fn = make_transcribe_fn(ARCHS["test2l"], DecodeConfig(**cfg), device=DEV)
    assert len(set(np.asarray(jl).tolist())) > 1   # rows stop at different steps
    for tp in (carried,) if name == "static_fp8_act_fp8" else (carried, own):
        tt, tl = fn(tp, wav)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
