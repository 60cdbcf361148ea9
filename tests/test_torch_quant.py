"""The port's int8 quantization, fusion and int8 matmul against the JAX
package: quantized bytes and scales bit-identical, the int8 kernel's plain
version against `int8_matmul_pallas` run in interpret mode on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.models.fuse import fuse_qkv as jax_fuse_qkv
from openai_whisper_compression_tpu.ops.quant_matmul import int8_matmul_pallas
from openai_whisper_compression_tpu.quant.api import quantize_params as jax_quantize_params
from openai_whisper_compression_tpu.quant.core import quantize_int8 as jax_quantize_int8
from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
from openai_whisper_compression_tpu_torch.models.params import from_numpy, named_leaves
from openai_whisper_compression_tpu_torch.ops.linear import linear
from openai_whisper_compression_tpu_torch.ops.qtensor import QTensor, dequantize
from openai_whisper_compression_tpu_torch.ops.quant_matmul import (
    int8_matmul, int8_matmul_ref)
from openai_whisper_compression_tpu_torch.quant.api import quantize_params
from openai_whisper_compression_tpu_torch.quant.core import quantize_int8

torch.set_num_threads(2)


def _weights(kind, rng):
    if kind == "normal":
        return (rng.standard_normal((96, 160)) * 0.02).astype(np.float32)
    if kind == "zero_column":
        w = rng.standard_normal((64, 32)).astype(np.float32)
        w[:, 3] = 0.0
        return w
    # exact .5 quotients: round-half-to-even must agree on both sides
    w = np.tile(np.array([[127.0], [0.5], [1.5], [-2.5], [63.5]], np.float32),
                (1, 8))
    return w


@pytest.mark.parametrize("kind", ["normal", "zero_column", "halves"])
def test_quantize_int8_bit_identical(kind):
    w = _weights(kind, np.random.default_rng(0))
    ref = jax_quantize_int8(jnp.asarray(w))
    got = quantize_int8(torch.from_numpy(w))
    assert got.shape == tuple(ref.shape) and got.kind == ref.kind
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    assert got.data.dtype == torch.int8
    np.testing.assert_array_equal(got.scale.numpy().view(np.uint32),
                                  np.asarray(ref.scale).view(np.uint32))


def test_quantize_params_and_fuse_match_jax():
    arch = ARCHS["test2l"]
    jp = JP.init_params_jit(arch, jax.random.PRNGKey(0))
    ref = jax.tree.map(np.asarray, jax_fuse_qkv(jax_quantize_params(jp, "int8")))
    got = fuse_qkv(quantize_params(from_numpy(jax.tree.map(np.asarray, jp)), "int8"))
    ref_leaves = dict(named_leaves(from_numpy(ref)))
    got_leaves = dict(named_leaves(got))
    assert ref_leaves.keys() == got_leaves.keys()
    for name, r in ref_leaves.items():
        g = got_leaves[name]
        if isinstance(r, QTensor):
            assert isinstance(g, QTensor) and g.shape == r.shape, name
            assert torch.equal(g.data, r.data), name
            assert torch.equal(g.scale, r.scale), name
        else:
            assert torch.equal(g, r), name


@pytest.mark.parametrize("m", [3, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_plain_matches_pallas(m, dtype):
    """Same bf16-rounded operands, f32 sums in another order: f32 output
    within 1e-5 relative; bf16 output within one bf16 rounding (2**-8)."""
    rng = np.random.default_rng(m)
    k, n = 128, 192
    x = rng.standard_normal((m, k)).astype(np.float32)
    q = jax_quantize_int8(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32)))
    ref = int8_matmul_pallas(jnp.asarray(x, dtype), q.data, q.scale)
    ref = np.asarray(ref.astype(jnp.float32))
    tdtype = getattr(torch, dtype)
    got = int8_matmul(torch.from_numpy(x).to(tdtype),
                      torch.from_numpy(np.array(q.data)),
                      torch.from_numpy(np.array(q.scale)))
    assert got.dtype == tdtype and got.shape == (m, n)
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())


def test_linear_cpu_takes_the_dequant_path():
    """On the CPU a quantized linear is x @ dequantize(w) + b, as in JAX."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(np.float32))
    q = quantize_int8(torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)))
    b = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    torch.testing.assert_close(linear(x, q, b), x @ dequantize(q) + b,
                               rtol=0, atol=0)
    # the kernel's plain version agrees with that path up to f32 rounding
    torch.testing.assert_close(int8_matmul_ref(x.reshape(6, 64).to(torch.bfloat16)
                                               .float(), q.data, q.scale),
                               x.reshape(6, 64).to(torch.bfloat16).float()
                               @ dequantize(q), rtol=1e-5, atol=1e-5)
