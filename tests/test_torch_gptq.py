"""The port's GPTQ (`quant/gptq.py`) and the `DATA_AWARE` GPTQ names
against the JAX package on `test2l` in f32 (the same weights on both
sides, carried over by `from_numpy`, and the same calibration mel and
tokens), and the solve at whisper-small's widths against jitted JAX.

Tolerances: Hessians within 1e-5 relative (Frobenius; X^T X summed in
another order). Given JAX's Hessian, the solve's scales are equal bit for
bit (max|w| times the f32 reciprocal of qmax, as XLA compiles the jitted
division), and its codes equal but for at most 0.1% that differ by exactly
one: the inverse Hessians of torch and XLA differ by up to ~1e-4 relative
at the conditioning of test2l's Hessians (damped condition numbers up to
6e3), and a value near a rounding midpoint can fall either way. At 2 bits
a flipped code moves a whole step (max|w|) of error onto the rows after
it, so one flip cascades: there the 0.1% holds over the tree, not per
weight. The GPTQ objective tr((W - Ŵ)^T H (W - Ŵ)) is never above JAX's by
more than 1e-4 relative (where codes differ, the port's was lower, up to
8.7%), equal to it within 1e-4 where the codes are equal, and below
round-to-nearest's. A Hessian whose Cholesky fails falls back to JAX's RTN
bit for bit (an eager true division there). The row loop alone is held
bit for bit: fed the factor U that JAX's solve computes, the port's
`_quantize_rows` gives JAX's codes at every width and bit count, so the
flips above come from the f32 inverse alone."""

import functools

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
from openai_whisper_compression_tpu.ops.qtensor import unpack_int_sub8 as jax_unpack
from openai_whisper_compression_tpu.quant import api as jax_api
from openai_whisper_compression_tpu.quant import gptq as jax_gptq
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
from openai_whisper_compression_tpu_torch.models import params as P
from openai_whisper_compression_tpu_torch.models import whisper
from openai_whisper_compression_tpu_torch.ops import linear
from openai_whisper_compression_tpu_torch.ops.qtensor import QTensor, unpack_int_sub8
from openai_whisper_compression_tpu_torch.quant import api, gptq

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

J_ARCH, ARCH = JAX_ARCHS["test2l"], ARCHS["test2l"]
H_RTOL = 1e-5
CODE_FLIPS = 1e-3
OBJ_RTOL = 1e-4


@pytest.fixture(scope="module")
def trees():
    jp = JP.init_params_jit(J_ARCH, jax.random.PRNGKey(0))
    return jp, P.from_numpy(jax.tree.map(np.asarray, jp), device=DEV)


def _cal_inputs():
    rng = np.random.default_rng(11)
    mel = (rng.standard_normal((3, 80, 2 * J_ARCH.max_source_positions))
           ).astype(np.float32)
    return mel, rng.integers(0, J_ARCH.vocab_size, (3, 8))


def jax_run_cal(p):
    mel, tok = _cal_inputs()
    jax_whisper.forward(p, J_ARCH, jnp.asarray(mel), jnp.asarray(tok, jnp.int32))


def torch_run_cal(p):
    mel, tok = _cal_inputs()
    return whisper.forward(p, ARCH, torch.from_numpy(mel), torch.from_numpy(tok))


@pytest.fixture(scope="module")
def hessians(trees):
    jp, tp = trees
    return (jax_gptq.collect_hessians(jp, jax_run_cal),
            gptq.collect_hessians(tp, torch_run_cal))


def test_hessians_match_jax(hessians):
    jh, th = hessians
    assert set(th) == set(jh) and len(th) == 6 * 2 + 10 * 2
    for name, want in jh.items():
        got = th[name]
        assert got.dtype == torch.float32 and got.shape == want.shape
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel <= H_RTOL, (name, rel)
    assert linear._TAP is None


def test_hessian_tap_filters_and_restores(trees):
    """`name_filter` narrows the tapped weights; a QTensor weight has no
    Hessian; the tap is unset even when the calibration raises."""
    _, tp = trees
    only = gptq.collect_hessians(tp, torch_run_cal, name_filter=lambda n: ".fc1." in n)
    assert sorted(only) == sorted(n for n, _ in P.named_leaves(tp) if n.endswith("fc1.w"))
    q = api.quantize_params(tp, "int8", name_filter=lambda n: n.startswith("encoder."))
    assert all(n.startswith("decoder.") for n in gptq.collect_hessians(q, torch_run_cal))

    def boom(p):
        raise RuntimeError("calibration failed")

    with pytest.raises(RuntimeError):
        gptq.collect_hessians(tp, boom)
    assert linear._TAP is None


def _objective(w, q, scale, h):
    e = np.asarray(w, np.float64) - np.asarray(q, np.float64) * np.asarray(scale, np.float64)
    return float(np.einsum("ij,ik,kj->", e, np.asarray(h, np.float64), e))


def _check_solve(w, h, bits, damp=0.01):
    """The port's solve against jitted JAX's on the same w and Hessian:
    returns (codes that differ, the largest difference, codes)."""
    jq, js, jok = jax_gptq.gptq_solve(jnp.asarray(w), jnp.asarray(h), bits=bits, damp=damp)
    tq, ts, tok = gptq.gptq_solve(torch.from_numpy(w), torch.from_numpy(np.asarray(h)),
                                  bits=bits, damp=damp)
    assert bool(tok) == bool(jok)
    assert ts.dtype == torch.float32 and tq.dtype == torch.int8
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    diff = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32))
    o_t, o_j = _objective(w, tq.numpy(), ts.numpy(), h), _objective(w, jq, js, h)
    qmax = 2 ** (bits - 1) - 1
    rtn = np.clip(np.round(w / np.asarray(js)), -qmax, qmax)
    assert o_t <= (1 + OBJ_RTOL) * o_j, (o_t, o_j)
    assert diff.any() or abs(o_t - o_j) <= OBJ_RTOL * o_j, (o_t, o_j)
    assert o_t < _objective(w, rtn, js, h)
    return int((diff > 0).sum()), int(diff.max()), diff.size


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_solve_matches_jax_on_test2l(trees, hessians, bits):
    """Every linear weight of test2l with JAX's own Hessian."""
    jp, _ = trees
    jh, _ = hessians
    leaves = dict(JP.named_leaves(jp))
    flips = total = 0
    for name, h in jh.items():
        n, most, size = _check_solve(np.asarray(leaves[name]), h, bits)
        if bits > 2:
            assert most <= 1 and n <= CODE_FLIPS * size, (name, n, most)
        flips, total = flips + n, total + size
    print(f"int{bits}: {flips} of {total} codes differ")
    assert flips <= CODE_FLIPS * total


@pytest.mark.parametrize("k,n,bits", [(768, 768, 4), (768, 384, 8), (1536, 256, 4)])
def test_solve_matches_jax_at_width(k, n, bits):
    """Whisper-small's and -tiny's depths, a Hessian of 2048 seeded rows
    with a dead input dim (never activated: its diagonal pinned)."""
    rng = np.random.default_rng(k + n)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    x = rng.standard_normal((2048, k)).astype(np.float32)
    x[:, 5] = 0.0
    n, most, size = _check_solve(w, x.T @ x, bits)
    assert most <= 1 and n <= CODE_FLIPS * size, (n, most)


@jax.jit
def _jax_factor(hessian, damp=0.01):
    """U as JAX's `gptq_solve` computes it (damping, dead dims pinned,
    `jnp.linalg.inv`, symmetrised, `jnp.linalg.cholesky(...).T`)."""
    k = hessian.shape[0]
    h = hessian.astype(jnp.float32)
    diag = jnp.diag(h)
    mean_diag = jnp.maximum(jnp.mean(diag), 1e-8)
    h = h + jnp.eye(k, dtype=jnp.float32) * (damp * mean_diag)
    h = jnp.where(jnp.eye(k, dtype=bool) & (diag <= 0)[None, :].T, mean_diag, h)
    hinv = jnp.linalg.inv(h)
    return jnp.linalg.cholesky((hinv + hinv.T) * 0.5).T


def _loop_on_jax_factor(w, h, bits):
    """(the port's row loop on JAX's U, JAX's solve) codes of one weight."""
    jq, js, jok = jax_gptq.gptq_solve(jnp.asarray(w), jnp.asarray(h), bits=bits)
    assert bool(jok)
    u = torch.from_numpy(np.asarray(_jax_factor(jnp.asarray(h))))
    tq = gptq._quantize_rows(torch.from_numpy(np.asarray(w)),
                             torch.from_numpy(np.asarray(js)), u, 2 ** (bits - 1) - 1)
    return tq.numpy(), np.asarray(jq)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_row_loop_equals_jax_on_jax_factor_test2l(trees, hessians, bits):
    """The port's row loop, given the factor JAX's solve computes, gives
    JAX's codes bit for bit on every linear of test2l under its own
    (ill-conditioned) Hessians: the solve's code flips (`CODE_FLIPS`) come
    from the f32 inverse alone, not from the loop."""
    jp, _ = trees
    jh, _ = hessians
    leaves = dict(JP.named_leaves(jp))
    for name, h in jh.items():
        got, want = _loop_on_jax_factor(np.asarray(leaves[name]), h, bits)
        np.testing.assert_array_equal(got, want, err_msg=name)


@functools.lru_cache(maxsize=1)
def _small_problem(k, n):
    """A seeded (K, N) weight and a Hessian of 4096 seeded rows with a dead
    input dim (never activated)."""
    rng = np.random.default_rng(k + n)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    x = rng.standard_normal((4096, k)).astype(np.float32)
    x[:, 5] = 0.0
    return w, x.T @ x


@pytest.mark.parametrize("k,n,bits", [(768, 768, 2), (768, 768, 4), (768, 768, 8),
                                      (768, 3072, 2), (768, 3072, 4), (768, 3072, 8),
                                      (3072, 768, 4)])
def test_row_loop_equals_jax_on_jax_factor_small(k, n, bits):
    """The same at whisper-small's linear widths (qkv / out and fc1 at each
    bit width, fc2's K = 3072 at 4 bits)."""
    got, want = _loop_on_jax_factor(*_small_problem(k, n), bits)
    np.testing.assert_array_equal(got, want)


def test_nan_hessian_falls_back_to_jax_rtn():
    """A Hessian the Cholesky cannot take (NaN): `quantize_gptq` retries at
    10x and 100x the damping, then rounds to nearest, equal to JAX's."""
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((64, 48)) * 0.05).astype(np.float32)
    h = np.full((64, 64), np.nan, np.float32)
    for bits in (2, 4, 8):
        jq = jax_gptq.quantize_gptq(jnp.asarray(w), h, bits=bits)
        tq = gptq.quantize_gptq(torch.from_numpy(w), torch.from_numpy(h), bits=bits)
        assert tq.kind == jq.kind and tq.bits == jq.bits and tq.shape == tuple(jq.shape)
        np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
        np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert not bool(gptq.gptq_solve(torch.from_numpy(w), torch.from_numpy(h))[2])


def _codes(q):
    data = q.data.numpy() if isinstance(q, QTensor) else np.asarray(q.data)
    if q.kind == "int8_pc":
        return data.astype(np.int32)
    unpack = (lambda d: unpack_int_sub8(torch.from_numpy(d), q.bits, q.shape[0]).numpy()
              ) if isinstance(q, QTensor) else (
        lambda d: np.asarray(jax_unpack(jnp.asarray(d), q.bits, q.shape[0])))
    return unpack(data).astype(np.int32)


@pytest.mark.parametrize("bits", [4, 8])
def test_gptq_quantize_params_matches_jax(trees, bits):
    """The whole-tree pass, each side with its own Hessians: every linear
    weight quantized into JAX's kind, scales equal, codes within the
    solve's criterion over the tree (the Hessians' own 1e-5 difference
    adds flips to a weight: up to 0.16% of test2l's fc2 at 8 bits); the
    rest of the tree (and the input tree) untouched."""
    jp, tp = trees
    jq = jax_gptq.gptq_quantize_params(jp, jax_run_cal, bits=bits)
    before = {n: t.clone() for n, t in P.named_leaves(tp)}
    tq = gptq.gptq_quantize_params(tp, torch_run_cal, bits=bits)
    assert all(torch.equal(t, before[n]) for n, t in P.named_leaves(tp))
    jl = dict(JP.named_leaves(jq))
    n_q = flips = total = 0
    for name, got in P.named_leaves(tq):
        want = jl[name]
        if isinstance(got, QTensor):
            assert got.kind == want.kind and got.shape == tuple(want.shape), name
            np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
            diff = np.abs(_codes(got) - _codes(want))
            assert diff.max() <= 1, name
            n_q, flips, total = n_q + 1, flips + int((diff > 0).sum()), total + diff.size
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert n_q == 6 * 2 + 10 * 2
    print(f"int{bits}: {flips} of {total} codes differ")
    assert flips <= CODE_FLIPS * total


DCFG = dict(max_new_tokens=10, kv_int8=True, cross_kv_int8=True)


def _wav(b=3):
    return (np.random.default_rng(4).standard_normal((b, 20480)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("name", ["gptq_int2", "gptq_int4", "gptq_int8"])
def test_data_aware_gptq_decodes_jax_tokens(trees, name):
    """`quantize_data_aware` end to end: greedy tokens (int8 caches) equal
    to JAX's transcription of its own GPTQ tree."""
    jp, tp = trees
    jq = jax_api.quantize_data_aware(jp, J_ARCH, name, jax_run_cal)
    tq = api.quantize_data_aware(tp, ARCH, name, torch_run_cal)
    assert sorted(api.DATA_AWARE) == sorted(jax_api.DATA_AWARE)
    wav = _wav()
    jt, jl = jax_make_transcribe_fn(J_ARCH, JaxDecodeConfig(**DCFG),
                                    use_pallas_mel=True)(jq, jnp.asarray(wav))
    tt, tl = make_transcribe_fn(ARCH, DecodeConfig(**DCFG), device=DEV)(tq, wav)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_quantize_data_aware_rejects_unknown_names(trees):
    with pytest.raises(KeyError, match="gptq_int4"):
        api.quantize_data_aware(trees[1], ARCH, "gptq_int5", torch_run_cal)
