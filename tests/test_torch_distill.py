"""The port's recovery distillation (`distill.py`) and quantization-aware
training (`quant/qat.py`) against the JAX package on `test2l` in f32: the
same weights on both sides (carried over by `from_numpy`), a student
magnitude-pruned by JAX's pruner, the same seeded synthetic batches.

Tolerances: the loss history of 3 steps within 1e-4 relative or 1e-6
absolute (the KL of a half-pruned student is ~1.5e-3, a difference of two
log-softmaxes over 1000 classes whose f32 rounding alone is ~5e-7), the
parameters after them within 1e-4 relative, each leaf's Frobenius norm (the
mel frontends, autograd's and XLA's sums and the two AdamW updates round
apart), pruned zeros exactly zero; the straight-through fake quantization's
forward bit-equal to `dequantize(quantize(w))` and its gradient exactly
the identity. QAT's quantized result: scales (max|w| / 7 of the latent weights) within
the parameters' 1e-4, codes equal but for values at a rounding midpoint
(at most 0.1%, each by one step)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu import distill as jax_distill
from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.ops.qtensor import dequantize as jax_dequantize
from openai_whisper_compression_tpu.prune import magnitude as jax_mag
from openai_whisper_compression_tpu.quant import api as jax_api
from openai_whisper_compression_tpu.quant import qat as jax_qat
from openai_whisper_compression_tpu_torch import distill
from openai_whisper_compression_tpu_torch.config import ARCHS
from openai_whisper_compression_tpu_torch.models import params as P
from openai_whisper_compression_tpu_torch.ops.qtensor import QTensor, dequantize
from openai_whisper_compression_tpu_torch.quant import api, qat
from openai_whisper_compression_tpu_torch.quant.core import QUANTIZERS

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

J_ARCH, ARCH = JAX_ARCHS["test2l"], ARCHS["test2l"]
LOSS_RTOL = 1e-4
LOSS_ATOL = 1e-6
PARAM_RTOL = 1e-4
STEPS = 3


def _port(jtree):
    return P.from_numpy(jax.tree.map(np.asarray, jtree), device=DEV)


@pytest.fixture(scope="module")
def trees():
    """(JAX teacher, JAX student pruned 50%, port teacher, port student)."""
    jt = JP.init_params_jit(J_ARCH, jax.random.PRNGKey(0))
    js = jax_mag.prune_global_l1(jt, 0.5)
    return jt, js, _port(jt), _port(js)


def _assert_params_close(got, want, rtol=PARAM_RTOL):
    """Each leaf within rtol relative (Frobenius). Elementwise the two can
    part by up to 2 lr a step where a gradient is within eps of zero: Adam
    turns its sign into a whole step."""
    for (gn, g), (wn, w) in zip(P.named_leaves(got), JP.named_leaves(want)):
        assert gn == wn
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and g.shape == w.shape, gn
        assert np.linalg.norm(g.numpy() - w) <= rtol * np.linalg.norm(w), gn


def test_sparsity_masks_equal_jax(trees):
    _, js, _, ts = trees
    want, got = jax_distill.sparsity_masks(js), distill.sparsity_masks(ts)
    wl = dict(JP.named_leaves(want))
    gl = dict(P.named_leaves(got))
    assert set(gl) == {n for n, v in wl.items()} | set(gl)
    for name, m in P.named_leaves(got):
        w = wl.get(name)
        if m is None:
            assert w is None, name
        else:
            np.testing.assert_array_equal(m.numpy(), np.asarray(w))


def test_kl_loss_matches_jax(trees):
    jt, js, tt, ts = trees
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 80, 128)).astype(np.float32)
    tok = rng.integers(0, 1000, (2, 5))
    logits = rng.standard_normal((2, 5, 1000)).astype(np.float32) * 3
    want = float(jax_distill.kl_loss(js, jnp.asarray(logits), J_ARCH, jnp.asarray(mel),
                                     jnp.asarray(tok, jnp.int32)))
    got = float(distill.kl_loss(ts, torch.from_numpy(logits), ARCH, torch.from_numpy(mel),
                                torch.from_numpy(tok)))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.fixture(scope="module")
def distilled(trees):
    jt, js, tt, ts = trees
    return (jax_distill.distill(js, jt, J_ARCH, steps=STEPS, lr=1e-3, seed=2),
            distill.distill(ts, tt, ARCH, steps=STEPS, lr=1e-3, seed=2))


def test_distill_matches_jax(trees, distilled):
    """3 steps on the synthetic batches (noise through the mel frontend):
    losses and parameters within tolerance, the pruned zeros exactly zero,
    the input trees untouched; every step moved the weights."""
    _, js, _, ts = trees
    (jout, jh), (tout, th) = distilled
    assert len(th) == len(jh) == STEPS and all(isinstance(x, float) for x in th)
    np.testing.assert_allclose(th, jh, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    _assert_params_close(tout, jout)
    for (n, got), (_, before) in zip(P.named_leaves(tout), P.named_leaves(ts)):
        if before.dim() >= 2:
            assert torch.equal(got == 0, before == 0) or not bool((before == 0).any()), n
            assert bool((got[before == 0] == 0).all()), n
        assert not got.requires_grad
    w0 = ts["encoder"]["layers"][0]["fc1"]["w"]
    assert not torch.equal(tout["encoder"]["layers"][0]["fc1"]["w"], w0)
    np.testing.assert_array_equal(w0.numpy(), np.asarray(js["encoder"]["layers"][0]["fc1"]["w"]))


def test_distill_options(trees):
    """batch_fn with precomputed teacher logits (no teacher forward),
    compute_dtype f32 for a bf16 student (returned in bf16), sparsity_ref,
    and the refusal of a quantized student."""
    jt, js, tt, ts = trees
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((2, 80, 128)).astype(np.float32)
    tok = rng.integers(0, 1000, (2, 4))
    t_logits = np.asarray(jax.jit(lambda p, m, t: jax_distill.decode_logits(
        p, J_ARCH, t, jax_distill.encode(p, J_ARCH, m)))(jt, jnp.asarray(mel),
                                                         jnp.asarray(tok, jnp.int32)))
    fn = lambda r: (mel, tok, t_logits)  # noqa: E731
    jout, jh = jax_distill.distill(js, None, J_ARCH, steps=2, lr=1e-3, batch_fn=fn)
    tout, th = distill.distill(ts, None, ARCH, steps=2, lr=1e-3, batch_fn=fn)
    np.testing.assert_allclose(th, jh, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    _assert_params_close(tout, jout)
    half, hist = distill.distill(P.tree_cast(ts, torch.bfloat16), tt, ARCH, steps=1,
                                 compute_dtype=torch.float32, sparsity_ref=ts)
    assert all(t.dtype == torch.bfloat16 for _, t in P.named_leaves(half)) and len(hist) == 1
    with pytest.raises(ValueError, match="quantized leaves"):
        distill.distill(api.quantize_params(ts, "int8"), tt, ARCH, steps=1)


@pytest.mark.parametrize("method", ["int8", "int4", "nf4", "hqq_int4", "quanto_int2"])
def test_ste_forward_and_gradient(method):
    """Forward bit-equal to dequantize(quantize(w)); gradient exactly the
    identity; the same values as JAX's fake quantization."""
    rng = np.random.default_rng(7)
    w_np = (rng.standard_normal((128, 48)) * 0.05).astype(np.float32)
    w = torch.from_numpy(w_np).requires_grad_(True)
    name, kw = qat.resolve_method(method, {})
    fq = qat.ste_fake_quant(w, method)
    assert torch.equal(fq.detach(), dequantize(QUANTIZERS[name](w.detach(), **kw)))
    g = torch.from_numpy(rng.standard_normal((128, 48)).astype(np.float32))
    (grad,) = torch.autograd.grad(fq, w, g)
    assert torch.equal(grad, g)
    want = np.asarray(jax_qat.ste_fake_quant(jnp.asarray(w_np), method))
    np.testing.assert_allclose(fq.detach().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(w_np).max())


def test_resolve_method_and_transform(trees):
    _, _, _, ts = trees
    assert qat.resolve_method("quanto_int4", {}) == jax_qat.resolve_method("quanto_int4", {})
    assert qat.QAT_METHODS == jax_qat.QAT_METHODS
    with pytest.raises(KeyError, match="non-weight-quant"):
        qat.resolve_method("baseline_fp32", {})
    names = qat.quantized_leaf_names(ts, include_embed=True)
    assert "decoder.embed" in names and len(names) == 33
    out = qat.make_ste_transform(ts, "int8", name_filter=lambda n: "fc1" in n)(ts)
    for n, t in P.named_leaves(out):
        assert torch.equal(t, P.get_leaf(ts, n)) == (not n.endswith("fc1.w")), n


def _qcodes(q):
    return (q.data.numpy() if isinstance(q, QTensor) else np.asarray(q.data)).astype(np.int32)


def test_qat_distill_matches_jax(trees):
    """QAT int4 from the pruned student, 3 steps: the history within
    tolerance; the quantized tree's scales and codes as JAX's (int4 nibbles
    packed: a byte holds two codes, compared as bytes)."""
    jt, js, tt, ts = trees
    jq, jh = jax_qat.qat_distill(js, jt, J_ARCH, method="int4", steps=STEPS, lr=1e-3, seed=5)
    tq, th = qat.qat_distill(ts, tt, ARCH, method="int4", steps=STEPS, lr=1e-3, seed=5)
    np.testing.assert_allclose(th, jh, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    flips = total = 0
    for (n, g), (_, w) in zip(P.named_leaves(tq), JP.named_leaves(jq)):
        if isinstance(g, QTensor):
            assert g.kind == w.kind == "int4_pack", n
            np.testing.assert_allclose(g.scale.numpy(), np.asarray(w.scale), rtol=PARAM_RTOL)
            gd = dequantize(g).numpy()
            wd = np.asarray(jax_dequantize(w, jnp.float32))
            step = np.asarray(w.scale).reshape(1, -1)
            d = np.abs(gd - wd) / step
            assert d.max() <= 1 + 1e-3, n
            flips, total = flips + int((d > 0.5).sum()), total + d.size
        else:
            w = np.asarray(w)
            assert np.linalg.norm(g.numpy() - w) <= PARAM_RTOL * np.linalg.norm(w), n
    assert flips <= 1e-3 * total, flips


def test_fake_quant_recovery_runs(trees):
    """Dequantize, distill, requantize: a quantized tree of the same kinds
    as JAX's."""
    jt, js, tt, ts = trees
    got = distill.fake_quant_recovery(api.quantize_params(ts, "int4"), tt, ARCH, steps=1)
    want = jax_distill.fake_quant_recovery(jax_api.quantize_params(js, "int4"), jt,
                                           J_ARCH, steps=1)
    kinds = [(n, l.kind) for n, l in P.named_leaves(got) if isinstance(l, QTensor)]
    assert kinds == [(n, l.kind) for n, l in JP.named_leaves(want) if hasattr(l, "kind")]


# --------------------------------------------------- distill(mesh=): dp x tp

@pytest.fixture(scope="module")
def mesh_runs(trees):
    """`distill(mesh=)` at dp = 2 x tp = 2: JAX's on four devices of the
    virtual mesh, the port's in one world of 4 gloo ranks (spawned once;
    `torch_parallel_worlds.distill_world`): a recovery run of the pruned
    student (its zeros kept) and an STE int4 QAT run of the teacher."""
    import sys

    from openai_whisper_compression_tpu.parallel import mesh as jax_mesh
    from openai_whisper_compression_tpu_torch.parallel.multihost import run_world

    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    import torch_parallel_worlds as worlds

    jt, js, tt, ts = trees
    mesh = jax_mesh.make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    kw = dict(steps=2, lr=1e-3, batch=2, seq_len=4, mesh=mesh)
    jax_runs = {
        "recovery": jax_distill.distill(js, jt, J_ARCH, preserve_sparsity=True, **kw),
        "qat": jax_distill.distill(jt, jt, J_ARCH, preserve_sparsity=False,
                                   param_transform=jax_qat.make_ste_transform(jt, "int4"),
                                   **kw)}
    port = run_world(worlds.distill_world, 4, {"student": ts, "teacher": tt})
    return jax_runs, port


@pytest.mark.parametrize("run", ["recovery", "qat"])
def test_distill_mesh_matches_jax(trees, mesh_runs, run):
    """Losses of 2 sharded steps within the single-device tolerances above
    (gloo's sums and XLA's add in other orders, ~1e-7 more), the whole
    trees every rank returns within PARAM_RTOL of JAX's, the same on every
    rank; the recovery run keeps the pruned zeros."""
    (jout, jh) = mesh_runs[0][run]
    jout = jax.tree.map(np.asarray, jout)
    first = mesh_runs[1][0][run][0]
    for rank in mesh_runs[1]:
        got, hist = rank[run]
        np.testing.assert_allclose(hist, jh, rtol=LOSS_RTOL, atol=LOSS_ATOL)
        _assert_params_close(P.from_numpy(got, device=DEV), jout)
        np.testing.assert_array_equal(got["encoder"]["layers"][1]["fc2"]["w"],
                                      first["encoder"]["layers"][1]["fc2"]["w"])
    if run == "recovery":
        before = trees[3]["encoder"]["layers"][0]["fc1"]["w"].numpy()
        after = first["encoder"]["layers"][0]["fc1"]["w"]
        assert (before == 0).any() and (after[before == 0] == 0).all()
