"""The port's GPipe encoder (`parallel/pipeline.py`) against the JAX
package's on a virtual 'pp' mesh: one world of 2 gloo ranks (pp = 2, the
pipeline of `__graft_entry__.dryrun_multichip`) runs `pp_encode` at 2 and
4 microbatches, and a gradient through it; every rank's states must match
JAX's within 1e-5 (f32; the JAX test's bound against one device). The
divisibility guards need no world."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.parallel import pipeline as jax_pipeline
from openai_whisper_compression_tpu_torch.config import ARCHS
from openai_whisper_compression_tpu_torch.models.params import from_numpy, init_params
from openai_whisper_compression_tpu_torch.parallel import mesh as mesh_lib
from openai_whisper_compression_tpu_torch.parallel import pipeline
from openai_whisper_compression_tpu_torch.parallel.multihost import run_world

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import torch_parallel_worlds as worlds  # noqa: E402

DEV = "cpu"
J_ARCH = JAX_ARCHS["test2l"]


@pytest.fixture(scope="module")
def setup():
    params = JP.init_params(J_ARCH, jax.random.PRNGKey(4))
    mel = np.random.default_rng(5).standard_normal(
        (4, J_ARCH.num_mel_bins, 2 * J_ARCH.max_source_positions)).astype(np.float32)
    return params, mel


@pytest.fixture(scope="module")
def world(setup):
    params, mel = setup
    return run_world(worlds.pipeline_world, 2, {
        "params": from_numpy(jax.tree.map(np.asarray, params), device=DEV), "mel": mel})


@pytest.mark.parametrize("n_micro", [2, 4])
def test_pp_encoder_matches_jax(setup, world, n_micro):
    params, mel = setup
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("pp",))
    ref = np.asarray(jax_pipeline.pp_encode(params, J_ARCH, mesh, jnp.asarray(mel),
                                            n_micro=n_micro))
    for r in world:
        np.testing.assert_allclose(r[n_micro], ref, atol=1e-5)


def test_pp_encoder_gradient_matches_jax(setup, world):
    """Reverse mode through the send / recv schedule: each stage's gradient
    of sum(states^2) with respect to its stacked fc1 weights equals the
    port's single-process gradient's rows within 1e-5 of its largest
    magnitude, and JAX's `jax.grad` through its ppermute scan within 2e-3
    of it (f32: the two packages' single-device encoders' gradients are
    4.4e-6 apart at a largest magnitude of 3.6e-3 here, and the pipeline
    adds nothing to that); every stage's layers get a gradient."""
    params, mel = setup
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("pp",))
    enc = params["encoder"]
    fn, place = jax_pipeline.make_pp_encoder(J_ARCH, mesh, n_micro=2)
    stacked = place(jax_pipeline.stack_layers(enc["layers"]))
    stem = {"conv1": enc["conv1"], "conv2": enc["conv2"], "pos": enc["pos"]}

    def loss(st):
        return jnp.sum(fn(stem, st, enc["ln"], jnp.asarray(mel)) ** 2)

    want = np.asarray(jax.grad(loss)(stacked)["fc1"]["w"])     # (L, d, ffn)
    n = want.shape[0] // len(world)
    for s, r in enumerate(world):
        assert r["loss"] == pytest.approx(float(loss(stacked)), rel=1e-5)
        part, single = want[s * n: (s + 1) * n], r["grad_fc1_single"][s * n: (s + 1) * n]
        assert np.abs(r["grad_fc1"]).max() > 0
        np.testing.assert_allclose(r["grad_fc1"], single, rtol=0,
                                   atol=1e-5 * float(np.abs(single).max()))
        np.testing.assert_allclose(r["grad_fc1"], part, rtol=0,
                                   atol=2e-3 * float(np.abs(part).max()))


def test_stack_layers_matches_jax(setup):
    params, _ = setup
    want = jax_pipeline.stack_layers(params["encoder"]["layers"])
    got = pipeline.stack_layers(from_numpy(jax.tree.map(np.asarray, params),
                                           device=DEV)["encoder"]["layers"])
    np.testing.assert_array_equal(got["fc1"]["w"].numpy(), np.asarray(want["fc1"]["w"]))
    assert got["attn"]["q"]["w"].shape == want["attn"]["q"]["w"].shape


def test_pp_divisibility_guards():
    mesh = mesh_lib.Mesh(("pp",), {"pp": 2}, {"pp": 0}, {}, {}, torch.device("cpu"))
    arch = ARCHS["test2l"]
    params = init_params(arch, 0, device=DEV)
    mel = torch.zeros(4, arch.num_mel_bins, 2 * arch.max_source_positions)
    with pytest.raises(AssertionError):
        pipeline.pp_encode(params, arch, mesh, mel, n_micro=3)       # 4 % 3
    arch3 = arch.replace(encoder_layers=3)
    with pytest.raises(AssertionError):                              # 3 layers % pp=2
        pipeline.pp_encode(init_params(arch3, 0, device=DEV), arch3, mesh, mel)
