"""The port's `parallel/tp_forward.py` against the JAX package's shard_map
functions on its virtual mesh, both at dp = 2 x tp = 4 on test2l (q/k
scaled 8x, as the JAX test does, so that a wrong head grouping shows).

One world of 8 gloo ranks is spawned for the file (`world`): the TP encoder
on the dense, int8 and packed int4 trees (int4's row-parallel leaves made
dense by `tp_compatible`), the sequence-parallel encoder on the dense and
int8 trees, and the TP greedy decoder on the int8 and int4 trees.
Tolerances (f32, each against the JAX function on the same shards; the
reductions add in other orders): dense 2e-5, int8 5e-4, int4 2e-3,
absolute and relative, as the JAX tests hold them against one device.
Tokens and lengths equal.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.ops.qtensor import QTensor as JaxQTensor
from openai_whisper_compression_tpu.parallel import mesh as jax_mesh
from openai_whisper_compression_tpu.parallel import tp_forward as jax_tp
from openai_whisper_compression_tpu.quant import api as jax_api
from openai_whisper_compression_tpu_torch.config import DecodeConfig
from openai_whisper_compression_tpu_torch.models.params import from_numpy
from openai_whisper_compression_tpu_torch.parallel.multihost import run_world

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import torch_parallel_worlds as worlds  # noqa: E402

DEV = "cpu"
J_ARCH = JAX_ARCHS["test2l"]
TOL = {"dense": 2e-5, "int8": 5e-4, "int4": 2e-3}
CFG = dict(max_new_tokens=8, language_token_id=None, task_token_id=None,
           notimestamps=False)


@pytest.fixture(scope="module")
def setup():
    params = JP.init_params(J_ARCH, jax.random.PRNGKey(0))
    for comp in ("encoder", "decoder"):
        for layer in params[comp]["layers"]:
            for attn in ("attn", "cross") if comp == "decoder" else ("attn",):
                layer[attn]["q"]["w"] = layer[attn]["q"]["w"] * 8.0
                layer[attn]["k"]["w"] = layer[attn]["k"]["w"] * 8.0
    trees = {"dense": params, "int8": jax_api.quantize_params(params, "int8"),
             "int4": jax_api.quantize_params(params, "int4")}
    mel = np.random.default_rng(0).standard_normal(
        (4, J_ARCH.num_mel_bins, 64)).astype(np.float32)
    return trees, mel, jax_mesh.make_mesh(dp=2, tp=4)


@pytest.fixture(scope="module")
def world(setup):
    trees, mel, _ = setup
    port = {k: from_numpy(jax.tree.map(np.asarray, v), device=DEV)
            for k, v in trees.items()}
    return run_world(worlds.tp_world, 8, {"trees": port, "mel": mel,
                                          "cfg": DecodeConfig(**CFG)})


@pytest.mark.parametrize("name", ["dense", "int8", "int4"])
def test_tp_encoder_matches_jax(setup, world, name):
    trees, mel, mesh = setup
    fn, place = jax_tp.make_tp_encoder(J_ARCH, mesh, trees[name])
    ref = np.asarray(fn(place(trees[name]), jnp.asarray(mel)))
    for r in world:
        np.testing.assert_allclose(r[f"enc_{name}"], ref, atol=TOL[name], rtol=TOL[name])


@pytest.mark.parametrize("name", ["dense", "int8"])
def test_tp_sp_encoder_matches_jax(setup, world, name):
    trees, mel, mesh = setup
    fn, place = jax_tp.make_tp_sp_encoder(J_ARCH, mesh, trees[name])
    ref = np.asarray(fn(place(trees[name]), jnp.asarray(mel)))
    for r in world:
        np.testing.assert_allclose(r[f"sp_{name}"], ref, atol=TOL[name], rtol=TOL[name])
        np.testing.assert_allclose(r[f"sp_{name}"], r[f"enc_{name}"],
                                   atol=TOL[name], rtol=TOL[name])


@pytest.mark.parametrize("name", ["int8", "int4"])
def test_tp_greedy_decode_matches_jax(setup, world, name):
    trees, mel, mesh = setup
    fn, place = jax_tp.make_tp_decoder(J_ARCH, mesh, trees[name], JaxDecodeConfig(**CFG))
    t, l = fn(place(trees[name]), jnp.asarray(mel))
    for r in world:
        np.testing.assert_array_equal(r[f"dec_{name}_tokens"], np.asarray(t))
        np.testing.assert_array_equal(r[f"dec_{name}_lengths"], np.asarray(l))


def test_tp_compatible_matches_jax(setup, world):
    """Packed int4: column-parallel leaves stay packed, row-parallel ones
    (o, fc2) become dense, as JAX's `tp_compatible` decides."""
    trees, _, mesh = setup
    compat = jax_tp.tp_compatible(trees["int4"], mesh)
    layer = compat["encoder"]["layers"][0]
    want = {"q": layer["attn"]["q"]["w"], "o": layer["attn"]["o"]["w"],
            "fc1": layer["fc1"]["w"], "fc2": layer["fc2"]["w"]}
    want = {k: "QTensor" if isinstance(v, JaxQTensor) else "Tensor"
            for k, v in want.items()}
    assert want == {"q": "QTensor", "o": "Tensor", "fc1": "QTensor", "fc2": "Tensor"}
    assert world[0]["int4_kinds"] == want
