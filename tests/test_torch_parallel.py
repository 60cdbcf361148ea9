"""The port's `parallel/{mesh,steps,multihost}.py` against the JAX package's
on its virtual 8-device mesh.

One world of 8 gloo ranks (dp = 2 x tp = 4, the shape of
`__graft_entry__.dryrun_multichip` and MULTICHIP_r05.json) is spawned once
for the file (`world`); it runs every case and returns numpy results:
the mesh coordinates, the local shapes of a sharded tree and its round
trip, one SGD step of the training step, the DP transcription and the
evaluation step. Tolerances: the loss within 1e-5 relative, updated
parameters within 1e-6 absolute (f32; gloo's and XLA's sums add in other
orders), tokens and lengths equal.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.parallel import mesh as jax_mesh
from openai_whisper_compression_tpu.parallel import steps as jax_steps
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.models.params import from_numpy, named_leaves
from openai_whisper_compression_tpu_torch.parallel import mesh as mesh_lib
from openai_whisper_compression_tpu_torch.parallel.multihost import run_world

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import torch_parallel_worlds as worlds  # noqa: E402

DEV = "cpu"
ARCH, J_ARCH = ARCHS["test2l"], JAX_ARCHS["test2l"]
LR = 1e-2
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-6


def _cfgs():
    kw = dict(max_new_tokens=8, language_token_id=None, task_token_id=None,
              cross_kv_int8=True)
    return JaxDecodeConfig(**kw), DecodeConfig(**kw)


@pytest.fixture(scope="module")
def inputs():
    jp = JP.init_params(J_ARCH, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((4, J_ARCH.num_mel_bins, 128)).astype(np.float32),
             rng.integers(0, J_ARCH.vocab_size, (4, 6)).astype(np.int32),
             rng.integers(0, J_ARCH.vocab_size, (4, 6)).astype(np.int32))
    n = J_ARCH.max_source_positions * 2 * 160
    wav = (np.random.default_rng(2).standard_normal((8, n)) * 0.1).astype(np.float32)
    return jp, batch, wav


@pytest.fixture(scope="module")
def world(inputs):
    jp, batch, wav = inputs
    tp = from_numpy(jax.tree.map(np.asarray, jp), device=DEV)
    return run_world(worlds.parallel_world, 8,
                     {"params": tp, "lr": LR, "batch": batch,
                      "cfg": _cfgs()[1], "wav": wav})


def test_choose_tp_and_specs_match_jax(inputs):
    for args in [(8, 4, 128), (8, 6, 128), (1, 12, 128), (8, 12, 3072), (4, 20, 5120)]:
        assert mesh_lib.choose_tp(*args) == jax_mesh.choose_tp(*args)
    from openai_whisper_compression_tpu.models.fuse import fuse_qkv as jax_fuse

    for jp in (inputs[0], jax_fuse(inputs[0])):
        js = jax.tree.map(tuple, jax_mesh.param_specs(jp),
                          is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert mesh_lib.param_specs(jp) == js


def test_mesh_coordinates_match_jax_layout(world):
    jm = jax_mesh.make_mesh(dp=2, tp=4)
    ids = np.vectorize(lambda d: d.id)(jm.devices)        # (dp, tp) device ids
    for rank, r in enumerate(world):
        assert r["size"] == 8
        assert ids[r["coords"]["dp"], r["coords"]["tp"]] == jax.devices()[rank].id
        assert r["ranks"]["tp"] == [int(i) for i in ids[r["coords"]["dp"]]]
        assert r["ranks"]["dp"] == [int(i) for i in ids[:, r["coords"]["tp"]]]


def test_shard_layout_matches_jax(inputs, world):
    jp = inputs[0]
    sharded = jax_mesh.shard_params(jp, jax_mesh.make_mesh(dp=2, tp=4))
    names = {"q.w": "encoder.layers.0.attn.q.w", "q.b": "encoder.layers.0.attn.q.b",
             "o.w": "encoder.layers.0.attn.o.w", "fc1.w": "encoder.layers.0.fc1.w",
             "fc2.w": "encoder.layers.0.fc2.w", "embed": "decoder.embed"}
    for key, name in names.items():
        shard = JP.get_leaf(sharded, name).addressable_shards[0].data.shape
        assert all(r["local_shapes"][key] == tuple(shard) for r in world), key
    assert all(r["roundtrip_equal"] for r in world)


def test_train_step_matches_jax(inputs, world):
    jp, batch, _ = inputs
    mesh = jax_mesh.make_mesh(dp=2, tp=4)
    step, place_params, place_batch = jax_steps.make_train_step(J_ARCH, mesh, lr=LR)
    new, loss = step(place_params(JP.init_params(J_ARCH, jax.random.PRNGKey(0))),
                     *place_batch(*(jnp.asarray(a) for a in batch)))
    for r in world:
        assert r["loss"] == pytest.approx(float(loss), rel=LOSS_RTOL)
    got = world[0]["new_params"]
    worst = 0.0
    for name, _ in named_leaves(from_numpy(jax.tree.map(np.asarray, jp), device=DEV)):
        node = got
        for part in name.split("."):
            node = node[int(part)] if isinstance(node, list) else node[part]
        worst = max(worst, float(np.abs(node - np.asarray(JP.get_leaf(new, name))).max()))
    assert worst <= PARAM_ATOL
    # every rank holds the same whole tree (replicas stayed equal)
    for r in world[1:]:
        for a, b in zip(jax.tree.leaves(r["new_params"]), jax.tree.leaves(got)):
            np.testing.assert_array_equal(a, b)


def test_dp_transcribe_matches_jax(inputs, world):
    jp, _, wav = inputs
    jcfg, _ = _cfgs()
    mesh = jax_mesh.make_mesh(dp=2, tp=4)
    fn, place = jax_steps.make_dp_transcribe(J_ARCH, mesh, jcfg)
    t, l = fn(jp, place(jnp.asarray(wav)))
    for r in world:
        np.testing.assert_array_equal(r["dp_tokens"], np.asarray(t))
        np.testing.assert_array_equal(r["dp_lengths"], np.asarray(l))


def test_eval_step_matches_jax(inputs, world):
    jp, _, wav = inputs
    jcfg, _ = _cfgs()
    fn, place = jax_steps.make_eval_step(J_ARCH, jax_mesh.make_mesh(dp=2, tp=4), jcfg)
    t, _ = fn(jp, place(jnp.asarray(wav)))
    for r in world:
        np.testing.assert_array_equal(r["eval_tokens"], np.asarray(t))
        assert r["eval_none"]


def test_placements_refuse_an_uneven_batch():
    mesh = mesh_lib.Mesh(("dp", "tp"), {"dp": 2, "tp": 4}, {"dp": 1, "tp": 0},
                         {}, {}, torch.device("cpu"))
    x = torch.arange(12).reshape(4, 3)
    assert torch.equal(mesh_lib.batch_sharding(mesh)(x), x[2:])
    assert torch.equal(mesh_lib.replicated(mesh)(x), x)
    with pytest.raises(ValueError, match="not divisible"):
        mesh_lib.batch_sharding(mesh)(x[:3])


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialized"):
        mesh_lib.make_mesh(dp=1, tp=1)


def test_a_failing_rank_fails_the_world_in_time():
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        run_world(worlds.failing_world, 2, timeout_s=20)
    assert time.monotonic() - t0 < 60
