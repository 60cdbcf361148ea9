"""Sharded execution steps: the dp/tp training step and the dp transcription
and evaluation steps (the JAX package's `parallel/steps.py`).

The JAX training step is one jitted `value_and_grad` that GSPMD partitions
over the mesh. Here each rank runs the tensor-parallel forward of its shard
(`tp_forward.nll_loss_local`, with Megatron's all-reduce pair under
autograd), takes its gradient, averages the gradients over 'dp' (the mean
loss of equal batch slices is the mean of their means) and applies the SGD
update to its shard.
"""

from __future__ import annotations

import torch

from ..config import WhisperArch
from ..models.params import copy_tree, named_leaves, set_leaf
from . import mesh as mesh_lib
from .mesh import Mesh
from .tp_forward import nll_loss_local


def make_train_step(arch: WhisperArch, mesh: Mesh, lr: float = 1e-4):
    """SGD training step over the mesh: the batch split on 'dp', parameters
    split per `param_specs` on 'tp'. Returns (step_fn, place_params,
    place_batch): place_params(params) -> this rank's shard; place_batch(
    *arrays) -> this rank's rows; step_fn(shard, mel, tokens, labels) ->
    (updated shard, loss), the loss being the mean over the whole batch (the
    same on every rank). The gradient of a replicated leaf is whole on every
    tp rank, so the replicas stay equal."""
    def step(params, mel, tokens, labels):
        leaves = [(n, t) for n, t in named_leaves(params)
                  if isinstance(t, torch.Tensor) and t.is_floating_point()]
        latent = {n: t.detach().clone().requires_grad_(True) for n, t in leaves}
        tree = copy_tree(params)
        for n, t in latent.items():
            set_leaf(tree, n, t)
        loss = nll_loss_local(tree, arch, mel, tokens, labels, mesh)
        grads = torch.autograd.grad(loss, list(latent.values()))
        dp = mesh.shape.get("dp", 1)
        out = copy_tree(params)
        with torch.no_grad():
            for (n, t), g in zip(latent.items(), grads):
                if dp > 1:
                    g = mesh_lib.all_reduce(g, mesh, "dp") / dp
                set_leaf(out, n, (t - lr * g.to(t.dtype)).detach())
            loss = loss.detach()
            if dp > 1:
                loss = mesh_lib.all_reduce(loss, mesh, "dp") / dp
        return out, loss

    def place_params(params):
        return mesh_lib.shard_params(params, mesh)

    def place_batch(*arrays):
        place = mesh_lib.batch_sharding(mesh)
        return tuple(place(a) for a in arrays)

    return step, place_params, place_batch


def make_dp_transcribe(arch: WhisperArch, mesh: Mesh, decode_cfg=None,
                       axis: str = "dp", **fn_kwargs):
    """Kernel-preserving data-parallel transcription: the single-device
    program (`make_transcribe_fn`, every kernel of the port, greedy, beam and
    timestamp machinery) runs unchanged on each rank's rows, with the whole
    tree on every rank and no communication (batch rows are independent).
    On a ('dp', 'tp') mesh the batch splits over 'dp' and the program is
    replicated over 'tp' (`tp_forward.make_tp_decoder` shards the model
    itself). Returns (step, place_batch): place_batch(wav) -> this rank's
    rows (the batch must divide by the 'dp' size), step(params, rows) ->
    their (tokens, lengths); `mesh.gather_batch` joins the ranks' rows."""
    from ..config import DecodeConfig
    from ..evaluation.harness import make_transcribe_fn

    fn = make_transcribe_fn(arch, decode_cfg or DecodeConfig(), device=mesh.device,
                            **fn_kwargs)
    return fn, mesh_lib.batch_sharding(mesh, axis)


def make_eval_step(arch: WhisperArch, mesh: Mesh, decode_cfg=None):
    """Data-parallel transcription step. Without a decode configuration:
    (None, place_batch). A mesh of more than one process routes through
    `make_dp_transcribe`; one process takes `make_transcribe_fn` itself,
    with the same placement."""
    from ..evaluation.harness import make_transcribe_fn

    place = mesh_lib.batch_sharding(mesh)
    if decode_cfg is None:
        return None, place
    if mesh.size > 1:
        return make_dp_transcribe(arch, mesh, decode_cfg)
    return make_transcribe_fn(arch, decode_cfg, device=mesh.device), place
