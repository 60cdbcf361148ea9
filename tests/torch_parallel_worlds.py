"""What each rank of the parallel tests' worlds runs (spawned by
`parallel.multihost.run_world`): one function a test file, which runs all of
that file's cases and returns numpy results. Imports torch and the port only
(the spawned ranks never import jax); the test files hold the results
against the JAX package on its virtual 8-device mesh."""

from __future__ import annotations

import torch

from openai_whisper_compression_tpu_torch.config import ARCHS
from openai_whisper_compression_tpu_torch.parallel import mesh as mesh_lib

DEV = "cpu"


def _np(tree):
    """A tree of tensors (QTensors as dicts of their fields) as numpy."""
    import dataclasses

    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    if dataclasses.is_dataclass(tree):
        return {f.name: _np(getattr(tree, f.name)) for f in dataclasses.fields(tree)
                if isinstance(getattr(tree, f.name), torch.Tensor)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy() if tree.is_floating_point() \
            else tree.numpy()
    return tree


def parallel_world(inp: dict) -> dict:
    """dp = 2 x tp = 4: the mesh, the layout of a sharded tree, one SGD
    train step, the DP transcription and the evaluation step."""
    from openai_whisper_compression_tpu_torch.parallel import steps

    arch = ARCHS["test2l"]
    mesh = mesh_lib.make_mesh(dp=2, tp=4, device=DEV)
    out = {"coords": dict(mesh.coords), "ranks": dict(mesh.ranks),
           "size": mesh.size}
    params = inp["params"]
    local = mesh_lib.shard_params(params, mesh)
    out["local_shapes"] = {
        "q.w": tuple(local["encoder"]["layers"][0]["attn"]["q"]["w"].shape),
        "q.b": tuple(local["encoder"]["layers"][0]["attn"]["q"]["b"].shape),
        "o.w": tuple(local["encoder"]["layers"][0]["attn"]["o"]["w"].shape),
        "fc1.w": tuple(local["encoder"]["layers"][0]["fc1"]["w"].shape),
        "fc2.w": tuple(local["encoder"]["layers"][0]["fc2"]["w"].shape),
        "embed": tuple(local["decoder"]["embed"].shape)}
    back = mesh_lib.unshard_params(local, mesh)
    out["roundtrip_equal"] = all(
        torch.equal(a, b) for a, b in zip(_leaves(back), _leaves(params)))

    step, place_params, place_batch = steps.make_train_step(arch, mesh, lr=inp["lr"])
    mel, tokens, labels = place_batch(*(torch.from_numpy(a) for a in inp["batch"]))
    new, loss = step(place_params(params), mel, tokens, labels)
    out["loss"] = float(loss)
    out["new_params"] = _np(mesh_lib.unshard_params(new, mesh))

    dp_fn, place_wav = steps.make_dp_transcribe(arch, mesh, inp["cfg"])
    toks, lens = dp_fn(inp["params"], place_wav(torch.from_numpy(inp["wav"])))
    out["dp_tokens"] = mesh_lib.gather_batch(toks, mesh).numpy()
    out["dp_lengths"] = mesh_lib.gather_batch(lens, mesh).numpy()
    ev_fn, place = steps.make_eval_step(arch, mesh, inp["cfg"])
    toks, _ = ev_fn(inp["params"], place(torch.from_numpy(inp["wav"])))
    out["eval_tokens"] = mesh_lib.gather_batch(toks, mesh).numpy()
    out["eval_none"] = steps.make_eval_step(arch, mesh)[0] is None
    return out


def _leaves(tree):
    from openai_whisper_compression_tpu_torch.models.params import named_leaves
    from openai_whisper_compression_tpu_torch.ops.qtensor import QTensor

    for _, leaf in named_leaves(tree):
        if isinstance(leaf, QTensor):
            yield from leaf._tensors()
        elif leaf is not None:
            yield leaf


def tp_world(inp: dict) -> dict:
    """dp = 2 x tp = 4: the TP encoder (dense, int8, int4 through
    `tp_compatible`), the SP encoder (dense, int8) and the TP greedy
    decoder (int8, and a packed int4 tree)."""
    from openai_whisper_compression_tpu_torch.parallel import tp_forward as tpf

    arch = ARCHS["test2l"]
    mesh = mesh_lib.make_mesh(dp=2, tp=4, device=DEV)
    rows = mesh_lib.batch_sharding(mesh)
    mel = rows(torch.from_numpy(inp["mel"]))
    out = {}
    for name, tree in inp["trees"].items():
        fn, place = tpf.make_tp_encoder(arch, mesh, tree)
        out[f"enc_{name}"] = mesh_lib.gather_batch(fn(place(tree), mel), mesh).numpy()
        if name in ("dense", "int8"):
            fn, place = tpf.make_tp_sp_encoder(arch, mesh, tree)
            piece = fn(place(tree), mel)
            whole = mesh_lib.all_gather(piece, mesh, "tp", 1)
            out[f"sp_{name}"] = mesh_lib.gather_batch(whole, mesh).numpy()
        if name in ("int8", "int4"):
            fn, place = tpf.make_tp_decoder(arch, mesh, tree, inp["cfg"])
            toks, lens = fn(place(tree), mel)
            out[f"dec_{name}_tokens"] = mesh_lib.gather_batch(toks, mesh).numpy()
            out[f"dec_{name}_lengths"] = mesh_lib.gather_batch(lens, mesh).numpy()
    compat = tpf.tp_compatible(inp["trees"]["int4"])
    out["int4_kinds"] = {
        "q": type(compat["encoder"]["layers"][0]["attn"]["q"]["w"]).__name__,
        "o": type(compat["encoder"]["layers"][0]["attn"]["o"]["w"]).__name__,
        "fc1": type(compat["encoder"]["layers"][0]["fc1"]["w"]).__name__,
        "fc2": type(compat["encoder"]["layers"][0]["fc2"]["w"]).__name__}
    return out


def pipeline_world(inp: dict) -> dict:
    """pp = 2: the GPipe encoder at 2 and 4 microbatches, and the gradient
    of a loss on its output with respect to each stage's layers."""
    from openai_whisper_compression_tpu_torch.parallel import pipeline

    arch = ARCHS["test2l"]
    mesh = mesh_lib.make_mesh(axes={"pp": 2}, device=DEV)
    mel = torch.from_numpy(inp["mel"])
    out = {n: pipeline.pp_encode(inp["params"], arch, mesh, mel, n_micro=n).numpy()
           for n in (2, 4)}
    # reverse mode: d sum(states^2) / d this stage's stacked layers
    enc = inp["params"]["encoder"]
    fn, place = pipeline.make_pp_encoder(arch, mesh, n_micro=2)
    local = place(pipeline.stack_layers(enc["layers"]))
    leaf = local["fc1"]["w"].requires_grad_(True)
    stem = {"conv1": enc["conv1"], "conv2": enc["conv2"], "pos": enc["pos"]}
    loss = (fn(stem, local, enc["ln"], mel) ** 2).sum()
    loss.backward()
    out["grad_fc1"] = leaf.grad.numpy()
    out["loss"] = float(loss)
    # the same gradient through the single-process encoder
    from openai_whisper_compression_tpu_torch.models.whisper import encode

    ws = [layer["fc1"]["w"].detach().clone().requires_grad_(True) for layer in enc["layers"]]
    tree = {**inp["params"], "encoder": {**enc, "layers": [
        {**layer, "fc1": {**layer["fc1"], "w": w}} for layer, w in zip(enc["layers"], ws)]}}
    (encode(tree, arch, mel) ** 2).sum().backward()
    out["grad_fc1_single"] = torch.stack([w.grad for w in ws]).numpy()
    return out


def distill_world(inp: dict) -> dict:
    """dp = 2 x tp = 2: `distill(mesh=)`, a recovery run of a pruned
    student (its zeros kept) and an STE QAT run (int4 fake quantization of
    whole gathered weights)."""
    from openai_whisper_compression_tpu_torch.distill import distill
    from openai_whisper_compression_tpu_torch.quant.qat import make_ste_transform

    arch = ARCHS["test2l"]
    mesh = mesh_lib.make_mesh(dp=2, tp=2, device=DEV)
    out = {}
    s, t = inp["student"], inp["teacher"]
    rec, hist = distill(s, t, arch, steps=2, lr=1e-3, batch=2, seq_len=4,
                        preserve_sparsity=True, mesh=mesh)
    out["recovery"] = (_np(rec), hist)
    qat, hist = distill(t, t, arch, steps=2, lr=1e-3, batch=2, seq_len=4,
                        param_transform=make_ste_transform(t, "int4"),
                        preserve_sparsity=False, mesh=mesh)
    out["qat"] = (_np(qat), hist)
    return out



def failing_world() -> None:
    """Rank 1 raises before the collective that rank 0 waits in."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    dist.all_reduce(torch.ones(1))
