"""GPipe-style pipeline parallelism for the encoder stack (the JAX package's
`parallel/pipeline.py`).

whisper-large's 32-layer encoder can be split over a 'pp' mesh axis when one
card cannot hold the model. Each stage (one rank) holds L/P contiguous
layers; the batch is cut into M microbatches; stage 0 takes them in turn,
every stage applies its layers and sends the activation to the next stage
(`send` / `recv`, where the JAX function `ppermute`s), the last stage keeps
the outputs, and a broadcast from the last stage hands every rank the whole
result (the JAX function's final `psum`). A stage works on microbatch m as
soon as it arrives, so with P stages the first output is ready after P
stage-steps and the bubble is (P-1)/(M+P-1) of the run, as in GPipe.

The conv stem, positions and final layer norm run replicated outside the
pipeline (under 1% of the encoder's FLOPs).

The pipeline is differentiable, as the JAX function's `scan` over
`ppermute`s is: under autograd a received activation sends its gradient
back to the stage before (`_Recv`), a sent one waits for its gradient from
the stage after (`_Send`, whose zero-size token joins the stage's output so
that every stage's backward reaches it), and the broadcast passes the last
stage's gradient through. Every rank calls backward on its copy of one
loss; the microbatches' chains run in reverse order on every stage (the
autograd engine takes the latest-made node first), so stage s's receive of
microbatch m's gradient meets stage s+1's send of it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..config import WhisperArch
from ..models.whisper import encoder_layer, layer_norm
from ..ops.qtensor import QTensor
from . import mesh as mesh_lib
from .mesh import Mesh
from .tp_forward import _stem


def stack_layers(layers: list[dict]) -> Any:
    """List of per-layer trees -> one tree of (L, ...) stacked leaves.
    Requires homogeneous layers (no per-layer structural pruning)."""
    first = layers[0]
    if isinstance(first, QTensor):      # field by field; shape stays per layer
        return dataclasses.replace(first, **{
            f.name: torch.stack([getattr(l, f.name) for l in layers])
            for f in dataclasses.fields(first)
            if isinstance(getattr(first, f.name), torch.Tensor)})
    if isinstance(first, dict):
        return {k: stack_layers([l[k] for l in layers]) for k in first}
    if isinstance(first, list):
        return [stack_layers([l[i] for l in layers]) for i in range(len(first))]
    if first is None:
        return None
    return torch.stack(layers)


def _unstack(stacked: Any, i: int) -> Any:
    if isinstance(stacked, QTensor):
        return _map(lambda x: x[i], stacked)
    if isinstance(stacked, dict):
        return {k: _unstack(v, i) for k, v in stacked.items()}
    if isinstance(stacked, list):
        return [_unstack(v, i) for v in stacked]
    return None if stacked is None else stacked[i]


class _Recv(torch.autograd.Function):
    """Receive from the stage before; the gradient goes back to it."""

    @staticmethod
    def forward(ctx, anchor, like, mesh, src):
        ctx.mesh, ctx.src = mesh, src
        return mesh_lib.recv(like, mesh, "pp", src)

    @staticmethod
    def backward(ctx, g):
        mesh_lib.send(g, ctx.mesh, "pp", ctx.src)
        return None, None, None, None


class _Send(torch.autograd.Function):
    """Send to the stage after; returns a zero-size token whose backward
    receives the activation's gradient from that stage."""

    @staticmethod
    def forward(ctx, act, mesh, dst):
        ctx.mesh, ctx.dst, ctx.like = mesh, dst, torch.empty_like(act)
        mesh_lib.send(act, mesh, "pp", dst)
        return act.new_zeros(0)

    @staticmethod
    def backward(ctx, _):
        return mesh_lib.recv(ctx.like, ctx.mesh, "pp", ctx.dst), None, None


class _Broadcast(torch.autograd.Function):
    """The last stage's tensor on every rank; its gradient is the last
    stage's own (each rank holds a copy of one loss)."""

    @staticmethod
    def forward(ctx, x, mesh, src):
        ctx.own = mesh.coords["pp"] == src
        return mesh_lib.broadcast(x, mesh, "pp", src)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.own else torch.zeros_like(g)), None, None


def make_pp_encoder(arch: WhisperArch, mesh: Mesh, n_micro: int | None = None):
    """Build (fn, place_layers) for a pipeline-parallel encoder forward.

    fn(stem_params, local_layers, ln_params, mel) -> (B, T, d) encoder
    states, the same on every rank of the 'pp' axis. `place_layers` keeps
    this stage's L/P rows of the stacked layer tree. The batch must divide
    by n_micro (default 2x the stage count)."""
    assert "pp" in mesh.axis_names, "mesh needs a 'pp' axis"
    p_stages = mesh.shape["pp"]
    s = mesh.coords["pp"]
    n_micro = n_micro or 2 * p_stages

    def place_layers(stacked: Any) -> Any:
        def part(x):
            if x is None:
                return None
            n = x.shape[0] // p_stages
            return x[s * n: (s + 1) * n].to(mesh.device)
        return _map(part, stacked)

    def pipeline(local_layers: Any, x: torch.Tensor) -> torch.Tensor:
        """x: (M, B/M, T, d) microbatches, the same on every stage."""
        n_local = _leaves(local_layers)[0].shape[0]
        layers = [_unstack(local_layers, i) for i in range(n_local)]
        # every stage must agree: a stage whose layers need a gradient
        # differentiates, and its neighbours' layers need one too
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in _leaves(local_layers))
        anchor = x.new_zeros(0, requires_grad=True) if grad else None
        outs, tokens = [], []
        for m in range(x.shape[0]):
            if s == 0:
                act = x[m]
            elif grad:
                act = _Recv.apply(anchor, x[m], mesh, s - 1)
            else:
                act = mesh_lib.recv(x[m], mesh, "pp", s - 1)
            for lp in layers:
                act = encoder_layer(lp, act, arch.head_dim)
            if s == p_stages - 1:
                outs.append(act)
            elif grad:
                tokens.append(_Send.apply(act, mesh, s + 1))
            else:
                mesh_lib.send(act, mesh, "pp", s + 1)
        # the last stage's collected outputs to every rank
        outs = torch.stack(outs) if outs else torch.empty_like(x)
        if not grad:
            return mesh_lib.broadcast(outs, mesh, "pp", p_stages - 1)
        out = _Broadcast.apply(outs, mesh, p_stages - 1)
        for t in tokens:          # zero-size: joins the graph, adds nothing
            out = out + t.sum()
        return out

    def fn(stem: dict, stacked_layers: Any, ln: dict,
           mel: torch.Tensor) -> torch.Tensor:
        x = _stem(stem, mel.to(mesh.device))
        b = x.shape[0]
        assert b % n_micro == 0, f"batch {b} % microbatches {n_micro} != 0"
        xm = x.reshape(n_micro, b // n_micro, *x.shape[1:])
        out = pipeline(stacked_layers, xm)
        return layer_norm(out.reshape(b, *out.shape[2:]), ln)

    return fn, place_layers


def _map(fn, tree):
    if isinstance(tree, QTensor):
        return dataclasses.replace(tree, **{
            f.name: fn(getattr(tree, f.name)) for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree) -> list:
    out: list = []
    _map(lambda t: out.append(t) if t is not None else None, tree)
    return out


def pp_encode(params: dict, arch: WhisperArch, mesh: Mesh, mel: torch.Tensor,
              n_micro: int | None = None) -> torch.Tensor:
    """Convenience: run the encoder pipeline-parallel from the whole tree
    (stacks the layers and keeps this stage's; use make_pp_encoder +
    place_layers to keep the placement across calls)."""
    enc = params["encoder"]
    n_layers = len(enc["layers"])
    assert n_layers % mesh.shape["pp"] == 0, \
        f"{n_layers} layers not divisible by pp={mesh.shape['pp']}"
    fn, place = make_pp_encoder(arch, mesh, n_micro)
    stacked = place(stack_layers(enc["layers"]))
    stem = {"conv1": enc["conv1"], "conv2": enc["conv2"], "pos": enc["pos"]}
    return fn(stem, stacked, enc["ln"], mel)
