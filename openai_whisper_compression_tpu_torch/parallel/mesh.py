"""Process meshes, sharding rules and the collectives of the parallel paths,
on `torch.distributed`.

The JAX package's `parallel/mesh.py` builds a ('dp', 'tp') device mesh and
lets GSPMD insert the collectives. Here every rank is one process holding
one device: `make_mesh` gives each rank its coordinates and one process
group per axis (the ranks that share every other coordinate), the sharding
rules (`param_specs`, copied) say which dimension of a leaf is split over
'tp', `shard_params` keeps this rank's slice, and the collectives are
called by hand at the points where the JAX code calls `psum`,
`all_gather`, `psum_scatter` and `ppermute`.

Rank layout: the JAX mesh reshapes the device list to (dp, tp), so rank r
sits at dp index r // tp and tp index r % tp (row-major over the axes).

Collectives on CUDA tensors under gloo (two ranks on one card, where NCCL
refuses to run): gloo all-reduces, broadcasts and all-gathers CUDA tensors
itself; its point-to-point send and recv of a CUDA tensor never complete
(an H100 run, torch 2.11), so those two are staged through host buffers, in
the open: each staged call is counted in `STAGED` by its name.
"""

from __future__ import annotations

import dataclasses
import math
from datetime import timedelta
from typing import Any

import torch
import torch.distributed as dist

from ..ops.qtensor import QTensor

DEFAULT_TIMEOUT_S = 120.0
# collectives gloo runs on CUDA tensors itself; the others are staged
_GLOO_CUDA = ("all_reduce", "broadcast", "all_gather")
STAGED: dict[str, int] = {}


@dataclasses.dataclass
class Mesh:
    """This rank's place in a mesh of processes: the axis names and sizes,
    its index on each axis, one process group per axis and the device it
    computes on."""

    axis_names: tuple[str, ...]
    shape: dict[str, int]
    coords: dict[str, int]
    groups: dict[str, Any]
    ranks: dict[str, list[int]]
    device: torch.device

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_mesh(dp: int | None = None, tp: int = 1, device: Any = None,
              axes: dict[str, int] | None = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """('dp', 'tp') mesh over the initialized default group (dp defaults
    to world // tp), or the named `axes` ({name: size}, row-major), e.g.
    {"pp": 2}. Every rank must call it, with the same arguments: each axis
    group is made by `new_group`, every group with `timeout_s`, so a rank
    that hangs makes the others fail in that time. `device`: this rank's
    device, by default cuda:(rank % cards) where torch sees a card (two
    ranks on one card share it), else the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(parallel.multihost.initialize)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if axes is None:
        if dp is None:
            dp = world // tp
        axes = {"dp": dp, "tp": tp}
    names = tuple(axes)
    if math.prod(axes.values()) != world:
        raise ValueError(f"mesh {axes} does not cover the world of {world}")
    sizes = [axes[a] for a in names]

    def coords_of(r: int) -> list[int]:
        out = []
        for s in reversed(sizes):
            out.append(r % s)
            r //= s
        return out[::-1]

    def rank_of(c: list[int]) -> int:
        r = 0
        for ci, s in zip(c, sizes):
            r = r * s + ci
        return r

    mine = coords_of(rank)
    groups, ranks = {}, {}
    timeout = timedelta(seconds=timeout_s)
    for i, a in enumerate(names):
        # every rank makes every group of this axis, in the same order
        for r in range(world):
            c = coords_of(r)
            if c[i] != 0:
                continue
            members = [rank_of(c[:i] + [j] + c[i + 1:]) for j in range(sizes[i])]
            g = dist.new_group(members, timeout=timeout)
            if rank in members:
                groups[a], ranks[a] = g, members
    if device is None:
        device = (torch.device("cuda", rank % torch.cuda.device_count())
                  if torch.cuda.is_available() else torch.device("cpu"))
    return Mesh(names, dict(axes), dict(zip(names, mine)), groups, ranks,
                torch.device(device))


def choose_tp(n_devices: int, n_heads: int, ffn_dim: int) -> int:
    """Largest tensor-parallel degree dividing both device count and the
    shardable dims (attention heads, FFN width)."""
    tp = math.gcd(n_devices, n_heads)
    while tp > 1 and (ffn_dim % tp or n_devices % tp):
        tp -= 1
    return max(tp, 1)


# ---------------------------------------------------------------------------
# Parameter sharding rules (Megatron-style TP for attention + FFN): a spec is
# a tuple naming, per dimension, the mesh axis it is split over (or None),
# as the JAX package's PartitionSpecs do
# ---------------------------------------------------------------------------

def _attn_spec(attn: dict | None = None) -> dict[str, Any]:
    # q/k/v: split output (head) dim; o: split input dim -> reduce after
    col = {"w": (None, "tp"), "b": ("tp",)}
    col_nb = {"w": (None, "tp")}
    row = {"w": ("tp", None), "b": (None,)}
    if attn is not None and "qkv" in attn:
        # fused qkv concatenates head blocks of q|k|v: sharding the fused out
        # dim would split across the q/k/v boundary -> replicate fused layers
        return {"qkv": {"w": (None, None), "b": (None,)}, "o": row}
    return {"q": col, "k": col_nb, "v": col, "o": row}


def _ln_spec() -> dict[str, Any]:
    return {"g": (None,), "b": (None,)}


def param_specs(params: dict) -> dict:
    """Spec tree matching the parameter tree (the JAX package's rules)."""
    def enc_layer(layer):
        return {
            "attn": _attn_spec(layer["attn"]), "attn_ln": _ln_spec(),
            "fc1": {"w": (None, "tp"), "b": ("tp",)},
            "fc2": {"w": ("tp", None), "b": (None,)},
            "mlp_ln": _ln_spec(),
        }

    def dec_layer(layer):
        p = enc_layer(layer)
        p["cross"] = _attn_spec(layer["cross"])
        p["cross_ln"] = _ln_spec()
        return p

    enc = params["encoder"]
    dec = params["decoder"]
    return {
        "encoder": {
            "conv1": {"w": (None,), "b": (None,)},
            "conv2": {"w": (None,), "b": (None,)},
            "pos": (None,),
            "layers": [enc_layer(l) for l in enc["layers"]],
            "ln": _ln_spec(),
        },
        "decoder": {
            "embed": (None,),
            "pos": (None,),
            "layers": [dec_layer(l) for l in dec["layers"]],
            "ln": _ln_spec(),
        },
    }


def _field_specs(q: QTensor, spec: tuple) -> dict[str, tuple]:
    """Per-field specs of a QTensor whose dense weight has `spec`: the codes
    follow the logical (K, N) layout; per-channel scales (int8 / fp8 /
    packed int4 / int2) follow N; per-group scales, zeros and double-quant
    fields (K/G, N); a static activation scale is replicated."""
    parts = tuple(spec) + (None, None)
    k_ax, n_ax = parts[0], parts[1]
    grp = ((None, n_ax) if q.kind in ("int8_pc", "fp8", "int4_pack", "int2_pack")
           else (k_ax, n_ax))
    return {"data": (k_ax, n_ax), "scale": grp, "zero": grp, "scale2": grp,
            "offset2": grp, "act_scale": ()}


def _local(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of x along every dimension `spec` puts on an
    axis (autograd follows the slice)."""
    for dim, ax in enumerate(spec):
        if ax is None or dim >= x.dim():
            continue
        n, i = mesh.shape[ax], mesh.coords[ax]
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split over {ax}={n}")
        w = x.shape[dim] // n
        x = x.narrow(dim, i * w, w)
    return x.contiguous()


def _local_shape(q: QTensor, spec: tuple, mesh: Mesh) -> tuple:
    parts = tuple(spec) + (None, None)
    return tuple(s // (mesh.shape[a] if a is not None else 1)
                 for s, a in zip(q.shape, parts[:2]))


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map2(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def shard_params(params: dict, mesh: Mesh) -> dict:
    """This rank's shard of a tree, on `mesh.device`, per `param_specs`: a
    QTensor is split field by field along the dense weight's axes, and its
    `shape` becomes the local (K, N). Slices keep autograd history."""
    def place(x, s):
        if x is None:
            return None
        if isinstance(x, QTensor):
            fs = _field_specs(x, s)
            return dataclasses.replace(
                x, shape=_local_shape(x, s, mesh),
                **{f: _local(getattr(x, f).to(mesh.device), fs[f], mesh)
                   for f in fs if getattr(x, f) is not None})
        return _local(x.to(mesh.device), s, mesh)

    return _map2(place, params, param_specs(params))


def unshard_params(local: dict, mesh: Mesh) -> dict:
    """The whole tree from every rank's shard (`shard_params`' inverse),
    on every rank: each split dimension is gathered over its axis."""
    def gather(x, s):
        if x is None:
            return None
        if isinstance(x, QTensor):
            fs = _field_specs(x, s)
            parts = tuple(s) + (None, None)
            shape = tuple(d * (mesh.shape[a] if a is not None else 1)
                          for d, a in zip(x.shape, parts[:2]))
            return dataclasses.replace(
                x, shape=shape, **{f: _gather_spec(getattr(x, f), fs[f], mesh)
                                   for f in fs if getattr(x, f) is not None})
        return _gather_spec(x, s, mesh)

    return _map2(gather, local, param_specs(local))


def _gather_spec(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    for dim, ax in enumerate(spec):
        if ax is not None and dim < x.dim():
            x = all_gather(x, mesh, ax, dim)
    return x


def batch_sharding(mesh: Mesh, axis: str = "dp"):
    """A placement: x -> this rank's rows of x's leading (batch) axis over
    `axis`, on the mesh's device (the JAX package's NamedSharding P('dp'))."""
    def place(x):
        x = torch.as_tensor(x)
        n, i = mesh.shape[axis], mesh.coords[axis]
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by {axis}={n}")
        w = x.shape[0] // n
        return x[i * w: (i + 1) * w].to(mesh.device)
    return place


def replicated(mesh: Mesh):
    """A placement: x -> the whole of x on the mesh's device (P())."""
    return lambda x: torch.as_tensor(x).to(mesh.device)


def gather_batch(x: torch.Tensor, mesh: Mesh, axis: str = "dp") -> torch.Tensor:
    """Every rank's rows of a batch-split result, in rank order along the
    leading axis (the global array of the JAX function's out_specs)."""
    return all_gather(x, mesh, axis, 0)


# ---------------------------------------------------------------------------
# Collectives over one mesh axis
# ---------------------------------------------------------------------------

def _staged(name: str, x: torch.Tensor, mesh: Mesh, axis: str) -> bool:
    stage = (x.is_cuda and name not in _GLOO_CUDA
             and dist.get_backend(mesh.groups[axis]) == "gloo")
    if stage:
        STAGED[name] = STAGED.get(name, 0) + 1
    return stage


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of x over `axis` (psum), as a new tensor."""
    y = x.contiguous().clone()
    if mesh.shape[axis] > 1:
        dist.all_reduce(y, group=mesh.groups[axis])
    return y


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """The pieces of every rank on `axis`, concatenated along `dim` in axis
    order (all_gather tiled=True)."""
    if mesh.shape[axis] == 1:
        return x
    stage = _staged("all_gather", x, mesh, axis)
    src = x.detach().contiguous()
    src = src.cpu() if stage else src
    parts = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, src, group=mesh.groups[axis])
    return torch.cat(parts, dim).to(x.device)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """The sum over `axis`, of which this rank keeps its piece along `dim`
    (psum_scatter tiled=True). A sum then a slice: gloo has no
    reduce_scatter."""
    if mesh.shape[axis] == 1:
        return x
    total = all_reduce(x, mesh, axis)
    w = x.shape[dim] // mesh.shape[axis]
    return total.narrow(dim, mesh.coords[axis] * w, w).contiguous()


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str, src_index: int) -> torch.Tensor:
    """x of the rank at index `src_index` on `axis`, on every rank of it."""
    y = x.contiguous().clone()
    if mesh.shape[axis] > 1:
        dist.broadcast(y, src=mesh.ranks[axis][src_index], group=mesh.groups[axis])
    return y


def send(x: torch.Tensor, mesh: Mesh, axis: str, dst_index: int) -> None:
    """Point-to-point send to the rank at `dst_index` on `axis` (ppermute's
    half)."""
    stage = _staged("send", x, mesh, axis)
    dist.send(x.contiguous().cpu() if stage else x.contiguous(),
              dst=mesh.ranks[axis][dst_index], group=mesh.groups[axis])


def recv(like: torch.Tensor, mesh: Mesh, axis: str, src_index: int) -> torch.Tensor:
    """Receive a tensor shaped and typed as `like` from the rank at
    `src_index` on `axis`."""
    stage = _staged("recv", like, mesh, axis)
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if stage else like.device)
    dist.recv(buf, src=mesh.ranks[axis][src_index], group=mesh.groups[axis])
    return buf.to(like.device)
