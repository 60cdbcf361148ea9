"""Parameter tree: seeded init, conversion from the JAX tree, tree utilities.

Same layout as the JAX package's `models/params.py`: nested dicts with
Python lists of layers; linear weights are (in_dim, out_dim) so the hot
contraction is `x @ w`; conv-stem weights keep torch's (out, in, width);
`decoder.embed` is (vocab, d) and doubles as the tied output projection.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..config import WhisperArch
from ..ops.qtensor import QTensor

Params = dict[str, Any]

INIT_STD = 0.02  # HF WhisperConfig.init_std, as in the JAX init_params


def sinusoid_positions(length: int, channels: int,
                       max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper encoder sinusoidal positions, concat(sin, cos) layout."""
    assert channels % 2 == 0
    log_inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


DEFAULT_DEVICE = "cuda"  # the entry points run on the card unless told otherwise


def resolve_device(device: str | torch.device) -> torch.device:
    """`device` as a torch.device. A CUDA device where torch sees no card
    raises here, as torch raises for a CUDA tensor, so that a call naming
    no device never falls back to the CPU; pass device="cpu" for that."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run on the CPU")
    return device


def init_params(arch: WhisperArch, seed: int = 0, dtype=torch.float32,
                device: str | torch.device = DEFAULT_DEVICE) -> Params:
    """Random-init tree with the JAX `init_params` layout and statistics
    (normal(0, 0.02) linears/conv/embeddings/decoder positions, zero biases,
    unit layernorms, sinusoidal encoder positions). Draws come from a
    `torch.Generator` seeded with `seed` on `device`, so they are not the
    JAX draws; parity tests convert JAX's tree with `from_numpy` instead."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, ffn = arch.d_model, arch.ffn_dim

    def normal(*shape):
        x = torch.randn(*shape, generator=gen, device=device,
                        dtype=torch.float32) * INIT_STD
        return x.to(dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    def linear(i, o, bias=True):
        p = {"w": normal(i, o)}
        if bias:
            p["b"] = zeros(o)
        return p

    def ln():
        return {"g": torch.ones(d, dtype=dtype, device=device), "b": zeros(d)}

    def attn():
        return {"q": linear(d, d), "k": linear(d, d, bias=False),
                "v": linear(d, d), "o": linear(d, d)}

    def enc_layer():
        return {"attn": attn(), "attn_ln": ln(), "fc1": linear(d, ffn),
                "fc2": linear(ffn, d), "mlp_ln": ln()}

    def dec_layer():
        p = enc_layer()
        p["cross"] = attn()
        p["cross_ln"] = ln()
        return p

    pos = sinusoid_positions(arch.max_source_positions, d)
    encoder = {
        "conv1": {"w": normal(d, arch.num_mel_bins, 3), "b": zeros(d)},
        "conv2": {"w": normal(d, d, 3), "b": zeros(d)},
        "pos": torch.from_numpy(pos).to(device=device, dtype=dtype),
        "layers": [enc_layer() for _ in range(arch.encoder_layers)],
        "ln": ln(),
    }
    decoder = {
        "embed": normal(arch.vocab_size, d),
        "pos": normal(arch.max_target_positions, d),
        "layers": [dec_layer() for _ in range(arch.decoder_layers)],
        "ln": ln(),
    }
    return {"encoder": encoder, "decoder": decoder}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch twin in numpy
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":  # nor has fp8: its bytes carry over
        return torch.from_numpy(np.array(a).view(np.uint8)).to(device).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def from_numpy(tree: Any, device: str | torch.device = DEFAULT_DEVICE) -> Any:
    """Port tree from the JAX parameter tree with numpy leaves. QTensor
    leaves arrive as objects with the JAX QTensor's fields (after
    `jax.tree.map(np.asarray, ...)`); every field carries over, the
    activation mode `act` and its frozen `act_scale` included. numpy has no
    fp8 type: the data of an "fp8" leaf may arrive as ml_dtypes'
    float8_e4m3fn or as its bytes (`np.asarray(x).view(np.uint8)`), which
    are viewed as `torch.float8_e4m3fn`."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_numpy(v, device) for v in tree]
    if hasattr(tree, "kind") and hasattr(tree, "scale"):
        fields = {f: _tensor(getattr(tree, f), device)
                  for f in ("data", "scale", "zero", "scale2", "offset2",
                            "act_scale")
                  if getattr(tree, f, None) is not None}
        if tree.kind == "fp8" and fields["data"].dtype == torch.uint8:
            fields["data"] = fields["data"].view(torch.float8_e4m3fn)
        return QTensor(**fields, kind=tree.kind, bits=int(tree.bits),
                       shape=tuple(tree.shape), block_size=int(tree.block_size),
                       act=getattr(tree, "act", None))
    return _tensor(tree, device)


def tree_to(params: Any, device: str | torch.device,
            dtype: torch.dtype | None = None) -> Any:
    """Move every leaf to `device`, casting dense leaves to `dtype` where one
    is given (QTensor data and scales keep their types)."""
    if isinstance(params, dict):
        return {k: tree_to(v, device, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [tree_to(v, device, dtype) for v in params]
    if isinstance(params, QTensor):
        return params.to(device)
    return params.to(device=device, dtype=dtype)


def tree_cast(params: Any, dtype: torch.dtype) -> Any:
    """Cast floating leaves to `dtype` (QTensors and integer leaves stay)."""
    if isinstance(params, dict):
        return {k: tree_cast(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [tree_cast(v, dtype) for v in params]
    if isinstance(params, QTensor) or not params.is_floating_point():
        return params
    return params.to(dtype)


def leaf_count(params: Any) -> int:
    """Total logical parameter count (a quantized leaf counts its logical
    (K, N) size)."""
    return sum(math.prod(leaf.shape) if isinstance(leaf, QTensor) else leaf.numel()
               for _, leaf in named_leaves(params) if leaf is not None)


def size_in_bytes(params: Any) -> int:
    """Stored size in bytes (quantized leaves count their packed bytes and
    every scale, zero, offset and activation-scale array)."""
    return sum(leaf.nbytes() if isinstance(leaf, QTensor)
               else leaf.numel() * leaf.element_size()
               for _, leaf in named_leaves(params) if leaf is not None)


def size_in_mb(params: Any) -> float:
    """`size_in_bytes` in MiB."""
    return size_in_bytes(params) / 2 ** 20


def disk_size_in_mb(params: Any, compressed: bool = False) -> float:
    """Serialized size in MiB: the stored bytes (`size_in_mb`), or with
    `compressed` the size of the tree's npz-deflate file
    (`storage.formats.save_npz`, written to a temporary directory)."""
    if not compressed:
        return size_in_mb(params)
    import os
    import tempfile

    from ..storage.formats import save_npz

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "m.npz")
        save_npz(params, path)
        return os.path.getsize(path) / 2 ** 20


def copy_tree(params: Any) -> Any:
    """Copy of the dict/list structure (leaves shared), so that `set_leaf`
    on the copy leaves the input alone."""
    if isinstance(params, dict):
        return {k: copy_tree(v) for k, v in params.items()}
    if isinstance(params, list):
        return [copy_tree(v) for v in params]
    return params


def named_leaves(params: Params, prefix: str = "") -> list[tuple[str, Any]]:
    """Flat (dotted-name, leaf) pairs, e.g. 'decoder.layers.3.attn.q.w'."""
    out: list[tuple[str, Any]] = []
    if isinstance(params, dict):
        for k, v in params.items():
            out.extend(named_leaves(v, f"{prefix}{k}."))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.extend(named_leaves(v, f"{prefix}{i}."))
    else:
        out.append((prefix[:-1], params))
    return out


def get_leaf(params: Params, name: str):
    """The leaf at dotted name `name` (as `named_leaves` names it)."""
    node = params
    for part in name.split("."):
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    return node


def set_leaf(params: Params, name: str, value) -> None:
    parts = name.split(".")
    node = params
    for part in parts[:-1]:
        node = node[int(part)] if isinstance(node, list) else node[part]
    if isinstance(node, list):
        node[int(parts[-1])] = value
    else:
        node[parts[-1]] = value

