"""Seeded Whisper weights, made on the device in two large draws.

The tree has the port's layout (nested dicts, lists of layers, linear
weights (in, out), conv weights (out, in, width), `decoder.embed` (vocab, d)
tied to the output projection), and it is what both the program and the
plain reference are given. Every leaf is a view into one of two buffers:
the linear weights, which the program quantizes and then drops, and the
rest, which it serves as they are. Each buffer is one `torch.randn` call on
a `torch.Generator` seeded with `--seed`, in the type the weights are
served in, then scaled leaf by leaf: the same seed gives the same weights
on every run. Linear and conv-stem weights are normal(0, 1/sqrt(fan_in)),
so that attention is sharp enough for the tokens to depend on the audio
(with Whisper's init_std of 0.02 everywhere, whisper-small's do not); each
MLP's second weight is then centred over its inputs (its mean over the
input axis taken out), so that the positive mean of GELU's outputs adds no
vector that is the same for every input: left in, it builds up layer by
layer, and on some seeds the decoder then emits one token everywhere by so
wide a margin that int4 weights change none of them;
embeddings, decoder positions, biases and layer-norm shifts are normal(0,
0.02), layer-norm gains 1 + normal(0, 0.02), so that no bias or gain is
exactly 0 or 1 and the check sees every one of them. Encoder positions are
Whisper's sinusoids.

A configuration may scale two groups of these deviations (its `draw`):
`conv_stem_gain` the conv stem's, so that the audio and not the sinusoids
leads the encoder's input, and `cross_query_gain` the decoder's
cross-attention queries', so that a query picks out a few audio frames, as
a trained model's alignment heads do, where a broad average over 1500 frames
is nearly the same for every clip. Both make the served tokens depend on
the audio, which the check needs to see a wrong encoder state.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STD = 0.02
ALIGN = 64            # elements: every leaf starts on a 128-byte boundary in bf16


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper's encoder positions: concat(sin, cos) (length, channels)."""
    log_inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def layout(model: dict) -> list[tuple[str, tuple, str]]:
    """(dotted path, shape, kind) of every leaf, in draw order. kind:
    "linear" (a linear weight), "normal" (other drawn weights and biases),
    "gain" (a layer-norm gain: 1 + draw), "sinusoid"."""
    d = model["d_model"]
    leaves: list[tuple[str, tuple, str]] = []

    def linear(p, i, o, bias=True):
        leaves.append((f"{p}.w", (i, o), "linear"))
        if bias:
            leaves.append((f"{p}.b", (o,), "normal"))

    def ln(p):
        leaves.append((f"{p}.g", (d,), "gain"))
        leaves.append((f"{p}.b", (d,), "normal"))

    def attn(p):
        linear(f"{p}.q", d, d)
        linear(f"{p}.k", d, d, bias=False)
        linear(f"{p}.v", d, d)
        linear(f"{p}.o", d, d)

    def layer(p, ffn, cross):
        attn(f"{p}.attn")
        ln(f"{p}.attn_ln")
        if cross:
            attn(f"{p}.cross")
            ln(f"{p}.cross_ln")
        linear(f"{p}.fc1", d, ffn)
        linear(f"{p}.fc2", ffn, d)
        ln(f"{p}.mlp_ln")

    leaves.append(("encoder.conv1.w", (d, model["num_mel_bins"], 3), "normal"))
    leaves.append(("encoder.conv1.b", (d,), "normal"))
    leaves.append(("encoder.conv2.w", (d, d, 3), "normal"))
    leaves.append(("encoder.conv2.b", (d,), "normal"))
    leaves.append(("encoder.pos", (model["max_source_positions"], d), "sinusoid"))
    for i in range(model["encoder_layers"]):
        layer(f"encoder.layers.{i}", model["encoder_ffn_dim"], cross=False)
    ln("encoder.ln")
    leaves.append(("decoder.embed", (model["vocab_size"], d), "normal"))
    leaves.append(("decoder.pos", (model["max_target_positions"], d), "normal"))
    for i in range(model["decoder_layers"]):
        layer(f"decoder.layers.{i}", model["decoder_ffn_dim"], cross=True)
    ln("decoder.ln")
    return leaves


def _set(tree: dict, path: str, value) -> None:
    parts = path.split(".")
    node = tree
    for a, b in zip(parts[:-1], parts[1:]):
        if a.isdigit():
            continue
        if b.isdigit():
            lst = node.setdefault(a, [])
            while len(lst) <= int(b):
                lst.append({})
            node = lst[int(b)]
        else:
            node = node.setdefault(a, {})
    node[parts[-1]] = value


def _offsets(shapes: list[tuple]) -> tuple[list[int], int]:
    offs, n = [], 0
    for s in shapes:
        offs.append(n)
        n += -(-math.prod(s) // ALIGN) * ALIGN
    return offs, n


DRAW_KEYS = ("conv_stem_gain", "cross_query_gain")


def make(model: dict, seed: int, device, dtype=torch.bfloat16, draw: dict | None = None) -> dict:
    """The seeded tree on `device` in `dtype`; `draw` scales groups of deviations."""
    draw = dict(draw or {})
    unknown = set(draw) - set(DRAW_KEYS)
    if unknown:
        raise ValueError(f"unknown draw keys {sorted(unknown)}; known: {DRAW_KEYS}")
    leaves = layout(model)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    tree: dict = {}
    for group in (("linear",), ("normal", "gain")):
        mine = [(p, s, k) for p, s, k in leaves if k in group]
        offs, total = _offsets([s for _, s, _ in mine])
        buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
        for (path, shape, kind), off in zip(mine, offs):
            view = buf[off: off + math.prod(shape)].view(shape)
            view.mul_(_std(path, shape, kind) * _gain(path, draw))
            if kind == "gain":
                view.add_(1.0)
            if path.endswith(".fc2.w"):     # centred over its inputs: see above
                view.sub_(view.float().mean(dim=0, keepdim=True).to(dtype))
            _set(tree, path, view)
    for path, shape, kind in leaves:
        if kind == "sinusoid":
            _set(tree, path, torch.from_numpy(sinusoids(*shape)).to(device, dtype))
    return tree


def _std(path: str, shape: tuple, kind: str) -> float:
    if kind == "linear":                                   # (in, out)
        return 1.0 / math.sqrt(shape[0])
    if path.endswith((".conv1.w", ".conv2.w")):            # (out, in, width)
        return 1.0 / math.sqrt(shape[1] * shape[2])
    return STD


def _gain(path: str, draw: dict) -> float:
    if path in ("encoder.conv1.w", "encoder.conv2.w"):
        return float(draw.get("conv_stem_gain", 1.0))
    if path.startswith("decoder.layers.") and path.endswith(".cross.q.w"):
        return float(draw.get("cross_query_gain", 1.0))
    return 1.0


def count(model: dict) -> int:
    """Parameters in the tree (the sinusoids included)."""
    return sum(math.prod(s) for _, s, _ in layout(model))


def of_config(config: dict, seed: int, device) -> dict:
    """The seeded tree of a configuration file, in the type it is served in."""
    return make(config["model"], seed, device,
                dtype=getattr(torch, config["program"]["weights_dtype"]),
                draw=config.get("draw"))
