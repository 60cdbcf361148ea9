"""Tensor-parallel forward and greedy decode with explicit collectives.

The JAX package runs these bodies inside `shard_map`: every device sees its
local head / FFN shard as a plain array, the single-device primitives run
shard-locally, and the two Megatron reduction points are explicit `psum`s.
Here each rank is a process holding its shard (`mesh.shard_params`); the
same primitives of the port run on it, so the kernels see the local shapes
(6 of whisper-small's 12 heads at tp = 2; N = 384 / 1536 column splits and
K = 384 / 1536 row splits of the int8 matmul), and the reductions are
`torch.distributed` calls at JAX's points. Row-parallel biases (o, fc2) are
added after the reduction.

Layout (parallel.mesh.param_specs):
  q/k/v: column-parallel (local heads)      -> no comm
  o:     row-parallel                       -> all-reduce, then + bias
  fc1:   column-parallel                    -> no comm
  fc2:   row-parallel                       -> all-reduce, then + bias
  conv/LN/embeddings: replicated

Under autograd (the training step, `distill(mesh=)`) the reductions are
Megatron's pair: a replicated activation enters a column-parallel branch
through `_enter` (identity forward, all-reduce of the gradient) and leaves
the row-parallel one through `_psum` (all-reduce forward, identity
gradient), so every rank holds the whole gradient of each replicated leaf.

Every function takes and returns this rank's rows of the batch (its 'dp'
index; `mesh.batch_sharding` cuts them, `mesh.gather_batch` joins them).
"""

from __future__ import annotations

from typing import Any

import torch

from ..config import DecodeConfig, WhisperArch
from ..models import whisper as W
from ..models.whisper import (NEG_INF, _conv1d, _out_width, attention, embed_tokens,
                              gelu, layer_norm, merge_heads, project_out, split_heads)
from ..ops.linear import linear
from ..ops.qtensor import QTensor, dequantize
from . import mesh as mesh_lib
from .mesh import Mesh

# ---------------------------------------------------------------------------
# The reductions, with Megatron's gradients
# ---------------------------------------------------------------------------


class _AllReduce(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh_lib.all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mesh_lib.all_reduce(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    """all_gather along `dim` forward, reduce-scatter of the gradient
    backward (the transpose of a tiled all_gather)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh_lib.all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (mesh_lib.reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim),
                None, None, None)


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    if mesh.shape[axis] == 1:
        return x
    return _AllReduce.apply(x, mesh, axis) if _tracked(x) else \
        mesh_lib.all_reduce(x, mesh, axis)


def _enter(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    if mesh.shape[axis] == 1 or not _tracked(x):
        return x
    return _Enter.apply(x, mesh, axis)


def gather_leaf(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """all_gather along `dim`, differentiable (reduce-scatter backward)."""
    if mesh.shape[axis] == 1:
        return x
    return _AllGather.apply(x, mesh, axis, dim) if _tracked(x) else \
        mesh_lib.all_gather(x, mesh, axis, dim)


def _add_bias(y: torch.Tensor, b) -> torch.Tensor:
    return y + b.to(y.dtype) if b is not None else y


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _local_attn(p: dict, x: torch.Tensor, head_dim: int, mesh: Mesh, axis: str,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Self-attention over the LOCAL head shard; all-reduce after the
    row-parallel out projection, bias added once after it."""
    h = _out_width(p["q"]["w"]) // head_dim
    x = _enter(x, mesh, axis)
    q = split_heads(linear(x, p["q"]["w"], p["q"].get("b")), h)
    k = split_heads(linear(x, p["k"]["w"]), h)
    v = split_heads(linear(x, p["v"]["w"], p["v"].get("b")), h)
    o = linear(merge_heads(attention(q, k, v, mask)), p["o"]["w"])  # no bias yet
    return _add_bias(_psum(o, mesh, axis), p["o"].get("b"))


def _local_mlp(p: dict, x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    h = gelu(linear(_enter(x, mesh, axis), p["fc1"]["w"], p["fc1"].get("b")))
    y = linear(h, p["fc2"]["w"])
    return _add_bias(_psum(y, mesh, axis), p["fc2"].get("b"))


def _stem(enc: dict, mel: torch.Tensor) -> torch.Tensor:
    x = gelu(_conv1d(mel, enc["conv1"]["w"], enc["conv1"]["b"], stride=1))
    x = gelu(_conv1d(x, enc["conv2"]["w"], enc["conv2"]["b"], stride=2))
    x = x.transpose(1, 2)
    return x + enc["pos"][: x.shape[1]].to(x.dtype)


def _encode_local(params: Any, mel: torch.Tensor, arch: WhisperArch,
                  mesh: Mesh, axis: str = "tp") -> torch.Tensor:
    enc = params["encoder"]
    x = _stem(enc, mel)
    for layer in enc["layers"]:
        x = x + _local_attn(layer["attn"], layer_norm(x, layer["attn_ln"]),
                            arch.head_dim, mesh, axis)
        x = x + _local_mlp(layer, layer_norm(x, layer["mlp_ln"]), mesh, axis)
    return layer_norm(x, enc["ln"])


# ---------------------------------------------------------------------------
# Full-sequence decoder (the training step's loss and distillation)
# ---------------------------------------------------------------------------

def _decode_logits_local(params: Any, arch: WhisperArch, tokens: torch.Tensor,
                         enc_out: torch.Tensor, mesh: Mesh,
                         axis: str = "tp") -> torch.Tensor:
    """`models.whisper.decode_logits` on local heads: causal self-attention,
    cross-attention over the local heads' K/V of the replicated encoder
    states, logits from the replicated (tied) embedding on every rank."""
    dec = params["decoder"]
    dh = arch.head_dim
    l = tokens.shape[1]
    x = embed_tokens(dec, tokens)
    x = x + dec["pos"][:l].to(x.dtype)
    causal = torch.triu(torch.full((l, l), NEG_INF, dtype=torch.float32,
                                   device=x.device), diagonal=1)[None, None]
    enc_in = _enter(enc_out, mesh, axis)
    for layer in dec["layers"]:
        x = x + _local_attn(layer["attn"], layer_norm(x, layer["attn_ln"]), dh,
                            mesh, axis, mask=causal)
        c = layer["cross"]
        h = _out_width(c["q"]["w"]) // dh
        hc = _enter(layer_norm(x, layer["cross_ln"]), mesh, axis)
        q = split_heads(linear(hc, c["q"]["w"], c["q"].get("b")), h)
        k = split_heads(linear(enc_in, c["k"]["w"]), h)
        v = split_heads(linear(enc_in, c["v"]["w"], c["v"].get("b")), h)
        o = linear(merge_heads(attention(q, k, v)), c["o"]["w"])
        x = x + _add_bias(_psum(o, mesh, axis), c["o"].get("b"))
        x = x + _local_mlp(layer, layer_norm(x, layer["mlp_ln"]), mesh, axis)
    return project_out(dec, layer_norm(x, dec["ln"]))


def forward_local(params: Any, arch: WhisperArch, mel: torch.Tensor,
                  tokens: torch.Tensor, mesh: Mesh, axis: str = "tp") -> torch.Tensor:
    """`models.whisper.forward` on this rank's shard: logits (B, L, V)."""
    enc = _encode_local(params, mel, arch, mesh, axis)
    return _decode_logits_local(params, arch, tokens, enc, mesh, axis)


def nll_loss_local(params: Any, arch: WhisperArch, mel: torch.Tensor,
                   tokens: torch.Tensor, labels: torch.Tensor, mesh: Mesh,
                   axis: str = "tp") -> torch.Tensor:
    """`models.whisper.nll_loss` (the mean over this rank's rows) on the
    shard."""
    logits = forward_local(params, arch, mel, tokens, mesh, axis).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None].long())[..., 0].mean()


# ---------------------------------------------------------------------------
# Sub-byte leaves under row parallelism
# ---------------------------------------------------------------------------

SUB_BYTE = ("int4_pack", "int2_pack", "nf4", "fp4")


def _packed_along_k(leaf: QTensor) -> bool:
    """True when the data array packs sub-byte values split-half along K
    (int4/int2/nf4/fp4 always; group_asym when bits <= 4)."""
    return (leaf.kind in SUB_BYTE
            or (leaf.kind == "group_asym" and leaf.data.shape[0] != leaf.in_dim))


def tp_compatible(params: Any, mesh: Mesh | None = None) -> Any:
    """QTensors whose packed layout cannot be split under TP become dense
    f32 leaves: sub-byte kinds pack along K (split-half), so ROW-parallel
    weights (o, fc2: spec ('tp', None)) would split across the packing
    interleave. Column-parallel sub-byte weights stay packed (splitting N
    keeps the layout). `mesh` is not read; the rules do not depend on it."""
    def fix(leaf, spec):
        if isinstance(leaf, QTensor) and _packed_along_k(leaf):
            if (tuple(spec) + (None,))[0] is not None:  # row-parallel -> dense
                return dequantize(leaf, torch.float32)
        return leaf

    return mesh_lib._map2(fix, params, mesh_lib.param_specs(params))


def _place_fn(mesh: Mesh):
    def place_params(params):
        return mesh_lib.shard_params(tp_compatible(params, mesh), mesh)
    return place_params


# ---------------------------------------------------------------------------
# Tensor-parallel greedy decode (serving path for whisper-large over a slice)
# ---------------------------------------------------------------------------

def _local_cross_kv(params: Any, arch: WhisperArch, enc_out: torch.Tensor,
                    bits: int = 16) -> list:
    """Per-layer transposed CrossKV from the LOCAL column-parallel k/v
    projections: each rank holds its own heads' (B·H/tp, Dh, S_pad), in the
    kernels' layout (`models.whisper.precompute_cross_kv_t` on the shard:
    bf16 as the JAX function's, or int8 through `transpose_quant_kv` / int4
    where the decode configuration asks for it)."""
    return W.precompute_cross_kv_t(params, arch, enc_out, bits=bits)


def _cross_local(c: dict, hc: torch.Tensor, kv, head_dim: int) -> torch.Tensor:
    """One decode position's cross-attention of the local heads, before the
    out projection: the grouped kernel at one slot, or the one-query kernel
    where B·H_local % 16 != 0 (JAX's `cross_t_apply`)."""
    hq = _out_width(c["q"]["w"]) // head_dim
    cq = linear(hc, c["q"]["w"], c["q"].get("b"))                # (B, 1, Hloc*Dh)
    qf = (cq.reshape(-1, head_dim) * (head_dim ** -0.5)).to(cq.dtype)
    if kv.k_t.shape[0] % W.UNGROUPED_MODULUS != 0:
        co = W.decode_cross_attention(qf.contiguous(), kv.k_t, kv.v_t, kv.k_scale,
                                      kv.v_scale, kv.valid_len)
    else:
        co = W.decode_cross_attention_grouped(qf[:, None, :].contiguous(), kv.k_t,
                                              kv.v_t, kv.k_scale, kv.v_scale,
                                              kv.valid_len)
    return co.reshape(cq.shape[0], 1, hq * head_dim).to(hc.dtype)


def _decoder_step_local(params: Any, arch: WhisperArch, tok: torch.Tensor,
                        pos: int, cache: list, cross_kvs: list, max_len: int,
                        mesh: Mesh, axis: str) -> torch.Tensor:
    """models.decode.decoder_step with Megatron's reduction points: q/k/v
    and the self/cross KV caches live on local head shards; o and fc2
    outputs are all-reduced (bias after the reduction). Logits computed
    redundantly per rank (embedding replicated), so argmax agrees
    everywhere. The self-attention is the plain masked `attention` over the
    whole cache, as in the JAX function."""
    from ..models import cache as kv_cache

    dec = params["decoder"]
    x = embed_tokens(dec, tok)[:, None, :]
    p0 = min(pos, dec["pos"].shape[0] - 1)     # JAX's dynamic_slice clamps
    x = x + dec["pos"][p0: p0 + 1][None].to(x.dtype)
    idx = torch.arange(max_len, device=x.device)
    mask = torch.where(idx <= pos, 0.0, NEG_INF).to(torch.float32)[None, None, None, :]
    for i, layer in enumerate(dec["layers"]):
        p = layer["attn"]
        h = _out_width(p["q"]["w"]) // arch.head_dim
        hs = layer_norm(x, layer["attn_ln"])
        q = split_heads(linear(hs, p["q"]["w"], p["q"].get("b")), h)
        k = split_heads(linear(hs, p["k"]["w"]), h)
        v = split_heads(linear(hs, p["v"]["w"], p["v"].get("b")), h)
        kv_cache.update(cache[i], k, v, pos)
        k_all, v_all = kv_cache.read(cache[i], q.dtype)
        o = linear(merge_heads(attention(q, k_all, v_all, mask)), p["o"]["w"])
        x = x + _add_bias(mesh_lib.all_reduce(o, mesh, axis), p["o"].get("b"))

        c = layer["cross"]
        co = _cross_local(c, layer_norm(x, layer["cross_ln"]), cross_kvs[i],
                          arch.head_dim)
        co = linear(co, c["o"]["w"])                         # bias after the sum
        x = x + _add_bias(mesh_lib.all_reduce(co, mesh, axis), c["o"].get("b"))

        x = x + _local_mlp(layer, layer_norm(x, layer["mlp_ln"]), mesh, axis)
    x = layer_norm(x, dec["ln"])
    return project_out(dec, x)[:, 0, :]


def _cross_bits(cfg: DecodeConfig) -> int:
    return 4 if cfg.cross_kv_int4 else 8 if cfg.cross_kv_int8 else 16


@torch.inference_mode()
def _greedy_local(params: Any, mel: torch.Tensor, arch: WhisperArch, mesh: Mesh,
                  axis: str, cfg: DecodeConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX function's loop as written: the encoder, the local cross-KV,
    the forced prefix stepped one position at a time, then greedy steps
    with the suppress bias until every row has emitted EOT or the token
    limit is reached. No timestamp rules, no prompt, fp self-KV in the
    encoder's dtype (the JAX function's `init_cache` call)."""
    from ..models import cache as kv_cache
    from ..models.decode import _gen_lengths, _suppress_bias, forced_prefix

    enc_out = _encode_local(params, mel, arch, mesh, axis)
    b, device = enc_out.shape[0], enc_out.device
    eot = arch.eos_token_id
    prefix = forced_prefix(arch, cfg)
    p_len = len(prefix)
    need = p_len + cfg.max_new_tokens + 1
    max_len = min(arch.max_target_positions, -(-need // 64) * 64)
    sup = torch.from_numpy(_suppress_bias(arch, tuple(cfg.suppress_tokens))).to(device)

    cross_kvs = _local_cross_kv(params, arch, enc_out, _cross_bits(cfg))
    cache = kv_cache.init_cache(params, arch, b, max_len, dtype=enc_out.dtype,
                                device=device)
    tokens = torch.full((b, max_len), eot, dtype=torch.long, device=device)
    tokens[:, :p_len] = torch.tensor(prefix, dtype=torch.long, device=device)
    for i in range(p_len - 1):
        _decoder_step_local(params, arch, tokens[:, i], i, cache, cross_kvs,
                            max_len, mesh, axis)
    limit = min(max_len, p_len + cfg.max_new_tokens)
    pos = p_len - 1
    finished = torch.zeros(b, dtype=torch.bool, device=device)
    while pos < limit - 1 and not bool(finished.all()):
        logits = _decoder_step_local(params, arch, tokens[:, pos], pos, cache,
                                     cross_kvs, max_len, mesh, axis)
        nxt = torch.argmax(logits.float() + sup, dim=-1)
        nxt = torch.where(finished, torch.full_like(nxt, eot), nxt)
        tokens[:, pos + 1] = nxt
        finished = finished | (nxt == eot)
        pos += 1
    return tokens, p_len + _gen_lengths(tokens, p_len, pos, eot)


def make_tp_decoder(arch: WhisperArch, mesh: Mesh, params_template: Any,
                    decode_cfg: DecodeConfig) -> tuple:
    """(decode_fn, place_params): the whole TP transcription step (encoder,
    cross-KV precompute and greedy loop) on this rank's shard, caches and
    cross-KV on local heads, logits replicated. decode_fn(local_params,
    mel) takes this rank's dp rows of the mel batch and returns their
    (tokens, lengths). `params_template` is not read: the shard follows the
    tree it is given (kept for the JAX package's signature)."""
    def fn(params, mel):
        return _greedy_local(params, mel.to(mesh.device), arch, mesh, "tp",
                             decode_cfg)

    return fn, _place_fn(mesh)


def make_tp_encoder(arch: WhisperArch, mesh: Mesh, params_template: Any):
    """(encode_fn, place_params): the TP encoder, whose local computation is
    the single-device code of the port (its kernels included) on the
    shard. encode_fn(local_params, mel) -> (B_local, T, d) states."""
    @torch.inference_mode()
    def fn(params, mel):
        return _encode_local(params, mel.to(mesh.device), arch, mesh, "tp")

    return fn, _place_fn(mesh)


# ---------------------------------------------------------------------------
# Megatron-style sequence parallelism (SP) on top of TP: between the
# attention/FFN blocks, activations (layernorms, residual stream) live
# SHARDED along the sequence dim on the same 'tp' group — T/tp activation
# memory per rank at the same communication volume as plain TP (each
# all-reduce splits into an all_gather before the block and a
# reduce-scatter after).
# ---------------------------------------------------------------------------

def _local_attn_sp(p: dict, x_shard: torch.Tensor, head_dim: int, mesh: Mesh,
                   axis: str) -> torch.Tensor:
    """x_shard: (B, T/tp, d) post-LN shard -> (B, T/tp, d) attention output
    shard. all_gather(T) -> local-head attention over full T -> row-parallel
    o-proj partials -> reduce-scatter(T)."""
    x = mesh_lib.all_gather(x_shard, mesh, axis, 1)               # (B, T, d)
    h = _out_width(p["q"]["w"]) // head_dim
    q = split_heads(linear(x, p["q"]["w"], p["q"].get("b")), h)
    k = split_heads(linear(x, p["k"]["w"]), h)
    v = split_heads(linear(x, p["v"]["w"], p["v"].get("b")), h)
    o = linear(merge_heads(attention(q, k, v)), p["o"]["w"])      # partial sums
    o = mesh_lib.reduce_scatter(o, mesh, axis, 1)
    return _add_bias(o, p["o"].get("b"))


def _local_mlp_sp(p: dict, x_shard: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    x = mesh_lib.all_gather(x_shard, mesh, axis, 1)
    h = gelu(linear(x, p["fc1"]["w"], p["fc1"].get("b")))
    y = linear(h, p["fc2"]["w"])                                  # row-parallel partials
    y = mesh_lib.reduce_scatter(y, mesh, axis, 1)
    return _add_bias(y, p["fc2"].get("b"))


def _encode_local_sp(params: Any, mel: torch.Tensor, arch: WhisperArch,
                     mesh: Mesh, axis: str) -> torch.Tensor:
    """Shard-local SP+TP encoder body: conv stem replicated, then the
    residual stream stays T-sharded between blocks."""
    enc = params["encoder"]
    x = _stem(enc, mel)
    tp = mesh.shape[axis]
    t_local = x.shape[1] // tp
    x = x[:, mesh.coords[axis] * t_local: (mesh.coords[axis] + 1) * t_local]
    for layer in enc["layers"]:
        x = x + _local_attn_sp(layer["attn"], layer_norm(x, layer["attn_ln"]),
                               arch.head_dim, mesh, axis)
        x = x + _local_mlp_sp(layer, layer_norm(x, layer["mlp_ln"]), mesh, axis)
    # LN is per-token: exact on the T-shard
    return layer_norm(x, enc["ln"])


def make_tp_sp_encoder(arch: WhisperArch, mesh: Mesh, params_template: Any):
    """(encode_fn, place_params) for the sequence-parallel TP encoder:
    encode_fn(local_params, mel) -> this rank's (B_local, T/tp, d) piece
    (`mesh.all_gather` over 'tp' along dim 1 joins the sequence). Requires
    T (post-conv) divisible by the tp axis size."""
    @torch.inference_mode()
    def fn(params, mel):
        mel = mel.to(mesh.device)
        t = (mel.shape[-1] + 1) // 2
        if t % mesh.shape["tp"]:
            raise ValueError(f"T={t} not divisible by tp={mesh.shape['tp']}")
        return _encode_local_sp(params, mel, arch, mesh, "tp")

    return fn, _place_fn(mesh)

