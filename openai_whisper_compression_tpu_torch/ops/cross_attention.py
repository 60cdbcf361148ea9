"""Decode cross-attention over transposed K/V (`csrc/cross_attention.cu`),
grouped and one query per row, and the fused cross-KV transpose + int8
quantize (`csrc/transpose_quant.cu`), each with its plain version: the port
of the JAX package's `ops/cross_attention.py::decode_cross_attention_grouped`
and `decode_cross_attention` (the bf16, int8 and int4 K/V bodies of each)
and `transpose_quant_kv`.

K query slots per (batch, head) row share one K/V entry: K = 1 in a greedy
decode step, the beam width in a beam-search step, the window of prompt and
prefix positions in prefill. The kernel holds up to `MAX_SLOTS` slots, so a
longer window runs as several launches, each over its own slots and each
reading the K/V again (the JAX kernel takes any K in one call).
`decode_cross_attention` is the one-query function that the JAX package's
decode step takes where B·H is no multiple of 16 (`UNGROUPED_MODULUS`): few
rows, so its kernel splits S over the blocks of a cluster
(`one_query_splits`), in one launch. Every kernel takes any head dim (even
for packed int4 K/V): 16, 32, 64 and 128 run their whole bodies, any other
up to 256 the RAGGED body of its capacity (`kernels.head_dim_capacity`),
and any past 256 the WIDE body (`csrc/cross_attention_wide.cu` for the
cross-attentions, the quantizer's own), which walks the head dim in chunks;
a WIDE launch is also counted in the wrapper's `launches_wide_dh`. K/V storage
follows the JAX layout: (B·H, Dh, S_pad) in q's own type (float32, bfloat16
or float16: the Pallas kernels are generic in it; f32 arithmetic, output in
q's type); int8 with (B·H, 1, S_pad) f32 per-position scales; or split-half
packed int4 (B·H, Dh/2, S_pad) with the same scales, told apart from int8 by
its Dh/2 rows, as the JAX package does. A launch over fp K/V is counted per
type: in `launches` for bfloat16, in `launches_f32` and `launches_f16`.
The wrappers take any strided or offset view of their inputs (all read
only): one the kernels cannot read in place is copied to a contiguous,
aligned buffer first (`kernels.aligned`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels
from .qtensor import quantize_absmax

NEG_INF = -1e30
MAX_SLOTS = 8   # query slots per (batch, head) row one launch holds
UNGROUPED_MODULUS = 16  # a decode step with B*H % 16 != 0 takes the one-query kernel
ONE_QUERY_CHUNK = 64  # positions the one-query kernel shares out over a cluster
_ONE_QUERY_BLOCKS = 132  # blocks of the one-query kernel the H100 holds at once: one an SM
NARROW_SLOTS = 4  # launches of more slots are counted apart (`_wide`)
GROUPED_CHUNK = 32  # positions a warp of the grouped kernel takes at a time
_GROUPED_BLOCKS = 264  # blocks the grouped kernel wants: two an SM of the H100
_MAX_CLUSTER = 8       # blocks of one cluster (the portable limit)
# K/V storage kind -> (code of csrc/cross_attention.cu, positions per
# 16-byte load, launch counter on the two wrappers); "fp" is K/V in q's type
_KINDS = {"fp": (0, 8, "launches"), "fp_f32": (0, 4, "launches_f32"),
          "fp_f16": (0, 8, "launches_f16"), "int8": (1, 16, "launches_int8"),
          "int4": (2, 16, "launches_int4")}
_FP_KIND = {torch.bfloat16: "fp", torch.float32: "fp_f32", torch.float16: "fp_f16"}


def pad_cross_len(s: int) -> int:
    """S padded to a multiple of 128 (the JAX layout's lane width)."""
    return -(-s // 128) * 128


def transpose_kv(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, H*Dh) -> (B*H, Dh, S_pad), zero padded along S."""
    b, s, d = x.shape
    x = x.reshape(b, s, h, d // h).permute(0, 2, 3, 1)
    x = F.pad(x, (0, pad_cross_len(s) - s))
    return x.reshape(b * h, d // h, -1).contiguous()


def transpose_quant_kv_ref(x: torch.Tensor, h: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: `transpose_kv`, then int8 with a per-(bh, position)
    absmax scale over Dh (the JAX `_quant_kv8_t(_transpose_kv(x, h))`)."""
    return quantize_absmax(transpose_kv(x, h), dim=1, qmax=127)


def transpose_quant_kv(x: torch.Tensor, h: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H*Dh) f32/bf16/f16 -> ((B*H, Dh, S_pad) int8, (B*H, 1, S_pad)
    f32 scales), S_pad = `pad_cross_len(S)`, padding positions quantized
    from zeros. A CUDA tensor launches the kernel (any Dh; counted in
    `transpose_quant_kv.launches`, and past Dh 256 also in
    `.launches_wide_dh`); an x that is not contiguous or not 16-byte
    aligned is copied first. A CPU tensor takes the plain version."""
    if not x.is_cuda:
        return transpose_quant_kv_ref(x, h)
    return _launch_transpose_quant_kv(x, h)


def _launch_transpose_quant_kv(x: torch.Tensor, h: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The card path of `transpose_quant_kv`: its checks, then the launch. The
    CPU tests call it directly, with a recording stand-in for the kernel
    library."""
    name = "transpose_quant_kv"
    kernels.refuse_grad(name, x)
    kernels.require(x.dim() == 3 and h >= 1 and x.shape[2] % h == 0, name,
                    f"x must be (B, S, {h} * Dh), got {tuple(x.shape)}")
    b, s, d = x.shape
    dh = d // h
    kernels.require_head_dim(name, dh)
    kernels.require(b >= 1 and s >= 1, name, f"B {b} and S {s} must be >= 1")
    code = kernels.dtype_code(x, name)
    x = kernels.aligned(x)   # the kernel reads rows of x in 16-byte pieces
    s_pad = pad_cross_len(s)
    q = torch.empty((b * h, dh, s_pad), dtype=torch.int8, device=x.device)
    scale = torch.empty((b * h, 1, s_pad), dtype=torch.float32, device=x.device)
    cap = kernels.head_dim_capacity(dh)
    err = kernels.lib().owc_transpose_quant_kv(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), b, s, h, s_pad, code, dh, cap,
        kernels.stream_of(x))
    kernels.check(name, err)
    transpose_quant_kv.launches += 1
    transpose_quant_kv.launches_wide_dh += cap == kernels.WIDE
    kernels.record_cost(transpose_quant_kv_cost(b, s, h, dh, x.element_size()))
    return q, scale


def transpose_quant_kv_cost(b: int, s: int, h: int, dh: int, itemsize: int) -> dict:
    """What the JAX `transpose_quant_kv`'s `pl.CostEstimate` declares for x
    (B, S, H·Dh) of `itemsize`-byte elements."""
    s_pad, d = pad_cross_len(s), h * dh
    return kernels.cost(3 * b * s_pad * d, b * s * d * itemsize + b * d * s_pad
                        + b * h * 4 * s_pad, 0)


transpose_quant_kv.launches = 0
transpose_quant_kv.launches_wide_dh = 0   # head dims past 256


def unpack4(packed: torch.Tensor) -> torch.Tensor:
    """(G, Dh/2, S) split-half packed int4 -> (G, Dh, S) f32 in [-7, 7]:
    byte row d holds dim d in its low nibble and dim d + Dh/2 in its high
    nibble, both signed (the JAX `_unpack4`)."""
    u = packed.to(torch.int32)
    lo = ((u & 15) ^ 8) - 8
    hi = u >> 4
    return torch.cat([lo, hi], dim=1).to(torch.float32)


def decode_cross_attention_grouped_ref(q: torch.Tensor, k_t: torch.Tensor,
                                       v_t: torch.Tensor,
                                       k_scale: torch.Tensor | None = None,
                                       v_scale: torch.Tensor | None = None,
                                       s_valid: int | None = None
                                       ) -> torch.Tensor:
    """Plain version (the math of `_beam_core`): f32 scores times the k
    scale, positions >= s_valid masked, f32 softmax with l summed before the
    v scale folds into the probabilities, f32 value sum, output in q's
    dtype."""
    s_pad = k_t.shape[2]
    s_valid = s_pad if s_valid is None else s_valid
    if k_t.shape[1] == q.shape[2] // 2:   # split-half packed int4
        k, v = unpack4(k_t), unpack4(v_t)
    else:
        k, v = k_t.float(), v_t.float()
    scores = torch.einsum("gkd,gds->gks", q.float(), k)
    if k_scale is not None:
        scores = scores * k_scale.float()
    mask = torch.arange(s_pad, device=q.device) < s_valid
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:   # padding scales may hold anything
        p = torch.where(mask, p * v_scale.float(), torch.zeros_like(p))
    return torch.einsum("gks,gds->gkd", p / l, v).to(q.dtype)


def _check_kv(name: str, q: torch.Tensor, k_t: torch.Tensor, v_t: torch.Tensor,
              k_scale: torch.Tensor | None, v_scale: torch.Tensor | None,
              s_valid: int | None) -> tuple[str, int, int]:
    """The checks of what both cross-attention kernels take: q in f32, bf16
    or f16 of any head dim (even for packed int4)
    whose first axis is B·H, K/V of one storage kind (q's type without
    scales, or int8 / int4 with them) on one device. Returns (kind, S_pad,
    s_valid); the caller reads the tensors through `kernels.aligned`."""
    bh, dh = q.shape[0], q.shape[-1]
    rows, s_pad = k_t.shape[1], k_t.shape[2]
    s_valid = s_pad if s_valid is None else s_valid
    kernels.require_head_dim(name, dh)
    tensors = [q, k_t, v_t]
    if k_scale is None and v_scale is None:
        kernels.dtype_code(q, name, k_t, v_t)
        kind = _FP_KIND[q.dtype]
        kernels.require(rows == dh, name, f"fp k_t must have {dh} rows, got {rows}")
    else:
        kernels.dtype_code(q, name)
        kernels.require(k_scale is not None and v_scale is not None, name,
                        "int8/int4 K/V need both k_scale and v_scale")
        kernels.require_dtype(name, torch.int8, k_t, v_t)
        kernels.require(rows in (dh, dh // 2), name,
                        f"int8 k_t has {dh} rows and packed int4 {dh // 2}, "
                        f"got {rows}")
        kind = "int8" if rows == dh else "int4"
        kernels.require_head_dim(name, dh, int4=kind == "int4")
        kernels.require_dtype(name, torch.float32, k_scale, v_scale)
        kernels.require(k_scale.shape == (bh, 1, s_pad)
                        and v_scale.shape == k_scale.shape, name,
                        f"scales must be ({bh}, 1, {s_pad}), got "
                        f"{tuple(k_scale.shape)} and {tuple(v_scale.shape)}")
        tensors += [k_scale, v_scale]
    vec = _KINDS[kind][1]
    kernels.require(k_t.shape == (bh, rows, s_pad) and v_t.shape == k_t.shape,
                    name, f"k_t/v_t must be ({bh}, {rows}, S_pad), got "
                    f"{tuple(k_t.shape)} and {tuple(v_t.shape)}")
    kernels.require(1 <= s_valid <= s_pad and s_pad % vec == 0, name,
                    f"s_valid {s_valid} outside 1..{s_pad}, or S_pad not a "
                    f"multiple of {vec} ({kind} K/V)")
    kernels.require(len({t.device for t in tensors}) == 1, name,
                    "q, the K/V and their scales must share a device")
    return kind, s_pad, s_valid


def grouped_splits(bh: int, s_valid: int) -> int:
    """Blocks of the thread block cluster that shares one row of the grouped
    kernel: enough for `_GROUPED_BLOCKS` blocks over B·H rows, at most
    `_MAX_CLUSTER`, and no more than the row has 32-position chunks, so that
    every block gets at least one."""
    chunks = -(-s_valid // GROUPED_CHUNK)
    return max(1, min(_MAX_CLUSTER, chunks, -(-_GROUPED_BLOCKS // bh)))


def one_query_splits(bh: int, s_valid: int) -> int:
    """Blocks of the thread block cluster that shares one row of the
    one-query kernel: as many as keep B·H rows within the
    `_ONE_QUERY_BLOCKS` the card holds at once (a block more would start a
    second wave, as long as the first), at most `_MAX_CLUSTER`, and no more
    than the row has `ONE_QUERY_CHUNK`-position chunks, so that every block
    gets at least one."""
    chunks = -(-s_valid // ONE_QUERY_CHUNK)
    return max(1, min(_MAX_CLUSTER, chunks, _ONE_QUERY_BLOCKS // bh))


def decode_cross_attention_grouped(q: torch.Tensor, k_t: torch.Tensor,
                                   v_t: torch.Tensor,
                                   k_scale: torch.Tensor | None = None,
                                   v_scale: torch.Tensor | None = None,
                                   s_valid: int | None = None) -> torch.Tensor:
    """q (BH, K, Dh) pre-scaled by Dh**-0.5; k_t/v_t (BH, Dh, S_pad) bf16,
    or int8 (Dh rows) or packed int4 (Dh/2 rows) with k_scale/v_scale
    (BH, 1, S_pad) f32; positions >= s_valid are padding (zero probability).
    Returns (BH, K, Dh) in q's dtype. A CUDA tensor launches the kernel
    (S split over a cluster of `grouped_splits` blocks a row), once for
    every `MAX_SLOTS` slots of K (each storage kind counts its
    launches in its own attribute: `launches` for bf16 K/V, `launches_f32`,
    `launches_f16`, `launches_int8`, `launches_int4`, and a launch of more
    than `NARROW_SLOTS` slots in that attribute + `_wide`); a CPU tensor
    takes the plain version."""
    if not q.is_cuda:
        return decode_cross_attention_grouped_ref(q, k_t, v_t, k_scale,
                                                  v_scale, s_valid)
    return _launch_decode_cross_attention_grouped(q, k_t, v_t, k_scale, v_scale, s_valid)


def _launch_decode_cross_attention_grouped(q: torch.Tensor, k_t: torch.Tensor,
                                           v_t: torch.Tensor,
                                           k_scale: torch.Tensor | None = None,
                                           v_scale: torch.Tensor | None = None,
                                           s_valid: int | None = None) -> torch.Tensor:
    """The card path of `decode_cross_attention_grouped`: its checks, then the
    launch. The CPU tests call it directly, with a recording stand-in for
    the kernel library."""
    name = "decode_cross_attention_grouped"
    kernels.refuse_grad(name, q, k_t, v_t, k_scale, v_scale)
    bh, kq, dh = q.shape
    kernels.require(kq >= 1, name, f"at least one query slot per row, got {kq}")
    kind, s_pad, s_valid = _check_kv(name, q, k_t, v_t, k_scale, v_scale, s_valid)
    code, _, counter = _KINDS[kind]
    kernels.require(1 <= bh < 2 ** 31, name, f"B*H {bh} outside 1..2**31 - 1")
    q, k_t, v_t, k_scale, v_scale = map(kernels.aligned, (q, k_t, v_t, k_scale, v_scale))
    splits = grouped_splits(bh, s_valid)
    cap = kernels.head_dim_capacity(dh)
    out = torch.empty_like(q)
    for j0 in range(0, kq, MAX_SLOTS):   # slots j0.. of every row, in place
        offset = j0 * dh * q.element_size()
        slots = min(MAX_SLOTS, kq - j0)
        err = kernels.lib().owc_cross_attention_grouped(
            q.data_ptr() + offset, k_t.data_ptr(), v_t.data_ptr(),
            None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(),
            out.data_ptr() + offset, bh, slots, kq * dh, s_pad, s_valid, splits, code,
            kernels.DTYPE_CODES[q.dtype], dh, cap, kernels.stream_of(q))
        kernels.check(name, err)
        attr = counter + ("_wide" if slots > NARROW_SLOTS else "")
        setattr(decode_cross_attention_grouped, attr,
                getattr(decode_cross_attention_grouped, attr) + 1)
        decode_cross_attention_grouped.launches_wide_dh += cap == kernels.WIDE
    kernels.record_cost(decode_cross_attention_grouped_cost(bh, kq, dh, s_pad,
                                                            k_t.element_size()))
    return out


def decode_cross_attention_grouped_cost(bh: int, kq: int, dh: int, s_pad: int,
                                        kv_itemsize: int) -> dict:
    """What the JAX `decode_cross_attention_grouped`'s `pl.CostEstimate`
    declares for one call of K query slots (its bytes count Dh rows of K/V
    whatever the storage holds, int4's Dh/2 too)."""
    return kernels.cost(4 * bh * kq * s_pad * dh, bh * 2 * dh * s_pad * kv_itemsize,
                        bh * kq * s_pad)


for _, _, _counter in _KINDS.values():   # bf16, f32, f16, int8, int4 K/V
    setattr(decode_cross_attention_grouped, _counter, 0)            # 1..4 slots
    setattr(decode_cross_attention_grouped, _counter + "_wide", 0)  # 5..8 slots
decode_cross_attention_grouped.launches_wide_dh = 0   # any kind, head dims past 256


def decode_cross_attention_ref(q: torch.Tensor, k_t: torch.Tensor,
                               v_t: torch.Tensor,
                               k_scale: torch.Tensor | None = None,
                               v_scale: torch.Tensor | None = None,
                               s_valid: int | None = None) -> torch.Tensor:
    """Plain version of `decode_cross_attention`: the grouped plain version
    at one query slot."""
    return decode_cross_attention_grouped_ref(q[:, None, :], k_t, v_t, k_scale,
                                              v_scale, s_valid)[:, 0, :]


def decode_cross_attention(q: torch.Tensor, k_t: torch.Tensor,
                           v_t: torch.Tensor,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None,
                           s_valid: int | None = None) -> torch.Tensor:
    """q (BH, Dh) pre-scaled by Dh**-0.5, one query per (batch, head) row;
    k_t/v_t, the scales and s_valid as `decode_cross_attention_grouped`
    takes them. Returns (BH, Dh) in q's dtype. A CUDA tensor launches the
    kernel once, S split over a cluster of `one_query_splits` blocks a row
    (at a head dim with no whole body, the grouped kernel's RAGGED or WIDE
    body at one slot; each storage kind counts its launches in its own attribute: `launches`
    for bf16 K/V, `launches_f32`, `launches_f16`, `launches_int8`,
    `launches_int4`); a CPU tensor takes the plain version."""
    if not q.is_cuda:
        return decode_cross_attention_ref(q, k_t, v_t, k_scale, v_scale, s_valid)
    return _launch_decode_cross_attention(q, k_t, v_t, k_scale, v_scale, s_valid)


def _launch_decode_cross_attention(q: torch.Tensor, k_t: torch.Tensor,
                                   v_t: torch.Tensor,
                                   k_scale: torch.Tensor | None = None,
                                   v_scale: torch.Tensor | None = None,
                                   s_valid: int | None = None) -> torch.Tensor:
    """The card path of `decode_cross_attention`: its checks, then the launch.
    The CPU tests call it directly, with a recording stand-in for the kernel
    library."""
    name = "decode_cross_attention"
    kernels.refuse_grad(name, q, k_t, v_t, k_scale, v_scale)
    kernels.require(q.dim() == 2, name, f"q must be (BH, Dh), got {tuple(q.shape)}")
    kind, s_pad, s_valid = _check_kv(name, q, k_t, v_t, k_scale, v_scale, s_valid)
    code, _, counter = _KINDS[kind]
    bh, dh = q.shape
    kernels.require(1 <= bh < 2 ** 31, name, f"B*H {bh} outside 1..2**31 - 1")
    q, k_t, v_t, k_scale, v_scale = map(kernels.aligned, (q, k_t, v_t, k_scale, v_scale))
    out = torch.empty_like(q)
    cap = kernels.head_dim_capacity(dh)
    err = kernels.lib().owc_cross_attention(
        q.data_ptr(), k_t.data_ptr(), v_t.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        out.data_ptr(), bh, one_query_splits(bh, s_valid), s_pad, s_valid, code,
        kernels.DTYPE_CODES[q.dtype], dh, cap, kernels.stream_of(q))
    kernels.check(name, err)
    setattr(decode_cross_attention, counter,
            getattr(decode_cross_attention, counter) + 1)
    decode_cross_attention.launches_wide_dh += cap == kernels.WIDE
    kernels.record_cost(decode_cross_attention_cost(bh, dh, s_pad, k_t.shape[1],
                                                    k_t.element_size(), kind))
    return out


def decode_cross_attention_cost(bh: int, dh: int, s_pad: int, rows: int,
                                kv_itemsize: int, kind: str) -> dict:
    """What the JAX `decode_cross_attention`'s `pl.CostEstimate` declares:
    K/V of `rows` stored rows (Dh, or Dh/2 for packed int4), their scales
    for the int8 and int4 kinds, and q and the output."""
    if kind in ("int8", "int4"):
        nbytes = bh * (2 * rows * s_pad + 8 * s_pad + 4 * dh)
    else:
        nbytes = bh * (2 * dh * s_pad * kv_itemsize + 4 * dh)
    return kernels.cost(4 * bh * s_pad * dh, nbytes, bh * s_pad)


for _, _, _counter in _KINDS.values():   # bf16, f32, f16, int8, int4 K/V
    setattr(decode_cross_attention, _counter, 0)
decode_cross_attention.launches_wide_dh = 0   # any kind, head dims past 256
