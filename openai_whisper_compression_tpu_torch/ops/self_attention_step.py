"""Fused KV-cache row write + one-query decode self-attention
(`csrc/self_attention_step.cu`), over an fp cache and over an int8 cache
with per-position scales, each with its plain version: the port of the JAX
package's `ops/self_attention_step.py::decode_self_attention_update` and
`decode_self_attention_update_int8`, with and without `start`: the first
valid cache position of each row, which masks a prompt's left padding. And
`decode_self_attention`, the same attention without the write, over a cache
whose row `pos` the caller has written (it has no caller in the JAX package
either: the decode step takes the update functions).

On the card q, the fresh rows and an fp cache share one element type,
float32, bfloat16 or float16 (the Pallas kernels are generic in it: f32
arithmetic, output in q's type); with an int8 cache only q, the fresh rows
and the output have it. A launch over an fp cache is counted per type, in
`launches` for bfloat16 and in `launches_f32` / `launches_f16`.

Every update version MUTATES its buffers: row `pos` of k_cache/v_cache (and, for
the int8 cache, position `pos` of k_scale/v_scale) is overwritten in place
(the JAX functions donate the buffers and return the updated ones; here the
caller keeps using its own tensors).

The kernels take any head dim: 16, 32, 64 and 128 run their whole bodies,
any other up to 256 the RAGGED body of its capacity
(`kernels.head_dim_capacity`), and any past 256 the WIDE body
(`csrc/self_attention_step_wide.cu`, counted also in each wrapper's
`launches_wide_dh`), which walks the head dim in chunks; both read and
write the caller's rows of Dh values where they are (no cache is padded or
copied for them); and caches of up to `MAX_CACHE_ROWS` positions. Their
wrappers take any strided or offset view where the JAX functions take an
array: q and the fresh rows, and the caches the read-only version reads,
are copied to a contiguous, aligned buffer where the kernel cannot read
them in place; a cache (or scale row) that an update writes and that is
not contiguous or not 16-byte aligned is updated in a contiguous copy,
whose row `pos` is then copied back into it.
"""

from __future__ import annotations

import torch

from . import kernels
from .qtensor import quantize_absmax

# The kernels' position arithmetic is 32-bit: a pass's last position (up to
# 255 past `pos`) must stay inside an int; offsets that meet S are 64-bit.
MAX_CACHE_ROWS = 2 ** 31 - 257
# element type of an fp cache -> what its launch counters carry after
# `launches`
_FP_COUNTER = {torch.bfloat16: "", torch.float32: "_f32", torch.float16: "_f16"}


def _count(fn, attr: str, dh: int) -> None:
    """One launch in `fn.<attr>`, and in `fn.launches_wide_dh` where head dim
    `dh` ran a WIDE body."""
    setattr(fn, attr, getattr(fn, attr) + 1)
    fn.launches_wide_dh += kernels.head_dim_capacity(dh) == kernels.WIDE


def _mask_before_start(scores: torch.Tensor,
                       start: torch.Tensor | None) -> torch.Tensor:
    """scores (BH, pos + 1) with the positions before each row's `start`
    set to -inf (zero probability); unchanged without `start`."""
    if start is None:
        return scores
    idx = torch.arange(scores.shape[1], device=scores.device)
    return scores.masked_fill(idx[None, :] < start[:, None], float("-inf"))


def decode_self_attention_update_ref(q: torch.Tensor, k_new: torch.Tensor,
                                     v_new: torch.Tensor,
                                     k_cache: torch.Tensor,
                                     v_cache: torch.Tensor, pos: int,
                                     start: torch.Tensor | None = None
                                     ) -> torch.Tensor:
    """Plain version: write row pos, then f32 masked softmax attention of
    each pre-scaled query over cache rows start..pos (0..pos without
    `start`). Returns (BH, Dh) in q's dtype."""
    k_cache[:, pos, :] = k_new.to(k_cache.dtype)
    v_cache[:, pos, :] = v_new.to(v_cache.dtype)
    return _attend_ref(q, k_cache, v_cache, pos, start)


def _attend_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                pos: int, start: torch.Tensor | None) -> torch.Tensor:
    """f32 masked softmax attention of each pre-scaled query over cache rows
    start..pos of an fp cache."""
    k = k_cache[:, : pos + 1, :].float()
    v = v_cache[:, : pos + 1, :].float()
    scores = _mask_before_start(torch.einsum("gd,gsd->gs", q.float(), k), start)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("gs,gsd->gd", probs, v).to(q.dtype)


def self_attention_cost(bh: int, s: int, dh: int, cache_itemsize: int) -> dict:
    """What the JAX self-attention kernels' `pl.CostEstimate` declares (the
    same for the update, its int8 variant and the read-only attention):
    the whole S-row cache, whatever `pos` is."""
    return kernels.cost(4 * bh * s * dh, 2 * bh * s * dh * cache_itemsize, bh * s)


def _start_arg(name: str, start: torch.Tensor | None, q: torch.Tensor) -> int | None:
    """The kernels' `start` pointer (None for the variants without it),
    after the checks of what they take: (BH,) int32, contiguous, on q's
    device."""
    if start is None:
        return None
    kernels.require(start.shape == (q.shape[0],), name,
                    f"start must be ({q.shape[0]},), got {tuple(start.shape)}")
    kernels.require_dtype(name, torch.int32, start)
    kernels.require(start.device == q.device and start.is_contiguous(), name,
                    "start must be contiguous and on q's device")
    return start.data_ptr()


def _check_sizes(name: str, q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: int) -> tuple[int, int, int]:
    """(BH, Dh, S) after the checks every version makes: q (BH, Dh) of a
    head dim the kernels take, caches (BH, S, Dh) of at most MAX_CACHE_ROWS
    rows with pos among them."""
    kernels.require(q.dim() == 2, name, f"q must be (BH, Dh), got {tuple(q.shape)}")
    bh, dh = q.shape
    s = k_cache.shape[1]
    kernels.require_head_dim(name, dh)
    kernels.require(k_cache.shape == (bh, s, dh) and v_cache.shape
                    == k_cache.shape, name, f"caches must be ({bh}, S, {dh})")
    kernels.require(0 <= pos < s <= MAX_CACHE_ROWS, name,
                    f"pos {pos} outside the {s}-row cache (at most "
                    f"{MAX_CACHE_ROWS} rows)")
    return bh, dh, s


def _in_place(bufs: tuple) -> list:
    """The buffers a kernel writes: each one itself where it is contiguous
    and 16-byte aligned, else a contiguous copy (`_write_back` copies its
    row pos back)."""
    return [t if t.is_contiguous() and t.data_ptr() % 16 == 0 else
            torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)
            for t in bufs]


def _write_back(bufs: tuple, work: list, pos: int) -> None:
    """Row pos of every copy `_in_place` made, into the caller's buffer."""
    for t, w in zip(bufs, work):
        if w is not t:
            t[:, pos].copy_(w[:, pos])


def decode_self_attention_update(q: torch.Tensor, k_new: torch.Tensor,
                                 v_new: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, pos: int,
                                 start: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """q/k_new/v_new (BH, Dh), q pre-scaled by Dh**-0.5; caches (BH, S, Dh)
    written at row `pos` IN PLACE; attention over rows start..pos, `start`
    (BH,) int32 with start <= pos (rows 0..pos without it). Returns
    (BH, Dh) in q's dtype. A CUDA tensor launches the kernel (f32, bf16 or
    f16, one type for all five tensors; counted in
    `decode_self_attention_update.launches` for bf16, `.launches_f32`,
    `.launches_f16`, with `start` in that attribute + `_start`); a CPU tensor
    takes the plain version."""
    pos = int(pos)
    if not q.is_cuda:
        return decode_self_attention_update_ref(q, k_new, v_new, k_cache,
                                                v_cache, pos, start)
    return _launch_decode_self_attention_update(q, k_new, v_new, k_cache, v_cache, pos, start)


def _launch_decode_self_attention_update(q: torch.Tensor, k_new: torch.Tensor,
                                         v_new: torch.Tensor, k_cache: torch.Tensor,
                                         v_cache: torch.Tensor, pos: int,
                                         start: torch.Tensor | None = None
                                         ) -> torch.Tensor:
    """The card path of `decode_self_attention_update`: its checks, then the
    launch. The CPU tests call it directly, with a recording stand-in for
    the kernel library."""
    name = "decode_self_attention_update"
    kernels.refuse_grad(name, q, k_new, v_new, k_cache, v_cache)
    bh, dh, s = _check_sizes(name, q, k_cache, v_cache, pos)
    kernels.require(k_new.shape == q.shape and v_new.shape == q.shape, name,
                    "q, k_new and v_new must have one shape")
    code = kernels.dtype_code(q, name, k_new, v_new, k_cache, v_cache)
    kernels.require(len({t.device for t in (q, k_new, v_new, k_cache, v_cache)})
                    == 1, name, "q, k/v and the caches must share a device")
    start_ptr = _start_arg(name, start, q)
    q, k_new, v_new = map(kernels.aligned, (q, k_new, v_new))
    work = _in_place((k_cache, v_cache))
    out = torch.empty_like(q)
    err = kernels.lib().owc_self_attention_update(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), work[0].data_ptr(),
        work[1].data_ptr(), out.data_ptr(), start_ptr, bh, s, pos, code, dh,
        kernels.head_dim_capacity(dh), kernels.stream_of(q))
    kernels.check(name, err)
    kernels.record_cost(self_attention_cost(bh, s, dh, k_cache.element_size()))
    _write_back((k_cache, v_cache), work, pos)
    _count(decode_self_attention_update, "launches" + _FP_COUNTER[q.dtype]
           + ("" if start is None else "_start"), dh)
    return out


for _suffix in _FP_COUNTER.values():   # bf16, f32, f16 caches
    setattr(decode_self_attention_update, "launches" + _suffix, 0)   # without start
    setattr(decode_self_attention_update, "launches" + _suffix + "_start", 0)
decode_self_attention_update.launches_wide_dh = 0   # head dims past 256


def decode_self_attention_update_int8_ref(q: torch.Tensor, k_new: torch.Tensor,
                                          v_new: torch.Tensor,
                                          k_cache: torch.Tensor,
                                          v_cache: torch.Tensor,
                                          k_scale: torch.Tensor,
                                          v_scale: torch.Tensor, pos: int,
                                          start: torch.Tensor | None = None
                                          ) -> torch.Tensor:
    """Plain version (the math of `_kernel_upd_i8`): quantize the fresh k/v
    rows (absmax over Dh, scale * 1/127), write them and their scales at
    `pos`, then f32 scores times the k scales over rows start..pos (0..pos
    without `start`), softmax with l summed before the v scales fold into
    the probabilities, f32 value sum. Returns (BH, Dh) in q's dtype."""
    kq, ks = quantize_absmax(k_new, dim=-1, qmax=127)
    vq, vs = quantize_absmax(v_new, dim=-1, qmax=127)
    k_cache[:, pos, :] = kq
    v_cache[:, pos, :] = vq
    k_scale[:, pos] = ks[:, 0]
    v_scale[:, pos] = vs[:, 0]
    return _attend_int8_ref(q, k_cache, v_cache, k_scale, v_scale, pos, start)


def _attend_int8_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_scale: torch.Tensor,
                     v_scale: torch.Tensor, pos: int,
                     start: torch.Tensor | None) -> torch.Tensor:
    """Attention over rows start..pos of an int8 cache, the scales folded
    into scores and probabilities (the math of the JAX `_core`)."""
    scores = torch.einsum("gd,gsd->gs", q.float(),
                          k_cache[:, : pos + 1, :].float()) * k_scale[:, : pos + 1]
    scores = _mask_before_start(scores, start)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    p = p * v_scale[:, : pos + 1]
    out = torch.einsum("gs,gsd->gd", p, v_cache[:, : pos + 1, :].float()) / l
    return out.to(q.dtype)


def decode_self_attention_update_int8(q: torch.Tensor, k_new: torch.Tensor,
                                      v_new: torch.Tensor,
                                      k_cache: torch.Tensor,
                                      v_cache: torch.Tensor,
                                      k_scale: torch.Tensor,
                                      v_scale: torch.Tensor, pos: int,
                                      start: torch.Tensor | None = None
                                      ) -> torch.Tensor:
    """q/k_new/v_new (BH, Dh), q pre-scaled by Dh**-0.5; k_cache/v_cache
    (BH, S, Dh) int8 and k_scale/v_scale (BH, S) f32, all four written at
    `pos` IN PLACE; attention over rows start..pos with the scales folded
    in, `start` (BH,) int32 with start <= pos (rows 0..pos without it).
    Returns (BH, Dh) in q's dtype. A CUDA tensor launches the kernel (q, k_new
    and v_new of one type, f32, bf16 or f16; counted in
    `decode_self_attention_update_int8.launches`, with `start` in
    `.launches_start`); a CPU tensor takes the plain version."""
    pos = int(pos)
    if not q.is_cuda:
        return decode_self_attention_update_int8_ref(
            q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, pos, start)
    return _launch_decode_self_attention_update_int8(q, k_new, v_new, k_cache, v_cache,
                                                     k_scale, v_scale, pos, start)


def _launch_decode_self_attention_update_int8(q: torch.Tensor, k_new: torch.Tensor,
                                              v_new: torch.Tensor,
                                              k_cache: torch.Tensor,
                                              v_cache: torch.Tensor,
                                              k_scale: torch.Tensor,
                                              v_scale: torch.Tensor, pos: int,
                                              start: torch.Tensor | None = None
                                              ) -> torch.Tensor:
    """The card path of `decode_self_attention_update_int8`: its checks, then
    the launch. The CPU tests call it directly, with a recording stand-in
    for the kernel library."""
    name = "decode_self_attention_update_int8"
    kernels.refuse_grad(name, q, k_new, v_new, k_cache, v_cache, k_scale, v_scale)
    bh, dh, s = _check_sizes(name, q, k_cache, v_cache, pos)
    tensors = (q, k_new, v_new, k_cache, v_cache, k_scale, v_scale)
    kernels.require(k_new.shape == q.shape and v_new.shape == q.shape, name,
                    "q, k_new and v_new must have one shape")
    kernels.require(k_scale.shape == (bh, s) and v_scale.shape == (bh, s),
                    name, f"scales must be ({bh}, {s})")
    code = kernels.dtype_code(q, name, k_new, v_new)
    kernels.require_dtype(name, torch.int8, k_cache, v_cache)
    kernels.require_dtype(name, torch.float32, k_scale, v_scale)
    kernels.require(len({t.device for t in tensors}) == 1, name,
                    "q, k/v, the caches and the scales must share a device")
    start_ptr = _start_arg(name, start, q)
    q, k_new, v_new = map(kernels.aligned, (q, k_new, v_new))
    bufs = (k_cache, v_cache, k_scale, v_scale)
    work = _in_place(bufs)
    out = torch.empty_like(q)
    err = kernels.lib().owc_self_attention_update_int8(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        *(t.data_ptr() for t in work), out.data_ptr(), start_ptr, bh, s, pos,
        code, dh, kernels.head_dim_capacity(dh), kernels.stream_of(q))
    kernels.check(name, err)
    kernels.record_cost(self_attention_cost(bh, s, dh, 1))
    _write_back(bufs, work, pos)
    _count(decode_self_attention_update_int8,
           "launches" + ("" if start is None else "_start"), dh)
    return out


decode_self_attention_update_int8.launches = 0         # without start
decode_self_attention_update_int8.launches_start = 0   # with start
decode_self_attention_update_int8.launches_wide_dh = 0   # head dims past 256


def decode_self_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, pos: int,
                              start: torch.Tensor | None = None,
                              k_scale: torch.Tensor | None = None,
                              v_scale: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Plain version of `decode_self_attention`: what the update plain
    versions compute after their write."""
    if k_scale is None:
        return _attend_ref(q, k_cache, v_cache, pos, start)
    return _attend_int8_ref(q, k_cache, v_cache, k_scale.float(),
                            v_scale.float(), pos, start)


def decode_self_attention(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, pos: int,
                          start: torch.Tensor | None = None,
                          k_scale: torch.Tensor | None = None,
                          v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """q (BH, Dh) pre-scaled by Dh**-0.5; k_cache/v_cache (BH, S, Dh) whose
    row `pos` already holds this step's key and value; an int8 cache passes
    its per-position scales k_scale/v_scale (BH, S) f32, which fold into
    scores and probabilities. Attention over rows start..pos, `start` (BH,)
    int32 with start <= pos (rows 0..pos without it). Nothing is written.
    Returns (BH, Dh) in q's dtype: on the cache an update function wrote,
    that function's output bit for bit. A CUDA tensor launches the kernel
    (q f32, bf16 or f16, an fp cache in q's type; counted in
    `decode_self_attention.launches` for a bf16 cache, `.launches_f32`,
    `.launches_f16` and `.launches_int8` for an int8 one, with `start` in
    that attribute + `_start`); a CPU tensor takes the plain version."""
    pos = int(pos)
    if not q.is_cuda:
        return decode_self_attention_ref(q, k_cache, v_cache, pos, start,
                                         k_scale, v_scale)
    return _launch_decode_self_attention(q, k_cache, v_cache, pos, start, k_scale, v_scale)


def _launch_decode_self_attention(q: torch.Tensor, k_cache: torch.Tensor,
                                  v_cache: torch.Tensor, pos: int,
                                  start: torch.Tensor | None = None,
                                  k_scale: torch.Tensor | None = None,
                                  v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The card path of `decode_self_attention`: its checks, then the launch.
    The CPU tests call it directly, with a recording stand-in for the kernel
    library."""
    name = "decode_self_attention"
    kernels.refuse_grad(name, q, k_cache, v_cache, k_scale, v_scale)
    bh, dh, s = _check_sizes(name, q, k_cache, v_cache, pos)
    int8 = k_scale is not None or v_scale is not None
    tensors = [q, k_cache, v_cache]
    if int8:
        code = kernels.dtype_code(q, name)
        kernels.require(k_scale is not None and v_scale is not None, name,
                        "an int8 cache needs both k_scale and v_scale")
        kernels.require(k_scale.shape == (bh, s) and v_scale.shape == (bh, s),
                        name, f"scales must be ({bh}, {s})")
        kernels.require_dtype(name, torch.int8, k_cache, v_cache)
        kernels.require_dtype(name, torch.float32, k_scale, v_scale)
        tensors += [k_scale, v_scale]
    else:
        code = kernels.dtype_code(q, name, k_cache, v_cache)
    kernels.require(len({t.device for t in tensors}) == 1, name,
                    "q, the caches and the scales must share a device")
    start_ptr = _start_arg(name, start, q)
    q, k_cache, v_cache, k_scale, v_scale = map(
        kernels.aligned, (q, k_cache, v_cache, k_scale, v_scale))
    out = torch.empty_like(q)
    cap = kernels.head_dim_capacity(dh)
    if int8:
        err = kernels.lib().owc_self_attention_int8(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(), start_ptr,
            bh, s, pos, code, dh, cap, kernels.stream_of(q))
    else:
        err = kernels.lib().owc_self_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            start_ptr, bh, s, pos, code, dh, cap, kernels.stream_of(q))
    kernels.check(name, err)
    kernels.record_cost(self_attention_cost(bh, s, dh, k_cache.element_size()))
    _count(decode_self_attention,
           "launches" + ("_int8" if int8 else _FP_COUNTER[q.dtype])
           + ("" if start is None else "_start"), dh)
    return out


for _suffix in (*_FP_COUNTER.values(), "_int8"):   # bf16, f32, f16, int8 caches
    setattr(decode_self_attention, "launches" + _suffix, 0)   # without start
    setattr(decode_self_attention, "launches" + _suffix + "_start", 0)
decode_self_attention.launches_wide_dh = 0   # head dims past 256
