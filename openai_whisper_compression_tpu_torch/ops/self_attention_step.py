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
"""

from __future__ import annotations

import torch

from . import kernels
from .qtensor import quantize_absmax

HEAD_DIM = 64
# element type of an fp cache -> what its launch counters carry after
# `launches`
_FP_COUNTER = {torch.bfloat16: "", torch.float32: "_f32", torch.float16: "_f16"}


def _count(fn, attr: str) -> None:
    setattr(fn, attr, getattr(fn, attr) + 1)


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


def _require_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The kernels read and write cache rows (and the fp kernel q and the
    fresh rows) in 16-byte pieces."""
    kernels.require(all(t.data_ptr() % 16 == 0 for t in tensors), name,
                    "q, the fresh rows and the caches must start on a "
                    "16-byte boundary")


def decode_self_attention_update(q: torch.Tensor, k_new: torch.Tensor,
                                 v_new: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, pos: int,
                                 start: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """q/k_new/v_new (BH, Dh), q pre-scaled by Dh**-0.5; caches (BH, S, Dh)
    written at row `pos` IN PLACE; attention over rows start..pos, `start`
    (BH,) int32 with start <= pos (rows 0..pos without it). Returns
    (BH, Dh) in q's dtype. A CUDA tensor launches the kernel (f32, bf16 or
    f16, one type for all five tensors, each on a 16-byte boundary; counted in
    `decode_self_attention_update.launches` for bf16, `.launches_f32`,
    `.launches_f16`, with `start` in that attribute + `_start`); a CPU tensor
    takes the plain version."""
    pos = int(pos)
    if not q.is_cuda:
        return decode_self_attention_update_ref(q, k_new, v_new, k_cache,
                                                v_cache, pos, start)
    name = "decode_self_attention_update"
    bh, dh = q.shape
    s = k_cache.shape[1]
    kernels.require(dh == HEAD_DIM, name, f"head dim must be {HEAD_DIM}, got {dh}")
    kernels.require(k_new.shape == q.shape and v_new.shape == q.shape, name,
                    "q, k_new and v_new must have one shape")
    kernels.require(k_cache.shape == (bh, s, dh) and v_cache.shape
                    == k_cache.shape, name, f"caches must be ({bh}, S, {dh})")
    kernels.require(0 <= pos < s and s <= 12288, name,
                    f"pos {pos} outside the {s}-row cache (at most 12288 rows)")
    code = kernels.dtype_code(q, name, k_new, v_new, k_cache, v_cache)
    kernels.require(len({t.device for t in (q, k_new, v_new, k_cache, v_cache)})
                    == 1, name, "q, k/v and the caches must share a device")
    kernels.require(all(t.is_contiguous() for t in
                        (q, k_new, v_new, k_cache, v_cache)), name,
                    "inputs must be contiguous")
    _require_aligned(name, q, k_new, v_new, k_cache, v_cache)
    start_ptr = _start_arg(name, start, q)
    out = torch.empty_like(q)
    err = kernels.lib().owc_self_attention_update(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), start_ptr, bh, s, pos, code,
        kernels.stream_of(q))
    kernels.check(name, err)
    _count(decode_self_attention_update, "launches" + _FP_COUNTER[q.dtype]
           + ("" if start is None else "_start"))
    return out


for _suffix in _FP_COUNTER.values():   # bf16, f32, f16 caches
    setattr(decode_self_attention_update, "launches" + _suffix, 0)   # without start
    setattr(decode_self_attention_update, "launches" + _suffix + "_start", 0)


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
    name = "decode_self_attention_update_int8"
    bh, dh = q.shape
    s = k_cache.shape[1]
    tensors = (q, k_new, v_new, k_cache, v_cache, k_scale, v_scale)
    kernels.require(dh == HEAD_DIM, name, f"head dim must be {HEAD_DIM}, got {dh}")
    kernels.require(k_new.shape == q.shape and v_new.shape == q.shape, name,
                    "q, k_new and v_new must have one shape")
    kernels.require(k_cache.shape == (bh, s, dh) and v_cache.shape
                    == k_cache.shape, name, f"caches must be ({bh}, S, {dh})")
    kernels.require(k_scale.shape == (bh, s) and v_scale.shape == (bh, s),
                    name, f"scales must be ({bh}, {s})")
    kernels.require(0 <= pos < s and s <= 12288, name,
                    f"pos {pos} outside the {s}-row cache (at most 12288 rows)")
    code = kernels.dtype_code(q, name, k_new, v_new)
    kernels.require_dtype(name, torch.int8, k_cache, v_cache)
    kernels.require_dtype(name, torch.float32, k_scale, v_scale)
    kernels.require(len({t.device for t in tensors}) == 1, name,
                    "q, k/v, the caches and the scales must share a device")
    kernels.require(all(t.is_contiguous() for t in tensors), name,
                    "inputs must be contiguous")
    _require_aligned(name, k_cache, v_cache)
    start_ptr = _start_arg(name, start, q)
    out = torch.empty_like(q)
    err = kernels.lib().owc_self_attention_update_int8(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        out.data_ptr(), start_ptr, bh, s, pos, code, kernels.stream_of(q))
    kernels.check(name, err)
    _count(decode_self_attention_update_int8,
           "launches" + ("" if start is None else "_start"))
    return out


decode_self_attention_update_int8.launches = 0         # without start
decode_self_attention_update_int8.launches_start = 0   # with start


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
    (q f32, bf16 or f16, an fp cache in q's type, q and the caches on
    16-byte boundaries; counted in
    `decode_self_attention.launches` for a bf16 cache, `.launches_f32`,
    `.launches_f16` and `.launches_int8` for an int8 one, with `start` in
    that attribute + `_start`); a CPU tensor takes the plain version."""
    pos = int(pos)
    if not q.is_cuda:
        return decode_self_attention_ref(q, k_cache, v_cache, pos, start,
                                         k_scale, v_scale)
    name = "decode_self_attention"
    bh, dh = q.shape
    s = k_cache.shape[1]
    int8 = k_scale is not None or v_scale is not None
    tensors = [q, k_cache, v_cache]
    kernels.require(dh == HEAD_DIM, name, f"head dim must be {HEAD_DIM}, got {dh}")
    kernels.require(k_cache.shape == (bh, s, dh) and v_cache.shape
                    == k_cache.shape, name, f"caches must be ({bh}, S, {dh})")
    kernels.require(0 <= pos < s and s <= 12288, name,
                    f"pos {pos} outside the {s}-row cache (at most 12288 rows)")
    if int8:
        code = kernels.dtype_code(q, name)
        kernels.require(k_scale is not None and v_scale is not None, name,
                        "an int8 cache needs both k_scale and v_scale")
        kernels.require(k_scale.shape == (bh, s) and v_scale.shape == (bh, s),
                        name, f"scales must be ({bh}, {s})")
        kernels.require_dtype(name, torch.int8, k_cache, v_cache)
        kernels.require_dtype(name, torch.float32, k_scale, v_scale)
        _require_aligned(name, k_cache, v_cache)
        tensors += [k_scale, v_scale]
    else:
        code = kernels.dtype_code(q, name, k_cache, v_cache)
        _require_aligned(name, q, k_cache, v_cache)
    kernels.require(len({t.device for t in tensors}) == 1, name,
                    "q, the caches and the scales must share a device")
    kernels.require(all(t.is_contiguous() for t in tensors), name,
                    "inputs must be contiguous")
    start_ptr = _start_arg(name, start, q)
    out = torch.empty_like(q)
    if int8:
        err = kernels.lib().owc_self_attention_int8(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(), start_ptr,
            bh, s, pos, code, kernels.stream_of(q))
    else:
        err = kernels.lib().owc_self_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            start_ptr, bh, s, pos, code, kernels.stream_of(q))
    kernels.check(name, err)
    _count(decode_self_attention,
           "launches" + ("_int8" if int8 else _FP_COUNTER[q.dtype])
           + ("" if start is None else "_start"))
    return out


for _suffix in (*_FP_COUNTER.values(), "_int8"):   # bf16, f32, f16, int8 caches
    setattr(decode_self_attention, "launches" + _suffix, 0)   # without start
    setattr(decode_self_attention, "launches" + _suffix + "_start", 0)
