// The C entry points of the decode cross-attention kernels
// (cross_attention.cuh) and their head dim 64 instances; the other head
// dims' instances are compiled apart, in cross_attention_d{16,32,128}.cu,
// the RAGGED ones of each capacity in cross_attention_r{16,...,256}.cu and
// the WIDE body (head dims past 256) in cross_attention_wide.cu.
#include "cross_attention.cuh"

OWC_CROSS_DEFINE(64)
OWC_CROSS_DECLARE(d16)
OWC_CROSS_DECLARE(d32)
OWC_CROSS_DECLARE(d128)
OWC_CROSS_DECLARE(r16)
OWC_CROSS_DECLARE(r32)
OWC_CROSS_DECLARE(r64)
OWC_CROSS_DECLARE(r128)
OWC_CROSS_DECLARE(r256)
// the WIDE body (cross_attention_wide.cu): head dims past 256
int owc_cross_grouped_wide(const void* q, const void* k_t, const void* v_t,
                           const void* k_scale, const void* v_scale, void* out, int BH,
                           int KQ, int row_stride, int S_pad, int s_valid, int splits,
                           int kind, int dtype, int dh, cudaStream_t st);

// In both entry points `dtype` is the code (common.cuh) of the element type
// of q and out: f32, bf16 or f16; `dh` the head dim and `cap` its capacity,
// the smallest of 16, 32, 64, 128, 256 that is >= dh, or OWC_WIDE for a dh
// past 256: dh = cap <= 128 runs the whole body, a cap of 256 or less the
// RAGGED body of cap, OWC_WIDE the WIDE body (cross_attention_wide.cu, which
// takes any dh; its cluster's blocks each take at least one chunk of 16
// positions of f32 K/V, 32 of the others). Packed int4 K/V need an even dh.

// q and out: KQ slots of dh values for each of BH rows, row g at element
// g * row_stride (row_stride = KQ * dh for contiguous (BH, KQ, dh) tensors;
// larger when the call covers some of a longer window's slots). kind 0:
// k_t/v_t (BH, dh, S_pad) in q's type, scales unused (may be null). kind 1:
// k_t/v_t (BH, dh, S_pad) int8 with k_scale/v_scale (BH, 1, S_pad) f32.
// kind 2: k_t/v_t (BH, dh / 2, S_pad) split-half packed int4 with the same
// scales. splits: the blocks (1..8) of the thread block cluster that shares
// a row, each given at least one 32-position chunk of it. Requires 1 <= KQ
// <= 8, 1 <= s_valid <= S_pad, S_pad a multiple of the kind's 16-byte chunk
// (4 positions of f32, 8 of bf16 or f16, 16 of int8/int4), 16-byte aligned
// k_t/v_t and scales, 4-byte aligned q rows where dh = cap (element aligned
// otherwise).
extern "C" int owc_cross_attention_grouped(const void* q, const void* k_t,
                                           const void* v_t, const void* k_scale,
                                           const void* v_scale, void* out,
                                           int BH, int KQ, int row_stride,
                                           int S_pad, int s_valid, int splits,
                                           int kind, int dtype, int dh, int cap,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap == OWC_WIDE)
    return owc_cross_grouped_wide(q, k_t, v_t, k_scale, v_scale, out, BH, KQ, row_stride,
                                  S_pad, s_valid, splits, kind, dtype, dh, st);
  if (dh < 1 || dh > cap || (cap > 16 && 2 * dh <= cap) || (kind == 2 && dh % 2))
    return (int)cudaErrorInvalidValue;
#define OWC_GROUPED(NAME)                                                                \
  return owc_cross_grouped_##NAME(q, k_t, v_t, k_scale, v_scale, out, BH, KQ, row_stride, \
                                  S_pad, s_valid, splits, kind, dtype, dh, st)
  const bool whole = dh == cap;
  switch (cap) {
    case 16: if (whole) OWC_GROUPED(d16); OWC_GROUPED(r16);
    case 32: if (whole) OWC_GROUPED(d32); OWC_GROUPED(r32);
    case 64: if (whole) OWC_GROUPED(d64); OWC_GROUPED(r64);
    case 128: if (whole) OWC_GROUPED(d128); OWC_GROUPED(r128);
    case 256: OWC_GROUPED(r256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef OWC_GROUPED
}

// One query per row: q and out (BH, dh); k_t/v_t, the scales, kind, dh and
// cap as above. splits: the blocks (1..8) of the thread block cluster that
// shares a row, each given at least one 64-position chunk of it. Requires 1
// <= s_valid <= S_pad, S_pad a multiple of the kind's 16-byte chunk,
// 16-byte aligned k_t/v_t.
extern "C" int owc_cross_attention(const void* q, const void* k_t,
                                   const void* v_t, const void* k_scale,
                                   const void* v_scale, void* out, int BH,
                                   int splits, int S_pad, int s_valid, int kind,
                                   int dtype, int dh, int cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap == OWC_WIDE)   // the WIDE body at one slot
    return owc_cross_grouped_wide(q, k_t, v_t, k_scale, v_scale, out, BH, 1, dh, S_pad,
                                  s_valid, splits, kind, dtype, dh, st);
  if (dh < 1 || dh > cap || (cap > 16 && 2 * dh <= cap) || (kind == 2 && dh % 2))
    return (int)cudaErrorInvalidValue;
#define OWC_ONE_QUERY(NAME)                                                           \
  return owc_cross_one_query_##NAME(q, k_t, v_t, k_scale, v_scale, out, BH, splits,  \
                                    S_pad, s_valid, kind, dtype, dh, st)
  const bool whole = dh == cap;
  switch (cap) {
    case 16: if (whole) OWC_ONE_QUERY(d16); OWC_ONE_QUERY(r16);
    case 32: if (whole) OWC_ONE_QUERY(d32); OWC_ONE_QUERY(r32);
    case 64: if (whole) OWC_ONE_QUERY(d64); OWC_ONE_QUERY(r64);
    case 128: if (whole) OWC_ONE_QUERY(d128); OWC_ONE_QUERY(r128);
    case 256: OWC_ONE_QUERY(r256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef OWC_ONE_QUERY
}
