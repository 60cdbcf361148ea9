// The C entry points of the decode cross-attention kernels
// (cross_attention.cuh) and their head dim 64 instances; the other head
// dims' instances are compiled apart, in cross_attention_d{16,32,128}.cu.
#include "cross_attention.cuh"

OWC_CROSS_DEFINE(64)
OWC_CROSS_DECLARE(16)
OWC_CROSS_DECLARE(32)
OWC_CROSS_DECLARE(128)

// In both entry points `dtype` is the code (common.cuh) of the element type
// of q and out: f32, bf16 or f16, and `dh` the head dim: 16, 32, 64 or 128.

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
// k_t/v_t and scales, 4-byte aligned q rows.
extern "C" int owc_cross_attention_grouped(const void* q, const void* k_t,
                                           const void* v_t, const void* k_scale,
                                           const void* v_scale, void* out,
                                           int BH, int KQ, int row_stride,
                                           int S_pad, int s_valid, int splits,
                                           int kind, int dtype, int dh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return owc_cross_grouped_d16(q, k_t, v_t, k_scale, v_scale, out, BH, KQ, row_stride,
                                   S_pad, s_valid, splits, kind, dtype, st);
    case 32:
      return owc_cross_grouped_d32(q, k_t, v_t, k_scale, v_scale, out, BH, KQ, row_stride,
                                   S_pad, s_valid, splits, kind, dtype, st);
    case 64:
      return owc_cross_grouped_d64(q, k_t, v_t, k_scale, v_scale, out, BH, KQ, row_stride,
                                   S_pad, s_valid, splits, kind, dtype, st);
    case 128:
      return owc_cross_grouped_d128(q, k_t, v_t, k_scale, v_scale, out, BH, KQ,
                                    row_stride, S_pad, s_valid, splits, kind, dtype, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// One query per row: q and out (BH, dh); k_t/v_t, the scales and kind as
// above. splits: the blocks (1..8) of the thread block cluster that shares a
// row, each given at least one 64-position chunk of it. Requires 1 <= s_valid
// <= S_pad, S_pad a multiple of the kind's 16-byte chunk, 16-byte aligned
// k_t/v_t.
extern "C" int owc_cross_attention(const void* q, const void* k_t,
                                   const void* v_t, const void* k_scale,
                                   const void* v_scale, void* out, int BH,
                                   int splits, int S_pad, int s_valid, int kind,
                                   int dtype, int dh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return owc_cross_one_query_d16(q, k_t, v_t, k_scale, v_scale, out, BH, splits,
                                     S_pad, s_valid, kind, dtype, st);
    case 32:
      return owc_cross_one_query_d32(q, k_t, v_t, k_scale, v_scale, out, BH, splits,
                                     S_pad, s_valid, kind, dtype, st);
    case 64:
      return owc_cross_one_query_d64(q, k_t, v_t, k_scale, v_scale, out, BH, splits,
                                     S_pad, s_valid, kind, dtype, st);
    case 128:
      return owc_cross_one_query_d128(q, k_t, v_t, k_scale, v_scale, out, BH, splits,
                                      S_pad, s_valid, kind, dtype, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
