// The C entry points of the fused cache update + decode self-attention
// kernels and of the read-only attention (self_attention_step.cuh), and
// their whole bodies (head dims 16, 32, 64, 128); the RAGGED bodies of each
// capacity are compiled apart, in self_attention_step_r{16,...,256}.cu.
#include "self_attention_step.cuh"

OWC_SA_DEFINE(d16, 16, false)
OWC_SA_DEFINE(d32, 32, false)
OWC_SA_DEFINE(d64, 64, false)
OWC_SA_DEFINE(d128, 128, false)
OWC_SA_DECLARE(r16)
OWC_SA_DECLARE(r32)
OWC_SA_DECLARE(r64)
OWC_SA_DECLARE(r128)
OWC_SA_DECLARE(r256)

namespace {

// The launcher of capacity cap for head dim dh: the whole body where dh =
// cap <= 128, else cap's RAGGED one; null where dh is not served by cap.
template <typename FN>
FN pick(int dh, int cap, FN d16, FN d32, FN d64, FN d128, FN r16, FN r32, FN r64, FN r128,
        FN r256) {
  if (dh < 1 || dh > cap || (cap > 16 && 2 * dh <= cap)) return nullptr;
  const bool whole = dh == cap;
  switch (cap) {
    case 16: return whole ? d16 : r16;
    case 32: return whole ? d32 : r32;
    case 64: return whole ? d64 : r64;
    case 128: return whole ? d128 : r128;
    case 256: return r256;
    default: return nullptr;
  }
}

using FpFn = int (*)(OWC_SA_FP_ARGS);
using I8Fn = int (*)(OWC_SA_I8_ARGS);

FpFn fp_of(int dh, int cap) {
  return pick<FpFn>(dh, cap, owc_sa_fp_d16, owc_sa_fp_d32, owc_sa_fp_d64, owc_sa_fp_d128,
                    owc_sa_fp_r16, owc_sa_fp_r32, owc_sa_fp_r64, owc_sa_fp_r128,
                    owc_sa_fp_r256);
}

I8Fn int8_of(int dh, int cap) {
  return pick<I8Fn>(dh, cap, owc_sa_int8_d16, owc_sa_int8_d32, owc_sa_int8_d64,
                    owc_sa_int8_d128, owc_sa_int8_r16, owc_sa_int8_r32, owc_sa_int8_r64,
                    owc_sa_int8_r128, owc_sa_int8_r256);
}

}  // namespace

// In every entry point `dtype` is the code (common.cuh) of the element type
// that q, the fresh rows, an fp cache and out share: f32, bf16 or f16; `dh`
// the head dim, 1..256, and `cap` its capacity, the smallest of 16, 32, 64,
// 128, 256 that is >= dh (dh = cap <= 128 runs the whole body, any other
// the RAGGED body of cap). The whole bodies need 16-byte aligned tensors.

// q/k_new/v_new (BH, dh), k_cache/v_cache (BH, S, dh) updated in place,
// out (BH, dh). start: (BH,) int32 first attending position of each row, or
// null for 0. Requires 0 <= start[g] <= pos < S <= 2^31 - 257.
extern "C" int owc_self_attention_update(const void* q, const void* k_new,
                                         const void* v_new, void* k_cache,
                                         void* v_cache, void* out,
                                         const void* start, int BH, int S,
                                         int pos, int dtype, int dh, int cap,
                                         void* stream) {
  const FpFn fn = fp_of(dh, cap);
  return fn ? fn(true, q, k_new, v_new, k_cache, v_cache, out, start, BH, S, pos, dtype, dh,
                 static_cast<cudaStream_t>(stream))
            : (int)cudaErrorInvalidValue;
}

// The same attention over caches whose row pos is already written; nothing
// is written but out. q (BH, dh), k_cache/v_cache (BH, S, dh), out (BH, dh);
// start as above. Requires 0 <= start[g] <= pos < S <= 2^31 - 257.
extern "C" int owc_self_attention(const void* q, void* k_cache, void* v_cache,
                                  void* out, const void* start, int BH, int S,
                                  int pos, int dtype, int dh, int cap, void* stream) {
  const FpFn fn = fp_of(dh, cap);
  return fn ? fn(false, q, nullptr, nullptr, k_cache, v_cache, out, start, BH, S, pos,
                 dtype, dh, static_cast<cudaStream_t>(stream))
            : (int)cudaErrorInvalidValue;
}

// q/k_new/v_new (BH, dh); k_cache/v_cache (BH, S, dh) int8 and
// k_scale/v_scale (BH, S) f32, all four updated in place at row pos;
// out (BH, dh). start: (BH,) int32 first attending position of each row, or
// null for 0. Requires 0 <= start[g] <= pos < S <= 2^31 - 257.
extern "C" int owc_self_attention_update_int8(const void* q, const void* k_new,
                                              const void* v_new, void* k_cache,
                                              void* v_cache, void* k_scale,
                                              void* v_scale, void* out,
                                              const void* start, int BH, int S,
                                              int pos, int dtype, int dh, int cap,
                                              void* stream) {
  const I8Fn fn = int8_of(dh, cap);
  return fn ? fn(true, q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, out, start, BH,
                 S, pos, dtype, dh, static_cast<cudaStream_t>(stream))
            : (int)cudaErrorInvalidValue;
}

// The same attention over an int8 cache whose row pos (codes and scales) is
// already written; nothing is written but out. q (BH, dh), k_cache/v_cache
// (BH, S, dh) int8, k_scale/v_scale (BH, S) f32, out (BH, dh); start as
// above. Requires 0 <= start[g] <= pos < S <= 2^31 - 257.
extern "C" int owc_self_attention_int8(const void* q, void* k_cache,
                                       void* v_cache, void* k_scale,
                                       void* v_scale, void* out,
                                       const void* start, int BH, int S,
                                       int pos, int dtype, int dh, int cap, void* stream) {
  const I8Fn fn = int8_of(dh, cap);
  return fn ? fn(false, q, nullptr, nullptr, k_cache, v_cache, k_scale, v_scale, out, start,
                 BH, S, pos, dtype, dh, static_cast<cudaStream_t>(stream))
            : (int)cudaErrorInvalidValue;
}
