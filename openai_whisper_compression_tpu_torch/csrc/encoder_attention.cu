// The C entry point of the encoder attention and its bf16 tensor-core
// bodies (encoder_attention.cuh); the f16 bodies are compiled apart, in
// encoder_attention_f16.cu, the f32 ones up to head dim 256 (3xTF32) in
// encoder_attention_f32.cu and encoder_attention_f32_wg.cu, the bf16 and
// f16 ones past 256 in encoder_attention_wide.cu, and the f32 one past 256
// (3xTF32) in encoder_attention_f32_wide.cu.
#include "encoder_attention.cuh"

// q, k, v, out: (B, H, T, dh) of element type `dtype` (common.cuh: f32,
// bf16 or f16), addressed as base + b * sb + h * sh + t * st + d, strides in
// elements, given for q, k, v and out in that order as strides[12] = {sb,
// sh, st} x 4. cap: dh's capacity, the smallest of 16, 32, 64, 128, 256 that
// is >= dh, or OWC_WIDE (dh past 256). bf16 and f16 run the tensor-core
// bodies (encoder_attention.cuh up to 256: a whole body where dh = cap has
// one, else the RAGGED body of cap; encoder_attention_wide.cu past 256): k
// and v, and past 256 q too, need 16-byte aligned rows (base pointer and
// every stride a multiple of 8 elements, positive strides), q and out
// 4-byte aligned rows at a whole body (element aligned otherwise). f32 runs
// the 3xTF32 bodies, which need element-aligned rows only. Requires T >= 1; any B * H.
extern "C" int owc_encoder_attention(const void* q, const void* k, const void* v,
                                     void* out, int B, int H, int T, int dh, int cap,
                                     float scale, const long long* strides, int dtype,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == OWC_F32)
    return cap == OWC_WIDE
               ? owc_encoder_attention_f32_wide(q, k, v, out, B, H, T, dh, scale, strides, st)
               : owc_encoder_attention_f32(q, k, v, out, B, H, T, dh, cap, scale, strides, st);
  if (cap == OWC_WIDE && (dtype == OWC_BF16 || dtype == OWC_F16))
    return owc_encoder_attention_wide(q, k, v, out, B, H, T, dh, scale, strides, dtype, st);
  switch (dtype) {
    case OWC_BF16: return launch_tc<BF>(q, k, v, out, B, H, T, dh, cap, scale, strides, st);
    case OWC_F16:
      return owc_encoder_attention_f16(q, k, v, out, B, H, T, dh, cap, scale, strides, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
