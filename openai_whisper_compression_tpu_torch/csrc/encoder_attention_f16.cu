// The f16 tensor-core bodies of the encoder attention
// (encoder_attention.cuh): the whole body at head dim 64 and the RAGGED
// body of every capacity, compiled apart so that the build runs them beside
// the bf16 ones.
#include "encoder_attention.cuh"

int owc_encoder_attention_f16(const void* q, const void* k, const void* v, void* out, int B,
                              int H, int T, int dh, int cap, float scale,
                              const long long* strides, cudaStream_t st) {
  return launch_tc<__half>(q, k, v, out, B, H, T, dh, cap, scale, strides, st);
}
