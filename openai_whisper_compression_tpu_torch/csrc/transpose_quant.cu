// Fused transpose + int8 quantize of a cross-attention K or V projection.
//
// Replaces: openai_whisper_compression_tpu/ops/cross_attention.py
//           transpose_quant_kv (kernel body _tq_kernel).
// For x (B, S, H * 64) f32, bf16 or f16 and every (b, h, s) with s < S_pad:
//   v[d]  = x[b, s, h * 64 + d] as f32, or 0 for s >= S (padding)
//   scale = max(max_d |v[d]|, 1e-12) * f32(1 / 127)
//   q[(b * H + h), d, s]     = clamp(rint(v[d] / scale), -127, 127)  (int8)
//   scales[(b * H + h), 0, s] = scale                                 (f32)
// The scale multiplies by the f32 reciprocal of 127, as the JAX package's
// `/ 127.0` compiles under jit; the quotient is an IEEE division (the build
// has no fast-math flags) and rintf rounds half to even like jnp.round.
//
// What bounds it on the H100: device-memory bytes. It reads the projection
// once and writes a quarter (bf16 input) of its bytes back: at whisper-small,
// batch 96, 221 MB in and 113 MB out per tensor, 24 tensors per batch.
//
// Design: one block (256 threads) per (b, h, tile of 64 positions). The
// block loads its 64 x 64 slab (each position's 64 dims are contiguous in
// x, so neighbouring threads read neighbouring dims) into shared memory as
// f32, padded to 65 columns so the transposed reads spread over the banks;
// one warp reduces each position's absmax over the 64 dims; then each
// thread quantizes 4 consecutive positions of one dim row and writes them
// as one 32-bit word, so a row's 64 bytes leave in 16 neighbouring stores.
// Any S and H work (S_pad is a multiple of 64); the head dim is 64.
#include "common.cuh"

namespace {

constexpr int DH = 64, TS = 64, THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
transpose_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                       float* __restrict__ scales, int S, int H, int S_pad) {
  __shared__ float tile[TS][DH + 1];
  __shared__ float sc[TS];
  const int s_base = blockIdx.x * TS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t D = (size_t)H * DH;
  const size_t bh = (size_t)b * H + h;

  for (int i = tid; i < TS * DH; i += THREADS) {
    const int s = i / DH, d = i % DH;
    const int gs = s_base + s;
    tile[s][d] = gs < S ? owc_to_float(x[((size_t)b * S + gs) * D + h * DH + d])
                        : 0.0f;
  }
  __syncthreads();

  for (int s = warp; s < TS; s += THREADS / 32) {
    const float a = owc_warp_max(fmaxf(fabsf(tile[s][lane]), fabsf(tile[s][lane + 32])));
    if (lane == 0) {
      const float scale = fmaxf(a, 1e-12f) * (1.0f / 127.0f);
      sc[s] = scale;
      scales[bh * S_pad + s_base + s] = scale;
    }
  }
  __syncthreads();

  for (int i = tid; i < DH * (TS / 4); i += THREADS) {
    const int d = i / (TS / 4), s4 = (i % (TS / 4)) * 4;
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      word |= (uint32_t)(uint8_t)owc_quant_int8(tile[s4 + k][d], sc[s4 + k])
              << (8 * k);
    *reinterpret_cast<uint32_t*>(q + (bh * DH + d) * S_pad + s_base + s4) = word;
  }
}

}  // namespace

// x (B, S, H * 64) f32, bf16 or f16 (dtype code); q (B * H, 64, S_pad)
// int8 and scales (B * H, 1, S_pad) f32, every position written. Requires
// S <= S_pad, S_pad % 64 == 0, B <= 65535, H <= 65535 and a 4-byte aligned q.
extern "C" int owc_transpose_quant_kv(const void* x, void* q, void* scales,
                                      int B, int S, int H, int S_pad, int dtype,
                                      void* stream) {
  const dim3 grid(S_pad / TS, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scales);
  const bool ok = owc_dispatch_float(dtype, [&](auto tag) {
    using T = decltype(tag);
    transpose_quant_kernel<T><<<grid, THREADS, 0, st>>>(static_cast<const T*>(x), qo,
                                                        so, S, H, S_pad);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
