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
// `/ 127.0` compiles under jit; the quotient is that of an IEEE division
// (the build has no fast-math flags) and rint rounds half to even like
// jnp.round.
//
// What bounds it on the H100: device-memory bytes. It reads the projection
// once and writes a quarter (bf16 input) of its bytes back: at whisper-small,
// batch 96, 221 MB in and 120 MB out per tensor (0.102 ms at 3.35 TB/s), 24
// tensors per batch. The kernel this one replaced ran at 30% of that: it read
// x one 2-byte element a thread at a time, 64-position tiles wrote each code
// row in half-lines, and an IEEE division per element (a ~20-instruction
// subroutine) made it instruction-bound.
//
// Design: one block (8 warps) per (b, h, tile of 128 positions); several
// blocks an SM, so one block's loads run under another's stores.
// - Loads: 16 bytes a lane. A position's 64 dims are 128 contiguous bytes in
//   bf16 or f16 (8 lanes) or 256 in f32 (16 lanes); each lane loads the same
//   16 bytes of 4 neighbouring positions, so a warp step brings whole lines
//   and every lane ends up holding 4 positions of the same dims.
// - Scales: a position's absmax is the lane's own maximum, then a shuffle
//   over the 8 (16) lanes of the position: no shared memory, no barrier.
// - Codes: v * (1 / scale) rounds to the same integer as the IEEE quotient
//   v / scale unless it lies within 2^-10 of a half-integer (the product is
//   within 2^-22 relative of the quotient, far less than that margin at
//   |v / scale| <= 127); those rare elements take the IEEE division itself,
//   so every code equals the plain version's bit for bit.
// - Transpose: a lane's 4 positions of one dim are one 32-bit word of that
//   dim's code row, stored to a [64][128] byte tile in shared memory whose
//   16-byte chunks are XOR-swizzled by the row, so the 32 words a warp stores
//   fall on 32 banks (f32 input: 16, two lanes a bank) and a row reads back
//   as whole 16-byte chunks. After one barrier each row of 128 codes leaves
//   as a whole 128-byte line (8 lanes, 16 bytes each).
// Any S and H work (S_pad is a multiple of 128); the head dim is 64.
#include "common.cuh"

namespace {

constexpr int DH = 64, TS = 128, THREADS = 256;
constexpr int CHUNKS = TS / 16;  // 16-byte chunks of a code row

__device__ __forceinline__ void unpack(const uint4& r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8], __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8], __half) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// The int8 code of v under `scale`, given r = 1 / scale: the product's
// rounding unless the product lies near a half-integer, where only the IEEE
// quotient decides (see the header).
__device__ __forceinline__ int code_of(float v, float scale, float r) {
  float y = v * r;
  const float k = rintf(y);
  if (fabsf(y - k) > 0.5f - 0.0009765625f) y = v / scale;
  return min(max(__float2int_rn(y), -127), 127);
}

// The 32-bit word of tile row `row` at word `word` (4 positions of codes),
// its 16-byte chunk swizzled by the row's group of 8.
__device__ __forceinline__ int tile_word(int row, int word) {
  return row * (TS / 4) + ((((word >> 2) ^ (row >> 3)) & (CHUNKS - 1)) << 2) + (word & 3);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
transpose_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                       float* __restrict__ scales, int S, int H, int S_pad) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte load holds: 8 or 4
  constexpr int L = DH / V;          // lanes a position: 8 or 16
  constexpr int Q = 32 / L;          // lane groups a warp step: 4 or 2
  constexpr int STEPS = 16 / (4 * Q);  // steps for a warp's 16 positions
  __shared__ __align__(16) uint32_t tile[DH * TS / 4];
  const int s_base = blockIdx.x * TS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = lane % L, grp = lane / L;
  const size_t D = (size_t)H * DH;
  const size_t bh = (size_t)b * H + h;
  const T* xb = x + (size_t)b * S * D + (size_t)h * DH + j * V;

  uint4 raw[STEPS][4];
#pragma unroll
  for (int st = 0; st < STEPS; ++st)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s_base + 16 * warp + 4 * (st * Q + grp) + i;
      raw[st][i] = s < S ? __ldg(reinterpret_cast<const uint4*>(xb + (size_t)s * D))
                         : make_uint4(0, 0, 0, 0);
    }

#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    const int p0 = 16 * warp + 4 * (st * Q + grp);  // the lane's first position
    float v[4][V], sc[4], rc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (V == 4) unpack(raw[st][i], v[i]);
      else unpack(raw[st][i], v[i], T());
      float a = 0.0f;
#pragma unroll
      for (int k = 0; k < V; ++k) a = fmaxf(a, fabsf(v[i][k]));
#pragma unroll
      for (int o = 1; o < L; o <<= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
      sc[i] = fmaxf(a, 1e-12f) * (1.0f / 127.0f);
      rc[i] = __frcp_rn(sc[i]);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        word |= (uint32_t)(uint8_t)code_of(v[i][k], sc[i], rc[i]) << (8 * i);
      tile[tile_word(j * V + k, p0 >> 2)] = word;
    }
    if (j == 0)
      *reinterpret_cast<float4*>(scales + bh * S_pad + s_base + p0) =
          make_float4(sc[0], sc[1], sc[2], sc[3]);
  }
  __syncthreads();

  const uint4* tile16 = reinterpret_cast<const uint4*>(tile);
#pragma unroll
  for (int c = tid; c < DH * CHUNKS; c += THREADS) {
    const int row = c / CHUNKS, ch = c % CHUNKS;
    *reinterpret_cast<uint4*>(q + (bh * DH + row) * S_pad + s_base + ch * 16) =
        tile16[row * CHUNKS + ((ch ^ (row >> 3)) & (CHUNKS - 1))];
  }
}

}  // namespace

// x (B, S, H * 64) f32, bf16 or f16 (dtype code), 16-byte aligned; q
// (B * H, 64, S_pad) int8 and scales (B * H, 1, S_pad) f32, 16-byte
// aligned, every position written. Requires S <= S_pad, S_pad % 128 == 0,
// B <= 65535 and H <= 65535.
extern "C" int owc_transpose_quant_kv(const void* x, void* q, void* scales,
                                      int B, int S, int H, int S_pad, int dtype,
                                      void* stream) {
  if (S_pad % TS != 0 || S > S_pad) return (int)cudaErrorInvalidValue;
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
