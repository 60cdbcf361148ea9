// Weight-only int8 matmul for the decode-regime linears.
//
// Replaces: openai_whisper_compression_tpu/ops/quant_matmul.py
//           int8_matmul_pallas (kernel body _int8_kernel).
// Computes: out[M, N] = (bf16(x)[M, K] @ bf16(W_int8)[K, N]) * scale[N],
//           f32 accumulation, output in x's dtype.
//
// What bounds it on the H100: at the decode shapes (M = 32 or 96 rows,
// K in {768, 3072}, N in {768, 2304, 3072}) the weight bytes are small
// (K*N int8, 0.6-2.4 MB) and the card could stream them in about a
// microsecond, so the limit is how fast the multiply-adds run and how many
// SMs have work. This first version uses CUDA cores (f32 FMA on operands
// already rounded to bf16, which is exact for bf16 x int8 products), so it
// is bounded by the f32 FMA rate, not by bytes.
//
// Design: 32x64 output tiles, 128 threads, each thread owning a 4x4 patch
// held in registers; x and W tiles of depth 32 are staged through shared
// memory as f32 (x transposed so both operands are read as float4).
// A skinny M gives few output tiles, so the K loop is split across
// grid.z until about two blocks per SM are in flight; each split writes
// an f32 partial tile to a workspace and a second small kernel sums the
// partials in a fixed order (deterministic, no atomics), applies the
// per-column scale and casts to the output dtype.
#include "common.cuh"

namespace {

constexpr int BM = 32, BN = 64, BK = 32, THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS)
int8_mm_partial(const T* __restrict__ x, const int8_t* __restrict__ w,
                float* __restrict__ part, int M, int N, int K,
                int tiles_per_split) {
  __shared__ __align__(16) float xs[BK][BM + 4];  // x tile, transposed
  __shared__ __align__(16) float ws[BK][BN];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int ktiles = K / BK;
  const int kt_begin = blockIdx.z * tiles_per_split;
  const int kt_end = min(ktiles, kt_begin + tiles_per_split);
  const int tx = tid & 15, ty = tid >> 4;  // cols tx*4.., rows ty*4..

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    {  // x tile: BM*BK values, 8 per thread
      const int r = tid >> 2, kc = (tid & 3) * 8;
      const int m = m0 + r;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = 0.0f;
        if (m < M) v = owc_round_bf16(owc_to_float(x[(size_t)m * K + k0 + kc + i]));
        xs[kc + i][r] = v;
      }
    }
    {  // W tile: BK*BN int8, one 16-byte load per thread
      const int r = tid >> 2, cc = (tid & 3) * 16;
      const int4 packed =
          *reinterpret_cast<const int4*>(w + (size_t)(k0 + r) * N + n0 + cc);
      const int8_t* b = reinterpret_cast<const int8_t*>(&packed);
#pragma unroll
      for (int i = 0; i < 16; ++i) ws[r][cc + i] = (float)b[i];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m < M) {
      *reinterpret_cast<float4*>(out + (size_t)m * N + n0 + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

template <typename T>
__global__ void int8_mm_reduce(const float* __restrict__ part,
                               const float* __restrict__ scale,
                               T* __restrict__ out, int M, int N, int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (idx >= total) return;
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp) s += part[(size_t)sp * total + idx];
  owc_store(out + idx, s * scale[idx % N]);
}

template <typename T>
void launch(const void* x, const void* w, const void* scale, void* part,
            void* out, int M, int N, int K, int splits, cudaStream_t st) {
  const int ktiles = K / BK;
  const int tps = (ktiles + splits - 1) / splits;
  dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  int8_mm_partial<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<float*>(part), M, N, K, tps);
  const size_t total = (size_t)M * N;
  const int rt = 256;
  int8_mm_reduce<T><<<(unsigned)((total + rt - 1) / rt), rt, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale),
      static_cast<T*>(out), M, N, splits);
}

}  // namespace

// x (M, K) f32/bf16, w (K, N) int8, scale (N,) f32, part (splits, M, N) f32
// workspace, out (M, N) in x's dtype. Requires K % 32 == 0, N % 64 == 0.
extern "C" int owc_int8_matmul(const void* x, const void* w, const void* scale,
                               void* part, void* out, int M, int N, int K,
                               int splits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == OWC_BF16)
    launch<__nv_bfloat16>(x, w, scale, part, out, M, N, K, splits, st);
  else
    launch<float>(x, w, scale, part, out, M, N, K, splits, st);
  return (int)cudaGetLastError();
}
