// Weight-only dequant-matmuls for the decode-regime linears: one kernel
// templated on the weight storage (a dequant trait).
//
// Replaces: openai_whisper_compression_tpu/ops/quant_matmul.py
//   int8_matmul_pallas        (_int8_kernel)            trait Int8W
//   int4_matmul_pallas        (_int4_kernel)            trait Int4W
//   nf4_matmul_pallas         (_make_nf4_kernel)        trait Codebook4W
//   group_asym_matmul_pallas  (_make_group_asym_kernel) traits AsymNibbleW,
//                                                       AsymU8W
// Computes: out[M, N] = (bf16(x)[M, K] @ W[K, N]) (* colscale[N]), f32
//   accumulation, output in x's dtype, where W is
//   - int8:  the int8 codes (exact in bf16), times the column scale after
//            the sum;
//   - int4:  split-half signed nibbles: byte row r holds row r (low nibble)
//            and row r + K/2 (high nibble); times the column scale after;
//   - nf4/fp4: split-half unsigned nibbles indexing a 16-entry code,
//            code * blockscale[k / G, n] in f32 rounded to bf16 (no column
//            scale; the double-quant scale is folded by the wrapper);
//   - group-asym: (v - zero[k / G, n]) * scale[k / G, n] in f32 rounded to
//            bf16, v an unsigned nibble (split-half) or a uint8 (K, N).
//
// What bounds it on the H100: at the decode shapes (M = 32-256 rows, K and
// N of 768-4096) the weights are 0.3-4 MB and the card could stream them
// in a few microseconds, so the limit is how fast the multiply-adds run
// and how many SMs have work. This first version multiplies on CUDA cores
// (f32 FMA on operands already rounded to bf16: every product is exact), so
// it is bounded by the f32 FMA rate, not by bytes.
//
// Design: 32x64 output tiles, 128 threads, each thread owning a 4x4 patch
// held in registers. The K loop walks 32 stored rows at a time; a split-half
// packed tile holds 64 logical rows (r .. r+31 and K/2 + r .. K/2 + r+31),
// so the x tile takes the two matching 32-column slices. Each thread reads
// 16 stored bytes of one row in a 16-byte load and dequantizes them (and
// their group's scales, 16-byte loads from L1) straight into the f32 W tile
// in shared memory; the rows of that tile are padded to 80 floats and each
// thread starts its four float4 stores at another chunk, so a quarter warp's
// stores fall in distinct banks. A skinny M gives few output tiles, so the
// K loop is split across grid.z until about two blocks per SM are in
// flight; each split writes an f32 partial tile to a workspace and a second
// small kernel sums the partials in a fixed order (deterministic, no
// atomics), applies the column scale where the storage has one and casts to
// the output dtype.
#include "common.cuh"

namespace {

constexpr int BM = 32, BN = 64, BK = 32, THREADS = 128;
constexpr int WS_STRIDE = BN + 16;  // padded W-tile row (floats)

struct Code16 {
  float v[16];
};

__device__ __forceinline__ void load16(const void* p, uint8_t (&b)[16]) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  *reinterpret_cast<int4*>(b) = v;
}

__device__ __forceinline__ void load16f(const float* p, float (&f)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(&f[4 * j]) =
        __ldg(reinterpret_cast<const float4*>(p) + j);
}

// Each trait dequantizes the 16 stored bytes of stored row r, columns
// n .. n+15, into out[h][i]: logical row h * K/HALVES + r, column n + i.
struct Int8W {
  static constexpr int HALVES = 1;
  const int8_t* w;
  __device__ void tile(int r, int n, int N, int, float (&out)[HALVES][16],
                       const float*) const {
    uint8_t b[16];
    load16(w + (size_t)r * N + n, b);
#pragma unroll
    for (int i = 0; i < 16; ++i) out[0][i] = (float)(int8_t)b[i];
  }
};

struct Int4W {
  static constexpr int HALVES = 2;
  const int8_t* w;
  __device__ void tile(int r, int n, int N, int, float (&out)[HALVES][16],
                       const float*) const {
    uint8_t b[16];
    load16(w + (size_t)r * N + n, b);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      out[0][i] = (float)((int)((uint32_t)b[i] << 28) >> 28);  // low nibble
      out[1][i] = (float)((int)(int8_t)b[i] >> 4);             // high nibble
    }
  }
};

// Scale (and zero) rows of the group holding logical row k.
__device__ __forceinline__ const float* group_row(const float* p, int k, int G,
                                                  int N, int n) {
  return p + (size_t)(k / G) * N + n;
}

struct Codebook4W {
  static constexpr int HALVES = 2;
  const int8_t* w;
  const float* scale;  // (K/G, N) effective block scale
  int G;
  __device__ void tile(int r, int n, int N, int K, float (&out)[HALVES][16],
                       const float* code) const {
    uint8_t b[16];
    load16(w + (size_t)r * N + n, b);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s[16];
      load16f(group_row(scale, h * (K / 2) + r, G, N, n), s);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int idx = h ? (b[i] >> 4) : (b[i] & 0xF);
        out[h][i] = owc_round_bf16(__fmul_rn(code[idx], s[i]));
      }
    }
  }
};

template <int HALVES_>
struct AsymW {
  static constexpr int HALVES = HALVES_;
  const uint8_t* w;  // split-half nibbles (K/2, N) or values (K, N)
  const float* scale;
  const float* zero;
  int G;
  __device__ void tile(int r, int n, int N, int K, float (&out)[HALVES][16],
                       const float*) const {
    uint8_t b[16];
    load16(w + (size_t)r * N + n, b);
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      float s[16], z[16];
      const int k = h * (K / HALVES) + r;
      load16f(group_row(scale, k, G, N, n), s);
      load16f(group_row(zero, k, G, N, n), z);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int v = HALVES == 2 ? (h ? (b[i] >> 4) : (b[i] & 0xF)) : b[i];
        out[h][i] = owc_round_bf16(__fmul_rn(__fsub_rn((float)v, z[i]), s[i]));
      }
    }
  }
};
using AsymNibbleW = AsymW<2>;
using AsymU8W = AsymW<1>;

template <typename T, typename W>
__global__ void __launch_bounds__(THREADS)
qmm_partial(const T* __restrict__ x, W wt, Code16 code_arg,
            float* __restrict__ part, int M, int N, int K,
            int tiles_per_split) {
  constexpr int H = W::HALVES, KT = H * BK;  // logical rows per tile
  __shared__ __align__(16) float xs[KT][BM + 4];  // x tile, transposed
  __shared__ __align__(16) float ws[KT][WS_STRIDE];
  __shared__ float code[16];
  const int tid = threadIdx.x;
  if (tid < 16) code[tid] = code_arg.v[tid];
  __syncthreads();
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kh = K / H;  // stored rows
  const int ktiles = kh / BK;
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
    {  // x tile: for each half, BM rows x BK columns, 8 values per thread
      const int r = tid >> 2, kc = (tid & 3) * 8;
      const int m = m0 + r;
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = 0.0f;
          if (m < M)
            v = owc_round_bf16(owc_to_float(x[(size_t)m * K + h * kh + k0 + kc + i]));
          xs[h * BK + kc + i][r] = v;
        }
    }
    {  // W tile: BK stored rows x BN columns, 16 bytes per thread
      const int r = tid >> 2, c = tid & 3;
      float w[H][16];
      wt.tile(k0 + r, n0 + c * 16, N, K, w, code);
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = (j + c) & 3;  // staggered chunk: no bank conflicts
          *reinterpret_cast<float4*>(&ws[h * BK + r][c * 16 + q * 4]) =
              make_float4(w[h][q * 4], w[h][q * 4 + 1], w[h][q * 4 + 2],
                          w[h][q * 4 + 3]);
        }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KT; ++k) {
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

// Sums the splits in order, times the column scale where there is one.
template <typename T>
__global__ void qmm_reduce(const float* __restrict__ part,
                           const float* __restrict__ colscale,
                           T* __restrict__ out, int M, int N, int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (idx >= total) return;
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp) s += part[(size_t)sp * total + idx];
  if (colscale != nullptr) s *= colscale[idx % N];
  owc_store(out + idx, s);
}

template <typename T, typename W>
void launch_t(const void* x, const W& wt, const Code16& code,
              const void* colscale, void* part, void* out, int M, int N,
              int K, int splits, cudaStream_t st) {
  const int ktiles = K / W::HALVES / BK;
  const int tps = (ktiles + splits - 1) / splits;
  dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  qmm_partial<T, W><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), wt, code, static_cast<float*>(part), M, N, K,
      tps);
  const size_t total = (size_t)M * N;
  const int rt = 256;
  qmm_reduce<T><<<(unsigned)((total + rt - 1) / rt), rt, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(colscale),
      static_cast<T*>(out), M, N, splits);
}

template <typename W>
int launch(const void* x, const W& wt, const Code16& code, const void* colscale,
           void* part, void* out, int M, int N, int K, int splits, int dtype,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == OWC_BF16)
    launch_t<__nv_bfloat16>(x, wt, code, colscale, part, out, M, N, K, splits, st);
  else
    launch_t<float>(x, wt, code, colscale, part, out, M, N, K, splits, st);
  return (int)cudaGetLastError();
}

}  // namespace

// Common arguments: x (M, K) f32/bf16, part (splits, M, N) f32 workspace,
// out (M, N) in x's dtype; N % 64 == 0; every weight, scale and zero array
// 16-byte aligned with N as its last (contiguous) axis.

// w (K, N) int8, scale (N,) f32. K % 32 == 0.
extern "C" int owc_int8_matmul(const void* x, const void* w, const void* scale,
                               void* part, void* out, int M, int N, int K,
                               int splits, int dtype, void* stream) {
  return launch(x, Int8W{static_cast<const int8_t*>(w)}, Code16{}, scale, part,
                out, M, N, K, splits, dtype, stream);
}

// w (K/2, N) int8 split-half signed nibbles, scale (N,) f32. K % 64 == 0.
extern "C" int owc_int4_matmul(const void* x, const void* w, const void* scale,
                               void* part, void* out, int M, int N, int K,
                               int splits, int dtype, void* stream) {
  return launch(x, Int4W{static_cast<const int8_t*>(w)}, Code16{}, scale, part,
                out, M, N, K, splits, dtype, stream);
}

// w (K/2, N) int8 split-half unsigned code indices, code (16,) f32 on the
// host, scale (K/G, N) f32 effective block scale. K % 64 == 0, K % G == 0.
extern "C" int owc_nf4_matmul(const void* x, const void* w, const float* code,
                              const void* scale, void* part, void* out, int M,
                              int N, int K, int G, int splits, int dtype,
                              void* stream) {
  Code16 c;
  for (int i = 0; i < 16; ++i) c.v[i] = code[i];
  const Codebook4W wt{static_cast<const int8_t*>(w),
                      static_cast<const float*>(scale), G};
  return launch(x, wt, c, nullptr, part, out, M, N, K, splits, dtype, stream);
}

// w (K/2, N) split-half unsigned nibbles (packed != 0, K % 64 == 0) or (K, N)
// uint8 values (packed == 0, K % 32 == 0); scale, zero (K/G, N) f32;
// K % G == 0.
extern "C" int owc_group_asym_matmul(const void* x, const void* w,
                                     const void* scale, const void* zero,
                                     void* part, void* out, int M, int N,
                                     int K, int G, int packed, int splits,
                                     int dtype, void* stream) {
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zero);
  if (packed)
    return launch(x, AsymNibbleW{wb, s, z, G}, Code16{}, nullptr, part, out, M,
                  N, K, splits, dtype, stream);
  return launch(x, AsymU8W{wb, s, z, G}, Code16{}, nullptr, part, out, M, N, K,
                splits, dtype, stream);
}
