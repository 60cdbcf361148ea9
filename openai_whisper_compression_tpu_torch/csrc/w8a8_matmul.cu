// w8a8 matmul: int8 activation quantization, an int8 x int8 -> int32 product
// on the tensor cores, and the dequantizing epilogue.
//
// Replaces: openai_whisper_compression_tpu/ops/quant_matmul.py
//           w8a8_matmul_pallas (_w8a8_kernel: dynamic per-row scale,
//           _w8a8_static_kernel: one frozen scalar scale).
// Computes, for x (M, K) f32 or bf16, W (K, N) int8 codes and their column
// scales sw (N,) f32:
//   sx[m]    = max(max_k |x[m, k]|, 1e-12) * f32(1 / 127)     (dynamic)
//            = act_scale                                       (static)
//   xq[m, k] = clamp(rint(x[m, k] / sx[m]), -127, 127)   (IEEE division)
//   acc      = sum_k xq[m, k] * W[k, n]                   (int32, exact)
//   out[m, n] = (f32(acc) * sx[m]) * sw[n]                in x's dtype
// The arithmetic of the JAX package's in-model path (`ops/linear.py`
// `_act_quant_matmul` under jit: XLA turns `/ 127.0` into a multiply by the
// f32 reciprocal). Integer sums have no order, so the result equals the
// plain version's bit for bit.
//
// What bounds it on the H100: at M = batch (a decode step) the weight's
// bytes, 0.6-2.4 MB a linear, and in practice launch latency; at M = B x 1500
// (the encoder) the int8 tensor-core rate, 2 M N K operations a linear.
//
// Design. The TPU kernel keeps the whole (K, N) weight in VMEM across its M
// blocks and quantizes a block of rows in place. Here two launches do the
// work:
// 1. `w8a8_prepare`: one block per row of x finds the row's absmax (a first
//    pass over the row, in the dynamic body), then writes the row's int8
//    codes and its scale, so each activation is divided once and not once
//    per column tile. Further blocks of the same launch transpose W through
//    shared memory into Wt (N, K): `mma.sync.m16n8k32.s8` wants four
//    consecutive k of one column in one register, and the QTensor keeps
//    (K, N) with N contiguous (its bytes are held bit for bit against the
//    JAX package's). The transposed copy is scratch of this call.
// 2. `w8a8_gemm`: xq (M, K) times Wt (N, K), both K-contiguous, in BM x BN
//    output tiles; 64-deep K tiles arrive by 16-byte cp.async into a double
//    buffer whose rows are padded to 80 bytes, so the eight rows and four
//    words that a warp's fragment load touches fall in 32 distinct banks.
//    Each warp owns a (BM / WARPS_M) x (BN / WARPS_N) patch of m16n8k32
//    tiles with int32 accumulators in registers. The epilogue scales and
//    stores pairs of neighbouring columns. Two tilings: 128 x 128 (8 warps,
//    64 x 32 a warp) once that fills the card's 132 SMs, 32 x 64 (4 warps)
//    for the skinny M of decode steps and prefill. Ragged M, N and K are
//    zero-filled on load and masked on store (K and N multiples of 16).
#include "common.cuh"

namespace {

constexpr int BK = 64;           // K depth of a shared-memory tile (bytes)
constexpr int ROW = BK + 16;     // padded tile row: 80 bytes, 20 words
constexpr int PREP_THREADS = 256;
constexpr int TT = 64;           // W is transposed in TT x TT tiles

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// c (16x8 int32) += a (16x32 int8, row major) * b (32x8 int8, column major)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Blocks 0 .. M-1: quantize row m of x (act_scale null: dynamic per-row
// scale, also written to sx[m]; else the frozen scalar). Blocks from M on:
// transpose one TT x TT tile of W (K, N) into Wt (N, K).
template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
w8a8_prepare(const T* __restrict__ x, const float* __restrict__ act_scale,
             int8_t* __restrict__ xq, float* __restrict__ sx,
             const int8_t* __restrict__ w, int8_t* __restrict__ wt, int M, int N,
             int K) {
  __shared__ float red[32];
  __shared__ int8_t tile[TT][TT + 4];
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < M) {
    const int m = blockIdx.x;
    const T* row = x + (size_t)m * K;
    float scale;
    if (act_scale == nullptr) {
      float a = 0.0f;
      for (int k = tid; k < K; k += PREP_THREADS) a = fmaxf(a, fabsf(owc_to_float(row[k])));
      a = owc_block_max(a, red);
      scale = fmaxf(a, 1e-12f) * (1.0f / 127.0f);
      if (tid == 0) sx[m] = scale;
    } else {
      scale = *act_scale;
    }
    int8_t* dst = xq + (size_t)m * K;
    for (int k = tid; k < K; k += PREP_THREADS)
      dst[k] = (int8_t)owc_quant_int8(owc_to_float(row[k]), scale);
    return;
  }
  const int t = blockIdx.x - M, tiles_n = (N + TT - 1) / TT;
  const int k0 = (t / tiles_n) * TT, n0 = (t % tiles_n) * TT;
  for (int i = tid; i < TT * TT; i += PREP_THREADS) {
    const int r = i / TT, c = i % TT;  // neighbouring threads: neighbouring n
    tile[r][c] = (k0 + r < K && n0 + c < N) ? w[(size_t)(k0 + r) * N + n0 + c] : 0;
  }
  __syncthreads();
  for (int i = tid; i < TT * TT; i += PREP_THREADS) {
    const int c = i / TT, r = i % TT;  // neighbouring threads: neighbouring k
    if (k0 + r < K && n0 + c < N) wt[(size_t)(n0 + c) * K + k0 + r] = tile[r][c];
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// `rows` x BK bytes of a K-contiguous int8 matrix (row stride K) starting at
// (row0, k0) into a padded shared tile; rows past `limit` and chunks past K
// are zero-filled.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* __restrict__ src,
                                          int row0, int limit, int k0, int K, int tid) {
  for (int c = tid; c < ROWS * (BK / 16); c += THREADS) {
    const int r = c / (BK / 16), k = k0 + (c % (BK / 16)) * 16;
    const bool ok = row0 + r < limit && k < K;
    cp_async16(dst + r * ROW + (c % (BK / 16)) * 16,
               ok ? src + (size_t)(row0 + r) * K + k : src, ok ? 16 : 0);
  }
}

// out (M, N) = (f32(xq (M, K) . wt (N, K)^T) * sx[m * sx_stride]) * sw[n]
template <int BM, int BN, int WARPS_M, int WARPS_N, typename T>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
w8a8_gemm(const int8_t* __restrict__ xq, const int8_t* __restrict__ wt,
          const float* __restrict__ sx, int sx_stride, const float* __restrict__ sw,
          T* __restrict__ out, int M, int N, int K) {
  constexpr int THREADS = WARPS_M * WARPS_N * 32;
  constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;  // a warp's patch
  constexpr int MT = WTM / 16, NT = WTN / 8;             // its mma tiles
  __shared__ __align__(16) int8_t As[2][BM * ROW];
  __shared__ __align__(16) int8_t Bs[2][BN * ROW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load_tile<BM, THREADS>(As[0], xq, m0, M, 0, K, tid);
  load_tile<BN, THREADS>(Bs[0], wt, n0, N, 0, K, tid);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) {
      load_tile<BM, THREADS>(As[cur ^ 1], xq, m0, M, (kt + 1) * BK, K, tid);
      load_tile<BN, THREADS>(Bs[cur ^ 1], wt, n0, N, (kt + 1) * BK, K, tid);
    }
    cp_async_commit();       // possibly empty: keeps the group count in step
    cp_async_wait_but_one();  // tile kt has landed
    __syncthreads();
    const int8_t* a_s = As[cur] + (wm * WTM + g) * ROW + t * 4;
    const int8_t* b_s = Bs[cur] + (wn * WTN + g) * ROW + t * 4;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = a_s + i * 16 * ROW + ks * 32;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * ROW);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * ROW + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* p = b_s + j * 8 * ROW + ks * 32;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();  // every warp is done with buffer cur before it refills
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the tile
      const int m = m0 + wm * WTM + i * 16 + g + h * 8;
      if (m >= M) continue;
      const float s = sx[(size_t)m * sx_stride];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn * WTN + j * 8 + 2 * t;
        if (n >= N) continue;  // N is even: n + 1 < N too
        const float v0 = __fmul_rn(__fmul_rn((float)acc[i][j][2 * h], s), sw[n]);
        const float v1 = __fmul_rn(__fmul_rn((float)acc[i][j][2 * h + 1], s), sw[n + 1]);
        store2(out + (size_t)m * N + n, v0, v1);
      }
    }
}

template <typename T>
int launch(const void* x, const void* w, const void* sw, const void* act_scale,
           void* xq, void* wt, void* sx, void* out, int M, int N, int K,
           cudaStream_t st) {
  const int tiles = ((K + TT - 1) / TT) * ((N + TT - 1) / TT);
  w8a8_prepare<T><<<M + tiles, PREP_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(act_scale),
      static_cast<int8_t*>(xq), static_cast<float*>(sx),
      static_cast<const int8_t*>(w), static_cast<int8_t*>(wt), M, N, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float* scales = static_cast<const float*>(act_scale ? act_scale : sx);
  const int stride = act_scale ? 0 : 1;
  const int big = ((M + 127) / 128) * ((N + 127) / 128);
  if (big >= 132) {  // the large tiling fills the card
    dim3 grid((N + 127) / 128, (M + 127) / 128);
    w8a8_gemm<128, 128, 2, 4, T><<<grid, 256, 0, st>>>(
        static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wt), scales,
        stride, static_cast<const float*>(sw), static_cast<T*>(out), M, N, K);
  } else {
    dim3 grid((N + 63) / 64, (M + 31) / 32);
    w8a8_gemm<32, 64, 1, 4, T><<<grid, 128, 0, st>>>(
        static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wt), scales,
        stride, static_cast<const float*>(sw), static_cast<T*>(out), M, N, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) f32/bf16 (dtype code), w (K, N) int8, sw (N,) f32, act_scale one
// f32 on the device or null (dynamic per-row scales); scratch xq (M, K)
// int8, wt (N, K) int8, sx (M,) f32 (unused with act_scale); out (M, N) in
// x's dtype. K % 16 == 0, N % 16 == 0, xq and wt 16-byte aligned,
// M <= 65535 * 32.
extern "C" int owc_w8a8_matmul(const void* x, const void* w, const void* sw,
                               const void* act_scale, void* xq, void* wt,
                               void* sx, void* out, int M, int N, int K,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == OWC_BF16)
    return launch<__nv_bfloat16>(x, w, sw, act_scale, xq, wt, sx, out, M, N, K, st);
  return launch<float>(x, w, sw, act_scale, xq, wt, sx, out, M, N, K, st);
}
