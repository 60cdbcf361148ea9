// Weight-only dequant-matmuls for the decode-regime linears: one kernel
// templated on the weight storage (a dequant trait) and on x's type.
//
// Replaces: openai_whisper_compression_tpu/ops/quant_matmul.py
//   int8_matmul_pallas        (_int8_kernel)            trait Int8W
//   int4_matmul_pallas        (_int4_kernel)            trait Int4W
//   nf4_matmul_pallas         (_make_nf4_kernel)        trait Codebook4W
//   group_asym_matmul_pallas  (_make_group_asym_kernel) traits AsymNibbleW,
//                                                       AsymU8W
// Computes: out[M, N] = (bf16(x)[M, K] @ W[K, N]) (* colscale[N]), f32
//   accumulation, output in x's dtype (f32, bf16 or f16), where W is
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
// What bounds it on the H100: bytes and latency. At the decode shapes (M of
// 1-1024 rows, K and N of 768-4096) the weights are 0.3-4 MB, which the
// card streams in a microsecond or two, and the product is 0.1-10 GFLOP,
// microseconds on the tensor cores. So what counts is that every SM has
// work, that a block keeps several tiles of W in flight, that W is read
// once, and that a linear is one launch.
//
// Design: a block of 8 warps owns a 64-column strip of the output for up to
// 128 rows of M (M above 128 takes one block per 128-row slab) and a range
// of K; warp w multiplies rows 16w .. 16w + 15 with mma.sync.m16n8k16 (bf16
// operands, f32 accumulators), so W passes through a block once whatever M
// is. The K loop walks 32 stored rows at a time (a split-half nibble tile
// holds 64 logical rows, r .. r + 31 and K/2 + r .. K/2 + r + 31, so the x
// tile takes the two matching 32-column slices) through a 4-stage cp.async
// ring of the STORED bytes of W (2 KB a stage) and of x in its own type
// (f32 and f16 x are rounded to bf16 when the A fragments are built). On
// the way from the ring to the fragments each thread turns 8 stored bytes
// into 8 (or 2 x 8) bf16 values (integer codes are exact in bf16; code x
// scale and (v - zero) x scale are rounded to bf16 as the contract says;
// group scales come through the read-only path, their loads issued before
// the wait for the tile) in a double-buffered bf16 tile [k][n], padded to 72
// columns, from which ldmatrix.trans gives the B fragments: the next
// tile's dequantization and this tile's products share one barrier. A
// skinny M gives few strips, so K is split over the blocks of a thread
// block cluster (up to 8, a split rule in the Python wrapper): each block
// leaves its f32 partial tile in its own shared memory, and after a cluster
// barrier every block sums a share of the tile over the cluster's blocks
// through distributed shared memory, in split order (no atomics, no
// workspace in device memory: the result does not change from run to run),
// applies the column scale where the storage has one, casts and writes.
// One launch a linear.
#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 128, BN = 64, BK = 32, THREADS = 256, NS = 4;
constexpr int PAD = 8;              // x-tile row padding, in elements
constexpr int WD_STRIDE = BN + 8;   // dequantized W tile row, bf16 elements
constexpr int PART_STRIDE = BN + 8; // partial tile row, floats
using BF = __nv_bfloat16;

struct Code16 {
  float v[16];
};

// Four 8x8 bf16 matrices, each transposed: lane l gives the address of row
// l % 8 of matrix l / 8 and receives elements [2 * (l % 4), + 1][l / 4].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c (16x8 f32) += a (16x16 bf16, row major) * b (16x8 bf16, column major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// Two neighbouring x values of the shared tile as a bf16 pair (f32 and f16
// rounded to nearest even, as x.to(bfloat16)).
__device__ __forceinline__ uint32_t ld_pair(const float* p) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  return pack_bf16(f.x, f.y);
}
__device__ __forceinline__ uint32_t ld_pair(const BF* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t ld_pair(const __half* p) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(p));
  return pack_bf16(f.x, f.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(BF* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}
__device__ __forceinline__ void store4(__half* p, float4 v) {
  const __half2 lo = __floats2half2_rn(v.x, v.y), hi = __floats2half2_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                            *reinterpret_cast<const uint32_t*>(&hi));
}

// Byte i of the 8 stored bytes.
__device__ __forceinline__ uint32_t byte_of(uint2 raw, int i) {
  return ((i < 4 ? raw.x : raw.y) >> (8 * (i & 3))) & 0xFFu;
}

__device__ __forceinline__ void load8f(const float* p, float (&f)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// A trait names the stored bytes (`bytes()`: rows of N bytes), loads what
// the 8 columns n .. n + 7 of stored row r need besides the bytes
// (`params`), and turns the 8 stored bytes into bf16: out[h] holds logical
// row h * K/HALVES + r, columns n .. n + 7.
struct NoParams {};

struct Int8W {
  static constexpr int HALVES = 1;
  using Params = NoParams;
  const int8_t* w;
  __device__ const uint8_t* bytes() const { return reinterpret_cast<const uint8_t*>(w); }
  __device__ void params(Params&, int, int, int, int) const {}
  __device__ void dequant(uint2 raw, const Params&, const float*,
                          uint4 (&out)[HALVES]) const {
    float f[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = (float)(int8_t)byte_of(raw, i);
    out[0] = pack8(f);
  }
};

struct Int4W {
  static constexpr int HALVES = 2;
  using Params = NoParams;
  const int8_t* w;
  __device__ const uint8_t* bytes() const { return reinterpret_cast<const uint8_t*>(w); }
  __device__ void params(Params&, int, int, int, int) const {}
  __device__ void dequant(uint2 raw, const Params&, const float*,
                          uint4 (&out)[HALVES]) const {
    float lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t b = byte_of(raw, i);
      lo[i] = (float)((int)(b << 28) >> 28);  // signed low nibble
      hi[i] = (float)((int)(b << 24) >> 28);  // signed high nibble
    }
    out[0] = pack8(lo);
    out[1] = pack8(hi);
  }
};

// Scale (and zero) rows of the group holding logical row k.
__device__ __forceinline__ const float* group_row(const float* p, int k, int G,
                                                  int N, int n) {
  return p + (size_t)(k / G) * N + n;
}

struct Codebook4W {
  static constexpr int HALVES = 2;
  struct Params {
    float s[2][8];
  };
  const int8_t* w;
  const float* scale;  // (K/G, N) effective block scale
  int G;
  __device__ const uint8_t* bytes() const { return reinterpret_cast<const uint8_t*>(w); }
  __device__ void params(Params& p, int r, int n, int N, int K) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) load8f(group_row(scale, h * (K / 2) + r, G, N, n), p.s[h]);
  }
  __device__ void dequant(uint2 raw, const Params& p, const float* code,
                          uint4 (&out)[HALVES]) const {
    float lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t b = byte_of(raw, i);
      lo[i] = __fmul_rn(code[b & 0xF], p.s[0][i]);
      hi[i] = __fmul_rn(code[b >> 4], p.s[1][i]);
    }
    out[0] = pack8(lo);
    out[1] = pack8(hi);
  }
};

template <int HALVES_>
struct AsymW {
  static constexpr int HALVES = HALVES_;
  struct Params {
    float s[HALVES_][8], z[HALVES_][8];
  };
  const uint8_t* w;  // split-half nibbles (K/2, N) or values (K, N)
  const float* scale;
  const float* zero;
  int G;
  __device__ const uint8_t* bytes() const { return w; }
  __device__ void params(Params& p, int r, int n, int N, int K) const {
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      const int k = h * (K / HALVES) + r;
      load8f(group_row(scale, k, G, N, n), p.s[h]);
      load8f(group_row(zero, k, G, N, n), p.z[h]);
    }
  }
  __device__ void dequant(uint2 raw, const Params& p, const float*,
                          uint4 (&out)[HALVES]) const {
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t b = byte_of(raw, i);
        const uint32_t v = HALVES == 2 ? (h ? (b >> 4) : (b & 0xF)) : b;
        f[i] = __fmul_rn(__fsub_rn((float)v, p.z[h][i]), p.s[h][i]);
      }
      out[h] = pack8(f);
    }
  }
};
using AsymNibbleW = AsymW<2>;
using AsymU8W = AsymW<1>;

// Shared memory: NS stages of (x tile [xrows][KT + PAD] of T, 2 KB of stored
// W), then the two dequantized tiles [KT][WD_STRIDE] bf16. After the K loop
// the f32 partial tile [xrows][PART_STRIDE] lies over the stages.
template <typename T, typename W>
constexpr int stage_bytes(int xrows) {
  return xrows * (W::HALVES * BK + PAD) * (int)sizeof(T) + BK * BN;
}
template <typename T, typename W>
constexpr int smem_bytes(int xrows) {
  return NS * stage_bytes<T, W>(xrows) + 2 * W::HALVES * BK * WD_STRIDE * (int)sizeof(BF);
}

template <typename T, typename W>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const T* __restrict__ x, W wt, Code16 code_arg,
           const float* __restrict__ colscale, T* __restrict__ out, int M, int N,
           int K, int xrows, int tiles_per_split) {
  constexpr int H = W::HALVES, KT = H * BK;  // logical rows per tile
  constexpr int XS = KT + PAD;               // x-tile row stride, elements
  constexpr int CPR = BK * sizeof(T) / 16;   // 16-byte chunks per row and half
  constexpr int EPC = 16 / sizeof(T);        // elements per chunk
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float code[16];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  if (tid < 16) code[tid] = code_arg.v[tid];  // read after the first barrier
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kh = K / H;  // stored rows
  const int kt_begin = blockIdx.z * tiles_per_split, nt = tiles_per_split;
  const int x_bytes = xrows * XS * (int)sizeof(T);
  const int stage = x_bytes + BK * BN;
  BF* wd = reinterpret_cast<BF*>(smem + NS * stage);

  // Tile t of this block's K range into stage t % NS (nothing past the
  // range; a group is committed either way, so the waits count alike). A
  // row of the x tile is CH 16-byte chunks, and CH divides the block, so a
  // thread copies the same chunk of the rows xrow0, xrow0 + RS, ...: its
  // addresses are set up once, and a tile costs an add for each.
  constexpr int CH = H * CPR, RS = THREADS / CH, NCH = BM / RS;
  static_assert(THREADS % CH == 0 && BM % RS == 0, "x-tile chunks must tile the block");
  const unsigned smem_base = (unsigned)__cvta_generic_to_shared(smem);
  const int xrow0 = tid / CH, xh = (tid % CH) / CPR, xcol = (tid % CPR) * EPC;
  const size_t xstep = (size_t)RS * K;  // elements between a thread's chunks
  const T* xsrc = x + (size_t)(m0 + xrow0) * K + xh * kh + (size_t)kt_begin * BK + xcol;
  const unsigned xdst = smem_base + (xrow0 * XS + xh * BK + xcol) * (int)sizeof(T);
  const uint8_t* wsrc =
      wt.bytes() + (size_t)(kt_begin * BK + (tid >> 2)) * N + n0 + (tid & 3) * 16;
  const unsigned wdst = smem_base + x_bytes + (tid >> 2) * BN + (tid & 3) * 16;
  auto load_tile = [&](int t) {
    if (t < nt) {
      const unsigned base = (t % NS) * stage;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int row = xrow0 + i * RS;
        if (row < xrows) {
          const bool ok = m0 + row < M;  // rows past M are zero filled
          cp_async16(base + xdst + i * RS * XS * (int)sizeof(T),
                     ok ? xsrc + i * xstep + (size_t)t * BK : x, ok ? 16 : 0);
        }
      }
      if (tid < BK * BN / 16) cp_async16(base + wdst, wsrc + (size_t)t * BK * N, 16);
    }
    cp_async_commit();
  };

  // Dequantization: thread tid takes stored row dr, columns dc .. dc + 7.
  const int dr = tid >> 3, dc = (tid & 7) * 8;
  typename W::Params prm;
  auto fetch_params = [&](int t) {
    if (t < nt) wt.params(prm, (kt_begin + t) * BK + dr, n0 + dc, N, K);
  };
  auto dequant_tile = [&](int t) {
    if (t < nt) {
      const uint2 raw = *reinterpret_cast<const uint2*>(
          smem + (t % NS) * stage + x_bytes + dr * BN + dc);
      uint4 o[H];
      wt.dequant(raw, prm, code, o);
      BF* dst = wd + (t & 1) * KT * WD_STRIDE;
#pragma unroll
      for (int h = 0; h < H; ++h)
        *reinterpret_cast<uint4*>(dst + (h * BK + dr) * WD_STRIDE + dc) = o[h];
    }
  };

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  const bool active = warp * 16 < xrows;  // the same for the whole warp
  auto mma_tile = [&](int t) {
    if (!active) return;
    const T* xs = reinterpret_cast<const T*>(smem + (t % NS) * stage) + warp * 16 * XS;
    const BF* wt_tile = wd + (t & 1) * KT * WD_STRIDE;
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      // a0 (row g, cols 2t), a1 (row g + 8), a2 (row g, cols 2t + 8), a3
      const uint32_t a[4] = {ld_pair(xs + g * XS + kk * 16 + 2 * t4),
                             ld_pair(xs + (g + 8) * XS + kk * 16 + 2 * t4),
                             ld_pair(xs + g * XS + kk * 16 + 8 + 2 * t4),
                             ld_pair(xs + (g + 8) * XS + kk * 16 + 8 + 2 * t4)};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {  // output columns 16dp .. 16dp + 15
        uint32_t b[4];
        ldmatrix_x4_trans(b, wt_tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                           * WD_STRIDE + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
  };

#pragma unroll
  for (int t = 0; t < NS - 1; ++t) load_tile(t);
  fetch_params(0);
  cp_async_wait<NS - 2>();  // tile 0 has landed
  __syncthreads();
  dequant_tile(0);
  for (int t = 0; t < nt; ++t) {
    fetch_params(t + 1);
    cp_async_wait<NS - 3>();  // tile t + 1 has landed
    // ... for every thread; tile t's bf16 W is whole; the products of tile
    // t - 1 are done, so its stage and its bf16 buffer are free
    __syncthreads();
    load_tile(t + NS - 1);
    dequant_tile(t + 1);
    mma_tile(t);
  }

  cp_async_wait<0>();
  __syncthreads();  // every product is done: the stages give way to the partial tile
  float* part = reinterpret_cast<float*>(smem);
  if (active) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float* p = part + (warp * 16 + g) * PART_STRIDE + n * 8 + 2 * t4;
      *reinterpret_cast<float2*>(p) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(p + 8 * PART_STRIDE) = make_float2(acc[n][2], acc[n][3]);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial tile is in its block's shared memory
  const int splits = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  // this block sums every splits-th group of 4 columns, splits in order
  for (int e = rank + splits * tid; e < xrows * (BN / 4); e += splits * THREADS) {
    const int row = e / (BN / 4), c4 = (e % (BN / 4)) * 4;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int sp = 0; sp < splits; ++sp) {
      const float* remote = cluster.map_shared_rank(part, sp);
      const float4 v = *reinterpret_cast<const float4*>(remote + row * PART_STRIDE + c4);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int m = m0 + row;
    if (m < M) {
      if (colscale != nullptr) {
        const float4 cs = __ldg(reinterpret_cast<const float4*>(colscale + n0 + c4));
        s.x *= cs.x;
        s.y *= cs.y;
        s.z *= cs.z;
        s.w *= cs.w;
      }
      store4(out + (size_t)m * N + n0 + c4, s);
    }
  }
  cluster.sync();  // no block leaves while another still reads its tile
}

template <typename T, typename W>
int launch_t(const void* x, const W& wt, const Code16& code, const void* colscale,
             void* out, int M, int N, int K, int splits, cudaStream_t st) {
  const int ktiles = K / W::HALVES / BK;
  if (M < 1 || splits < 1 || splits > 8 || ktiles % splits != 0)
    return (int)cudaErrorInvalidValue;
  const int xrows = M >= BM ? BM : (M + 15) / 16 * 16;
  const int smem = smem_bytes<T, W>(xrows);
  cudaError_t e = cudaFuncSetAttribute(qmm_kernel<T, W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes<T, W>(BM));
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / BN, (M + BM - 1) / BM, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, qmm_kernel<T, W>, static_cast<const T*>(x), wt, code,
                         static_cast<const float*>(colscale), static_cast<T*>(out), M,
                         N, K, xrows, ktiles / splits);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename W>
int launch(const void* x, const W& wt, const Code16& code, const void* colscale,
           void* out, int M, int N, int K, int splits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  const bool ok = owc_dispatch_float(dtype, [&](auto tag) {
    err = launch_t<decltype(tag)>(x, wt, code, colscale, out, M, N, K, splits, st);
  });
  return ok ? err : (int)cudaErrorInvalidValue;
}

}  // namespace

// Common arguments: x (M, K) f32/bf16/f16, out (M, N) in x's dtype; N % 64
// == 0; x and every weight, scale and zero array 16-byte aligned with its
// last axis contiguous; splits (1..8) divides the K tiles of 32 stored rows
// and is the size of the thread block cluster that shares one output tile.

// w (K, N) int8, scale (N,) f32. K % 32 == 0.
extern "C" int owc_int8_matmul(const void* x, const void* w, const void* scale,
                               void* out, int M, int N, int K, int splits,
                               int dtype, void* stream) {
  return launch(x, Int8W{static_cast<const int8_t*>(w)}, Code16{}, scale, out, M,
                N, K, splits, dtype, stream);
}

// w (K/2, N) int8 split-half signed nibbles, scale (N,) f32. K % 64 == 0.
extern "C" int owc_int4_matmul(const void* x, const void* w, const void* scale,
                               void* out, int M, int N, int K, int splits,
                               int dtype, void* stream) {
  return launch(x, Int4W{static_cast<const int8_t*>(w)}, Code16{}, scale, out, M,
                N, K, splits, dtype, stream);
}

// w (K/2, N) int8 split-half unsigned code indices, code (16,) f32 on the
// host, scale (K/G, N) f32 effective block scale. K % 64 == 0, K % G == 0.
extern "C" int owc_nf4_matmul(const void* x, const void* w, const float* code,
                              const void* scale, void* out, int M, int N, int K,
                              int G, int splits, int dtype, void* stream) {
  Code16 c;
  for (int i = 0; i < 16; ++i) c.v[i] = code[i];
  const Codebook4W wt{static_cast<const int8_t*>(w),
                      static_cast<const float*>(scale), G};
  return launch(x, wt, c, nullptr, out, M, N, K, splits, dtype, stream);
}

// w (K/2, N) split-half unsigned nibbles (packed != 0, K % 64 == 0) or (K, N)
// uint8 values (packed == 0, K % 32 == 0); scale, zero (K/G, N) f32;
// K % G == 0.
extern "C" int owc_group_asym_matmul(const void* x, const void* w,
                                     const void* scale, const void* zero,
                                     void* out, int M, int N, int K, int G,
                                     int packed, int splits, int dtype,
                                     void* stream) {
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zero);
  if (packed)
    return launch(x, AsymNibbleW{wb, s, z, G}, Code16{}, nullptr, out, M, N, K,
                  splits, dtype, stream);
  return launch(x, AsymU8W{wb, s, z, G}, Code16{}, nullptr, out, M, N, K, splits,
                dtype, stream);
}
