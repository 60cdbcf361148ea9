// w8a8 matmul: int8 activation quantization, an int8 x int8 -> int32 product
// on the tensor cores, and the dequantizing epilogue.
//
// Replaces: openai_whisper_compression_tpu/ops/quant_matmul.py
//           w8a8_matmul_pallas (_w8a8_kernel: dynamic per-row scale,
//           _w8a8_static_kernel: one frozen scalar scale).
// Computes, for x (M, K) f32, bf16 or f16, W (K, N) int8 codes and their column
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
// (the encoder) the int8 tensor-core rate, 2 M N K operations a linear, and
// nearly as much the bytes of x and of the output.
//
// The int8 tensor-core products want four (mma.sync) or all (wgmma) of the
// k of one column of W next to each other, while the QTensor keeps W (K, N)
// with N contiguous (its bytes are held bit for bit against the JAX
// package's). Neither body keeps or makes a transposed copy of W: each
// turns the stored bytes around on chip, four rows at a time, with byte
// permutes (`prmt`): a 4 x 4 block of bytes (four k of four neighbouring n)
// becomes four words of four k each.
//
// M <= 1024 (decode steps, the prefill): `w8a8_small`, one launch a linear.
// - A block owns 32 rows of x and 128 columns of W over a range of K; K is
//   split over the blocks of a thread block cluster (up to 8, a rule in the
//   Python wrapper) so that some 100 blocks are in flight.
// - Each block finds the absmax of its 32 rows over its K range (x comes
//   from L2, every thread's loads in flight at once), the cluster's blocks
//   take the maximum of their partial absmaxes
//   through distributed shared memory (a maximum has no order), and each
//   block quantizes its rows' K range once into an int8 slab in shared
//   memory. The static body reads the frozen scale instead.
// - Meanwhile W's stored rows arrive in 64-row stages by cp.async into a
//   4-stage ring of 128-byte rows whose 16-byte chunks are XOR-swizzled by
//   (row / 4) % 4. Eight warps each own 16 rows x 32 columns: a thread reads
//   one word (four neighbouring n) of each of the four rows 4t .. 4t + 3 that
//   its m16n8k32 B fragment needs (conflict-free: the swizzle puts the four
//   t of a warp on distinct banks) and `prmt` turns the 4 x 4 bytes into the
//   B fragments of four n8 tiles at once. So the tiles' columns interleave
//   (tile j holds columns 4i + j of the warp's 32), and a thread's
//   accumulators cover 8 neighbouring output columns.
// - The int32 partial tiles are summed over the cluster through distributed
//   shared memory, then scaled and stored: no workspace, no second launch.
//
// M > 1024 (the encoder, the cross-KV projections): two launches.
// - `w8a8_quantize`: a warp per row, 16-byte loads, the absmax, then the
//   codes (and sx). Bound by bytes: x read once, xq and sx written once.
// - `w8a8_gemm`: persistent blocks (one an SM) walk 128 x 128 output tiles,
//   n fastest, so the blocks in flight share the rows of x in L2 (W lives in
//   L2 whole). Three roles a block:
//   * two consumer warpgroups of 64 rows each run
//     `wgmma.m64n128k32.s32.s8.s8` from a 4-stage ring, both operands in
//     shared memory, K-major, in the 128-byte swizzle;
//   * thread 0 of the producer warpgroups loads the 128 x 128 int8 tile of
//     xq into a stage by TMA;
//   * the two producer warpgroups (8 warps) copy W's stored bytes of the
//     stage (128 k x 128 n) by 4-byte cp.async, each thread 16 rows x 4
//     columns, three stages ahead into a ring of their own, then turn them
//     K-major with `prmt` and store them as 16-byte chunks in the swizzle
//     wgmma reads (conflict-free: a lane reads back only its own words, and
//     the 8 lanes of a store phase hit 8 distinct chunks). Plain loads into
//     registers, one stage ahead, left the producers waiting on L2 at
//     every stage.
//     wgmma takes s8 operands only K-major, so W is turned around here, once
//     a stage, for 128 rows of x.
//   The producers give registers to the consumers (`setmaxnreg` 56 / 200),
//   and a block's epilogue overlaps the next tile's loads.
// - `w8a8_gemm_panel`, where K <= 1024 (every encoder linear of whisper-small
//   and -medium but fc2): the 128 x 128 tiles read 32 KB of L2 a stage for
//   4.2 M operations, more than L2 gives at the int8 rate, so here a block
//   keeps one n-tile's W panel (K x 128, turned K-major once, at most 128
//   KB) in shared memory and walks m-tiles: a stage brings only xq's 16 KB,
//   by TMA, and the producer warpgroup has nothing to turn around after the
//   start.
//
// Ragged widths (K or N not a multiple of 16, e.g. an FFN of 922 units after
// activation-guided pruning) run a second instantiation of every body
// (RAGGED): x is read an element at a time where its rows are not 16-byte
// aligned or end inside a chunk of 8, W's stored bytes one at a time where
// its rows are not (N % 16 for the cp.async chunks, N % 4 for the 4-byte
// words of the large path), outputs one at a time where a pair or a group of
// 4 would cross the row's end or an alignment. The quantize pass writes xq
// with its rows padded with zeros to Kp = K rounded up to 16, so its tensor
// map keeps the 16-byte row stride TMA needs. Whole-tile shapes run the
// aligned instantiation, the code as it was. The integer sums are the same
// either way, so both stay bit-equal to the plain version.
#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

// ---- shared pieces ----

// Four words, row i holding bytes (i, 0..3), as four words, word j holding
// bytes (0..3, j): the 4 x 4 byte transpose.
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4], uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// 8 consecutive values of x as f32 (16-byte aligned: 32 bytes for f32).
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = owc_to_float(e[i]);
}

// x[k .. k + 7] of a row of K as f32, 0 past K: the 16-byte loads of
// `load8` where `vec` (K % 8 == 0: rows 16-byte aligned, no chunk crosses K)
// or the call is aligned, else one value at a time.
template <bool RAGGED, typename T>
__device__ __forceinline__ void load8x(const T* row, int k, int K, bool vec, float (&f)[8]) {
  if (k >= K) {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = 0.0f;
  } else if (!RAGGED || vec) {
    load8(row + k, f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = k + i < K ? owc_to_float(row[k + i]) : 0.0f;
  }
}

// Bytes n .. n + 4 * WORDS - 1 of the stored row `src` of N as words, low
// byte first, 0 past N (the ragged path's loads of W).
template <int WORDS>
__device__ __forceinline__ void load_bytes(const int8_t* src, int n, int N,
                                           uint32_t (&v)[WORDS]) {
#pragma unroll
  for (int b = 0; b < 4 * WORDS; ++b) {
    if (b % 4 == 0) v[b / 4] = 0u;
    if (n + b < N) v[b / 4] |= (uint32_t)(uint8_t)__ldg(src + n + b) << (8 * (b % 4));
  }
}

// The 8 int8 codes of 8 values under `scale`, packed low byte first.
__device__ __forceinline__ uint2 quant8(const float (&f)[8], float scale) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i / 4] |= ((uint32_t)owc_quant_int8(f[i], scale) & 0xFFu) << (8 * (i % 4));
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ float absmax8(const float (&f)[8], float a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) a = fmaxf(a, fabsf(f[i]));
  return a;
}

// (f32(acc) * s) * sw, rounded once each, as the plain version multiplies.
__device__ __forceinline__ float dequant(int acc, float s, float sw) {
  return __fmul_rn(__fmul_rn((float)acc, s), sw);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
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

// ---- M <= 1024: one launch, K split over a cluster ----

constexpr int S_BM = 32, S_BN = 128, S_BK = 64, S_NS = 4, S_THREADS = 256;
constexpr int S_STAGE = S_BK * S_BN;        // 8 KB of stored W a stage
constexpr int S_PART = S_BN + 4;            // int32 partial tile row

// The swizzled byte offset of stored row r, 16-byte chunk c, of a stage.
__device__ __forceinline__ int s_chunk(int r, int c) {
  return r * S_BN + ((c ^ (2 * ((r >> 2) & 3))) << 4);
}

inline int s_smem_bytes(int klen) {
  return S_NS * S_STAGE + S_BM * (klen + 16);
}

template <typename T, bool RAGGED>
__global__ void __launch_bounds__(S_THREADS)
w8a8_small(const T* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ sw, const float* __restrict__ act_scale,
           T* __restrict__ out, int M, int N, int K, int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float amax[S_BM];
  __shared__ float sxs[S_BM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * S_BN, m0 = blockIdx.y * S_BM;
  const int klen = tiles_per_split * S_BK;
  const int kb = blockIdx.z * klen;
  const int AS = klen + 16;  // slab row stride: a fragment load hits 32 banks
  int8_t* slab = reinterpret_cast<int8_t*>(smem + S_NS * S_STAGE);
  const unsigned ring = smem_u32(smem);
  // ragged: which pieces may still move 16 bytes (or 4 outputs) at a time
  const bool xvec = K % 8 == 0, wvec = N % 16 == 0, ovec = N % 4 == 0;

  // W tile t (64 stored rows x 128 columns) into stage t % S_NS; rows past K
  // and columns past N are zero filled; a group is committed either way
  auto load_w = [&](int t) {
    if (t < tiles_per_split) {
#pragma unroll
      for (int i = 0; i < S_STAGE / 16 / S_THREADS; ++i) {
        const int c = tid + i * S_THREADS, r = c >> 3, ch = c & 7;
        const int k = kb + t * S_BK + r, n = n0 + ch * 16;
        const bool ok = k < K && n < N;
        if (!RAGGED || wvec) {
          cp_async16(ring + (t % S_NS) * S_STAGE + s_chunk(r, ch),
                     ok ? w + (size_t)k * N + n : w, ok ? 16 : 0);
        } else {  // rows not 16-byte aligned: a byte at a time, stored plainly
          uint32_t v[4];
          load_bytes<4>(w + (size_t)k * N, n, ok ? N : n, v);
          *reinterpret_cast<uint4*>(smem + (t % S_NS) * S_STAGE + s_chunk(r, ch)) =
              make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < S_NS - 1; ++t) load_w(t);

  // the rows' scales: this block's partial absmax, then the cluster's
  // maximum. Both passes over x walk (row, 8-value chunk) items with
  // neighbouring threads on neighbouring chunks, so each thread's loads are
  // independent and in flight together; a row's maximum gathers by a
  // shared-memory atomicMax on the float's bits (|x| >= 0: they order alike).
  cg::cluster_group cluster = cg::this_cluster();
  const int cpr = klen / 8;  // chunks a row
  if (act_scale == nullptr) {
    if (tid < S_BM) amax[tid] = 0.0f;
    __syncthreads();
#pragma unroll 4
    for (int e = tid; e < S_BM * cpr; e += S_THREADS) {
      const int r = e / cpr, k = kb + (e % cpr) * 8;
      if (m0 + r < M && k < K) {
        float f[8];
        load8x<RAGGED>(x + (size_t)(m0 + r) * K, k, K, xvec, f);
        atomicMax(reinterpret_cast<int*>(&amax[r]), __float_as_int(absmax8(f, 0.0f)));
      }
    }
    cluster.sync();  // every split's partial absmax is in its shared memory
    if (tid < S_BM) {
      float a = 0.0f;
      for (int sp = 0; sp < (int)cluster.num_blocks(); ++sp)
        a = fmaxf(a, cluster.map_shared_rank(amax, sp)[tid]);
      sxs[tid] = fmaxf(a, 1e-12f) * (1.0f / 127.0f);
    }
  } else if (tid < S_BM) {
    sxs[tid] = *act_scale;
  }
  __syncthreads();

  // the slab: this block's rows over its K range as int8 codes (zeros past
  // M and past K)
#pragma unroll 4
  for (int e = tid; e < S_BM * cpr; e += S_THREADS) {
    const int r = e / cpr, c = e % cpr, k = kb + c * 8;
    uint2 q = make_uint2(0u, 0u);
    if (m0 + r < M && k < K) {
      float f[8];
      load8x<RAGGED>(x + (size_t)(m0 + r) * K, k, K, xvec, f);
      q = quant8(f, sxs[r]);
    }
    *reinterpret_cast<uint2*>(slab + r * AS + c * 8) = q;
  }

  const int wm = warp >> 2, wn = warp & 3;  // 16 rows x 32 columns a warp
  // the B words of a thread: rows 4 t4 + i (and + 16), bytes 4g .. 4g + 3 of
  // the warp's 32 columns; the chunk's swizzle is the same for all 8 rows
  const int colb = (((2 * wn + (g >> 2)) ^ (2 * t4)) << 4) + (g & 3) * 4;
  const int8_t* a_row = slab + (wm * 16 + g) * AS + 4 * t4;
  int acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  for (int t = 0; t < tiles_per_split; ++t) {
    cp_async_wait<S_NS - 2>();  // tile t has landed
    __syncthreads();  // ... for every thread; the slab is whole; stage t - 1 is free
    load_w(t + S_NS - 1);
    const unsigned char* st = smem + (t % S_NS) * S_STAGE;
#pragma unroll
    for (int ks = 0; ks < S_BK / 32; ++ks) {
      const int8_t* ap = a_row + t * S_BK + ks * 32;
      const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(ap),
                             *reinterpret_cast<const uint32_t*>(ap + 8 * AS),
                             *reinterpret_cast<const uint32_t*>(ap + 16),
                             *reinterpret_cast<const uint32_t*>(ap + 8 * AS + 16)};
      uint32_t w0[4], w1[4], b0[4], b1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ks * 32 + 4 * t4 + i;
        w0[i] = *reinterpret_cast<const uint32_t*>(st + r * S_BN + colb);
        w1[i] = *reinterpret_cast<const uint32_t*>(st + (r + 16) * S_BN + colb);
      }
      transpose4(w0, b0);
      transpose4(w1, b1);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[j], a, b0[j], b1[j]);
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // every product is done: the ring gives way to the partial tile
  int* part = reinterpret_cast<int*>(smem);
  {
    // tile j's column 2 t4 (+1) is the warp's column 8 t4 + j (+ 4)
    int* p = part + (wm * 16 + g) * S_PART + wn * 32 + 8 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8
      *reinterpret_cast<int4*>(p + h * 8 * S_PART) =
          make_int4(acc[0][2 * h], acc[1][2 * h], acc[2][2 * h], acc[3][2 * h]);
      *reinterpret_cast<int4*>(p + h * 8 * S_PART + 4) = make_int4(
          acc[0][2 * h + 1], acc[1][2 * h + 1], acc[2][2 * h + 1], acc[3][2 * h + 1]);
    }
  }
  cluster.sync();  // every split's partial tile is in its block's shared memory
  const int splits = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  // this block sums and stores every splits-th group of 4 columns
  for (int e = rank + splits * tid; e < S_BM * (S_BN / 4); e += splits * S_THREADS) {
    const int row = e / (S_BN / 4), c4 = (e % (S_BN / 4)) * 4;
    const int m = m0 + row, n = n0 + c4;
    if (m >= M || n >= N) continue;  // aligned (N % 16 == 0): n + 3 < N too
    int4 s = make_int4(0, 0, 0, 0);
    for (int sp = 0; sp < splits; ++sp) {
      const int4 v = *reinterpret_cast<const int4*>(cluster.map_shared_rank(part, sp)
                                                    + row * S_PART + c4);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const float sc = sxs[row];
    T* o = out + (size_t)m * N + n;
    if (!RAGGED || ovec) {
      store2(o, dequant(s.x, sc, sw[n]), dequant(s.y, sc, sw[n + 1]));
      store2(o + 2, dequant(s.z, sc, sw[n + 2]), dequant(s.w, sc, sw[n + 3]));
    } else {
      const int v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n + i < N) owc_store(o + i, dequant(v[i], sc, sw[n + i]));
    }
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

template <typename T, bool RAGGED>
int launch_small(const void* x, const void* w, const void* sw, const void* act_scale,
                 void* out, int M, int N, int K, int splits, cudaStream_t st) {
  const int ktiles = (K + S_BK - 1) / S_BK;
  if (splits < 1 || splits > 8 || ktiles % splits != 0) return (int)cudaErrorInvalidValue;
  const int tps = ktiles / splits;
  const int smem = s_smem_bytes(tps * S_BK);
  cudaError_t e = cudaFuncSetAttribute(w8a8_small<T, RAGGED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + S_BN - 1) / S_BN, (M + S_BM - 1) / S_BM, splits);
  cfg.blockDim = dim3(S_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, w8a8_small<T, RAGGED>, static_cast<const T*>(x),
                         static_cast<const int8_t*>(w), static_cast<const float*>(sw),
                         static_cast<const float*>(act_scale), static_cast<T*>(out), M,
                         N, K, tps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---- M > 1024: a quantize pass, then the persistent wgmma GEMM ----

constexpr int Q_THREADS = 256;  // a warp per row

// Row m of x to int8 codes in row m of xq, Kp codes a row (K, then zeros
// to Kp), and, dynamic, its scale in sx.
template <typename T, bool RAGGED>
__global__ void __launch_bounds__(Q_THREADS)
w8a8_quantize(const T* __restrict__ x, const float* __restrict__ act_scale,
              int8_t* __restrict__ xq, float* __restrict__ sx, int M, int K, int Kp) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (Q_THREADS / 32) + (threadIdx.x >> 5);
  if (m >= M) return;
  const T* row = x + (size_t)m * K;
  float scale;
  if (act_scale == nullptr) {
    float a = 0.0f;
    for (int k = lane * 8; k < K; k += 32 * 8) {
      float f[8];
      load8x<RAGGED>(row, k, K, K % 8 == 0, f);
      a = absmax8(f, a);
    }
    scale = fmaxf(owc_warp_max(a), 1e-12f) * (1.0f / 127.0f);
    if (lane == 0) sx[m] = scale;
  } else {
    scale = *act_scale;
  }
  for (int k = lane * 8; k < Kp; k += 32 * 8) {
    float f[8];
    load8x<RAGGED>(row, k, K, K % 8 == 0, f);
    *reinterpret_cast<uint2*>(xq + (size_t)m * Kp + k) = quant8(f, scale);
  }
}

constexpr int G_BM = 128, G_BN = 128, G_BK = 128, G_STAGES = 4, G_RAW = 4;
constexpr int G_CONSUMERS = 256, G_PRODUCERS = 256;
constexpr int G_THREADS = G_CONSUMERS + G_PRODUCERS;
constexpr int G_TILE = G_BM * G_BK;  // 16 KB: the xq tile, and as much of W
constexpr int G_STAGE = 2 * G_TILE;
// the stages, W's stored bytes in flight, and alignment slack
constexpr int G_SMEM = G_STAGES * G_STAGE + G_RAW * G_TILE + 1024;

// 4 bytes to the shared address `dst`, zero filled where src_bytes is 0
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// d (64 x 128 int32) (+)= A (64 x 32 int8) * B (32 x 128 int8), both K-major
// tiles of 128-byte rows in shared memory. Thread t of the warpgroup holds
// rows 16 * (t / 32) + (t % 32) / 4 (+ 8) and columns 8j + 2 * (t % 4) (+ 1)
// in d[4j .. 4j + 3].
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
        "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]),
        "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
        "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void reg_fence(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The epilogue of a consumer thread's 64 x 128 accumulators: rows m0 and
// m0 + 8, columns n0 + 8j (+1), scaled and stored in x's type.
template <typename T, bool RAGGED>
__device__ __forceinline__ void store_tile(const int (&acc)[64], int m0, int n0,
                                           const float* __restrict__ sx, int sx_stride,
                                           const float* __restrict__ sw,
                                           T* __restrict__ out, int M, int N) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows g and g + 8
    const int m = m0 + h * 8;
    if (m >= M) continue;
    const float s = sx[(size_t)m * sx_stride];
    T* orow = out + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j;
      if (!RAGGED || N % 2 == 0) {
        if (n < N)  // N is even: n + 1 < N too
          store2(orow + n, dequant(acc[4 * j + 2 * h], s, __ldg(sw + n)),
                 dequant(acc[4 * j + 2 * h + 1], s, __ldg(sw + n + 1)));
      } else {  // odd N: no pair is aligned
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (n + i < N)
            owc_store(orow + n + i, dequant(acc[4 * j + 2 * h + i], s, __ldg(sw + n + i)));
      }
    }
  }
}

// out (M, N) = (f32(xq (M, K) . W (K, N)) * sx[m * sx_stride]) * sw[n]
template <typename T, bool RAGGED>
__global__ void __launch_bounds__(G_THREADS, 1)
w8a8_gemm(const __grid_constant__ CUtensorMap xq_map, const int8_t* __restrict__ w,
          const float* __restrict__ sx, int sx_stride, const float* __restrict__ sw,
          T* __restrict__ out, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[G_STAGES];
  __shared__ __align__(8) uint64_t empty_bar[G_STAGES];
  // the swizzle repeats every 1024 bytes of shared address
  unsigned char* stages = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int tiles_n = (N + G_BN - 1) / G_BN;
  const int tiles = ((M + G_BM - 1) / G_BM) * tiles_n;
  const int ktiles = (K + G_BK - 1) / G_BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(&full_bar[s], G_PRODUCERS / 32 + 1);  // each producer warp + the TMA bytes
      mbar_init(&empty_bar[s], G_CONSUMERS / 32);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= G_CONSUMERS) {
    // ---- producers: xq by TMA, W turned K-major by 8 warps ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int p = tid - G_CONSUMERS, pwarp = p >> 5, lane = p & 31;
    // a warp's 64 k x 32 n of the stage; a lane's 16 k x 4 n of that
    const int kc = lane & 3, nq = lane >> 2;
    const int krow = (pwarp & 1) * 64 + kc * 16;       // first of the lane's 16 k
    const int ncol = (pwarp >> 1) * 32 + nq * 4;       // first of its 4 n
    const int chunk = krow >> 4;                        // its 16 k: one chunk a row
    // the lane's 16 words of W in flight, G_RAW items deep, in a ring of its
    // own words (each lane reads back only what it copied)
    const unsigned raw = smem_u32(stages + G_STAGES * G_STAGE) + (pwarp * 512 + lane) * 4;
    const int items = ((tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x) * ktiles;
    auto fetch = [&](int it) {  // zeros past K and N; nothing past the last item
      if (it < items) {
        const int tile = blockIdx.x + (it / ktiles) * gridDim.x;
        const int k0 = (it % ktiles) * G_BK + krow, n = (tile % tiles_n) * G_BN + ncol;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const bool ok = k0 + i < K && n < N;
          const unsigned dst = raw + (it % G_RAW) * G_TILE + i * 128;
          if (!RAGGED || N % 4 == 0) {
            cp_async4(dst, ok ? w + (size_t)(k0 + i) * N + n : w, ok ? 4 : 0);
          } else {  // rows not 4-byte aligned: bytes, stored plainly (the
                    // lane reads back only its own words)
            uint32_t v[1];
            load_bytes<1>(w + (size_t)(k0 + i) * N, n, ok ? N : n, v);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst), "r"(v[0]));
          }
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < G_RAW - 1; ++i) fetch(i);
    for (int it = 0; it < items; ++it) {
      const int s = it % G_STAGES, round = it / G_STAGES;
      fetch(it + G_RAW - 1);
      cp_async_wait<G_RAW - 1>();  // item it's words have landed
      uint32_t o[4][4];  // [group of 4 k][column]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t r4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned a = raw + (it % G_RAW) * G_TILE + (4 * q + i) * 128;
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(r4[i]) : "r"(a));
        }
        transpose4(r4, o[q]);
      }
      mbar_wait(&empty_bar[s], (round & 1) ^ 1);  // passes on a fresh barrier
      unsigned char* a_tile = stages + s * G_STAGE;
      unsigned char* b_tile = a_tile + G_TILE;
      if (p == 0) {
        const int tile = blockIdx.x + (it / ktiles) * gridDim.x;
        mbar_expect_tx(&full_bar[s], G_TILE);
        tma_load_2d(a_tile, &xq_map, &full_bar[s], (it % ktiles) * G_BK,
                    (tile / tiles_n) * G_BM);
      }
      // column j of the lane's 4: 16 k in one chunk of row n, swizzled by n % 8
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = ncol + j;
        *reinterpret_cast<uint4*>(b_tile + n * G_BK + ((chunk ^ (n & 7)) << 4)) =
            make_uint4(o[0][j], o[1][j], o[2][j], o[3][j]);
      }
      fence_proxy_async();  // the stores are for wgmma's eyes
      __syncwarp();
      if (lane == 0) mbar_arrive(&full_bar[s]);  // one arrival a warp
    }
    cp_async_wait<0>();
  } else {
    // ---- consumers: two warpgroups of 64 rows ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
    const int wg = tid >> 7, lane = tid & 31, warp_in_wg = (tid >> 5) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    int acc[64];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % G_STAGES;
        mbar_wait(&full_bar[s], (it / G_STAGES) & 1);
        const unsigned char* a_tile = stages + s * G_STAGE + wg * 64 * G_BK;
        const uint64_t ad = smem_desc(a_tile), bd = smem_desc(stages + s * G_STAGE + G_TILE);
        reg_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < G_BK / 32; ++kk)  // 32 k are 32 bytes of a row
          wgmma_s8(acc, ad + ((kk * 32) >> 4), bd + ((kk * 32) >> 4), kt > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        reg_fence(acc);
        if (kt > 0 && lane == 0) mbar_arrive(&empty_bar[(it - 1) % G_STAGES]);
      }
      wgmma_wait<0>();
      reg_fence(acc);
      if (lane == 0) mbar_arrive(&empty_bar[(it - 1) % G_STAGES]);

      store_tile<T, RAGGED>(acc, (tile / tiles_n) * G_BM + wg * 64 + warp_in_wg * 16 + g,
                 (tile % tiles_n) * G_BN + 2 * t4, sx, sx_stride, sw, out, M, N);
    }
  }
}

// The same product where W's 128-column panel fits in shared memory whole
// (K <= P_KMAX): a block keeps one n-tile's panel, turned K-major once at
// its start, and walks m-tiles, so W is read once a block and an item
// brings only its 16 KB of xq by TMA. The producer warpgroup turns the panel
// around, then its first thread keeps the xq ring full.
constexpr int P_KMAX = 1024, P_THREADS = 384, P_MAX_STAGES = 8;
constexpr int P_SMEM = 227 * 1024 - 1024;  // the card's 227 KB less room for the barriers

template <typename T, bool RAGGED>
__global__ void __launch_bounds__(P_THREADS, 1)
w8a8_gemm_panel(const __grid_constant__ CUtensorMap xq_map, const int8_t* __restrict__ w,
                const float* __restrict__ sx, int sx_stride, const float* __restrict__ sw,
                T* __restrict__ out, int M, int N, int K, int stages) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[P_MAX_STAGES];
  __shared__ __align__(8) uint64_t empty_bar[P_MAX_STAGES];
  __shared__ __align__(8) uint64_t panel_bar;
  unsigned char* panel = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int ktiles = (K + G_BK - 1) / G_BK;
  unsigned char* ring = panel + ktiles * G_TILE;
  const int tiles_n = (N + G_BN - 1) / G_BN, tiles_m = (M + G_BM - 1) / G_BM;
  const int per_n = gridDim.x / tiles_n;  // blocks sharing an n-tile
  const int nt = blockIdx.x % tiles_n, m_first = blockIdx.x / tiles_n;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full_bar[s], 1);                  // the TMA bytes
      mbar_init(&empty_bar[s], G_CONSUMERS / 32);  // lane 0 of each consumer warp
    }
    mbar_init(&panel_bar, 4);                       // lane 0 of each producer warp
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= G_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int p = tid - G_CONSUMERS, lane = p & 31;
    // the panel: tasks of 16 k x 4 n (a lane's 4 x 4 byte blocks, as in
    // w8a8_gemm), lanes of a warp on neighbouring tasks
    const int n_base = nt * G_BN;
    for (int task = p; task < ktiles * 8 * 32; task += 128) {
      const int k16 = task >> 5, nq = task & 31;  // 16-row group, 4-column group
      const int k0 = k16 * 16, n = n_base + nq * 4;
      uint32_t r[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const bool ok = k0 + i < K && n < N;
        if (!RAGGED || N % 4 == 0) {
          r[i] = ok ? __ldg(reinterpret_cast<const uint32_t*>(w + (size_t)(k0 + i) * N + n))
                    : 0u;
        } else {  // rows not 4-byte aligned: bytes
          uint32_t v[1];
          load_bytes<1>(w + (size_t)(k0 + i) * N, n, ok ? N : n, v);
          r[i] = v[0];
        }
      }
      uint32_t o[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t r4[4] = {r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]};
        transpose4(r4, o[q]);
      }
      unsigned char* tile = panel + (k16 >> 3) * G_TILE;
      const int chunk = k16 & 7;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = nq * 4 + j;
        *reinterpret_cast<uint4*>(tile + nn * G_BK + ((chunk ^ (nn & 7)) << 4)) =
            make_uint4(o[0][j], o[1][j], o[2][j], o[3][j]);
      }
    }
    fence_proxy_async();  // the panel is for wgmma's eyes
    __syncwarp();
    if (lane == 0) mbar_arrive(&panel_bar);
    if (p == 0) {
      int it = 0;
      for (int mt = m_first; mt < tiles_m; mt += per_n)
        for (int ks = 0; ks < ktiles; ++ks, ++it) {
          const int s = it % stages, round = it / stages;
          mbar_wait(&empty_bar[s], (round & 1) ^ 1);  // passes on a fresh barrier
          mbar_expect_tx(&full_bar[s], G_TILE);
          tma_load_2d(ring + s * G_TILE, &xq_map, &full_bar[s], ks * G_BK, mt * G_BM);
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int wg = tid >> 7, lane = tid & 31, warp_in_wg = (tid >> 5) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    int acc[64];
    int it = 0;
    mbar_wait(&panel_bar, 0);
    for (int mt = m_first; mt < tiles_m; mt += per_n) {
      for (int ks = 0; ks < ktiles; ++ks, ++it) {
        const int s = it % stages;
        mbar_wait(&full_bar[s], (it / stages) & 1);
        const uint64_t ad = smem_desc(ring + s * G_TILE + wg * 64 * G_BK);
        const uint64_t bd = smem_desc(panel + ks * G_TILE);
        reg_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < G_BK / 32; ++kk)
          wgmma_s8(acc, ad + ((kk * 32) >> 4), bd + ((kk * 32) >> 4), ks > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        reg_fence(acc);
        if (ks > 0 && lane == 0) mbar_arrive(&empty_bar[(it - 1) % stages]);
      }
      wgmma_wait<0>();
      reg_fence(acc);
      if (lane == 0) mbar_arrive(&empty_bar[(it - 1) % stages]);
      store_tile<T, RAGGED>(acc, mt * G_BM + wg * 64 + warp_in_wg * 16 + g, nt * G_BN + 2 * t4, sx,
                 sx_stride, sw, out, M, N);
    }
  }
}

// The tensor map of xq (M, K) int8: boxes of 128 rows x 128 k, 128-byte
// swizzle, rows and k past the edges filled with zeros.
bool make_xq_map(CUtensorMap* map, const void* xq, int M, int K) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t size[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t stride[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {G_BK, G_BM};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(xq), size, stride,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, bool RAGGED>
int launch_large(const void* x, const void* w, const void* sw, const void* act_scale,
                 void* xq, void* sx, void* out, int M, int N, int K, cudaStream_t st) {
  const int Kp = (K + 15) / 16 * 16;  // xq's row: a 16-byte stride for TMA
  w8a8_quantize<T, RAGGED><<<(M + Q_THREADS / 32 - 1) / (Q_THREADS / 32), Q_THREADS, 0,
                             st>>>(static_cast<const T*>(x),
                                   static_cast<const float*>(act_scale),
                                   static_cast<int8_t*>(xq), static_cast<float*>(sx), M, K, Kp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map;
  if (!make_xq_map(&map, xq, M, Kp)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const float* scales = static_cast<const float*>(act_scale ? act_scale : sx);
  const int tiles_n = (N + G_BN - 1) / G_BN, tiles_m = (M + G_BM - 1) / G_BM;
  if (K <= P_KMAX) {  // W's panel of an n-tile stays in shared memory
    const int panel = ((K + G_BK - 1) / G_BK) * G_TILE;
    const int stages = min(P_MAX_STAGES, (P_SMEM - 1024 - panel) / G_TILE);
    const int per_n = max(1, min(tiles_m, sms / tiles_n));
    const int smem = panel + stages * G_TILE + 1024;
    e = cudaFuncSetAttribute(w8a8_gemm_panel<T, RAGGED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    w8a8_gemm_panel<T, RAGGED><<<tiles_n * per_n, P_THREADS, smem, st>>>(
        map, static_cast<const int8_t*>(w), scales, act_scale ? 0 : 1,
        static_cast<const float*>(sw), static_cast<T*>(out), M, N, K, stages);
    return (int)cudaGetLastError();
  }
  e = cudaFuncSetAttribute(w8a8_gemm<T, RAGGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           G_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles = tiles_m * tiles_n;
  w8a8_gemm<T, RAGGED><<<tiles < sms ? tiles : sms, G_THREADS, G_SMEM, st>>>(
      map, static_cast<const int8_t*>(w), scales, act_scale ? 0 : 1,
      static_cast<const float*>(sw), static_cast<T*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) f32/bf16/f16 (dtype code), w (K, N) int8, sw (N,) f32, act_scale
// one f32 on the device or null (dynamic per-row scales); out (M, N) in x's
// dtype. Any K and N (K or N off 16 takes the RAGGED instantiation); x and
// w 16-byte aligned.
// M <= 1024: one kernel; `splits` (1..8, dividing ceil(K / 64)) is the size
// of the thread block cluster that shares a tile's K, and the K range of a
// split, ceil(K / 64) / splits * 64 bytes, is held in shared memory for 32
// rows (at most 4096). xq and sx are unused (may be null).
// M > 1024: two kernels; scratch xq (M, Kp) int8, Kp = K rounded up to 16
// (16-byte aligned), and, for
// dynamic scales, sx (M,) f32; `splits` is unused.
extern "C" int owc_w8a8_matmul(const void* x, const void* w, const void* sw,
                               const void* act_scale, void* xq, void* sx, void* out,
                               int M, int N, int K, int splits, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const bool ragged = K % 16 != 0 || N % 16 != 0;
  int err = 0;
  const bool ok = owc_dispatch_float(dtype, [&](auto tag) {
    using T = decltype(tag);
    if (ragged)
      err = M <= 1024 ? launch_small<T, true>(x, w, sw, act_scale, out, M, N, K, splits, st)
                      : launch_large<T, true>(x, w, sw, act_scale, xq, sx, out, M, N, K, st);
    else
      err = M <= 1024 ? launch_small<T, false>(x, w, sw, act_scale, out, M, N, K, splits, st)
                      : launch_large<T, false>(x, w, sw, act_scale, xq, sx, out, M, N, K, st);
  });
  return ok ? err : (int)cudaErrorInvalidValue;
}
