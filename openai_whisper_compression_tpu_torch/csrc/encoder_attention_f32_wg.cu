// Non-causal encoder attention in f32 on the tensor cores by 3xTF32 on
// wgmma: the f32 body at head dims 33-64 (capacity 64: every Whisper
// size's). encoder_attention_f32.cu states the arithmetic and holds the
// other capacities' mma.sync body; this one computes the same function (q
// scaled in f32; the scores, the online softmax and the sums in f32; expf)
// with the products on wgmma, which ran faster than the mma.sync body at
// whisper-small's shape on the card (PERF.md).
//
// Replaces: openai_whisper_compression_tpu/ops/attention.py
//           encoder_attention_pallas (kernel body _attn_kernel), for f32
//           inputs of head dim 33-64.
//
// What bounds it on the H100: operations, 3 x 4 * B*H * T^2 * 64 TF32 flop
// (2.0e12 at whisper-small, batch 96: 4.0 ms at 495 TFLOP/s).
//
// wgmma takes TF32 operands K-major only, and f32 data needs splitting:
// - A block is three warpgroups: two consumers of 64 query rows each (128
//   rows an item) and a producer; blocks are persistent (one an SM) and walk
//   (batch, head, query block) items, query block fastest, so no grid
//   extent grows with B*H.
// - The producer's 128 threads load each tile of 64 keys from device memory
//   (16-byte loads where rows allow, else by elements; zeros past T and dh;
//   a thread's 16 loads of the next tile in flight together while it waits
//   for a stage), split every value into x_hi = tf32(x) and x_lo = tf32(x -
//   x_hi), and write both to a ring of 2 stages in the 128-byte swizzle
//   wgmma reads: K as it lies ([key][d], two 32-dim halves: K-major for S =
//   Q K^T), V transposed ([d][key], two 32-key halves: K-major for O += P
//   V); then it fences the async proxy and arrives on the stage's `full`
//   barrier (a lane a warp). In V's rows the keys of each group of 8 lie in
//   the order 0, 2, 4, 6, 1, 3, 5, 7: wgmma's TF32 A fragment holds k = t4
//   and t4 + 4 where the score accumulator holds keys 2 t4 and 2 t4 + 1, so
//   in that order the scores, exponentiated and split, are P V's A operand
//   as they lie in registers.
// - Each consumer scales its 64 rows of q in f32, splits them and writes Q_hi
//   and Q_lo tiles (the A operand of S, from shared memory) at the start of
//   an item.
// - S = Q K^T: each k step of 8 dims is three m64n64k8 products, Q_lo K_hi,
//   Q_hi K_lo, Q_hi K_hi, into a fresh accumulator that one f32 add takes
//   into the scores once the step is done (the other consumer's products
//   keep the tensor cores busy meanwhile): the tensor cores cut the low bits
//   of their own additions, and carried over all the steps in one
//   accumulator that bias broke the 1e-5 bound on peaked scores.
// - O += P V: the 8 k steps of a tile (three products each) go into a fresh
//   per-tile accumulator, added into O after the online rescale: the bias of
//   a tile's 24 products is that of a 24th of the sum.
// - The online softmax's row maximum and sum are shuffles over a row's 4
//   threads; keys past T score -inf (their V rows are zeros).
// - Registers: every thread keeps the 168 a block of 384 threads starts
//   with: the consumers need no more, and the producer holds one tile's 64
//   values in them (two tiles' spilled).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int WG_ROWS = 64;               // query rows a consumer
constexpr int WG_BM = 2 * WG_ROWS;        // query rows an item
constexpr int WG_BN = 64;                 // keys a tile
constexpr int WG_CONSUMERS = 256;
constexpr int WG_THREADS = WG_CONSUMERS + 128;
constexpr int WG_STAGES = 2;
constexpr int WG_HALF = 64 * 128;         // a [64 rows][32 f32] swizzled half
constexpr int WG_TILE = 2 * WG_HALF;      // 64 x 64 f32
// a stage: K_hi, K_lo, V_hi, V_lo tiles; then each consumer's Q_hi, Q_lo
constexpr int WG_STAGE_BYTES = 4 * WG_TILE;
constexpr int WG_Q_BYTES = 2 * WG_TILE;
constexpr int WG_SMEM = WG_STAGES * WG_STAGE_BYTES + 2 * WG_Q_BYTES + 1024;

struct Strides {  // in elements; the head dim is contiguous
  long long b, h, t;
};

__device__ __forceinline__ uint32_t tf32_hi(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as the TF32 pair (hi, lo): hi = x rounded to TF32 (nearest, ties away),
// lo = the remainder rounded to TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_hi(x);
  lo = tf32_hi(x - __uint_as_float(hi));
}

// Byte offset of f32 element (row, col < 32) in a [rows][32] tile of
// 128-byte rows in the 128-byte swizzle (1024-byte aligned).
__device__ __forceinline__ int sw128(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
}

template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define OWC_D32                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define OWC_D32_ARGS                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),      \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64 f32) = or += A (64 x 8 TF32, a K-major shared tile) * B (8 x 64,
// a K-major [n][k] shared tile)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " OWC_D32
      ", %32, %33, p, 1, 1;\n"
      "}\n"
      : OWC_D32_ARGS
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32) = or += a (64 x 8 TF32, registers) * B (8 x 64, a K-major
// [n][k] shared tile)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " OWC_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : OWC_D32_ARGS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
#undef OWC_D32
#undef OWC_D32_ARGS

// the 128 threads of consumer `wg` meet (named barriers 1 and 2)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// 4 values of row r (< T) at dims d0.. (< dh) of src, zeros elsewhere:
// one 16-byte load where rows are 16-byte aligned (vec), else by elements
__device__ __forceinline__ float4 load4(const float* src, long long st, int r, int d0, int T,
                                        int dh, bool vec) {
  if (r >= T) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = src + (long long)r * st + d0;
  if (vec) return d0 < dh ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(d0 < dh ? __ldg(p) : 0.f, d0 + 1 < dh ? __ldg(p + 1) : 0.f,
                     d0 + 2 < dh ? __ldg(p + 2) : 0.f, d0 + 3 < dh ? __ldg(p + 3) : 0.f);
}

__global__ void __launch_bounds__(WG_THREADS, 1)
encoder_attention_f32_wg_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ out,
                                int BH, int H, int T, int dh, float scale, Strides qs,
                                Strides ks, Strides vs, Strides os, bool vec, bool pairs) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[WG_STAGES];
  __shared__ __align__(8) uint64_t empty_bar[WG_STAGES];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31;
  const int ntiles = (T + WG_BN - 1) / WG_BN;
  const int qblocks = (T + WG_BM - 1) / WG_BM;
  const int items = qblocks * BH;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full_bar[s], 4);    // lane 0 of each producer warp
      mbar_init(&empty_bar[s], 8);   // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= WG_CONSUMERS) {
    // ---- producer warpgroup: loads, splits and lays out the K and V tiles ----
    const int pt = tid - WG_CONSUMERS, warp = pt >> 5;   // 0..127, 0..3
    const int kl = lane & 7, col = (lane & ~7) + (kl >> 1) + 4 * (kl & 1);   // V's key order
    const int mine = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
    const int fills = mine * ntiles;   // this block's tiles, over all its items
    // a thread's 8 pieces of 4 values of K ([key][d], a thread 4 dims of a
    // key) and of V (a lane a key, 4 dims a step) of tile n, all loads in
    // flight together; tile n + 1's are fetched while tile n is laid out
    // a thread's 8 pieces of 4 values of K ([key][d], a thread 4 dims of a
    // key) and of V (a lane a key, 4 dims a step) of tile n, all 16 loads in
    // flight together; tile n + 1's are fetched as soon as tile n is laid out
    float4 kx[8], vx[8];
    auto fetch = [&](int n) {
      const int w = blockIdx.x + (n / ntiles) * gridDim.x, key0 = (n % ntiles) * WG_BN;
      const int bh = w / qblocks, b = bh / H, h = bh % H;
      const float* kg = k + b * ks.b + h * ks.h;
      const float* vg = v + b * vs.b + h * vs.h;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = pt + 128 * i, task = warp + 4 * i;   // 32 V tasks: 2 key halves x 16 dim groups
        kx[i] = load4(kg, ks.t, key0 + (e >> 4), (e & 15) * 4, T, dh, vec);
        vx[i] = load4(vg, vs.t, key0 + (task >> 4) * 32 + lane, (task & 15) * 4, T, dh, vec);
      }
    };
    if (fills > 0) fetch(0);
    for (int n = 0; n < fills; ++n) {
      const int s = n % WG_STAGES;
      mbar_wait(&empty_bar[s], ((n / WG_STAGES) & 1) ^ 1);   // passes on a fresh barrier
      unsigned char* st = smem + s * WG_STAGE_BYTES;
#pragma unroll
      for (int i = 0; i < 8; ++i) {   // K: two 32-dim halves
        const int e = pt + 128 * i, key = e >> 4, d0 = (e & 15) * 4;
        uint4 hi, lo;
        split_tf32(kx[i].x, hi.x, lo.x);
        split_tf32(kx[i].y, hi.y, lo.y);
        split_tf32(kx[i].z, hi.z, lo.z);
        split_tf32(kx[i].w, hi.w, lo.w);
        const int off = (d0 >> 5) * WG_HALF + sw128(key, d0 & 31);
        *reinterpret_cast<uint4*>(st + off) = hi;
        *reinterpret_cast<uint4*>(st + WG_TILE + off) = lo;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {   // V transposed: two 32-key halves
        const int task = warp + 4 * i, half = task >> 4, d0 = (task & 15) * 4;
        const float xs[4] = {vx[i].x, vx[i].y, vx[i].z, vx[i].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          uint32_t hi, lo;
          split_tf32(xs[c], hi, lo);
          const int off = half * WG_HALF + sw128(d0 + c, col);
          *reinterpret_cast<uint32_t*>(st + 2 * WG_TILE + off) = hi;
          *reinterpret_cast<uint32_t*>(st + 3 * WG_TILE + off) = lo;
        }
      }
      fence_proxy_async();   // the tiles, for wgmma's eyes
      __syncwarp();
      if (lane == 0) mbar_arrive(&full_bar[s]);
      if (n + 1 < fills) fetch(n + 1);
    }
  } else {
  // ---- consumer warpgroups ----
  const int wg = tid >> 7, wt = tid & 127, warp_in_wg = wt >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  unsigned char* qhi = smem + WG_STAGES * WG_STAGE_BYTES + wg * WG_Q_BYTES;
  unsigned char* qlo = qhi + WG_TILE;
  const int ksteps = (dh + 7) / 8;   // k steps of S that hold dims below dh
  int it = 0;                        // tiles consumed so far

  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int bh = w / qblocks, b = bh / H, h = bh % H;
    const int row0 = (w % qblocks) * WG_BM + wg * WG_ROWS;
    {  // this consumer's 64 rows of q * scale, split: [row][d] in two halves
      const float* qg = q + b * qs.b + h * qs.h;
#pragma unroll 2
      for (int i = 0; i < 8; ++i) {
        const int e = wt + 128 * i, r = e >> 4, d0 = (e & 15) * 4;
        const float4 x = load4(qg, qs.t, row0 + r, d0, T, dh, vec);
        uint4 hi, lo;
        split_tf32(x.x * scale, hi.x, lo.x);
        split_tf32(x.y * scale, hi.y, lo.y);
        split_tf32(x.z * scale, hi.z, lo.z);
        split_tf32(x.w * scale, hi.w, lo.w);
        const int off = (d0 >> 5) * WG_HALF + sw128(r, d0 & 31);
        *reinterpret_cast<uint4*>(qhi + off) = hi;
        *reinterpret_cast<uint4*>(qlo + off) = lo;
      }
      fence_proxy_async();
      wg_sync(wg);   // (the previous item's products on Q are long done)
    }

    float o[32], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;

    for (int j = 0; j < ntiles; ++j, ++it) {
      const int s = it % WG_STAGES;
      mbar_wait(&full_bar[s], (it / WG_STAGES) & 1);
      unsigned char* st = smem + s * WG_STAGE_BYTES;

      // S = Q K^T: a k step's three products into a fresh accumulator, added
      // into the scores once they are done
      float sc[32], t[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk >= ksteps) break;
        const int half = kk >> 2, ofs = 2 * (kk & 3);   // 8 dims: 32 bytes of a row
        const uint64_t ah = smem_desc(qhi + half * WG_HALF) + ofs;
        const uint64_t al = smem_desc(qlo + half * WG_HALF) + ofs;
        const uint64_t bh_ = smem_desc(st + half * WG_HALF) + ofs;
        const uint64_t bl = smem_desc(st + WG_TILE + half * WG_HALF) + ofs;
        reg_fence(t);
        wgmma_fence();
        wgmma_ss(t, al, bh_, 0);
        wgmma_ss(t, ah, bl, 1);
        wgmma_ss(t, ah, bh_, 1);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(t);
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] += t[i];
      }

      // the online softmax of rows g (r = 0) and g + 8 (r = 1)
      if (j * WG_BN + WG_BN > T) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (j * WG_BN + (i >> 2) * 8 + 2 * t4 + (i & 1) >= T) sc[i] = -INFINITY;
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[r], mx);   // finite: a tile's first key is valid
        corr[r] = expf(m_run[r] - m_new);
        m_run[r] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = expf(sc[4 * n + 2 * r + c] - m_new);   // 0 past T
            sc[4 * n + 2 * r + c] = p;
            sum += p;
          }
        l_run[r] = l_run[r] * corr[r] + sum;
      }

      // O += P V over the tile's 8 k steps of 8 keys, into a fresh accumulator
      uint32_t p_hi[8][4], p_lo[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {   // keys 2 t4 and 2 t4 + 1 of step kk
        split_tf32(sc[4 * kk + 0], p_hi[kk][0], p_lo[kk][0]);   // row g
        split_tf32(sc[4 * kk + 2], p_hi[kk][1], p_lo[kk][1]);   // row g + 8
        split_tf32(sc[4 * kk + 1], p_hi[kk][2], p_lo[kk][2]);
        split_tf32(sc[4 * kk + 3], p_hi[kk][3], p_lo[kk][3]);
      }
      float ot[32];
      reg_fence(ot);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        reg_fence(p_hi[kk]);
        reg_fence(p_lo[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int half = kk >> 2, ofs = 2 * (kk & 3);
        const uint64_t vh = smem_desc(st + 2 * WG_TILE + half * WG_HALF) + ofs;
        const uint64_t vl = smem_desc(st + 3 * WG_TILE + half * WG_HALF) + ofs;
        wgmma_rs(ot, p_lo[kk], vh, kk > 0);
        wgmma_rs(ot, p_hi[kk], vl, 1);
        wgmma_rs(ot, p_hi[kk], vh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(ot);
      if (lane == 0) mbar_arrive(&empty_bar[s]);   // this warp is done with the stage
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[4 * n] = fmaf(o[4 * n], corr[0], ot[4 * n]);
        o[4 * n + 1] = fmaf(o[4 * n + 1], corr[0], ot[4 * n + 1]);
        o[4 * n + 2] = fmaf(o[4 * n + 2], corr[1], ot[4 * n + 2]);
        o[4 * n + 3] = fmaf(o[4 * n + 3], corr[1], ot[4 * n + 3]);
      }
    }

    float* og = out + b * os.b + h * os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.0f / l;
      const int row = row0 + warp_in_wg * 16 + 8 * r + g;
      if (row >= T) continue;
      float* orow = og + (long long)row * os.t;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = 8 * n + 2 * t4;
        const float x0 = o[4 * n + 2 * r] * inv, x1 = o[4 * n + 2 * r + 1] * inv;
        if (pairs && d + 1 < dh) {
          *reinterpret_cast<float2*>(orow + d) = make_float2(x0, x1);
        } else {
          if (d < dh) orow[d] = x0;
          if (d + 1 < dh) orow[d + 1] = x1;
        }
      }
    }
  }
  }  // consumer warpgroups
}

}  // namespace

// The wgmma f32 body (encoder_attention_f32.cu's launcher calls it at head
// dims 33-64): q, k, v, out f32 laid out as the entry point says (strides
// in elements, rows element aligned). Any B * H whose items an int counts.
int owc_encoder_attention_f32_wg(const void* q, const void* k, const void* v, void* out,
                                 int B, int H, int T, int dh, float scale,
                                 const long long* strides, cudaStream_t stream) {
  if (T < 1 || dh < 1 || dh > 64 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  cudaError_t e = cudaFuncSetAttribute(encoder_attention_f32_wg_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const long long items = (long long)((T + WG_BM - 1) / WG_BM) * B * H;
  if (items > 2147483647LL) return (int)cudaErrorInvalidValue;   // an int walks them
  const int grid = (int)(items < sms ? items : sms);
  const bool vec = owc_align_class(4LL * (dh | qs.b | qs.h | qs.t | ks.b | ks.h | ks.t | vs.b |
                                          vs.h | vs.t),
                                   q, k, v) >= 16;
  const bool pairs = ((dh | os.b | os.h | os.t) % 2 == 0) &&
                     reinterpret_cast<uintptr_t>(out) % 8 == 0;
  encoder_attention_f32_wg_kernel<<<grid, WG_THREADS, WG_SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), B * H, H, T, dh, scale, qs, ks, vs, os, vec, pairs);
  return (int)cudaGetLastError();
}
