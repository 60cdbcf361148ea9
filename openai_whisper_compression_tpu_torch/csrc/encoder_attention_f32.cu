// Non-causal encoder attention in f32 on the tensor cores, by 3xTF32: the
// f32 bodies at every head dim up to 256. This file holds the mma.sync body
// of capacities 16, 32, 128 and 256 and the launcher; capacity 64 (head
// dims 33-64, every Whisper size's) runs the wgmma body of
// encoder_attention_f32_wg.cu, which computes the same function.
//
// Replaces: openai_whisper_compression_tpu/ops/attention.py
//           encoder_attention_pallas (kernel body _attn_kernel), for f32
//           inputs.
// Computes what encoder_attention.cuh computes, in f32, for each (batch,
// head) pair and query row i < T:
//   s[i, j]   = sum_d (q[i, d] * scale) * k[j, d]                  (f32)
//   p[i, j]   = exp(s[i, j] - m[i]),  l[i] = sum_j p[i, j]
//   out[i, d] = (sum_j p[i, j] * v[j, d]) / l[i]
// with the softmax online over the key tiles. Nothing is rounded but the
// sums, which run in another order than the plain version's; the
// exponentials are expf's (ex2.approx of a rounded s log2(e) strays ~1e-6):
// the kernel is held to 1e-5 of the plain version's largest output.
//
// 3xTF32: the tensor cores multiply f32 only as TF32 (a 10-bit mantissa,
// products ~1e-3 off). Each operand x is split once into x_hi = tf32(x)
// (cvt.rna) and x_lo = tf32(x - x_hi), which together hold 21-22 of f32's
// 24 mantissa bits, and each product a b becomes a_lo b_hi + a_hi b_lo +
// a_hi b_hi, the small terms first, into the f32 accumulators (a_lo b_lo,
// ~2^-22 of the product, is dropped). Q K^T splits Q (scaled in f32) and K;
// P V splits P and V. Each k step's three products (8 dims or 8 keys) go
// into a fresh accumulator that an f32 add takes into the sum
// (`mma_group`): the tensor cores cut the low bits of their own additions,
// and that bias, carried over all k steps in one accumulator, broke the
// 1e-5 bound on the card.
//
// What bounds it on the H100: operations. One call does 4 * B*H * T^2 * Dh
// flop, three times over as TF32 products: 2.0e12 at whisper-small, batch
// 96, 4.0 ms at the card's 495 TFLOP/s TF32 peak, against 1.8 GB of q, k, v
// and out (0.53 ms). The body it replaced ran FFMA on the CUDA cores, 67
// TFLOP/s: 9.9 ms at best, 24.7 measured.
//
// Why mma.sync.m16n8k8 here: wgmma takes TF32 operands K-major only. Q K^T
// fits (q and k both have d contiguous), but V, the B operand of P V, has
// its keys (the k dimension) strided, and must be transposed into shared
// memory, split, on the way; the wgmma body does that with a producer
// warpgroup and both operands' split tiles in shared memory, which fit at
// capacity 64 only (at 128 the Q tiles alone would take 128 KB). mma.sync's
// B fragments are loaded by the threads in any layout, from V as it lies,
// and its accumulator layout feeds P V's A operand from registers with no
// shuffle (below); the split happens in registers at each fragment load,
// so the shared tiles hold f32 as it comes from device memory.
//
// Design: a template on the capacity CAP (16, 32, 128, 256; the head dim
// dh <= CAP is taken at run time, dims past dh load as zeros and add nothing).
// - A block of 4 warps takes BM query rows of one (batch, head): each warp
//   16 MT rows (MT = 2 m16 tiles at CAP <= 32, else 1), so that each K and V
//   fragment it loads and splits feeds MT products. Blocks are persistent
//   (two an SM at CAP <= 32): each walks (batch, head, query block) items,
//   query block fastest, so no grid extent grows with B*H.
// - Q (BM rows) sits in shared memory for the item; K and V tiles of 32 keys
//   stream through two stages by cp.async (16 bytes a copy where every row
//   is 16-byte aligned, else 4), rows past T and dims past dh zero-filled;
//   the next tile's copies run under this tile's products.
// - Fragments: m16n8k8 TF32 takes A (row g or g + 8, k t4 or t4 + 4), B (k t4
//   or t4 + 4, column g) and leaves C (row g or g + 8, columns 2 t4, 2 t4 +
//   1) in thread (g = lane / 4, t4 = lane % 4). The order of k within a step
//   is free as long as A and B agree, so logical k t4 / t4 + 4 is taken as
//   physical dim (or key) 2 t4 / 2 t4 + 1: Q and K fragments are float2
//   loads of neighbouring dims, and the score tile's C fragments of 8 keys
//   are, as they lie, the A fragment of P V's k step over those 8 keys. V's
//   B fragment is then keys 2 t4 and 2 t4 + 1 of column g.
// - Shared rows are padded so the fragment loads fall on 32 distinct banks:
//   Q and K rows of CAP + 8 floats (float2 loads, rows g 8 words apart), V
//   rows of CAP + 4 (scalar loads, keys 2 t4 in rows 8 banks apart).
// - The online softmax's row maximum and sum are shuffles over a row's 4
//   threads; keys past T score -inf (their V rows are zeros, so 0 * v adds
//   nothing).
// - Head dims past 256 keep the CUDA-core body (encoder_attention_cc.cu).
#include "common.cuh"
#include "hopper.cuh"  // sm_count

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BN = 32;   // keys a tile

template <int CAP>
struct F32Geo {
  static constexpr int MT = CAP <= 32 ? 2 : 1;   // m16 tiles a warp
  static constexpr int BM = 16 * MT * WARPS;     // query rows a block
  static constexpr int KS = CAP / 8;             // k steps of Q K^T, n tiles of P V
  static constexpr int NS = BN / 8;              // n tiles of Q K^T, k steps of P V
  static constexpr int GV = KS < 4 ? KS : 4;     // n tiles a group of P V's products
  static constexpr int LDQ = CAP + 8, LDK = CAP + 8, LDV = CAP + 4;
  static constexpr int Q_FLOATS = BM * LDQ;
  static constexpr int STAGE_FLOATS = BN * LDK + BN * LDV;
  static constexpr int SMEM = (Q_FLOATS + 2 * STAGE_FLOATS) * 4;
};

struct Strides {  // in elements; the head dim is contiguous
  long long b, h, t;
};

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// x as the TF32 pair (hi, lo): hi = x rounded to TF32 (nearest, ties away),
// lo = the remainder x - hi rounded to TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// d += a (16 x 8, TF32) * b (8 x 8, TF32)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mt][n0 + j] += a[mt] b[j] over the MT m tiles and GN n tiles j, in
// 3xTF32: a_lo b_hi, then a_hi b_lo, then a_hi b_hi, each issued for all
// GN * MT pairs back to back, so that no product waits on the one before it
// in its accumulator, into fresh accumulators that one f32 add (round to
// nearest) each takes into acc. The tensor cores add into an accumulator
// with the low bits cut (toward zero): over the 188 k steps of P V at T =
// 1500 that bias, carried in one accumulator, strayed 2e-5 of the largest
// output from the plain version (a k step's sum is a 188th of the whole),
// and over the 8 k steps of a score at head dim 64, 1.2e-5 on peaked
// scores (of 30 to 45).
template <int GN, int MT, int N>
__device__ __forceinline__ void mma_group(float (&acc)[MT][N][4], int n0,
                                          const uint32_t (&a_hi)[MT][4],
                                          const uint32_t (&a_lo)[MT][4],
                                          const uint32_t (&b_hi)[GN][2],
                                          const uint32_t (&b_lo)[GN][2]) {
  float t[MT][GN][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < GN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[mt][j][e] = 0.0f;
#pragma unroll
  for (int j = 0; j < GN; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_tf32(t[mt][j], a_lo[mt], b_hi[j][0], b_hi[j][1]);
#pragma unroll
  for (int j = 0; j < GN; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_tf32(t[mt][j], a_hi[mt], b_lo[j][0], b_lo[j][1]);
#pragma unroll
  for (int j = 0; j < GN; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_tf32(t[mt][j], a_hi[mt], b_hi[j][0], b_hi[j][1]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < GN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mt][n0 + j][e] += t[mt][j][e];
}

template <int CAP>
__global__ void __launch_bounds__(THREADS, CAP <= 32 ? 2 : 1)
encoder_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ out, int H,
                             int T, int dh, float scale, Strides qs, Strides ks, Strides vs,
                             Strides os, int qblocks, int items, bool vec, bool pairs) {
  using G = F32Geo<CAP>;
  constexpr int MT = G::MT, BM = G::BM, KS = G::KS, NS = G::NS, GV = G::GV;
  constexpr int LDQ = G::LDQ, LDK = G::LDK, LDV = G::LDV;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ntiles = (T + BN - 1) / BN;
  const int ksteps = (dh + 7) / 8;   // k steps (and n tiles) that hold dims below dh

  // rows r0.. (< T) and dims < dh of src (row stride st) into dst (row
  // stride ld), zeros elsewhere in the tile's ROWS x CAP
  auto load_tile = [&](float* dst, int ld, const float* src, long long st, int r0,
                       int rows) {
    const unsigned base = smem_u32(dst);
    if (vec) {   // 16 bytes a copy: dh % 4 == 0, rows 16-byte aligned
      for (int c = tid; c < rows * (CAP / 4); c += THREADS) {
        const int r = c / (CAP / 4), d = 4 * (c % (CAP / 4));
        const bool ok = r0 + r < T && d < dh;
        cp_async16(base + (r * ld + d) * 4, ok ? src + (long long)(r0 + r) * st + d : src,
                   ok ? 16 : 0);
      }
    } else {
      for (int c = tid; c < rows * CAP; c += THREADS) {
        const int r = c / CAP, d = c % CAP;
        const bool ok = r0 + r < T && d < dh;
        cp_async4(base + (r * ld + d) * 4, ok ? src + (long long)(r0 + r) * st + d : src,
                  ok ? 4 : 0);
      }
    }
  };

  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int bh = w / qblocks, b = bh / H, h = bh % H;
    const int row0 = (w % qblocks) * BM;
    const float* qg = q + b * qs.b + h * qs.h;
    const float* kg = k + b * ks.b + h * ks.h;
    const float* vg = v + b * vs.b + h * vs.h;
    auto load_kv = [&](int j) {
      float* st = smem + G::Q_FLOATS + (j & 1) * G::STAGE_FLOATS;
      load_tile(st, LDK, kg, ks.t, j * BN, BN);
      load_tile(st + BN * LDK, LDV, vg, vs.t, j * BN, BN);
    };
    load_tile(sq, LDQ, qg, qs.t, row0, BM);
    load_kv(0);
    cp_async_commit();

    float o[MT][KS][4], m_run[MT][2], l_run[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_run[mt][r] = -INFINITY;
        l_run[mt][r] = 0.0f;
      }
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.0f;
    }

    for (int j = 0; j < ntiles; ++j) {
      if (j + 1 < ntiles) {
        load_kv(j + 1);   // into the stage tile j - 1 left (all warps are past it)
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();   // tile j (and q) are in shared memory, every thread's copies
      const float* sk = smem + G::Q_FLOATS + (j & 1) * G::STAGE_FLOATS;
      const float* sv = sk + BN * LDK;

      // S = (q scale) K^T over this warp's MT m tiles and the tile's BN keys
      float s[MT][NS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk >= ksteps) break;
        uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* qr = sq + (16 * (MT * warp + mt) + g) * LDQ + 8 * kk + 2 * t4;
          const float2 x0 = *reinterpret_cast<const float2*>(qr);            // row g
          const float2 x1 = *reinterpret_cast<const float2*>(qr + 8 * LDQ);  // row g + 8
          split_tf32(x0.x * scale, a_hi[mt][0], a_lo[mt][0]);
          split_tf32(x1.x * scale, a_hi[mt][1], a_lo[mt][1]);
          split_tf32(x0.y * scale, a_hi[mt][2], a_lo[mt][2]);
          split_tf32(x1.y * scale, a_hi[mt][3], a_lo[mt][3]);
        }
        uint32_t b_hi[NS][2], b_lo[NS][2];   // the 4 n tiles of the 32 keys
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float2 y =
              *reinterpret_cast<const float2*>(sk + (8 * n + g) * LDK + 8 * kk + 2 * t4);
          split_tf32(y.x, b_hi[n][0], b_lo[n][0]);
          split_tf32(y.y, b_hi[n][1], b_lo[n][1]);
        }
        mma_group(s, 0, a_hi, a_lo, b_hi, b_lo);
      }

      // the online softmax of rows g (r = 0) and g + 8 (r = 1) of each m tile
      const bool ragged = j * BN + BN > T;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              if (ragged && j * BN + 8 * n + 2 * t4 + c >= T) s[mt][n][2 * r + c] = -INFINITY;
              mx = fmaxf(mx, s[mt][n][2 * r + c]);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run[mt][r], mx);   // finite: a tile's first key is valid
          const float corr = expf(m_run[mt][r] - m_new);
          m_run[mt][r] = m_new;
          float sum = 0.0f;
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float p = expf(s[mt][n][2 * r + c] - m_new);   // 0 past T
              s[mt][n][2 * r + c] = p;
              sum += p;
            }
          l_run[mt][r] = l_run[mt][r] * corr + sum;
#pragma unroll
          for (int n = 0; n < KS; ++n) {
            o[mt][n][2 * r] *= corr;
            o[mt][n][2 * r + 1] *= corr;
          }
        }
      }

      // O += P V: the score tile's C fragments of 8 keys are P's A fragments
      auto p_frags = [&](int kk, uint32_t (&a_hi)[MT][4], uint32_t (&a_lo)[MT][4]) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          split_tf32(s[mt][kk][0], a_hi[mt][0], a_lo[mt][0]);   // row g, key 2 t4
          split_tf32(s[mt][kk][2], a_hi[mt][1], a_lo[mt][1]);   // row g + 8
          split_tf32(s[mt][kk][1], a_hi[mt][2], a_lo[mt][2]);   // row g, key 2 t4 + 1
          split_tf32(s[mt][kk][3], a_hi[mt][3], a_lo[mt][3]);
        }
      };
      auto v_frags = [&](int kk, int n0, uint32_t (&b_hi)[GV][2], uint32_t (&b_lo)[GV][2]) {
        const float* vr = sv + (8 * kk + 2 * t4) * LDV + g;
#pragma unroll
        for (int j = 0; j < GV; ++j) {
          split_tf32(vr[8 * (n0 + j)], b_hi[j][0], b_lo[j][0]);
          split_tf32(vr[LDV + 8 * (n0 + j)], b_hi[j][1], b_lo[j][1]);
        }
      };
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        uint32_t a_hi[MT][4], a_lo[MT][4];
        p_frags(kk, a_hi, a_lo);
#pragma unroll
        for (int n0 = 0; n0 < KS; n0 += GV) {
          if (n0 >= ksteps) break;
          uint32_t b_hi[GV][2], b_lo[GV][2];
          v_frags(kk, n0, b_hi, b_lo);
          mma_group(o, n0, a_hi, a_lo, b_hi, b_lo);
        }
      }
      __syncthreads();   // every warp is done with this stage (and, last, with q)
    }

    float* og = out + b * os.b + h * os.h;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[mt][r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.0f / l;
        const int row = row0 + 16 * (MT * warp + mt) + 8 * r + g;
        if (row >= T) continue;
        float* orow = og + (long long)row * os.t + 2 * t4;
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          const int d = 8 * n + 2 * t4;
          const float x0 = o[mt][n][2 * r] * inv, x1 = o[mt][n][2 * r + 1] * inv;
          if (pairs && d + 1 < dh) {
            *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(x0, x1);
          } else {
            if (d < dh) orow[8 * n] = x0;
            if (d + 1 < dh) orow[8 * n + 1] = x1;
          }
        }
      }
  }
}

template <int CAP>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int H, int T,
               int dh, float scale, const long long* strides, cudaStream_t stream) {
  using G = F32Geo<CAP>;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  auto kernel = encoder_attention_f32_kernel<CAP>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return (int)e;
  int sms = 0, per_sm = 0;
  e = sm_count(&sms);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, G::SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long qblocks = (T + G::BM - 1) / G::BM, items = qblocks * B * H;
  if (items > 2147483647LL) return (int)cudaErrorInvalidValue;   // an int walks them
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(items < slots ? items : slots);
  // 16-byte copies where every row of q, k and v starts 16-byte aligned;
  // out written in pairs where its rows start 8-byte aligned
  const bool vec = owc_align_class(4LL * (dh | qs.b | qs.h | qs.t | ks.b | ks.h | ks.t | vs.b |
                                          vs.h | vs.t),
                                   q, k, v) >= 16;
  const bool pairs = ((dh | os.b | os.h | os.t) % 2 == 0) &&
                     reinterpret_cast<uintptr_t>(out) % 8 == 0;
  kernel<<<grid, THREADS, G::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), H, T, dh, scale, qs, ks, vs, os, (int)qblocks, (int)items, vec,
      pairs);
  return (int)cudaGetLastError();
}

}  // namespace

int owc_encoder_attention_f32_wg(const void* q, const void* k, const void* v, void* out,
                                 int B, int H, int T, int dh, float scale,
                                 const long long* strides, cudaStream_t stream);

// The f32 tensor-core encoder attention (encoder_attention.cu's entry point
// calls it for f32 at head dims up to 256): q, k, v, out f32 laid out as the
// entry point says (strides in elements, rows element aligned); cap: dh's
// capacity (16, 32, 64, 128 or 256). Any B * H whose items an int counts.
int owc_encoder_attention_f32(const void* q, const void* k, const void* v, void* out, int B,
                              int H, int T, int dh, int cap, float scale,
                              const long long* strides, cudaStream_t st) {
  if (T < 1 || dh < 1 || dh > cap || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  switch (cap) {
    case 16: return launch_f32<16>(q, k, v, out, B, H, T, dh, scale, strides, st);
    case 32: return launch_f32<32>(q, k, v, out, B, H, T, dh, scale, strides, st);
    case 64:   // the wgmma body (encoder_attention_f32_wg.cu)
      return owc_encoder_attention_f32_wg(q, k, v, out, B, H, T, dh, scale, strides, st);
    case 128: return launch_f32<128>(q, k, v, out, B, H, T, dh, scale, strides, st);
    case 256: return launch_f32<256>(q, k, v, out, B, H, T, dh, scale, strides, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
