// Non-causal encoder attention in f32 past head dim 256 on the tensor cores,
// by 3xTF32: the f32 WIDE body.
//
// Replaces: openai_whisper_compression_tpu/ops/attention.py
//           encoder_attention_pallas (kernel body _attn_kernel), for f32
//           inputs of a head dim past 256.
// Computes what encoder_attention.cuh computes, in f32, for each (batch,
// head) pair and query row i < T:
//   s[i, j]   = sum_d (q[i, d] * scale) * k[j, d]
//   p[i, j]   = exp(s[i, j] - m[i]),  l[i] = sum_j p[i, j]
//   out[i, d] = (sum_j p[i, j] * v[j, d]) / l[i]
// with the softmax online over 128-key tiles. Nothing is rounded but the
// sums, which run in another order than the plain version's, and the
// exponentials are expf's (ex2.approx of a rounded s log2(e) strays ~1e-6):
// the kernel is held to 1e-5 of the plain version's largest output.
//
// 3xTF32 as in encoder_attention_f32.cu: each operand x is split in
// registers, as its fragment is loaded, into x_hi = tf32(x) (cvt.rna) and
// x_lo = x - x_hi, whose low 13 bits the tensor cores do not read (a TF32
// truncation of the remainder, as CUTLASS's fast 3xTF32 takes it); each
// product a b is a_lo b_hi + a_hi b_lo + a_hi b_hi, and each k step's three
// products (8 dims of Q K^T, 8 keys of P V) go into a fresh accumulator (the
// first product writes it) that one f32 add takes into the sum
// (`mma_group`): the tensor cores cut the low bits of their own additions,
// which over all k steps in one accumulator broke the 1e-5 bound on the
// card. The shared tiles hold f32 as it comes from device memory. The scale
// multiplies the f32 scores, not q (one rounding more or less than the
// plain version's (q scale) K^T, far inside the bound).
//
// What bounds it on the H100: operations. One call does 4 * B*H * T^2 * Dh
// flop, three times over as TF32 products: 1.66e11 at (8, 2, 1500, 384),
// 0.34 ms at the card's 495 TFLOP/s TF32 peak, against 74 MB of q, k, v
// and out (0.02 ms). The CUDA-core body it replaced ran FFMA (67 TFLOP/s at
// best) and made a tile's scores once for each 128 output dims. The card
// runs mma.sync m16n8k8 TF32 at about 310 TFLOP/s (tools/mma_sync_rate.cu),
// so 3xTF32 on it could take 0.54 ms here; what a step waits on is the
// issue and the latency of the splits, adds, loads and dependent products
// of 8 warps an SM (16 warps of half the rows each ran slower), so the
// design spends few instructions a product: each split feeds 4 products or
// more, no accumulator is zeroed, no copy address is divided.
//
// Why a design of its own: the head dim is unbounded here, so neither q nor
// the output of a block's query rows fits in registers as in the bodies up
// to 256 (encoder_attention_f32.cu keeps a warp's 16 rows x all dims).
// - A block of 8 warps takes 64 query rows of one (batch, head) at a time;
//   blocks are persistent (one an SM) and walk (batch, head, output pass,
//   query block) items, query block fastest, so no grid extent grows with
//   B*H.
// - Scores once: a tile of 128 keys has its 64 x 128 scores made once, each
//   warp 32 rows (2 m16 tiles) x 32 keys (mma.sync m16n8k8), over the head
//   dim in chunks of 32 dims: a Q chunk and the K chunk beside it in one
//   stage of the ring (so no shared memory grows with the head dim).
// - The softmax of a row spans the 4 warps that hold its keys: each takes
//   its keys' row maxima (shuffles over a row's 4 threads), they meet in
//   shared memory behind a block barrier, and each goes on from the same
//   maximum; the probabilities go to one 64 x 128 P tile in shared memory.
// - The output dims are shared out: a pass holds up to 384 output dims,
//   each warp 32 rows x a quarter of them (up to 12 n8 tiles, 96 sums a
//   thread), O += P V with P's fragments from the P tile and V's from
//   stages of 16 keys x the pass's dims. A head dim past 384 takes more
//   passes, each of which makes the scores again: once for each 384 dims.
// - Loads: a ring of 5 stages of 30 KB, filled by cp.async (16 bytes a copy
//   where every row is 16-byte aligned, else 4), the next 4 stages' copies
//   in flight under this one's products; rows past T and dims past dh are
//   zero filled. One block barrier a stage.
// - The ragged last tile (1500 = 11 x 128 + 92) is masked to -inf before
//   the row maximum; each warp sums l over its keys, and the 4 partial sums
//   of a row meet in shared memory at the item's end, in a fixed order.
// Any view whose head dim is contiguous is read in place.
#include "common.cuh"
#include "hopper.cuh"  // cp.async, sm_count

namespace {

constexpr int FW_WARPS = 8;
constexpr int FW_THREADS = 32 * FW_WARPS;
constexpr int FW_BM = 64;                  // query rows an item
constexpr int FW_BN = 128;                 // keys a tile
constexpr int FW_DC = 32;                  // dims of a Q or K chunk
constexpr int FW_VK = 16;                  // keys of a V stage
constexpr int FW_PASS = 384;               // output dims a pass
constexpr int FW_NT = FW_PASS / 8 / 4;     // n8 tiles of P V a warp holds
constexpr int FW_GV = 4;                   // n8 tiles of P V a group of products
constexpr int FW_LDQ = FW_DC + 8;          // floats a row of a Q or K chunk
constexpr int FW_LDV = FW_PASS + 4;        // floats a row of a V stage
constexpr int FW_LDP = FW_BN + 8;          // floats a row of the P tile
constexpr int FW_QK = (FW_BM + FW_BN) * FW_LDQ;
constexpr int FW_VS = FW_VK * FW_LDV;
constexpr int FW_SLOT = FW_QK > FW_VS ? FW_QK : FW_VS;   // floats a stage
constexpr int FW_NS = 5;                   // stages of the ring
constexpr int FW_SMEM = (FW_NS * FW_SLOT + FW_BM * FW_LDP + 8 * FW_BM) * 4;
static_assert(FW_SMEM <= 232448, "a block's shared memory");

struct Strides {  // in elements; the head dim is contiguous
  long long b, h, t;
};

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// x as the TF32 pair (hi, lo): hi = x rounded to TF32 (nearest, ties away),
// lo = the remainder x - hi, exact in f32, of which the tensor cores read
// the TF32 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d = a (16 x 8, TF32) * b (8 x 8, TF32) (+ d where `ACC`)
template <bool ACC>
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (ACC) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
  }
}

// acc[mt][n0 + j] += a[mt] b[j] over the 2 m tiles and GN n tiles j, in
// 3xTF32: a_lo b_hi into a fresh accumulator, then a_hi b_lo and a_hi b_hi,
// each issued for the 2 GN pairs back to back (independent products between
// the dependent ones); one f32 add each takes the fresh accumulators into
// acc.
template <int GN, int N>
__device__ __forceinline__ void mma_group(float (&acc)[2][N][4], int n0,
                                          const uint32_t (&a_hi)[2][4],
                                          const uint32_t (&a_lo)[2][4],
                                          const uint32_t (&b_hi)[GN][2],
                                          const uint32_t (&b_lo)[GN][2]) {
  float t[2][GN][4];
#pragma unroll
  for (int j = 0; j < GN; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_tf32<false>(t[mt][j], a_lo[mt], b_hi[j][0], b_hi[j][1]);
#pragma unroll
  for (int j = 0; j < GN; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_tf32<true>(t[mt][j], a_hi[mt], b_lo[j][0], b_lo[j][1]);
#pragma unroll
  for (int j = 0; j < GN; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_tf32<true>(t[mt][j], a_hi[mt], b_hi[j][0], b_hi[j][1]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < GN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n0 + j][e] += t[mt][j][e];
}

__global__ void __launch_bounds__(FW_THREADS, 1)
encoder_attention_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, float* __restrict__ out, int H,
                                  int T, int dh, float scale, Strides qs, Strides ks,
                                  Strides vs, Strides os, int qblocks, int npasses, int items,
                                  bool vec, bool pairs) {
  extern __shared__ __align__(16) float smem[];
  float* sp = smem + FW_NS * FW_SLOT;    // [FW_BM][FW_LDP]: P
  float* smax = sp + FW_BM * FW_LDP;     // [4][FW_BM]: row maxima of each key quarter
  float* sl = smax + 4 * FW_BM;          // [4][FW_BM]: row sums of each key quarter
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mg = warp & 1, kq = warp >> 1;   // rows 32 mg.., keys (and dims) quarter kq
  constexpr int SN = FW_BN / 4 / 8;          // n8 tiles of scores a warp holds
  const int nchunks = (dh + FW_DC - 1) / FW_DC;
  const int ntiles = (T + FW_BN - 1) / FW_BN;
  const int per = nchunks + FW_BN / FW_VK;     // stages of a whole key tile
  const int last_keys = T - (ntiles - 1) * FW_BN;
  const int steps = (ntiles - 1) * per + nchunks + (last_keys + FW_VK - 1) / FW_VK;

  // rows r0.. (< T, ROWS of them) and dims d0.. (< dh, `cols` of them, a
  // multiple of 4) of src into dst (row stride ld floats), zeros past T and
  // dh: TPR threads a row, thread t copying pieces t % TPR + TPR j of rows
  // t / TPR + (256 / TPR) i (no division on the way)
  auto load_rows = [&](auto rows_tag, auto tpr_tag, float* dst, int ld, const float* src,
                       long long st, int r0, int d0, int cols) {
    constexpr int ROWS = decltype(rows_tag)::value, TPR = decltype(tpr_tag)::value;
    constexpr int RP = FW_THREADS / TPR;   // rows a pass of the block
    const unsigned base = smem_u32(dst);
    const int rt = tid / TPR, ct = tid % TPR;
#pragma unroll
    for (int i = 0; i < (ROWS + RP - 1) / RP; ++i) {
      const int r = rt + RP * i;
      if (ROWS % RP != 0 && r >= ROWS) break;
      const bool row_ok = r0 + r < T;
      const float* srow = src + (long long)(r0 + r) * st + d0;
      if (vec) {   // 16 bytes a copy: dh % 4 == 0, rows 16-byte aligned
        for (int d = 4 * ct; d < cols; d += 4 * TPR) {
          const bool ok = row_ok && d0 + d < dh;
          cp_async16(base + (r * ld + d) * 4, ok ? srow + d : src, ok ? 16 : 0);
        }
      } else {
        for (int d = ct; d < cols; d += TPR) {
          const bool ok = row_ok && d0 + d < dh;
          cp_async4(base + (r * ld + d) * 4, ok ? srow + d : src, ok ? 4 : 0);
        }
      }
    }
  };
  using QRows = std::integral_constant<int, FW_BM>;
  using KRows = std::integral_constant<int, FW_BN>;
  using VRows = std::integral_constant<int, FW_VK>;
  using ChunkTpr = std::integral_constant<int, FW_DC / 4>;   // a Q or K chunk row: 8 pieces
  using VTpr = std::integral_constant<int, 16>;

  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int qb = w % qblocks, pass = (w / qblocks) % npasses, bh = w / (qblocks * npasses);
    const int b = bh / H, h = bh % H;
    const int row0 = qb * FW_BM, d0 = pass * FW_PASS;
    const int pd = min(FW_PASS, dh - d0);              // the pass's dims
    const int pnt = (pd + 7) / 8;                       // ... its n8 tiles
    const int npw = (pnt + 3) / 4;                      // n8 tiles a warp
    const int nvw = max(0, min(npw, pnt - kq * npw));   // ... this warp's
    const float* qg = q + b * qs.b + h * qs.h;
    const float* kg = k + b * ks.b + h * ks.h;
    const float* vg = v + b * vs.b + h * vs.h;

    // the steps in order: key tile jt, stage sub of it: a Q and K chunk of
    // 32 dims (sub < nchunks), else a V stage of 16 keys x the pass's dims;
    // the producer's step (pi, its tile, stage and ring slot) runs NS - 1
    // ahead of the consumer's
    int pi = 0, pjt = 0, psub = 0, pslot = 0;
    auto issue = [&]() {
      if (pi < steps) {
        float* st = smem + pslot * FW_SLOT;
        if (psub < nchunks) {
          load_rows(QRows(), ChunkTpr(), st, FW_LDQ, qg, qs.t, row0, psub * FW_DC, FW_DC);
          load_rows(KRows(), ChunkTpr(), st + FW_BM * FW_LDQ, FW_LDQ, kg, ks.t, pjt * FW_BN,
                    psub * FW_DC, FW_DC);
        } else {
          load_rows(VRows(), VTpr(), st, FW_LDV, vg, vs.t, pjt * FW_BN + (psub - nchunks) * FW_VK,
                    d0, (pd + 3) & ~3);
        }
      }
      cp_async_commit();
      ++pi;
      pslot = pslot == FW_NS - 1 ? 0 : pslot + 1;
      if (++psub == per) {
        psub = 0;
        ++pjt;
      }
    };

    float o[2][FW_NT][4], s[2][SN][4], m_run[2][2], l_run[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_run[mt][r] = -INFINITY;
        l_run[mt][r] = 0.0f;
      }
#pragma unroll
      for (int n = 0; n < FW_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.0f;
    }

#pragma unroll
    for (int i = 0; i < FW_NS - 1; ++i) issue();
    int jt = 0, sub = 0, slot = 0;
    for (int i = 0; i < steps; ++i) {
      cp_async_wait<FW_NS - 2>();   // stage i has landed, for this thread's copies
      __syncthreads();              // ... and for every thread's; stage i - 1 is free
      issue();
      const float* st = smem + slot * FW_SLOT;
      const int key0 = jt * FW_BN;
      if (sub < nchunks) {
        // S (+)= Q K^T over this chunk's dims: rows 32 mg.., keys 32 kq..
        if (sub == 0) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int n = 0; n < SN; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.0f;
        }
        const float* sk = st + FW_BM * FW_LDQ;
#pragma unroll
        for (int kk = 0; kk < FW_DC / 8; ++kk) {
          if (sub * FW_DC + 8 * kk >= dh) break;
          uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const float* qr = st + (32 * mg + 16 * mt + g) * FW_LDQ + 8 * kk + 2 * t4;
            const float2 x0 = *reinterpret_cast<const float2*>(qr);              // row g
            const float2 x1 = *reinterpret_cast<const float2*>(qr + 8 * FW_LDQ);  // row g + 8
            split_tf32(x0.x, a_hi[mt][0], a_lo[mt][0]);
            split_tf32(x1.x, a_hi[mt][1], a_lo[mt][1]);
            split_tf32(x0.y, a_hi[mt][2], a_lo[mt][2]);
            split_tf32(x1.y, a_hi[mt][3], a_lo[mt][3]);
          }
#pragma unroll
          for (int n0 = 0; n0 < SN; n0 += 2) {
            uint32_t b_hi[2][2], b_lo[2][2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float2 y = *reinterpret_cast<const float2*>(
                  sk + (32 * kq + 8 * (n0 + j) + g) * FW_LDQ + 8 * kk + 2 * t4);
              split_tf32(y.x, b_hi[j][0], b_lo[j][0]);
              split_tf32(y.y, b_hi[j][1], b_lo[j][1]);
            }
            mma_group<2>(s, n0, a_hi, a_lo, b_hi, b_lo);
          }
        }
        if (sub == nchunks - 1) {
          // the online softmax of rows g (r = 0) and g + 8 (r = 1) of each m
          // tile: the scaled scores of this warp's 32 keys, then the 4
          // quarters' maxima
          const bool ragged = key0 + FW_BN > T;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float mx = -INFINITY;
#pragma unroll
              for (int n = 0; n < SN; ++n)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  float& x = s[mt][n][2 * r + c];
                  x = ragged && key0 + 32 * kq + 8 * n + 2 * t4 + c >= T ? -INFINITY : x * scale;
                  mx = fmaxf(mx, x);
                }
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
              if (t4 == 0) smax[kq * FW_BM + 32 * mg + 16 * mt + 8 * r + g] = mx;
            }
          __syncthreads();
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = 32 * mg + 16 * mt + 8 * r + g;
              const float mx = fmaxf(fmaxf(smax[row], smax[FW_BM + row]),
                                     fmaxf(smax[2 * FW_BM + row], smax[3 * FW_BM + row]));
              const float m_new = fmaxf(m_run[mt][r], mx);   // finite: a tile's first key is valid
              const float corr = expf(m_run[mt][r] - m_new);
              m_run[mt][r] = m_new;
              float sum = 0.0f;
#pragma unroll
              for (int n = 0; n < SN; ++n) {
                const float p0 = expf(s[mt][n][2 * r] - m_new);   // 0 past T
                const float p1 = expf(s[mt][n][2 * r + 1] - m_new);
                sum += p0 + p1;
                *reinterpret_cast<float2*>(sp + row * FW_LDP + 32 * kq + 8 * n + 2 * t4) =
                    make_float2(p0, p1);
              }
              l_run[mt][r] = l_run[mt][r] * corr + sum;
#pragma unroll
              for (int n = 0; n < FW_NT; ++n) {
                o[mt][n][2 * r] *= corr;
                o[mt][n][2 * r + 1] *= corr;
              }
            }
        }
      } else {
        // O += P V over this stage's 16 keys: rows 32 mg.., this warp's n tiles
        const int kv0 = (sub - nchunks) * FW_VK;   // the stage's first key in the tile
#pragma unroll
        for (int ks = 0; ks < FW_VK / 8; ++ks) {
          if (key0 + kv0 + 8 * ks >= T) break;
          uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const float* pr = sp + (32 * mg + 16 * mt + g) * FW_LDP + kv0 + 8 * ks + 2 * t4;
            const float2 x0 = *reinterpret_cast<const float2*>(pr);
            const float2 x1 = *reinterpret_cast<const float2*>(pr + 8 * FW_LDP);
            split_tf32(x0.x, a_hi[mt][0], a_lo[mt][0]);   // row g, key 2 t4
            split_tf32(x1.x, a_hi[mt][1], a_lo[mt][1]);   // row g + 8
            split_tf32(x0.y, a_hi[mt][2], a_lo[mt][2]);   // row g, key 2 t4 + 1
            split_tf32(x1.y, a_hi[mt][3], a_lo[mt][3]);
          }
          const float* vr = st + (8 * ks + 2 * t4) * FW_LDV + 8 * kq * npw + g;
#pragma unroll
          for (int n0 = 0; n0 < FW_NT; n0 += FW_GV) {
            if (n0 >= nvw) break;
            uint32_t b_hi[FW_GV][2], b_lo[FW_GV][2];
#pragma unroll
            for (int j = 0; j < FW_GV; ++j) {
              const bool on = n0 + j < nvw;   // else dims of another warp, or past the pass
              split_tf32(on ? vr[8 * (n0 + j)] : 0.0f, b_hi[j][0], b_lo[j][0]);
              split_tf32(on ? vr[FW_LDV + 8 * (n0 + j)] : 0.0f, b_hi[j][1], b_lo[j][1]);
            }
            mma_group<FW_GV>(o, n0, a_hi, a_lo, b_hi, b_lo);
          }
        }
      }
      slot = slot == FW_NS - 1 ? 0 : slot + 1;
      if (++sub == per) {
        sub = 0;
        ++jt;
      }
    }

    // l over the 4 threads of a row, then over the 4 key quarters, in order
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[mt][r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        if (t4 == 0) sl[kq * FW_BM + 32 * mg + 16 * mt + 8 * r + g] = l;
      }
    __syncthreads();
    float* og = out + b * os.b + h * os.h;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rl = 32 * mg + 16 * mt + 8 * r + g, row = row0 + rl;
        if (row >= T) continue;
        const float inv =
            1.0f / ((sl[rl] + sl[FW_BM + rl]) + (sl[2 * FW_BM + rl] + sl[3 * FW_BM + rl]));
        float* orow = og + (long long)row * os.t + d0;
#pragma unroll
        for (int n = 0; n < FW_NT; ++n) {
          if (n >= nvw) break;
          const int d = 8 * (kq * npw + n) + 2 * t4;
          const float x0 = o[mt][n][2 * r] * inv, x1 = o[mt][n][2 * r + 1] * inv;
          if (pairs && d + 1 < pd) {
            *reinterpret_cast<float2*>(orow + d) = make_float2(x0, x1);
          } else {
            if (d < pd) orow[d] = x0;
            if (d + 1 < pd) orow[d + 1] = x1;
          }
        }
      }
    __syncthreads();   // sl is read before the next item writes it
  }
}

}  // namespace

// The f32 WIDE encoder attention (encoder_attention.cu's entry point calls
// it for f32 past head dim 256): q, k, v, out f32 laid out as the entry
// point says (strides in elements, rows element aligned). Any B * H whose
// items an int counts.
int owc_encoder_attention_f32_wide(const void* q, const void* k, const void* v, void* out,
                                   int B, int H, int T, int dh, float scale,
                                   const long long* strides, cudaStream_t stream) {
  if (T < 1 || dh < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  auto kernel = encoder_attention_f32_wide_kernel;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FW_SMEM);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const long long qblocks = (T + FW_BM - 1) / FW_BM, npasses = (dh + FW_PASS - 1) / FW_PASS;
  const long long items = qblocks * npasses * B * H;
  if (items > 2147483647LL) return (int)cudaErrorInvalidValue;   // an int walks them
  const int grid = (int)(items < sms ? items : sms);
  // 16-byte copies where every row of q, k and v starts 16-byte aligned;
  // out written in pairs where its rows start 8-byte aligned
  const bool vec = owc_align_class(4LL * (dh | qs.b | qs.h | qs.t | ks.b | ks.h | ks.t | vs.b |
                                          vs.h | vs.t),
                                   q, k, v) >= 16;
  const bool pairs = ((dh | os.b | os.h | os.t) % 2 == 0) &&
                     reinterpret_cast<uintptr_t>(out) % 8 == 0;
  kernel<<<grid, FW_THREADS, FW_SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), H, T, dh, scale, qs, ks, vs, os, (int)qblocks, (int)npasses,
      (int)items, vec, pairs);
  return (int)cudaGetLastError();
}
