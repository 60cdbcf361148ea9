// Non-causal encoder attention in bf16 and f16 past head dim 256 on the
// tensor cores: the WIDE body of the 16-bit types.
//
// Replaces: openai_whisper_compression_tpu/ops/attention.py
//           encoder_attention_pallas (kernel body _attn_kernel), for 16-bit
//           inputs of a head dim past 256.
// Computes what encoder_attention.cuh computes (its contract, in E = bf16
// or f16): q scaled in E, the scores and the online softmax in f32, the
// unnormalised probabilities rounded to E (v's type) before the value
// product, its f32 sum divided by the f32 row sum l, the output in E; keys
// past T take no weight, rows past T are not written.
//
// What bounds it on the H100: operations. One call does 4 * B*H * T^2 * dh
// flop on the tensor cores (5.5e10 at (8, 2, 1500, 384): 0.056 ms at the
// 16-bit peak) against 37 MB of q, k, v and out (0.011 ms), and B*H * T^2
// exponentials. The CUDA-core body it replaced made each row's scores once
// for each 128 output dims, on FFMA: 94x that bound.
//
// Why a design of its own: the head dim is unbounded here (any dh past 256),
// so neither q nor the output of a 64-row tile fits in one warpgroup's
// registers as in the bodies up to 256 (an accumulator of 64 rows x 384
// dims would take 192 registers a thread).
// - A block is three warpgroups: two consumers and a producer, and takes
//   64 query rows of one (batch, head) at a time; blocks are persistent (one
//   an SM) and walk (batch, head, output pass, query block) items, query
//   block fastest, so no grid extent grows with B*H.
// - Scores once: each tile of 64 keys has its 64 x 64 scores made once, each
//   consumer the 32 keys of its half (m64n32k16), over the head dim in
//   chunks of 64 dims: Q and K both from shared memory (a Q chunk and the
//   K chunk beside it in one stage of the ring), dh / 64 chunks, k steps
//   of 16 dims. The consumers scale each Q chunk in E in place as it lands
//   (each its 32 rows, then a named barrier), before its products.
// - The softmax of a tile spans the two consumers: each takes its half's
//   row maxima (shuffles over a row's 4 threads), they swap them through
//   shared memory behind a named barrier of the 256 consumer threads, and
//   each goes on from the same maximum. The probabilities, rounded to E, go
//   to one 64 x 64 P tile in shared memory (the 128-byte swizzle that wgmma
//   reads), and after a second barrier both read all of it.
// - The output dims are shared out: a pass holds up to 512 output dims, V
//   slots of 128 dims each (two 64-dim halves, one a consumer): O += P V
//   with P from shared memory (K-major) and V read in place from its [key][d]
//   half through the transposed (MN-major) descriptor, m64n64k16, into up to
//   four 32-register accumulators a consumer. A head dim past 512 takes more
//   passes, each of which makes the scores again: once for each 512 dims,
//   not once for each 128.
// - Loads: the producer's first thread keeps a ring of 8 stages of 16 KB
//   filled by TMA (a Q chunk and a K chunk, or a V slot's halves), in the
//   128-byte swizzle; tensor maps over the (B, H, T, dh) views as the bodies
//   up to 256 build them, with inner extent dh, so the dims past dh and the
//   rows past T arrive as zeros. A V half wholly past dh is neither loaded
//   nor multiplied. Every consumer warp arrives on a stage's `empty`
//   barrier once its products on the stage are done.
// - The ragged last tile (1500 = 23 x 64 + 28) is masked to -inf before the
//   row maximum; l sums the unrounded probabilities, each consumer its half,
//   added through shared memory at the item's end.
// - Registers: the producer warpgroup gives its registers away (setmaxnreg
//   40) and each consumer takes 232, as the bodies up to 256 do.
#include "encoder_attention.cuh"

namespace {

constexpr int W_ROWS = 64;                 // query rows an item
constexpr int W_KEYS = 64;                 // keys a tile
constexpr int W_CHUNK = 64;                // dims a Q or K chunk, a V half
constexpr int W_SLOT_BYTES = 16384;        // a stage: two 64 x 64 boxes of E
constexpr int W_HALF_BYTES = W_SLOT_BYTES / 2;
constexpr int W_SLOTS = 8;
constexpr int W_VSLOTS = 4;                // V slots a pass
constexpr int W_PASS = W_VSLOTS * 2 * W_CHUNK;   // output dims a pass: 512
constexpr int W_CONSUMERS = 256;
constexpr int W_THREADS = W_CONSUMERS + 128;
constexpr int W_SMEM = W_SLOTS * W_SLOT_BYTES + W_ROWS * W_KEYS * 2 + 1024;

// d (64 x 32 f32) = or += A (64 x 16, a K-major shared tile) * B (16 x 32,
// a K-major [n][k] shared tile)
#define OWC_WIDE_WGMMA_QK(TYPE, TAG) \
__device__ __forceinline__ void wgmma_ss_qk32(float (&d)[16], uint64_t a, uint64_t b,      \
                                              int accumulate, TAG) {                       \
  asm volatile(                                                                            \
      "{\n"                                                                                \
      ".reg .pred p;\n"                                                                    \
      "setp.ne.b32 p, %18, 0;\n"                                                           \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TYPE "." TYPE " "                      \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "           \
      "%16, %17, p, 1, 1, 0, 0;\n"                                                         \
      "}\n"                                                                                \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),            \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),          \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                                 \
      : "l"(a), "l"(b), "r"(accumulate));                                                  \
}
OWC_WIDE_WGMMA_QK("bf16", BF)
OWC_WIDE_WGMMA_QK("f16", __half)
#undef OWC_WIDE_WGMMA_QK

// d (64 x 64 f32) += A (64 x 16, a K-major shared tile) * B (16 x 64, an
// MN-major [k][n] shared tile)
#define OWC_WIDE_WGMMA_PV(TYPE, TAG) \
__device__ __forceinline__ void wgmma_ss_pv(float (&d)[32], uint64_t a, uint64_t b, TAG) {  \
  asm volatile(                                                                            \
      "{\n"                                                                                \
      ".reg .pred p;\n"                                                                    \
      "setp.ne.b32 p, %34, 0;\n"                                                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "                      \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "        \
      "%31}, %32, %33, p, 1, 1, 0, 1;\n"                                                   \
      "}\n"                                                                                \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),            \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),          \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),                   \
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),                   \
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),                   \
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                    \
      : "l"(a), "l"(b), "r"(1));                                                           \
}
OWC_WIDE_WGMMA_PV("bf16", BF)
OWC_WIDE_WGMMA_PV("f16", __half)
#undef OWC_WIDE_WGMMA_PV

// the 256 consumer threads meet (named barrier 1; the producer never waits)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(W_CONSUMERS) : "memory");
}

template <typename E>
__global__ void __launch_bounds__(W_THREADS, 1)
encoder_attention_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              E* __restrict__ out, int BH, int H, int T, int dh,
                              float scale, Strides os, CoordOrder qo, CoordOrder ko, CoordOrder vo,
                              bool pairs) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[W_SLOTS];
  __shared__ __align__(8) uint64_t empty_bar[W_SLOTS];
  __shared__ float red_max[2][W_ROWS];   // each consumer's row maxima of a tile
  __shared__ float red_sum[2][W_ROWS];   // each consumer's row sums of an item
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ptile = ring + W_SLOTS * W_SLOT_BYTES;   // [64 rows][64 keys] of E
  const int tid = threadIdx.x;
  const int ntiles = (T + W_KEYS - 1) / W_KEYS;
  const int qblocks = (T + W_ROWS - 1) / W_ROWS;
  const int nchunks = (dh + W_CHUNK - 1) / W_CHUNK;
  const int npasses = (dh + W_PASS - 1) / W_PASS;
  const int items = qblocks * npasses * BH;
  // V slots of pass p: the 128-dim slots that start below dh
  auto vslots = [&](int p) {
    const int left = dh - p * W_PASS;
    return left >= W_PASS ? W_VSLOTS : (left + 2 * W_CHUNK - 1) / (2 * W_CHUNK);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < W_SLOTS; ++s) {
      mbar_init(&full_bar[s], 1);    // the producer's expect_tx arrival
      mbar_init(&empty_bar[s], 8);   // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= W_CONSUMERS) {
    // ---- producer warpgroup: its first thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == W_CONSUMERS) {
      int it = 0;   // stages filled so far
      auto next = [&](int bytes) {
        const int s = it % W_SLOTS;
        mbar_wait(&empty_bar[s], ((it / W_SLOTS) & 1) ^ 1);   // passes on a fresh barrier
        mbar_expect_tx(&full_bar[s], bytes);
        ++it;
        return s;
      };
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const int bh = w / (qblocks * npasses), b = bh / H, h = bh % H;
        const int p = (w / qblocks) % npasses, row0 = (w % qblocks) * W_ROWS;
        const int nv = vslots(p);
        for (int j = 0; j < ntiles; ++j) {
          for (int c = 0; c < nchunks; ++c) {
            const int s = next(W_SLOT_BYTES);
            unsigned char* st = ring + s * W_SLOT_BYTES;
            load_kv_tile(st, &q_map, &full_bar[s], qo, row0, h, b, c * W_CHUNK);
            load_kv_tile(st + W_HALF_BYTES, &k_map, &full_bar[s], ko, j * W_KEYS, h, b,
                         c * W_CHUNK);
          }
          for (int i = 0; i < nv; ++i) {
            const int d0 = p * W_PASS + i * 2 * W_CHUNK;
            const bool second = d0 + W_CHUNK < dh;   // a half wholly past dh stays out
            const int s = next(second ? W_SLOT_BYTES : W_HALF_BYTES);
            unsigned char* st = ring + s * W_SLOT_BYTES;
            load_kv_tile(st, &v_map, &full_bar[s], vo, j * W_KEYS, h, b, d0);
            if (second)
              load_kv_tile(st + W_HALF_BYTES, &v_map, &full_bar[s], vo, j * W_KEYS, h, b,
                           d0 + W_CHUNK);
          }
        }
      }
    }
  } else {
  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid >> 7, lane = tid & 31, warp_in_wg = (tid >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_in_item = warp_in_wg * 16 + g;   // and + 8
  int it = 0;   // stages consumed so far

  float o_acc[W_VSLOTS][32];   // this consumer's half of each V slot
  float s_acc[16];             // scores of this consumer's 32 keys of a tile
  float m_run[2], l_run[2];    // rows g and g + 8; l is this thread's share

  auto wait_full = [&]() {
    const int s = it % W_SLOTS;
    mbar_wait(&full_bar[s], (it / W_SLOTS) & 1);
    return s;
  };
  auto release = [&](int s) {   // this warp is done with stage s
    if (lane == 0) mbar_arrive(&empty_bar[s]);
  };

  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int bh = w / (qblocks * npasses);
    const int p = (w / qblocks) % npasses, row0 = (w % qblocks) * W_ROWS;
    const int nv = vslots(p);
#pragma unroll
    for (int i = 0; i < W_VSLOTS; ++i)
#pragma unroll
      for (int e = 0; e < 32; ++e) o_acc[i][e] = 0.0f;
    m_run[0] = m_run[1] = -INFINITY;
    l_run[0] = l_run[1] = 0.0f;

    for (int j = 0; j < ntiles; ++j) {
      // S = Q K^T over the head dim's chunks: this consumer's 32 keys
      int prev = -1;
      reg_fence(s_acc);
      for (int c = 0; c < nchunks; ++c) {
        const int s = wait_full();
        ++it;
        unsigned char* st = ring + s * W_SLOT_BYTES;
        // q * scale rounded to E, in place: this consumer's 32 rows of the Q
        // chunk (its first 4 KB, whatever the swizzle), 16 bytes twice a thread
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          uint4* piece = reinterpret_cast<uint4*>(st) + wg * 256 + x * 128 + (tid & 127);
          uint4 u = *piece;
          uint32_t* e2 = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            const float2 f =
                Elem<E>::wide(*reinterpret_cast<const typename Elem<E>::E2*>(&e2[y]));
            e2[y] = pack2<E>(f.x * scale, f.y * scale);
          }
          *piece = u;
        }
        fence_proxy_async();   // the scaled chunk, for wgmma's eyes
        consumers_sync();      // ... both halves of it
        const uint64_t qd = smem_desc(st);
        const uint64_t kd = smem_desc(st + W_HALF_BYTES + wg * 32 * 128);   // rows 32 wg..
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < W_CHUNK / 16; ++kk)   // 16 dims are 32 bytes of a row
          wgmma_ss_qk32(s_acc, qd + 2 * kk, kd + 2 * kk, c > 0 || kk > 0, E());
        wgmma_commit();
        wgmma_wait<1>();   // the previous chunk's products are done
        if (prev >= 0) release(prev);
        prev = s;
      }
      wgmma_wait<0>();
      reg_fence(s_acc);
      release(prev);

      // the tile's row maxima over both consumers' keys
      if (j * W_KEYS + W_KEYS > T) {   // the ragged last tile: keys past T take no weight
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (j * W_KEYS + wg * 32 + (i >> 2) * 8 + 2 * t4 + (i & 1) >= T) s_acc[i] = -INFINITY;
      }
      float mx[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = -INFINITY;
#pragma unroll
        for (int n = 0; n < 4; ++n) m = fmaxf(m, fmaxf(s_acc[4 * n + 2 * r], s_acc[4 * n + 2 * r + 1]));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        mx[r] = m;
        if (t4 == 0) red_max[wg][row_in_item + 8 * r] = m;
      }
      consumers_sync();   // both halves' maxima are there (and both P V of tile j - 1 done)
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_tile = fmaxf(mx[r], red_max[wg ^ 1][row_in_item + 8 * r]);
        const float m_new = fmaxf(m_run[r], m_tile);   // finite: key j * 64 is valid
        corr[r] = ex2((m_run[r] - m_new) * LOG2E);
        m_run[r] = m_new;
        const float ms = m_new * LOG2E;
        float sum = 0.0f;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float p0 = ex2(fmaf(s_acc[4 * n + 2 * r], LOG2E, -ms));
          const float p1 = ex2(fmaf(s_acc[4 * n + 2 * r + 1], LOG2E, -ms));
          sum += p0 + p1;
          // keys 32 wg + 8 n + 2 t4 (+1) of row row_in_item + 8 r, into the
          // 128-byte swizzle: 16-byte chunk 4 wg + n of the row, XOR the row % 8
          const int row = row_in_item + 8 * r;
          *reinterpret_cast<uint32_t*>(ptile + row * 128 + (((4 * wg + n) ^ (row & 7)) << 4) +
                                       4 * t4) = pack2<E>(p0, p1);
        }
        l_run[r] = l_run[r] * corr[r] + sum;
      }
#pragma unroll
      for (int i = 0; i < W_VSLOTS; ++i)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o_acc[i][4 * n] *= corr[0];
          o_acc[i][4 * n + 1] *= corr[0];
          o_acc[i][4 * n + 2] *= corr[1];
          o_acc[i][4 * n + 3] *= corr[1];
        }
      fence_proxy_async();   // the P tile's stores, for wgmma's eyes
      consumers_sync();      // ... both consumers' stores

      // O += P V over the pass's V slots: this consumer's half of each
      const uint64_t pd = smem_desc(ptile);
#pragma unroll
      for (int i = 0; i < W_VSLOTS; ++i) {
        if (i < nv) {
          const int s = wait_full();
          ++it;
          if (p * W_PASS + i * 2 * W_CHUNK + wg * W_CHUNK < dh) {
            const uint64_t vd = smem_desc(ring + s * W_SLOT_BYTES + wg * W_HALF_BYTES);
            reg_fence(o_acc[i]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < W_KEYS / 16; ++kk)   // 16 keys: 32 bytes of P, 16 rows of V
              wgmma_ss_pv(o_acc[i], pd + 2 * kk, vd + ((kk * 16 * 128) >> 4), E());
            wgmma_commit();
            wgmma_wait<0>();
            reg_fence(o_acc[i]);
          }
          release(s);
        }
      }
    }

    // l over both consumers' keys, then the output of this consumer's halves
    float l_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l_row[r] = l;
      if (t4 == 0) red_sum[wg][row_in_item + 8 * r] = l;
    }
    consumers_sync();
    E* ob = out + (bh / H) * os.b + (bh % H) * os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.0f / (l_row[r] + red_sum[wg ^ 1][row_in_item + 8 * r]);
      const int row = row0 + row_in_item + 8 * r;
      if (row >= T) continue;
      E* orow = ob + row * os.t;
#pragma unroll
      for (int i = 0; i < W_VSLOTS; ++i) {
        if (i >= nv) break;
        const int c0 = p * W_PASS + i * 2 * W_CHUNK + wg * W_CHUNK + 2 * t4;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int c = c0 + 8 * n;
          const typename Elem<E>::E2 o2 = Elem<E>::pair(o_acc[i][4 * n + 2 * r] * inv,
                                                        o_acc[i][4 * n + 2 * r + 1] * inv);
          if (pairs) {
            if (c < dh) *reinterpret_cast<typename Elem<E>::E2*>(orow + c) = o2;
          } else {
            if (c < dh) orow[c] = o2.x;
            if (c + 1 < dh) orow[c + 1] = o2.y;
          }
        }
      }
    }
    consumers_sync();   // red_sum is read before the next item writes it
  }
  }  // consumer warpgroups
}

template <typename E>
int launch_wide(const void* q, const void* k, const void* v, void* out, int B, int H, int T,
                int dh, float scale, const long long* strides, cudaStream_t stream) {
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  CUtensorMap q_map, k_map, v_map;
  CoordOrder qo, ko, vo;
  // boxes of 64 rows x 64 dims in the 128-byte swizzle (Geo<128>'s)
  if (!make_kv_map<E, 128>(&q_map, &qo, q, B, H, T, dh, qs) ||
      !make_kv_map<E, 128>(&k_map, &ko, k, B, H, T, dh, ks) ||
      !make_kv_map<E, 128>(&v_map, &vo, v, B, H, T, dh, vs))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(encoder_attention_wide_kernel<E>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const long long items = (long long)((T + W_ROWS - 1) / W_ROWS) *
                          ((dh + W_PASS - 1) / W_PASS) * B * H;
  if (items > 2147483647LL) return (int)cudaErrorInvalidValue;   // an int walks them
  const int grid = (int)(items < sms ? items : sms);
  // out written in pairs where every row starts 4-byte aligned
  const bool pairs = owc_align_class(2LL * (dh | os.b | os.h | os.t), out) >= 4;
  encoder_attention_wide_kernel<E><<<grid, W_THREADS, W_SMEM, stream>>>(
      q_map, k_map, v_map, static_cast<E*>(out), B * H, H, T, dh, scale, os, qo, ko, vo, pairs);
  return (int)cudaGetLastError();
}

}  // namespace

// The WIDE tensor-core encoder attention (encoder_attention.cu's entry point
// calls it for bf16 and f16 past head dim 256): q, k, v with 16-byte aligned
// rows (base pointers and strides multiples of 8 elements, positive
// strides), out with element-aligned rows. Any B * H whose items an int
// counts.
int owc_encoder_attention_wide(const void* q, const void* k, const void* v, void* out, int B,
                               int H, int T, int dh, float scale, const long long* strides,
                               int dtype, cudaStream_t st) {
  if (T < 1 || dh < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case OWC_BF16: return launch_wide<BF>(q, k, v, out, B, H, T, dh, scale, strides, st);
    case OWC_F16: return launch_wide<__half>(q, k, v, out, B, H, T, dh, scale, strides, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
