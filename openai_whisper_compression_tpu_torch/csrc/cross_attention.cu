// Decode cross-attention over transposed encoder K/V: the grouped kernel
// (K query slots of a row share its K/V) and, further down, the one-query
// kernel for small B*H, which splits S over several blocks.
//
// Replaces: openai_whisper_compression_tpu/ops/cross_attention.py
//           decode_cross_attention_grouped, its three bodies over _beam_core:
//           _kernel_beam (bf16 K/V), _kernel_beam_int8 (int8 K/V) and
//           _kernel_beam_int4 (split-half packed int4 K/V).
// Computes, for each (batch, head) row g of BH and each of its KQ query
// slots j (KQ = 1 in a greedy decode step, the beam width in a beam-search
// step, up to 8 positions of the prompt and prefix window in prefill):
//   scores[j, s] = (sum_d q[g, j, d] * k_t[g, d, s]) * k_scale[g, s]
//   scores[j, s] = -inf for s >= s_valid
//   p[j, s]      = exp(scores[j, s] - max_s), l[j] = sum_s p[j, s]
//   out[g, j, d] = sum_s p[j, s] * v_scale[g, s] * v_t[g, d, s] / l[j]
// in f32, from q in f32, bf16 or f16 and K/V in q's type (no scales) or in
// int8 / int4 with scales, output in q's type (the Pallas kernels are
// generic in it). l is summed before the v-scale fold, as in _beam_core.
//
// What bounds it on the H100: device-memory bytes. Every decode step reads
// the whole cross K/V once: BH x 64 x S_pad x 2 tensors x 2 bytes for bf16
// (151 MB per layer at whisper-small, batch 32), half that for int8 and a
// quarter for int4, against 4 x KQ FLOPs per element, far below the balance
// point. The design reads each K/V element once per call, in 16-byte loads,
// and shares it across the KQ query slots of its row; past s_valid only the
// tail of the last chunk is read, and masked.
//
// Design: flash-decoding. S is cut into 32-position chunks; a row's chunks
// are shared out over the blocks of a thread block cluster (1-8 blocks, the
// split chosen by the Python wrapper so that some 264 blocks are in flight
// whatever B*H is: two an SM) and within a block over its 4 warps, each warp
// walking its chunks with its own online softmax (running max m and sum l
// per slot, the output rescaled when m grows):
// - A warp keeps its next chunks' K and V (and, for int8/int4, their
//   scales) in flight by cp.async in a ring of stages of its own, so every
//   warp streams from the first chunk on, K and V arrive together, and
//   shared memory does not grow with S. The ring holds 2 chunks (16-bit K/V)
//   or 3 (f32, int8, int4): an SM's 8-16 warps then keep 50-100 KB in
//   flight, what the card's memory latency asks at its rate. The block's
//   chunks are dealt round to its warps, so that one round of their loads
//   covers 128 neighbouring positions of every stored row, and each copy
//   asks L2 for its whole 128-byte line (`cp_async16_line`): a chunk is only
//   32-128 bytes of a row, and the card's memory serves whole lines faster
//   (PERF.md, PR 7). Pieces that straddle s_valid are zero filled past it:
//   the padding is never read.
// - 16-bit q (bf16, f16): both products on the tensor cores, mma.sync
//   m16n8k16 with f32 sums. The slots are the 16 rows of A (8 used), so a
//   launch costs the same at 1 and at 8 slots. Scores: B is the [d][s] K
//   tile through ldmatrix.trans. Values: the score accumulators of two
//   8-position tiles are the A fragment of 16 positions as they lie (P,
//   times the v scale, rounded to q's type), B the [d][s] V tile through
//   ldmatrix. int8 and int4 codes stay as stored:
//   ldmatrix.trans hands a thread 16-bit pairs of neighbouring positions, so
//   the even positions of 16 make one n8 tile of scores and the odd ones the
//   next, and a 4-byte load of V gives the matching pairs; each byte or
//   nibble turns into q's type in registers, exactly (|code| <= 127), so only
//   the order of the f32 sums differs from the plain version. Tiles are
//   [64][32], their 16-byte chunks swizzled by row: conflict-free.
// - f32 q: CUDA cores in f32 (no TF32). Scores with a lane per position,
//   then per slot warp-wide max and sum; values with a lane per two head
//   dims over float4 reads of the V tile (XOR-swizzled 128-byte rows).
// - Each warp leaves (o, m, l) per slot in shared memory; after a cluster
//   barrier every block combines a share of the row's outputs over the
//   cluster's blocks and warps in a fixed order through distributed shared
//   memory: one launch, no atomics, the same bits from run to run.
// An int4 row d holds dim d in the low nibble and dim d + 32 in the high
// nibble (both signed), so it yields two head dims. The TPU
// kernel takes any slot count; here a window longer than 8 slots is several
// launches, each over its own slots of q and out (hence the row stride),
// each reading K/V again.
#include <cooperative_groups.h>

#include <type_traits>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int DH = 64, THREADS = 256;
using BF = __nv_bfloat16;

// storage kinds, codes shared with ops/cross_attention.py: K/V in q's own
// type, int8 with scales, split-half packed int4 with scales
enum Kind { KV_FP = 0, KV_INT8 = 1, KV_INT4 = 2 };

// How a kind stores one (64, S_pad) K or V slab: ROWS stored rows of S_pad
// elements; one 16-byte load holds VEC consecutive positions of a row, and
// each stored row carries DIMS head dims (row r holds dims r + i * ROWS).
// Q is q's element type, which is also the stored type of the KV_FP kind.
template <int KIND, typename Q> struct Store;

template <typename Q> struct Store<KV_FP, Q> {
  using T = Q;
  static constexpr int ROWS = 64, VEC = 16 / sizeof(Q), DIMS = 1;
  __device__ static void load(const T* p, float out[DIMS][VEC]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[0][i] = owc_to_float(e[i]);
  }
};

template <typename Q> struct Store<KV_INT8, Q> {
  using T = int8_t;
  static constexpr int ROWS = 64, VEC = 16, DIMS = 1;
  __device__ static void load(const T* p, float out[DIMS][VEC]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[0][i] = (float)b[i];
  }
};

template <typename Q> struct Store<KV_INT4, Q> {
  using T = int8_t;
  static constexpr int ROWS = 32, VEC = 16, DIMS = 2;
  __device__ static void load(const T* p, float out[DIMS][VEC]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int x = b[i];                          // sign-extended byte
      out[0][i] = (float)(((x & 15) ^ 8) - 8);     // signed low nibble
      out[1][i] = (float)(x >> 4);                 // signed high nibble
    }
  }
};

// ---------------------------------------------------------------------------
// The grouped kernel: one pass over S with an online softmax, S split over
// the warps of a block and over the blocks of a thread block cluster.
constexpr int G_CHUNK = 32;   // positions a warp takes at a time
constexpr int G_WARPS = 4;
constexpr int G_THREADS = G_WARPS * 32;
constexpr int G_MAXQ = 8;     // slots a launch holds
constexpr int REC = DH + 2;   // a warp's partial of one slot: 64 sums, m, l
constexpr float LOG2E = 1.4426950408889634f;

// Tiles of a chunk, [64 dims][G_CHUNK positions], in the stored type: rows
// of 64 bytes (16-bit), 128 (f32) or 32 (int8 and int4 codes), their 16-byte
// chunks XOR-swizzled by the row so that the 8 rows an ldmatrix matrix reads
// at one column, or the rows a warp reads at one position, fall on distinct
// banks, with no padding to waste the shared memory that holds the bytes in
// flight.
template <typename C> struct Tile {  // 16-bit
  static constexpr int ROW = 64;
  __device__ static int off(int d, int chunk) {
    return d * ROW + ((chunk ^ ((d >> 1) & 3)) << 4);
  }
};
template <> struct Tile<float> {
  static constexpr int ROW = 128;
  __device__ static int off(int d, int chunk) { return d * ROW + ((chunk ^ (d & 7)) << 4); }
};
template <> struct Tile<int8_t> {
  static constexpr int ROW = G_CHUNK;
  __device__ static int off(int d, int chunk) {
    return d * ROW + ((chunk ^ ((d >> 2) & 1)) << 4);
  }
};

// A warp's shared memory: NS stages, each the chunk's K and V as stored (in
// q's type already laid out as its compute tile; int8 and int4 as 32-byte
// rows) and, for the scaled kinds, the chunk's k and v scales; then the
// compute tiles the scaled kinds are converted into.
template <int KIND, typename Q> struct GLayout {
  static constexpr bool SCALED = KIND != KV_FP;
  using Raw = Tile<typename Store<KIND, Q>::T>;
  static constexpr int TILE = DH * Tile<Q>::ROW;                  // a compute tile
  static constexpr int RAW = Store<KIND, Q>::ROWS * Raw::ROW;     // one of K, V
  static constexpr int SCALES = 2 * RAW;                          // offset in a stage
  static constexpr int STAGE = 2 * RAW + (SCALED ? 2 * G_CHUNK * 4 : 0);
  // chunks in flight while one is used: an SM holds 8-16 warps, whose
  // stages in flight must cover the card's memory latency at its rate
  static constexpr int NS = SCALED || sizeof(Q) == 4 ? 3 : 2;
  // the f32 body converts int8 and int4 codes into f32 compute tiles
  static constexpr bool CONVERT = SCALED && std::is_same<Q, float>::value;
  static constexpr int WARP = NS * STAGE + (CONVERT ? 2 * TILE : 0);
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8 f32) += a (16x16, row major) * b (16x8, column major), in Q
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1, BF) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1, __half) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi, BF) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 codes (exact in f32) as two 16-byte chunks of the f32 compute tile
__device__ __forceinline__ void put8(unsigned char* tile, int d, int pos0, const float (&f)[8],
                                     float) {
  *reinterpret_cast<float4*>(tile + Tile<float>::off(d, pos0 / 4)) =
      make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(tile + Tile<float>::off(d, pos0 / 4 + 1)) =
      make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// Two codes of the 4 bytes in r as a pair of q's type (exact; the low half
// from byte `odd`, the high half from byte `odd` + 2): their signed value
// (int8) or their signed low (nib 0) or high (nib 1) nibble (int4). The
// code, made unsigned (u = code + 8 or + 128), goes into the mantissa of a
// number whose exponent makes it 2^e + u, and the subtraction of 2^e + 8
// (or + 128) leaves the code: f16 holds u < 1024 so, bf16 only u < 128, so
// bf16 takes an int8 code through f32.
template <int KIND>
__device__ __forceinline__ uint32_t code_pair(uint32_t r, int odd, int nib, __half) {
  const uint32_t u = KIND == KV_INT8 ? r ^ 0x80808080u
                                     : ((nib ? r >> 4 : r) & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t h = __byte_perm(u, 0x64646464u, odd ? 0x4341 : 0x4240);  // 1024 + u
  const __half2 v = __hsub2(*reinterpret_cast<const __half2*>(&h),
                            __float2half2_rn(KIND == KV_INT8 ? 1152.0f : 1032.0f));
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <int KIND>
__device__ __forceinline__ uint32_t code_pair(uint32_t r, int odd, int nib, BF) {
  if (KIND == KV_INT8) {
    const uint32_t u = r ^ 0x80808080u;
    const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, odd ? 0x7541 : 0x7540));
    const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, odd ? 0x7543 : 0x7542));
    return pack2(lo - 8388736.0f, hi - 8388736.0f, BF());  // 2^23 + u - (2^23 + 128)
  }
  const uint32_t u = ((nib ? r >> 4 : r) & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t h = __byte_perm(u, 0x43434343u, odd ? 0x4341 : 0x4240);  // 128 + u
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&h),
                                   __float2bfloat162_rn(136.0f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int KIND, typename Q>
__global__ void __launch_bounds__(G_THREADS)
cross_attn_grouped_kernel(const Q* __restrict__ q,
                          const typename Store<KIND, Q>::T* __restrict__ k_t,
                          const typename Store<KIND, Q>::T* __restrict__ v_t,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          Q* __restrict__ out, int KQ, int row_stride,
                          int S_pad, int s_valid) {
  using L = GLayout<KIND, Q>;
  using St = Store<KIND, Q>;
  using T = typename St::T;
  constexpr bool F32 = std::is_same<Q, float>::value;
  constexpr int NS = L::NS;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float rec[G_WARPS][G_MAXQ][REC];
  __shared__ float qs[F32 ? G_MAXQ : 1][DH];  // the f32 body's slots
  cg::cluster_group cluster = cg::this_cluster();
  const int g = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank(), splits = (int)cluster.num_blocks();
  const T* kg = k_t + (size_t)g * St::ROWS * S_pad;
  const T* vg = v_t + (size_t)g * St::ROWS * S_pad;
  const float* ksg = L::SCALED ? k_scale + (size_t)g * S_pad : nullptr;
  const float* vsg = L::SCALED ? v_scale + (size_t)g * S_pad : nullptr;
  const Q* qg = q + (size_t)g * row_stride;

  // this warp's chunks: the block's share of the row, then the warp's
  const int nch = (s_valid + G_CHUNK - 1) / G_CHUNK;
  const int b_lo = rank * nch / splits, b_hi = (rank + 1) * nch / splits;
  // the block's chunks dealt round to its warps, so that the warps' loads of
  // one round cover 128 neighbouring positions of every stored row
  const int nj = max(0, (b_hi - b_lo - warp + G_WARPS - 1) / G_WARPS);
  auto chunk_of = [&](int j) { return b_lo + warp + j * G_WARPS; };
  unsigned char* wsm = smem + warp * L::WARP;
  const uint32_t wsm_u = (uint32_t)__cvta_generic_to_shared(wsm);
  unsigned char* ctile = wsm + NS * L::STAGE;  // K, then V, compute tiles

  // the warp's chunk j into stage i: every 16-byte piece below s_valid (a
  // piece that straddles it is zero filled past it; the padding is never
  // read)
  auto load = [&](int j, int i) {
    if (j < nj) {
      const int s0 = chunk_of(j) * G_CHUNK;
      const uint32_t st = wsm_u + i * L::STAGE;
      constexpr int VEC = St::VEC, E = 16 / VEC;  // positions a piece, bytes each
      constexpr int PPR = G_CHUNK / VEC;          // pieces a stored row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const T* src = (h ? vg : kg) + s0;
#pragma unroll
        for (int p = lane; p < St::ROWS * PPR; p += 32) {
          const int r = p / PPR, pc = p % PPR;
          const int dst = st + h * L::RAW + L::Raw::off(r, pc);
          if (s0 + G_CHUNK <= s_valid) {  // a whole chunk: no piece straddles s_valid
            cp_async16_line(dst, src + (size_t)r * S_pad + pc * VEC, 16);
          } else {
            const int bytes = max(0, min(16, (s_valid - s0 - pc * VEC) * E));
            cp_async16_line(dst, bytes ? src + (size_t)r * S_pad + pc * VEC : src, bytes);
          }
        }
      }
      if (L::SCALED && lane < 16) {
        const int h = lane >> 3, pos = s0 + (lane & 7) * 4;
        const int bytes = max(0, min(16, (s_valid - pos) * 4));
        const float* src = h ? vsg : ksg;
        cp_async16_line(st + L::SCALES + lane * 16, bytes ? src + pos : src, bytes);
      }
    }
    cp_async_commit();
  };
  // the scaled kinds' codes of stage i as compute tiles (exact in any type)
  auto convert = [&](int i) {
    const unsigned char* st = wsm + i * L::STAGE;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned char* raw = st + h * L::RAW;
      unsigned char* dst = ctile + h * L::TILE;
      if constexpr (L::CONVERT) {
        for (int p = lane; p < St::ROWS * 2; p += 32) {
          const int r = p >> 1, pos0 = (p & 1) * 16;
          float v[St::DIMS][St::VEC];
          St::load(reinterpret_cast<const T*>(raw + L::Raw::off(r, p & 1)), v);
#pragma unroll
          for (int dd = 0; dd < St::DIMS; ++dd)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float f[8];
#pragma unroll
              for (int e = 0; e < 8; ++e) f[e] = v[dd][half * 8 + e];
              put8(dst, r + dd * St::ROWS, pos0 + half * 8, f, Q());
            }
        }
      }
    }
  };
  auto k_tile = [&](int i) -> unsigned char* {
    return L::CONVERT ? ctile : wsm + i * L::STAGE;
  };
  auto scales = [&](int i) {
    return reinterpret_cast<const float*>(wsm + i * L::STAGE + L::SCALES);
  };

  float m_run[F32 ? G_MAXQ : 1], l_run[F32 ? G_MAXQ : 1];
#pragma unroll
  for (int j = 0; j < (F32 ? G_MAXQ : 1); ++j) {
    m_run[j] = -INFINITY;
    l_run[j] = 0.0f;
  }

  if constexpr (!F32) {
    // ---- 16-bit q: mma.sync m16n8k16 for both products ----
    // The rows of A are slots (8 of 16 used), so the cost does not depend on
    // the slot count. Scores: B is a 16-dim x 8-position tile of K, taken by
    // ldmatrix.trans from the [d][s] rows: two 16-bit positions of a row
    // from fp K; from int8 or int4 codes, whose 16-bit pairs hold two
    // positions, the even positions make one n8 tile and the odd ones the
    // next. Values: the score accumulators of a tile pair, times the v
    // scale and rounded to q's type, are the A fragment of 16 positions as
    // they lie; B is the V tile through ldmatrix (fp) or one 4-byte load of
    // four positions, split into the same even and odd pairs (codes).
    const int gq = lane >> 2, t4 = lane & 3, mi = lane >> 3, mr = lane & 7;
    uint32_t qa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const Q* qp = qg + gq * DH + ks * 16 + 2 * t4;
      const bool on = gq < KQ;
      qa[ks][0] = on ? *reinterpret_cast<const uint32_t*>(qp) : 0u;
      qa[ks][1] = 0u;
      qa[ks][2] = on ? *reinterpret_cast<const uint32_t*>(qp + 8) : 0u;
      qa[ks][3] = 0u;
    }
    // the chunk position of score tile n (two per 16 positions), element e
    auto pos_of = [&](int n, int e) {
      return L::SCALED ? (n >> 1) * 16 + 4 * t4 + 2 * e + (n & 1)
                       : (n >> 1) * 16 + (n & 1) * 8 + 2 * t4 + e;
    };
    float o[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

#pragma unroll
    for (int i = 0; i < NS - 1; ++i) load(i, i);
    for (int j = 0; j < nj; ++j) {
      const int i = j % NS;
      cp_async_wait<NS - 2>();  // chunk j has landed, for this lane's copies
      __syncwarp();              // ... and for the warp's; stage j - 1 is free
      load(j + NS - 1, (j + NS - 1) % NS);
      const uint32_t kt = wsm_u + i * L::STAGE, vt = kt + L::RAW;
      float sc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
      if constexpr (!L::SCALED) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            uint32_t b[4];  // [d lo, d hi] x [positions 16h .. + 7, + 8 .. + 15]
            ldmatrix_x4_trans(b, kt + Tile<Q>::off(ks * 16 + (mi & 1) * 8 + mr,
                                                   h * 2 + (mi >> 1)));
            mma16(sc[2 * h], qa[ks], b[0], b[1], Q());
            mma16(sc[2 * h + 1], qa[ks], b[2], b[3], Q());
          }
      } else {
#pragma unroll
        for (int kr = 0; kr < St::ROWS / 16; ++kr) {
          uint32_t b[4];  // [d lo, d hi] x [positions 0 .. 15, 16 .. 31]
          ldmatrix_x4_trans(b, kt + L::Raw::off(kr * 16 + (mi & 1) * 8 + mr, mi >> 1));
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int odd = 0; odd < 2; ++odd)
#pragma unroll
              for (int nib = 0; nib < St::DIMS; ++nib) {
                const int ks = kr + nib * 2;  // int4: high nibbles are dims + 32
                mma16(sc[2 * h + odd], qa[ks], code_pair<KIND>(b[2 * h], odd, nib, Q()),
                      code_pair<KIND>(b[2 * h + 1], odd, nib, Q()), Q());
              }
        }
      }
      // online softmax of slot gq over the chunk's 32 positions, in base 2
      // (this thread: 8 of them; the 4 lanes of a slot hold the rest)
      const int s0 = chunk_of(j) * G_CHUNK;
      const float* scl = L::SCALED ? scales(i) : nullptr;
      float x[4][2], mt = -INFINITY;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = pos_of(n, e);
          const float v = (L::SCALED ? sc[n][e] * scl[p] : sc[n][e]) * LOG2E;
          x[n][e] = s0 + p < s_valid ? v : -INFINITY;
          mt = fmaxf(mt, x[n][e]);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float mn = fmaxf(m_run[0], mt);  // finite: a chunk's first position is valid
      const float corr = ex2(m_run[0] - mn);
      m_run[0] = mn;
      float lsum = 0.0f;
      uint32_t pa[2][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float pv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pr = ex2(x[n][e] - mn);  // 0 past s_valid
          lsum += pr;
          // the v scale folds in after l; past s_valid the scale is never read
          const int p = pos_of(n, e);
          pv[e] = L::SCALED ? (s0 + p < s_valid ? pr * scl[G_CHUNK + p] : 0.0f) : pr;
        }
        pa[n >> 1][(n & 1) * 2] = pack2(pv[0], pv[1], Q());
        pa[n >> 1][(n & 1) * 2 + 1] = 0u;
      }
      l_run[0] = l_run[0] * corr + lsum;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[n][0] *= corr;
        o[n][1] *= corr;
      }
      if constexpr (!L::SCALED) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int dp = 0; dp < 4; ++dp) {
            uint32_t b[4];  // [dims 16dp .. + 7, + 8 .. + 15] x [positions lo, hi]
            ldmatrix_x4(b, vt + Tile<Q>::off((2 * dp + (mi >> 1)) * 8 + mr, h * 2 + (mi & 1)));
            mma16(o[2 * dp], pa[h], b[0], b[1], Q());
            mma16(o[2 * dp + 1], pa[h], b[2], b[3], Q());
          }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int dt = 0; dt < St::ROWS / 8; ++dt) {
            // positions 16h + 4 t4 .. + 3 of stored row 8 dt + gq
            const uint32_t w = lds32(vt + L::Raw::off(dt * 8 + gq, h) + 4 * t4);
#pragma unroll
            for (int nib = 0; nib < St::DIMS; ++nib)
              mma16(o[dt + nib * 4], pa[h], code_pair<KIND>(w, 0, nib, Q()),
                    code_pair<KIND>(w, 1, nib, Q()), Q());
          }
      }
    }
    cp_async_wait<0>();
    float l = l_run[0];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    float* r = rec[warp][gq];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      r[n * 8 + 2 * t4] = o[n][0];
      r[n * 8 + 2 * t4 + 1] = o[n][1];
    }
    if (t4 == 0) {
      r[DH] = m_run[0];
      r[DH + 1] = l;
    }
  } else {
    // ---- f32 q: CUDA cores, f32 arithmetic ----
    for (int e = tid; e < G_MAXQ * DH; e += G_THREADS)
      qs[e / DH][e % DH] = e / DH < KQ ? qg[e] : 0.0f;
    __syncthreads();
    float* ps = reinterpret_cast<float*>(rec[warp]);  // [slot][32] probabilities
    float o[G_MAXQ][2];
#pragma unroll
    for (int j = 0; j < G_MAXQ; ++j) o[j][0] = o[j][1] = 0.0f;
#pragma unroll
    for (int i = 0; i < NS - 1; ++i) load(i, i);
    for (int j = 0; j < nj; ++j) {
      const int i = j % NS;
      cp_async_wait<NS - 2>();
      __syncwarp();
      load(j + NS - 1, (j + NS - 1) % NS);
      if (L::SCALED) {
        convert(i);
        __syncwarp();
      }
      const unsigned char* kt = k_tile(i);
      const unsigned char* vt = kt + L::TILE;  // V's tile follows K's
      // scores: lane = position
      float acc[G_MAXQ];
#pragma unroll
      for (int j = 0; j < G_MAXQ; ++j) acc[j] = 0.0f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float kv = *reinterpret_cast<const float*>(
            kt + Tile<float>::off(d, lane >> 2) + (lane & 3) * 4);
#pragma unroll
        for (int j = 0; j < G_MAXQ; ++j)
          if (j < KQ) acc[j] = fmaf(qs[j][d], kv, acc[j]);
      }
      const int pos = chunk_of(j) * G_CHUNK + lane;
      const bool valid = pos < s_valid;
      const float* scl = L::SCALED ? scales(i) : nullptr;
      __syncwarp();  // the previous chunk's probabilities have been read
#pragma unroll
      for (int j = 0; j < G_MAXQ; ++j) {
        if (j < KQ) {
          const float x = valid ? (L::SCALED ? acc[j] * scl[lane] : acc[j]) : -INFINITY;
          const float mn = fmaxf(m_run[j], owc_warp_max(x));
          const float corr = expf(m_run[j] - mn);
          m_run[j] = mn;
          const float p = expf(x - mn);
          l_run[j] = l_run[j] * corr + owc_warp_sum(p);
          ps[j * G_CHUNK + lane] =
              L::SCALED ? (valid ? p * scl[G_CHUNK + lane] : 0.0f) : p;
          o[j][0] *= corr;
          o[j][1] *= corr;
        }
      }
      __syncwarp();
      // values: lane = head dims lane and lane + 32
#pragma unroll
      for (int pq = 0; pq < G_CHUNK / 4; ++pq) {
        const float4 v0 = *reinterpret_cast<const float4*>(vt + Tile<float>::off(lane, pq));
        const float4 v1 =
            *reinterpret_cast<const float4*>(vt + Tile<float>::off(lane + 32, pq));
#pragma unroll
        for (int j = 0; j < G_MAXQ; ++j) {
          if (j < KQ) {
            const float4 p = *reinterpret_cast<const float4*>(ps + j * G_CHUNK + pq * 4);
            o[j][0] = fmaf(p.x, v0.x, fmaf(p.y, v0.y, fmaf(p.z, v0.z, fmaf(p.w, v0.w, o[j][0]))));
            o[j][1] = fmaf(p.x, v1.x, fmaf(p.y, v1.y, fmaf(p.z, v1.z, fmaf(p.w, v1.w, o[j][1]))));
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncwarp();  // the probabilities' room becomes the warp's record
#pragma unroll
    for (int j = 0; j < G_MAXQ; ++j) {
      if (j < KQ) {
        rec[warp][j][lane] = o[j][0];
        rec[warp][j][lane + 32] = o[j][1];
        if (lane == 0) {
          rec[warp][j][DH] = m_run[j];
          rec[warp][j][DH + 1] = l_run[j];
        }
      }
    }
  }

  // every warp's record of every block of the row, combined in a fixed order
  // (rank, then warp): no atomics, the same bits from run to run
  cluster.sync();
  for (int e = rank * G_THREADS + tid; e < KQ * DH; e += splits * G_THREADS) {
    const int j = e / DH, d = e % DH;
    float big = -INFINITY;
    for (int sp = 0; sp < splits; ++sp) {
      const float* rr = &cluster.map_shared_rank(&rec[0][0][0], sp)[j * REC];
#pragma unroll
      for (int w = 0; w < G_WARPS; ++w) big = fmaxf(big, rr[w * G_MAXQ * REC + DH]);
    }
    float l = 0.0f, acc = 0.0f;
    for (int sp = 0; sp < splits; ++sp) {
      const float* rr = &cluster.map_shared_rank(&rec[0][0][0], sp)[j * REC];
#pragma unroll
      for (int w = 0; w < G_WARPS; ++w) {
        const float* x = rr + w * G_MAXQ * REC;
        const float m = x[DH];
        if (m == -INFINITY) continue;  // a warp that had no chunk
        const float wgt = F32 ? expf(m - big) : ex2(m - big);  // m in base 2 but for f32
        l = fmaf(x[DH + 1], wgt, l);
        acc = fmaf(x[d], wgt, acc);
      }
    }
    owc_store(out + (size_t)g * row_stride + j * DH + d, acc / l);
  }
  cluster.sync();  // no block leaves while another still reads its records
}

template <int KIND, typename Q>
int launch(const void* q, const void* k_t, const void* v_t, const void* k_scale,
           const void* v_scale, void* out, int BH, int KQ, int row_stride,
           int S_pad, int s_valid, int splits, cudaStream_t st) {
  using T = typename Store<KIND, Q>::T;
  constexpr int smem = G_WARPS * GLayout<KIND, Q>::WARP;
  if (splits < 1 || splits > 8) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(cross_attn_grouped_kernel<KIND, Q>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BH, splits);
  cfg.blockDim = dim3(G_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, cross_attn_grouped_kernel<KIND, Q>, static_cast<const Q*>(q),
                         static_cast<const T*>(k_t), static_cast<const T*>(v_t),
                         static_cast<const float*>(k_scale),
                         static_cast<const float*>(v_scale), static_cast<Q*>(out), KQ,
                         row_stride, S_pad, s_valid);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Calls fn(kind tag, q type tag) for the storage kind and dtype codes;
// false where either is unknown.
template <typename F>
bool dispatch(int kind, int dtype, F&& fn) {
  return owc_dispatch_float(dtype, [&](auto qt) {
    switch (kind) {
      case KV_FP: fn(std::integral_constant<int, KV_FP>(), qt); break;
      case KV_INT8: fn(std::integral_constant<int, KV_INT8>(), qt); break;
      case KV_INT4: fn(std::integral_constant<int, KV_INT4>(), qt); break;
    }
  }) && kind >= KV_FP && kind <= KV_INT4;
}

// ---------------------------------------------------------------------------
// One query per (batch, head) row, S split over several blocks.
//
// Replaces: openai_whisper_compression_tpu/ops/cross_attention.py
//           decode_cross_attention, its three bodies _kernel (bf16 K/V),
//           _kernel_int8 and _kernel_int4: the decode step's cross-attention
//           where B*H is no multiple of 16 (whisper-small at batch 1-3: 12,
//           24, 36 rows), computing what the grouped kernel computes at one
//           slot.
// What bounds it on the H100: bytes, and in practice launch latency. A row
// streams 2 x 64 x s_valid elements whatever B*H is, and with 12 rows one
// block per row would leave 120 of the 132 SMs idle. So a block takes
// SPLIT_CHUNKS 16-byte chunks of positions of one row (128 positions of
// int8/int4 K/V, 64 of bf16 or f16, 32 of f32): B*H x 12 (24, 47) blocks at
// S = 1500.
// Design: 256 threads = 32 row groups x 8 chunks. Pass 1: each thread takes
// its chunk of its group's stored rows (2 rows, 1 for int4, one 16-byte load
// each), the 32 partial scores of a position are summed through shared
// memory, scaled and masked; block reductions give the span's maximum m and
// sum l of exp(score - m). Pass 2: the same thread layout over V, the
// probabilities (times the v scale) from shared memory, the 8 chunk lanes of
// a row reduced by shuffles. Each block leaves 64 unnormalised sums, m and l
// in scratch; `cross_attn_combine_kernel` (one small block per row) rescales
// the partial sums to the common maximum, divides by the total l and writes
// q's type. Two launches, no atomics, so the result does not change from run to
// run.
constexpr int SPLIT_CHUNKS = 8;  // 16-byte chunks of positions per block
constexpr int PART = DH + 2;     // a block's record: 64 sums, m, l

template <int KIND, typename Q>
__global__ void __launch_bounds__(THREADS)
cross_attn_split_kernel(const Q* __restrict__ q,
                        const typename Store<KIND, Q>::T* __restrict__ k_t,
                        const typename Store<KIND, Q>::T* __restrict__ v_t,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        float* __restrict__ part, int S_pad, int s_valid) {
  using St = Store<KIND, Q>;
  constexpr int ROWS = St::ROWS, VEC = St::VEC, DIMS = St::DIMS;
  constexpr bool SCALED = KIND != KV_FP;
  constexpr int SPAN = SPLIT_CHUNKS * VEC;    // positions per block
  constexpr int RG = THREADS / SPLIT_CHUNKS;  // row groups
  constexpr int RPT = ROWS / RG;              // stored rows per thread
  __shared__ float qs[DH];
  __shared__ float partial[RG][SPAN];
  __shared__ float ps[SPAN];
  __shared__ float red[32];
  const int g = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  const int c = tid % SPLIT_CHUNKS, rg = tid / SPLIT_CHUNKS;
  const typename St::T* kg = k_t + (size_t)g * ROWS * S_pad;
  const typename St::T* vg = v_t + (size_t)g * ROWS * S_pad;
  const int nchunks = (s_valid + VEC - 1) / VEC;
  const int s0 = (split * SPLIT_CHUNKS + c) * VEC;  // this thread's chunk
  const bool active = split * SPLIT_CHUNKS + c < nchunks;

  if (tid < DH) qs[tid] = owc_to_float(q[(size_t)g * DH + tid]);
  __syncthreads();

  {
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    if (active) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg * RPT + i;
        float kv[DIMS][VEC];
        St::load(kg + (size_t)r * S_pad + s0, kv);
#pragma unroll
        for (int d = 0; d < DIMS; ++d) {
          const float qd = qs[r + d * ROWS];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] = fmaf(qd, kv[d][v], acc[v]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) partial[rg][c * VEC + v] = acc[v];
  }
  __syncthreads();

  const int s = split * SPAN + tid;  // the position thread tid < SPAN owns
  const bool valid = tid < SPAN && s < s_valid;
  float x = -INFINITY;
  if (valid) {
    float sum = 0.0f;
#pragma unroll 8
    for (int r = 0; r < RG; ++r) sum += partial[r][tid];
    x = SCALED ? sum * k_scale[(size_t)g * S_pad + s] : sum;
  }
  // the first chunk of every block lies below s_valid, so m is finite
  const float m = owc_block_max(x, red);
  const float p = valid ? expf(x - m) : 0.0f;
  const float l = owc_block_sum(p, red);
  // the v scale folds in after l; padding scales may hold anything
  if (tid < SPAN)
    ps[tid] = SCALED ? (valid ? p * v_scale[(size_t)g * S_pad + s] : 0.0f) : p;
  __syncthreads();

  float* rec = part + ((size_t)g * gridDim.y + split) * PART;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg * RPT + i;
    float acc[DIMS];
#pragma unroll
    for (int d = 0; d < DIMS; ++d) acc[d] = 0.0f;
    if (active) {
      float vv[DIMS][VEC];
      St::load(vg + (size_t)r * S_pad + s0, vv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        if (s0 + v < s_valid) {  // padding may hold anything
          const float pv = ps[c * VEC + v];
#pragma unroll
          for (int d = 0; d < DIMS; ++d) acc[d] = fmaf(pv, vv[d][v], acc[d]);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < DIMS; ++d) {
      float tot = acc[d];  // over the row's 8 chunk lanes, neighbours in a warp
#pragma unroll
      for (int o = SPLIT_CHUNKS / 2; o > 0; o >>= 1)
        tot += __shfl_xor_sync(0xffffffffu, tot, o);
      if (c == 0) rec[r + d * ROWS] = tot;
    }
  }
  if (tid == 0) {
    rec[DH] = m;
    rec[DH + 1] = l;
  }
}

// out[g, d] = sum_i part[g, i, d] * exp(m_i - M) / sum_i l_i * exp(m_i - M),
// M the largest m_i; 64 threads, one per head dim.
template <typename Q>
__global__ void __launch_bounds__(DH)
cross_attn_combine_kernel(const float* __restrict__ part, Q* __restrict__ out,
                          int nsplit) {
  const int g = blockIdx.x, d = threadIdx.x;
  const float* rec = part + (size_t)g * nsplit * PART;
  float big = -INFINITY;
  for (int i = 0; i < nsplit; ++i) big = fmaxf(big, rec[i * PART + DH]);
  float l = 0.0f, acc = 0.0f;
  for (int i = 0; i < nsplit; ++i) {
    const float w = expf(rec[i * PART + DH] - big);
    l = fmaf(rec[i * PART + DH + 1], w, l);
    acc = fmaf(rec[i * PART + d], w, acc);
  }
  owc_store(out + (size_t)g * DH + d, acc / l);
}

template <int KIND, typename Q>
int launch_split(const void* q, const void* k_t, const void* v_t,
                 const void* k_scale, const void* v_scale, void* part, void* out,
                 int BH, int nsplit, int S_pad, int s_valid, cudaStream_t st) {
  using T = typename Store<KIND, Q>::T;
  constexpr int VEC = Store<KIND, Q>::VEC;
  const int nchunks = (s_valid + VEC - 1) / VEC;
  if (nsplit != (nchunks + SPLIT_CHUNKS - 1) / SPLIT_CHUNKS || nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  cross_attn_split_kernel<KIND, Q><<<dim3(BH, nsplit), THREADS, 0, st>>>(
      static_cast<const Q*>(q), static_cast<const T*>(k_t),
      static_cast<const T*>(v_t), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<float*>(part), S_pad,
      s_valid);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cross_attn_combine_kernel<Q><<<BH, DH, 0, st>>>(static_cast<const float*>(part),
                                                  static_cast<Q*>(out), nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// In both entry points `dtype` is the code (common.cuh) of the element type
// of q and out: f32, bf16 or f16.

// q and out: KQ slots of 64 values for each of BH rows, row g at element
// g * row_stride (row_stride = KQ * 64 for contiguous (BH, KQ, 64) tensors;
// larger when the call covers some of a longer window's slots). kind 0:
// k_t/v_t (BH, 64, S_pad) in q's type, scales unused (may be null). kind 1:
// k_t/v_t (BH, 64, S_pad) int8 with k_scale/v_scale (BH, 1, S_pad) f32.
// kind 2: k_t/v_t (BH, 32, S_pad) split-half packed int4 with the same
// scales. splits: the blocks (1..8) of the thread block cluster that shares
// a row, each given at least one 32-position chunk of it. Requires 1 <= KQ
// <= 8, 1 <= s_valid <= S_pad, S_pad a multiple of the kind's 16-byte chunk
// (4 positions of f32, 8 of bf16 or f16, 16 of int8/int4), 16-byte aligned
// k_t/v_t and scales, 4-byte aligned q rows.
extern "C" int owc_cross_attention_grouped(const void* q, const void* k_t,
                                           const void* v_t, const void* k_scale,
                                           const void* v_scale, void* out,
                                           int BH, int KQ, int row_stride,
                                           int S_pad, int s_valid, int splits,
                                           int kind, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KQ < 1 || KQ > G_MAXQ || splits > (s_valid + G_CHUNK - 1) / G_CHUNK)
    return (int)cudaErrorInvalidValue;
  int err = 0;
  const bool ok = dispatch(kind, dtype, [&](auto kind_tag, auto qt) {
    err = launch<decltype(kind_tag)::value, decltype(qt)>(
        q, k_t, v_t, k_scale, v_scale, out, BH, KQ, row_stride, S_pad, s_valid, splits,
        st);
  });
  return ok ? err : (int)cudaErrorInvalidValue;
}

// One query per row: q and out (BH, 64); k_t/v_t, the scales and kind as
// above. part: scratch of BH * nsplit * 66 floats, nsplit =
// ceil(ceil(s_valid / VEC) / 8) with VEC the kind's positions per 16-byte
// chunk. Requires 1 <= s_valid <= S_pad, S_pad a multiple of VEC, 16-byte
// aligned k_t/v_t.
extern "C" int owc_cross_attention(const void* q, const void* k_t,
                                   const void* v_t, const void* k_scale,
                                   const void* v_scale, void* part, void* out,
                                   int BH, int nsplit, int S_pad, int s_valid,
                                   int kind, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  const bool ok = dispatch(kind, dtype, [&](auto kind_tag, auto qt) {
    err = launch_split<decltype(kind_tag)::value, decltype(qt)>(
        q, k_t, v_t, k_scale, v_scale, part, out, BH, nsplit, S_pad, s_valid, st);
  });
  return ok ? err : (int)cudaErrorInvalidValue;
}
