// Decode cross-attention over transposed encoder K/V: the grouped kernel
// (K query slots of a row share its K/V) and, further down, the one-query
// kernel for small B*H, which splits S over the blocks of a cluster.
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

constexpr int DH = 64;
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
    decode(*reinterpret_cast<const uint4*>(p), out);
  }
  __device__ static void decode(const uint4& u, float out[DIMS][VEC]) {
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[0][i] = owc_to_float(e[i]);
  }
};

template <typename Q> struct Store<KV_INT8, Q> {
  using T = int8_t;
  static constexpr int ROWS = 64, VEC = 16, DIMS = 1;
  __device__ static void load(const T* p, float out[DIMS][VEC]) {
    decode(*reinterpret_cast<const uint4*>(p), out);
  }
  // 16 codes, exactly, by byte permutes
  __device__ static void decode(const uint4& u, float out[DIMS][VEC]) {
    owc_int8x4_to_float(u.x, out[0]);
    owc_int8x4_to_float(u.y, out[0] + 4);
    owc_int8x4_to_float(u.z, out[0] + 8);
    owc_int8x4_to_float(u.w, out[0] + 12);
  }
};

template <typename Q> struct Store<KV_INT4, Q> {
  using T = int8_t;
  static constexpr int ROWS = 32, VEC = 16, DIMS = 2;
  __device__ static void load(const T* p, float out[DIMS][VEC]) {
    decode(*reinterpret_cast<const uint4*>(p), out);
  }
  // the signed low nibbles of 16 bytes, then the high ones, exactly
  __device__ static void decode(const uint4& u, float out[DIMS][VEC]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      owc_int4x4_to_float(w[c], 0, out[0] + 4 * c);
      owc_int4x4_to_float(w[c], 4, out[1] + 4 * c);
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
// One query per (batch, head) row, S split over the blocks of a cluster.
//
// Replaces: openai_whisper_compression_tpu/ops/cross_attention.py
//           decode_cross_attention, its three bodies _kernel (bf16 K/V),
//           _kernel_int8 and _kernel_int4: the decode step's cross-attention
//           where B*H is no multiple of 16 (whisper-small at batch 1-3: 12,
//           24, 36 rows), computing what the grouped kernel computes at one
//           slot.
// What bounds it on the H100: bytes, and in practice latency. A row streams
// 2 x 64 x s_valid elements whatever B*H is (1-5 MB at 12-36 rows), less
// than a microsecond of the card's memory rate; what a call costs is its
// launch and how many memory latencies it waits through in series.
// Design: one launch, one latency.
// - A row's positions are cut into 64-position chunks, shared out over the
//   1-8 blocks of a thread block cluster (`one_query_splits` in the wrapper:
//   as many blocks as the card holds at once, one an SM, since 200-243
//   registers a thread leave room for one; a second wave costs as much as
//   the first), and within a block a
//   chunk's tiles (4 16-byte chunk columns: 64 positions of int8/int4, 32 of
//   16-bit, 16 of f32 K/V) are dealt round to its 8 warps.
// - In a tile, lane l takes chunk column l & 3 of the stored rows l >> 2,
//   + 8, + 16, ...: 4 lanes read 64 neighbouring bytes of a row, a warp 8
//   rows an instruction. A lane issues all of its K and V loads (and its
//   positions' scales) at once, and the next tile's before it computes this
//   one's, so V is in flight while the scores reduce.
// - Scores: each lane sums its rows' products for the positions of its
//   column; a reduce-scatter over the 8 lanes of a column
//   (`owc_reduce_scatter`) leaves every position's score with one lane (or
//   two), with no shared array and no block barrier. A warp keeps an online
//   softmax (m, l in base 2); its probabilities, times the v scale, go
//   through 64 floats of the warp's own shared memory to the lanes that hold
//   V, which add them into 64 dims of sums spread over the warp.
// - The warps' (o, m, l) combine in the block, the blocks' in a fixed order
//   through distributed shared memory after a cluster barrier: no atomics,
//   no scratch in device memory, the same bits from run to run.
// int8 and int4 codes turn into f32 exactly (byte permutes), so only the
// order of the f32 sums differs from the plain version. Positions past
// s_valid are never loaded but in the chunk column that straddles s_valid,
// whose values there are masked out (the padding may hold anything).
constexpr int OQ_CHUNK = 64;  // positions of a block's share (ONE_QUERY_CHUNK)
constexpr int OQ_WARPS = 8;
constexpr int OQ_THREADS = OQ_WARPS * 32;
constexpr int OQ_COLS = 4;    // 16-byte chunk columns of a warp's tile

template <int KIND, typename Q>
__global__ void __launch_bounds__(OQ_THREADS, 1)
cross_attn_one_query_kernel(const Q* __restrict__ q,
                            const typename Store<KIND, Q>::T* __restrict__ k_t,
                            const typename Store<KIND, Q>::T* __restrict__ v_t,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale, Q* __restrict__ out,
                            int S_pad, int s_valid) {
  using St = Store<KIND, Q>;
  using T = typename St::T;
  constexpr bool SCALED = KIND != KV_FP;
  constexpr int VEC = St::VEC, DIMS = St::DIMS, ROWS = St::ROWS;
  constexpr int RPL = ROWS / 8;                 // stored rows a lane reads
  constexpr int TILE = OQ_COLS * VEC;           // positions of a warp's tile
  constexpr int TILES = OQ_CHUNK / TILE;        // tiles a chunk
  constexpr int NV = VEC >= 8 ? VEC / 8 : 1;    // scores a lane holds
  __shared__ float rec[OQ_WARPS][REC];          // each warp's (o, m, l)
  __shared__ __align__(16) float pbuf[OQ_WARPS][TILE];
  __shared__ float brec[REC];                   // the block's (o, m, l)
  cg::cluster_group cluster = cg::this_cluster();
  const int g = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank(), splits = (int)cluster.num_blocks();
  const int cc = lane & 3, rg = lane >> 2;      // chunk column, first stored row
  const int base = owc_scatter_base<VEC, 16, 4>(lane); // where this lane's scores lie
  // VEC = 4: the lanes that differ in bit 2 hold the same scores; one counts
  const bool own = VEC >= 8 || !(lane & 4);
  const T* kg = k_t + (size_t)g * ROWS * S_pad;
  const T* vg = v_t + (size_t)g * ROWS * S_pad;
  const float* ksg = SCALED ? k_scale + (size_t)g * S_pad : nullptr;
  const float* vsg = SCALED ? v_scale + (size_t)g * S_pad : nullptr;

  // the block's chunks, their tiles that hold a valid position, this warp's
  const int nch = (s_valid + OQ_CHUNK - 1) / OQ_CHUNK;
  const int t_lo = rank * nch / splits * TILES;
  const int t_hi = min((rank + 1) * nch / splits * TILES, (s_valid + TILE - 1) / TILE);
  const int nj = max(0, (t_hi - t_lo - warp + OQ_WARPS - 1) / OQ_WARPS);
  auto tile_pos = [&](int j) { return (t_lo + warp + j * OQ_WARPS) * TILE; };

  float qr[RPL][DIMS];
#pragma unroll
  for (int i = 0; i < RPL; ++i)
#pragma unroll
    for (int d = 0; d < DIMS; ++d) qr[i][d] = owc_to_float(q[(size_t)g * DH + rg + 8 * i + d * ROWS]);

  // tile j's K and V pieces of this lane (zeros for a column past s_valid)
  // and the scales of the positions whose scores it will hold
  auto load = [&](int j, uint4 (&kx)[RPL], uint4 (&vx)[RPL], float (&ksx)[NV],
                  float (&vsx)[NV]) {
    const int p0 = tile_pos(j) + cc * VEC;
    const bool on = p0 < s_valid;
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const size_t off = (size_t)(rg + 8 * i) * S_pad + p0;
      kx[i] = on ? __ldg(reinterpret_cast<const uint4*>(kg + off)) : make_uint4(0, 0, 0, 0);
      vx[i] = on ? __ldg(reinterpret_cast<const uint4*>(vg + off)) : make_uint4(0, 0, 0, 0);
    }
    if constexpr (SCALED) {
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        const int p = p0 + base + e;
        ksx[e] = p < s_valid ? __ldg(ksg + p) : 0.0f;
        vsx[e] = p < s_valid ? __ldg(vsg + p) : 0.0f;
      }
    }
  };

  float m_run = -INFINITY, l_run = 0.0f;
  float acc[RPL][DIMS];
#pragma unroll
  for (int i = 0; i < RPL; ++i)
#pragma unroll
    for (int d = 0; d < DIMS; ++d) acc[i][d] = 0.0f;
  uint4 kr[RPL], vr[RPL], kn[RPL], vn[RPL];
  float ksr[NV], vsr[NV], ksn[NV], vsn[NV];
  if (nj > 0) load(0, kr, vr, ksr, vsr);
#pragma unroll 1
  for (int j = 0; j < nj; ++j) {
    if (j + 1 < nj) load(j + 1, kn, vn, ksn, vsn);  // in flight under this tile
    const int t0 = tile_pos(j), p0 = t0 + cc * VEC;
    float part[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) part[v] = 0.0f;
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      float kv[DIMS][VEC];
      St::decode(kr[i], kv);
#pragma unroll
      for (int d = 0; d < DIMS; ++d)
#pragma unroll
        for (int v = 0; v < VEC; ++v) part[v] = fmaf(qr[i][d], kv[d][v], part[v]);
    }
    owc_reduce_scatter<16, 4>(part, lane);
    float x[NV], mt = -INFINITY;
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const float s = SCALED ? part[e] * ksr[e] : part[e];
      x[e] = p0 + base + e < s_valid ? s * LOG2E : -INFINITY;
      mt = fmaxf(mt, x[e]);
    }
    // finite: a tile's first position is valid
    const float mn = fmaxf(m_run, owc_warp_max(mt));
    const float corr = ex2(m_run - mn);
    m_run = mn;
    float ls = 0.0f;
    __syncwarp();  // the previous tile's probabilities have been read
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const float pr = ex2(x[e] - mn);  // 0 past s_valid
      if (own) {
        ls += pr;
        // the v scale folds in after l; past s_valid the scale is never read
        pbuf[warp][cc * VEC + base + e] = SCALED ? pr * vsr[e] : pr;
      }
    }
    l_run = l_run * corr + owc_warp_sum(ls);
    __syncwarp();
    float pv[VEC];
#pragma unroll
    for (int v = 0; v < VEC; v += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(&pbuf[warp][cc * VEC + v]);
      pv[v] = p4.x;
      pv[v + 1] = p4.y;
      pv[v + 2] = p4.z;
      pv[v + 3] = p4.w;
    }
    const bool straddles = !SCALED && p0 + VEC > s_valid;  // fp padding may hold inf
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      float vv[DIMS][VEC];
      St::decode(vr[i], vv);
      if (straddles) {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          if (p0 + v >= s_valid) vv[0][v] = 0.0f;
      }
#pragma unroll
      for (int d = 0; d < DIMS; ++d) {
        float a = acc[i][d] * corr;
#pragma unroll
        for (int v = 0; v < VEC; ++v) a = fmaf(pv[v], vv[d][v], a);
        acc[i][d] = a;
      }
    }
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      kr[i] = kn[i];
      vr[i] = vn[i];
    }
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      ksr[e] = ksn[e];
      vsr[e] = vsn[e];
    }
  }

  // the warp's sums over its 4 chunk columns, then its record
#pragma unroll
  for (int i = 0; i < RPL; ++i)
#pragma unroll
    for (int d = 0; d < DIMS; ++d) {
      float a = acc[i][d];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      if (cc == 0) rec[warp][rg + 8 * i + d * ROWS] = a;
    }
  if (lane == 0) {
    rec[warp][DH] = m_run;
    rec[warp][DH + 1] = l_run;
  }
  __syncthreads();
  // the block's warps, in order (every block has a valid tile: m finite)
  if (tid < DH) {
    float big = -INFINITY;
#pragma unroll
    for (int w = 0; w < OQ_WARPS; ++w) big = fmaxf(big, rec[w][DH]);
    float l = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < OQ_WARPS; ++w) {
      const float m = rec[w][DH];
      if (m == -INFINITY) continue;  // a warp that had no tile
      const float wgt = ex2(m - big);
      l = fmaf(rec[w][DH + 1], wgt, l);
      a = fmaf(rec[w][tid], wgt, a);
    }
    brec[tid] = a;
    if (tid == 0) {
      brec[DH] = big;
      brec[DH + 1] = l;
    }
  }
  // the cluster's blocks, in rank order; block r writes the dims d % splits == r
  cluster.sync();
  if (tid < DH && tid % splits == rank) {
    float big = -INFINITY;
    for (int sp = 0; sp < splits; ++sp) big = fmaxf(big, cluster.map_shared_rank(brec, sp)[DH]);
    float l = 0.0f, a = 0.0f;
    for (int sp = 0; sp < splits; ++sp) {
      const float* r = cluster.map_shared_rank(brec, sp);
      const float wgt = ex2(r[DH] - big);
      l = fmaf(r[DH + 1], wgt, l);
      a = fmaf(r[tid], wgt, a);
    }
    owc_store(out + (size_t)g * DH + tid, a / l);
  }
  cluster.sync();  // no block leaves while another still reads its record
}

template <int KIND, typename Q>
int launch_one_query(const void* q, const void* k_t, const void* v_t, const void* k_scale,
                     const void* v_scale, void* out, int BH, int splits, int S_pad,
                     int s_valid, cudaStream_t st) {
  using T = typename Store<KIND, Q>::T;
  if (splits < 1 || splits > 8 || splits > (s_valid + OQ_CHUNK - 1) / OQ_CHUNK)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BH, splits);
  cfg.blockDim = dim3(OQ_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, cross_attn_one_query_kernel<KIND, Q>, static_cast<const Q*>(q),
      static_cast<const T*>(k_t), static_cast<const T*>(v_t),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<Q*>(out), S_pad, s_valid);
  if (e != cudaSuccess) return (int)e;
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
// above. splits: the blocks (1..8) of the thread block cluster that shares a
// row, each given at least one 64-position chunk of it. Requires 1 <= s_valid
// <= S_pad, S_pad a multiple of the kind's 16-byte chunk, 16-byte aligned
// k_t/v_t.
extern "C" int owc_cross_attention(const void* q, const void* k_t,
                                   const void* v_t, const void* k_scale,
                                   const void* v_scale, void* out, int BH,
                                   int splits, int S_pad, int s_valid, int kind,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  const bool ok = dispatch(kind, dtype, [&](auto kind_tag, auto qt) {
    err = launch_one_query<decltype(kind_tag)::value, decltype(qt)>(
        q, k_t, v_t, k_scale, v_scale, out, BH, splits, S_pad, s_valid, st);
  });
  return ok ? err : (int)cudaErrorInvalidValue;
}
