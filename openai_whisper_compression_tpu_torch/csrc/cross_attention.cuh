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
//   (PERF.md, row 9). Pieces that straddle s_valid are zero filled past it:
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
// An int4 row d holds dim d in the low nibble and dim d + Dh/2 in the high
// nibble (both signed), so it yields two head dims. The TPU
// kernel takes any slot count; here a window longer than 8 slots is several
// launches, each over its own slots of q and out (hence the row stride),
// each reading K/V again.
//
// Head dims: every body is a template on DH, one of 16, 32, 64 and 128
// (the TPU kernels take any; every Whisper size has 64, the test models
// 16). This header holds the templates; `cross_attention.cu` holds the C
// entry points and the DH = 64 instances, and each of
// `cross_attention_d{16,32,128}.cu` the instances of one other head dim
// (one nvcc process each, so the build runs them side by side). What
// depends on DH: the 16-bit body's k steps over q (DH / 16) and its output
// tiles (DH / 8); split-half int4 at DH = 16 holds both nibble halves of a
// k step in one 8-row tile, so that body reads the low and the high
// nibbles of the same rows; the f32 body gives a lane DH / 32 value dims
// (one, half the lanes idle, at DH = 16), and at DH = 128 runs 2 warps a
// block (the PR that added it; since repaired, below); the one-query
// kernel's lane holds DH / 8 stored rows, and at DH = 128 stops loading the
// next tile under this one (its 16 rows of K and V would take every
// register).
//
// Any other head dim dh up to 256 runs the RAGGED instance of its capacity
// (the smallest of 16, 32, 64, 128, 256 >= dh; one `.cu` file a capacity,
// `cross_attention_r*.cu`), which takes dh at run time. K/V are stored
// (BH, dh, S_pad) and int4 as dh / 2 rows, so the width changes only the
// number of stored rows: a RAGGED body loads the rows < dh (dh / 2) into the
// capacity's tiles, whose rows past them its copies zero fill,
// reads q through `dim_of` (zeros past dh; split-half int4's high nibbles
// are dims + dh / 2, so they sit at capacity dims + DH / 2) and writes its
// records and the output at dims < dh only. The capacity sets the stages:
// 256 dims of 16-bit K/V take 16-position chunks (a 32-position stage
// would leave room for 2 warps a block), and int8 at 256 two stages.
// The f32 body at DH = 128 and 256 and every RAGGED f32 body is a second
// f32 body (`F32B`): the first kept a warp's whole 32-position stages of
// f32 K/V (32 KB at DH = 128) and its codes converted into f32 tiles, so at
// DH = 128 it ran 2 warps a block and spilled, 3x slower than its plain
// version. The second takes 8 positions a stage of f32 K/V (a position's
// dims split over 4 lanes, the partial scores summed by shuffles; int8 and
// int4 keep 32-position stages), reads the codes from their stored tiles as
// it multiplies (no converted tiles), keeps its partials in its drained
// stages, runs 4 warps a block, two blocks an SM at DH = 128, and has a
// loop of its own for one slot (a greedy step: no slot predicates, q in
// registers).
// A head dim past 256 runs the WIDE body of cross_attention_wide.cu, which
// walks the head dim in chunks (no template here).
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using BF = __nv_bfloat16;

// storage kinds, codes shared with ops/cross_attention.py: K/V in q's own
// type, int8 with scales, split-half packed int4 with scales
enum Kind { KV_FP = 0, KV_INT8 = 1, KV_INT4 = 2 };

// How a kind stores one (DH, S_pad) K or V slab: ROWS stored rows of S_pad
// elements; one 16-byte load holds VEC consecutive positions of a row, and
// each stored row carries DIMS head dims (row r holds dims r + i * ROWS).
// Q is q's element type, which is also the stored type of the KV_FP kind.
template <int KIND, typename Q, int DH> struct Store;

template <typename Q, int DH> struct Store<KV_FP, Q, DH> {
  using T = Q;
  static constexpr int ROWS = DH, VEC = 16 / sizeof(Q), DIMS = 1;
  __device__ static void load(const T* p, float out[DIMS][VEC]) {
    decode(*reinterpret_cast<const uint4*>(p), out);
  }
  __device__ static void decode(const uint4& u, float out[DIMS][VEC]) {
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[0][i] = owc_to_float(e[i]);
  }
};

template <typename Q, int DH> struct Store<KV_INT8, Q, DH> {
  using T = int8_t;
  static constexpr int ROWS = DH, VEC = 16, DIMS = 1;
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

template <typename Q, int DH> struct Store<KV_INT4, Q, DH> {
  using T = int8_t;
  static constexpr int ROWS = DH / 2, VEC = 16, DIMS = 2;
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
constexpr int G_MAXQ = 8;     // slots a launch holds
constexpr float LOG2E = 1.4426950408889634f;

// Tiles of a chunk, [DH dims][G_CHUNK positions], in the stored type: rows
// of 64 bytes (16-bit), 128 (f32) or 32 (int8 and int4 codes), their 16-byte
// chunks XOR-swizzled by the row so that the 8 rows an ldmatrix matrix reads
// at one column, or the rows a warp reads at one position, fall on distinct
// banks, with no padding to waste the shared memory that holds the bytes in
// flight.
// A tile of ROWB-byte rows (a chunk of one stored row); the swizzle of each
// width spreads 8 neighbouring rows over distinct banks.
template <int ROWB> struct Swz;
template <> struct Swz<128> {
  static constexpr int ROW = 128;
  __device__ static int off(int d, int chunk) { return d * ROW + ((chunk ^ (d & 7)) << 4); }
};
template <> struct Swz<64> {
  static constexpr int ROW = 64;
  __device__ static int off(int d, int chunk) {
    return d * ROW + ((chunk ^ ((d >> 1) & 3)) << 4);
  }
};
template <> struct Swz<32> {
  static constexpr int ROW = 32;
  __device__ static int off(int d, int chunk) {
    return d * ROW + ((chunk ^ ((d >> 2) & 1)) << 4);
  }
};
// the tile of CH positions of element type C: 16-bit 64-byte rows, f32 128,
// int8 and int4 codes 32 at CH = 32
template <typename C, int CH = G_CHUNK> struct Tile : Swz<CH * (int)sizeof(C)> {};

// The dim of q and of the output that capacity dim c of a DH-wide body
// stands for, at head dim dh; -1 where it stands for none (past dh). Split-
// half int4 rows hold dims r and r + dh / 2, which a capacity body holds at
// r and r + DH / 2.
template <int KIND, int DH>
__device__ __forceinline__ int dim_of(int c, int dh) {
  if constexpr (KIND == KV_INT4) {
    constexpr int CR = DH / 2;
    const int r = c % CR, rows = dh / 2;
    return r < rows ? r + (c / CR) * rows : -1;
  } else {
    return c < dh ? c : -1;
  }
}

// A warp's shared memory: NS stages, each the chunk's K and V as stored (in
// q's type already laid out as its compute tile; int8 and int4 as 32-byte
// rows) and, for the scaled kinds, the chunk's k and v scales; then the
// compute tiles the scaled kinds are converted into.
template <int KIND, typename Q, int DH, bool RAGGED = false> struct GLayout {
  static constexpr bool SCALED = KIND != KV_FP;
  static constexpr bool F32 = std::is_same<Q, float>::value;
  // the second f32 body (header): f32 q at DH >= 128 or RAGGED
  static constexpr bool F32B = F32 && (RAGGED || DH >= 128);
  // positions a warp takes at a time: 32, but 16 for 16-bit K/V at DH =
  // 256 (a 32-position stage would pass 16 KB), and 8 for f32 K/V in the
  // second f32 body (stages of 0.5-16 KB: two blocks an SM at 128; 4
  // positions at 256, two blocks an SM, measured slower)
  static constexpr int CHUNK = SCALED ? G_CHUNK
                               : F32B ? 8
                               : 2 * G_CHUNK * DH * (int)sizeof(Q) > 16384 ? 16
                                                                          : G_CHUNK;
  using Raw = Tile<typename Store<KIND, Q, DH>::T, CHUNK>;
  static constexpr int TILE = DH * Tile<Q>::ROW;                    // a compute tile
  static constexpr int RAW = Store<KIND, Q, DH>::ROWS * Raw::ROW;   // one of K, V
  static constexpr int SCALES = 2 * RAW;                            // offset in a stage
  static constexpr int STAGE = 2 * RAW + (SCALED ? 2 * G_CHUNK * 4 : 0);
  // the first f32 body converts int8 and int4 codes into f32 compute tiles
  static constexpr bool CONVERT = SCALED && F32 && !F32B;
  static constexpr int WARPS = 4;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int REC = DH + 2;  // a warp's partial of one slot: DH sums, m, l
  // a warp's record room: its slots' partials, which the f32 bodies also
  // use for their [slot][CHUNK] probabilities; the second f32 body keeps its
  // partials in its own stages once they are drained (RECS floats apart)
  // and only the probabilities in the static room
  static constexpr int RECW = G_MAXQ * REC > G_MAXQ * CHUNK ? G_MAXQ * REC
                                                             : G_MAXQ * CHUNK;
  static constexpr int RECW_STATIC = F32B ? G_MAXQ * CHUNK : RECW;
  static constexpr int STATIC = (WARPS * RECW_STATIC + (F32 ? G_MAXQ : 1) * DH) * 4;
  // chunks in flight while one is used: an SM holds 8-16 warps, whose
  // stages in flight must cover the card's memory latency at its rate; 2
  // where 3 would not fit in a block's 227 KB (int8 and f32 at DH = 256)
  static constexpr int NS_MOST = SCALED || sizeof(Q) == 4 ? 3 : 2;
  static constexpr int NS =
      WARPS * (NS_MOST * STAGE + (CONVERT ? 2 * TILE : 0)) + STATIC > 232448 ? 2 : NS_MOST;
  static constexpr int WARP = NS * STAGE + (CONVERT ? 2 * TILE : 0);
  static constexpr int RECS = F32B ? WARP / 4 : RECW;   // floats between warps' partials
  static_assert(!F32B || WARP >= G_MAXQ * REC * 4, "the partials fit in the stages");
  static_assert(!SCALED || CHUNK == G_CHUNK, "scaled kinds load 32-position chunks");
  static_assert(WARPS * WARP + STATIC <= 232448, "a block's shared memory");
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

// RAGGED: the capacity-DH body of head dim dh (< DH, or = DH = 256).
template <int KIND, typename Q, int DH, bool RAGGED>
__global__ void __launch_bounds__(GLayout<KIND, Q, DH, RAGGED>::THREADS)
cross_attn_grouped_kernel(const Q* __restrict__ q,
                          const typename Store<KIND, Q, DH>::T* __restrict__ k_t,
                          const typename Store<KIND, Q, DH>::T* __restrict__ v_t,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          Q* __restrict__ out, int KQ, int row_stride,
                          int S_pad, int s_valid, int dh) {
  using L = GLayout<KIND, Q, DH, RAGGED>;
  using St = Store<KIND, Q, DH>;
  using T = typename St::T;
  constexpr bool F32 = L::F32;
  constexpr int NS = L::NS, G_WARPS = L::WARPS, G_THREADS = L::THREADS;
  constexpr int REC = L::REC, RECW = L::RECW, CH = L::CHUNK;
  // the head dim of q, the output and the stored rows; the rows loaded
  const int dhr = RAGGED ? dh : DH;
  const int rows = RAGGED ? (KIND == KV_INT4 ? dh / 2 : dh) : St::ROWS;
  constexpr int KS = DH / 16;   // k steps of 16 dims over q (16-bit body)
  constexpr int OT = DH / 8;    // 8-dim output tiles (16-bit body)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float rec[G_WARPS][L::RECW_STATIC];  // [slot][REC] partials a warp
  __shared__ float qs[F32 ? G_MAXQ : 1][DH];  // the f32 body's slots
  cg::cluster_group cluster = cg::this_cluster();
  const int g = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank(), splits = (int)cluster.num_blocks();
  const T* kg = k_t + (size_t)g * rows * S_pad;
  const T* vg = v_t + (size_t)g * rows * S_pad;
  const float* ksg = L::SCALED ? k_scale + (size_t)g * S_pad : nullptr;
  const float* vsg = L::SCALED ? v_scale + (size_t)g * S_pad : nullptr;
  const Q* qg = q + (size_t)g * row_stride;

  // this warp's chunks: the block's share of the row, then the warp's
  const int nch = (s_valid + CH - 1) / CH;
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
  // read); RAGGED: the stage rows past the stored rows are zero filled too
  // (q is zero there, and 0 x garbage may be NaN), so the copies are the
  // whole body's, at the capacity's rows
  auto load = [&](int j, int i) {
    if (j < nj) {
      const int s0 = chunk_of(j) * CH;
      const uint32_t st = wsm_u + i * L::STAGE;
      constexpr int VEC = St::VEC, E = 16 / VEC;  // positions a piece, bytes each
      constexpr int PPR = CH / VEC;               // pieces a stored row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const T* src = (h ? vg : kg) + s0;
#pragma unroll
        for (int p = lane; p < St::ROWS * PPR; p += 32) {
          const int r = p / PPR, pc = p % PPR;
          const bool in = !RAGGED || r < rows;
          const int dst = st + h * L::RAW + L::Raw::off(r, pc);
          if (s0 + CH <= s_valid) {  // a whole chunk: no piece straddles s_valid
            cp_async16_line(dst, in ? src + (size_t)r * S_pad + pc * VEC : src, in ? 16 : 0);
          } else {
            const int bytes = in ? max(0, min(16, (s_valid - s0 - pc * VEC) * E)) : 0;
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
    constexpr int NT = CH / 8;  // 8-position score tiles of a chunk
    uint32_t qa[KS][4];
    // RAGGED: the 16 bits of q's capacity dim c (zero past dh)
    auto q16 = [&](int c) -> uint32_t {
      const int d = dim_of<KIND, DH>(c, dh);
      return d >= 0 ? (uint32_t)reinterpret_cast<const unsigned short*>(qg + gq * dh)[d] : 0u;
    };
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const bool on = gq < KQ;
      if constexpr (RAGGED) {
        const int c = ks * 16 + 2 * t4;
        qa[ks][0] = on ? q16(c) | (q16(c + 1) << 16) : 0u;
        qa[ks][2] = on ? q16(c + 8) | (q16(c + 9) << 16) : 0u;
      } else {
        const Q* qp = qg + gq * DH + ks * 16 + 2 * t4;
        qa[ks][0] = on ? *reinterpret_cast<const uint32_t*>(qp) : 0u;
        qa[ks][2] = on ? *reinterpret_cast<const uint32_t*>(qp + 8) : 0u;
      }
      qa[ks][1] = 0u;
      qa[ks][3] = 0u;
    }
    // the chunk position of score tile n (two per 16 positions), element e
    auto pos_of = [&](int n, int e) {
      return L::SCALED ? (n >> 1) * 16 + 4 * t4 + 2 * e + (n & 1)
                       : (n >> 1) * 16 + (n & 1) * 8 + 2 * t4 + e;
    };
    float o[OT][4];
#pragma unroll
    for (int n = 0; n < OT; ++n)
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
      float sc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
      if constexpr (!L::SCALED) {
#pragma unroll
        for (int h = 0; h < CH / 16; ++h)
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            uint32_t b[4];  // [d lo, d hi] x [positions 16h .. + 7, + 8 .. + 15]
            ldmatrix_x4_trans(b, kt + L::Raw::off(ks * 16 + (mi & 1) * 8 + mr,
                                                  h * 2 + (mi >> 1)));
            mma16(sc[2 * h], qa[ks], b[0], b[1], Q());
            mma16(sc[2 * h + 1], qa[ks], b[2], b[3], Q());
          }
      } else if constexpr (St::ROWS >= 16) {
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
                // int4: the high nibbles are dims + DH / 2
                const int ks = kr + nib * (St::ROWS / 16);
                mma16(sc[2 * h + odd], qa[ks], code_pair<KIND>(b[2 * h], odd, nib, Q()),
                      code_pair<KIND>(b[2 * h + 1], odd, nib, Q()), Q());
              }
        }
      } else {
        // int4 at DH = 16: the 8 stored rows hold the k step's dims 0-7 in
        // their low nibbles and dims 8-15 in their high ones, so one 8-row
        // matrix gives both halves of B ([rows 0-7] x [positions 0 .. 15,
        // 16 .. 31], each taken twice by the x4 load)
        uint32_t b[4];
        ldmatrix_x4_trans(b, kt + L::Raw::off(mr, mi & 1));
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int odd = 0; odd < 2; ++odd)
            mma16(sc[2 * h + odd], qa[0], code_pair<KIND>(b[h], odd, 0, Q()),
                  code_pair<KIND>(b[h], odd, 1, Q()), Q());
      }
      // online softmax of slot gq over the chunk's CH positions, in base 2
      // (this thread: CH / 4 of them; the 4 lanes of a slot hold the rest)
      const int s0 = chunk_of(j) * CH;
      const float* scl = L::SCALED ? scales(i) : nullptr;
      float x[NT][2], mt = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n)
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
      uint32_t pa[CH / 16][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
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
      for (int n = 0; n < OT; ++n) {
        o[n][0] *= corr;
        o[n][1] *= corr;
      }
      if constexpr (!L::SCALED) {
#pragma unroll
        for (int h = 0; h < CH / 16; ++h)
#pragma unroll
          for (int dp = 0; dp < DH / 16; ++dp) {
            uint32_t b[4];  // [dims 16dp .. + 7, + 8 .. + 15] x [positions lo, hi]
            ldmatrix_x4(b, vt + L::Raw::off((2 * dp + (mi >> 1)) * 8 + mr, h * 2 + (mi & 1)));
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
              mma16(o[dt + nib * (St::ROWS / 8)], pa[h], code_pair<KIND>(w, 0, nib, Q()),
                    code_pair<KIND>(w, 1, nib, Q()), Q());
          }
      }
    }
    cp_async_wait<0>();
    float l = l_run[0];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    float* r = &rec[warp][gq * REC];
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      if constexpr (RAGGED) {  // at the dims they stand for
        const int d0 = dim_of<KIND, DH>(n * 8 + 2 * t4, dh);
        const int d1 = dim_of<KIND, DH>(n * 8 + 2 * t4 + 1, dh);
        if (d0 >= 0) r[d0] = o[n][0];
        if (d1 >= 0) r[d1] = o[n][1];
      } else {
        r[n * 8 + 2 * t4] = o[n][0];
        r[n * 8 + 2 * t4 + 1] = o[n][1];
      }
    }
    if (t4 == 0) {
      r[DH] = m_run[0];
      r[DH + 1] = l;
    }
  } else if constexpr (L::F32B) {
    // ---- f32 q, the second body: CUDA cores, f32 arithmetic ----
    // q's slots by capacity dim (zeros past dh) in shared memory
    for (int e = tid; e < G_MAXQ * DH; e += G_THREADS) {
      const int jq = e / DH, c = e % DH;
      const int d = RAGGED ? dim_of<KIND, DH>(c, dh) : c;
      qs[jq][c] = jq < KQ && d >= 0 ? qg[jq * dhr + d] : 0.0f;
    }
    __syncthreads();
    float* ps = rec[warp];  // [slot][CH] probabilities
    // scores: R lanes a position, lane = (position sp, dims sg + R i)
    constexpr int R = 32 / CH;
    const int sp = lane % CH, sg = lane / CH;
    // value dims of this lane: lane + 32 i (at DH = 16 lanes 16-31 repeat
    // lanes 0-15's dims and keep nothing)
    constexpr int DPL = DH >= 32 ? DH / 32 : 1;
    const int dl = lane & (DH >= 32 ? 31 : DH - 1);
    using Raw = typename L::Raw;
    // K at capacity dim c, chunk position s, of a stage's stored K tile
    auto kval = [&](const unsigned char* kt, int c, int s) -> float {
      if constexpr (KIND == KV_FP) {
        return *reinterpret_cast<const float*>(kt + Raw::off(c, s >> 2) + (s & 3) * 4);
      } else if constexpr (KIND == KV_INT8) {
        return (float)*reinterpret_cast<const int8_t*>(kt + Raw::off(c, s >> 4) + (s & 15));
      } else {
        constexpr int CR = DH / 2;
        const int b = *reinterpret_cast<const int8_t*>(kt + Raw::off(c % CR, s >> 4) + (s & 15));
        return (float)(c < CR ? ((b & 15) ^ 8) - 8 : b >> 4);
      }
    };
    // V at capacity dim c, chunk positions 4 pq .. + 3
    auto vval4 = [&](const unsigned char* vt, int c, int pq, float (&v)[4]) {
      if constexpr (KIND == KV_FP) {
        const float4 f = *reinterpret_cast<const float4*>(vt + Raw::off(c, pq));
        v[0] = f.x;
        v[1] = f.y;
        v[2] = f.z;
        v[3] = f.w;
      } else if constexpr (KIND == KV_INT8) {
        owc_int8x4_to_float(
            *reinterpret_cast<const uint32_t*>(vt + Raw::off(c, pq >> 2) + (pq & 3) * 4), v);
      } else {
        constexpr int CR = DH / 2;
        owc_int4x4_to_float(
            *reinterpret_cast<const uint32_t*>(vt + Raw::off(c % CR, pq >> 2) + (pq & 3) * 4),
            c < CR ? 0 : 4, v);
      }
    };
    // the main loop over MQ slots: 1 where the launch holds one (a greedy
    // step: no slot predicates, and q in registers where a lane's dims are
    // at most 64), else G_MAXQ
    auto run = [&](auto mq_tag) {
      constexpr int MQ = decltype(mq_tag)::value;
      constexpr bool QREG = MQ == 1 && DH / R <= 64;
      auto on = [&](int jq) { return MQ == 1 || jq < KQ; };
      float qreg[QREG ? DH / R : 1];
      if constexpr (QREG) {
#pragma unroll
        for (int ii = 0; ii < DH / R; ++ii) qreg[ii] = qs[0][ii * R + sg];
      }
      float o[MQ][DPL];
#pragma unroll
      for (int jq = 0; jq < MQ; ++jq)
#pragma unroll
        for (int i = 0; i < DPL; ++i) o[jq][i] = 0.0f;
#pragma unroll
      for (int i = 0; i < NS - 1; ++i) load(i, i);
      for (int j = 0; j < nj; ++j) {
        const int i = j % NS;
        cp_async_wait<NS - 2>();
        __syncwarp();
        load(j + NS - 1, (j + NS - 1) % NS);
        const unsigned char* kt = wsm + i * L::STAGE;
        const unsigned char* vt = kt + L::RAW;
        float acc[MQ];
#pragma unroll
        for (int jq = 0; jq < MQ; ++jq) acc[jq] = 0.0f;
        if constexpr (QREG) {   // unrolled whole: qreg stays in registers
#pragma unroll
          for (int ii = 0; ii < DH / R; ++ii)
            acc[0] = fmaf(qreg[ii], kval(kt, ii * R + sg, sp), acc[0]);
        } else {
#pragma unroll 8
          for (int ii = 0; ii < DH / R; ++ii) {
            const int c = ii * R + sg;
            const float kv = kval(kt, c, sp);
#pragma unroll
            for (int jq = 0; jq < MQ; ++jq)
              if (on(jq)) acc[jq] = fmaf(qs[jq][c], kv, acc[jq]);
          }
        }
#pragma unroll
        for (int jq = 0; jq < MQ; ++jq)
#pragma unroll
          for (int o2 = CH; o2 < 32; o2 <<= 1)
            if (on(jq)) acc[jq] += __shfl_xor_sync(0xffffffffu, acc[jq], o2);
        const int pos = chunk_of(j) * CH + sp;
        const bool valid = pos < s_valid;
        const float* scl = L::SCALED ? scales(i) : nullptr;
        __syncwarp();  // the previous chunk's probabilities have been read
#pragma unroll
        for (int jq = 0; jq < MQ; ++jq) {
          if (on(jq)) {
            const float x = valid ? (L::SCALED ? acc[jq] * scl[sp] : acc[jq]) : -INFINITY;
            const float mn = fmaxf(m_run[jq], owc_warp_max(x));
            const float corr = expf(m_run[jq] - mn);
            m_run[jq] = mn;
            const float p = expf(x - mn);
            l_run[jq] = l_run[jq] * corr + owc_warp_sum(sg == 0 ? p : 0.0f);
            if (sg == 0)
              ps[jq * CH + sp] = L::SCALED ? (valid ? p * scl[CH + sp] : 0.0f) : p;
#pragma unroll
            for (int i2 = 0; i2 < DPL; ++i2) o[jq][i2] *= corr;
          }
        }
        __syncwarp();
        // values: lane = head dims lane + 32 i
#pragma unroll
        for (int pq = 0; pq < CH / 4; ++pq) {
          float v[DPL][4];
#pragma unroll
          for (int i2 = 0; i2 < DPL; ++i2) vval4(vt, dl + 32 * i2, pq, v[i2]);
#pragma unroll
          for (int jq = 0; jq < MQ; ++jq) {
            if (on(jq)) {
              const float4 p = *reinterpret_cast<const float4*>(ps + jq * CH + pq * 4);
#pragma unroll
              for (int i2 = 0; i2 < DPL; ++i2)
                o[jq][i2] = fmaf(p.x, v[i2][0],
                                 fmaf(p.y, v[i2][1],
                                      fmaf(p.z, v[i2][2], fmaf(p.w, v[i2][3], o[jq][i2]))));
            }
          }
        }
      }
      cp_async_wait<0>();
      __syncwarp();  // the drained stages become the warp's record
      float* wrec = reinterpret_cast<float*>(wsm);
#pragma unroll
      for (int jq = 0; jq < MQ; ++jq) {
        if (on(jq)) {
#pragma unroll
          for (int i2 = 0; i2 < DPL; ++i2) {
            const int c = lane + 32 * i2;
            const int d = RAGGED ? dim_of<KIND, DH>(c, dh) : c;
            if (c < DH && d >= 0) wrec[jq * REC + d] = o[jq][i2];
          }
          if (lane == 0) {
            wrec[jq * REC + DH] = m_run[jq];
            wrec[jq * REC + DH + 1] = l_run[jq];
          }
        }
      }
    };
    if (KQ == 1) run(std::integral_constant<int, 1>());
    else run(std::integral_constant<int, G_MAXQ>());
  } else {
    // ---- f32 q, the first body (whole DH <= 64): CUDA cores, f32 ----
    for (int e = tid; e < G_MAXQ * DH; e += G_THREADS)
      qs[e / DH][e % DH] = e / DH < KQ ? qg[e] : 0.0f;
    __syncthreads();
    float* ps = rec[warp];  // [slot][32] probabilities
    // value dims of this lane: lane + 32 i (at DH = 16 lanes 16-31 repeat
    // lanes 0-15's dims and keep nothing)
    constexpr int DPL = DH >= 32 ? DH / 32 : 1;
    const int dl = lane & (DH >= 32 ? 31 : DH - 1);
    float o[G_MAXQ][DPL];
#pragma unroll
    for (int j = 0; j < G_MAXQ; ++j)
#pragma unroll
      for (int i = 0; i < DPL; ++i) o[j][i] = 0.0f;
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
#pragma unroll
          for (int i = 0; i < DPL; ++i) o[j][i] *= corr;
        }
      }
      __syncwarp();
      // values: lane = head dims lane + 32 i
#pragma unroll
      for (int pq = 0; pq < G_CHUNK / 4; ++pq) {
        float4 v[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          v[i] = *reinterpret_cast<const float4*>(vt + Tile<float>::off(dl + 32 * i, pq));
#pragma unroll
        for (int j = 0; j < G_MAXQ; ++j) {
          if (j < KQ) {
            const float4 p = *reinterpret_cast<const float4*>(ps + j * G_CHUNK + pq * 4);
#pragma unroll
            for (int i = 0; i < DPL; ++i)
              o[j][i] = fmaf(p.x, v[i].x,
                             fmaf(p.y, v[i].y, fmaf(p.z, v[i].z, fmaf(p.w, v[i].w, o[j][i]))));
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncwarp();  // the probabilities' room becomes the warp's record
#pragma unroll
    for (int j = 0; j < G_MAXQ; ++j) {
      if (j < KQ) {
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          if (lane + 32 * i < DH) rec[warp][j * REC + lane + 32 * i] = o[j][i];
        if (lane == 0) {
          rec[warp][j * REC + DH] = m_run[j];
          rec[warp][j * REC + DH + 1] = l_run[j];
        }
      }
    }
  }

  // every warp's record of every block of the row, combined in a fixed order
  // (rank, then warp): no atomics, the same bits from run to run
  cluster.sync();
  float* recs = L::F32B ? reinterpret_cast<float*>(smem) : &rec[0][0];
  for (int e = rank * G_THREADS + tid; e < KQ * dhr; e += splits * G_THREADS) {
    const int j = e / dhr, d = e % dhr;
    float big = -INFINITY;
    for (int sp = 0; sp < splits; ++sp) {
      const float* rr = &cluster.map_shared_rank(recs, sp)[j * REC];
#pragma unroll
      for (int w = 0; w < G_WARPS; ++w) big = fmaxf(big, rr[w * L::RECS + DH]);
    }
    float l = 0.0f, acc = 0.0f;
    for (int sp = 0; sp < splits; ++sp) {
      const float* rr = &cluster.map_shared_rank(recs, sp)[j * REC];
#pragma unroll
      for (int w = 0; w < G_WARPS; ++w) {
        const float* x = rr + w * L::RECS;
        const float m = x[DH];
        if (m == -INFINITY) continue;  // a warp that had no chunk
        const float wgt = F32 ? expf(m - big) : ex2(m - big);  // m in base 2 but for f32
        l = fmaf(x[DH + 1], wgt, l);
        acc = fmaf(x[d], wgt, acc);
      }
    }
    owc_store(out + (size_t)g * row_stride + j * dhr + d, acc / l);
  }
  cluster.sync();  // no block leaves while another still reads its records
}

template <int KIND, typename Q, int DH, bool RAGGED>
int launch(const void* q, const void* k_t, const void* v_t, const void* k_scale,
           const void* v_scale, void* out, int BH, int KQ, int row_stride,
           int S_pad, int s_valid, int splits, int dh, cudaStream_t st) {
  using T = typename Store<KIND, Q, DH>::T;
  using L = GLayout<KIND, Q, DH, RAGGED>;
  constexpr int smem = L::WARPS * L::WARP;
  if (splits < 1 || splits > 8) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(cross_attn_grouped_kernel<KIND, Q, DH, RAGGED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BH, splits);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, cross_attn_grouped_kernel<KIND, Q, DH, RAGGED>,
                         static_cast<const Q*>(q), static_cast<const T*>(k_t),
                         static_cast<const T*>(v_t), static_cast<const float*>(k_scale),
                         static_cast<const float*>(v_scale), static_cast<Q*>(out), KQ,
                         row_stride, S_pad, s_valid, dh);
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

template <int KIND, typename Q, int DH>
__global__ void __launch_bounds__(OQ_THREADS, 1)
cross_attn_one_query_kernel(const Q* __restrict__ q,
                            const typename Store<KIND, Q, DH>::T* __restrict__ k_t,
                            const typename Store<KIND, Q, DH>::T* __restrict__ v_t,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale, Q* __restrict__ out,
                            int S_pad, int s_valid) {
  using St = Store<KIND, Q, DH>;
  using T = typename St::T;
  constexpr bool SCALED = KIND != KV_FP;
  constexpr int VEC = St::VEC, DIMS = St::DIMS, ROWS = St::ROWS;
  constexpr int RPL = ROWS / 8;                 // stored rows a lane reads
  constexpr int TILE = OQ_COLS * VEC;           // positions of a warp's tile
  constexpr int TILES = OQ_CHUNK / TILE;        // tiles a chunk
  constexpr int NV = VEC >= 8 ? VEC / 8 : 1;    // scores a lane holds
  constexpr int REC = DH + 2;                   // (o, m, l)
  // the next tile's loads in flight under this one, but where 16 stored
  // rows of K and V a lane (DH = 128, 16-bit or f32 K/V) would double the
  // 128 registers they already take
  constexpr bool PREFETCH = RPL <= 8;
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
  uint4 kr[RPL], vr[RPL], kn[PREFETCH ? RPL : 1], vn[PREFETCH ? RPL : 1];
  float ksr[NV], vsr[NV], ksn[NV], vsn[NV];
  if (nj > 0) load(0, kr, vr, ksr, vsr);
#pragma unroll 1
  for (int j = 0; j < nj; ++j) {
    if constexpr (PREFETCH) {
      if (j + 1 < nj) load(j + 1, kn, vn, ksn, vsn);  // in flight under this tile
    } else if (j > 0) {
      load(j, kr, vr, ksr, vsr);
    }
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
    if constexpr (PREFETCH) {
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

template <int KIND, typename Q, int DH>
int launch_one_query(const void* q, const void* k_t, const void* v_t, const void* k_scale,
                     const void* v_scale, void* out, int BH, int splits, int S_pad,
                     int s_valid, cudaStream_t st) {
  using T = typename Store<KIND, Q, DH>::T;
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
      &cfg, cross_attn_one_query_kernel<KIND, Q, DH>, static_cast<const Q*>(q),
      static_cast<const T*>(k_t), static_cast<const T*>(v_t),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<Q*>(out), S_pad, s_valid);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launchers of one capacity, over every storage kind and q type;
// cudaErrorInvalidValue where a code or a size is out of range.
template <int DH, bool RAGGED>
int grouped_dh(const void* q, const void* k_t, const void* v_t, const void* k_scale,
               const void* v_scale, void* out, int BH, int KQ, int row_stride, int S_pad,
               int s_valid, int splits, int kind, int dtype, int dh, cudaStream_t st) {
  if (KQ < 1 || KQ > G_MAXQ || splits > (s_valid + G_CHUNK - 1) / G_CHUNK)
    return (int)cudaErrorInvalidValue;
  int err = 0;
  const bool ok = dispatch(kind, dtype, [&](auto kind_tag, auto qt) {
    err = launch<decltype(kind_tag)::value, decltype(qt), DH, RAGGED>(
        q, k_t, v_t, k_scale, v_scale, out, BH, KQ, row_stride, S_pad, s_valid, splits, dh,
        st);
  });
  return ok ? err : (int)cudaErrorInvalidValue;
}

template <int DH>
int one_query_dh(const void* q, const void* k_t, const void* v_t, const void* k_scale,
                 const void* v_scale, void* out, int BH, int splits, int S_pad,
                 int s_valid, int kind, int dtype, cudaStream_t st) {
  int err = 0;
  const bool ok = dispatch(kind, dtype, [&](auto kind_tag, auto qt) {
    err = launch_one_query<decltype(kind_tag)::value, decltype(qt), DH>(
        q, k_t, v_t, k_scale, v_scale, out, BH, splits, S_pad, s_valid, st);
  });
  return ok ? err : (int)cudaErrorInvalidValue;
}

// the one-query launcher of capacity DH: the one-query kernel's whole body,
// else (RAGGED, and 256) the grouped kernel at one slot (see below)
template <int DH, bool RAGGED>
int one_query_any(const void* q, const void* k_t, const void* v_t, const void* k_scale,
                  const void* v_scale, void* out, int BH, int splits, int S_pad,
                  int s_valid, int kind, int dtype, int dh, cudaStream_t st) {
  if constexpr (RAGGED || DH > 128)
    return grouped_dh<DH, RAGGED>(q, k_t, v_t, k_scale, v_scale, out, BH, 1, dh, S_pad,
                                  s_valid, splits, kind, dtype, dh, st);
  else
    return one_query_dh<DH>(q, k_t, v_t, k_scale, v_scale, out, BH, splits, S_pad,
                            s_valid, kind, dtype, st);
}

}  // namespace

// Declares, or with a body defines, the two launchers of capacity DH, whole
// (`owc_cross_*_d<DH>`, DH <= 128) or RAGGED (`owc_cross_*_r<DH>`, head dim
// dh at run time), that the C entry points of cross_attention.cu call. A
// RAGGED one-query launcher runs the grouped kernel's RAGGED body at one
// slot (the computation the one-query kernel makes, at half the instances
// to compile), as capacity 256 must: there the one-query kernel's lane
// would hold 32 stored rows of K and of V.
#define OWC_CROSS_GROUPED_ARGS                                                       \
  const void *q, const void *k_t, const void *v_t, const void *k_scale,             \
      const void *v_scale, void *out, int BH, int KQ, int row_stride, int S_pad,    \
      int s_valid, int splits, int kind, int dtype, int dh, cudaStream_t st
#define OWC_CROSS_ONE_QUERY_ARGS                                                     \
  const void *q, const void *k_t, const void *v_t, const void *k_scale,             \
      const void *v_scale, void *out, int BH, int splits, int S_pad, int s_valid,   \
      int kind, int dtype, int dh, cudaStream_t st
#define OWC_CROSS_DECLARE(NAME)                                 \
  int owc_cross_grouped_##NAME(OWC_CROSS_GROUPED_ARGS);         \
  int owc_cross_one_query_##NAME(OWC_CROSS_ONE_QUERY_ARGS);
#define OWC_CROSS_DEFINE_AS(NAME, DH, RAGGED)                                       \
  int owc_cross_grouped_##NAME(OWC_CROSS_GROUPED_ARGS) {                            \
    return grouped_dh<DH, RAGGED>(q, k_t, v_t, k_scale, v_scale, out, BH, KQ,       \
                                  row_stride, S_pad, s_valid, splits, kind, dtype,  \
                                  dh, st);                                          \
  }                                                                                 \
  int owc_cross_one_query_##NAME(OWC_CROSS_ONE_QUERY_ARGS) {                        \
    return one_query_any<DH, RAGGED>(q, k_t, v_t, k_scale, v_scale, out, BH, splits, \
                                     S_pad, s_valid, kind, dtype, dh, st);          \
  }
#define OWC_CROSS_DEFINE(DH) OWC_CROSS_DEFINE_AS(d##DH, DH, false)
#define OWC_CROSS_DEFINE_RAGGED(DH) OWC_CROSS_DEFINE_AS(r##DH, DH, true)
