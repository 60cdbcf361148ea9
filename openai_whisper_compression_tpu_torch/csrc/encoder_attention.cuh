// Non-causal attention over the encoder's fixed context, scores kept on chip:
// the tensor-core bodies, templates on the 16-bit element type E (bf16 or
// f16) and the head dim. `encoder_attention.cu` holds the C entry point and
// the bf16 instances, `encoder_attention_f16.cu` the f16 ones (the whole
// body at head dim 64, the RAGGED body of every capacity);
// `encoder_attention_f32.cu` and `encoder_attention_f32_wg.cu` take f32 up
// to head dim 256 (3xTF32 on the tensor cores), `encoder_attention_wide.cu`
// bf16 and f16 past 256, and `encoder_attention_f32_wide.cu` f32 past 256
// (3xTF32).
//
// Replaces: openai_whisper_compression_tpu/ops/attention.py
//           encoder_attention_pallas (kernel body _attn_kernel).
// Computes, for each (batch, head) pair and each query row i < T:
//   s[i, j]   = sum_d E(q[i, d] * scale) * k[j, d]           (f32), j < T
//   m[i]      = max_j s[i, j];  p[i, j] = exp(s[i, j] - m[i]); l[i] = sum_j p
//   out[i, d] = (sum_j E(p[i, j]) * v[j, d]) / l[i]          (f32 sums)
// from E q, k, v with head dim 64, output in E: q is scaled in E, the
// unnormalised probabilities are rounded to E (v's type) before the value
// product, l sums the unrounded f32 values and divides after the product,
// as the TPU kernel does. The f16 body is the bf16 one with f16 operands
// (`wgmma` .f32.f16.f16, f16 tensor maps); the words below say bf16 for
// both. Keys at positions >= T do not exist here (the
// TPU kernel pads T to 128 and masks them); query rows >= T are not
// written. The TPU kernel holds all of K/V and a (512, T_pad) f32 score
// block of one (batch, head) in VMEM per grid step; a block here has 227 KB
// and registers are scarcer, so the softmax is online (a running max and
// sum per row, the output rescaled when the max grows): a probability is
// rounded to bf16 relative to the running max and not the final one, which
// moves the result by less than the bf16 rounding of the output itself (the
// kernel is held to one bf16 step of the plain version's largest output).
//
// What bounds it on the H100: operations, of two kinds. One call does
// 4 * B*H * T^2 * 64 flop on the tensor cores (6.6e11 at whisper-small,
// batch 96: 0.67 ms at the bf16 peak) against 0.88 GB of q, k, v and out
// (0.26 ms), and B*H * T^2 exponentials (2.6e9) on the special-function
// units, 16 a clock an SM: 0.6-0.7 ms at the card's clock, as much again.
// A kernel that runs the two one after the other cannot come under their
// sum; one that overlaps them is bounded by the larger.
//
// Design: wgmma for both products, a TMA-fed ring of K/V tiles, and the
// softmax of one tile run under the products of its neighbours.
// - A block is three warpgroups: two consumers of 64 query rows each (128
//   rows a block) and a producer. A K/V tile in shared memory is read by
//   one wgmma per 64 query rows; the kernel this one replaced multiplied
//   with 16-row warp-level products, read every tile once per 16 rows and
//   was held back by shared-memory bandwidth before the tensor cores.
// - One block an SM, walking over (batch, head, query block) items with the
//   query block fastest, so the blocks in flight share few (batch, head)
//   pairs and each pair's 384 KB of K/V stay in L2 while its 12 items run.
//   The barriers and the ring live across items: the producer loads the
//   next item's first tiles while the consumers finish this one, and the
//   consumers fetch the next item's q into registers meanwhile.
// - The producer's first thread keeps a ring of 4 stages filled, each a
//   128-key K tile and V tile (32 KB), by two TMA loads a stage that signal
//   the stage's `full` mbarrier; a consumer warp's first lane arrives on the
//   stage's `empty` mbarrier once its warpgroup's products on that stage
//   are done. The tensor maps describe k's and v's (B, H, T, 64) strided
//   views in place (built by the launcher from the pointers and strides it
//   is given; `cuTensorMapEncodeTiled` is looked up through the runtime at
//   the first call, so the library links against the runtime only), in the
//   128-byte swizzle that wgmma's descriptors read without bank conflicts;
//   rows past T arrive as zeros.
// - S = Q K^T: Q, scaled and rounded to bf16, sits in registers as the A
//   operand (16 registers a thread: read once from device memory, so it
//   needs no shared tile and no proxy fence); K is the B operand in its
//   [key][d] tile (K-major). m64n128k16, four steps over d.
// - O += P V: the score accumulators, exponentiated and rounded to bf16,
//   are the A operand as they lie (the accumulator layout of two 8-key
//   columns is the A fragment of 16 keys); V is the B operand read in place
//   from its [key][d] tile through the transposed (MN-major) descriptor:
//   no transpose pass. m64n64k16, eight steps over the keys.
// - Hiding the exponentials: within a warpgroup the next tile's Q K^T is
//   issued together with this tile's P V, and the softmax of the new scores
//   runs while P V is still in flight; the two warpgroups are not in step,
//   so one's exponentials also fall under the other's products. Passing the
//   turn on the tensor cores back and forth between the warpgroups through
//   named barriers, on top of that, was measured and bought nothing at
//   T = 1500 (PERF.md), so the kernel does without.
// - The ragged last tile (1500 = 11 x 128 + 92) is masked to -inf before
//   the row maximum.
// - Registers: a block of 384 threads starts with 168 a thread, and the
//   consumers need more (64 score + 32 output + 32 probability + 2 x 16 q
//   registers and the softmax's temporaries). The card hands registers out
//   to four warps at a time, so a lone producer warp would cost a
//   warpgroup's worth all the same; a whole producer warpgroup gives its
//   registers away instead (`setmaxnreg` down to 40) and each consumer
//   takes 232: no spills. A third consumer warpgroup (192 rows a block)
//   leaves each 128 registers and spills.
// - Head dims: the kernel is a template on DH, 16, 32, 64 or 128 (the TPU
//   kernel takes any; every Whisper size has 64). A tile row is DH bf16
//   values, 32, 64 or 128 bytes, in the swizzle of its own width (32, 64 or
//   128 bytes), which the wgmma descriptors name; S = Q K^T takes DH / 16
//   k steps, O += P V is m64nDHk16. At DH = 128 a row (256 bytes) is wider
//   than the widest swizzle, so each K or V tile is two 64-dim halves,
//   loaded by two TMA boxes, and P V runs one m64n64k16 a half; and since
//   64 more output and 16 more q registers a thread would not fit, a stage
//   holds 64 keys (m64n64k16 scores) in place of 128. The numbers above
//   are DH = 64's.
// - Any other head dim dh up to 256 runs the RAGGED instance of its
//   capacity (the smallest of 16, 32, 64, 128, 256 >= dh), which takes dh
//   at run time. The products run at the capacity's width: the tensor maps
//   of k and v have the inner extent dh and boxes of the capacity's rows,
//   so TMA fills the dims past dh with zeros, which add nothing to a score;
//   q is read zero past dh, and only dh output columns are written (both in
//   pairs where dh and the rows allow, else an element at a time). (The
//   maps need (B, H, T) strides of 16-byte multiples; where a view lacks
//   them, the wrapper copies it once into a
//   zero-padded buffer of the capacity's width.) Capacity 256 takes 64-key
//   stages like 128, a K tile of four 64-dim boxes, and splits the output
//   dims over two items of 128 each (the scores of an item's rows are made
//   twice, once for each half): 128 more output and 32 more q registers a
//   thread would not fit. There q is loaded at the start of its item, not
//   under the previous one. A head dim past 256 would need a query tile
//   wider than the registers hold: it runs the WIDE body
//   (encoder_attention_wide.cu), whose q and output live in shared memory
//   and in two warpgroups' registers.
#pragma once

#include <limits.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int WGS = 2;             // consumer warpgroups
constexpr int BM = 64 * WGS;       // query rows per block
constexpr int STAGES = 4;
constexpr int CONSUMERS = 128 * WGS;  // threads of the consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;
using BF = __nv_bfloat16;

// The tiles of head dim DH: BN keys a stage, a K tile HALVES [BN][HD]
// halves of ROWB-byte rows in the ROWB-byte swizzle, a V tile the VHALVES
// halves of the DV output dims an item makes (DV = DH but at 256: 128, and
// each (batch, head, query block) is OSPLIT items, one a 128-dim half).
template <int DH>
struct Geo {
  static constexpr int BN = DH >= 128 ? 64 : 128;   // keys per stage
  static constexpr int HD = DH >= 128 ? 64 : DH;    // dims of a half
  static constexpr int HALVES = DH / HD;
  static constexpr int DV = DH > 128 ? 128 : DH;    // output dims of an item
  static constexpr int VHALVES = DV / HD;
  static constexpr int OSPLIT = DH / DV;
  static constexpr int ROWB = HD * 2;               // bytes of a half's row
  static constexpr int HALF_BYTES = BN * ROWB;
  static constexpr int TILE_BYTES = BN * DH * 2;    // one K tile
  static constexpr int V_BYTES = BN * DV * 2;       // one V tile
  static constexpr int STAGE_BYTES = TILE_BYTES + V_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment slack
  // the next item's q fetched under this one (not at 256: its 64 registers)
  static constexpr bool PREFETCH_Q = DH <= 128;
};

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across this point.
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

// d (64 x 128 f32) = or += a (64 x 16 bf16, registers) * B (16 x 128, a
// K-major [n][k] shared tile). Thread t of the warpgroup holds rows
// 16 * (t / 32) + (t % 32) / 4 (+ 8) and columns 8j + 2 * (t % 4) (+ 1) in
// d[4j .. 4j + 3]: the warp-level m16n8 accumulator layout, 16 side by side.
#define OWC_ENC_WGMMA_QK(TYPE, TAG) \
__device__ __forceinline__ void wgmma_qk(float (&d)[64], const uint32_t (&a)[4],    \
                                         uint64_t b, int accumulate, TAG) {         \
  asm volatile(                                                                     \
      "{\n"                                                                         \
      ".reg .pred p;\n"                                                             \
      "setp.ne.b32 p, %69, 0;\n"                                                    \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
      "%61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"                    \
      "}\n"                                                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),            \
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),            \
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),            \
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),            \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),            \
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),            \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),            \
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),            \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),            \
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),            \
        "+f"(d[62]), "+f"(d[63])                                                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));       \
}
OWC_ENC_WGMMA_QK("bf16", BF)
OWC_ENC_WGMMA_QK("f16", __half)
#undef OWC_ENC_WGMMA_QK

// d (64 x 64 f32) += a (64 x 16 bf16, registers) * B (16 x 64, an MN-major
// [k][n] shared tile: the transposed-B form).
#define OWC_ENC_WGMMA_PV(TYPE, TAG) \
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4],    \
                                         uint64_t b, TAG) {                         \
  asm volatile(                                                                     \
      "{\n"                                                                         \
      ".reg .pred p;\n"                                                             \
      "setp.ne.b32 p, %37, 0;\n"                                                    \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
      "%31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"                              \
      "}\n"                                                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),            \
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),            \
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),            \
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));                \
}
OWC_ENC_WGMMA_PV("bf16", BF)
OWC_ENC_WGMMA_PV("f16", __half)
#undef OWC_ENC_WGMMA_PV

// d (64 x 64 f32) = or += a * B (16 x 64, a K-major [n][k] tile): the
// scores of 64 keys (DH = 128).
#define OWC_ENC_WGMMA_QK64(TYPE, TAG) \
__device__ __forceinline__ void wgmma_qk64(float (&d)[32], const uint32_t (&a)[4],  \
                                           uint64_t b, int accumulate, TAG) {       \
  asm volatile(                                                                     \
      "{\n"                                                                         \
      ".reg .pred p;\n"                                                             \
      "setp.ne.b32 p, %37, 0;\n"                                                    \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
      "%31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"                              \
      "}\n"                                                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),            \
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),            \
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),            \
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));       \
}
OWC_ENC_WGMMA_QK64("bf16", BF)
OWC_ENC_WGMMA_QK64("f16", __half)
#undef OWC_ENC_WGMMA_QK64

// d (64 x 32 f32) += a * B (16 x 32, an MN-major [k][n] tile): P V at DH = 32.
#define OWC_ENC_WGMMA_PV32(TYPE, TAG) \
__device__ __forceinline__ void wgmma_pv32(float (&d)[16], const uint32_t (&a)[4], \
                                           uint64_t b, TAG) {                      \
  asm volatile(                                                                    \
      "{\n"                                                                        \
      ".reg .pred p;\n"                                                            \
      "setp.ne.b32 p, %21, 0;\n"                                                   \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TYPE "." TYPE " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "   \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"                                   \
      "}\n"                                                                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));               \
}
OWC_ENC_WGMMA_PV32("bf16", BF)
OWC_ENC_WGMMA_PV32("f16", __half)
#undef OWC_ENC_WGMMA_PV32

// d (64 x 16 f32) += a * B (16 x 16, an MN-major [k][n] tile): P V at DH = 16.
#define OWC_ENC_WGMMA_PV16(TYPE, TAG) \
__device__ __forceinline__ void wgmma_pv16(float (&d)[8], const uint32_t (&a)[4], \
                                           uint64_t b, TAG) {                     \
  asm volatile(                                                                   \
      "{\n"                                                                       \
      ".reg .pred p;\n"                                                           \
      "setp.ne.b32 p, %13, 0;\n"                                                  \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TYPE "." TYPE " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"  \
      "}\n"                                                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
        "+f"(d[6]), "+f"(d[7])                                                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));              \
}
OWC_ENC_WGMMA_PV16("bf16", BF)
OWC_ENC_WGMMA_PV16("f16", __half)
#undef OWC_ENC_WGMMA_PV16

// The wgmma descriptor of a tile of ROWB-byte rows in the ROWB-byte
// swizzle (1024-byte aligned): 8-row groups 8 ROWB bytes apart (SBO).
// ROWB = 128 is `smem_desc`.
template <int ROWB>
__device__ __forceinline__ uint64_t tile_desc(const void* p) {
  if constexpr (ROWB == 128) {
    return smem_desc(p);
  } else {
    uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
    d |= (uint64_t)1 << 16;                       // LBO (unused), in 16-byte units
    d |= (uint64_t)((8 * ROWB) >> 4) << 32;       // SBO
    d |= (uint64_t)(ROWB == 64 ? 2 : 3) << 62;    // 64- or 32-byte swizzle
    return d;
  }
}

// What the kernel takes of each 16-bit element type E (bf16, f16): its
// pair type, two floats rounded into a pair (lo in the low half) and a pair
// widened, and the tensor maps' data type.
template <typename E> struct Elem;
template <> struct Elem<BF> {
  using E2 = __nv_bfloat162;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ __forceinline__ static E2 pair(float lo, float hi) { return __floats2bfloat162_rn(lo, hi); }
  __device__ __forceinline__ static float2 wide(E2 v) { return __bfloat1622float2(v); }
};
template <> struct Elem<__half> {
  using E2 = __half2;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ __forceinline__ static E2 pair(float lo, float hi) { return __floats2half2_rn(lo, hi); }
  __device__ __forceinline__ static float2 wide(E2 v) { return __half22float2(v); }
};

template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const typename Elem<E>::E2 v = Elem<E>::pair(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two neighbouring q values times `scale`, rounded to E (q * scale in q's
// own type).
template <typename E>
__device__ __forceinline__ uint32_t load_q2(const E* p, float scale) {
  const float2 f = Elem<E>::wide(*reinterpret_cast<const typename Elem<E>::E2*>(p));
  return pack2<E>(f.x * scale, f.y * scale);
}

// The same of the first n of the two (zeros past them), an element at a
// time (RAGGED: q's rows need not be 4-byte aligned).
template <typename E>
__device__ __forceinline__ uint32_t load_q2_part(const E* p, int n, float scale) {
  return pack2<E>(n > 0 ? owc_to_float(p[0]) * scale : 0.0f,
                  n > 1 ? owc_to_float(p[1]) * scale : 0.0f);
}

struct Strides {  // in elements; the head dim is contiguous
  long long b, h, t;
};

// Where the key position, the head and the batch index stand among a tensor
// map's coordinates 1..3 (its dimensions are ordered by stride).
struct CoordOrder {
  int t, h, b;
};

__device__ __forceinline__ void load_kv_tile(void* dst, const CUtensorMap* map,
                                             uint64_t* bar, CoordOrder o, int key,
                                             int h, int b, int d0 = 0) {
  int c[4] = {0, 0, 0, 0};
  c[o.t] = key;
  c[o.h] = h;
  c[o.b] = b;
  tma_load_4d(dst, map, bar, d0, c[1], c[2], c[3]);
}

// RAGGED: the capacity-DH body of head dim dh (< DH, or = DH = 256).
template <typename E, int DH, bool RAGGED>
__global__ void __launch_bounds__(THREADS, 1)
encoder_attention_kernel(const E* __restrict__ q,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         E* __restrict__ out, int BH, int H, int T, float scale,
                         Strides qs, Strides os, CoordOrder ko, CoordOrder vo, int dh,
                         bool pairs) {
  using G = Geo<DH>;
  constexpr int BN = G::BN, TILE_BYTES = G::TILE_BYTES, STAGE_BYTES = G::STAGE_BYTES;
  constexpr int DV = G::DV, OSPLIT = G::OSPLIT;
  constexpr int KS = DH / 16;   // k steps of S = Q K^T
  constexpr int NS = BN / 8;    // 8-key score columns
  constexpr int PK = BN / 16;   // k steps of O += P V
  constexpr int NO = DV / 8;    // 8-dim output columns
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  // the swizzle repeats every 1024 bytes of shared address
  unsigned char* tiles = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int ntiles = (T + BN - 1) / BN;
  const int qblocks = (T + BM - 1) / BM;
  // (batch, head, output half, query block), query block fastest
  const int items = qblocks * OSPLIT * BH;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty_bar[s], 4 * WGS);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup: its first thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CONSUMERS) {
      int it = 0;  // tiles loaded so far, over all of this block's items
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const int bh = w / (qblocks * OSPLIT), b = bh / H, h = bh % H;
        const int v0 = (w % (qblocks * OSPLIT)) / qblocks * DV;  // the item's V dims
        for (int j = 0; j < ntiles; ++j, ++it) {
          const int s = it % STAGES, round = it / STAGES;
          mbar_wait(&empty_bar[s], (round & 1) ^ 1);  // passes on a fresh barrier
          mbar_expect_tx(&full_bar[s], STAGE_BYTES);
          unsigned char* stage = tiles + s * STAGE_BYTES;
#pragma unroll
          for (int hf = 0; hf < G::HALVES; ++hf)
            load_kv_tile(stage + hf * G::HALF_BYTES, &k_map, &full_bar[s], ko, j * BN, h,
                         b, hf * G::HD);
#pragma unroll
          for (int hf = 0; hf < G::VHALVES; ++hf)
            load_kv_tile(stage + TILE_BYTES + hf * G::HALF_BYTES, &v_map, &full_bar[s], vo,
                         j * BN, h, b, v0 + hf * G::HD);
        }
      }
    }
  } else {
  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid >> 7, lane = tid & 31, warp_in_wg = (tid >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_in_block = wg * 64 + warp_in_wg * 16 + g;  // and + 8

  // A fragments of item w's scaled query rows: a0 (row g, cols 2t), a1 (row
  // g + 8), a2 (row g, cols 2t + 8), a3 (row g + 8, cols 2t + 8)
  auto load_q = [&](uint32_t (&f)[KS][4], int w) {
    const int bh = w / (qblocks * OSPLIT), row0 = (w % qblocks) * BM + row_in_block;
    const E* qb = q + (bh / H) * qs.b + (bh % H) * qs.h;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + (i & 1) * 8;
        const int col = kk * 16 + (i >> 1) * 8 + 2 * t4;
        if constexpr (RAGGED)   // pairs: dh even, q's rows 4-byte aligned
          f[kk][i] = row >= T ? 0u
                     : pairs  ? (col < dh ? load_q2(qb + row * qs.t + col, scale) : 0u)
                              : load_q2_part(qb + row * qs.t + col, dh - col, scale);
        else
          f[kk][i] = row < T ? load_q2(qb + row * qs.t + col, scale) : 0u;
      }
  };

  uint32_t qf[KS][4], q_next[G::PREFETCH_Q ? KS : 1][4];
  float s_acc[BN / 2];  // scores of BN keys, then their exponentials
  float o_acc[DV / 2];
  uint32_t p_frag[PK][4];  // bf16 probabilities: the A operand of P V
  float m_run[2], l_run[2];  // rows g and g + 8; l is this lane's share
  int it = 0;  // tiles consumed before the current item

  // Scores of the item's tile j from its stage's K tile (issue only).
  auto issue_qk = [&](int j) {
    unsigned char* kt = tiles + ((it + j) % STAGES) * STAGE_BYTES;
    constexpr int PER = G::HD / 16;  // k steps a half
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {  // 16 values of d are 32 bytes of a row
      const uint64_t kd = tile_desc<G::ROWB>(kt + (kk / PER) * G::HALF_BYTES);
      if constexpr (BN == 128)
        wgmma_qk(s_acc, qf[kk], kd + (((kk % PER) * 32) >> 4), kk > 0, E());
      else
        wgmma_qk64(s_acc, qf[kk], kd + (((kk % PER) * 32) >> 4), kk > 0, E());
    }
  };
  // O += P V over tile j's V tile (issue only).
  auto issue_pv = [&](int j) {
    unsigned char* vt = tiles + ((it + j) % STAGES) * STAGE_BYTES + TILE_BYTES;
#pragma unroll
    for (int hf = 0; hf < G::VHALVES; ++hf) {
      const uint64_t vd = tile_desc<G::ROWB>(vt + hf * G::HALF_BYTES);
#pragma unroll
      for (int kk = 0; kk < PK; ++kk) {  // 16 keys are 16 rows
        const uint64_t d = vd + ((kk * 16 * G::ROWB) >> 4);
        if constexpr (DV == 64)
          wgmma_pv(o_acc, p_frag[kk], d, E());
        else if constexpr (G::HD == 64)  // DV = 128: half hf's 64 output dims
          wgmma_pv(*reinterpret_cast<float(*)[32]>(o_acc + 32 * hf), p_frag[kk], d, E());
        else if constexpr (G::HD == 32)
          wgmma_pv32(o_acc, p_frag[kk], d, E());
        else
          wgmma_pv16(o_acc, p_frag[kk], d, E());
      }
    }
  };
  auto wait_full = [&](int j) {
    mbar_wait(&full_bar[(it + j) % STAGES], ((it + j) / STAGES) & 1);
  };
  auto release = [&](int j) {  // this warp is done with tile j's stage
    if (lane == 0) mbar_arrive(&empty_bar[(it + j) % STAGES]);
  };
  // The online softmax over tile j's scores: s_acc becomes exp(s - m), the
  // running maximum and sum move on; returns what the output so far must be
  // multiplied by (0 on an item's first tile, whose old maximum is -inf).
  auto softmax_tile = [&](int j, float (&corr)[2]) {
    if (j * BN + BN > T) {  // the ragged last tile: keys past T take no weight
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        if (j * BN + (i >> 2) * 8 + 2 * t4 + (i & 1) >= T) s_acc[i] = -INFINITY;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};  // short chains
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mx[n & 3] = fmaxf(mx[n & 3], fmaxf(s_acc[4 * n + 2 * r], s_acc[4 * n + 2 * r + 1]));
      float m_tile = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
      const float m_new = fmaxf(m_run[r], m_tile);  // finite: key 0 is in tile 0
      corr[r] = ex2((m_run[r] - m_new) * LOG2E);
      m_run[r] = m_new;
      const float ms = m_new * LOG2E;
      float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float p0 = ex2(fmaf(s_acc[4 * n + 2 * r], LOG2E, -ms));
        const float p1 = ex2(fmaf(s_acc[4 * n + 2 * r + 1], LOG2E, -ms));
        s_acc[4 * n + 2 * r] = p0;
        s_acc[4 * n + 2 * r + 1] = p1;
        sum[n & 3] += p0 + p1;
      }
      l_run[r] = l_run[r] * corr[r] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
    }
  };
  auto rescale_and_pack = [&](const float (&corr)[2]) {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o_acc[4 * n] *= corr[0];
      o_acc[4 * n + 1] *= corr[0];
      o_acc[4 * n + 2] *= corr[1];
      o_acc[4 * n + 3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < PK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p_frag[kk][i] = pack2<E>(s_acc[8 * kk + 2 * i], s_acc[8 * kk + 2 * i + 1]);
  };
  auto fence_pv_operands = [&]() {
    reg_fence(o_acc);
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) reg_fence(p_frag[kk]);
  };

  if constexpr (G::PREFETCH_Q)
    if ((int)blockIdx.x < items) load_q(q_next, blockIdx.x);
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    if constexpr (G::PREFETCH_Q) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) qf[kk][i] = q_next[kk][i];
      // the next item's q arrives while this one's tiles stream by
      if (w + (int)gridDim.x < items) load_q(q_next, w + gridDim.x);
    } else {
      load_q(qf, w);
    }
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o_acc[i] = 0.0f;
    m_run[0] = m_run[1] = -INFINITY;
    l_run[0] = l_run[1] = 0.0f;
    float corr[2];

    // tile 0: scores alone
    wait_full(0);
    reg_fence(s_acc);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) reg_fence(qf[kk]);
    wgmma_fence();
    issue_qk(0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s_acc);
    softmax_tile(0, corr);
    rescale_and_pack(corr);

    for (int j = 1; j < ntiles; ++j) {
      wait_full(j);
      reg_fence(s_acc);
      fence_pv_operands();
      wgmma_fence();
      issue_qk(j);
      wgmma_commit();
      issue_pv(j - 1);
      wgmma_commit();
      wgmma_wait<1>();  // the scores are there; P V of tile j - 1 still runs
      reg_fence(s_acc);
      softmax_tile(j, corr);
      wgmma_wait<0>();  // P V of tile j - 1 is done: its stage is free
      fence_pv_operands();
      release(j - 1);
      rescale_and_pack(corr);
    }

    // the last tile's P V
    fence_pv_operands();
    wgmma_fence();
    issue_pv(ntiles - 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o_acc);
    release(ntiles - 1);
    it += ntiles;

    const int bh = w / (qblocks * OSPLIT), row0 = (w % qblocks) * BM + row_in_block;
    const int c0 = (w % (qblocks * OSPLIT)) / qblocks * DV + 2 * t4;  // first column
    E* ob = out + (bh / H) * os.b + (bh % H) * os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.0f / l;
      const int row = row0 + r * 8;
      if (row < T) {
        E* orow = ob + row * os.t + c0;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const typename Elem<E>::E2 o2 = Elem<E>::pair(o_acc[4 * n + 2 * r] * inv,
                                                        o_acc[4 * n + 2 * r + 1] * inv);
          if constexpr (RAGGED) {  // the columns below dh (in pairs where aligned)
            if (pairs) {
              if (c0 + n * 8 < dh) *reinterpret_cast<typename Elem<E>::E2*>(orow + n * 8) = o2;
            } else {
              if (c0 + n * 8 < dh) orow[n * 8] = o2.x;
              if (c0 + n * 8 + 1 < dh) orow[n * 8 + 1] = o2.y;
            }
          } else {
            *reinterpret_cast<typename Elem<E>::E2*>(orow + n * 8) = o2;
          }
        }
      }
    }
  }
  }  // consumer warpgroups
}

// The tensor map of an E (B, H, T, DH) strided view, boxes of (BN, HD)
// at one (batch, head) in the ROWB-byte swizzle, rows past T filled with
// zeros. The three outer dimensions are listed by ascending stride; `order`
// says where each landed.
template <typename E, int DH>
bool make_kv_map(CUtensorMap* map, CoordOrder* order, const void* base, int B, int H,
                 int T, int dh, Strides st) {
  using G = Geo<DH>;
  constexpr int BN = G::BN;
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  struct Dim {
    long long stride;
    cuuint64_t size;
    cuuint32_t box;
    int* where;
  } dims[3] = {{st.t, (cuuint64_t)T, BN, &order->t},
               {st.h, (cuuint64_t)H, 1, &order->h},
               {st.b, (cuuint64_t)B, 1, &order->b}};
  for (int i = 0; i < 3; ++i)  // a dimension of one element: any stride will do
    if (dims[i].size == 1) dims[i].stride = LLONG_MAX;
  for (int i = 0; i < 3; ++i)  // three elements: a bubble sort
    for (int j = 0; j + 1 < 3 - i; ++j)
      if (dims[j].stride > dims[j + 1].stride) {
        const Dim tmp = dims[j];
        dims[j] = dims[j + 1];
        dims[j + 1] = tmp;
      }
  // elements spanned by the dimensions so far (a multiple of 8, so that a
  // dimension of one element gets a 16-byte stride)
  long long extent = (dh + 7) / 8 * 8;
  for (int i = 0; i < 3; ++i) {
    if (dims[i].size == 1) dims[i].stride = extent;
    const long long span = dims[i].stride * (long long)dims[i].size;
    if (span > extent) extent = (span + 7) / 8 * 8;
  }
  // the inner extent dh: TMA fills a box's dims past it with zeros
  cuuint64_t size[4] = {(cuuint64_t)dh, 0, 0, 0};
  cuuint64_t stride_bytes[3];
  cuuint32_t box[4] = {G::HD, 0, 0, 0};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    size[i + 1] = dims[i].size;
    stride_bytes[i] = (cuuint64_t)dims[i].stride * sizeof(E);
    box[i + 1] = dims[i].box;
    *dims[i].where = i + 1;
  }
  const CUtensorMapSwizzle swizzle = G::ROWB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : G::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                     : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, Elem<E>::MAP, 4, const_cast<void*>(base), size, stride_bytes, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename E, int DH, bool RAGGED>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int T,
           int dh, float scale, const long long* strides, cudaStream_t stream) {
  using G = Geo<DH>;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  CUtensorMap k_map, v_map;
  CoordOrder ko, vo;
  if (!make_kv_map<E, DH>(&k_map, &ko, k, B, H, T, dh, ks) ||
      !make_kv_map<E, DH>(&v_map, &vo, v, B, H, T, dh, vs))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(encoder_attention_kernel<E, DH, RAGGED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       G::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  // one block an SM, each walking over (batch, head, query block) items
  int sms = 0;
  e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const long long items = (long long)((T + BM - 1) / BM) * G::OSPLIT * B * H;
  if (items > 2147483647LL) return (int)cudaErrorInvalidValue;   // an int walks them
  const int grid = (int)(items < sms ? items : sms);
  // q and out read and written in pairs where every row starts 4-byte aligned
  const bool pairs = owc_align_class(2LL * (dh | qs.b | qs.h | qs.t | os.b | os.h | os.t),
                                     q, out) >= 4;
  encoder_attention_kernel<E, DH, RAGGED><<<grid, THREADS, G::SMEM_BYTES, stream>>>(
      static_cast<const E*>(q), k_map, v_map, static_cast<E*>(out), B * H, H, T, scale,
      qs, os, ko, vo, dh, pairs);
  return (int)cudaGetLastError();
}

// The tensor-core body of element type E for head dim dh at capacity cap
// (16, 32, 64, 128 or 256): bf16 has whole bodies at 16, 32, 64 and 128, f16
// at 64 (every Whisper size's head dim) alone; any other dh, or dh = cap
// without a whole body, runs cap's RAGGED body. cudaErrorInvalidValue where
// cap does not serve dh.
template <typename E>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B, int H, int T,
              int dh, int cap, float scale, const long long* strides, cudaStream_t st) {
  constexpr bool BF16 = std::is_same<E, BF>::value;
  if (dh < 1 || dh > cap || (cap > 16 && 2 * dh <= cap)) return (int)cudaErrorInvalidValue;
  const bool whole = dh == cap;
#define OWC_ENC_LAUNCH(DH, RAGGED) \
  launch<E, DH, RAGGED>(q, k, v, out, B, H, T, dh, scale, strides, st)
  switch (cap) {
    case 16:
      if constexpr (BF16) {
        if (whole) return OWC_ENC_LAUNCH(16, false);
      }
      return OWC_ENC_LAUNCH(16, true);
    case 32:
      if constexpr (BF16) {
        if (whole) return OWC_ENC_LAUNCH(32, false);
      }
      return OWC_ENC_LAUNCH(32, true);
    case 64: return whole ? OWC_ENC_LAUNCH(64, false) : OWC_ENC_LAUNCH(64, true);
    case 128:
      if constexpr (BF16) {
        if (whole) return OWC_ENC_LAUNCH(128, false);
      }
      return OWC_ENC_LAUNCH(128, true);
    case 256: return OWC_ENC_LAUNCH(256, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef OWC_ENC_LAUNCH
}

}  // namespace

// The f16 tensor-core bodies (encoder_attention_f16.cu), the f32 ones
// (encoder_attention_f32.cu, which calls encoder_attention_f32_wg.cu's at
// capacity 64), the 16-bit WIDE one (encoder_attention_wide.cu)
// and the f32 one past 256 (encoder_attention_f32_wide.cu), compiled
// apart so that the build runs them beside this file; owc_encoder_attention
// (encoder_attention.cu) picks among them.
int owc_encoder_attention_f16(const void* q, const void* k, const void* v, void* out, int B,
                              int H, int T, int dh, int cap, float scale,
                              const long long* strides, cudaStream_t st);
int owc_encoder_attention_f32(const void* q, const void* k, const void* v, void* out, int B,
                              int H, int T, int dh, int cap, float scale,
                              const long long* strides, cudaStream_t st);
int owc_encoder_attention_wide(const void* q, const void* k, const void* v, void* out, int B,
                               int H, int T, int dh, float scale, const long long* strides,
                               int dtype, cudaStream_t st);
int owc_encoder_attention_f32_wide(const void* q, const void* k, const void* v, void* out,
                                   int B, int H, int T, int dh, float scale,
                                   const long long* strides, cudaStream_t st);
