// Fused KV-cache row write + one-query decode self-attention, over an fp
// cache and over an int8 cache with per-position scales; and the same
// attention without the write, over a cache whose row pos the caller wrote.
//
// Replaces: openai_whisper_compression_tpu/ops/self_attention_step.py
//           decode_self_attention_update (kernel bodies _kernel_upd and
//           _kernel_upd_nostart), decode_self_attention_update_int8
//           (_kernel_upd_i8 and _kernel_upd_i8_nostart) and
//           decode_self_attention (_kernel, _kernel_nostart, _kernel_int8,
//           _kernel_int8_nostart: the WRITE = false instances below).
// fp cache, for each (batch, head) row g of BH, with lo = start[g] (the
// first valid cache position of a left-padded prompt), or 0 where start is
// null:
//   k_cache[g, pos, :] = k_new[g, :];  v_cache[g, pos, :] = v_new[g, :]
//   scores[s] = q[g, :] . k_cache[g, s, :]           for lo <= s <= pos
//   out[g, :] = sum_s softmax(scores)[s] * v_cache[g, s, :]
// int8 cache: the fresh rows are quantized first (scale = max(absmax over
// the 64 dims, 1e-12) * f32(1 / 127), q = clamp(rint(x / scale), -127, 127))
// and written with their scales at pos; then
//   scores[s] = (q[g, :] . kq[g, s, :]) * k_scale[g, s]  for lo <= s <= pos
//   p[s] = exp(scores[s] - max), l = sum_s p[s]
//   out[g, :] = sum_s p[s] * v_scale[g, s] * vq[g, s, :] / l
// so the fresh row attends at its quantized-then-dequantized value, as in
// the TPU kernel. Arithmetic in f32; q, the fresh rows, an fp cache and the
// output share one element type, f32, bf16 or f16 (the Pallas kernels are
// generic in it: output in q's type, cache in its own); with an int8 cache
// only q, the fresh rows and the output have it. The caches and scales are
// updated in place.
//
// What bounds it on the H100: bytes, then one memory latency and the
// launch. A row reads rows start..pos of its K and V caches, 2 x 64 x (pos
// + 1 - start) elements (3 MB in bf16 at pos 30 over 384 rows, under a
// microsecond of the card's memory rate) and writes one row of each; what a
// call costs beyond its launch is how many memory latencies it waits
// through in series. So every body is one warp per row that issues a whole
// pass's loads before any arithmetic, and the fresh rows are attended from
// registers: no shared memory, no block barrier, one latency a pass. Only
// the live cache rows lo..pos are read; the start variants of the TPU
// kernels are one null-able pointer here, not separate bodies.
//
// Design, fp cache: a block of one warp per row (blocks of two and four
// rows were no faster on the H100), a pass of FP_PASS = 32 positions. A
// 16-byte piece holds E = 16 / sizeof(T) dims (8 in bf16 and f16, 4 in
// f32), so one warp load brings P = 32 E / 64 positions (4, or 2 in f32).
// Lane l holds piece l / P of q and of the positions s0 + l % P + P t of a
// pass (t < 32 / P slots: 8, or 16 in f32) and issues the pass's K and V
// loads together. A score is E products, then a reduce-scatter over the
// 64 / E lanes of its position (`owc_reduce_scatter`) leaves the score of
// position s0 + l with lane l: max and sum are one warp reduction a pass,
// one ex2 a lane, and each lane takes its slots' probabilities back by
// shuffles into E dims of value sums, which reduce over the P slot lanes at
// the end (2 dims of the output a lane). The update loads the fresh rows as
// 16-byte pieces while the pass is in flight; the lanes of slot 0 write them
// to row pos and the slot that holds pos attends them from registers: row
// pos is never read back. A cache longer than a pass loops with an online
// softmax (m and l in base 2: q is scaled by log2(e) as it loads).
// Design, int8 cache: a warp per row, 4 rows a block, no shared memory and
// no block barrier. A lane holds 16 dims of q and 8 positions of a 64-position
// pass; it issues the pass's 8 K and 8 V loads of 16 bytes and their scales
// together, so one memory latency covers a pass (the headline's whole
// cache). A score is 16 products and 2 shuffles over the position's 4 lanes;
// max and sum are shuffles over the 8 position slots; the value sums stay in
// registers (p times the v scale times the codes) and reduce over the slots
// at the end. The fresh rows are quantized in registers while the first
// pass's loads are in flight, 2 dims a lane (the absmax over the warp), the
// codes gathered by shuffles, and attended from there as they are written:
// no write-then-barrier-then-read. A cache longer than a pass loops with an
// online softmax.
// This header holds the kernel templates; `self_attention_step.cu` holds
// the C entry points and the whole bodies, and each of
// `self_attention_step_r{16,32,64,128,256}.cu` the RAGGED bodies of one
// capacity (one nvcc process each, so the build runs them side by side).
// The read-only attention is the same kernel compiled without the write
// (WRITE = false), which reads row pos from memory, so that on the cache an
// update wrote it repeats that update's arithmetic operation for operation
// and returns its output bit for bit.
// Head dims: both templates take DH = 16, 32, 64 or 128 (the TPU kernels
// take any; every Whisper size has 64, the test models 16). The numbers
// above are DH = 64's. fp cache: a 16-byte piece still holds E dims, so a
// row is DQ = DH / E pieces, a warp load brings P = 32 / DQ positions (16 in
// bf16 at DH = 16, 1 in f32 at DH = 128) and a lane holds DQ slots of a
// 32-position pass; at DH = 128 in f32 (32 slots) the pass's V loads wait
// until its scores are made, so that K and V do not hold 256 registers at
// once. int8 cache: a position is DQ = DH / 16 lanes of 16 dims, a warp load
// brings 32 / DQ positions and a pass 8 times that (256 at DH = 16, 32 at
// DH = 128); a fresh row is quantized DH / 32 dims a lane (one dim on half
// the lanes at DH = 16).
// Any other head dim dh up to 256 runs the RAGGED instance of its
// capacity (the smallest of 16, 32, 64, 128, 256 >= dh), which takes dh at
// run time, and the update or the read-only attention as an argument (one
// instance for both). The caches (BH, S, dh) are the caller's and are
// updated in place, so a RAGGED body reads and writes rows of dh values
// where they are: a lane's piece by one 16-byte access where dh * elem %
// 16 == 0, by the aligned 4-byte words that hold it otherwise (shifted into
// place; the fresh row written an element at a time), its dims past dh as
// zeros (they add nothing to a score, and their sums are not written).
// Nothing is padded or copied. Capacity 256 in f32 holds 64 pieces a row: a
// lane takes two of a position (one in each 128-dim half) and a pass is 16
// positions, each score left with two lanes; int8 at 256 quantizes 8 fresh
// dims a lane. Where a pass's 32 slots of K and V would not fit in
// registers together (f32 at 128, 16-bit and f32 at 256), V is loaded into
// K's registers once the scores are made.
// A head dim past 256 runs the WIDE body of self_attention_step_wide.cu,
// which walks the head dim in chunks (no template here).
// Long caches: positions and offsets are computed in 64 bits where they
// meet a row's S, so S is bounded only by a pass's position staying inside
// an int: S <= 2^31 - 257.
#pragma once

#include <type_traits>

#include "hopper.cuh"  // ex2

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// fp cache: positions a pass (one a lane)
constexpr int FP_PASS = 32;

// 16 bytes of T as E floats (exact)
template <typename T>
struct Piece;
template <>
struct Piece<float> {
  static constexpr int E = 4;
  __device__ static void to_float(const uint4& u, float (&f)[E]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Piece<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void to_float(const uint4& u, float (&f)[E]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};
template <>
struct Piece<__half> {
  static constexpr int E = 8;
  __device__ static void to_float(const uint4& u, float (&f)[E]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xFFFFu)));
      f[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
    }
  }
};

// RAGGED: the capacity-DH body of head dim dh (< DH, or = DH = 256), one
// instance for both the update and the read-only attention (`write` at run
// time, the template's WRITE unused: half the instances to compile);
// `align`: the alignment class of its rows (`owc_align_class`).
template <typename T, bool WRITE_T, int DH, bool RAGGED>
__global__ void __launch_bounds__(32)
self_attn_update_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, T* k_cache, T* v_cache,
                        T* __restrict__ out, const int* __restrict__ start,
                        int S, int pos, int dh, int align, bool write) {
  const bool WRITE = RAGGED ? write : WRITE_T;
  constexpr int E = Piece<T>::E;     // dims of a 16-byte piece
  // pieces of a position a lane holds: 2 where a row's pieces outnumber the
  // lanes (f32 at DH = 256: dims 4 dq .. + 3 and 128 + 4 dq .. + 3), else 1
  constexpr int PPL = DH / E > 32 ? DH / E / 32 : 1;
  constexpr int DHH = DH / PPL;      // the dims the lanes' first pieces span
  constexpr int P = 32 * E / DHH;    // positions a warp load brings
  constexpr int PASS = FP_PASS / PPL;  // positions a pass: 16 where PPL = 2
  constexpr int DUP = 32 / PASS;     // lanes that end up with one position's score
  constexpr int SLOTS = PASS / P;    // positions a lane holds in a pass
  // K and V of a pass in flight together but where 32 slots of each would
  // take 256 registers (f32 at DH = 128, every type at 256): there V
  // follows the scores, in K's registers
  constexpr bool KV_TOGETHER = SLOTS * PPL <= 16;
  // output dims a lane writes, and whether it owns them (at P > E the
  // lanes that differ in their low P / E bits hold the same sums)
  constexpr int VPL = E >= P ? E / P : 1;
  const int lane = threadIdx.x, g = blockIdx.x;
  const int slot = lane % P, dq = lane / P;
  const int lo = start ? start[g] : 0;  // first position that attends
  const int dhr = RAGGED ? dh : DH;     // the row length of q, the caches, out
  T* kg = k_cache + (size_t)g * S * dhr + dq * E;  // this lane's piece of row 0
  T* vg = v_cache + (size_t)g * S * dhr + dq * E;
  // this lane's piece pc at p in a row of alignment class A (RAGGED: its
  // dims past dh zero; a whole body's A is 0, a whole 16-byte piece)
  auto ld = [&](auto A, const T* p, int pc) -> uint4 {
    if constexpr (decltype(A)::value == 0) return *reinterpret_cast<const uint4*>(p);
    else return owc_load_piece<decltype(A)::value>(p, dh - (pc * DHH + dq * E));
  };
  auto st16 = [&](auto A, T* p, const uint4& u, int pc) {
    if constexpr (decltype(A)::value == 0) *reinterpret_cast<uint4*>(p) = u;
    else owc_store_piece<decltype(A)::value>(p, u, dh - (pc * DHH + dq * E));
  };

  // a pass's K and V pieces of this lane, all in flight together:
  // positions s0 + slot + P t up to pos (zero past it); row pos only where
  // this kernel does not write it
  uint4 kr[SLOTS][PPL], vr[KV_TOGETHER ? SLOTS : 1][PPL];
  auto load_one = [&](int s0, const T* base) {  // into kr
    owc_aligned_as<RAGGED>(align, [&](auto A) {
#pragma unroll
      for (int t = 0; t < SLOTS; ++t) {
        const int s = s0 + slot + P * t;
#pragma unroll
        for (int pc = 0; pc < PPL; ++pc) {
          kr[t][pc] = make_uint4(0, 0, 0, 0);
          if (s <= pos && !(WRITE && s == pos))
            kr[t][pc] = ld(A, base + (size_t)s * dhr + pc * DHH, pc);
        }
      }
    });
  };
  auto load = [&](int s0) {
    if constexpr (!KV_TOGETHER) {
      load_one(s0, kg);
    } else {
      owc_aligned_as<RAGGED>(align, [&](auto A) {
#pragma unroll
        for (int t = 0; t < SLOTS; ++t) {
          const int s = s0 + slot + P * t;
          kr[t][0] = vr[t][0] = make_uint4(0, 0, 0, 0);
          if (s <= pos && !(WRITE && s == pos)) {
            kr[t][0] = ld(A, kg + (size_t)s * dhr, 0);
            vr[t][0] = ld(A, vg + (size_t)s * dhr, 0);
          }
        }
      });
    }
  };
  load(lo);

  float qr[PPL][E];
  // the fresh rows: the lanes of slot 0 write them, and the slot that
  // holds pos attends them from registers
  uint4 kfresh[PPL], vfresh[PPL];
  owc_aligned_as<RAGGED>(align, [&](auto A) {
#pragma unroll
    for (int pc = 0; pc < PPL; ++pc) {
      Piece<T>::to_float(ld(A, q + (size_t)g * dhr + pc * DHH + dq * E, pc), qr[pc]);
#pragma unroll
      for (int i = 0; i < E; ++i) qr[pc][i] *= LOG2E;  // scores in base 2
    }
#pragma unroll
    for (int pc = 0; pc < PPL; ++pc) {
      kfresh[pc] = vfresh[pc] = make_uint4(0, 0, 0, 0);
      if (WRITE) {
        kfresh[pc] = ld(A, k_new + (size_t)g * dhr + pc * DHH + dq * E, pc);
        vfresh[pc] = ld(A, v_new + (size_t)g * dhr + pc * DHH + dq * E, pc);
        if (slot == 0) {
          st16(A, kg + (size_t)pos * dhr + pc * DHH, kfresh[pc], pc);
          st16(A, vg + (size_t)pos * dhr + pc * DHH, vfresh[pc], pc);
        }
      }
    }
  });

  float m_run = -INFINITY, l_run = 0.0f, acc[PPL][E];
#pragma unroll
  for (int pc = 0; pc < PPL; ++pc)
#pragma unroll
    for (int i = 0; i < E; ++i) acc[pc][i] = 0.0f;
#pragma unroll 1
  for (int s0 = lo; s0 <= pos; s0 += PASS) {
    if (s0 != lo) load(s0);
    if (WRITE) {
#pragma unroll
      for (int t = 0; t < SLOTS; ++t) {
        if (s0 + slot + P * t == pos) {
#pragma unroll
          for (int pc = 0; pc < PPL; ++pc) kr[t][pc] = kfresh[pc];
          if constexpr (KV_TOGETHER) vr[t][0] = vfresh[0];
        }
      }
    }
    // scores: E products a piece, then summed over the lanes of each
    // position; lane l keeps the score of position s0 + l / DUP
    float x[SLOTS];
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      float sc = 0.0f;
#pragma unroll
      for (int pc = 0; pc < PPL; ++pc) {
        float kf[E];
        Piece<T>::to_float(kr[t][pc], kf);
#pragma unroll
        for (int i = 0; i < E; ++i) sc = fmaf(qr[pc][i], kf[i], sc);
      }
      x[t] = sc;
    }
    owc_reduce_scatter<16, P>(x, lane);
    if constexpr (!KV_TOGETHER) {  // V into K's registers
      load_one(s0, vg);
      if (WRITE) {
#pragma unroll
        for (int t = 0; t < SLOTS; ++t)
          if (s0 + slot + P * t == pos) {
#pragma unroll
            for (int pc = 0; pc < PPL; ++pc) kr[t][pc] = vfresh[pc];
          }
      }
    }
    const float xs = s0 + lane / DUP <= pos ? x[0] : -INFINITY;
    const float mn = fmaxf(m_run, owc_warp_max(xs));  // finite: s0 attends
    const float corr = ex2(m_run - mn);
    m_run = mn;
    const float p = ex2(xs - mn);  // 0 past pos
    // this lane's share (one of a position's DUP lanes); summed at the end
    l_run = l_run * corr + (lane % DUP == 0 ? p : 0.0f);
#pragma unroll
    for (int pc = 0; pc < PPL; ++pc)
#pragma unroll
      for (int i = 0; i < E; ++i) acc[pc][i] *= corr;
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const float pt = __shfl_sync(0xffffffffu, p, (slot + P * t) * DUP);
#pragma unroll
      for (int pc = 0; pc < PPL; ++pc) {
        float vf[E];
        if constexpr (KV_TOGETHER) Piece<T>::to_float(vr[t][pc], vf);
        else Piece<T>::to_float(kr[t][pc], vf);
#pragma unroll
        for (int i = 0; i < E; ++i) acc[pc][i] = fmaf(pt, vf[i], acc[pc][i]);
      }
    }
  }
  const float l = owc_warp_sum(l_run);
  // the value sums over the P slot lanes; each lane keeps VPL of its E dims
  // (2 at DH = 64: dims 2 lane and 2 lane + 1 of the row)
#pragma unroll
  for (int pc = 0; pc < PPL; ++pc) {
    owc_reduce_scatter<P / 2, 1>(acc[pc], lane);
    const int d = pc * DHH + dq * E + owc_scatter_base<E, P / 2, 1>(lane);
    if (E >= P || (lane & (P / E - 1)) == 0) {
#pragma unroll
      for (int i = 0; i < VPL; ++i)
        if (!RAGGED || d + i < dh) owc_store(out + (size_t)g * dhr + d + i, acc[pc][i] / l);
    }
  }
}

// int8 cache: a warp per (batch, head) row, I8_WARPS rows a block. At DH =
// 64 lane l holds dims 16 (l & 3) .. + 15 and the positions lo + (l >> 2) +
// 8 t of a pass (t < I8_SLOTS): a 64-byte cache row is 4 lanes' 16-byte
// pieces, so one warp load brings 8 positions, and a lane issues all of a
// pass's K and V loads and scales together: one memory latency a 64-position
// pass. Generally a row is DQ = DH / 16 lanes and a warp load brings 32 / DQ
// positions.
constexpr int I8_WARPS = 4;
constexpr int I8_SLOTS = 8;

__device__ __forceinline__ void codes16(const uint4& u, float (&f)[16]) {
  owc_int8x4_to_float(u.x, f);
  owc_int8x4_to_float(u.y, f + 4);
  owc_int8x4_to_float(u.z, f + 8);
  owc_int8x4_to_float(u.w, f + 12);
}

// RAGGED: the capacity-DH body of head dim dh (< DH, or = DH = 256), the
// update or the read-only attention by `write` at run time (WRITE_T
// unused); `align`: the alignment class of the cache rows (`owc_align_class`).
template <typename T, bool WRITE_T, int DH, bool RAGGED>
__device__ __forceinline__ void
self_attn_int8_body(const T* __restrict__ q, const T* __restrict__ k_new,
                    const T* __restrict__ v_new, int8_t* k_cache, int8_t* v_cache,
                    float* k_scale, float* v_scale, T* __restrict__ out,
                    const int* __restrict__ start, int BH, int S, int pos, int dh,
                    int align, bool write) {
  const bool WRITE = RAGGED ? write : WRITE_T;
  constexpr int DQ = DH / 16;          // lanes of a position
  constexpr int PW = 32 / DQ;          // positions a warp load brings
  constexpr int I8_PASS = PW * I8_SLOTS;  // positions a pass covers
  constexpr int FD = DH >= 32 ? DH / 32 : 1;  // fresh dims a lane quantizes
  // value sums a lane keeps: 16 over the PW slot lanes (at DH = 16 each sum
  // is held by two lanes, which differ in bit 0)
  constexpr int VPL = 16 >= PW ? 16 / PW : 1;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * I8_WARPS + (threadIdx.x >> 5);
  if (g >= BH) return;  // a whole warp: no barrier below spans warps
  const int dq = lane % DQ, slot = lane / DQ;
  const int lo = start ? start[g] : 0;  // first position that attends
  const int dhr = RAGGED ? dh : DH;     // the row length of q, the caches, out
  int8_t* kg = k_cache + (size_t)g * S * dhr;
  int8_t* vg = v_cache + (size_t)g * S * dhr;
  float* ksg = k_scale + (size_t)g * S;
  float* vsg = v_scale + (size_t)g * S;
  const int nv = dh - dq * 16;  // RAGGED: dims of this lane's piece inside dh

  float qr[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if constexpr (RAGGED)
      qr[i] = i < nv ? owc_to_float(q[(size_t)g * dh + dq * 16 + i]) : 0.0f;
    else
      qr[i] = owc_to_float(q[(size_t)g * DH + dq * 16 + i]);
  }

  // a pass's 8 K and 8 V pieces and scales of this lane, all in flight
  // together: positions s0 + slot + 8 t up to pos (zero codes and scales
  // past it); row pos only where this kernel does not write it
  uint4 kr[I8_SLOTS], vr[I8_SLOTS];
  float ks[I8_SLOTS], vs[I8_SLOTS];
  auto load = [&](int s0) {
    owc_aligned_as<RAGGED>(align, [&](auto A) {
      constexpr int AL = decltype(A)::value;
#pragma unroll
      for (int t = 0; t < I8_SLOTS; ++t) {
        const int s = s0 + slot + PW * t;
        kr[t] = vr[t] = make_uint4(0, 0, 0, 0);
        ks[t] = vs[t] = 0.0f;
        if (s <= pos && !(WRITE && s == pos)) {
          const size_t off = (size_t)s * dhr + dq * 16;
          if constexpr (AL == 0) {
            kr[t] = *reinterpret_cast<const uint4*>(kg + off);
            vr[t] = *reinterpret_cast<const uint4*>(vg + off);
          } else {
            kr[t] = owc_load_piece<AL>(kg + off, nv);
            vr[t] = owc_load_piece<AL>(vg + off, nv);
          }
          ks[t] = ksg[s];
          vs[t] = vsg[s];
        }
      }
    });
  };
  load(lo);  // in flight while the fresh rows are quantized

  // the fresh rows, quantized in registers: a lane takes dims 2 lane and
  // 2 lane + 1 (the absmax over the warp), and the 4 lanes of every slot
  // gather the codes of their 16 dims by shuffles; the lanes of slot 0
  // write them, and the slot that holds pos attends them from registers:
  // row pos is never read back
  uint4 kfresh = make_uint4(0, 0, 0, 0), vfresh = make_uint4(0, 0, 0, 0);
  float ksf = 0.0f, vsf = 0.0f;
  if (WRITE) {
    auto quant = [&](const T* src, uint4& codes, float& scale) {
      // this lane's FD dims FD lane .. (none past DH: lanes 16-31 at DH = 16)
      float x[FD];
      float a = 0.0f;
#pragma unroll
      for (int i = 0; i < FD; ++i) {
        x[i] = FD * lane + i < dhr ? owc_to_float(src[(size_t)g * dhr + FD * lane + i]) : 0.0f;
        a = fmaxf(a, fabsf(x[i]));
      }
      a = owc_warp_max(a);
      scale = fmaxf(a, 1e-12f) * (1.0f / 127.0f);
      // the FD codes, byte i of word i / 4 = dim FD lane + i
      uint32_t part = 0, part_hi = 0;
#pragma unroll
      for (int i = 0; i < FD; ++i) {
        const uint32_t c = (uint32_t)owc_quant_int8(x[i], scale) & 0xFFu;
        if (i < 4) part |= c << (8 * i);
        else part_hi |= c << (8 * (i - 4));
      }
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // dims dq * 16 + 4 i .. + 3
        if constexpr (FD == 8) {  // DH = 256: lane 2 dq + i / 2 holds them
          w[i] = __shfl_sync(0xffffffffu, (i & 1) ? part_hi : part, dq * 2 + (i >> 1));
        } else if constexpr (FD == 2) {
          const uint32_t lo = __shfl_sync(0xffffffffu, part, dq * 8 + 2 * i);
          const uint32_t hi = __shfl_sync(0xffffffffu, part, dq * 8 + 2 * i + 1);
          w[i] = lo | (hi << 16);
        } else if constexpr (FD == 4) {
          w[i] = __shfl_sync(0xffffffffu, part, dq * 4 + i);
        } else {
          w[i] = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            w[i] |= __shfl_sync(0xffffffffu, part, dq * 16 + 4 * i + k) << (8 * k);
        }
      }
      codes = make_uint4(w[0], w[1], w[2], w[3]);
    };
    quant(k_new, kfresh, ksf);
    quant(v_new, vfresh, vsf);
    if (slot == 0) {
      if constexpr (RAGGED) {
        owc_aligned_as<RAGGED>(align, [&](auto A) {
          owc_store_piece<decltype(A)::value>(kg + (size_t)pos * dh + dq * 16, kfresh, nv);
          owc_store_piece<decltype(A)::value>(vg + (size_t)pos * dh + dq * 16, vfresh, nv);
        });
      } else {
        *reinterpret_cast<uint4*>(kg + (size_t)pos * DH + dq * 16) = kfresh;
        *reinterpret_cast<uint4*>(vg + (size_t)pos * DH + dq * 16) = vfresh;
      }
      if (dq == 0) {
        ksg[pos] = ksf;
        vsg[pos] = vsf;
      }
    }
  }

  float m_run = -INFINITY, l_run = 0.0f, acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
#pragma unroll 1
  for (int s0 = lo; s0 <= pos; s0 += I8_PASS) {
    if (s0 != lo) load(s0);
    if (WRITE) {
#pragma unroll
      for (int t = 0; t < I8_SLOTS; ++t) {
        if (s0 + slot + PW * t == pos) {
          kr[t] = kfresh;
          vr[t] = vfresh;
          ks[t] = ksf;
          vs[t] = vsf;
        }
      }
    }
    // scores: 16 dims a lane, summed over the DQ lanes of a position
    float x[I8_SLOTS], mt = -INFINITY;
#pragma unroll
    for (int t = 0; t < I8_SLOTS; ++t) {
      float kf[16], sc = 0.0f;
      codes16(kr[t], kf);
#pragma unroll
      for (int i = 0; i < 16; ++i) sc = fmaf(qr[i], kf[i], sc);
#pragma unroll
      for (int o = 1; o < DQ; o <<= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
      x[t] = s0 + slot + PW * t <= pos ? sc * ks[t] * LOG2E : -INFINITY;
      mt = fmaxf(mt, x[t]);
    }
    // over the PW position slots (the DQ lanes of a slot agree already);
    // finite, since position s0 attends
#pragma unroll
    for (int o = DQ; o < 32; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
    const float mn = fmaxf(m_run, mt);
    const float corr = ex2(m_run - mn);
    m_run = mn;
    float ls = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= corr;
#pragma unroll
    for (int t = 0; t < I8_SLOTS; ++t) {
      const float p = ex2(x[t] - mn);  // 0 past pos
      ls += p;
      const float pv = p * vs[t];      // the v scale folds in after l
      float vf[16];
      codes16(vr[t], vf);
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = fmaf(pv, vf[i], acc[i]);
    }
#pragma unroll
    for (int o = DQ; o < 32; o <<= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
    l_run = l_run * corr + ls;
  }
  // the value sums over the PW slots; each lane keeps VPL of its 16 dims
  // (2 at DH = 64)
  owc_reduce_scatter<16, DQ>(acc, lane);
  const int d = dq * 16 + owc_scatter_base<16, 16, DQ>(lane);
  if (16 >= PW || (lane & DQ) == 0) {
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      if (!RAGGED || d + i < dh) owc_store(out + (size_t)g * dhr + d + i, acc[i] / l_run);
  }
}

#define OWC_I8_PARAMS                                                                  \
  const T *__restrict__ q, const T *__restrict__ k_new, const T *__restrict__ v_new,     \
      int8_t *k_cache, int8_t *v_cache, float *k_scale, float *v_scale,                  \
      T *__restrict__ out, const int *__restrict__ start, int BH, int S, int pos, int dh, \
      int align, bool write

template <typename T, bool WRITE, int DH>
__global__ void __launch_bounds__(I8_WARPS * 32)
self_attn_update_int8_kernel(OWC_I8_PARAMS) {
  self_attn_int8_body<T, WRITE, DH, false>(q, k_new, v_new, k_cache, v_cache, k_scale,
                                           v_scale, out, start, BH, S, pos, dh, align, write);
}

// The RAGGED bodies, one block an SM at the least: ptxas may then take the
// registers that their element loads need (with no bound it aimed at three
// blocks and spilled a few bytes)
template <typename T, bool WRITE, int DH>
__global__ void __launch_bounds__(I8_WARPS * 32, 1)
self_attn_update_int8_ragged_kernel(OWC_I8_PARAMS) {
  self_attn_int8_body<T, WRITE, DH, true>(q, k_new, v_new, k_cache, v_cache, k_scale,
                                          v_scale, out, start, BH, S, pos, dh, align, write);
}

// the caches' limits (the header's "Long caches")
inline bool sizes_ok(int S, int pos) { return pos >= 0 && pos < S && S <= 2147483391; }

// The launchers of one capacity, whole or RAGGED (the head dim dh at run
// time), over the three element types; cudaErrorInvalidValue where a code
// or a size is out of range.
template <int DH, bool RAGGED, bool WRITE>
int launch_fp(const void* q, const void* k_new, const void* v_new, void* k_cache,
              void* v_cache, void* out, const void* start, int BH, int S, int pos,
              int dtype, int dh, cudaStream_t stream) {
  if (!sizes_ok(S, pos)) return (int)cudaErrorInvalidValue;
  const bool ok = owc_dispatch_float(dtype, [&](auto tag) {
    using T = decltype(tag);
    const int align = owc_align_class((long long)dh * sizeof(T), q, k_new, v_new, k_cache,
                                      v_cache, out);
    // a RAGGED body's one instance takes WRITE at run time
    self_attn_update_kernel<T, RAGGED ? false : WRITE, DH, RAGGED><<<BH, 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_new),
        static_cast<const T*>(v_new), static_cast<T*>(k_cache), static_cast<T*>(v_cache),
        static_cast<T*>(out), static_cast<const int*>(start), S, pos, dh, align, WRITE);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

template <int DH, bool RAGGED, bool WRITE>
int launch_int8(const void* q, const void* k_new, const void* v_new, void* k_cache,
                void* v_cache, void* k_scale, void* v_scale, void* out,
                const void* start, int BH, int S, int pos, int dtype, int dh,
                cudaStream_t stream) {
  if (!sizes_ok(S, pos)) return (int)cudaErrorInvalidValue;
  const int blocks = (BH + I8_WARPS - 1) / I8_WARPS;
  const int align = owc_align_class(dh, k_cache, v_cache);
  const bool ok = owc_dispatch_float(dtype, [&](auto tag) {
    using T = decltype(tag);
#define OWC_I8_ARGS                                                                      \
  static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),  \
      static_cast<int8_t*>(k_cache), static_cast<int8_t*>(v_cache),                      \
      static_cast<float*>(k_scale), static_cast<float*>(v_scale), static_cast<T*>(out),  \
      static_cast<const int*>(start), BH, S, pos, dh, align, WRITE
    if constexpr (RAGGED)   // one instance: WRITE at run time
      self_attn_update_int8_ragged_kernel<T, false, DH><<<blocks, I8_WARPS * 32, 0, stream>>>(
          OWC_I8_ARGS);
    else
      self_attn_update_int8_kernel<T, WRITE, DH><<<blocks, I8_WARPS * 32, 0, stream>>>(
          OWC_I8_ARGS);
#undef OWC_I8_ARGS
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // namespace

// Declares, or with a body defines, the launchers of one capacity, whole
// (`owc_sa_*_d<DH>`, DH <= 128) or RAGGED (`owc_sa_*_r<DH>`), that the C
// entry points of self_attention_step.cu call; `write`: the update (true)
// or the read-only attention.
#define OWC_SA_FP_ARGS                                                                   \
  bool write, const void *q, const void *k_new, const void *v_new, void *k_cache,        \
      void *v_cache, void *out, const void *start, int BH, int S, int pos, int dtype,    \
      int dh, cudaStream_t st
#define OWC_SA_I8_ARGS                                                                   \
  bool write, const void *q, const void *k_new, const void *v_new, void *k_cache,        \
      void *v_cache, void *k_scale, void *v_scale, void *out, const void *start, int BH, \
      int S, int pos, int dtype, int dh, cudaStream_t st
#define OWC_SA_DECLARE(NAME)                    \
  int owc_sa_fp_##NAME(OWC_SA_FP_ARGS);         \
  int owc_sa_int8_##NAME(OWC_SA_I8_ARGS);
#define OWC_SA_DEFINE(NAME, DH, RAGGED)                                                   \
  int owc_sa_fp_##NAME(OWC_SA_FP_ARGS) {                                                  \
    return write ? launch_fp<DH, RAGGED, true>(q, k_new, v_new, k_cache, v_cache, out,    \
                                               start, BH, S, pos, dtype, dh, st)          \
                 : launch_fp<DH, RAGGED, false>(q, k_new, v_new, k_cache, v_cache, out,   \
                                                start, BH, S, pos, dtype, dh, st);        \
  }                                                                                       \
  int owc_sa_int8_##NAME(OWC_SA_I8_ARGS) {                                                \
    return write ? launch_int8<DH, RAGGED, true>(q, k_new, v_new, k_cache, v_cache,       \
                                                 k_scale, v_scale, out, start, BH, S,     \
                                                 pos, dtype, dh, st)                      \
                 : launch_int8<DH, RAGGED, false>(q, k_new, v_new, k_cache, v_cache,      \
                                                  k_scale, v_scale, out, start, BH, S,    \
                                                  pos, dtype, dh, st);                    \
  }
