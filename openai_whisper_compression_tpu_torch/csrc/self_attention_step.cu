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
// What bounds it on the H100: launch latency, then bytes. At whisper-small,
// batch 32, a 64-slot bf16 cache is BH x 64 x 64 x 2 bytes = 3 MB per tensor
// (half that in int8 at batch 32, 4.7 MB at batch 96), a microsecond or two
// of device-memory time; the step is tiny, so the gain is one launch in
// place of the separate quantize, row write, score, softmax and value
// kernels. Only the live cache rows lo..pos are read; the start variants of
// the TPU kernels are one null-able pointer here, not separate bodies.
//
// Design, fp cache: one block (128 threads) per (batch, head) row, which
// owns that row's cache slice: it writes row pos first, and __syncthreads
// makes the write visible before any thread of the block reads the cache
// back. Each warp scores a strided set of positions (lanes split the 64
// dims, warp reduction), block reductions give the softmax, and 64 threads
// sum the value rows (neighbouring threads read neighbouring dims:
// coalesced).
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
// The read-only attention is the same kernel compiled without the write
// (WRITE = false), which reads row pos from memory, so that on the cache an
// update wrote it repeats that update's arithmetic operation for operation
// and returns its output bit for bit.
#include "hopper.cuh"  // ex2

namespace {

constexpr int DH = 64, THREADS = 128;

template <typename T, bool WRITE>
__global__ void __launch_bounds__(THREADS)
self_attn_update_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, T* k_cache, T* v_cache,
                        T* __restrict__ out, const int* __restrict__ start,
                        int S, int pos) {
  extern __shared__ __align__(16) float sc[];  // [pos + 1]
  __shared__ float qs[DH];
  __shared__ float red[32];
  const int g = blockIdx.x, tid = threadIdx.x;
  const int lo = start ? start[g] : 0;  // first position that attends
  T* kg = k_cache + (size_t)g * S * DH;
  T* vg = v_cache + (size_t)g * S * DH;

  if (tid < DH) {
    if (WRITE) {
      kg[(size_t)pos * DH + tid] = k_new[(size_t)g * DH + tid];
      vg[(size_t)pos * DH + tid] = v_new[(size_t)g * DH + tid];
    }
    qs[tid] = owc_to_float(q[(size_t)g * DH + tid]);
  }
  __syncthreads();  // the row write lands before the block reads the cache

  const int lane = tid & 31, warp = tid >> 5;
  for (int s = lo + warp; s <= pos; s += THREADS / 32) {
    const T* krow = kg + (size_t)s * DH;
    float part = qs[lane] * owc_to_float(krow[lane]) +
                 qs[lane + 32] * owc_to_float(krow[lane + 32]);
    part = owc_warp_sum(part);
    if (lane == 0) sc[s] = part;
  }
  __syncthreads();

  float m = -INFINITY;
  for (int s = lo + tid; s <= pos; s += THREADS) m = fmaxf(m, sc[s]);
  m = owc_block_max(m, red);
  float l = 0.0f;
  for (int s = lo + tid; s <= pos; s += THREADS) {
    const float p = expf(sc[s] - m);
    sc[s] = p;
    l += p;
  }
  l = owc_block_sum(l, red);  // ends with a barrier: sc holds probabilities

  if (tid < DH) {
    float acc = 0.0f;
    for (int s = lo; s <= pos; ++s)
      acc = fmaf(sc[s], owc_to_float(vg[(size_t)s * DH + tid]), acc);
    owc_store(out + (size_t)g * DH + tid, acc / l);
  }
}

// int8 cache: a warp per (batch, head) row, I8_WARPS rows a block. Lane l
// holds dims 16 (l & 3) .. + 15 and the positions lo + (l >> 2) + 8 t of a
// pass (t < I8_SLOTS): a 64-byte cache row is 4 lanes' 16-byte pieces, so
// one warp load brings 8 positions, and a lane issues all of a pass's K and
// V loads and scales together: one memory latency a 64-position pass.
constexpr int I8_WARPS = 4;
constexpr int I8_SLOTS = 8;
constexpr int I8_PASS = 8 * I8_SLOTS;  // positions a pass covers
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void codes16(const uint4& u, float (&f)[16]) {
  owc_int8x4_to_float(u.x, f);
  owc_int8x4_to_float(u.y, f + 4);
  owc_int8x4_to_float(u.z, f + 8);
  owc_int8x4_to_float(u.w, f + 12);
}

template <typename T, bool WRITE>
__global__ void __launch_bounds__(I8_WARPS * 32)
self_attn_update_int8_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                             const T* __restrict__ v_new, int8_t* k_cache,
                             int8_t* v_cache, float* k_scale, float* v_scale,
                             T* __restrict__ out, const int* __restrict__ start,
                             int BH, int S, int pos) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * I8_WARPS + (threadIdx.x >> 5);
  if (g >= BH) return;  // a whole warp: no barrier below spans warps
  const int dq = lane & 3, slot = lane >> 2;
  const int lo = start ? start[g] : 0;  // first position that attends
  int8_t* kg = k_cache + (size_t)g * S * DH;
  int8_t* vg = v_cache + (size_t)g * S * DH;
  float* ksg = k_scale + (size_t)g * S;
  float* vsg = v_scale + (size_t)g * S;

  float qr[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) qr[i] = owc_to_float(q[(size_t)g * DH + dq * 16 + i]);

  // a pass's 8 K and 8 V pieces and scales of this lane, all in flight
  // together: positions s0 + slot + 8 t up to pos (zero codes and scales
  // past it); row pos only where this kernel does not write it
  uint4 kr[I8_SLOTS], vr[I8_SLOTS];
  float ks[I8_SLOTS], vs[I8_SLOTS];
  auto load = [&](int s0) {
#pragma unroll
    for (int t = 0; t < I8_SLOTS; ++t) {
      const int s = s0 + slot + 8 * t;
      kr[t] = vr[t] = make_uint4(0, 0, 0, 0);
      ks[t] = vs[t] = 0.0f;
      if (s <= pos && !(WRITE && s == pos)) {
        const size_t off = (size_t)s * DH + dq * 16;
        kr[t] = *reinterpret_cast<const uint4*>(kg + off);
        vr[t] = *reinterpret_cast<const uint4*>(vg + off);
        ks[t] = ksg[s];
        vs[t] = vsg[s];
      }
    }
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
      const float x0 = owc_to_float(src[(size_t)g * DH + 2 * lane]);
      const float x1 = owc_to_float(src[(size_t)g * DH + 2 * lane + 1]);
      const float a = owc_warp_max(fmaxf(fabsf(x0), fabsf(x1)));
      scale = fmaxf(a, 1e-12f) * (1.0f / 127.0f);
      const uint32_t pair = ((uint32_t)owc_quant_int8(x0, scale) & 0xFFu) |
                            (((uint32_t)owc_quant_int8(x1, scale) & 0xFFu) << 8);
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // dims dq * 16 + 4 i .. + 3
        const uint32_t lo = __shfl_sync(0xffffffffu, pair, dq * 8 + 2 * i);
        const uint32_t hi = __shfl_sync(0xffffffffu, pair, dq * 8 + 2 * i + 1);
        w[i] = lo | (hi << 16);
      }
      codes = make_uint4(w[0], w[1], w[2], w[3]);
    };
    quant(k_new, kfresh, ksf);
    quant(v_new, vfresh, vsf);
    if (slot == 0) {
      *reinterpret_cast<uint4*>(kg + (size_t)pos * DH + dq * 16) = kfresh;
      *reinterpret_cast<uint4*>(vg + (size_t)pos * DH + dq * 16) = vfresh;
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
        if (s0 + slot + 8 * t == pos) {
          kr[t] = kfresh;
          vr[t] = vfresh;
          ks[t] = ksf;
          vs[t] = vsf;
        }
      }
    }
    // scores: 16 dims a lane, summed over the 4 lanes of a position
    float x[I8_SLOTS], mt = -INFINITY;
#pragma unroll
    for (int t = 0; t < I8_SLOTS; ++t) {
      float kf[16], sc = 0.0f;
      codes16(kr[t], kf);
#pragma unroll
      for (int i = 0; i < 16; ++i) sc = fmaf(qr[i], kf[i], sc);
      sc += __shfl_xor_sync(0xffffffffu, sc, 1);
      sc += __shfl_xor_sync(0xffffffffu, sc, 2);
      x[t] = s0 + slot + 8 * t <= pos ? sc * ks[t] * LOG2E : -INFINITY;
      mt = fmaxf(mt, x[t]);
    }
    // over the 8 position slots (the 4 lanes of a slot agree already);
    // finite, since position s0 attends
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 8));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
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
    ls += __shfl_xor_sync(0xffffffffu, ls, 4);
    ls += __shfl_xor_sync(0xffffffffu, ls, 8);
    ls += __shfl_xor_sync(0xffffffffu, ls, 16);
    l_run = l_run * corr + ls;
  }
  // the value sums over the 8 slots; each lane keeps 2 of its 16 dims
  owc_reduce_scatter8(acc, lane);
  const int d = dq * 16 + owc_scatter_base<16>(lane);
  owc_store(out + (size_t)g * DH + d, acc[0] / l_run);
  owc_store(out + (size_t)g * DH + d + 1, acc[1] / l_run);
}

template <bool WRITE>
int launch_fp(const void* q, const void* k_new, const void* v_new, void* k_cache,
              void* v_cache, void* out, const void* start, int BH, int S, int pos,
              int dtype, void* stream) {
  const size_t smem = (size_t)(pos + 1) * sizeof(float);
  const bool ok = owc_dispatch_float(dtype, [&](auto tag) {
    using T = decltype(tag);
    self_attn_update_kernel<T, WRITE>
        <<<BH, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(q), static_cast<const T*>(k_new),
            static_cast<const T*>(v_new), static_cast<T*>(k_cache),
            static_cast<T*>(v_cache), static_cast<T*>(out),
            static_cast<const int*>(start), S, pos);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

template <bool WRITE>
int launch_int8(const void* q, const void* k_new, const void* v_new, void* k_cache,
                void* v_cache, void* k_scale, void* v_scale, void* out,
                const void* start, int BH, int S, int pos, int dtype, void* stream) {
  const int blocks = (BH + I8_WARPS - 1) / I8_WARPS;
  const bool ok = owc_dispatch_float(dtype, [&](auto tag) {
    using T = decltype(tag);
    self_attn_update_int8_kernel<T, WRITE>
        <<<blocks, I8_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(q), static_cast<const T*>(k_new),
            static_cast<const T*>(v_new), static_cast<int8_t*>(k_cache),
            static_cast<int8_t*>(v_cache), static_cast<float*>(k_scale),
            static_cast<float*>(v_scale), static_cast<T*>(out),
            static_cast<const int*>(start), BH, S, pos);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // namespace

// In every entry point `dtype` is the code (common.cuh) of the element type
// that q, the fresh rows, an fp cache and out share: f32, bf16 or f16.

// q/k_new/v_new (BH, 64), k_cache/v_cache (BH, S, 64) updated in place,
// out (BH, 64). start: (BH,) int32 first attending position of each row, or
// null for 0. Requires 0 <= start[g] <= pos < S <= 12288.
extern "C" int owc_self_attention_update(const void* q, const void* k_new,
                                         const void* v_new, void* k_cache,
                                         void* v_cache, void* out,
                                         const void* start, int BH, int S,
                                         int pos, int dtype, void* stream) {
  return launch_fp<true>(q, k_new, v_new, k_cache, v_cache, out, start, BH, S, pos,
                         dtype, stream);
}

// The same attention over caches whose row pos is already written; nothing
// is written but out. q (BH, 64), k_cache/v_cache (BH, S, 64), out (BH, 64);
// start as above. Requires 0 <= start[g] <= pos < S <= 12288.
extern "C" int owc_self_attention(const void* q, void* k_cache, void* v_cache,
                                  void* out, const void* start, int BH, int S,
                                  int pos, int dtype, void* stream) {
  return launch_fp<false>(q, nullptr, nullptr, k_cache, v_cache, out, start, BH, S,
                          pos, dtype, stream);
}

// q/k_new/v_new (BH, 64); k_cache/v_cache (BH, S, 64) int8 and
// k_scale/v_scale (BH, S) f32, all four updated in place at row pos;
// out (BH, 64). start: (BH,) int32 first attending position of each row, or
// null for 0. Requires 0 <= start[g] <= pos < S <= 12288.
extern "C" int owc_self_attention_update_int8(const void* q, const void* k_new,
                                              const void* v_new, void* k_cache,
                                              void* v_cache, void* k_scale,
                                              void* v_scale, void* out,
                                              const void* start, int BH, int S,
                                              int pos, int dtype, void* stream) {
  return launch_int8<true>(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, out,
                           start, BH, S, pos, dtype, stream);
}

// The same attention over an int8 cache whose row pos (codes and scales) is
// already written; nothing is written but out. q (BH, 64), k_cache/v_cache
// (BH, S, 64) int8, k_scale/v_scale (BH, S) f32, out (BH, 64); start as
// above. Requires 0 <= start[g] <= pos < S <= 12288.
extern "C" int owc_self_attention_int8(const void* q, void* k_cache,
                                       void* v_cache, void* k_scale,
                                       void* v_scale, void* out,
                                       const void* start, int BH, int S,
                                       int pos, int dtype, void* stream) {
  return launch_int8<false>(q, nullptr, nullptr, k_cache, v_cache, k_scale, v_scale,
                            out, start, BH, S, pos, dtype, stream);
}
