// The WIDE body of the fused cache update + decode self-attention kernels
// and of the read-only attention: head dims past 256, taken at run time,
// over an fp cache and over an int8 cache with per-position scales.
//
// Replaces: openai_whisper_compression_tpu/ops/self_attention_step.py
//           decode_self_attention_update, decode_self_attention_update_int8
//           and decode_self_attention (with and without start) at the head
//           dims the bodies of self_attention_step.cuh do not hold: those
//           keep a lane's pieces of a pass's K and V rows in registers,
//           which grow with the head dim.
// Computes what self_attention_step.cuh computes, for each (batch, head)
// row g with lo = start[g] (0 where start is null):
//   fp cache:   row pos of k_cache/v_cache = k_new/v_new (the update), then
//               out = softmax_s(q . k_cache[s]) . v_cache[s], lo <= s <= pos
//   int8 cache: the fresh rows quantized first, scale = max(absmax over dh,
//               1e-12) * f32(1 / 127), code = clamp(rint(x / scale), -127,
//               127) (IEEE division, as the plain version and the JAX
//               package's jitted quantizer round), written with their
//               scales at pos; then scores (q . codes[s]) * k_scale[s],
//               p = exp(scores - max), l = sum p, out = sum p * v_scale[s] *
//               v_codes[s] / l
// in f32, from q, the fresh rows and an fp cache of one element type (f32,
// bf16 or f16; with an int8 cache only q, the fresh rows and out have it).
//
// What bounds it on the H100: bytes, 2 x dh x (pos + 1 - lo) cache elements a
// row; a head dim past 256 is on no Whisper model's path, so the body is a
// simple one that is right, not one tuned to that bound.
//
// Design: a block of 128 threads takes one row g and one piece of 128
// output dims (ceil(dh / 128) pieces a row, blockIdx.y), and walks lo..pos
// in rounds of 128 positions: thread t makes the score of position s0 + t
// (its cache row read along dh, q staged in shared memory 128 dims at a
// time, so no register array grows with dh); the online softmax is
// block-wide (shuffles and shared memory); then thread t adds the round's
// positions into output dim piece * 128 + t (a warp reads 32 neighbouring
// dims of a cache row). The update's fresh rows: every block takes the
// int8 scales' absmax over the whole dh first (a block reduction, the same
// in every block), the block of piece 0 writes row pos (codes and scales),
// and every block attends row pos from k_new/v_new (for int8 the codes it
// writes, quantized once a chunk of dims outside the loops that read them)
// in place of the cache: no block reads a row another block writes. The read-only attention is the same code reading
// row pos from the cache, so on the cache an update wrote it repeats that
// update's arithmetic and returns its output bit for bit.
#include "common.cuh"
#include "hopper.cuh"  // ex2

namespace {

constexpr int W_THREADS = 128;   // positions of a round; output dims of a piece
constexpr float LOG2E = 1.4426950408889634f;

// Block-wide reduction of one value a thread (red: 4 floats of shared
// memory); every thread gets the result.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = MAX ? owc_warp_max(x) : owc_warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = MAX ? fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]))
          : (red[0] + red[1]) + (red[2] + red[3]);
  __syncthreads();
  return x;
}

// A cache element as f32 (exact): an int8 code, or an fp cache's value.
__device__ __forceinline__ float cached(int8_t x) { return (float)x; }
template <typename C>
__device__ __forceinline__ float cached(C x) { return owc_to_float(x); }

// One body for both caches: C is the cache's element type (T, or int8_t with
// scales). `write`: the update (row pos from the fresh rows) or the
// read-only attention (row pos from the cache).
template <typename T, typename C>
__global__ void __launch_bounds__(W_THREADS)
self_attn_wide_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                      const T* __restrict__ v_new, C* k_cache, C* v_cache, float* k_scale,
                      float* v_scale, T* __restrict__ out, const int* __restrict__ start,
                      int S, int pos, int dh, bool write) {
  constexpr bool I8 = std::is_same<C, int8_t>::value;
  __shared__ float qs[W_THREADS];
  __shared__ float kfs[W_THREADS];   // the update's fresh k row at q's chunk of dims
  __shared__ float ps[W_THREADS];
  __shared__ float red[4];
  const long long g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lo = start ? start[g] : 0;
  C* kc = k_cache + g * S * (long long)dh;
  C* vc = v_cache + g * S * (long long)dh;
  const float* ksg = I8 ? k_scale + g * S : nullptr;
  const float* vsg = I8 ? v_scale + g * S : nullptr;
  const T* qg = q + g * dh;
  const T* kn = write ? k_new + g * dh : nullptr;
  const T* vn = write ? v_new + g * dh : nullptr;
  const int d_out = blockIdx.y * W_THREADS + tid;
  const bool has_dim = d_out < dh;

  // the fresh rows' scales (int8): the absmax over the whole dh
  float ksf = 0.0f, vsf = 0.0f;
  if (I8 && write) {
    float ak = 0.0f, av = 0.0f;
    for (int d = tid; d < dh; d += W_THREADS) {
      ak = fmaxf(ak, fabsf(owc_to_float(kn[d])));
      av = fmaxf(av, fabsf(owc_to_float(vn[d])));
    }
    ksf = fmaxf(block_reduce<true>(ak, red), 1e-12f) * (1.0f / 127.0f);
    vsf = fmaxf(block_reduce<true>(av, red), 1e-12f) * (1.0f / 127.0f);
  }
  // row pos as stored (piece 0's block writes it)
  if (write && blockIdx.y == 0) {
    for (int d = tid; d < dh; d += W_THREADS) {
      if constexpr (I8) {
        kc[(long long)pos * dh + d] = (int8_t)owc_quant_int8(owc_to_float(kn[d]), ksf);
        vc[(long long)pos * dh + d] = (int8_t)owc_quant_int8(owc_to_float(vn[d]), vsf);
      } else {
        kc[(long long)pos * dh + d] = kn[d];
        vc[(long long)pos * dh + d] = vn[d];
      }
    }
    if (I8 && tid == 0) {
      k_scale[g * S + pos] = ksf;
      v_scale[g * S + pos] = vsf;
    }
  }
  // row pos as the update attends it: the fresh value at dim d as stored
  // (int8: its code), made outside the loops that read it
  auto fresh = [&](const T* row, float scale, int d) -> float {
    if constexpr (I8) return (float)owc_quant_int8(owc_to_float(row[d]), scale);
    else return owc_to_float(row[d]);
  };
  const float vfresh = write && has_dim ? fresh(vn, vsf, d_out) : 0.0f;

  float m_run = -INFINITY, l_part = 0.0f, o = 0.0f;
  for (int s0 = lo; s0 <= pos; s0 += W_THREADS) {
    const int s = s0 + tid;
    const bool valid = s <= pos;
    float acc = 0.0f;
    for (int d0 = 0; d0 < dh; d0 += W_THREADS) {
      __syncthreads();   // the previous chunk of q has been read
      qs[tid] = d0 + tid < dh ? owc_to_float(qg[d0 + tid]) : 0.0f;
      if (write) kfs[tid] = d0 + tid < dh ? fresh(kn, ksf, d0 + tid) : 0.0f;
      __syncthreads();
      if (valid) {
        const int n = min(W_THREADS, dh - d0);
        const C* krow = kc + (long long)s * dh + d0;
        if (write && s == pos) {
          for (int i = 0; i < n; ++i) acc = fmaf(qs[i], kfs[i], acc);
        } else {
#pragma unroll 4
          for (int i = 0; i < n; ++i) acc = fmaf(qs[i], cached(krow[i]), acc);
        }
      }
    }
    float x = -INFINITY;
    if (valid) {
      const float ks = I8 ? (write && s == pos ? ksf : ksg[s]) : 1.0f;
      x = (I8 ? acc * ks : acc) * LOG2E;
    }
    const float mn = fmaxf(m_run, block_reduce<true>(x, red));  // finite: s0 is valid
    const float corr = ex2(m_run - mn);
    m_run = mn;
    const float p = ex2(x - mn);   // 0 past pos
    l_part = l_part * corr + p;
    float pv = p;
    if (I8 && valid) pv = p * (write && s == pos ? vsf : vsg[s]);   // after l
    ps[tid] = pv;
    o *= corr;
    __syncthreads();
    if (has_dim) {
      const int n = min(W_THREADS, pos + 1 - s0);
      const C* vcol = vc + (long long)s0 * dh + d_out;
#pragma unroll 4
      for (int i = 0; i < n; ++i)
        o = fmaf(ps[i], write && s0 + i == pos ? vfresh : cached(vcol[(long long)i * dh]), o);
    }
  }
  const float l = block_reduce<false>(l_part, red);
  if (has_dim) owc_store(out + g * dh + d_out, o / l);
}

inline bool wide_sizes_ok(int S, int pos, int dh) {
  return pos >= 0 && pos < S && S <= 2147483391 && dh >= 1 &&
         (dh + W_THREADS - 1) / W_THREADS <= 65535;
}

}  // namespace

// The WIDE launchers that self_attention_step.cu's entry points call at cap
// OWC_WIDE: arguments as the whole and RAGGED launchers take them
// (self_attention_step.cuh's OWC_SA_FP_ARGS and OWC_SA_I8_ARGS); `write`:
// the update, or the read-only attention. Rows need element alignment only.
int owc_sa_fp_wide(bool write, const void* q, const void* k_new, const void* v_new,
                   void* k_cache, void* v_cache, void* out, const void* start, int BH, int S,
                   int pos, int dtype, int dh, cudaStream_t st) {
  if (!wide_sizes_ok(S, pos, dh)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)BH, (unsigned)((dh + W_THREADS - 1) / W_THREADS));
  const bool ok = owc_dispatch_float(dtype, [&](auto tag) {
    using T = decltype(tag);
    self_attn_wide_kernel<T, T><<<grid, W_THREADS, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
        static_cast<T*>(k_cache), static_cast<T*>(v_cache), nullptr, nullptr,
        static_cast<T*>(out), static_cast<const int*>(start), S, pos, dh, write);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

int owc_sa_int8_wide(bool write, const void* q, const void* k_new, const void* v_new,
                     void* k_cache, void* v_cache, void* k_scale, void* v_scale, void* out,
                     const void* start, int BH, int S, int pos, int dtype, int dh,
                     cudaStream_t st) {
  if (!wide_sizes_ok(S, pos, dh)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)BH, (unsigned)((dh + W_THREADS - 1) / W_THREADS));
  const bool ok = owc_dispatch_float(dtype, [&](auto tag) {
    using T = decltype(tag);
    self_attn_wide_kernel<T, int8_t><<<grid, W_THREADS, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
        static_cast<int8_t*>(k_cache), static_cast<int8_t*>(v_cache),
        static_cast<float*>(k_scale), static_cast<float*>(v_scale), static_cast<T*>(out),
        static_cast<const int*>(start), S, pos, dh, write);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}
