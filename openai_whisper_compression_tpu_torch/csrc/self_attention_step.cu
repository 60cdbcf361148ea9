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
// Design: one block (128 threads) per (batch, head) row, which owns that
// row's cache slice: it writes row pos first (in the int8 kernel warp 0
// quantizes k and warp 1 quantizes v, each with a warp absmax), and
// __syncthreads makes the write visible before any thread of the block
// reads the cache back (the caches are not read through the read-only
// path). Each warp scores a strided set of positions (lanes split the 64
// dims, warp reduction), block reductions give the softmax, and 64 threads
// sum the value rows (neighbouring threads read neighbouring dims:
// coalesced). The read-only attention is the same kernel compiled without
// the write (WRITE = false), so that on the cache an update wrote it repeats
// that update's arithmetic operation for operation and returns its output
// bit for bit.
#include "common.cuh"

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

template <typename T, bool WRITE>
__global__ void __launch_bounds__(THREADS)
self_attn_update_int8_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                             const T* __restrict__ v_new, int8_t* k_cache,
                             int8_t* v_cache, float* k_scale, float* v_scale,
                             T* __restrict__ out,
                             const int* __restrict__ start, int S, int pos) {
  extern __shared__ __align__(16) float sc[];  // [pos + 1]
  __shared__ float qs[DH];
  __shared__ float red[32];
  const int g = blockIdx.x, tid = threadIdx.x;
  const int lo = start ? start[g] : 0;  // first position that attends
  const int lane = tid & 31, warp = tid >> 5;
  int8_t* kg = k_cache + (size_t)g * S * DH;
  int8_t* vg = v_cache + (size_t)g * S * DH;
  float* ksg = k_scale + (size_t)g * S;
  float* vsg = v_scale + (size_t)g * S;

  if (WRITE && warp < 2) {  // warp 0 quantizes and writes the k row, warp 1 the v row
    const T* src = (warp == 0 ? k_new : v_new) + (size_t)g * DH;
    const float a = owc_to_float(src[lane]), b = owc_to_float(src[lane + 32]);
    const float absmax = owc_warp_max(fmaxf(fabsf(a), fabsf(b)));
    const float scale = fmaxf(absmax, 1e-12f) * (1.0f / 127.0f);
    int8_t* row = (warp == 0 ? kg : vg) + (size_t)pos * DH;
    row[lane] = (int8_t)owc_quant_int8(a, scale);
    row[lane + 32] = (int8_t)owc_quant_int8(b, scale);
    if (lane == 0) (warp == 0 ? ksg : vsg)[pos] = scale;
  } else if (warp == 2) {
    qs[lane] = owc_to_float(q[(size_t)g * DH + lane]);
    qs[lane + 32] = owc_to_float(q[(size_t)g * DH + lane + 32]);
  }
  __syncthreads();  // the row and scale writes land before the block reads

  for (int s = lo + warp; s <= pos; s += THREADS / 32) {
    const int8_t* krow = kg + (size_t)s * DH;
    float part = qs[lane] * (float)krow[lane] + qs[lane + 32] * (float)krow[lane + 32];
    part = owc_warp_sum(part);
    if (lane == 0) sc[s] = part * ksg[s];
  }
  __syncthreads();

  float m = -INFINITY;
  for (int s = lo + tid; s <= pos; s += THREADS) m = fmaxf(m, sc[s]);
  m = owc_block_max(m, red);
  float l = 0.0f;
  for (int s = lo + tid; s <= pos; s += THREADS) {
    const float p = expf(sc[s] - m);
    l += p;
    sc[s] = p * vsg[s];  // the v scale folds in after l
  }
  l = owc_block_sum(l, red);  // ends with a barrier: sc holds p * v_scale

  if (tid < DH) {
    float acc = 0.0f;
    for (int s = lo; s <= pos; ++s)
      acc = fmaf(sc[s], (float)vg[(size_t)s * DH + tid], acc);
    owc_store(out + (size_t)g * DH + tid, acc / l);
  }
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
  const size_t smem = (size_t)(pos + 1) * sizeof(float);
  const bool ok = owc_dispatch_float(dtype, [&](auto tag) {
    using T = decltype(tag);
    self_attn_update_int8_kernel<T, WRITE>
        <<<BH, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(q), static_cast<const T*>(k_new),
            static_cast<const T*>(v_new), static_cast<int8_t*>(k_cache),
            static_cast<int8_t*>(v_cache), static_cast<float*>(k_scale),
            static_cast<float*>(v_scale), static_cast<T*>(out),
            static_cast<const int*>(start), S, pos);
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
