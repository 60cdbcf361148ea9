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
// Design: one block (256 threads) per (batch, head) row. The q slots sit in
// shared memory as f32. Pass 1: a thread per chunk of positions (one 16-byte
// load: 4 of f32, 8 of bf16 or f16, 16 of int8 and int4) walks the stored rows of k_t
// (neighbouring threads read neighbouring chunks, so each row read is
// coalesced) and keeps chunk x KQ dot products in registers; scores times
// the k scale go to shared memory. Block-wide max/sum reductions give the
// softmax; the probabilities are stored already multiplied by the v scale.
// Pass 2: each warp owns a set of stored rows, its lanes stride along the
// row in 16-byte chunks, and a warp reduction yields out[j, d]. An int4 row
// d holds dim d in the low nibble and dim d + 32 in the high nibble (both
// signed), so it yields two output dims. The storage kind and the slot
// count (1, 4 or 8) are template parameters, so a decode step keeps only one
// chunk of sums per thread in registers. Pass 1 sweeps the K rows once per
// group of 4 slots (at 8 slots twice; the second sweep finds its chunk in
// L1/L2), so that at most 4 x 16 sums live in registers. The TPU kernel
// takes any slot count; here a window longer than 8 slots is several
// launches, each over its own slots of q and out (hence the row stride),
// each reading K/V again.
#include <type_traits>

#include "common.cuh"

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

template <int KIND, int MAXQ, typename Q>
__global__ void __launch_bounds__(THREADS)
cross_attn_grouped_kernel(const Q* __restrict__ q,
                          const typename Store<KIND, Q>::T* __restrict__ k_t,
                          const typename Store<KIND, Q>::T* __restrict__ v_t,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          Q* __restrict__ out, int KQ, int row_stride,
                          int S_pad, int s_valid) {
  using St = Store<KIND, Q>;
  constexpr int ROWS = St::ROWS, VEC = St::VEC, DIMS = St::DIMS;
  constexpr bool SCALED = KIND != KV_FP;
  constexpr int QG = MAXQ < 4 ? MAXQ : 4;  // slots per sweep of pass 1
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;               // [MAXQ][DH]
  float* sc = sm + MAXQ * DH;   // [KQ][S_pad] scores, then probabilities
  __shared__ float red[32];
  __shared__ float inv_l[MAXQ];
  const int g = blockIdx.x, tid = threadIdx.x;
  const typename St::T* kg = k_t + (size_t)g * ROWS * S_pad;
  const typename St::T* vg = v_t + (size_t)g * ROWS * S_pad;
  const float* ksg = SCALED ? k_scale + (size_t)g * S_pad : nullptr;
  const float* vsg = SCALED ? v_scale + (size_t)g * S_pad : nullptr;
  const int nchunks = (s_valid + VEC - 1) / VEC;
  const int s_end = nchunks * VEC;  // <= S_pad (S_pad % VEC == 0)

  for (int i = tid; i < KQ * DH; i += THREADS)
    qs[i] = owc_to_float(q[(size_t)g * row_stride + i]);
  __syncthreads();

  for (int c = tid; c < nchunks; c += THREADS) {
    const int s0 = c * VEC;
#pragma unroll
    for (int j0 = 0; j0 < MAXQ; j0 += QG) {
      if (j0 >= KQ) break;
      float acc[QG][VEC];
#pragma unroll
      for (int j = 0; j < QG; ++j)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[j][v] = 0.0f;
#pragma unroll 4
      for (int r = 0; r < ROWS; ++r) {
        float kv[DIMS][VEC];
        St::load(kg + (size_t)r * S_pad + s0, kv);
#pragma unroll
        for (int j = 0; j < QG; ++j) {
          if (j0 + j < KQ) {
#pragma unroll
            for (int i = 0; i < DIMS; ++i) {
              const float qd = qs[(j0 + j) * DH + r + i * ROWS];
#pragma unroll
              for (int v = 0; v < VEC; ++v) acc[j][v] = fmaf(qd, kv[i][v], acc[j][v]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < QG; ++j) {
        if (j0 + j < KQ) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const int s = s0 + v;
            const float x = SCALED ? acc[j][v] * ksg[s] : acc[j][v];
            sc[(j0 + j) * S_pad + s] = s < s_valid ? x : -INFINITY;
          }
        }
      }
    }
  }
  __syncthreads();

  for (int j = 0; j < KQ; ++j) {
    float* row = sc + j * S_pad;
    float m = -INFINITY;
    for (int s = tid; s < s_end; s += THREADS) m = fmaxf(m, row[s]);
    m = owc_block_max(m, red);
    float l = 0.0f;
    for (int s = tid; s < s_end; s += THREADS) {
      const float p = expf(row[s] - m);  // exactly 0 for masked positions
      l += p;
      // the v scale folds in after l; padding scales may hold anything
      row[s] = SCALED ? (s < s_valid ? p * vsg[s] : 0.0f) : p;
    }
    l = owc_block_sum(l, red);
    if (tid == 0) inv_l[j] = 1.0f / l;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    const typename St::T* vrow = vg + (size_t)r * S_pad;
    float acc[DIMS][MAXQ];
#pragma unroll
    for (int i = 0; i < DIMS; ++i)
#pragma unroll
      for (int j = 0; j < MAXQ; ++j) acc[i][j] = 0.0f;
    for (int c = lane; c < nchunks; c += 32) {
      const int s0 = c * VEC;
      float vv[DIMS][VEC];
      St::load(vrow + s0, vv);
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        if (s0 + v >= s_valid) {  // padding may hold anything
#pragma unroll
          for (int i = 0; i < DIMS; ++i) vv[i][v] = 0.0f;
        }
#pragma unroll
      for (int j = 0; j < MAXQ; ++j) {
        if (j < KQ) {
          const float4* p4 = reinterpret_cast<const float4*>(sc + j * S_pad + s0);
#pragma unroll
          for (int v4 = 0; v4 < VEC / 4; ++v4) {
            const float4 p = p4[v4];
            const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int i = 0; i < DIMS; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[i][j] = fmaf(pv[e], vv[i][4 * v4 + e], acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < DIMS; ++i) {
#pragma unroll
      for (int j = 0; j < MAXQ; ++j) {
        if (j < KQ) {
          const float tot = owc_warp_sum(acc[i][j]);
          if (lane == 0)
            owc_store(out + (size_t)g * row_stride + j * DH + r + i * ROWS,
                      tot * inv_l[j]);
        }
      }
    }
  }
}

template <int KIND, int MAXQ, typename Q>
int launch(const void* q, const void* k_t, const void* v_t, const void* k_scale,
           const void* v_scale, void* out, int BH, int KQ, int row_stride,
           int S_pad, int s_valid, cudaStream_t st) {
  using T = typename Store<KIND, Q>::T;
  const size_t smem = (size_t)(MAXQ * DH + KQ * S_pad) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      cross_attn_grouped_kernel<KIND, MAXQ, Q>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cross_attn_grouped_kernel<KIND, MAXQ, Q><<<BH, THREADS, smem, st>>>(
      static_cast<const Q*>(q), static_cast<const T*>(k_t),
      static_cast<const T*>(v_t), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<Q*>(out), KQ, row_stride,
      S_pad, s_valid);
  return (int)cudaGetLastError();
}

template <int KIND, typename Q>
int launch_slots(const void* q, const void* k_t, const void* v_t,
                 const void* k_scale, const void* v_scale, void* out, int BH,
                 int KQ, int row_stride, int S_pad, int s_valid,
                 cudaStream_t st) {
  if (KQ == 1)
    return launch<KIND, 1, Q>(q, k_t, v_t, k_scale, v_scale, out, BH, KQ,
                              row_stride, S_pad, s_valid, st);
  if (KQ <= 4)
    return launch<KIND, 4, Q>(q, k_t, v_t, k_scale, v_scale, out, BH, KQ,
                              row_stride, S_pad, s_valid, st);
  return launch<KIND, 8, Q>(q, k_t, v_t, k_scale, v_scale, out, BH, KQ,
                            row_stride, S_pad, s_valid, st);
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
// scales. Requires 1 <= KQ <= 8, 1 <= s_valid <= S_pad, S_pad a multiple of
// the kind's 16-byte chunk (4 positions of f32, 8 of bf16 or f16, 16 of
// int8/int4), 16-byte aligned k_t/v_t, and (8 * 64 + KQ * S_pad) * 4 bytes
// of shared memory at most (227 KB is the card's limit).
extern "C" int owc_cross_attention_grouped(const void* q, const void* k_t,
                                           const void* v_t, const void* k_scale,
                                           const void* v_scale, void* out,
                                           int BH, int KQ, int row_stride,
                                           int S_pad, int s_valid, int kind,
                                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KQ < 1 || KQ > 8) return (int)cudaErrorInvalidValue;
  int err = 0;
  const bool ok = dispatch(kind, dtype, [&](auto kind_tag, auto qt) {
    err = launch_slots<decltype(kind_tag)::value, decltype(qt)>(
        q, k_t, v_t, k_scale, v_scale, out, BH, KQ, row_stride, S_pad, s_valid, st);
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
