// Grouped decode cross-attention over transposed encoder K/V.
//
// Replaces: openai_whisper_compression_tpu/ops/cross_attention.py
//           decode_cross_attention_grouped (bf16 body _beam_core via
//           _kernel_beam).
// Computes, for each (batch, head) row g of BH and each of its KQ query
// slots j (KQ = 1 in a decode step, KQ = prefix length - 1 in prefill):
//   scores[j, s] = sum_d q[g, j, d] * k_t[g, d, s]          (q pre-scaled)
//   p[j, :]      = softmax(scores[j, :]) with s >= s_valid masked to
//                  probability exactly zero
//   out[g, j, d] = sum_s p[j, s] * v_t[g, d, s]
// in f32, from bf16 q/K/V, output in bf16.
//
// What bounds it on the H100: device-memory bytes. Every decode step reads
// the whole cross K/V once: BH x 64 x S_pad x 2 tensors x 2 bytes (151 MB
// per layer at whisper-small, batch 32), against 4 x KQ FLOPs per element,
// far below the balance point. The design reads each K/V element once per
// call, in 16-byte loads, and shares it across the KQ query slots of its
// row; past s_valid only the tail of the last 8-position chunk is read, and
// masked.
//
// Design: one block (256 threads) per (batch, head) row. The q slots sit in
// shared memory as f32. Pass 1: a thread per 8-position chunk walks the 64
// rows of k_t (one 16-byte load per row; neighbouring threads read
// neighbouring chunks, so each row read is coalesced) and keeps 8 x KQ dot
// products in registers; scores go to shared memory. Block-wide max/sum
// reductions give the softmax. Pass 2: each warp owns 8 of the 64 value
// rows, its lanes stride along the row in 16-byte chunks, and a warp
// reduction yields out[j, d]. The slot count is a template parameter
// (1 or 4), so a decode step keeps only 8 sums per thread in registers.
// Beam widths (KQ up to 8) wait for the beam-search slice.
#include "common.cuh"

namespace {

constexpr int DH = 64, THREADS = 256, VEC = 8;
using T = __nv_bfloat16;

// 8 consecutive bf16 elements as f32, in one 16-byte load.
__device__ __forceinline__ void load8(const T* p, float out[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int MAXQ>
__global__ void __launch_bounds__(THREADS)
cross_attn_grouped_kernel(const T* __restrict__ q, const T* __restrict__ k_t,
                          const T* __restrict__ v_t, T* __restrict__ out,
                          int KQ, int S_pad, int s_valid) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;               // [MAXQ][DH]
  float* sc = sm + MAXQ * DH;   // [KQ][S_pad] scores, then probabilities
  __shared__ float red[32];
  __shared__ float inv_l[MAXQ];
  const int g = blockIdx.x, tid = threadIdx.x;
  const T* kg = k_t + (size_t)g * DH * S_pad;
  const T* vg = v_t + (size_t)g * DH * S_pad;
  const int nchunks = (s_valid + VEC - 1) / VEC;
  const int s_end = nchunks * VEC;  // <= S_pad (S_pad % 8 == 0)

  for (int i = tid; i < KQ * DH; i += THREADS)
    qs[i] = owc_to_float(q[(size_t)g * KQ * DH + i]);
  __syncthreads();

  for (int c = tid; c < nchunks; c += THREADS) {
    const int s0 = c * VEC;
    float acc[MAXQ][VEC];
#pragma unroll
    for (int j = 0; j < MAXQ; ++j)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[j][v] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float kv[VEC];
      load8(kg + (size_t)d * S_pad + s0, kv);
#pragma unroll
      for (int j = 0; j < MAXQ; ++j) {
        if (j < KQ) {
          const float qd = qs[j * DH + d];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[j][v] = fmaf(qd, kv[v], acc[j][v]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MAXQ; ++j) {
      if (j < KQ) {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          sc[j * S_pad + s0 + v] = s0 + v < s_valid ? acc[j][v] : -INFINITY;
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
      row[s] = p;
      l += p;
    }
    l = owc_block_sum(l, red);
    if (tid == 0) inv_l[j] = 1.0f / l;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  for (int d = warp; d < DH; d += THREADS / 32) {
    const T* vrow = vg + (size_t)d * S_pad;
    float acc[MAXQ];
#pragma unroll
    for (int j = 0; j < MAXQ; ++j) acc[j] = 0.0f;
    for (int c = lane; c < nchunks; c += 32) {
      const int s0 = c * VEC;
      float vv[VEC];
      load8(vrow + s0, vv);
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        if (s0 + v >= s_valid) vv[v] = 0.0f;  // padding may hold anything
#pragma unroll
      for (int j = 0; j < MAXQ; ++j) {
        if (j < KQ) {
          const float* p = sc + j * S_pad + s0;
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[j] = fmaf(p[v], vv[v], acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MAXQ; ++j) {
      if (j < KQ) {
        const float tot = owc_warp_sum(acc[j]);
        if (lane == 0) owc_store(out + ((size_t)g * KQ + j) * DH + d, tot * inv_l[j]);
      }
    }
  }
}

template <int MAXQ>
int launch(const void* q, const void* k_t, const void* v_t, void* out, int BH,
           int KQ, int S_pad, int s_valid, cudaStream_t st) {
  const size_t smem = (size_t)(MAXQ * DH + KQ * S_pad) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      cross_attn_grouped_kernel<MAXQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cross_attn_grouped_kernel<MAXQ><<<BH, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_t),
      static_cast<const T*>(v_t), static_cast<T*>(out), KQ, S_pad, s_valid);
  return (int)cudaGetLastError();
}

}  // namespace

// q (BH, KQ, 64), k_t/v_t (BH, 64, S_pad), out (BH, KQ, 64), all bf16.
// Requires 1 <= KQ <= 4, 1 <= s_valid <= S_pad, S_pad % 8 == 0, 16-byte
// aligned k_t/v_t, and (4 * 64 + KQ * S_pad) * 4 bytes of shared memory
// (at most 227 KB).
extern "C" int owc_cross_attention_grouped(const void* q, const void* k_t,
                                           const void* v_t, void* out, int BH,
                                           int KQ, int S_pad, int s_valid,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KQ == 1) return launch<1>(q, k_t, v_t, out, BH, KQ, S_pad, s_valid, st);
  return launch<4>(q, k_t, v_t, out, BH, KQ, S_pad, s_valid, st);
}
