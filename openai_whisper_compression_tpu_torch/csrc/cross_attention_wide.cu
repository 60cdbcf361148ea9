// The WIDE body of the decode cross-attention kernels: head dims past 256,
// taken at run time, for every storage kind and q type.
//
// Replaces: openai_whisper_compression_tpu/ops/cross_attention.py
//           decode_cross_attention_grouped and decode_cross_attention
//           (their bodies over _beam_core) at the head dims the bodies of
//           cross_attention.cuh do not hold: those keep a k step of q, or a
//           stored row of K and V, a lane in registers, which grows with the
//           head dim. A one-query call runs this body at one slot.
// Computes what cross_attention.cuh computes: for each (batch, head) row g
// and each of its KQ <= 8 query slots j,
//   scores[j, s] = (sum_d q[g, j, d] * k_t[g, d, s]) * k_scale[g, s], s < s_valid
//   p[j, s] = exp(scores[j, s] - max_s), l[j] = sum_s p[j, s]
//   out[g, j, d] = sum_s p[j, s] * v_scale[g, s] * v_t[g, d, s] / l[j]
// in f32, from q in f32, bf16 or f16 and K/V in q's type (no scales), int8
// or split-half packed int4 (row r holds dims r and r + dh / 2) with scales;
// output in q's type. l is summed before the v-scale fold. Unlike the
// 16-bit bodies of cross_attention.cuh, the probabilities are not rounded to
// q's type before the value product: every product runs on the CUDA cores
// in f32, as the plain version computes it.
//
// What bounds it on the H100: device-memory bytes, 2 x dh x s_valid stored
// elements a row; a head dim past 256 is on no Whisper model's path, so the
// body is a simple one that is right, not one tuned to that bound.
//
// Design: a block of 128 threads takes one row g and one piece of 128
// output dims (ceil(dh / 128) pieces a row, blockIdx.y; each piece makes the
// row's scores again), and walks s_valid in rounds of 128 positions:
// - Scores: thread t takes position s0 + t, its KQ sums in registers; q is
//   staged in shared memory 128 dims (stored rows) at a time, so that no
//   register array grows with dh, and a warp reads each stored row of K as
//   32 neighbouring positions.
// - The online softmax is block-wide: a round's maximum of each slot by
//   shuffles and shared memory; each thread keeps its share of l (scaled as
//   the maximum moves) and the shares are summed at the end.
// - Values: thread t takes output dim piece * 128 + t and reads its stored
//   row of V along the round's positions in 16-byte pieces (the same row
//   for int4's low and high halves), times the round's probabilities (with
//   the v scale folded in) from shared memory.
// Positions past s_valid are never read but inside a 16-byte piece of V that
// straddles it, whose values there are taken as zero.
#include "cross_attention.cuh"  // the storage kinds, `dispatch`, G_MAXQ, LOG2E

namespace {

constexpr int W_THREADS = 128;   // positions of a round; output dims of a piece
constexpr int W_MAXQ = G_MAXQ;   // slots a launch holds
constexpr int W_QCHUNK = 128;    // dims (stored rows) of q staged at a time

// the stored element of a kind with q type Q (no head dim: any)
template <int KIND, typename Q> using Stored = Store<KIND, Q, 16>;

// Block-wide maximum of one value a thread, for each of W_MAXQ slots (red:
// [4 warps][W_MAXQ] of shared memory; every thread gets the result).
__device__ __forceinline__ void block_max(float (&x)[W_MAXQ], float (*red)[W_MAXQ]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < W_MAXQ; ++j) {
    const float m = owc_warp_max(x[j]);
    if (lane == 0) red[warp][j] = m;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < W_MAXQ; ++j)
    x[j] = fmaxf(fmaxf(red[0][j], red[1][j]), fmaxf(red[2][j], red[3][j]));
  __syncthreads();
}

template <int KIND, typename Q>
__global__ void __launch_bounds__(W_THREADS)
cross_attn_wide_kernel(const Q* __restrict__ q,
                       const typename Stored<KIND, Q>::T* __restrict__ k_t,
                       const typename Stored<KIND, Q>::T* __restrict__ v_t,
                       const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                       Q* __restrict__ out, int KQ, int row_stride, int S_pad, int s_valid,
                       int dh) {
  using T = typename Stored<KIND, Q>::T;
  constexpr bool SCALED = KIND != KV_FP;
  constexpr int VEC = 16 / sizeof(T);   // positions in a 16-byte piece of V
  __shared__ float qs[2][W_MAXQ][W_QCHUNK];   // q at a chunk's dims (int4: and + dh / 2)
  __shared__ __align__(16) float ps[W_MAXQ][W_THREADS];   // a round's p (times v scale)
  __shared__ float red[4][W_MAXQ];
  const long long g = blockIdx.x;
  const int tid = threadIdx.x;
  const int rows = KIND == KV_INT4 ? dh / 2 : dh;   // stored rows of K and V
  const T* kg = k_t + g * rows * (long long)S_pad;
  const T* vg = v_t + g * rows * (long long)S_pad;
  const float* ksg = SCALED ? k_scale + g * S_pad : nullptr;
  const float* vsg = SCALED ? v_scale + g * S_pad : nullptr;
  const Q* qg = q + g * row_stride;
  // this thread's output dim, its stored row and nibble (int4)
  const int d_out = blockIdx.y * W_THREADS + tid;
  const bool has_dim = d_out < dh;
  const int vrow = KIND == KV_INT4 ? d_out % rows : d_out;
  const int nib = KIND == KV_INT4 ? d_out / rows : 0;

  float m_run[W_MAXQ], l_part[W_MAXQ], o[W_MAXQ];
#pragma unroll
  for (int j = 0; j < W_MAXQ; ++j) {
    m_run[j] = -INFINITY;
    l_part[j] = 0.0f;
    o[j] = 0.0f;
  }
  for (int s0 = 0; s0 < s_valid; s0 += W_THREADS) {
    const int s = s0 + tid;
    const bool valid = s < s_valid;
    float acc[W_MAXQ];
#pragma unroll
    for (int j = 0; j < W_MAXQ; ++j) acc[j] = 0.0f;
    for (int r0 = 0; r0 < rows; r0 += W_QCHUNK) {
      __syncthreads();   // the previous chunk of q has been read
      for (int e = tid; e < W_MAXQ * W_QCHUNK; e += W_THREADS) {
        const int j = e / W_QCHUNK, r = r0 + e % W_QCHUNK;
        const bool in = j < KQ && r < rows;
        qs[0][j][e % W_QCHUNK] = in ? owc_to_float(qg[j * dh + r]) : 0.0f;
        if (KIND == KV_INT4)
          qs[1][j][e % W_QCHUNK] = in ? owc_to_float(qg[j * dh + rows + r]) : 0.0f;
      }
      __syncthreads();
      if (valid) {
        const int n = min(W_QCHUNK, rows - r0);
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
          const T kv = kg[(long long)(r0 + i) * S_pad + s];
          if constexpr (KIND == KV_INT4) {
            const int byte = (int)kv;
            const float lo = (float)(((byte & 15) ^ 8) - 8), hi = (float)(byte >> 4);
#pragma unroll
            for (int j = 0; j < W_MAXQ; ++j)
              acc[j] = fmaf(qs[1][j][i], hi, fmaf(qs[0][j][i], lo, acc[j]));
          } else {
            float kf;
            if constexpr (KIND == KV_INT8) kf = (float)kv;
            else kf = owc_to_float(kv);
#pragma unroll
            for (int j = 0; j < W_MAXQ; ++j) acc[j] = fmaf(qs[0][j][i], kf, acc[j]);
          }
        }
      }
    }
    // the round's online softmax, every slot
    const float ks = SCALED && valid ? ksg[s] : 1.0f;
    float x[W_MAXQ], mt[W_MAXQ];
#pragma unroll
    for (int j = 0; j < W_MAXQ; ++j) {
      x[j] = valid ? (SCALED ? acc[j] * ks : acc[j]) * LOG2E : -INFINITY;
      mt[j] = x[j];
    }
    block_max(mt, red);
    const float vs = SCALED && valid ? vsg[s] : 0.0f;
    float corr[W_MAXQ];
#pragma unroll
    for (int j = 0; j < W_MAXQ; ++j) {
      const float mn = fmaxf(m_run[j], mt[j]);   // finite: a round's first position is valid
      corr[j] = ex2(m_run[j] - mn);
      m_run[j] = mn;
      const float p = ex2(x[j] - mn);   // 0 past s_valid
      l_part[j] = l_part[j] * corr[j] + p;
      // the v scale folds in after l; past s_valid the scale is never read
      ps[j][tid] = SCALED ? p * vs : p;
      o[j] *= corr[j];
    }
    __syncthreads();
    if (has_dim) {
      const T* vrow_p = vg + (long long)vrow * S_pad + s0;
      const int n = min(W_THREADS, s_valid - s0);
      for (int c = 0; c < n; c += VEC) {
        const uint4 u = *reinterpret_cast<const uint4*>(vrow_p + c);
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          if (c + i >= n) break;   // past s_valid: never weighed
          float vv;
          if constexpr (KIND == KV_INT4) {
            const int byte = (int)e[i];
            vv = nib ? (float)(byte >> 4) : (float)(((byte & 15) ^ 8) - 8);
          } else if constexpr (KIND == KV_INT8) {
            vv = (float)e[i];
          } else {
            vv = owc_to_float(e[i]);
          }
#pragma unroll
          for (int j = 0; j < W_MAXQ; ++j) o[j] = fmaf(ps[j][c + i], vv, o[j]);
        }
      }
    }
  }
  // l over the block's shares, then the output
#pragma unroll
  for (int j = 0; j < W_MAXQ; ++j) {
    const float w = owc_warp_sum(l_part[j]);
    if ((tid & 31) == 0) red[tid >> 5][j] = w;
  }
  __syncthreads();
  if (has_dim) {
    for (int j = 0; j < KQ; ++j) {
      const float l = (red[0][j] + red[1][j]) + (red[2][j] + red[3][j]);
      owc_store(out + g * row_stride + (long long)j * dh + d_out, o[j] / l);
    }
  }
}

template <int KIND, typename Q>
int launch_wide(const void* q, const void* k_t, const void* v_t, const void* k_scale,
                const void* v_scale, void* out, int BH, int KQ, int row_stride, int S_pad,
                int s_valid, int dh, cudaStream_t st) {
  using T = typename Stored<KIND, Q>::T;
  const dim3 grid((unsigned)BH, (unsigned)((dh + W_THREADS - 1) / W_THREADS));
  cross_attn_wide_kernel<KIND, Q><<<grid, W_THREADS, 0, st>>>(
      static_cast<const Q*>(q), static_cast<const T*>(k_t), static_cast<const T*>(v_t),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<Q*>(out), KQ, row_stride, S_pad, s_valid, dh);
  return (int)cudaGetLastError();
}

}  // namespace

// The WIDE launcher that cross_attention.cu's entry points call at cap
// OWC_WIDE (grouped: KQ slots of q at a row stride; one query: KQ = 1 and a
// row stride of dh): arguments as there (`splits` is not taken: a row is
// one block a piece of 128 output dims). Requires 1 <= KQ <= 8, 1 <= s_valid
// <= S_pad, S_pad a multiple of the kind's 16-byte chunk, 16-byte aligned
// k_t/v_t, an even dh for int4, and ceil(dh / 128) <= 65535.
int owc_cross_grouped_wide(const void* q, const void* k_t, const void* v_t,
                           const void* k_scale, const void* v_scale, void* out, int BH,
                           int KQ, int row_stride, int S_pad, int s_valid, int kind,
                           int dtype, int dh, cudaStream_t st) {
  if (KQ < 1 || KQ > W_MAXQ || s_valid < 1 || s_valid > S_pad || dh < 1 ||
      (kind == KV_INT4 && dh % 2) || (dh + W_THREADS - 1) / W_THREADS > 65535)
    return (int)cudaErrorInvalidValue;
  int err = 0;
  const bool ok = dispatch(kind, dtype, [&](auto kind_tag, auto qt) {
    err = launch_wide<decltype(kind_tag)::value, decltype(qt)>(
        q, k_t, v_t, k_scale, v_scale, out, BH, KQ, row_stride, S_pad, s_valid, dh, st);
  });
  return ok ? err : (int)cudaErrorInvalidValue;
}
