// Non-causal encoder attention on the CUDA cores: the f32 body past head
// dim 256.
//
// Replaces: openai_whisper_compression_tpu/ops/attention.py
//           encoder_attention_pallas (kernel body _attn_kernel), for f32
//           inputs of a head dim past 256.
// Computes what encoder_attention.cuh computes, in f32, for each (batch,
// head) pair and query row i < T:
//   s[i, j]   = sum_d (q[i, d] * scale) * k[j, d]
//   p[i, j]   = exp(s[i, j] - m[i]),  l[i] = sum_j p[i, j]
//   out[i, d] = (sum_j p[i, j] * v[j, d]) / l[i]
// with the softmax online over 64-key tiles. Nothing is rounded but the
// sums, which run in another order than the plain version's, and the
// exponentials are expf's (not ex2.approx): the kernel is held to 1e-5 of
// its largest output.
//
// Why the CUDA cores: f32 up to head dim 256 runs on the tensor cores by
// 3xTF32 (encoder_attention_f32.cu), whose output tile lives in registers;
// past 256 it would not fit, and no Whisper model runs such a width. A
// plain FFMA kernel that is right serves it.
//
// What bounds it on the H100: f32 operations. One call does 4 * B*H * T^2
// * Dh flop (4.4e10 at (8, 2, 1500, 384): 0.66 ms at the card's 67 TFLOP/s
// outside the tensor cores) against 74 MB of f32 q, k, v and out.
//
// Design: a block of 256 threads takes 64 query rows of one (batch, head)
// and one piece of 128 output dims, walking the keys in 64-key tiles; a
// head dim of n pieces makes the scores n times.
// - Thread (ty, tx) of a 16 x 16 grid holds the scores of rows 4 ty .. + 3
//   and keys 4 tx .. + 3 of a tile and the output of rows 4 ty .. + 3 at
//   dims 4 tx .. + 3 (+ 64): each step of a product reads a float4 of each
//   operand from shared memory and makes 32 FFMAs.
// - Q and K chunks of 64 dims lie in shared memory transposed ([d][row]),
//   V as it is ([key][d]), P transposed ([key][row]); rows of 68 floats
//   (132 for V). The loads read whole 32-byte sectors of a row (8 dims x 4
//   rows a warp for Q and K, 32 dims of a row for V) and store
//   conflict-free; each q chunk is loaded again with its K chunk.
// - The softmax's row maximum and sum are shuffles over the 16 threads of a
//   row (one half-warp); dims past dh and keys past T load as zeros, keys
//   past T score -inf.
// - The grid's y extent holds at most 65535 (batch, head) pairs: a larger
//   B * H is launched in slices of whole batches (or, past 65535 heads, of
//   heads of one batch), each with its pointers offset to its first pair.
#include "common.cuh"

namespace {

constexpr int BQ = 64;         // query rows a block
constexpr int BK = 64;         // keys a tile
constexpr int DC = 64;         // dims of a Q or K chunk
constexpr int DV = 128;        // output dims a block
constexpr int NG = DV / 64;    // 4-dim groups a thread, 64 apart
constexpr int THREADS = 256;
constexpr int LD = 64 + 4;     // floats a row of the Q, K and P tiles
constexpr int LDV = DV + 4;    // floats a row of the V tile
constexpr int SMEM = (3 * DC * LD + BK * LDV) * 4;
constexpr long long MAX_Y = 65535;   // the grid's y extent

struct Strides {  // in elements; the head dim is contiguous
  long long b, h, t;
};

// Grid: (query blocks x pieces, B * H).
__global__ void __launch_bounds__(THREADS)
encoder_attention_cc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ out, int H, int T,
                            int dh, float scale, Strides qs, Strides ks, Strides vs,
                            Strides os, int qblocks) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;            // [DC][LD]: q chunk, transposed
  float* kt = qt + DC * LD;    // [DC][LD]: K chunk, transposed
  float* pt = kt + DC * LD;    // [BK][LD]: probabilities, transposed
  float* vt = pt + BK * LD;    // [BK][LDV]: V piece
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = (blockIdx.x % qblocks) * BQ, dv0 = (blockIdx.x / qblocks) * DV;
  const float* qg = q + b * qs.b + h * qs.h;
  const float* kg = k + b * ks.b + h * ks.h;
  const float* vg = v + b * vs.b + h * vs.h;
  const int nchunks = (dh + DC - 1) / DC;
  const int ntiles = (T + BK - 1) / BK;

  // rows r0.. and dims d0.. of src into dst[d][r] (zeros past T and dh):
  // a warp reads 8 dims of 4 rows a step, and its stores fall on 32 banks
  auto load_t = [&](float* dst, const float* src, long long st, int r0, int d0, bool is_q) {
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int d = (tid & 7) + 8 * (i & 7), r = (tid >> 3) + 32 * (i >> 3);
      float x = 0.0f;
      if (r0 + r < T && d0 + d < dh) {
        x = src[(long long)(r0 + r) * st + d0 + d];
        if (is_q) x *= scale;
      }
      dst[d * LD + r] = x;
    }
  };

  float o[4][4 * NG], m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) o[i][j] = 0.0f;
  }

  for (int jt = 0; jt < ntiles; ++jt) {
    const int key0 = jt * BK;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int c = 0; c < nchunks; ++c) {
      __syncthreads();   // the previous chunk's products are done with qt and kt
      load_t(qt, qg, qs.t, row0, c * DC, true);
      load_t(kt, kg, ks.t, key0, c * DC, false);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < DC; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(qt + d * LD + 4 * ty);
        const float4 bk = *reinterpret_cast<const float4*>(kt + d * LD + 4 * tx);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
      }
    }
    // the online softmax of rows 4 ty + i over this tile's keys
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (key0 + 4 * tx + j >= T) s[i][j] = -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int o2 = 1; o2 < 16; o2 <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o2));
      const float mn = fmaxf(m_run[i], mt);   // finite: a tile's first key is valid
      corr[i] = expf(m_run[i] - mn);
      m_run[i] = mn;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // 0 past T; the accurate exponential of s - m, as the plain version
        // takes it (ex2.approx of a rounded s log2(e) strays ~1e-6)
        s[i][j] = expf(s[i][j] - mn);
        sum += s[i][j];
      }
      l_run[i] = l_run[i] * corr[i] + sum;
    }
    __syncthreads();   // the previous tile's value products are done with pt and vt
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * LD + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    // V rows key0.. at dims dv0..: a warp reads 32 dims of a row a step
#pragma unroll 4
    for (int e = tid; e < BK * DV; e += THREADS) {
      const int d = e % DV, r = e / DV;
      float x = 0.0f;
      if (key0 + r < T && dv0 + d < dh) x = vg[(long long)(key0 + r) * vs.t + dv0 + d];
      vt[r * LDV + d] = x;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NG; ++j) o[i][j] *= corr[i];
#pragma unroll 8
    for (int key = 0; key < BK; ++key) {
      const float4 a = *reinterpret_cast<const float4*>(pt + key * LD + 4 * ty);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 bv4 = *reinterpret_cast<const float4*>(vt + key * LDV + 64 * g + 4 * tx);
        const float bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][4 * g + j] = fmaf(av[i], bv[j], o[i][4 * g + j]);
      }
    }
  }

  float* og = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int o2 = 1; o2 < 16; o2 <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o2);
    const int row = row0 + 4 * ty + i;
    if (row >= T) continue;
    const float inv = 1.0f / l;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = dv0 + 64 * g + 4 * tx + j;
        if (d < dh) og[(long long)row * os.t + d] = o[i][4 * g + j] * inv;
      }
  }
}

}  // namespace

// The CUDA-core encoder attention (encoder_attention.cu's entry point calls
// it for f32 past head dim 256): q, k, v, out f32 laid out as the entry
// point says (strides in elements; rows need only element alignment).
int owc_encoder_attention_cc(const void* q, const void* k, const void* v, void* out, int B,
                             int H, int T, int dh, float scale, const long long* strides,
                             cudaStream_t st) {
  if (T < 1 || dh < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  const long long qblocks = (T + BQ - 1) / BQ, pieces = (dh + DV - 1) / DV;
  if (qblocks * pieces > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(encoder_attention_cc_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  // (batch, head) slices of at most MAX_Y pairs: whole batches where H fits
  const long long nb = H <= MAX_Y ? MAX_Y / H : 1, nh = H <= MAX_Y ? H : MAX_Y;
  for (long long b0 = 0; b0 < B; b0 += nb)
    for (long long h0 = 0; h0 < H; h0 += nh) {
      const long long bs = B - b0 < nb ? B - b0 : nb, hs = H - h0 < nh ? H - h0 : nh;
      const long long off_q = b0 * qs.b + h0 * qs.h, off_k = b0 * ks.b + h0 * ks.h;
      const long long off_v = b0 * vs.b + h0 * vs.h, off_o = b0 * os.b + h0 * os.h;
      const dim3 grid((unsigned)(qblocks * pieces), (unsigned)(bs * hs));
      encoder_attention_cc_kernel<<<grid, THREADS, SMEM, st>>>(
          static_cast<const float*>(q) + off_q, static_cast<const float*>(k) + off_k,
          static_cast<const float*>(v) + off_v, static_cast<float*>(out) + off_o, (int)hs, T,
          dh, scale, qs, ks, vs, os, (int)qblocks);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  return (int)cudaSuccess;
}
