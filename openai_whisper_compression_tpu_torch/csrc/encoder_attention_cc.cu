// Non-causal encoder attention on the CUDA cores: the f32 body at every
// head dim, and the WIDE body of bf16 and f16 (head dims past 256).
//
// Replaces: openai_whisper_compression_tpu/ops/attention.py
//           encoder_attention_pallas (kernel body _attn_kernel), for the
//           inputs the tensor-core bodies of encoder_attention.cuh do not
//           take.
// Computes what encoder_attention.cuh computes, in q's element type X (f32,
// bf16 or f16) for each (batch, head) pair and query row i < T:
//   s[i, j]   = sum_d X(q[i, d] * scale) * k[j, d]                 (f32)
//   p[i, j]   = exp(s[i, j] - m[i]),  l[i] = sum_j p[i, j]         (f32)
//   out[i, d] = X((sum_j X(p[i, j]) * v[j, d]) / l[i])
// with the softmax online over 64-key tiles (the probabilities rounded to X
// relative to the running maximum, as the tensor-core bodies round them).
// In f32 nothing is rounded but the sums, which run in another order than
// the plain version's, and the exponentials are expf's (not ex2.approx):
// the kernel is held to 1e-5 of its largest output.
//
// Why the CUDA cores for f32: the tensor cores multiply f32 only as TF32,
// whose 10-bit mantissa leaves products about 1e-3 off; that breaks an f32
// bound. A 3xTF32 split (each operand as a TF32 high part and a TF32
// remainder, three products a pair) would restore f32 accuracy at three
// times the tensor-core work and a wgmma pipeline of its own; a plain FFMA
// kernel that is right comes first. The same body serves bf16 and f16 past
// head dim 256, where the tensor-core bodies would need a query tile wider
// than their registers: those widths are on no Whisper model's path.
//
// What bounds it on the H100: f32 operations. One call does 4 * B*H * T^2
// * Dh flop (6.6e11 at whisper-small, batch 96: 9.9 ms at the card's 67
// TFLOP/s outside the tensor cores) against 1.8 GB of f32 q, k, v and out
// (0.53 ms).
//
// Design: a block of 256 threads takes 64 query rows of one (batch, head)
// and one piece of DV output dims (64 at head dim 64, the WHOLE instance,
// else 128), walking the keys in 64-key tiles; a head dim past DV is
// ceil(dh / DV) pieces, each of which makes the scores again.
// - Thread (ty, tx) of a 16 x 16 grid holds the scores of rows 4 ty .. + 3
//   and keys 4 tx .. + 3 of a tile and the output of rows 4 ty .. + 3 at
//   dims 4 tx .. + 3 (+ 64): each step of a product reads a float4 of each
//   operand from shared memory and makes 16 (32) FFMAs.
// - Q and K chunks of 64 dims lie in shared memory transposed ([d][row]),
//   V as it is ([key][d]), P transposed ([key][row]); rows of 68 floats
//   (132 for V at DV = 128). The loads read whole 32-byte sectors of a row
//   (8 dims x 4 rows a warp for Q and K, 32 dims of a row for V) and store
//   conflict-free. A head dim of one chunk (<= 64) loads q once; a wider
//   one loads each q chunk again with its K chunk.
// - The softmax's row maximum and sum are shuffles over the 16 threads of a
//   row (one half-warp); dims past dh and keys past T load as zeros, keys
//   past T score -inf.
#include "common.cuh"
#include "hopper.cuh"  // ex2

namespace {

constexpr int BQ = 64;         // query rows a block
constexpr int BK = 64;         // keys a tile
constexpr int DC = 64;         // dims of a Q or K chunk
constexpr int THREADS = 256;
constexpr int LD = 64 + 4;     // floats a row of the Q, K and P tiles
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {  // in elements; the head dim is contiguous
  long long b, h, t;
};

template <bool WHOLE> struct Cc {
  static constexpr int DV = WHOLE ? 64 : 128;  // output dims a block
  static constexpr int LDV = DV + 4;           // floats a row of the V tile
  static constexpr int NG = DV / 64;           // 4-dim groups a thread, 64 apart
  static constexpr int SMEM = (3 * DC * LD + BK * LDV) * 4;
};

// x rounded to X and back (nothing for f32)
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_to(float x, __half) {
  return __half2float(__float2half_rn(x));
}

// WHOLE: head dim 64, one piece. Grid: (query blocks x pieces, B * H).
template <typename X, bool WHOLE>
__global__ void __launch_bounds__(THREADS)
encoder_attention_cc_kernel(const X* __restrict__ q, const X* __restrict__ k,
                            const X* __restrict__ v, X* __restrict__ out, int H, int T,
                            int dh, float scale, Strides qs, Strides ks, Strides vs,
                            Strides os, int qblocks) {
  using C = Cc<WHOLE>;
  constexpr int DV = C::DV, LDV = C::LDV, NG = C::NG;
  constexpr bool F32 = std::is_same<X, float>::value;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;            // [DC][LD]: q chunk, transposed
  float* kt = qt + DC * LD;    // [DC][LD]: K chunk, transposed
  float* pt = kt + DC * LD;    // [BK][LD]: probabilities, transposed
  float* vt = pt + BK * LD;    // [BK][LDV]: V piece
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = (blockIdx.x % qblocks) * BQ, dv0 = (blockIdx.x / qblocks) * DV;
  const X* qg = q + b * qs.b + h * qs.h;
  const X* kg = k + b * ks.b + h * ks.h;
  const X* vg = v + b * vs.b + h * vs.h;
  const int nchunks = WHOLE ? 1 : (dh + DC - 1) / DC;
  const int ntiles = (T + BK - 1) / BK;

  // rows r0.. and dims d0.. of src into dst[d][r] (zeros past T and dh):
  // a warp reads 8 dims of 4 rows a step, and its stores fall on 32 banks
  auto load_t = [&](float* dst, const X* src, long long st, int r0, int d0, bool is_q) {
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int d = (tid & 7) + 8 * (i & 7), r = (tid >> 3) + 32 * (i >> 3);
      float x = 0.0f;
      if (r0 + r < T && (WHOLE || d0 + d < dh)) {
        x = owc_to_float(src[(long long)(r0 + r) * st + d0 + d]);
        if (is_q) x = round_to(x * scale, X());
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
  if (nchunks == 1) {
    load_t(qt, qg, qs.t, row0, 0, true);   // read by every tile (after its barrier)
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
      if (nchunks > 1) load_t(qt, qg, qs.t, row0, c * DC, true);
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
      corr[i] = F32 ? expf(m_run[i] - mn) : ex2((m_run[i] - mn) * LOG2E);
      m_run[i] = mn;
      const float ms = mn * LOG2E;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // 0 past T; f32 takes the accurate exponential of s - m, as the plain
        // version does (ex2.approx of a rounded s log2(e) strays ~1e-6)
        const float p = F32 ? expf(s[i][j] - mn) : ex2(fmaf(s[i][j], LOG2E, -ms));
        sum += p;
        s[i][j] = round_to(p, X());   // v's type, before the value product
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
      if (key0 + r < T && (WHOLE || dv0 + d < dh))
        x = owc_to_float(vg[(long long)(key0 + r) * vs.t + dv0 + d]);
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

  X* og = out + b * os.b + h * os.h;
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
        if (WHOLE || d < dh) owc_store(og + (long long)row * os.t + d, o[i][4 * g + j] * inv);
      }
  }
}

template <typename X, bool WHOLE>
int launch_cc(const void* q, const void* k, const void* v, void* out, int B, int H, int T,
              int dh, float scale, const long long* strides, cudaStream_t stream) {
  using C = Cc<WHOLE>;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  const long long qblocks = (T + BQ - 1) / BQ, pieces = (dh + C::DV - 1) / C::DV;
  if (qblocks * pieces > 2147483647LL || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(encoder_attention_cc_kernel<X, WHOLE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(qblocks * pieces), (unsigned)(B * H));
  encoder_attention_cc_kernel<X, WHOLE><<<grid, THREADS, C::SMEM, stream>>>(
      static_cast<const X*>(q), static_cast<const X*>(k), static_cast<const X*>(v),
      static_cast<X*>(out), H, T, dh, scale, qs, ks, vs, os, (int)qblocks);
  return (int)cudaGetLastError();
}

}  // namespace

// The CUDA-core encoder attention (encoder_attention.cu's entry point calls
// it for f32 at every head dim and for bf16 and f16 past 256): q, k, v, out
// of element type `dtype` (common.cuh) laid out as the entry point says
// (strides in elements; rows need only element alignment); the WHOLE
// instance where dh = 64 in f32, else the one that takes dh at run time.
// Requires T >= 1, dh >= 1, B * H <= 65535.
int owc_encoder_attention_cc(const void* q, const void* k, const void* v, void* out, int B,
                             int H, int T, int dh, float scale, const long long* strides,
                             int dtype, cudaStream_t st) {
  if (T < 1 || dh < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  int err = (int)cudaErrorInvalidValue;
  owc_dispatch_float(dtype, [&](auto tag) {
    using X = decltype(tag);
    if constexpr (std::is_same<X, float>::value) {
      if (dh == 64) {
        err = launch_cc<X, true>(q, k, v, out, B, H, T, dh, scale, strides, st);
        return;
      }
    }
    err = launch_cc<X, false>(q, k, v, out, B, H, T, dh, scale, strides, st);
  });
  return err;
}
