// Non-causal attention over the encoder's fixed context, scores kept on chip.
//
// Replaces: openai_whisper_compression_tpu/ops/attention.py
//           encoder_attention_pallas (kernel body _attn_kernel).
// Computes, for each (batch, head) pair and each query row i < T:
//   s[i, j]   = sum_d bf16(q[i, d] * scale) * k[j, d]        (f32), j < T
//   m[i]      = max_j s[i, j];  p[i, j] = exp(s[i, j] - m[i]); l[i] = sum_j p
//   out[i, d] = (sum_j bf16(p[i, j]) * v[j, d]) / l[i]       (f32 sums)
// from bf16 q, k, v with head dim 64, output in bf16: q is scaled in bf16,
// the unnormalised probabilities are rounded to bf16 before the value
// product, l sums the unrounded f32 values and divides after the product,
// as the TPU kernel does. Keys at positions >= T do not exist here (the
// TPU kernel pads T to 128 and masks them); query rows >= T are not
// written.
//
// The TPU kernel holds all of K/V and a (512, T_pad) f32 score block of
// one (batch, head) in VMEM per grid step. A block here has 227 KB at
// most and registers are scarcer, so the softmax is online (a running
// max and sum per row, the output rescaled when the max grows): a
// probability is then rounded to bf16 relative to the running max and not
// the final one, which moves the result by less than the bf16 rounding of
// the output itself (the kernel is held to one bf16 step of the plain
// version's largest output).
//
// What bounds it on the H100: operations. One call does 4 * B*H * T^2 * 64
// flop (6.6e11 at whisper-small, batch 96) against 4 * B*H * T * 64 * 2
// bytes of q, k, v and out (0.88 GB): 750 flop per byte, far above the
// card's balance point, so the products run on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, f32 accumulators); wgmma and TMA are
// later work. The (T, T) scores never reach device memory.
//
// Design: one block of 8 warps per 128 query rows of one (batch, head);
// a warp owns 16 rows and keeps their scaled q (A fragments), the output
// accumulators and the softmax statistics in registers. K and V stream
// through shared memory in tiles of 64 keys, double buffered with
// cp.async (16-byte copies; rows past T are zero filled), each tile shared
// by the 8 warps. Shared rows are padded to 72 elements (144 bytes) so the
// eight row addresses of an ldmatrix fall into distinct banks. S = Q K^T
// takes its B fragments with ldmatrix from K stored [key][d]; the score
// accumulators of two 8-key tiles, rounded to bf16, are the A fragment of
// P V (their register layouts coincide), and V stored [key][d] gives its B
// fragments with ldmatrix.trans. Neighbouring blocks share a (batch, head),
// so its K/V stay in L2 while its 12 blocks run. q, k, v and out are
// addressed through (batch, head, row) strides: the (B, T, H, 64) layout
// that the projections leave is read in place, and out is written in that
// layout so that merging the heads is a view.
#include "common.cuh"

namespace {

constexpr int DH = 64;        // head dim
constexpr int BM = 128;       // query rows per block: 8 warps x 16 rows
constexpr int BN = 64;        // keys per shared-memory tile
constexpr int THREADS = 256;
constexpr int LDS = DH + 8;   // shared row stride in elements (144 bytes)
constexpr float LOG2E = 1.4426950408889634f;
using BF = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives elements [l / 4][2 * (l % 4), + 1] of each matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same with each matrix transposed: elements [2 * (l % 4), + 1][l / 4].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c (16x8 f32) += a (16x16 bf16, row major) * b (16x8 bf16, column major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two neighbouring q values times `scale`, rounded to bf16 (q * scale in
// q's own type).
__device__ __forceinline__ uint32_t load_q2(const BF* p, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return pack_bf16(f.x * scale, f.y * scale);
}

struct Strides {  // in elements; the head dim is contiguous
  long long b, h, t;
};

__global__ void __launch_bounds__(THREADS, 2)
encoder_attention_kernel(const BF* __restrict__ q, const BF* __restrict__ k,
                         const BF* __restrict__ v, BF* __restrict__ out, int H,
                         int T, float scale, Strides qs, Strides ks, Strides vs,
                         Strides os) {
  __shared__ __align__(16) BF Ks[2][BN][LDS];
  __shared__ __align__(16) BF Vs[2][BN][LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int m0 = blockIdx.x * BM + warp * 16;  // this warp's first query row
  const BF* qb = q + b * qs.b + h * qs.h;
  const BF* kb = k + b * ks.b + h * ks.h;
  const BF* vb = v + b * vs.b + h * vs.h;
  BF* ob = out + b * os.b + h * os.h;
  const int ntiles = (T + BN - 1) / BN;

  auto load_tile = [&](int tile, int buf) {
    const int kv0 = tile * BN;
    for (int c = tid; c < BN * (DH / 8); c += THREADS) {  // 16-byte chunks
      const int row = c >> 3, col = (c & 7) * 8;
      const int key = kv0 + row;
      const bool ok = key < T;
      const long long src = ok ? key : T - 1;  // a valid address; 0 bytes read
      cp_async16(&Ks[buf][row][col], kb + src * ks.t + col, ok ? 16 : 0);
      cp_async16(&Vs[buf][row][col], vb + src * vs.t + col, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  // A fragments of this warp's 16 scaled query rows: a0 (row g, cols 2t),
  // a1 (row g + 8), a2 (row g, cols 2t + 8), a3 (row g + 8, cols 2t + 8)
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + g + (i & 1) * 8;
      const int col = kk * 16 + (i >> 1) * 8 + 2 * t4;
      qf[kk][i] = row < T ? load_q2(qb + row * qs.t + col, scale) : 0u;
    }

  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.0f, 0.0f};            // this lane's share of the row sums
  const bool active = m0 < T;               // the same for the whole warp

  load_tile(0, 0);
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j has landed; tile j - 1's buffer is free
    if (j + 1 < ntiles) load_tile(j + 1, (j + 1) & 1);
    if (!active) continue;
    const int buf = j & 1;

    // S = Q K^T for 16 rows x 64 keys: s[n] is the 16x8 tile of keys 8n..
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // d 0..31, 32..63
        uint32_t kf[4];
        ldmatrix_x4(kf, &Ks[buf][n * 8 + (lane & 7)][half * 32 + (lane >> 3) * 8]);
        mma_bf16(s[n], qf[half * 2], kf[0], kf[1]);
        mma_bf16(s[n], qf[half * 2 + 1], kf[2], kf[3]);
      }
    }
    const int kv0 = j * BN;
    if (kv0 + BN > T) {  // the ragged last tile: keys past T take no weight
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + n * 8 + 2 * t4 + (e & 1) >= T) s[n][e] = -INFINITY;
    }

    // online softmax over the tile; s becomes the unnormalised probabilities
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);  // finite: key 0 is in tile 0
      const float corr = exp2f((m_run[r] - m_new) * LOG2E);  // 0 on tile 0
      m_run[r] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float p0 = exp2f((s[n][2 * r] - m_new) * LOG2E);
        const float p1 = exp2f((s[n][2 * r + 1] - m_new) * LOG2E);
        s[n][2 * r] = p0;
        s[n][2 * r + 1] = p1;
        sum += p0 + p1;
      }
      l_run[r] = l_run[r] * corr + sum;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }

    // O += P V: the score tiles 2kk and 2kk + 1, rounded to bf16, are the A
    // fragment over keys 16kk..16kk + 15
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {  // output dims 16dp..16dp + 15
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &Vs[buf][kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                                 [dp * 16 + (lane >> 4) * 8]);
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = m0 + g + r * 8;
    if (row < T) {
      BF* orow = ob + row * os.t + 2 * t4;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(o[n][2 * r] / l, o[n][2 * r + 1] / l);
    }
  }
}

}  // namespace

// q, k, v, out: bf16 (B, H, T, 64) addressed as base + b * sb + h * sh +
// t * st + d, strides in elements, given for q, k, v and out in that order
// as strides[12] = {sb, sh, st} x 4. k and v need 16-byte aligned rows (base
// pointer and every stride a multiple of 8 elements), q and out 4-byte
// aligned rows. Requires B * H <= 65535 and T >= 1.
extern "C" int owc_encoder_attention(const void* q, const void* k, const void* v,
                                     void* out, int B, int H, int T, float scale,
                                     const long long* strides, void* stream) {
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  const dim3 grid((T + BM - 1) / BM, B * H);
  encoder_attention_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const BF*>(q), static_cast<const BF*>(k), static_cast<const BF*>(v),
      static_cast<BF*>(out), H, T, scale, qs, ks, vs, os);
  return (int)cudaGetLastError();
}
