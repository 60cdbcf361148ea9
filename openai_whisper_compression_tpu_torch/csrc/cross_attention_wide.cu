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
// output in q's type. l is summed before the v-scale fold. Every product
// runs on the CUDA cores in f32 (the probabilities are not rounded to q's
// type, as the plain version does not round them).
//
// What bounds it on the H100: device-memory bytes, 2 x rows x s_valid
// stored elements a row (rows = dh, or dh / 2 for int4), against 4 x KQ
// flop an element.
//
// Design: flash-decoding over a thread block cluster, the scores of a row
// made once.
// - A row's positions are cut into chunks of CH positions (8 x 16 bytes of a
//   stored row, a whole 128-byte line of 16-bit and f32 K/V: 32 positions of
//   f32, 64 of the others), shared out over the 1-8 blocks of a cluster
//   (the wrapper's `wide_splits`); each block of 256 threads walks its
//   chunks with an online softmax over its slots. A block has a fixed cost
//   (q staged, the first tiles' latency, the combine), so the rule gives
//   each block a long run of chunks.
// - A ring of tiles in shared memory, filled by cp.async in 16-byte pieces
//   along the positions (each copy asking L2 for its whole 128-byte line):
//   a tile is 256 stored rows of one chunk of K or of V, and a chunk is its
//   K tiles, then its V tiles. 2 tiles of 32 KB (16-bit and f32 K/V) or 3
//   of 16 KB (int8, int4) are in flight while one is used, whatever B·H and
//   the head dim are; a block barrier a tile. Two or three blocks an SM.
// - Scores: thread (column c, row group rg) takes U = 4 (f32) or 8
//   positions of a tile's rows rg, rg + 32, ...; its KQ x U sums go over
//   the slots of a template of 1, 4 or 8 (the launch's slot count rounded
//   up), q staged once in shared memory as f32 [row][slot]. After the last
//   K tile, the sums of the 4 row groups of a warp meet by a reduce-scatter
//   of shuffles, the 8 warps' through shared memory.
// - The online softmax: warp j takes slot j, a lane two positions (f32 K/V:
//   one; in base 2, ex2.approx); the probabilities, times the v scale, go to
//   shared memory.
// - Values: thread t takes stored row t of each V tile, its 16-byte pieces
//   along the chunk's positions, times the probabilities; its sums stay in
//   registers: up to 1024 output dims a block (4 V tiles; int4 2 tiles of
//   two dims a row). A head dim past that is cut into passes (grid z), each
//   making the scores again.
// - The blocks' (o, m, l) of each slot combine in a fixed order (rank)
//   through distributed shared memory after a cluster barrier: no atomics,
//   the same bits from run to run.
// Positions past s_valid are never read: a 16-byte piece that straddles it
// is zero filled past it, and the padding's scores are masked.
#include "cross_attention.cuh"  // the storage kinds, `dispatch`, Swz, LOG2E

namespace {

constexpr int W_THREADS = 256;
constexpr int W_WARPS = W_THREADS / 32;
constexpr int W_RT = 256;                    // stored rows of a tile
constexpr int W_COLS = 8;                    // threads on a row of a tile (scores)
constexpr int W_RG = W_THREADS / W_COLS;     // row groups (scores)
constexpr int W_SCALE_BYTES = 512;           // a chunk's k and v scales, after its tile
constexpr int W_SMEM_MAX = 232448;

// The geometry of a storage kind under q type Q.
template <int KIND, typename Q> struct WGeo {
  using St = Store<KIND, Q, 16>;                 // the stored element (any head dim)
  using T = typename St::T;
  static constexpr bool SCALED = KIND != KV_FP;
  static constexpr int DIMS = St::DIMS;          // head dims a stored row holds
  static constexpr int ELEM = (int)sizeof(T);
  static constexpr int VEC = 16 / ELEM;          // positions of a 16-byte piece
  static constexpr int U = ELEM == 4 ? 4 : 8;    // positions a thread scores
  static constexpr int CH = W_COLS * U;          // positions of a chunk
  static constexpr int ROWB = CH * ELEM;         // bytes of a tile row: 128, or 64 (codes)
  static constexpr int PPR = ROWB / 16;          // 16-byte pieces of a tile row
  static constexpr int TILE = W_RT * ROWB;
  static constexpr int SLOT = TILE + (SCALED ? W_SCALE_BYTES : 0);
  static constexpr int NT = TILE >= 32768 ? 3 : 4;   // tiles of the ring: 96 or 64 KB
  static constexpr int RPT = KIND == KV_INT4 ? 2 : 4;  // V tiles a pass holds
  static constexpr int PASS = RPT * W_RT;        // stored rows a pass: 1024 output dims
  static_assert(!SCALED || CH == 64, "a chunk's scales are 64 positions");
  static_assert(DIMS * PASS * 8 * 4 <= NT * SLOT, "the records fit in the ring");
};

// Shared memory of a launch: the ring, q [rows][DIMS][MQ] (rounded to 16
// bytes), the warps' partial scores [8][MQ][CH], p [MQ][CH], the
// corrections [MQ], then m and l [2][MQ].
template <int KIND, typename Q>
size_t wide_smem(int rows, int mq) {
  using G = WGeo<KIND, Q>;
  const size_t qn = ((size_t)rows * G::DIMS * mq + 3) & ~(size_t)3;
  return (size_t)G::NT * G::SLOT +
         4 * (qn + (size_t)W_WARPS * mq * G::CH + (size_t)mq * G::CH + 3 * (size_t)mq);
}

// U positions of tile row rl at column c (int4: its low and high nibbles).
template <int KIND, typename Q>
__device__ __forceinline__ void load_u(const unsigned char* tile, int rl, int c,
                                       float (&kv)[WGeo<KIND, Q>::DIMS][WGeo<KIND, Q>::U]) {
  using G = WGeo<KIND, Q>;
  using Sw = Swz<G::ROWB>;
  if constexpr (G::ELEM == 1) {   // 8 bytes: half a piece
    const uint2 w = *reinterpret_cast<const uint2*>(tile + Sw::off(rl, c >> 1) + (c & 1) * 8);
    if constexpr (KIND == KV_INT8) {
      owc_int8x4_to_float(w.x, kv[0]);
      owc_int8x4_to_float(w.y, kv[0] + 4);
    } else {
      owc_int4x4_to_float(w.x, 0, kv[0]);
      owc_int4x4_to_float(w.y, 0, kv[0] + 4);
      owc_int4x4_to_float(w.x, 4, kv[1]);
      owc_int4x4_to_float(w.y, 4, kv[1] + 4);
    }
  } else {   // a whole piece: 4 f32 or 8 16-bit values
    G::St::decode(*reinterpret_cast<const uint4*>(tile + Sw::off(rl, c)), kv);
  }
}

template <int KIND, typename Q, int MQ>
__global__ void __launch_bounds__(W_THREADS, 1)
cross_attn_wide_kernel(const Q* __restrict__ q,
                       const typename WGeo<KIND, Q>::T* __restrict__ k_t,
                       const typename WGeo<KIND, Q>::T* __restrict__ v_t,
                       const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                       Q* __restrict__ out, int KQ, int row_stride, int S_pad, int s_valid,
                       int dh) {
  using G = WGeo<KIND, Q>;
  using T = typename G::T;
  using Sw = Swz<G::ROWB>;
  constexpr int CH = G::CH, U = G::U, DIMS = G::DIMS, NT = G::NT, RPT = G::RPT;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long g = blockIdx.x;
  const int rank = (int)cluster.block_rank(), splits = (int)cluster.num_blocks();
  const int rows = KIND == KV_INT4 ? dh / 2 : dh;     // stored rows of K and V
  const int p0 = blockIdx.z * G::PASS;                // this pass's first stored row
  const int p_rows = min(G::PASS, rows - p0);         // ... and its count
  const int nk = (rows + W_RT - 1) / W_RT;            // K tiles a chunk
  const int nv = (p_rows + W_RT - 1) / W_RT;          // V tiles a chunk (<= RPT)
  const T* kg = k_t + g * rows * (long long)S_pad;
  const T* vg = v_t + g * rows * (long long)S_pad;
  const float* ksg = G::SCALED ? k_scale + g * S_pad : nullptr;
  const float* vsg = G::SCALED ? v_scale + g * S_pad : nullptr;
  const Q* qg = q + g * row_stride;

  unsigned char* ring = smem;
  const uint32_t ring_u = (uint32_t)__cvta_generic_to_shared(ring);
  float* qs = reinterpret_cast<float*>(smem + NT * G::SLOT);
  float* red = qs + ((rows * DIMS * MQ + 3) & ~3);
  float* ps = red + W_WARPS * MQ * CH;
  float* corr_s = ps + MQ * CH;
  float* ml = corr_s + MQ;   // m [MQ], l [MQ]

  // q as f32 [row][nib][slot]; zeros at the slots past KQ
  for (int e = tid; e < rows * DIMS * MQ; e += W_THREADS) {
    const int j = e % MQ, rn = e / MQ;
    qs[e] = j < KQ ? owc_to_float(qg[j * dh + (rn % DIMS) * rows + rn / DIMS]) : 0.0f;
  }

  // the block's chunks
  const int nch = (s_valid + CH - 1) / CH;
  const int b_lo = rank * nch / splits, b_hi = (rank + 1) * nch / splits;
  const int per = nk + nv, steps = (b_hi - b_lo) * per;

  // the producer's next tile into its ring slot, NT - 1 steps ahead of the
  // consumer: of chunk `prod_c`, K tile w < nk or V tile w - nk; every piece
  // below s_valid (one that straddles it zero filled past it); the chunk's
  // scales with its last K tile
  int prod = 0, prod_c = 0, prod_w = 0;   // the producer's step, its chunk and tile
  auto issue = [&]() {
    if (prod < steps) {
      const int c = prod_c, w = prod_w;
      const bool is_k = w < nk;
      const int r0 = is_k ? w * W_RT : p0 + (w - nk) * W_RT;
      const int nr = min(W_RT, (is_k ? rows : p0 + p_rows) - r0);
      const int s0 = (b_lo + c) * CH;
      const uint32_t dst = ring_u + (prod % NT) * G::SLOT;
      const T* src0 = (is_k ? kg : vg) + (long long)r0 * S_pad + s0;
      const bool whole = s0 + CH <= s_valid;
      for (int p = tid; p < nr * G::PPR; p += W_THREADS) {
        const int r = p / G::PPR, pc = p % G::PPR;
        const int bytes =
            whole ? 16 : max(0, min(16, (s_valid - s0 - pc * G::VEC) * G::ELEM));
        cp_async16_line(dst + Sw::off(r, pc),
                        bytes ? src0 + (long long)r * S_pad + pc * G::VEC : src0, bytes);
      }
      if (G::SCALED && is_k && w == nk - 1 && tid < 2 * CH / 4) {
        const int pos = s0 + (tid % (CH / 4)) * 4;
        const int bytes = max(0, min(16, (s_valid - pos) * 4));
        const float* src = tid < CH / 4 ? ksg : vsg;
        cp_async16_line(dst + G::TILE + tid * 16, bytes ? src + pos : src, bytes);
      }
    }
    cp_async_commit();
    ++prod;
    if (++prod_w == per) {
      prod_w = 0;
      ++prod_c;
    }
  };

  float acc[MQ * U];           // partial scores [slot][position] of this thread
  float o[RPT][DIMS][MQ];      // output sums of this thread's stored rows
  float m_run = -INFINITY, l_run = 0.0f;   // slot `warp`'s (warp < MQ)
#pragma unroll
  for (int t = 0; t < RPT; ++t)
#pragma unroll
    for (int n = 0; n < DIMS; ++n)
#pragma unroll
      for (int j = 0; j < MQ; ++j) o[t][n][j] = 0.0f;

  const int col = tid & (W_COLS - 1), rg = tid / W_COLS;
#pragma unroll
  for (int i = 0; i < NT - 1; ++i) issue();
  int i = 0;
  for (int c = 0; c < b_hi - b_lo; ++c) {
#pragma unroll
    for (int e = 0; e < MQ * U; ++e) acc[e] = 0.0f;   // dead through the V tiles
    for (int w = 0; w < nk; ++w, ++i) {
      cp_async_wait<NT - 2>();   // tile i has landed, for this thread's copies
      __syncthreads();           // ... and for every thread's; slot i - 1 is free
      issue();
      const unsigned char* tile = ring + (i % NT) * G::SLOT;
      // scores: this thread's rows of the tile, its U positions (at 8
      // slots a row at a time: their 64 sums leave no room for more)
#pragma unroll(MQ == 8 ? 1 : W_RT / W_RG)
      for (int ii = 0; ii < W_RT / W_RG; ++ii) {
        const int rl = rg + W_RG * ii, r = w * W_RT + rl;
        if (r < rows) {
          float kv[DIMS][U];
          load_u<KIND, Q>(tile, rl, col, kv);
#pragma unroll
          for (int n = 0; n < DIMS; ++n) {
            const float* qr = qs + (r * DIMS + n) * MQ;
            float qv[MQ];
            if constexpr (MQ % 4 == 0) {
#pragma unroll
              for (int j = 0; j < MQ; j += 4) {
                const float4 x = *reinterpret_cast<const float4*>(qr + j);
                qv[j] = x.x;
                qv[j + 1] = x.y;
                qv[j + 2] = x.z;
                qv[j + 3] = x.w;
              }
            } else {
              qv[0] = qr[0];
            }
#pragma unroll
            for (int j = 0; j < MQ; ++j)
#pragma unroll
              for (int u = 0; u < U; ++u) acc[j * U + u] = fmaf(qv[j], kv[n][u], acc[j * U + u]);
          }
        }
      }
      if (w == nk - 1) {
        // the 4 row groups of the warp, then the 8 warps, in a fixed order
        owc_reduce_scatter<16, W_COLS>(acc, lane);
        constexpr int N = MQ * U, R = N / 4;
        const int base = owc_scatter_base<N, 16, W_COLS>(lane);
#pragma unroll
        for (int e = 0; e < R; ++e) {
          const int idx = base + e, j = idx / U;
          red[(warp * MQ + j) * CH + col * U + idx % U] = acc[e];
        }
        __syncthreads();
        // the online softmax of slot `warp`, positions lane and lane + 32
        // (f32 K/V: lane), in base 2
        if (warp < MQ) {
          constexpr int PPL = CH / 32;
          const float* scl = reinterpret_cast<const float*>(tile + G::TILE);
          float x[PPL], mx = -INFINITY;
#pragma unroll
          for (int e = 0; e < PPL; ++e) {
            const int pos = lane + 32 * e;
            float s = 0.0f;
#pragma unroll
            for (int w2 = 0; w2 < W_WARPS; ++w2) s += red[(w2 * MQ + warp) * CH + pos];
            x[e] = (b_lo + c) * CH + pos < s_valid ? (G::SCALED ? s * scl[pos] : s) * LOG2E
                                                   : -INFINITY;
            mx = fmaxf(mx, x[e]);
          }
          const float mn = fmaxf(m_run, owc_warp_max(mx));   // finite: a chunk's first is valid
          const float cr = ex2(m_run - mn);
          m_run = mn;
          float sum = 0.0f;
#pragma unroll
          for (int e = 0; e < PPL; ++e) {
            const int pos = lane + 32 * e;
            const float p = ex2(x[e] - mn);   // 0 past s_valid
            sum += p;
            // the v scale folds in after l; past s_valid the scale is never read
            ps[warp * CH + pos] = G::SCALED ? (x[e] > -INFINITY ? p * scl[CH + pos] : 0.0f) : p;
          }
          l_run = l_run * cr + owc_warp_sum(sum);
          if (lane == 0) corr_s[warp] = cr;
        }
      }
    }
    // values: stored row p0 + 256 vt + tid of each V tile
#pragma unroll
    for (int vt = 0; vt < RPT; ++vt) {
      if (vt < nv) {
        cp_async_wait<NT - 2>();
        __syncthreads();   // also: this chunk's probabilities are in shared memory
        issue();
        const unsigned char* tile = ring + (i % NT) * G::SLOT;
        ++i;
        if (vt == 0) {   // the chunk's correction, once
#pragma unroll
          for (int j = 0; j < MQ; ++j) {
            const float cr = corr_s[j];
#pragma unroll
            for (int t = 0; t < RPT; ++t)
#pragma unroll
              for (int n = 0; n < DIMS; ++n) o[t][n][j] *= cr;
          }
        }
        if (vt * W_RT + tid < p_rows) {
#pragma unroll
          for (int pc = 0; pc < G::PPR; ++pc) {
            float v[DIMS][G::VEC];
            G::St::decode(*reinterpret_cast<const uint4*>(tile + Sw::off(tid, pc)), v);
#pragma unroll
            for (int j = 0; j < MQ; ++j)
#pragma unroll
              for (int q4 = 0; q4 < G::VEC / 4; ++q4) {
                const float4 p =
                    *reinterpret_cast<const float4*>(ps + j * CH + pc * G::VEC + 4 * q4);
#pragma unroll
                for (int n = 0; n < DIMS; ++n)
                  o[vt][n][j] = fmaf(p.w, v[n][4 * q4 + 3],
                                     fmaf(p.z, v[n][4 * q4 + 2],
                                          fmaf(p.y, v[n][4 * q4 + 1],
                                               fmaf(p.x, v[n][4 * q4], o[vt][n][j]))));
              }
          }
        }
      }
    }
  }

  // the block's record: o [slot][nib][pass row] in the drained ring, m and l
  cp_async_wait<0>();
  __syncthreads();
  float* rec = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int vt = 0; vt < RPT; ++vt) {
    const int rl = vt * W_RT + tid;
    if (rl < p_rows) {
#pragma unroll
      for (int j = 0; j < MQ; ++j)
#pragma unroll
        for (int n = 0; n < DIMS; ++n) rec[(j * DIMS + n) * G::PASS + rl] = o[vt][n][j];
    }
  }
  if (warp < MQ && lane == 0) {
    ml[warp] = m_run;
    ml[MQ + warp] = l_run;
  }
  // the cluster's blocks, in rank order; every block has a chunk (m finite)
  cluster.sync();
  for (int e = rank * W_THREADS + tid; e < KQ * DIMS * p_rows; e += splits * W_THREADS) {
    const int rl = e % p_rows, jn = e / p_rows, n = jn % DIMS, j = jn / DIMS;
    float big = -INFINITY;
    for (int sp = 0; sp < splits; ++sp) big = fmaxf(big, cluster.map_shared_rank(ml, sp)[j]);
    float l = 0.0f, a = 0.0f;
    for (int sp = 0; sp < splits; ++sp) {
      const float* r = cluster.map_shared_rank(ml, sp);
      const float wgt = ex2(r[j] - big);
      l = fmaf(r[MQ + j], wgt, l);
      a = fmaf(cluster.map_shared_rank(rec, sp)[(j * DIMS + n) * G::PASS + rl], wgt, a);
    }
    owc_store(out + g * row_stride + (long long)j * dh + n * rows + p0 + rl, a / l);
  }
  cluster.sync();   // no block leaves while another still reads its record
}

template <int KIND, typename Q, int MQ>
int launch_wide_mq(const void* q, const void* k_t, const void* v_t, const void* k_scale,
                   const void* v_scale, void* out, int BH, int KQ, int row_stride,
                   int S_pad, int s_valid, int splits, int dh, size_t smem,
                   cudaStream_t st) {
  using G = WGeo<KIND, Q>;
  using T = typename G::T;
  auto kernel = cross_attn_wide_kernel<KIND, Q, MQ>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int rows = KIND == KV_INT4 ? dh / 2 : dh;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)BH, (unsigned)splits, (unsigned)((rows + G::PASS - 1) / G::PASS));
  cfg.blockDim = dim3(W_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const Q*>(q), static_cast<const T*>(k_t),
                         static_cast<const T*>(v_t), static_cast<const float*>(k_scale),
                         static_cast<const float*>(v_scale), static_cast<Q*>(out), KQ,
                         row_stride, S_pad, s_valid, dh);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The slot template of KQ slots (1, 4 or 8: a one-slot call does one slot's
// work), launched once; where its q would not fit in shared memory beside
// the ring, launches of fewer slots each (reading K and V again).
template <int KIND, typename Q>
int launch_wide(const void* q, const void* k_t, const void* v_t, const void* k_scale,
                const void* v_scale, void* out, int BH, int KQ, int row_stride, int S_pad,
                int s_valid, int splits, int dh, cudaStream_t st) {
  using G = WGeo<KIND, Q>;
  if (splits < 1 || splits > 8 || splits > (s_valid + G::CH - 1) / G::CH)
    return (int)cudaErrorInvalidValue;
  const int rows = KIND == KV_INT4 ? dh / 2 : dh;
  int mq = KQ == 1 ? 1 : KQ <= 4 ? 4 : 8;
  while (mq > 1 && wide_smem<KIND, Q>(rows, mq) > W_SMEM_MAX) mq = mq == 8 ? 4 : 1;
  const size_t smem = wide_smem<KIND, Q>(rows, mq);
  if (smem > W_SMEM_MAX) return (int)cudaErrorInvalidValue;
  for (int j0 = 0; j0 < KQ; j0 += mq) {
    const int kq = KQ - j0 < mq ? KQ - j0 : mq;
    const void* qj = static_cast<const Q*>(q) + (long long)j0 * dh;
    void* oj = static_cast<Q*>(out) + (long long)j0 * dh;
    const int err =
        mq == 1 ? launch_wide_mq<KIND, Q, 1>(qj, k_t, v_t, k_scale, v_scale, oj, BH, kq,
                                             row_stride, S_pad, s_valid, splits, dh, smem, st)
        : mq == 4 ? launch_wide_mq<KIND, Q, 4>(qj, k_t, v_t, k_scale, v_scale, oj, BH, kq,
                                               row_stride, S_pad, s_valid, splits, dh, smem, st)
                  : launch_wide_mq<KIND, Q, 8>(qj, k_t, v_t, k_scale, v_scale, oj, BH, kq,
                                               row_stride, S_pad, s_valid, splits, dh, smem,
                                               st);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// The WIDE launcher that cross_attention.cu's entry points call at cap
// OWC_WIDE (grouped: KQ slots of q at a row stride; one query: KQ = 1 and a
// row stride of dh): arguments as there. splits: the blocks (1..8) of the
// cluster that shares a row, each given at least one chunk (32 positions of
// f32 K/V, 64 of the others). Requires 1 <= KQ <= 8, 1 <= s_valid <= S_pad,
// S_pad a multiple of the kind's 16-byte chunk, 16-byte aligned k_t/v_t and
// scales, an even dh for int4; any dh whose one slot of q fits in shared
// memory beside the ring (some 30,000).
int owc_cross_grouped_wide(const void* q, const void* k_t, const void* v_t,
                           const void* k_scale, const void* v_scale, void* out, int BH,
                           int KQ, int row_stride, int S_pad, int s_valid, int splits,
                           int kind, int dtype, int dh, cudaStream_t st) {
  if (KQ < 1 || KQ > G_MAXQ || s_valid < 1 || s_valid > S_pad || dh < 1 || BH < 1 ||
      (kind == KV_INT4 && dh % 2))
    return (int)cudaErrorInvalidValue;
  int err = 0;
  const bool ok = dispatch(kind, dtype, [&](auto kind_tag, auto qt) {
    err = launch_wide<decltype(kind_tag)::value, decltype(qt)>(
        q, k_t, v_t, k_scale, v_scale, out, BH, KQ, row_stride, S_pad, s_valid, splits, dh,
        st);
  });
  return ok ? err : (int)cudaErrorInvalidValue;
}
