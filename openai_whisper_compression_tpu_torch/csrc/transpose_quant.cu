// Fused transpose + int8 quantize of a cross-attention K or V projection.
//
// Replaces: openai_whisper_compression_tpu/ops/cross_attention.py
//           transpose_quant_kv (kernel body _tq_kernel).
// For x (B, S, H * Dh) f32, bf16 or f16 and every (b, h, s) with s < S_pad:
//   v[d]  = x[b, s, h * Dh + d] as f32, or 0 for s >= S (padding)
//   scale = max(max_d |v[d]|, 1e-12) * f32(1 / 127)
//   q[(b * H + h), d, s]     = clamp(rint(v[d] / scale), -127, 127)  (int8)
//   scales[(b * H + h), 0, s] = scale                                 (f32)
// The scale multiplies by the f32 reciprocal of 127, as the JAX package's
// `/ 127.0` compiles under jit; the quotient is that of an IEEE division
// (the build has no fast-math flags) and rint rounds half to even like
// jnp.round.
//
// What bounds it on the H100: device-memory bytes. It reads the projection
// once and writes a quarter (bf16 input) of its bytes back: at whisper-small,
// batch 96, 221 MB in and 120 MB out per tensor (0.102 ms at 3.35 TB/s), 24
// tensors per batch. The kernel this one replaced ran at 30% of that: it read
// x one 2-byte element a thread at a time, 64-position tiles wrote each code
// row in half-lines, and an IEEE division per element (a ~20-instruction
// subroutine) made it instruction-bound.
//
// Design: one block (8 warps at Dh = 64) per (b, h, tile of 128 positions);
// several blocks an SM, so one block's loads run under another's stores.
// - Loads: 16 bytes a lane. A position's 64 dims are 128 contiguous bytes in
//   bf16 or f16 (8 lanes) or 256 in f32 (16 lanes); each lane loads the same
//   16 bytes of 4 neighbouring positions, so a warp step brings whole lines
//   and every lane ends up holding 4 positions of the same dims.
// - Scales: a position's absmax is the lane's own maximum, then a shuffle
//   over the 8 (16) lanes of the position: no shared memory, no barrier.
// - Head dims: the kernel is a template on Dh (16, 32, 64 or 128; every
//   Whisper size has 64, the test models 16). A position takes Dh / 8 lanes
//   in bf16 or f16 and Dh / 4 in f32; a warp covers 16 positions, or, where
//   a warp step's lane groups cover more (Dh = 16 and 32), that many, and
//   the block has as many warps as its 128 positions need (2 at Dh = 16 in
//   bf16).
// - Any other head dim dh up to 256 runs the RAGGED instance of its
//   capacity (the smallest of 16, 32, 64, 128, 256 >= dh), which takes dh
//   at run time: a lane's dims past dh load as zeros (which leave the
//   absmax and every code as they are), only dh code rows are written, and
//   where a head's slice of x (h * dh elements in) is not 16-byte aligned
//   a piece is read as the aligned 4-byte words that hold it, shifted into
//   place. At capacity 256 in f32 a
//   position is 64 pieces, so a lane takes two (32 lanes a position).
// - Codes: v * (1 / scale) rounds to the same integer as the IEEE quotient
//   v / scale unless it lies within 2^-10 of a half-integer (the product is
//   within 2^-22 relative of the quotient, far less than that margin at
//   |v / scale| <= 127); those rare elements take the IEEE division itself,
//   so every code equals the plain version's bit for bit.
// - Transpose: a lane's 4 positions of one dim are one 32-bit word of that
//   dim's code row, stored to a [64][128] byte tile in shared memory whose
//   16-byte chunks are XOR-swizzled by the row, so the 32 words a warp stores
//   fall on 32 banks (f32 input: 16, two lanes a bank) and a row reads back
//   as whole 16-byte chunks. After one barrier each row of 128 codes leaves
//   as a whole 128-byte line (8 lanes, 16 bytes each).
// - A head dim past 256 runs the WIDE body (below), which walks the head dim
//   in chunks of 32.
// Any S and H work (S_pad is a multiple of 128).
#include "common.cuh"

namespace {

constexpr int TS = 128;
constexpr int CHUNKS = TS / 16;  // 16-byte chunks of a code row

// How a block of head dim DH over elements of T is cut: lanes a position,
// the positions a warp covers, the warps a block.
template <typename T, int DH>
struct Cut {
  static constexpr int V0 = 16 / sizeof(T);  // elements a 16-byte load holds: 8 or 4
  // 16-byte pieces a lane: 2 where a position's pieces outnumber the lanes
  // (f32 at DH = 256), else 1
  static constexpr int PPL = DH / V0 > 32 ? DH / V0 / 32 : 1;
  static constexpr int V = V0 * PPL;        // elements a lane
  static constexpr int L = DH / V;          // lanes a position
  static constexpr int Q = 32 / L;          // lane groups a warp step
  static constexpr int STEPS = 16 / (4 * Q) / PPL > 1 ? 16 / (4 * Q) / PPL : 1;
  static constexpr int PW = 4 * Q * STEPS;  // positions a warp covers
  static constexpr int THREADS = 32 * TS / PW;
  static_assert(L >= 1 && L <= 32 && TS % PW == 0, "head dim");
};

__device__ __forceinline__ void unpack(const uint4& r, float* v, float) {
  v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float* v, __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& r, float* v, __half) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// The int8 code of v under `scale`, given r = 1 / scale: the product's
// rounding unless the product lies near a half-integer, where only the IEEE
// quotient decides (see the header).
__device__ __forceinline__ int code_of(float v, float scale, float r) {
  float y = v * r;
  const float k = rintf(y);
  if (fabsf(y - k) > 0.5f - 0.0009765625f) y = v / scale;
  return min(max(__float2int_rn(y), -127), 127);
}

// The 32-bit word of tile row `row` at word `word` (4 positions of codes),
// its 16-byte chunk swizzled by the row's group of 8.
__device__ __forceinline__ int tile_word(int row, int word) {
  return row * (TS / 4) + ((((word >> 2) ^ (row >> 3)) & (CHUNKS - 1)) << 2) + (word & 3);
}

// RAGGED: the capacity-DH body of a head dim dh < DH (or dh = DH = 256)
// given at run time; `align`: the alignment class of x's rows of dh
// elements (`owc_align_class`).
template <typename T, int DH, bool RAGGED>
__global__ void __launch_bounds__(Cut<T, DH>::THREADS)
transpose_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                       float* __restrict__ scales, int S, int H, int S_pad, int dh,
                       int align) {
  using C = Cut<T, DH>;
  constexpr int V0 = C::V0, PPL = C::PPL;
  constexpr int V = C::V, L = C::L, Q = C::Q, STEPS = C::STEPS, PW = C::PW;
  constexpr int THREADS = C::THREADS;
  __shared__ __align__(16) uint32_t tile[DH * TS / 4];
  const int s_base = blockIdx.x * TS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = lane % L, grp = lane / L;
  const int dhr = RAGGED ? dh : DH;  // the head dim of x and of the code rows
  const size_t D = (size_t)H * dhr;
  const size_t bh = (size_t)b * H + h;
  const T* xb = x + (size_t)b * S * D + (size_t)h * dhr + j * V;

  uint4 raw[STEPS][4][PPL];
  owc_aligned_as<RAGGED>(align, [&](auto A) {
#pragma unroll
    for (int st = 0; st < STEPS; ++st)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s_base + PW * warp + 4 * (st * Q + grp) + i;
#pragma unroll
        for (int pc = 0; pc < PPL; ++pc) {
          const T* p = xb + (size_t)s * D + pc * V0;
          if constexpr (decltype(A)::value == 0)
            raw[st][i][pc] = s < S ? __ldg(reinterpret_cast<const uint4*>(p))
                                   : make_uint4(0, 0, 0, 0);
          else
            raw[st][i][pc] = s < S ? owc_load_piece<decltype(A)::value>(
                                         p, dh - (j * V + pc * V0))
                                   : make_uint4(0, 0, 0, 0);
        }
      }
  });

#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    const int p0 = PW * warp + 4 * (st * Q + grp);  // the lane's first position
    float v[4][V], sc[4], rc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int pc = 0; pc < PPL; ++pc) unpack(raw[st][i][pc], v[i] + pc * V0, T());
      float a = 0.0f;
#pragma unroll
      for (int k = 0; k < V; ++k) a = fmaxf(a, fabsf(v[i][k]));
#pragma unroll
      for (int o = 1; o < L; o <<= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
      sc[i] = fmaxf(a, 1e-12f) * (1.0f / 127.0f);
      rc[i] = __frcp_rn(sc[i]);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        word |= (uint32_t)(uint8_t)code_of(v[i][k], sc[i], rc[i]) << (8 * i);
      tile[tile_word(j * V + k, p0 >> 2)] = word;
    }
    if (j == 0)
      *reinterpret_cast<float4*>(scales + bh * S_pad + s_base + p0) =
          make_float4(sc[0], sc[1], sc[2], sc[3]);
  }
  __syncthreads();

  const uint4* tile16 = reinterpret_cast<const uint4*>(tile);
#pragma unroll
  for (int c = tid; c < DH * CHUNKS; c += THREADS) {
    const int row = c / CHUNKS, ch = c % CHUNKS;
    if (RAGGED && row >= dh) continue;  // code rows past dh do not exist
    *reinterpret_cast<uint4*>(q + (bh * dhr + row) * S_pad + s_base + ch * 16) =
        tile16[row * CHUNKS + ((ch ^ (row >> 3)) & (CHUNKS - 1))];
  }
}

// The grid's y and z extents hold at most 65535 heads and clips: a larger H
// or B is launched in slices, each kernel given the full H (its strides) and
// x, q and scales offset to its first (b, h), so a call that fits is one
// launch as it always was.
constexpr int MAX_YZ = 65535;

template <typename T, typename F>
cudaError_t over_slices(const void* x, int8_t* q, float* scales, int B, int S, int H,
                        int S_pad, int dh, F&& launch_slice) {
  const size_t D = (size_t)H * dh;
  for (int b0 = 0; b0 < B; b0 += MAX_YZ)
    for (int h0 = 0; h0 < H; h0 += MAX_YZ) {
      const size_t bh0 = (size_t)b0 * H + h0;
      launch_slice(static_cast<const T*>(x) + (size_t)b0 * S * D + (size_t)h0 * dh,
                   q + bh0 * dh * S_pad, scales + bh0 * S_pad,
                   B - b0 < MAX_YZ ? B - b0 : MAX_YZ, H - h0 < MAX_YZ ? H - h0 : MAX_YZ);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  return cudaSuccess;
}

template <typename T, int DH, bool RAGGED>
cudaError_t launch(const void* x, int8_t* q, float* scales, int B, int S, int H, int S_pad,
                   int dh, cudaStream_t st) {
  return over_slices<T>(x, q, scales, B, S, H, S_pad, dh,
                        [&](const T* xs, int8_t* qs, float* ss, int nb, int nh) {
    const dim3 grid(S_pad / TS, nh, nb);
    transpose_quant_kernel<T, DH, RAGGED><<<grid, Cut<T, DH>::THREADS, 0, st>>>(
        xs, qs, ss, S, H, S_pad, dh, owc_align_class((long long)dh * sizeof(T), xs));
  });
}

// The WIDE body: a head dim dh past 256, taken at run time. A block of 8
// warps takes 32 positions of one (b, h): each warp the absmax of 4
// positions over the whole dh (its lanes reading 32 neighbouring dims of a
// row at a time), then the codes 32 dims at a time through a [32][33] float
// tile in shared memory, so that the reads of x run along dims and each
// code row leaves as 32 neighbouring bytes; no register array grows with dh.
// The codes take the IEEE quotient (`owc_quant_int8`), bit for bit the
// plain version's.
constexpr int WIDE_POS = 32;
constexpr int WIDE_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS)
transpose_quant_wide_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                            float* __restrict__ scales, int S, int H, int S_pad, int dh) {
  __shared__ float tile[WIDE_POS][WIDE_POS + 1];
  __shared__ float sc[WIDE_POS];
  const int s_base = blockIdx.x * WIDE_POS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t D = (size_t)H * dh;
  const size_t bh = (size_t)b * H + h;
  const T* xb = x + (size_t)b * S * D + (size_t)h * dh;
  for (int i = warp; i < WIDE_POS; i += WIDE_THREADS / 32) {
    const int s = s_base + i;
    float a = 0.0f;
    if (s < S)
      for (int d = lane; d < dh; d += 32) a = fmaxf(a, fabsf(owc_to_float(xb[s * D + d])));
    a = owc_warp_max(a);
    if (lane == 0) {
      sc[i] = fmaxf(a, 1e-12f) * (1.0f / 127.0f);
      scales[bh * S_pad + s] = sc[i];
    }
  }
  for (int d0 = 0; d0 < dh; d0 += WIDE_POS) {
    __syncthreads();   // sc is written; the previous tile has been read
    for (int e = tid; e < WIDE_POS * WIDE_POS; e += WIDE_THREADS) {
      const int i = e / WIDE_POS, dd = e % WIDE_POS, s = s_base + i;
      tile[i][dd] = s < S && d0 + dd < dh ? owc_to_float(xb[s * D + d0 + dd]) : 0.0f;
    }
    __syncthreads();
    for (int e = tid; e < WIDE_POS * WIDE_POS; e += WIDE_THREADS) {
      const int dd = e / WIDE_POS, i = e % WIDE_POS;
      if (d0 + dd < dh)
        q[(bh * dh + d0 + dd) * S_pad + s_base + i] = (int8_t)owc_quant_int8(tile[i][dd], sc[i]);
    }
  }
}

}  // namespace

// x (B, S, H * dh) f32, bf16 or f16 (dtype code), 16-byte aligned where dh
// is 16, 32, 64 or 128 (element aligned otherwise); q (B * H, dh, S_pad)
// int8 and scales (B * H, 1, S_pad) f32, 16-byte aligned, every position
// written. cap: dh's capacity, the smallest of 16, 32, 64, 128, 256 that is
// >= dh (dh = cap <= 128 runs the whole body, any other the RAGGED one), or
// OWC_WIDE for a dh past 256 (the WIDE body, which reads x element aligned).
// Requires S <= S_pad and S_pad % 128 == 0.
extern "C" int owc_transpose_quant_kv(const void* x, void* q, void* scales,
                                      int B, int S, int H, int S_pad, int dtype,
                                      int dh, int cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scales);
  if (B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (cap == OWC_WIDE) {
    if (S_pad % TS != 0 || S > S_pad || dh < 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSuccess;
    const bool ok = owc_dispatch_float(dtype, [&](auto tag) {
      using T = decltype(tag);
      err = over_slices<T>(x, qo, so, B, S, H, S_pad, dh,
                           [&](const T* xs, int8_t* qs, float* ss, int nb, int nh) {
        transpose_quant_wide_kernel<T><<<dim3(S_pad / WIDE_POS, nh, nb), WIDE_THREADS, 0,
                                         st>>>(xs, qs, ss, S, H, S_pad, dh);
      });
    });
    return ok ? (int)err : (int)cudaErrorInvalidValue;
  }
  if (S_pad % TS != 0 || S > S_pad || dh < 1 || dh > cap || (cap > 16 && 2 * dh <= cap))
    return (int)cudaErrorInvalidValue;
  const bool whole = dh == cap;
  bool known = true;
  cudaError_t err = cudaSuccess;
  const bool ok = owc_dispatch_float(dtype, [&](auto tag) {
    using T = decltype(tag);
    switch (cap) {
      case 16:
        err = whole ? launch<T, 16, false>(x, qo, so, B, S, H, S_pad, dh, st)
                    : launch<T, 16, true>(x, qo, so, B, S, H, S_pad, dh, st);
        break;
      case 32:
        err = whole ? launch<T, 32, false>(x, qo, so, B, S, H, S_pad, dh, st)
                    : launch<T, 32, true>(x, qo, so, B, S, H, S_pad, dh, st);
        break;
      case 64:
        err = whole ? launch<T, 64, false>(x, qo, so, B, S, H, S_pad, dh, st)
                    : launch<T, 64, true>(x, qo, so, B, S, H, S_pad, dh, st);
        break;
      case 128:
        err = whole ? launch<T, 128, false>(x, qo, so, B, S, H, S_pad, dh, st)
                    : launch<T, 128, true>(x, qo, so, B, S, H, S_pad, dh, st);
        break;
      case 256: err = launch<T, 256, true>(x, qo, so, B, S, H, S_pad, dh, st); break;
      default: known = false;
    }
  });
  if (!ok || !known) return (int)cudaErrorInvalidValue;
  return (int)err;
}
