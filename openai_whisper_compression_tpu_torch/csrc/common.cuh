// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exposes `extern "C"` launchers with a plain C interface:
// raw device pointers, sizes, a dtype code where the kernel takes more than
// one element type, and the CUDA stream, all passed from Python through
// ctypes. A launcher enqueues its kernel(s) on the given stream, never
// synchronises or allocates, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// dtype codes shared with the Python wrappers (ops/kernels.py DTYPE_CODES)
#define OWC_F32 0
#define OWC_BF16 1
#define OWC_F16 2

// The capacity code of the attention kernels' WIDE bodies, which take any
// head dim past 256 at run time (ops/kernels.py WIDE); 16, 32, 64, 128 and
// 256 name the other bodies.
#define OWC_WIDE 0

__device__ __forceinline__ float owc_to_float(float x) { return x; }
__device__ __forceinline__ float owc_to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float owc_to_float(__half x) { return __half2float(x); }

__device__ __forceinline__ void owc_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void owc_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void owc_store(__half* p, float x) { *p = __float2half_rn(x); }

// Calls `fn(T())` with T the element type of dtype code `dtype`; false for a
// code no kernel takes.
template <typename F>
bool owc_dispatch_float(int dtype, F&& fn) {
  switch (dtype) {
    case OWC_F32: fn(float()); return true;
    case OWC_BF16: fn(__nv_bfloat16()); return true;
    case OWC_F16: fn(__half()); return true;
    default: return false;
  }
}

// Round a float to bf16 precision and back (round to nearest even), so f32
// inputs meet the same bf16 operand rounding as the TPU kernels apply.
__device__ __forceinline__ float owc_round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Symmetric int8 code of x under `scale`: clamp(rint(x / scale), -127, 127),
// an IEEE division (no fast-math flags) rounded half to even, as jnp.round
// and torch.round round.
__device__ __forceinline__ int owc_quant_int8(float x, float scale) {
  return (int)fminf(fmaxf(rintf(x / scale), -127.0f), 127.0f);
}

// The 4 int8 codes of w (byte i = code i) as exact floats: code + 128 goes
// into the low mantissa bits of 2^23, and 2^23 + 128 is subtracted (a byte
// permute and an add each, in place of a conversion instruction).
__device__ __forceinline__ void owc_int8x4_to_float(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.0f;
}

// The same for the 4 signed nibbles u - 8 of w, u = (w >> shift) & 15 in each
// byte (shift 0: the low nibbles, 4: the high ones).
__device__ __forceinline__ void owc_int4x4_to_float(uint32_t w, int shift, float* f) {
  const uint32_t u = ((w >> shift) & 0x0F0F0F0Fu) ^ 0x08080808u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388616.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388616.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388616.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388616.0f;
}

// Where the sums of `owc_reduce_scatter<HI, LO>` land: value e of a lane's
// result is value `owc_scatter_base<N, HI, LO>(lane)` + e of the N.
template <int N, int HI, int LO>
__device__ __forceinline__ int owc_scatter_base(int lane) {
  int base = 0, n = N;
#pragma unroll
  for (int o = HI; o >= LO; o >>= 1) {
    if (n > 1) {
      n /= 2;
      if (lane & o) base += n;
    }
  }
  return base;
}

// Sums x over the lanes that differ only in the lane bits LO..HI (powers of
// two, HI >= LO: 2 HI / LO lanes) and keeps a share: at each step, HI down
// to LO, a lane sends half of its values to its partner and adds the other
// half, so N values become max(N / lanes, 1) sums, each held by one lane
// where N >= lanes, else by the lanes that differ in the last bits only.
// Fewer shuffles than an all-reduce of each value (3 to 14 in place of 3 N
// over 8 lanes).
template <int HI, int LO, int N>
__device__ __forceinline__ void owc_reduce_scatter(float (&x)[N], int lane) {
  int n = N;
#pragma unroll
  for (int o = HI; o >= LO; o >>= 1) {
    if (n > 1) {
      const int h = n / 2;
      const bool up = lane & o;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        if (i < h) {
          const float send = up ? x[i] : x[i + h];
          const float keep = up ? x[i + h] : x[i];
          x[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      n = h;
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], o);
    }
  }
}

// The RAGGED bodies read and write rows of a head dim dh that need not be
// whole 16-byte pieces, or 16-byte aligned. A row's alignment class is 16
// where its bytes and every base pointer are multiples of 16, else 1
// (`owc_align_class`); the bodies take the class at compile time in each
// load loop (one copy of the loop a class), so that a pass's loads stay in
// flight together.
template <typename... P>
inline int owc_align_class(long long row_bytes, P... ptrs) {
  uintptr_t bits = (uintptr_t)row_bytes;
  ((bits |= (uintptr_t)ptrs), ...);
  return bits % 16 == 0 ? 16 : 1;
}

// The 16 bytes of the first 16 / sizeof(T) elements at p, or of the first n
// of them followed by zero bytes where n is smaller (zeros where n <= 0), p
// in a row of alignment class A: one 16-byte load (A = 16: a piece lies
// wholly inside or outside the row), or (A = 1) the 4-byte aligned words
// that hold the piece's bytes, at most five, shifted into place: a word
// holding a valid byte lies inside the allocation whatever it holds past
// the row.
template <int A, typename T>
__device__ __forceinline__ uint4 owc_load_piece(const T* p, int n) {
  if constexpr (A == 16) {
    return n > 0 ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
  } else {
    constexpr int V0 = 16 / sizeof(T);
    const int bytes = n <= 0 ? 0 : (n < V0 ? n : V0) * (int)sizeof(T);
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
    const int o = (int)(a & 3);
    uint32_t r[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) r[j] = 4 * j < o + bytes ? w[j] : 0u;
    uint32_t out[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t v = __funnelshift_r(r[k], r[k + 1], 8 * o);
      const int left = bytes - 4 * k;   // valid bytes of this word
      out[k] = left >= 4 ? v : left <= 0 ? 0u : v & ((1u << (8 * left)) - 1u);
    }
    return make_uint4(out[0], out[1], out[2], out[3]);
  }
}

// The first n elements of the 16 bytes u to p (all of them where n covers
// the piece; none where n <= 0), p in a row of alignment class A: one
// 16-byte store (A = 16) or a store an element.
template <int A, typename T>
__device__ __forceinline__ void owc_store_piece(T* p, const uint4& u, int n) {
  if constexpr (A == 16) {
    if (n > 0) *reinterpret_cast<uint4*>(p) = u;
  } else {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    if constexpr (sizeof(T) == 4) {
      uint32_t* e = reinterpret_cast<uint32_t*>(p);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < n) e[k] = w[k];
    } else if constexpr (sizeof(T) == 2) {
      unsigned short* e = reinterpret_cast<unsigned short*>(p);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < n) e[k] = (unsigned short)(w[k >> 1] >> (16 * (k & 1)));
    } else {
      unsigned char* e = reinterpret_cast<unsigned char*>(p);
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (k < n) e[k] = (unsigned char)(w[k >> 2] >> (8 * (k & 3)));
    }
  }
}

// Calls f(A) with A the integral_constant of alignment class `align`: 0 (a
// whole body, which loads whole 16-byte pieces) unless RAGGED.
template <bool RAGGED, typename F>
__device__ __forceinline__ void owc_aligned_as(int align, F&& f) {
  if constexpr (!RAGGED) f(std::integral_constant<int, 0>());
  else if (align == 16) f(std::integral_constant<int, 16>());
  else f(std::integral_constant<int, 1>());
}

__device__ __forceinline__ float owc_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float owc_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
