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

// dtype codes shared with the Python wrappers (ops/kernels.py DTYPE_CODES)
#define OWC_F32 0
#define OWC_BF16 1
#define OWC_F16 2

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

// Where the sums of `owc_reduce_scatter8` land: value e of a lane's result
// is value `owc_scatter_base<N>(lane)` + e of the N.
template <int N>
__device__ __forceinline__ int owc_scatter_base(int lane) {
  int base = 0, n = N;
#pragma unroll
  for (int o = 16; o >= 4; o >>= 1) {
    if (n > 1) {
      n /= 2;
      if (lane & o) base += n;
    }
  }
  return base;
}

// Sums x over the 8 lanes that share lane & 3 (lanes differing in bits 2-4)
// and keeps a share: at each of the three steps a lane sends half of its
// values to its partner and adds the other half, so N values become
// max(N / 8, 1) sums (N / 8 > 0: each held by one lane; N = 4: by the two
// lanes that differ in bit 2; N = 2 or 1: by all four). 3 to 14 shuffles in
// place of 3 N.
template <int N>
__device__ __forceinline__ void owc_reduce_scatter8(float (&x)[N], int lane) {
  int n = N;
#pragma unroll
  for (int o = 16; o >= 4; o >>= 1) {
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

// Block-wide reductions for blockDim.x a multiple of 32 (at most 1024).
// `scratch` holds 32 floats of shared memory; every thread gets the result.
__device__ __forceinline__ float owc_block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = owc_warp_max(v);
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < nwarps ? scratch[lane] : -INFINITY;
  return owc_warp_max(v);
}

__device__ __forceinline__ float owc_block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = owc_warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < nwarps ? scratch[lane] : 0.0f;
  return owc_warp_sum(v);
}
