// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exposes `extern "C"` launchers with a plain C interface:
// raw device pointers, sizes, a dtype code where the kernel takes both f32
// and bf16 input, and the CUDA stream, all passed from Python through ctypes. A launcher enqueues its kernel(s) on the given
// stream, never synchronises or allocates, and returns cudaGetLastError() so
// the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers (ops/kernels.py DTYPE_CODES)
#define OWC_F32 0
#define OWC_BF16 1

__device__ __forceinline__ float owc_to_float(float x) { return x; }
__device__ __forceinline__ float owc_to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void owc_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void owc_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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
