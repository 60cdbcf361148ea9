// Fused log-mel: windowed DFT -> power -> mel filterbank -> log10.
//
// Replaces: openai_whisper_compression_tpu/audio/mel_pallas.py
//           log_mel_pallas (kernel body _mel_kernel).
// Computes, for every frame row r of (R, 400) reflect-padded frames:
//   re = frame . cosB, im = frame . sinB     (400 x n_freq bases, window folded in)
//   out[r, m] = log10(max(sum_f (re^2 + im^2)[f] * melfb[f, m], 1e-10))
// Frames and bases arrive in the DFT dtype (bf16 with fast_mel, else f32);
// products are formed and summed in f32, as the TPU kernel's
// preferred_element_type=f32 dots do. The trailing-frame drop, the clamp to
// max-8 and the (x+4)/4 scaling stay outside, in PyTorch.
//
// What bounds it on the H100: arithmetic. 2 x 400 x 201 x 2 FLOPs per frame
// for the DFT (about 31 GFLOP for 32 utterances of 30 s) against 1.6 KB of
// bf16 frame bytes, far above the card's bytes-to-FLOPs balance point. This
// first version runs the products on CUDA cores (f32 FMA), so it is bounded
// by the f32 FMA rate; a tensor-core (mma/wgmma) version is later work.
//
// Design: one block per 32 frames. The block stages its frames in shared
// memory as f32 (51 KB, dynamic shared memory). One thread per frequency
// bin keeps the 32 frames' re/im sums in registers and walks the 400 taps,
// reading its two basis columns from L2/L1 (the 0.3-0.6 MB bases stay
// cache-resident across blocks) and the frames as broadcast float4 loads.
// The power spectrum of the 32 frames stays in shared memory for the mel
// product, so only the (R, n_mels) f32 result is written to device memory.
#include "common.cuh"

namespace {

constexpr int NFFT = 400, ROWS = 32;

template <typename T>
__global__ void mel_log10_kernel(const T* __restrict__ frames,
                                 const T* __restrict__ cosb,
                                 const T* __restrict__ sinb,
                                 const float* __restrict__ melfb,
                                 float* __restrict__ out, int R, int n_freq,
                                 int n_mels) {
  extern __shared__ __align__(16) float smem[];
  float* fs = smem;                 // [ROWS][NFFT] frames as f32
  float* pw = smem + ROWS * NFFT;   // [ROWS][n_freq] power spectrum
  const int r0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, R - r0);

  for (int i = threadIdx.x; i < ROWS * NFFT; i += blockDim.x) {
    const int r = i / NFFT;
    fs[i] = r < nrows ? owc_to_float(frames[(size_t)r0 * NFFT + i]) : 0.0f;
  }
  __syncthreads();

  for (int f = threadIdx.x; f < n_freq; f += blockDim.x) {
    float re[ROWS], im[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) re[r] = im[r] = 0.0f;
    for (int t = 0; t < NFFT; t += 4) {
      float c[4], s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        c[u] = owc_to_float(cosb[(t + u) * n_freq + f]);
        s[u] = owc_to_float(sinb[(t + u) * n_freq + f]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(fs + r * NFFT + t);
        re[r] = fmaf(x.x, c[0], re[r]);
        im[r] = fmaf(x.x, s[0], im[r]);
        re[r] = fmaf(x.y, c[1], re[r]);
        im[r] = fmaf(x.y, s[1], im[r]);
        re[r] = fmaf(x.z, c[2], re[r]);
        im[r] = fmaf(x.z, s[2], im[r]);
        re[r] = fmaf(x.w, c[3], re[r]);
        im[r] = fmaf(x.w, s[3], im[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) pw[r * n_freq + f] = re[r] * re[r] + im[r] * im[r];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nrows * n_mels; i += blockDim.x) {
    const int r = i / n_mels, m = i - r * n_mels;
    const float* p = pw + r * n_freq;
    float acc = 0.0f;
    for (int f = 0; f < n_freq; ++f) acc = fmaf(p[f], melfb[f * n_mels + m], acc);
    out[(size_t)(r0 + r) * n_mels + m] = log10f(fmaxf(acc, 1e-10f));
  }
}

template <typename T>
int launch(const void* frames, const void* cosb, const void* sinb,
           const void* melfb, void* out, int R, int n_freq, int n_mels,
           cudaStream_t st) {
  const size_t smem = (size_t)(ROWS * NFFT + ROWS * n_freq) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      mel_log10_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = ((n_freq + 31) / 32) * 32;
  const int blocks = (R + ROWS - 1) / ROWS;
  mel_log10_kernel<T><<<blocks, threads, smem, st>>>(
      static_cast<const T*>(frames), static_cast<const T*>(cosb),
      static_cast<const T*>(sinb), static_cast<const float*>(melfb),
      static_cast<float*>(out), R, n_freq, n_mels);
  return (int)cudaGetLastError();
}

}  // namespace

// frames (R, 400), cosb/sinb (400, n_freq) in the DFT dtype; melfb
// (n_freq, n_mels) f32; out (R, n_mels) f32. Requires n_freq <= 1024.
extern "C" int owc_mel_log10(const void* frames, const void* cosb,
                             const void* sinb, const void* melfb, void* out,
                             int R, int n_freq, int n_mels, int dtype,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == OWC_BF16)
    return launch<__nv_bfloat16>(frames, cosb, sinb, melfb, out, R, n_freq,
                                 n_mels, st);
  return launch<float>(frames, cosb, sinb, melfb, out, R, n_freq, n_mels, st);
}
