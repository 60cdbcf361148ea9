// The card's peak rate of mma.sync m16n8k8 TF32 (and of m16n8k16 bf16 beside
// it): every warp of two blocks an SM issues long streams of independent
// products, 4, 8 and 16 warps a block. The f32 encoder attention's 3xTF32
// bodies run on this instruction (PERF.md, row 10). Build and run on the
// GPU machine:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o /tmp/mma_sync_rate \
//       tools/mma_sync_rate.cu && /tmp/mma_sync_rate
#include <cstdio>
#include <cuda_runtime.h>
#include <cstdint>
template <bool BF>
__global__ void probe(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (BF)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out; cudaMalloc(&out, sms * 4 * 1024 * 4);
  const int iters = 4096;
  for (int bf = 0; bf < 2; ++bf)
    for (int warps : {4, 8, 16}) {
      cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
      auto run = [&]() { if (bf) probe<true><<<sms * 2, warps * 32>>>(out, iters); else probe<false><<<sms * 2, warps * 32>>>(out, iters); };
      run(); cudaDeviceSynchronize();
      cudaEventRecord(e0); run(); cudaEventRecord(e1); cudaEventSynchronize(e1);
      float ms; cudaEventElapsedTime(&ms, e0, e1);
      double flop = 2.0 * sms * warps * iters * 8 * (bf ? 4096.0 : 2048.0);
      printf("mma.sync %s, %d warps a block, 2 blocks an SM: %.1f TFLOP/s\n", bf ? "bf16 m16n8k16" : "tf32 m16n8k8", warps, flop / ms / 1e9);
    }
  return 0;
}
