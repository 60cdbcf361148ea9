// Fused log-mel: windowed DFT -> power -> mel filterbank -> log10.
//
// Replaces: openai_whisper_compression_tpu/audio/mel_pallas.py
//           log_mel_pallas (kernel body _mel_kernel).
// Computes, for frame r of clip b (taps k < 400 of the reflect-padded
// waveform at offset 160 r) and each mel m:
//   re_f = sum_k x[k] cos_f[k],  im_f = sum_k x[k] sin_f[k]   (window folded in)
//   out[b, r, m] = log10(max(sum_f (re_f^2 + im_f^2) fb[f, m], 1e-10))
// Samples and bases are rounded to the DFT dtype (bf16 with fast_mel, else
// f32); products and sums run in f32, as the TPU kernel's
// preferred_element_type=f32 dots do. The trailing-frame drop, the clamp to
// max - 8 and (x + 4) / 4 stay outside, in PyTorch.
//
// Operands (built by audio/mel_kernel.py::mel_operands): the reflect-padded
// waveform (B, stride) f32 with stride a multiple of 4 samples, read in place
// (no frame is ever written to device memory); the bases with cos and sin of
// each bin side by side, columns 2f and 2f + 1 of 416 (201 bins, zero padded
// to 208); the filterbank as bands: for each mel its first bin and the
// number of bins from its first nonzero weight to its last (at most 14 of
// 201 at 80 mels), with those weights. A band sum in ascending f is the
// dense sum in the same order, since the weights outside it are zeros.
//
// What bounds it on the H100: operations. The DFT is 2 x 400 x 402 flop a
// frame (31 GFLOP for 32 clips of 30 s: 0.031 ms at the bf16 tensor-core
// peak); the waveform and the output are 92 MB (0.027 ms), the banded mel
// product 0.8 MFLOP. The kernel this one replaced ran the DFT as f32 FMAs on
// CUDA cores from frames copied out to device memory first, and multiplied
// by the dense 201 x 80 filterbank: 26x its bound, slower than plain torch.
//
// bf16 body: the DFT on the tensor cores (wgmma, f32 accumulators).
// - A block takes 128 consecutive frames of one clip: two warpgroups of 64.
//   Their 20,720 samples are read once, rounded to bf16 and written into a
//   frame-major tile in shared memory, 408 taps a row (816 bytes, an odd
//   number of 16-byte chunks, so the 8 rows an ldmatrix reads fall on
//   distinct banks; frames 320 bytes apart would not).
// - A frame row is the A operand from registers (ldmatrix, 4 registers a
//   16-tap step); the bases are the B operand from shared memory, K-major:
//   the 416 columns in four quarters of 104 (m64n104k16), the 400 taps in 7
//   slabs of 64 (the last of 16). The 28 (quarter, slab) tiles of 13 KB
//   stream through a 3-stage cp.async ring in the 128-byte swizzle wgmma
//   reads; all 333 KB of bases pass through every block, from L2.
// - Each 16-tap step goes into a fresh accumulator, which is added into the
//   f32 sums by TwoSum, its rounding errors summed apart (`add_into`): the
//   25 steps' sum as if rounded once. Carrying the accumulator over steps
//   in the tensor cores loses accuracy in their own additions (over all 400
//   taps: 1.4e-5 from the exact, float64, result; over two steps: 2.6e-5
//   at one seed; PERF.md).
// - Interleaved columns put re and im of one bin in a thread's accumulator
//   pair, so the power re^2 + im^2 forms in registers (f32) and goes to a
//   power tile in shared memory (157 bins a row for the first three
//   quarters, then 53 in the freed ring: odd strides, so 32 neighbouring
//   frames fall on 32 banks).
// - The banded mel product runs on CUDA cores with a lane per frame, in
//   f32, two mels at a time; the rows leave through the freed frame tile.
// f32 body (fast_mel=False): the f32 samples and bases (TF32 would round
// the samples to 10 bits), their products and sums in f64 on CUDA cores. A
// block takes 32 frames of one clip, whose 5,360 samples sit in shared memory
// as they lie in the waveform, widened to f64 once; a thread per bin sums the
// 32 frames' re and im over the 400 taps in f64 registers (each product of
// two f32 values is exact in f64), reading its cos/sin pair as one 8-byte
// load, and rounds them to f32 at the end; the same banded mel product
// follows. A bin whose 400 products nearly cancel (a power ~1e-4 of its
// frame's typical one: thousands of them in a batch of noise) keeps its
// relative accuracy so. One f32 FMA chain over the 400 taps put a streaming
// flush window's log-mel 1.35e-5 from the float64 result where the plain
// version (cuBLAS) was 2.4e-6 from it; 4-tap f32 chains added by TwoSum
// still left 1.40e-5 against the plain version's 5.3e-6 at 8 clips of noise,
// and Dot2 sums in f32 (TwoProduct and TwoSum a tap) cost 2.5x this body.
#include "hopper.cuh"

namespace {

constexpr int NFFT = 400, HOP = 160, NFREQ = 201;
constexpr int NCOL = 416;   // interleaved cos/sin columns (2 x 208 bins)
constexpr int MAX_MELS = 128;

// ---- bf16 body ----
constexpr int BM = 128;             // frames a block
constexpr int THREADS = 256;        // two warpgroups
constexpr int FR_STRIDE = 408;      // bf16 taps a frame row in shared memory
constexpr int SLABS = 7;            // 64-tap slabs of the 400 taps (6 whole, one of 16)
constexpr int QUARTERS = 4;         // column quarters of 104 (52 bins)
constexpr int QCOLS = NCOL / QUARTERS;
constexpr int QBINS = QCOLS / 2;
constexpr int TILES = QUARTERS * SLABS;  // (quarter, slab) tiles of the bases
constexpr int TILE_BYTES = QCOLS * 128;
constexpr int STAGES = 3;
constexpr int SPAN = (BM - 1) * HOP + NFFT;  // samples a block reads
// Shared memory: the ring of bases tiles, the frame tile, and the power of
// the first three quarters (bins 0..155, 157 a frame row: an odd stride, so
// 32 neighbouring frames fall on 32 banks). After the products the ring
// holds the last quarter's power (53 a row) and the frame tile the output.
constexpr int RING_BYTES = STAGES * TILE_BYTES;
constexpr int FR_BYTES = BM * FR_STRIDE * 2;
constexpr int P1_SPLIT = (QUARTERS - 1) * QBINS, P1_STRIDE = P1_SPLIT + 1;
constexpr int P2_STRIDE = QBINS + 1;
constexpr int SMEM_BYTES = RING_BYTES + FR_BYTES + BM * P1_STRIDE * 4 + 1024;
static_assert(BM * P2_STRIDE * 4 <= RING_BYTES && BM * (MAX_MELS + 1) * 4 <= FR_BYTES,
              "the last quarter's power and the output fit where the ring and frames were");

template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (64 x 104 f32) = or += a (64 x 16 bf16, registers) * B (16 x 104, a
// K-major [n][k] shared tile). Thread t of the warpgroup holds rows
// 16 * (t / 32) + (t % 32) / 4 (+ 8) and columns 8j + 2 * (t % 4) (+ 1) in
// d[4j .. 4j + 3]: the warp-level m16n8 accumulator layout, 13 side by side.
__device__ __forceinline__ void wgmma_dft(float (&d)[52], const uint32_t (&a)[4],
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51}, "
      "{%52, %53, %54, %55}, %56, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Tile t of the bases (column quarter t / SLABS, tap slab t % SLABS) into a
// ring stage: row n of the quarter is 128 bytes (64 taps) in the 128-byte
// swizzle, its 16-byte chunk c at chunk c ^ (n % 8) of the row, 8-row groups
// 1024 bytes apart. The last slab's rows carry 16 taps (2 chunks).
__device__ __forceinline__ void load_bases_tile(unsigned char* stage,
                                                const __nv_bfloat16* bases, int t) {
  const int quarter = t / SLABS, slab = t % SLABS;
  const int cpr = slab < SLABS - 1 ? 8 : 2;
  const __nv_bfloat16* src = bases + (size_t)quarter * QCOLS * NFFT + slab * 64;
  const uint32_t dst = smem_u32(stage);
  for (int c = threadIdx.x; c < QCOLS * cpr; c += THREADS) {
    const int n = c / cpr, ch = c % cpr;
    cp_async16(dst + (n >> 3) * 1024 + (n & 7) * 128 + ((ch ^ (n & 7)) << 4),
               src + (size_t)n * NFFT + ch * 8, 16);
  }
}

// sum + comp += d: every add is TwoSum (Knuth), which leaves the f32 sum in
// sum and adds its exact rounding error into comp, so that sum + comp is the
// steps' sum as if taken exactly and rounded once. Plain f32 adds strayed up
// to 3.05e-5 from the exact log-mel on rare ill-conditioned bins, further
// than the plain version's f32 chain; Kahan's 4 operations an add came within
// 1e-6 of that chain at one seed (PERF.md).
__device__ __forceinline__ void add_into(float (&sum)[52], float (&comp)[52], float (&d)[52]) {
  reg_fence(d);
#pragma unroll
  for (int i = 0; i < 52; ++i) {
    const float s = sum[i] + d[i], z = s - sum[i];
    comp[i] += (sum[i] - (s - z)) + (d[i] - z);
    sum[i] = s;
  }
}

// The banded mel product and log10 of frame fr % frames: its power row is
// p1 (bins below `split`, stride s1) and p2 (the rest, stride s2); out to st
// (n_mels + 1 apart). A lane per frame, so a warp's reads of one bin fall on
// distinct banks and the band loop is the same for all lanes; two mels at a
// time, for two independent chains. Thread i takes frame i % frames and
// every (nthreads / frames)-th mel.
__device__ __forceinline__ void mel_bands(const float* p1, int s1, int split,
                                          const float* p2, int s2, float* st,
                                          int frames, int nthreads,
                                          const int* __restrict__ bands,
                                          const float* __restrict__ weights,
                                          int n_mels, int band_w) {
  const int fr = threadIdx.x % frames, step = nthreads / frames;
  p1 += fr * s1;
  p2 += fr * s2;
  for (int m = threadIdx.x / frames; m < n_mels; m += 2 * step) {
    const int m2 = m + step;
    const bool two = m2 < n_mels;
    const int f1 = __ldg(bands + 2 * m), w1 = __ldg(bands + 2 * m + 1);
    const int f2 = two ? __ldg(bands + 2 * m2) : 0, w2 = two ? __ldg(bands + 2 * m2 + 1) : 0;
    const float* wt1 = weights + m * band_w;
    const float* wt2 = two ? weights + m2 * band_w : wt1;
    float a1 = 0.0f, a2 = 0.0f;
    for (int j = 0; j < max(w1, w2); ++j) {
      if (j < w1) {
        const int f = f1 + j;
        a1 = fmaf(f < split ? p1[f] : p2[f - split], __ldg(wt1 + j), a1);
      }
      if (j < w2) {
        const int f = f2 + j;
        a2 = fmaf(f < split ? p1[f] : p2[f - split], __ldg(wt2 + j), a2);
      }
    }
    st[fr * (n_mels + 1) + m] = log10f(fmaxf(a1, 1e-10f));
    if (two) st[fr * (n_mels + 1) + m2] = log10f(fmaxf(a2, 1e-10f));
  }
}

// The staged (frames x n_mels) result rows of one tile to out, coalesced.
__device__ __forceinline__ void store_rows(const float* st, float* __restrict__ out,
                                           size_t base, int nrows, int n_mels) {
  for (int i = threadIdx.x; i < nrows * n_mels; i += blockDim.x) {
    const int r = i / n_mels;
    out[base + i] = st[r * (n_mels + 1) + (i - r * n_mels)];
  }
}

__global__ void __launch_bounds__(THREADS, 1)
mel_bf16_kernel(const float* __restrict__ wav, const __nv_bfloat16* __restrict__ bases,
                const int* __restrict__ bands, const float* __restrict__ weights,
                float* __restrict__ out, int stride, int n_frames, int n_mels,
                int band_w) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = smem;
  __nv_bfloat16* frames = reinterpret_cast<__nv_bfloat16*>(smem + RING_BYTES);
  float* p1 = reinterpret_cast<float*>(smem + RING_BYTES + FR_BYTES);
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, wq = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y, r0 = blockIdx.x * BM;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    load_bases_tile(ring + t * TILE_BYTES, bases, t);
    cp_async_commit();
  }

  // the block's samples, each read once (all of a thread's 16-byte loads in
  // flight together), rounded to bf16 and written to every frame row that
  // holds it (2 or 3: frames overlap by 240 taps)
  {
    const float* row = wav + (size_t)b * stride;
    const int s0 = r0 * HOP;
    constexpr int PER = (SPAN / 4 + THREADS - 1) / THREADS;
    float4 v[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + i * THREADS, s = s0 + 4 * c;
      v[i] = c < SPAN / 4 && s < stride ? __ldg(reinterpret_cast<const float4*>(row + s))
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int j = 4 * (tid + i * THREADS);
      if (j >= SPAN) break;
      const uint2 packed =
          make_uint2(pack_bf16x2(v[i].x, v[i].y), pack_bf16x2(v[i].z, v[i].w));
      const int m_hi = min(j / HOP, BM - 1);
      for (int m = j >= NFFT ? (j - NFFT) / HOP + 1 : 0; m <= m_hi; ++m)
        *reinterpret_cast<uint2*>(frames + m * FR_STRIDE + j - m * HOP) = packed;
    }
  }

  // A fragments: row 16 * wq + (lane % 16) of the warpgroup's 64 frames,
  // taps + 8 for the upper 16 lanes
  const uint32_t a_base = smem_u32(frames) +
      ((64 * wg + 16 * wq + (lane & 15)) * FR_STRIDE + (lane >> 4) * 8) * 2;
  const int row = 64 * wg + 16 * wq + g;  // the thread's frames: row, row + 8
  float acc[52];            // a step's tensor-core accumulator
  float sum[52], comp[52];  // the quarter's f32 sums and their rounding errors
  int t = 0;
#pragma unroll
  for (int qn = 0; qn < QUARTERS; ++qn) {
#pragma unroll 1
    for (int slab = 0; slab < SLABS; ++slab, ++t) {
      cp_async_wait<STAGES - 2>();  // tile t has landed (this thread's copies)
      fence_proxy_async();          // ... and is for wgmma's eyes
      __syncthreads();  // every thread's copies; every product of tile t - 1 done
      if (t + STAGES - 1 < TILES)
        load_bases_tile(ring + ((t + STAGES - 1) % STAGES) * TILE_BYTES, bases,
                        t + STAGES - 1);
      cp_async_commit();
      const uint64_t bd = smem_desc(ring + (t % STAGES) * TILE_BYTES);
      if (slab == 0) {
#pragma unroll
        for (int i = 0; i < 52; ++i) sum[i] = comp[i] = 0.0f;
      }
      // 4 steps of 16 taps (1 in the last slab), each into a fresh
      // accumulator added into the sums; the other warpgroup's products run
      // on the tensor cores while this one adds
      uint32_t a[4][4];
      const int steps = slab < SLABS - 1 ? 4 : 1;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < steps) ldmatrix_x4(a[kk], a_base + (slab * 64 + kk * 16) * 2);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < steps) {
          reg_fence(acc);
          wgmma_fence();
          wgmma_dft(acc, a[kk], bd + ((kk * 32) >> 4), 0);
          wgmma_commit();
          wgmma_wait<0>();
          add_into(sum, comp, acc);
        }
      }
    }
    // the quarter's power: bins QBINS * qn + 4i + t4 of frames row, row + 8
    float* q = qn < QUARTERS - 1 ? p1 + row * P1_STRIDE + QBINS * qn + t4 : nullptr;
    if (qn == QUARTERS - 1) {
      cp_async_wait<0>();
      __syncthreads();  // every product is done: the ring takes the last quarter
      q = reinterpret_cast<float*>(ring) + row * P2_STRIDE + t4;
    }
    const int s8 = qn < QUARTERS - 1 ? 8 * P1_STRIDE : 8 * P2_STRIDE;
#pragma unroll
    for (int i = 0; i < 13; ++i) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = sum[4 * i + e] + comp[4 * i + e];
      q[4 * i] = v[0] * v[0] + v[1] * v[1];
      q[s8 + 4 * i] = v[2] * v[2] + v[3] * v[3];
    }
  }
  __syncthreads();
  float* st = reinterpret_cast<float*>(frames);
  mel_bands(p1, P1_STRIDE, P1_SPLIT, reinterpret_cast<const float*>(ring), P2_STRIDE, st,
            BM, THREADS, bands, weights, n_mels, band_w);
  __syncthreads();
  store_rows(st, out, ((size_t)b * n_frames + r0) * n_mels, min(BM, n_frames - r0),
             n_mels);
}

// ---- f32 body ----
constexpr int FM = 32;                         // frames a block
constexpr int F_THREADS = 224;                 // a thread a bin (7 warps)
constexpr int F_SPAN = (FM - 1) * HOP + NFFT;  // samples a block reads
constexpr int F_SMEM_BYTES = F_SPAN * 8 + FM * NFREQ * 4;
static_assert(FM * 129 <= 2 * F_SPAN, "the output tile must fit where the samples were");

__global__ void __launch_bounds__(F_THREADS)
mel_f32_kernel(const float* __restrict__ wav, const float* __restrict__ bases,
               const int* __restrict__ bands, const float* __restrict__ weights,
               float* __restrict__ out, int stride, int n_frames, int n_mels,
               int band_w) {
  extern __shared__ __align__(16) double fsm64[];
  double* seg = fsm64;                                       // the block's samples as they lie
  float* pw = reinterpret_cast<float*>(fsm64 + F_SPAN);     // [FM][NFREQ] power spectrum
  const int tid = threadIdx.x, b = blockIdx.y, r0 = blockIdx.x * FM;
  {
    const float* row = wav + (size_t)b * stride;
    const int s0 = r0 * HOP;
    for (int c = tid; c < F_SPAN / 4; c += F_THREADS) {
      const int s = s0 + 4 * c;
      const float4 v = s < stride ? __ldg(reinterpret_cast<const float4*>(row + s))
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<double2*>(seg)[2 * c] = make_double2(v.x, v.y);
      reinterpret_cast<double2*>(seg)[2 * c + 1] = make_double2(v.z, v.w);
    }
  }
  __syncthreads();

  const int f = tid;
  if (f < NFREQ) {
    const float2* cs2 = reinterpret_cast<const float2*>(bases) + f;
    double re[FM], im[FM];
#pragma unroll
    for (int r = 0; r < FM; ++r) re[r] = im[r] = 0.0;
    for (int t = 0; t < NFFT; t += 4) {
      double c[4], s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 cs = __ldg(cs2 + (t + u) * (NCOL / 2));
        c[u] = cs.x;
        s[u] = cs.y;
      }
#pragma unroll
      for (int r = 0; r < FM; ++r) {
        const double2 x01 = *reinterpret_cast<const double2*>(seg + r * HOP + t);
        const double2 x23 = *reinterpret_cast<const double2*>(seg + r * HOP + t + 2);
        re[r] = fma(x01.x, c[0], re[r]);
        im[r] = fma(x01.x, s[0], im[r]);
        re[r] = fma(x01.y, c[1], re[r]);
        im[r] = fma(x01.y, s[1], im[r]);
        re[r] = fma(x23.x, c[2], re[r]);
        im[r] = fma(x23.x, s[2], im[r]);
        re[r] = fma(x23.y, c[3], re[r]);
        im[r] = fma(x23.y, s[3], im[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < FM; ++r) {
      const float a = __double2float_rn(re[r]), b = __double2float_rn(im[r]);
      pw[r * NFREQ + f] = a * a + b * b;
    }
  }
  __syncthreads();
  float* st = reinterpret_cast<float*>(seg);  // the samples are no longer needed
  mel_bands(pw, NFREQ, NFREQ, pw, NFREQ, st, FM, F_THREADS, bands, weights, n_mels,
            band_w);
  __syncthreads();
  store_rows(st, out, ((size_t)b * n_frames + r0) * n_mels, min(FM, n_frames - r0),
             n_mels);
}

}  // namespace

// At most 65535 clips go to one launch (the grid's y extent): a larger B is
// launched in slices of 65535 clips, each with its rows of wav and out.
constexpr int MAX_CLIPS = 65535;

// wav (B, stride) f32, the reflect-padded waveform (stride % 4 == 0, 16-byte
// aligned rows); bases: bf16 (416, 400) [column][tap] for the bf16 body, f32
// (400, 416) [tap][column] for the f32 body, columns 2f / 2f + 1 = cos / sin
// of bin f; bands (n_mels, 2) int32 (first bin, width); weights (n_mels,
// band_w) f32; out (B * n_frames, n_mels) f32. Requires n_mels <= 128 and
// band_w <= 201.
extern "C" int owc_mel_log10(const void* wav, const void* bases, const void* bands,
                             const void* weights, void* out, int B, int stride,
                             int n_frames, int n_mels, int band_w, int dtype,
                             void* stream) {
  if (n_mels < 1 || n_mels > MAX_MELS || band_w > NFREQ || stride % 4 != 0 || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bd = static_cast<const int*>(bands);
  const float* bw = static_cast<const float*>(weights);
  if (dtype == OWC_BF16) {
    cudaError_t e = cudaFuncSetAttribute(
        mel_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
  } else if (dtype == OWC_F32) {
    cudaError_t e = cudaFuncSetAttribute(
        mel_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  for (int b0 = 0; b0 < B; b0 += MAX_CLIPS) {
    const int nb = B - b0 < MAX_CLIPS ? B - b0 : MAX_CLIPS;
    const float* w = static_cast<const float*>(wav) + (size_t)b0 * stride;
    float* o = static_cast<float*>(out) + (size_t)b0 * n_frames * n_mels;
    if (dtype == OWC_BF16) {
      const dim3 grid((n_frames + BM - 1) / BM, nb);
      mel_bf16_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
          w, static_cast<const __nv_bfloat16*>(bases), bd, bw, o, stride, n_frames,
          n_mels, band_w);
    } else {
      const dim3 grid((n_frames + FM - 1) / FM, nb);
      mel_f32_kernel<<<grid, F_THREADS, F_SMEM_BYTES, st>>>(
          w, static_cast<const float*>(bases), bd, bw, o, stride, n_frames, n_mels,
          band_w);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
