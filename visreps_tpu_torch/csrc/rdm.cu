// Correlation RDM on Hopper (sm_90a): tiled Gram product with the RDM
// epilogue fused before the single store.
//
//   out[i, j] = 1 - clip((xc_i . xc_j / d) / (std_i * std_j + correction), -1, 1)
//   out[i, i] = 0
//
// Replaces the TPU kernel visreps_tpu/ops/rdm_pallas.py:29 `_rdm_kernel`
// (launched by pl.pallas_call at :96 inside compute_rdm_pallas). That
// kernel walks a sequential grid axis over d, accumulating one
// (256, 256) tile of x_i . x_j^T in an f32 VMEM scratch, and on the last
// step clamps, sets the diagonal and writes 1 - corr once; its rows are
// pre-scaled by 1/(std * sqrt(d)) outside the kernel because 1-D
// operands clash with Mosaic layouts. Here blocks run in parallel and in
// no order, so each block owns one TILE x TILE output tile and loops
// over d itself; `std` is an ordinary 1-D operand, so the epilogue is
// exactly compute_rdm's (ops/rdm.py) and the input is the centred rows.
//
// What bounds it: the function needs n (n + 1) d operations (the upper
// triangle and diagonal of a symmetric product) against n d + n^2 words
// moved, i.e. about (n + 1) d / (4 (n + d)) operations per byte of f32:
// 85 at the main path's smallest shape (n = 1000, d = 512) and ~250 at
// d >> n, far above the H100's ~20 f32 operations per byte of memory
// rate (67 TFLOP/s over 3.35 TB/s). The kernel is compute-bound at every
// main-path shape. This version computes both triangles (2 n^2 d
// operations), so it can reach at most half its bound.
// This first version uses f32 FMA on the CUDA cores (no TF32, matching
// the JAX package's Precision.HIGHEST Gram; bf16 operands are widened
// to f32 in shared memory). Its answer to the bound is register
// blocking: each thread keeps a 4 x 4 block of sums, so every 8 shared
// memory reads feed 16 FMAs, and the block's 64 x 16 operand slabs are
// staged once in shared memory for all 256 threads. The sums run in two
// levels (a partial over 256 of d, then a running total) so that f32
// rounding at d ~ 2e5 stays near 1e-6 of the result. Tensor cores
// (wgmma fed by TMA) are the next step, once PERF.md gives this
// version's time against its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TILE = 64;                 // output tile edge
constexpr int BK = 16;                   // depth of one shared-memory stage
constexpr int THREADS = 256;             // 16 x 16 threads, 4 x 4 outputs each
constexpr int STAGES_PER_PART = 16;      // partial sum spans 256 of d
constexpr int LOADS = TILE * BK / THREADS;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
rdm_tile_kernel(const T* __restrict__ xc, const float* __restrict__ stdv,
                float* __restrict__ out, int n, int d, float correction) {
  __shared__ float as[BK][TILE + 4];
  __shared__ float bs[BK][TILE + 4];

  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float total[4][4];
  float part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) total[i][j] = part[i][j] = 0.f;

  int stage = 0;
  for (int k0 = 0; k0 < d; k0 += BK) {
    // Stage the (TILE x BK) row slabs of both operands; 16 neighbouring
    // threads read 16 neighbouring columns of one row. Ragged edges of
    // n and d load zeros (masked, not padded in memory).
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int e = threadIdx.x + l * THREADS;
      const int r = e / BK;
      const int k = e % BK;
      const int gk = k0 + k;
      const int ga = row0 + r;
      const int gb = col0 + r;
      as[k][r] = (ga < n && gk < d) ? widen(xc[(size_t)ga * d + gk]) : 0.f;
      bs[k][r] = (gb < n && gk < d) ? widen(xc[(size_t)gb * d + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
    __syncthreads();
    if (++stage == STAGES_PER_PART) {
      stage = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          total[i][j] += part[i][j];
          part[i][j] = 0.f;
        }
    }
  }

  // Epilogue: compute_rdm's arithmetic, in its order, then one store.
  const float fd = (float)d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
    const float sr = stdv[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= n) continue;
      const float cov = (total[i][j] + part[i][j]) / fd;
      const float denom = __fadd_rn(__fmul_rn(sr, stdv[c]), correction);
      float corr = cov / denom;
      corr = corr < -1.f ? -1.f : (corr > 1.f ? 1.f : corr);  // keeps NaN
      if (r == c) corr = 1.f;
      out[(size_t)r * n + c] = 1.f - corr;
    }
  }
}

template <typename T>
int launch(const void* xc, const void* stdv, void* out, int n, int d,
           float correction, void* stream) {
  const int tiles = (n + TILE - 1) / TILE;
  dim3 grid(tiles, tiles);
  rdm_tile_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xc), static_cast<const float*>(stdv),
      static_cast<float*>(out), n, d, correction);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// xc: (n, d) row-major f32; stdv: (n,) f32; out: (n, n) f32. Launches on
// `stream` without synchronising; returns cudaGetLastError() (0 = ok).
int rdm_f32(const void* xc, const void* stdv, void* out, int n, int d,
            float correction, void* stream) {
  return launch<float>(xc, stdv, out, n, d, correction, stream);
}

// Same, with (n, d) bf16 rows widened to f32 before the f32 accumulation.
int rdm_bf16(const void* xc, const void* stdv, void* out, int n, int d,
             float correction, void* stream) {
  return launch<__nv_bfloat16>(xc, stdv, out, n, d, correction, stream);
}

}  // extern "C"
