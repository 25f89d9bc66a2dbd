// Correlation RDM on Hopper (sm_90a): a tensor-core Gram product over the
// upper-triangle tiles of a symmetric matrix, with the RDM epilogue fused.
//
//   out[i, j] = 1 - clip((xc_i . xc_j / d) / (std_i * std_j + correction), -1, 1)
//   out[i, i] = 0
//
// Replaces the TPU kernel visreps_tpu/ops/rdm_pallas.py:29 `_rdm_kernel`
// (launched by pl.pallas_call at :96 inside compute_rdm_pallas), which
// walks a sequential grid axis over d into an f32 VMEM tile and writes
// 1 - corr on the last step. Here `std` is an ordinary operand, so the
// epilogue is exactly compute_rdm's (ops/rdm.py) on the centred rows.
//
// What bounds it: the function needs n (n + 1) d operations against
// n d + n^2 words moved, >= 85 operations per byte at every main-path
// shape (n = 1000, d >= 512), so it is operations-bound. Routes:
//  - bf16 rows go straight to wgmma .bf16 with f32 accumulation (bf16 x
//    bf16 products are exact in f32, as in the plain version's widening).
//  - f32 rows run as three TF32 products (3xTF32): each element of a
//    landed stage is split in shared memory, in place, into
//    hi = tf32(x) and lo = tf32(x - hi), and lo.hi' + hi.lo' + hi.hi' is
//    accumulated. One TF32 product keeps ~3 digits; the split keeps f32's
//    (the JAX Gram is Precision.HIGHEST) for three times the tensor-core
//    work, so the f32 bound is 3 n (n + 1) d over the TF32 peak.
// Against that bound: a producer warp keeps a ring of 128-byte-wide
// (128-row) TMA tiles with 128B swizzle in flight on mbarriers while two
// consumer warpgroups each run wgmma m64n128 on one half of a 128 x 128
// output tile; the f32 split of stage k+1 overlaps the wgmma of stage k.
// Only tiles with tile_row <= tile_col run (a diagonal tile loads one row
// block as both operands); the epilogue stages the finished tile in shared
// memory and stores it and its mirror with coalesced writes, so `out` is
// exactly symmetric with a zero diagonal.
// Where the upper tiles cannot fill the card's SMs (132 on an H100 SXM;
// n = 1000: 36 tiles), d is
// split (the plan, chosen in ops/rdm_kernel.py, spans >= 512 of d per
// split); partial Grams go to an f32 workspace and a second kernel sums
// them in a fixed order (bit-reproducible) and applies the epilogue.
// The tensor core's accumulator spans at most 512 of d; it is then added
// into an f32 register total, so rounding at d ~ 2e5 stays near 1e-6.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;                      // output tile edge (rows of one TMA box)
constexpr int ROW_BYTES = 128;                 // one stage: 128 bytes of d per row
constexpr int BOX_BYTES = TILE * ROW_BYTES;    // 16 KB per operand per stage
constexpr int CONSUMERS = 256;                 // two warpgroups, 64 output rows each
constexpr int THREADS = CONSUMERS + 32;        // + one producer warp
constexpr int PART_DEPTH = 512;                // d spanned by one tensor-core accumulator
constexpr int MAX_SPLITS = 16;

struct StageBounds {
  int k[MAX_SPLITS + 1];  // split s covers stages [k[s], k[s + 1])
};

template <typename T> struct Route;
template <> struct Route<float> {  // 3xTF32: x, then hi/lo halves per stage
  static constexpr int STAGES = 3, BUFS = 4;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <> struct Route<__nv_bfloat16> {
  static constexpr int STAGES = 5, BUFS = 2;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

template <typename T>
constexpr int smem_bytes() {
  return Route<T>::STAGES * Route<T>::BUFS * BOX_BYTES + 1024 /* align */ + 256 /* mbarriers */;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
        "r"(col), "r"(row) : "memory");
}

// K-major operand with 128B swizzle: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  return (static_cast<uint64_t>(smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

#define WG_REGS                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "  \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
              "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_ACC F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)

// d (64 x 128, f32, this warpgroup's rows) += A (64 x 8) . B (128 x 8)^T, TF32.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_REGS
      ", %64, %65, p, 1, 1; }"
      : WG_ACC : "l"(a), "l"(b), "r"(1));
}

// d += A (64 x 16) . B (128 x 16)^T, bf16 operands, f32 accumulation.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS
      ", %64, %65, p, 1, 1, 0, 0; }"
      : WG_ACC : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

__device__ __forceinline__ float tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// Split one landed (128 x 32) f32 box in place into hi, with lo beside it.
// Elementwise over 16-byte chunks, so both halves keep TMA's swizzle.
__device__ __forceinline__ void split_box(float4* x, float4* lo, int tid) {
#pragma unroll
  for (int j = 0; j < BOX_BYTES / 16 / CONSUMERS; ++j) {
    const int i = tid + j * CONSUMERS;
    const float4 v = x[i];
    float4 h, l;
    h.x = tf32(v.x); l.x = tf32(v.x - h.x);
    h.y = tf32(v.y); l.y = tf32(v.y - h.y);
    h.z = tf32(v.z); l.z = tf32(v.z - h.z);
    h.w = tf32(v.w); l.w = tf32(v.w - h.w);
    x[i] = h;
    lo[i] = l;
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ float rdm_value(float gram, float sr, float sc, float fd,
                                           float correction, bool diag) {
  const float cov = gram / fd;
  const float denom = __fadd_rn(__fmul_rn(sr, sc), correction);
  float corr = cov / denom;
  corr = corr < -1.f ? -1.f : (corr > 1.f ? 1.f : corr);  // keeps NaN
  if (diag) corr = 1.f;
  return 1.f - corr;
}

// One block per (upper tile, split of d). ws == nullptr: one split, the
// epilogue writes out; else the split's partial Gram goes to ws[split].
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
rdm_gram_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ stdv,
                float* __restrict__ out, float* __restrict__ ws, int n, int d, int n_pad,
                float correction, const __grid_constant__ StageBounds bounds) {
  using R = Route<T>;
  constexpr bool SPLIT = R::BUFS == 4;
  constexpr int STAGE_D = ROW_BYTES / sizeof(T);
  constexpr int FLUSH = PART_DEPTH / STAGE_D;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::STAGES * R::BUFS * BOX_BYTES);
  uint64_t* empty = full + R::STAGES;

  // Upper tile (tr <= tc) of this block, row-major over the triangle.
  const int tiles = (n + TILE - 1) / TILE;
  int t = blockIdx.x, tr = 0;
  while (t >= tiles - tr) t -= tiles - tr++;
  const int tc = tr + t;
  const bool diag = tr == tc;
  const int split = blockIdx.y;
  const int k0 = bounds.k[split];
  const int nst = bounds.k[split + 1] - k0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Stage s holds A, B (and for f32 their lo halves) at BOX_BYTES apart.
  auto buf = [&](int s, int which) { return smem + (s * R::BUFS + which) * BOX_BYTES; };

  if (threadIdx.x >= CONSUMERS) {  // producer warp: one lane issues TMA
    if (threadIdx.x == CONSUMERS) {
      for (int it = 0; it < nst; ++it) {
        const int s = it % R::STAGES, round = it / R::STAGES;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        mbar_expect_tx(&full[s], (diag ? 1 : 2) * BOX_BYTES);
        const int col = (k0 + it) * STAGE_D;
        tma_load(buf(s, 0), &map, &full[s], col, tr * TILE);
        if (!diag) tma_load(buf(s, 1), &map, &full[s], col, tc * TILE);
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  float acc[64], total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = total[i] = 0.f;

  auto split_stage = [&](int s) {
    split_box(reinterpret_cast<float4*>(buf(s, 0)), reinterpret_cast<float4*>(buf(s, 2)), tid);
    if (!diag)
      split_box(reinterpret_cast<float4*>(buf(s, 1)), reinterpret_cast<float4*>(buf(s, 3)), tid);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // generic stores -> wgmma
  };

  if constexpr (SPLIT) {
    mbar_wait(&full[0], 0);
    split_stage(0);
    consumers_sync();
  }
  int since = 0;
  for (int it = 0; it < nst; ++it) {
    const int s = it % R::STAGES;
    if constexpr (!SPLIT) mbar_wait(&full[s], (it / R::STAGES) & 1);
    const uint8_t* a = buf(s, 0) + wg * 64 * ROW_BYTES;
    const uint8_t* b = buf(s, diag ? 0 : 1);
    wgmma_fence();
    if constexpr (SPLIT) {
      const uint8_t* a_lo = buf(s, 2) + wg * 64 * ROW_BYTES;
      const uint8_t* b_lo = buf(s, diag ? 2 : 3);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 4 x k8 = 32 of d; small terms first
        wgmma_tf32(acc, wgmma_desc(a_lo) + 2 * kk, wgmma_desc(b) + 2 * kk);
        wgmma_tf32(acc, wgmma_desc(a) + 2 * kk, wgmma_desc(b_lo) + 2 * kk);
        wgmma_tf32(acc, wgmma_desc(a) + 2 * kk, wgmma_desc(b) + 2 * kk);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 4 x k16 = 64 of d
        wgmma_bf16(acc, wgmma_desc(a) + 2 * kk, wgmma_desc(b) + 2 * kk);
    }
    wgmma_commit();
    if (SPLIT && it + 1 < nst) {  // split the next stage while this one multiplies
      const int s1 = (it + 1) % R::STAGES;
      mbar_wait(&full[s1], ((it + 1) / R::STAGES) & 1);
      split_stage(s1);
    }
    wgmma_wait();
    if (++since == FLUSH) {
      since = 0;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        total[i] += acc[i];
        acc[i] = 0.f;
      }
    }
    mbar_arrive(&empty[s]);
    if (SPLIT && it + 1 < nst) consumers_sync();
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] += acc[i];

  // Accumulator layout of m64nN: d[i] sits at row 16 warp + lane / 4 + 8 ((i / 2) % 2),
  // column 8 (i / 4) + 2 (lane % 4) + i % 2 of this warpgroup's 64 x 128 block.
  const int lane = tid % 32;
  const int a0 = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;  // row in the tile
  const int r0 = tr * TILE + a0;
  const int c0 = tc * TILE + 2 * (lane % 4);
  if (ws == nullptr) {
    // Stage the finished tile in the drained ring (row pitch TILE + 1, so a
    // warp reading a column hits 32 banks), then store it row by row and its
    // mirror row by row of the transpose: both stores coalesced.
    constexpr int PITCH = TILE + 1;
    float* tile = reinterpret_cast<float*>(smem);
    const float fd = static_cast<float>(d);
    consumers_sync();  // both warpgroups are done with the ring
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int a = a0 + 8 * ((i >> 1) & 1), b = 2 * (lane % 4) + 8 * (i >> 2) + (i & 1);
      const int r = tr * TILE + a, c = tc * TILE + b;
      if (r < n && c < n)
        tile[a * PITCH + b] = rdm_value(total[i], stdv[r], stdv[c], fd, correction, r == c);
    }
    consumers_sync();
    for (int k = tid; k < TILE * TILE; k += CONSUMERS) {
      const int a = k / TILE, b = k % TILE;
      const int r = tr * TILE + a, c = tc * TILE + b;  // (r, c) of the upper triangle
      if (r < n && c < n && r <= c) out[(size_t)r * n + c] = tile[a * PITCH + b];
      const int rm = tc * TILE + a, cm = tr * TILE + b;  // its mirror (rm, cm), cm < rm
      if (rm < n && cm < rm) out[(size_t)rm * n + cm] = tile[b * PITCH + a];
    }
  } else {
    float* part = ws + (size_t)split * n_pad * n_pad;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = r0 + 8 * ((i >> 1) & 1);
      const int c = c0 + 8 * (i >> 2);
      *reinterpret_cast<float2*>(part + (size_t)r * n_pad + c) = make_float2(total[i], total[i + 1]);
    }
  }
}

// Sums the splits' partial Grams in split order (no atomics: bit-identical
// from run to run), applies the epilogue on i <= j, and writes each value
// and its mirror; the transpose goes through shared memory so that both
// stores are coalesced. One block per 32 x 32 block of the upper triangle.
__global__ void __launch_bounds__(256)
rdm_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ stdv,
                  float* __restrict__ out, int n, int d, int n_pad, int splits,
                  float correction) {
  __shared__ float t[32][33];
  const int bx = blockIdx.x, by = blockIdx.y;
  if (by > bx) return;
  const float fd = static_cast<float>(d);
  const size_t plane = (size_t)n_pad * n_pad;
  const int c = bx * 32 + threadIdx.x;
  for (int rr = threadIdx.y; rr < 32; rr += 8) {
    const int r = by * 32 + rr;
    float v = 0.f;
    if (r < n && c < n && r <= c) {
      float g = 0.f;
      for (int s = 0; s < splits; ++s) g += ws[s * plane + (size_t)r * n_pad + c];
      v = rdm_value(g, stdv[r], stdv[c], fd, correction, r == c);
      out[(size_t)r * n + c] = v;
    }
    t[rr][threadIdx.x] = v;
  }
  __syncthreads();
  const int c2 = by * 32 + threadIdx.x;
  for (int rr = threadIdx.y; rr < 32; rr += 8) {
    const int r2 = bx * 32 + rr;
    if (r2 < n && c2 < n && c2 < r2) out[(size_t)r2 * n + c2] = t[threadIdx.x][rr];
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded: no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Error codes beside cudaError_t's (all positive): the driver entry point
// is missing, the tensor map was refused, or the plan is out of range.
constexpr int ERR_NO_ENCODE = -1, ERR_TENSOR_MAP = -2, ERR_PLAN = -3;

template <typename T>
int launch(const void* xc, const void* stdv, void* out, void* ws, int n, int d, int ld,
           float correction, int splits, const int* stage_bounds, void* stream) {
  if (splits < 1 || splits > MAX_SPLITS || (splits > 1) != (ws != nullptr)) return ERR_PLAN;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODE;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(T)};
  const cuuint32_t box[2] = {ROW_BYTES / sizeof(T), TILE};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, Route<T>::TMA_TYPE, 2, const_cast<void*>(xc), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)  // out of bounds reads 0
    return ERR_TENSOR_MAP;
  StageBounds b;
  for (int s = 0; s <= splits; ++s) b.k[s] = stage_bounds[s];
  static unsigned configured = 0;  // devices that allow this kernel its shared memory
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < 32 && !(configured >> dev & 1u)) {
    err = cudaFuncSetAttribute(rdm_gram_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<T>());
    if (err == cudaSuccess) configured |= 1u << dev;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + TILE - 1) / TILE;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  rdm_gram_kernel<T><<<dim3(tiles * (tiles + 1) / 2, splits), THREADS, smem_bytes<T>(), st>>>(
      map, static_cast<const float*>(stdv), static_cast<float*>(out), static_cast<float*>(ws),
      n, d, tiles * TILE, correction, b);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int blocks = (n + 31) / 32;
  rdm_reduce_kernel<<<dim3(blocks, blocks), dim3(32, 8), 0, st>>>(
      static_cast<const float*>(ws), static_cast<const float*>(stdv), static_cast<float*>(out),
      n, d, tiles * TILE, splits, correction);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// xc: (n, d) f32 rows, `ld` elements apart (ld * 4 and the base 16-byte
// aligned); stdv: (n,) f32; out: (n, n) f32; ws: (splits, n_pad, n_pad)
// f32 with n_pad = 128 ceil(n / 128), or null when splits == 1;
// stage_bounds: host array of splits + 1 stage indices (32 of d each).
// Launches on `stream` without synchronising; returns 0, a cudaError_t
// from cudaGetLastError() after each launch, or a negative code above.
int rdm_f32(const void* xc, const void* stdv, void* out, void* ws, int n, int d, int ld,
            float correction, int splits, const int* stage_bounds, void* stream) {
  return launch<float>(xc, stdv, out, ws, n, d, ld, correction, splits, stage_bounds, stream);
}

// Same for bf16 rows (ld * 2 16-byte aligned; stages span 64 of d).
int rdm_bf16(const void* xc, const void* stdv, void* out, void* ws, int n, int d, int ld,
             float correction, int splits, const int* stage_bounds, void* stream) {
  return launch<__nv_bfloat16>(xc, stdv, out, ws, n, d, ld, correction, splits,
                               stage_bounds, stream);
}

}  // extern "C"
