// Shared pieces of the pairwise-kernel CUDA kernels (kernel_matvec.cu,
// kernel_block.cu, kernel_multi.cu): the kernel ids, the staging of A / B
// tiles into shared memory, the per-family base tile, the elementwise
// kernel maps and the bf16 round.
//
// Operands arrive as float or __nv_bfloat16 (T).  They are widened to f32
// when staged in shared memory (bf16 -> f32 is exact), so distances, norms
// and the kernel maps run in f32 for both precision policies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pk {

// Kernel ids: the order of KERNEL_NAMES in repro_torch/core/kernels.py.
enum KernelId {
  K_RBF = 0, K_LAPLACIAN = 1, K_MATERN52 = 2, K_LINEAR = 3,
  K_POLYNOMIAL = 4, K_SIGMOID = 5, K_COSINE = 6
};

// Base-tile families (KERNEL_FAMILIES in core/kernels.py).
enum Family { F_L2 = 0, F_L1 = 1, F_DOT = 2, F_COS = 3 };

__host__ __device__ constexpr int family_of(int kid) {
  return (kid == K_RBF || kid == K_MATERN52) ? F_L2
       : (kid == K_LAPLACIAN)                ? F_L1
       : (kid == K_COSINE)                   ? F_COS
                                             : F_DOT;
}

__host__ __device__ constexpr bool needs_norms(int fam) { return fam == F_L2 || fam == F_COS; }

// The tiling of kernel_block.cu (DC is also the column path's slab width,
// sweep_cols.cuh): a block of 256 threads owns TM rows of A
// and walks B in tiles of TN rows.  Thread (rg, lane) = (tid / LANES,
// tid % LANES) computes the RM consecutive rows rg*RM .. rg*RM+3 against
// the JN consecutive columns lane*JN .. lane*JN+3 of a tile.  The feature
// dimension d is walked in DC-wide slabs.  Tiles are staged TRANSPOSED
// (feature-major, s[k][row]) so a thread reads its 4 rows / 4 columns of a
// feature as one float4.
constexpr int THREADS = 256;
constexpr int LANES = 16;
constexpr int RM = 4;
constexpr int JN = 4;
constexpr int TM = (THREADS / LANES) * RM;  // 64 rows of A
constexpr int TN = LANES * JN;              // 64 rows of B per tile
constexpr int DC = 32;                      // feature slab width
constexpr int PB = TN * DC / THREADS;       // B values a thread prefetches per slab

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Stage rows [r0, r0 + TM) x features [k0, k0 + kc) of a row-major
// (nrows, d) matrix into s[k][row] as f32, zero-filling rows past nrows.
template <typename T>
__device__ __forceinline__ void stage_a(float (*s)[TM], const T* __restrict__ src, int64_t r0,
                                        int64_t nrows, int d, int k0, int kc) {
  for (int idx = threadIdx.x; idx < TM * kc; idx += THREADS) {
    const int r = idx % TM, k = idx / TM;
    const int64_t g = r0 + r;
    s[k][r] = g < nrows ? to_f32(src[g * d + k0 + k]) : 0.0f;
  }
}

// One B slab in flight: each thread loads its PB values of rows
// [j0, j0 + TN) x features [k0, k0 + kc) into registers (fetch_b), and
// later writes them to shared memory (commit_b), so the loads of the next
// slab overlap the arithmetic on the current one.
template <typename T>
__device__ __forceinline__ void fetch_b(float (&pb)[PB], const T* __restrict__ src, int64_t j0,
                                        int64_t nrows, int d, int k0, int kc) {
#pragma unroll
  for (int r = 0; r < PB; ++r) {
    const int idx = threadIdx.x + r * THREADS;
    const int j = idx % TN, k = idx / TN;
    const int64_t g = j0 + j;
    pb[r] = (k < kc && g < nrows) ? to_f32(src[g * d + k0 + k]) : 0.0f;
  }
}

__device__ __forceinline__ void commit_b(float (*s)[TN], const float (&pb)[PB], int kc) {
#pragma unroll
  for (int r = 0; r < PB; ++r) {
    const int idx = threadIdx.x + r * THREADS;
    const int k = idx / TN;
    if (k < kc) s[k][idx % TN] = pb[r];
  }
}

// Squared norms of rows [r0, r0 + TM) over all d features, from device
// memory, one thread per row (the A tile: once per block).
template <typename T>
__device__ __forceinline__ void a_sq_norms(float* out, const T* __restrict__ src, int64_t r0,
                                           int64_t nrows, int d) {
  for (int r = threadIdx.x; r < TM; r += THREADS) {
    float s = 0.0f;
    const int64_t g = r0 + r;
    if (g < nrows)
      for (int k = 0; k < d; ++k) {
        const float x = to_f32(src[g * d + k]);
        s = fmaf(x, x, s);
      }
    out[r] = s;
  }
}

// b2[j] (+)= sum over the staged slab of Bs[k][j]^2, one thread per column.
__device__ __forceinline__ void b_sq_norms(float* b2, const float (*Bs)[TN], int kc, bool first) {
  const int j = threadIdx.x;
  if (j < TN) {
    float s = first ? 0.0f : b2[j];
    for (int k = 0; k < kc; ++k) s = fmaf(Bs[k][j], Bs[k][j], s);
    b2[j] = s;
  }
}

// acc[i][j] += the family's slab contribution for rows rg*RM+i and columns
// lane*JN+j over the staged features [0, kc): two float4 shared loads per
// 16 fused multiply-adds (l1: subtract, abs, add).
template <int FAM>
__device__ __forceinline__ void accumulate_slab(float (&acc)[RM][JN], const float (*As)[TM],
                                                const float (*Bs)[TN], int rg, int lane,
                                                int kc) {
#pragma unroll 4
  for (int k = 0; k < kc; ++k) {
    const float4 a4 = *reinterpret_cast<const float4*>(&As[k][rg * RM]);
    const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][lane * JN]);
    const float a[RM] = {a4.x, a4.y, a4.z, a4.w};
    const float b[JN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        if (FAM == F_L1) acc[i][j] += fabsf(a[i] - b[j]);
        else acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
  }
}

// The family's base value from the accumulated slab sum and the squared
// norms: l2 clamps ||a||^2 + ||b||^2 - 2 a.b at 0; cos divides by the norms
// with a zero norm counted as 1; l1 and dot pass through.
template <int FAM>
__device__ __forceinline__ float base_value(float acc, float a2, float b2) {
  if (FAM == F_L2) return fmaxf(a2 + b2 - 2.0f * acc, 0.0f);
  if (FAM == F_COS) {
    const float an = sqrtf(a2), bn = sqrtf(b2);
    return acc / ((an == 0.0f ? 1.0f : an) * (bn == 0.0f ? 1.0f : bn));
  }
  return acc;
}

// Per-launch constants of the kernel maps: the divisions by sigma are done
// once per thread, not once per pair.
struct MapConst {
  float inv_s2, rbf_scale, lap_scale, sqrt5_inv_sigma, five_thirds_inv_s2;
};

// exp(x) is taken as exp2(x * log2(e)), the factor folded into the scales.
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ MapConst map_const(float sigma) {
  const float s2 = sigma * sigma;
  return {1.0f / s2, -kLog2e / (2.0f * s2), -kLog2e / sigma, 2.2360679774997896f / sigma,
          5.0f / (3.0f * s2)};
}

// 2^x by the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0, far under any tolerance of a kernel value).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Elementwise kernel maps, the formulas of core/kernels.py.
template <int KID>
__device__ __forceinline__ float kernel_map(float base, const MapConst& c) {
  if (KID == K_RBF) return ex2(base * c.rbf_scale);
  if (KID == K_LAPLACIAN) return ex2(base * c.lap_scale);
  if (KID == K_MATERN52) {
    const float s5 = c.sqrt5_inv_sigma * sqrtf(base + 1e-20f);
    return (1.0f + s5 + c.five_thirds_inv_s2 * base) * ex2(-kLog2e * s5);
  }
  if (KID == K_LINEAR) return base * c.inv_s2;
  if (KID == K_POLYNOMIAL) {
    const float u = fmaf(base, c.inv_s2, 1.0f);
    return u * u * u;
  }
  if (KID == K_SIGMOID) return tanhf(fmaf(base, c.inv_s2, 1.0f));
  return base;  // K_COSINE
}

// x rounded to the nearest bf16 (a bf16 matmul operand), back in f32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

}  // namespace pk

// Instantiate LAUNCH(T, KID) for a runtime kernel id; returns
// cudaErrorInvalidValue for an unknown id.
#define PK_DISPATCH_KERNEL(kid, LAUNCH, T)                     \
  switch (kid) {                                               \
    case pk::K_RBF: LAUNCH(T, pk::K_RBF); break;               \
    case pk::K_LAPLACIAN: LAUNCH(T, pk::K_LAPLACIAN); break;   \
    case pk::K_MATERN52: LAUNCH(T, pk::K_MATERN52); break;     \
    case pk::K_LINEAR: LAUNCH(T, pk::K_LINEAR); break;         \
    case pk::K_POLYNOMIAL: LAUNCH(T, pk::K_POLYNOMIAL); break; \
    case pk::K_SIGMOID: LAUNCH(T, pk::K_SIGMOID); break;       \
    case pk::K_COSINE: LAUNCH(T, pk::K_COSINE); break;         \
    default: return (int)cudaErrorInvalidValue;                \
  }
