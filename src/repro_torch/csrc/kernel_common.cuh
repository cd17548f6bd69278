// Shared pieces of the pairwise-kernel CUDA kernels (kernel_matvec.cu,
// kernel_block.cu, kernel_multi.cu): the kernel ids, the widening of an
// operand to f32, the per-family base value, the elementwise kernel maps
// and the bf16 round.
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

// The feature slab width of the column path (sweep_cols.cuh).
constexpr int DC = 32;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
