// out = K(A, B) @ V without forming K: A (m, d), B (n, d), V (n, t) -> (m, t) f32.
//
// Replaces the TPU kernel src/repro/kernels/kernel_matvec.py:kernel_matvec_pallas
// (body _matvec_body), ASkotch's O(n b d) hot spot.  The TPU walked B and V
// along a sequential grid axis with the accumulator resident in VMEM; here
// that axis becomes a loop inside each block, since blocks run in parallel
// and nothing carries from one block to the next.
//
// Bound on the H100: operations.  At the main path's shape (m = 50,000,
// n = 10^6, d = 9, t = 1) the work is ~1.2e12 f32 operations plus 5e10 exp,
// while the bytes (B is 36 MB) are negligible.  The time is in issued
// instructions per pair, not in memory (PERF.md has the measurements).
//
// t == 1 (G_B, the residual pass, the prediction) runs on the t = 1 sweep of
// sweep_t1.cuh: B packed once a launch with its norms and v ([b, ||b||^2, v]
// rows, zero past n), staged by cp.async in 256-row tiles, the block's 64
// rows of A in registers (two a lane), each B row a broadcast read by a
// whole warp, whole row sums per thread added over the 8 warps in a fixed
// order.  A pair of rbf costs d FMAs (the dot product, started at
// -||a||^2 / 2), one FMA and one min for the scaled, clamped exponent (the
// pack stores rs ||b||^2, rs = -log2(e) / (2 sigma^2), so the exponent is
// rs ||b||^2 - 2 rs acc and exp(x) = ex2(x log2 e) costs nothing more), the
// ex2 (one special-function operation a pair) and one FMA with v.
//
// t > 1 runs on the first port's loop (kernel_matvec_kernel below):
//   * one block per 64-row tile of A and TC = 8 columns of V (grid.y), A
//     staged once; the block loops over all of B and V in 64-row tiles, d
//     walked in 32-wide slabs;
//   * the next slab of B (and V) is loaded into registers while the current
//     one is computed, then written to shared memory, feature-major, so
//     each thread reads its 4 rows and 4 columns of a feature as two float4
//     per 16 fused multiply-adds;
//   * each thread owns a 4 x 4 register tile of the distance and, for its 4
//     rows, TC output accumulators in registers;
//   * slab and tile counters are carried, not divided, and the map's
//     divisions are per-launch constants;
//   * the 16 threads sharing a row reduce their partial sums with a fixed
//     butterfly of warp shuffles at the end.
// Both are deterministic: no atomics.
// Known limit: a small m (a few prediction queries) gives fewer blocks than
// the 132 SMs; splitting n across blocks is later work.
//
// Precision: with bf16 operands the kernel value is rounded to bf16 before
// its product with V (the TPU kernel's bf16 matmul operand); the product of
// two bf16 values is exact in f32 and accumulates in f32.
#include "kernel_common.cuh"
#include "sweep_t1.cuh"

using namespace pk;

// t > 1: a block takes TC columns of V (grid.y chunks).
constexpr int TC = 8;

template <typename T, int KID>
__global__ void __launch_bounds__(THREADS, 1)
kernel_matvec_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ v,
                     float* __restrict__ out, int64_t m, int64_t n, int d, int t, float sigma) {
  constexpr int FAM = family_of(KID);
  constexpr bool NORMS = needs_norms(FAM);
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int PV = (TN * TC + THREADS - 1) / THREADS;
  __shared__ __align__(16) float As[DC][TM];
  __shared__ __align__(16) float Bs[DC][TN];
  __shared__ __align__(16) float Vs[TC][TN];
  __shared__ __align__(16) float a2[TM];
  __shared__ __align__(16) float b2[TN];
  const int rg = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int64_t r0 = (int64_t)blockIdx.x * TM;
  const int c0 = blockIdx.y * TC;
  const int tc = min(TC, t - c0);
  const MapConst mc = map_const(sigma);
  const int ns = (d + DC - 1) / DC;  // slabs per B tile
  const bool a_once = ns == 1;       // the whole A tile fits one slab: stage it once

  if (NORMS) a_sq_norms(a2, a, r0, m, d);
  if (a_once) stage_a(As, a, r0, m, d, 0, d);

  // the slab in flight: rows [f_j0, f_j0 + TN), features from f_slab * DC
  float pb[PB], pv[PV];
  int64_t f_j0 = 0;
  int f_slab = 0;
  auto fetch_next = [&]() {
    const int k0 = f_slab * DC;
    fetch_b(pb, b, f_j0, n, d, k0, min(DC, d - k0));
    if (f_slab == 0) fetch_v<T, TC, PV>(pv, v, f_j0, n, t, c0, tc);
    if (++f_slab == ns) {
      f_slab = 0;
      f_j0 += TN;
    }
  };
  if (n > 0) fetch_next();

  float o[RM][TC] = {};
  for (int64_t j0 = 0; j0 < n; j0 += TN) {
    float acc[RM][JN] = {};
    for (int slab = 0; slab < ns; ++slab) {
      const int k0 = slab * DC, kc = min(DC, d - k0);
      __syncthreads();  // readers of the previous slab / tile are done
      commit_b(Bs, pb, kc);
      if (slab == 0) commit_v<TC, PV>(Vs, pv);
      if (!a_once) stage_a(As, a, r0, m, d, k0, kc);
      __syncthreads();
      if (f_j0 < n) fetch_next();  // in flight during the arithmetic below
      if (NORMS) b_sq_norms(b2, Bs, kc, slab == 0);
      accumulate_slab<FAM>(acc, As, Bs, rg, lane, kc);
    }
    if (NORMS) __syncthreads();  // b2 complete

    const int cols = n - j0 < TN ? (int)(n - j0) : TN;  // live columns of this tile
    const float4 a24 = *reinterpret_cast<const float4*>(&a2[rg * RM]);
    const float4 b24 = *reinterpret_cast<const float4*>(&b2[lane * JN]);
    const float av[RM] = {a24.x, a24.y, a24.z, a24.w};
    const float bv[JN] = {b24.x, b24.y, b24.z, b24.w};
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        float kv;
        if (KID == K_RBF) {
          // exp(-max(a2 + b2 - 2 acc, 0) / (2 sigma^2)) with the scale folded
          // into the norms: one add, one fma, one min and the exponential
          kv = ex2(fminf(fmaf(acc[i][j], -2.0f * mc.rbf_scale,
                              mc.rbf_scale * av[i] + mc.rbf_scale * bv[j]), 0.0f));
        } else {
          kv = kernel_map<KID>(base_value<FAM>(acc[i][j], av[i], bv[j]), mc);
        }
        if (BF16) kv = round_bf16(kv);
        acc[i][j] = lane * JN + j < cols ? kv : 0.0f;
      }
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const float4 v4 = *reinterpret_cast<const float4*>(&Vs[c][lane * JN]);
#pragma unroll
      for (int i = 0; i < RM; ++i)
        o[i][c] = fmaf(acc[i][3], v4.w, fmaf(acc[i][2], v4.z,
                  fmaf(acc[i][1], v4.y, fmaf(acc[i][0], v4.x, o[i][c]))));
    }
  }

  reduce_lanes(o);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int64_t row = r0 + rg * RM + i;
      if (row < m)
        for (int c = 0; c < tc; ++c) out[row * t + c0 + c] = o[i][c];
    }
}

// Blocks an SM must hold: three (80 registers) for the register path at 9
// feature slots; two (128 registers) where the 16-wide A tile, the slab loop
// or cosine's divisions would spill at 80.
__host__ __device__ constexpr int t1_min_blocks(int kid, int nf, bool slab) {
  return nf == 9 && !slab && kid != K_COSINE ? 3 : 2;
}

// out (m) = K(A, B) @ v, t == 1, on the t = 1 sweep over the packed B (bp:
// P floats a row, n_pad rows).  One special-function operation a pair for
// rbf and laplacian, two for matern52 (sqrt.approx and ex2).
template <typename T, int KID, int NF, bool SLAB>
__global__ void __launch_bounds__(t1::THREADS, t1_min_blocks(KID, NF, SLAB))
kernel_matvec_t1_kernel(const T* __restrict__ a, const float* __restrict__ bp,
                        float* __restrict__ out, int64_t m, int64_t n_pad, int d, int P,
                        float sigma) {
  constexpr int FAM = family_of(KID);
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float t1_smem[];
  const MapConst mc = map_const(sigma);
  const float m2rs = -2.0f * mc.rbf_scale;
  float o[t1::R] = {};
  t1::sweep<NF, SLAB, FAM != F_L1, FAM == F_L1>(
      a, bp, m, d, P, 0, n_pad, FAM == F_L2, t1_smem,
      [&](float (&acc)[t1::R][t1::J], float (&acc1)[t1::R][t1::J], const float (&a2)[t1::R],
          const float (&b2)[t1::J], const float (&vv)[t1::J]) {
#pragma unroll
        for (int j = 0; j < t1::J; ++j) {
#pragma unroll
          for (int r = 0; r < t1::R; ++r) {
            float kv;
            if (KID == K_RBF) {
              // exp(-max(||a - b||^2, 0) / (2 sigma^2)) as ex2(rs ||a - b||^2),
              // rs = -log2(e) / (2 sigma^2) < 0: acc = a.b - a2 / 2 and the
              // packed norm is rs b2, so rs ||a - b||^2 = rs b2 - 2 rs acc
              kv = ex2(fminf(fmaf(acc[r][j], m2rs, b2[j]), 0.0f));
            } else {
              const float base = FAM == F_L2   ? fmaxf(fmaf(-2.0f, acc[r][j], b2[j]), 0.0f)
                               : FAM == F_L1   ? acc1[r][j]
                                               : base_value<FAM>(acc[r][j], a2[r], b2[j]);
              kv = t1::kernel_map_t1<KID>(base, mc);
            }
            if (BF16) kv = round_bf16(kv);
            o[r] = fmaf(kv, vv[j], o[r]);
          }
        }
      });
  t1::write_rows(o, t1_smem + t1::ring_floats(NF, SLAB), out, m, false);
}

template <typename T, int KID>
static cudaError_t launch_t1(const T* a, const T* b, const T* v, float* out, int64_t m, int64_t n,
                             int d, float sigma, float* scratch, cudaStream_t s) {
  // rbf reads its norms scaled by rs = -log2(e) / (2 sigma^2), as map_const
  const float s2 = sigma * sigma;
  const float norm_scale = KID == K_RBF ? -kLog2e / (2.0f * s2) : 1.0f;
  cudaError_t err = t1::launch_pack(b, v, scratch, n, d, norm_scale, s);
  if (err != cudaSuccess) return err;
  const t1::PackShape ps = t1::pack_shape(n, d);
  const unsigned blocks = (unsigned)((m + t1::TM - 1) / t1::TM);
#define PK_T1(NF, SLAB)                                                                      \
  err = t1::launch_sweep(kernel_matvec_t1_kernel<T, KID, NF, SLAB>, blocks,                  \
                         t1::smem_bytes(NF, SLAB), s, a, (const float*)scratch, out, m,      \
                         ps.rows, d, ps.stride, sigma)
  PK_T1_DISPATCH_NF(d, PK_T1)
#undef PK_T1
  return err;
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// bf16 != 0 reads A, B and V as __nv_bfloat16, else as float.  d, t >= 1.
// t == 1 needs `scratch`: sweep_t1_scratch_floats(n, d) floats of device
// memory (unused for t > 1).
extern "C" int kernel_matvec_launch(const void* a, const void* b, const void* v, void* out,
                                    long long m, long long n, int d, int t, float sigma,
                                    int kernel_id, int bf16, void* scratch, void* stream) {
  if (m < 0 || n < 0 || d < 1 || t < 1) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (t == 1) {
    cudaError_t err = cudaSuccess;
#define PK_LAUNCH(T, KID)                                                                  \
  err = launch_t1<T, KID>((const T*)a, (const T*)b, (const T*)v, (float*)out, m, n, d,     \
                          sigma, (float*)scratch, s)
    if (bf16) {
      PK_DISPATCH_KERNEL(kernel_id, PK_LAUNCH, __nv_bfloat16)
    } else {
      PK_DISPATCH_KERNEL(kernel_id, PK_LAUNCH, float)
    }
#undef PK_LAUNCH
    return (int)err;
  }
  const int gy = (t + TC - 1) / TC;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((m + TM - 1) / TM), (unsigned)gy);
#define PK_LAUNCH(T, KID)                                                                   \
  kernel_matvec_kernel<T, KID><<<grid, THREADS, 0, s>>>(                                    \
      (const T*)a, (const T*)b, (const T*)v, (float*)out, m, n, d, t, sigma)
  if (bf16) {
    PK_DISPATCH_KERNEL(kernel_id, PK_LAUNCH, __nv_bfloat16)
  } else {
    PK_DISPATCH_KERNEL(kernel_id, PK_LAUNCH, float)
  }
#undef PK_LAUNCH
  return (int)cudaGetLastError();
}
