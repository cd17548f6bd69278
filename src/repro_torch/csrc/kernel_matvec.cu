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
// t > 8 (pcg-nystrom's and the single-kernel tune's sketches K Omega, the
// tune's CG apply over its lam x fold columns, a one-vs-all G_B, residual
// pass and prediction with t heads, Falkon's and EigenPro's multi-head
// sweeps) runs on the column path of sweep_cols.cuh, shared with the
// weighted and stacked matvecs, with one kernel fixed at compile time
// (kernel_matvec_cols_kernel): no table, no weight rows, one 16 x 32 kernel
// tile a B tile.  Each pair's kernel value is formed once per 16-row B tile
// for all of the block's columns (up to 160; a wider t is split evenly over
// column blocks), then every thread streams its 8 rows x CO columns of the
// output through it: per B row two float4 of K, the V row and 8 CO FMAs,
// the loop unrolled over 16 / CO B rows (two at CO >= 8).  The width
// follows t: CO is 2, 4, 8 or 10 (16 CO columns a block), the smallest that
// holds the block's columns.  For rbf the scale is folded into the norms as
// on the t = 1 sweep: a pair's map is one add, one FMA, one min and the
// ex2.  Bound: the t FMAs a pair at the FP32 rate (100 at the sketch's
// rank 100), above the ~2d + 6 operations of the distance and the map.
//
// 2 <= t <= 8 runs on the first port's loop (kernel_matvec_kernel), one
// chunk of TC = 8 columns: a block per 64-row tile of A walks all of B and
// V in 64-row tiles, d in 32-wide slabs loaded into registers a slab ahead
// and staged feature-major, each thread a 4 x 4 register tile of the
// distance and 4 rows x 8 output sums, the 16 threads of a row reduced by a
// fixed butterfly of shuffles.  Below 9 columns the column path's work per
// 16-row B tile that does not scale with the columns (the copies of B and
// V, three barriers, the d loop and the maps for a 32-row block) costs more
// than the 8-column loop: at the solve's G_B shape (50,000 x 10^6, rbf) the
// loop takes ~135 ms up to t = 8 and ~270 ms from 9 to 16, the column path
// ~235 ms at t = 8 and 16 (PERF.md).
// The wrapper pads V with zero columns to a multiple of 4 at t > 1, so its
// rows are copied in 16-byte units.
// A small m at t = 1 (a serving bucket of 8 to 4096 queries) splits n
// across grid.y (sweep_t1.cuh): S ranges of B, an (S, m) partials buffer,
// and a small kernel that adds each row's S partials in order.  At t > 1 a
// small m still gives fewer blocks than the 132 SMs.
//
// Precision: with bf16 operands the kernel value is rounded to bf16 before
// its product with V (the TPU kernel's bf16 matmul operand); the product of
// two bf16 values is exact in f32 and accumulates in f32.  At t > 1 the
// wrapper passes the bf16-rounded operands widened to f32 (exact).
//
// Deterministic: no atomics; the t = 1 sweep adds its warps' row sums in
// warp order, the loop reduces a row's 16 partial sums by a fixed
// butterfly, and on the column path a thread owns whole output values.
#include "kernel_common.cuh"
#include "sweep_cols.cuh"
#include "sweep_t1.cuh"

using namespace pk;

// 2 <= t <= TC: the first port's loop, a block per 64-row tile of A for all
// of V's columns (A, B and V f32; BF16: holding bf16-rounded values, and
// each K value is rounded to bf16 before its product with V).
constexpr int TC = 8;

template <bool BF16, int KID>
__global__ void __launch_bounds__(THREADS, 1)
kernel_matvec_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ v, float* __restrict__ out, int64_t m, int64_t n,
                     int d, int t, float sigma) {
  constexpr int FAM = family_of(KID);
  constexpr bool NORMS = needs_norms(FAM);
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
    if (f_slab == 0) fetch_v<float, TC, PV>(pv, v, f_j0, n, t, c0, tc);
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
// P floats a row, n_pad rows), block (x, y) over rows [y span, +span) of it
// (one range: span = n_pad; split: `out` is the (S, m) partials).  One
// special-function operation a pair for rbf and laplacian, two for
// matern52 (sqrt.approx and ex2).
template <typename T, int KID, int NF, bool SLAB>
__global__ void __launch_bounds__(t1::THREADS, t1_min_blocks(KID, NF, SLAB))
kernel_matvec_t1_kernel(const T* __restrict__ a, const float* __restrict__ bp,
                        float* __restrict__ out, int64_t m, int64_t n_pad, int64_t span, int d,
                        int P, float sigma) {
  constexpr int FAM = family_of(KID);
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float t1_smem[];
  const MapConst mc = map_const(sigma);
  const float m2rs = -2.0f * mc.rbf_scale;
  float o[t1::R] = {};
  t1::sweep<NF, SLAB, FAM != F_L1, FAM == F_L1>(
      a, bp, m, d, P, t1::range_begin(span), t1::range_end(span, n_pad), FAM == F_L2, t1_smem,
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
  const t1::Split sp = t1::split_of(m, n, d);
  float* part = scratch + t1::pack_floats(n, d);  // the (S, m) partials of a split
  float* dst = sp.s > 1 ? part : out;
#define PK_T1(NF, SLAB)                                                                      \
  err = t1::launch_sweep(kernel_matvec_t1_kernel<T, KID, NF, SLAB>, t1::sweep_grid(m, sp),   \
                         t1::smem_bytes(NF, SLAB), s, a, (const float*)scratch, dst, m,      \
                         ps.rows, sp.span, d, ps.stride, sigma)
  PK_T1_DISPATCH_NF(d, PK_T1)
#undef PK_T1
  if (err != cudaSuccess || sp.s == 1) return err;
  return t1::launch_reduce(part, out, m, sp.s, false, s);
}

// The kernel set of kernel_matvec's column path: kernel KID alone,
// unweighted, its map constants in registers, the FMA loop unrolled over
// JU_ B rows.  rbf keeps its norms scaled by rs = -log2(e) / (2 sigma^2) <
// 0, so its value is ex2(min(rs a2 + rs b2 - 2 rs a.b, 0)); the dot family
// keeps no norms.
template <int KID, int JU_>
struct OneKernel {
  using Tab = cols::NoTable;
  static constexpr bool WEIGHTED = false;
  static constexpr bool NORMS = needs_norms(family_of(KID));
  static constexpr int JU = JU_;
  MapConst mc;
  __device__ __forceinline__ static constexpr int q() { return 1; }
  __device__ __forceinline__ void load(Tab&) const {}
  __device__ __forceinline__ float weight(const Tab&, int, int, int, int) const { return 0.0f; }
  __device__ __forceinline__ float norm(float s) const {
    return KID == K_RBF ? mc.rbf_scale * s : s;
  }
  __device__ __forceinline__ void map(const Tab&, int, float (&kv)[4][1],
                                      const float (&ac)[4][1], const float (&ac1)[4][1],
                                      const float (&av)[4], const float (&bv)[1]) const {
    constexpr int FAM = family_of(KID);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      kv[i][0] = KID == K_RBF
                     ? ex2(fminf(fmaf(ac[i][0], -2.0f * mc.rbf_scale, av[i] + bv[0]), 0.0f))
                     : kernel_map<KID>(
                           base_value<FAM>(FAM == F_L1 ? ac1[i][0] : ac[i][0], av[i], bv[0]), mc);
  }
};

// out (m, t) = K(A, B) @ V, t > 1, on the column path: grid.y block y owns
// columns [y cw, min((y + 1) cw, t)), cw <= 16 CO.  A, B and V are f32 (for
// BF16, holding bf16-rounded values; each K value is rounded to bf16 before
// its product with V).
template <bool BF16, int KID, int CO>
__global__ void __launch_bounds__(cols::CTHREADS, 6)
kernel_matvec_cols_kernel(const float* __restrict__ a, const float* __restrict__ b,
                          const float* __restrict__ v, float* __restrict__ out, int64_t m,
                          int64_t n, int d, int t, int cw, float sigma, bool v16) {
  constexpr int FAM = family_of(KID);
  // the FMA loop's 8 CO FMAs a B row, unrolled to 32 or more a step
  constexpr int JU = CO <= 4 ? 16 / CO : 2;
  cols::body<BF16, FAM != F_L1, FAM == F_L1, CO>(a, b, v, out, m, n, d, t, cw,
                                                 OneKernel<KID, JU>{map_const(sigma)}, v16, false);
}

template <bool BF16, int KID>
static cudaError_t launch_cols(const float* a, const float* b, const float* v, float* out,
                               int64_t m, int64_t n, int d, int t, float sigma, cudaStream_t s) {
  const cols::Split sp = cols::col_split(t, true);
  if (sp.gy > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((m + cols::CM - 1) / cols::CM), (unsigned)sp.gy);
  const bool v16 = t % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  // one kernel tile: under the 48 KB a block gets by default
#define PK_COLS(CO)                                                                        \
  kernel_matvec_cols_kernel<BF16, KID, CO>                                                 \
      <<<grid, cols::CTHREADS, cols::smem_bytes<cols::CCG * CO, cols::NoTable>(1), s>>>(   \
          a, b, v, out, m, n, d, t, sp.cw, sigma, v16)
  switch (sp.co) {
    case cols::CO_TWO: PK_COLS(cols::CO_TWO); break;
    case cols::CO_FOUR: PK_COLS(cols::CO_FOUR); break;
    case cols::CO_MID: PK_COLS(cols::CO_MID); break;
    default: PK_COLS(cols::CO_WIDE); break;
  }
#undef PK_COLS
  return cudaGetLastError();
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// d, t >= 1.  t == 1: bf16 != 0 reads A, B and V as __nv_bfloat16, else as
// float, and needs `scratch`: sweep_t1_scratch_floats(m, n, d) floats of
// device memory.  t > 1: A, B and V are float (bf16 != 0: holding
// bf16-rounded values, and K is rounded to bf16 before its product with V);
// `scratch` is unused.
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
  if (t <= TC) {  // one 8-column chunk: faster than a column block up to 8 columns
    const dim3 grid((unsigned)((m + TM - 1) / TM));
#define PK_LAUNCH(BF, KID)                                                                  \
  kernel_matvec_kernel<BF, KID><<<grid, THREADS, 0, s>>>(                                   \
      (const float*)a, (const float*)b, (const float*)v, (float*)out, m, n, d, t, sigma)
    if (bf16) {
      PK_DISPATCH_KERNEL(kernel_id, PK_LAUNCH, true)
    } else {
      PK_DISPATCH_KERNEL(kernel_id, PK_LAUNCH, false)
    }
#undef PK_LAUNCH
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaSuccess;
#define PK_LAUNCH(BF, KID)                                                                  \
  err = launch_cols<BF, KID>((const float*)a, (const float*)b, (const float*)v, (float*)out, \
                             m, n, d, t, sigma, s)
  if (bf16) {
    PK_DISPATCH_KERNEL(kernel_id, PK_LAUNCH, true)
  } else {
    PK_DISPATCH_KERNEL(kernel_id, PK_LAUNCH, false)
  }
#undef PK_LAUNCH
  return (int)err;
}
