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
// Three routes, chosen by t (and, at t = 1 and 2 <= t <= 32, a split of n
// up to 4096 rows of A):
//
// t == 1 (G_B, the residual pass, the prediction, a single-head serving
// bucket) runs on the t = 1 sweep of sweep_t1.cuh: B packed once a launch
// with its norms and v ([b, ||b||^2, v] rows, zero past n), staged by
// cp.async in 256-row tiles, the block's 64 rows of A in registers (two a
// lane), each B row a broadcast read by a whole warp, whole row sums per
// thread added over the 8 warps in a fixed order.  A pair of rbf costs d
// FMAs (the dot product, started at -||a||^2 / 2), one FMA and one min for
// the scaled, clamped exponent (the pack stores rs ||b||^2, rs = -log2(e) /
// (2 sigma^2), so the exponent is rs ||b||^2 - 2 rs acc and exp(x) =
// ex2(x log2 e) costs nothing more), the ex2 (one special-function
// operation a pair) and one FMA with v.
//
// 2 <= t <= 32 (one-vs-all with up to 32 classes: its G_B, residual pass
// and prediction; the single-kernel tune's CG over its 4 lams x 5 folds;
// Falkon's and EigenPro's sweeps with t heads; a t-head serving bucket; the
// distributed primitives at t = 8) runs on the same sweep at W value
// columns (kernel_matvec_tk_kernel, W = t1::width_of(t): 2, 4, 8, 12, 16,
// 20, 24 or 32): the pack writes [b, ||b||^2, v_0 .. v_{W-1}] rows (V's
// columns past t zero), each pair's kernel value is formed once as at
// t = 1 and used in W FMAs into the thread's 2 x W row sums, and a B row's
// W values are W / 4 broadcast float4 loads from the staged tile, shared by
// the lane's two rows.  What bounds it is still the instructions a pair:
// at d = 9 the t = 1 sweep's ~13 plus W - 1 FMAs and the value loads, so
// the time grows with W, not with t.  Up to 4096 rows of A it splits B over
// grid.y exactly as at t = 1 (split_of: S from n and the feature route,
// never from m or t), writes (S, m, t) partials after the packed B, and
// reduce_splits adds each value's S partials in split order, so a row's
// result is bitwise the same whatever rows travel with it.  It replaced
// the first port's 8-column loop at t <= 8 and the column path at
// 9 <= t <= 16.  Measured in one run (tools/time_torch_kernels.py on the
// code before and after the change; H100 80GB HBM3 at 700 W; rbf, d = 9,
// f32) at the one-vs-all G_B, 50,000 x 10^6: the sweep 34.0, 38.5, 51.1, 61.1
// and 68.8 ms at t = 2, 4, 8, 10 and 16; the loop 135.6, 135.5 and 139.9
// ms at t = 2, 4 and 8; the column path 236.1 ms at t = 10 and 233.8 at
// 16 (234.4 at 20).  So the sweep wins above 4096 rows too and takes
// 2 <= t <= 16 at every m.  A 64-query bucket at t = 10: 0.33 ms (the
// column path: 59.0 ms, 2 of the 132 SMs busy, no split).  Its inner loop
// (tools/sass_torch_loops.py, a group of 16 pairs): 374 instructions at
// W = 8 (288 FFMA, 48 LDS, 16 MUFU), 446 at W = 12, 522 at W = 16, against
// the t = 1 sweep's 239 (176 FFMA, 24 LDS, 16 MUFU).  The widths 20, 24
// and 32 hold 40 to 64 row sums a thread: W = 32 runs one block an SM (its
// 2 x 32 sums and a 135 KB ring of 176-byte rows fit no second one), and
// so do 20 and 24 above 9 features (tk_min_blocks).  Measured in one run
// (the same tool, parent and change in turn) at the one-vs-all G_B: 79.5
// ms at t = 17 and 20, 88.6 at 24, 114.7 at 25 and 32, against 230.7-234.6
// on the column path at each; at the single-kernel tune's CG apply
// (20,000^2 x 20) 0.83 ms against 2.17-2.19.  So the sweep takes 2 <= t <=
// 32 at every m.
//
// t > 32 (pcg-nystrom's sketch K Omega at rank 100, a one-vs-all with more
// than 32 classes) runs on the column path of sweep_cols.cuh, shared with the
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
// The wrapper pads V with zero columns to a multiple of 4 there, so its
// rows are copied in 16-byte units.
//
// Precision: with bf16 operands the kernel value is rounded to bf16 before
// its product with V (the TPU kernel's bf16 matmul operand); the product of
// two bf16 values is exact in f32 and accumulates in f32.  The sweeps read
// bf16 A, B and V as they are; the column path gets them widened to f32
// (exact) by the wrapper.
//
// Deterministic: no atomics; the sweeps add their warps' row sums in warp
// order and the splits' partials in split order, and on the column path a
// thread owns whole output values.
//
// Built in PK_PARTS parts that compile in parallel and link into one
// library (kernels/_build.py reads the count from the #define below):
// -DPK_PART=0 is the t = 1 sweep, the column path and the C entry points,
// -DPK_PART=i > 0 the multi-column sweep at width t1::WIDTHS[i - 1].
#define PK_PARTS 9
#ifndef PK_PART
#error "kernel_matvec.cu is built in parts: -DPK_PART=0 .. PK_PARTS - 1 (kernels/_build.py)"
#endif
#if PK_PART > 0
#define PK_SWEEP_NO_EXPORTS  // part 0 exports sweep_t1.cuh's sizes
#endif
#include "kernel_common.cuh"
#include "sweep_cols.cuh"
#include "sweep_t1.cuh"

using namespace pk;

// Blocks an SM must hold: three (80 registers) for the register path at 9
// feature slots; two (128 registers) where the 16-wide A tile, the slab loop
// or cosine's divisions would spill at 80.
__host__ __device__ constexpr int t1_min_blocks(int kid, int nf, bool slab) {
  return nf == 9 && !slab && kid != K_COSINE ? 3 : 2;
}

// The kernel value of pair (r, j) of a sweep group (bf16: rounded to bf16,
// the TPU kernel's matmul operand).  For rbf, exp(-max(||a - b||^2, 0) /
// (2 sigma^2)) as ex2(rs ||a - b||^2), rs = -log2(e) / (2 sigma^2) < 0: acc
// = a.b - a2 / 2 and the packed norm is rs b2, so rs ||a - b||^2 = rs b2 -
// 2 rs acc (m2rs = -2 rs).  One special-function operation a pair for rbf
// and laplacian, two for matern52 (sqrt.approx and ex2).
template <int KID, bool BF16>
__device__ __forceinline__ float pair_value(float acc, float acc1, float a2, float b2,
                                            const MapConst& mc, float m2rs) {
  constexpr int FAM = family_of(KID);
  float kv;
  if (KID == K_RBF) {
    kv = ex2(fminf(fmaf(acc, m2rs, b2), 0.0f));
  } else {
    const float base = FAM == F_L2   ? fmaxf(fmaf(-2.0f, acc, b2), 0.0f)
                     : FAM == F_L1   ? acc1
                                     : base_value<FAM>(acc, a2, b2);
    kv = t1::kernel_map_t1<KID>(base, mc);
  }
  return BF16 ? round_bf16(kv) : kv;
}

// out (m) = K(A, B) @ v, t == 1, on the t = 1 sweep over the packed B (bp:
// P floats a row, n_pad rows), block (x, y) over rows [y span, +span) of it
// (one range: span = n_pad; split: `out` is the (S, m) partials).
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
            const float kv = pair_value<KID, BF16>(acc[r][j], acc1[r][j], a2[r], b2[j], mc, m2rs);
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

// ---------------------------------------------------------------------------
// 2 <= t <= 32: the multi-column sweep (sweep_t1.cuh at W value columns)
// ---------------------------------------------------------------------------

// Every width of t1::WIDTHS is built, each a part of its own.
constexpr int TK_MAX = t1::WIDTHS[t1::N_WIDTHS - 1];
static_assert(PK_PARTS == 1 + t1::N_WIDTHS, "kernel_matvec.cu is built in 1 + N_WIDTHS parts");
static_assert(PK_PART >= 0 && PK_PART < PK_PARTS, "PK_PART is out of range");

// Blocks an SM must hold: three (80 registers) at 9 feature slots and up to
// 4 columns (as t1_min_blocks); two (128 registers) for the 2 x W row sums
// of the wider sweeps up to W = 16, the 16-wide A tile, the slab loop and
// cosine, and at W = 20 and 24 with A's 9 feature slots in registers; one
// (255 registers at most) where ptxas spills at 128: W = 20 and 24 with 16
// feature slots or the slab loop, and W = 32 (64 row sums).
__host__ __device__ constexpr int tk_min_blocks(int kid, int nf, bool slab, int w) {
  return w <= 4 ? t1_min_blocks(kid, nf, slab) : w <= 16 || (w <= 24 && nf == 9 && !slab) ? 2 : 1;
}

// out (m, t) = K(A, B) @ V, 2 <= t <= W, on the sweep over the packed B (bp:
// P floats a row ending in the W values, n_pad rows), block (x, y) over
// rows [y span, +span) of it (split: `out` is the (S, m, t) partials).
// Each pair's kernel value is formed once (pair_value, as at t = 1), then
// used in W FMAs into the thread's two rows x W sums; a B row's values are
// W / 4 broadcast float4 loads from the staged tile (a float2 at W = 2).
template <typename T, int KID, int NF, bool SLAB, int W>
__global__ void __launch_bounds__(t1::THREADS, tk_min_blocks(KID, NF, SLAB, W))
kernel_matvec_tk_kernel(const T* __restrict__ a, const float* __restrict__ bp,
                        float* __restrict__ out, int64_t m, int64_t n_pad, int64_t span, int d,
                        int P, int t, float sigma) {
  constexpr int FAM = family_of(KID);
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int SP = t1::row_floats(NF, W);  // floats a staged row; its values from SP - W
  extern __shared__ __align__(16) float t1_smem[];
  const MapConst mc = map_const(sigma);
  const float m2rs = -2.0f * mc.rbf_scale;
  float o[t1::R][W] = {};
  t1::sweep<NF, SLAB, FAM != F_L1, FAM == F_L1, W>(
      a, bp, m, d, P, t1::range_begin(span), t1::range_end(span, n_pad), FAM == F_L2, t1_smem,
      [&](float (&acc)[t1::R][t1::J], float (&acc1)[t1::R][t1::J], const float (&a2)[t1::R],
          const float (&b2)[t1::J], const float* grp) {
#pragma unroll
        for (int j = 0; j < t1::J; ++j) {
          float kv[t1::R];
#pragma unroll
          for (int r = 0; r < t1::R; ++r)
            kv[r] = pair_value<KID, BF16>(acc[r][j], acc1[r][j], a2[r], b2[j], mc, m2rs);
          t1::add_values<W>(o, kv, grp + j * SP + (SP - W), [](float x) { return x; });
        }
      });
  t1::write_cols<W>(o, t1_smem, out, m, t, false);
}

template <typename T, int KID, int W>
static cudaError_t launch_tk(const T* a, const T* b, const T* v, float* out, int64_t m, int64_t n,
                             int d, int t, float sigma, float* scratch, cudaStream_t s) {
  const float s2 = sigma * sigma;
  const float norm_scale = KID == K_RBF ? -kLog2e / (2.0f * s2) : 1.0f;  // as launch_t1
  cudaError_t err = t1::launch_pack<W>(b, v, scratch, n, d, norm_scale, s, t);
  if (err != cudaSuccess) return err;
  const t1::PackShape ps = t1::pack_shape(n, d, W);
  const t1::Split sp = t1::split_of(m, n, d);
  float* part = scratch + t1::pack_floats(n, d, W);  // the (S, m, t) partials of a split
  float* dst = sp.s > 1 ? part : out;
#define PK_TK(NF, SLAB)                                                                       \
  err = t1::launch_sweep(kernel_matvec_tk_kernel<T, KID, NF, SLAB, W>, t1::sweep_grid(m, sp), \
                         t1::smem_bytes(NF, SLAB, W), s, a, (const float*)scratch, dst, m,    \
                         ps.rows, sp.span, d, ps.stride, t, sigma)
  PK_T1_DISPATCH_NF(d, PK_TK)
#undef PK_TK
  if (err != cudaSuccess || sp.s == 1) return err;
  return t1::launch_reduce(part, out, m * t, sp.s, false, s);
}

// The arguments of one kernel_matvec launch, as kernel_matvec_launch takes
// them.
struct LaunchArgs {
  const void *a, *b, *v;
  float* out;
  int64_t m, n;
  int d, t;
  float sigma;
  int kernel_id, bf16;
  float* scratch;
  cudaStream_t stream;
};

// The sweep at width W for every kernel and both precisions (A, B and V as
// __nv_bfloat16 with bf16 != 0, else float).  Each width is a part of its
// own (PK_PART below).
template <int W>
int launch_tk_width(const LaunchArgs& x) {
  cudaError_t err = cudaSuccess;
#define PK_LAUNCH(T, KID)                                                                     \
  err = launch_tk<T, KID, W>((const T*)x.a, (const T*)x.b, (const T*)x.v, x.out, x.m, x.n,    \
                             x.d, x.t, x.sigma, x.scratch, x.stream)
  if (x.bf16) {
    PK_DISPATCH_KERNEL(x.kernel_id, PK_LAUNCH, __nv_bfloat16)
  } else {
    PK_DISPATCH_KERNEL(x.kernel_id, PK_LAUNCH, float)
  }
#undef PK_LAUNCH
  return (int)err;
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

#if PK_PART > 0
// A part of the library: the sweep at one width.
template int launch_tk_width<t1::WIDTHS[PK_PART - 1]>(const LaunchArgs&);
#else
// Part 0: the widths are instantiated in the other parts.
extern template int launch_tk_width<2>(const LaunchArgs&);
extern template int launch_tk_width<4>(const LaunchArgs&);
extern template int launch_tk_width<8>(const LaunchArgs&);
extern template int launch_tk_width<12>(const LaunchArgs&);
extern template int launch_tk_width<16>(const LaunchArgs&);
extern template int launch_tk_width<20>(const LaunchArgs&);
extern template int launch_tk_width<24>(const LaunchArgs&);
extern template int launch_tk_width<32>(const LaunchArgs&);

// The widest t that runs on the multi-column sweep; the wrapper sends wider
// V to the column path as f32 padded to a multiple of 4 columns.
extern "C" int kernel_matvec_sweep_t_max() { return TK_MAX; }

// Floats of the scratch a launch of m rows and t columns needs for B of n
// rows and d features: t = 1, the t = 1 sweep's (sweep_t1_scratch_floats);
// 2 <= t <= 32, the packed B with its W = t1::width_of(t) values a row,
// then the (S, m, t) partials of a launch split over n; t > 32, none.
extern "C" long long kernel_matvec_scratch_floats(long long m, long long n, int d, int t) {
  if (m < 0 || n < 0 || d < 1 || t < 1 || t > TK_MAX) return 0;
  return (long long)t1::scratch_floats(m, n, d, t == 1 ? 1 : t1::width_of(t), t);
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// d, t >= 1.  t <= 32: bf16 != 0 reads A, B and V as __nv_bfloat16, else
// as float, and needs `scratch`: kernel_matvec_scratch_floats(m, n, d, t)
// floats of device memory; V is (n, t).  t > 32: A, B and V are float
// (bf16 != 0: holding bf16-rounded values, and K is rounded to bf16 before
// its product with V); `scratch` is unused.
extern "C" int kernel_matvec_launch(const void* a, const void* b, const void* v, void* out,
                                    long long m, long long n, int d, int t, float sigma,
                                    int kernel_id, int bf16, void* scratch, void* stream) {
  if (m < 0 || n < 0 || d < 1 || t < 1) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (t == 1) {
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
  if (t <= TK_MAX) {  // the multi-column sweep, at every m (the crossover in the note)
    const LaunchArgs x{a, b, v, (float*)out, m, n, d, t, sigma, kernel_id, bf16, (float*)scratch, s};
    switch (t1::width_of(t)) {
      case 2: return launch_tk_width<2>(x);
      case 4: return launch_tk_width<4>(x);
      case 8: return launch_tk_width<8>(x);
      case 12: return launch_tk_width<12>(x);
      case 16: return launch_tk_width<16>(x);
      case 20: return launch_tk_width<20>(x);
      case 24: return launch_tk_width<24>(x);
      default: return launch_tk_width<32>(x);
    }
  }
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
#endif
