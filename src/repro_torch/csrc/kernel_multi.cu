// The three weighted-sum (multi-kernel) kernels: q base kernels K_i with
// per-kernel bandwidths, evaluated from ONE pass over the (A, B) pairs.
//
// Replaces the TPU kernels of src/repro/kernels/multi.py:
//   * kernel_matvec_multi_launch (t = 1),
//     kernel_matvec_multi_heads_launch (2 <= t <= 16, static weights) and
//     kernel_matvec_multi_cols_launch (t > 1) <- kernel_matvec_multi_pallas
//     out = (sum_i w_i K_i(A, B)) @ V, w (q,) or per column (q, t);
//   * kernel_matvec_components_launch  <- kernel_matvec_components_pallas
//     out[i] = K_i(A, B) @ V, stacked (q, m, t);
//   * kernel_block_multi_launch        <- kernel_block_multi_pallas
//     out = sum_i w_i K_i(A, B) materialised, static weights.
//
// Common to the kernels:
//   * Families.  The base value is computed once per family present, as the
//     TPU kernel did: l2, dot and cos all need only sum a.b (plus the row
//     norms), so one accumulator serves them; l1 needs its own |a - b|
//     accumulator.  The kernels are templated on which of the two
//     accumulators they form, not on the 7^q combinations.
//   * Runtime q.  The kernel ids, bandwidths and static weights arrive by
//     value in a MultiSpec of at most QMAX entries (QC for the stacked
//     matvec); each block copies them, with the map constants, into shared
//     memory, and a thread reads one kernel's id, constants and weight into
//     registers once per group of pairs, where the switch on the id is taken.
//     The wrapper splits a larger q into groups and sums (matvec, block: a
//     launch with `accumulate` adds to the output) or concatenates (stacked
//     matvec) them.
//
// The weighted matvec at t == 1 (the refit's G_B, residual and prediction)
// runs on the t = 1 sweep it shares with kernel_matvec.cu (sweep_t1.cuh: B
// packed once a launch with its norms and v, 256-row tiles staged by
// cp.async, the block's 64 rows of A in registers, whole row sums per
// thread).  Per 16-pair group a thread forms the family sums, then, per
// kernel, accumulates K_k * (v w_k); with no dot or cos kernel the clamped
// l2 distance is formed once for all l2 kernels.  Bound: operations.  At the
// refit's G_B (rbf + laplacian + matern52, d = 9) a pair costs 2d operations
// for the l1 sum, d for the dot product and about 20 for three maps and
// three products, and four special-function operations (three ex2, one
// sqrt.approx), whose 16 results a clock an SM set a floor of ~48 ms at
// 5e10 pairs.
//
// The weighted heads (kernel_matvec_multi_heads_kernel: 2 <= t <= 16 columns
// with static (q,) weights, a multi-kernel one-vs-all's G_B, residual pass
// and prediction, a multi-kernel model served with heads) run on the same
// sweep at W value columns, as kernel_matvec's multi-column sweep does (W =
// t1::width_of(t): 2, 4, 8, 12 or 16; B packed with its norms and V's
// columns, split over n up to 4096 rows by split_of, so a row's result is
// bitwise the same in every bucket; (S, m, t) partials added in split order
// by reduce_splits).  Per group a thread forms the family sums once, then
// per kernel its map: in f32 it adds w_k K_k into one weighted value a pair,
// then spends W FMAs on it; in bf16 each K_k and each V_c w_k is rounded to
// bf16 before their product (the TPU kernel's operands), so q x W FMAs a
// pair.  Bound: operations, the t = 1 weighted sweep's plus 2 W a pair.  It
// replaced, for these calls, the column path below, whose 32-row blocks do
// not split n and whose 128- or 160-column blocks left 14 of 16 column
// groups idle at t = 10.  Measured in one run (tools/time_torch_kernels.py,
// parent and change in turn; H100 80GB HBM3 at 700 W; the refit's rbf +
// laplacian + matern52, d = 9, f32) at the G_B, 50,000 x 10^6: 118.6, 142.4
// and 180.9 ms at t = 2, 10 and 16 (W = 16 runs one block an SM: ptxas
// spills at 128 registers), against 1,345-1,437 on the column path; a
// 10-head bucket of 64 queries 0.385 ms against 360.  Built one part a
// width (PK_PARTS below).
//
// The column path (kernel_matvec_cols_kernel: the weighted matvec at t > 1,
// the tune's matvec_cols, 160 columns; and the stacked matvec,
// kernel_components_cols_kernel, the tune's sketch, 100 columns) runs on
// sweep_cols.cuh, which it shares with kernel_matvec at t > 1: each pair's
// kernel values formed once per 16-row B tile for a column block of up to
// 160 columns, every thread streaming its 8 rows x 8 (10) columns of the
// output through them.  Here the kernel sets are the MultiSpec's q kernels
// with their weights (MultiSet<false>) and one kernel of it (MultiSet<true>):
//   * The stacked matvec's (q, m, t) output has no weights to fold the q
//     kernels into one accumulator, and a thread holds one 80-register
//     output tile, so the grid spreads over the kernels: grid.z = q, and a
//     block forms only its kernel's family sum and map and writes out[z].
//     A pair's family sum is then formed once per kernel, not once per
//     family (at the sketch's rbf + laplacian + matern52 the dot product
//     twice: 9 of ~340 operations a pair at t = 100); in exchange each block
//     keeps the weighted path's 64 threads, registers and shared memory
//     (31 KB at 128 columns), so six blocks share an SM.  The sketch's 625 x
//     3 blocks give each SM about the work the weighted matvec's 625 blocks
//     of three kernels each do.

// The weighted block (kernel_block_multi_kernel: the refit's K_BB, 50,000^2):
//   * Bound: the output.  10 GB of f32 at 3.35 TB/s is ~3.0 ms; beneath it
//     the pair work (~45 instructions a pair for l1 + dot + three maps, ~3.4
//     ms at full issue) and four special-function operations a pair (~2.4
//     ms) must overlap the stores.
//   * Lanes own columns.  The output is row-major, so lane l of a warp owns
//     the four consecutive columns 4l .. 4l + 3 of a 128 x 128 tile: their
//     B rows sit in registers (packed once a launch with their norms, 9 or
//     16 feature slots), and a warp writes each output row of its tile as
//     one float4 a lane, 512 consecutive bytes (four whole 128-byte lines),
//     with the streaming hint (st.global.cs: the 10 GB pass through the 50
//     MB L2 once).  No shared-memory transpose is needed for these stores.
//   * A rows are read by the whole warp at one address (a broadcast load of
//     the packed row, its norm in the same 16 bytes), four at a time: a
//     group is 4 rows x 4 columns, 16 pairs a lane.  Per group the family
//     sums are formed once; with no dot or cos kernel the dot sum starts at
//     -||a||^2 / 2 and the clamped l2 distance is formed once for all l2
//     kernels; then, per kernel, its id, map constants and weight are read
//     into registers and the switch taken once for the 16 pairs.
//   * Symmetry.  When A and B are the same rows (the refit's op.block(xb):
//     the wrapper passes the same tensor, packed once), warps take only the
//     tiles on and above the diagonal and write each tile above it a second
//     time, transposed: every 32 rows a warp stages its 128 x 32 values in
//     its 16 KB of shared memory (the float4 index swizzled, so neither the
//     staging nor the reads meet a bank conflict) and writes 128 whole
//     128-byte lines.  The pair work halves; the writes stay 10 GB.
//   * Blocks of 4 warps at up to 170 registers, three an SM (64 KB of shared
//     memory each on the symmetric path), form a persistent grid; each warp
//     walks tiles on its own, so one warp's stores drain while it and its
//     neighbours compute.
//   * Above 16 features a slab loop of 16 reloads the lane's B slab per
//     group (the rows are packed to a multiple of 16 features).

// Precision (the TPU kernels' bf16 semantics): with bf16 operands, the
// weighted matvec rounds each K_i value and each V * w_i to bf16 before their
// product (accumulated in f32); the stacked matvec rounds only K_i (V is
// already bf16); the block rounds only the operands and keeps the weighted
// sum of f32 values in f32.
//
// Deterministic: no atomics; the t = 1 sweep adds its 8 warps' row sums in
// warp order (split over n at m <= 4096 rows, a serving bucket's, then a
// row's S range sums in range order, S set by n alone), the column path
// and the block need no reduction across threads (a thread owns whole sums
// and whole output values), and group launches are ordered on the stream.
//
// Built in PK_PARTS parts that compile in parallel and link into one
// library (kernels/_build.py reads the count from the #define below):
// -DPK_PART=0 is everything but the weighted heads and holds the C entry
// points, -DPK_PART=i > 0 the weighted heads at width t1::WIDTHS[i - 1].
#define PK_PARTS 6
#ifndef PK_PART
#error "kernel_multi.cu is built in parts: -DPK_PART=0 .. PK_PARTS - 1 (kernels/_build.py)"
#endif
#if PK_PART > 0
#define PK_SWEEP_NO_EXPORTS  // part 0 exports sweep_t1.cuh's sizes
#endif
#include <algorithm>

#include "kernel_common.cuh"
#include "sweep_cols.cuh"
#include "sweep_t1.cuh"

using namespace pk;

// The weighted heads' widest t: the widths of t1::WIDTHS up to it are built.
constexpr int HEADS_MAX = 16;
constexpr int HEADS_WIDTHS = 5;
static_assert(t1::WIDTHS[HEADS_WIDTHS - 1] == HEADS_MAX, "HEADS_WIDTHS widths reach HEADS_MAX");
static_assert(PK_PARTS == 1 + HEADS_WIDTHS, "kernel_multi.cu is built in 1 + HEADS_WIDTHS parts");
static_assert(PK_PART >= 0 && PK_PART < PK_PARTS, "PK_PART is out of range");

constexpr int QMAX = 8;  // kernels per launch (weighted matvec, block)
constexpr int QC = 4;    // kernels per launch of the stacked matvec (grid.z = q)

// The combination of one launch, by value: q <= QMAX entries.
struct MultiSpec {
  int q;
  int kid[QMAX];
  float sigma[QMAX];
  float w[QMAX];  // static weights: the block's, or a (q,) matvec weight
};

// A block's shared copy of the combination, with the map constants.
struct MultiTable {
  int kid[QMAX];
  MapConst mc[QMAX];
  float w[QMAX];
};

// Thread 0 fills the table (static indices only: no local copy of `spec`).
// Readers wait for the block's next __syncthreads().
__device__ __forceinline__ void load_table(MultiTable& tab, const MultiSpec& spec) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < QMAX; ++i) {
      tab.kid[i] = spec.kid[i];
      tab.mc[i] = map_const(spec.sigma[i]);
      tab.w[i] = spec.w[i];
    }
  }
}

// kv[i][j] = K_KID for the thread's R x J pairs, from the accumulators of
// its family (acc: sum a.b, acc1: sum |a - b|) and the squared norms.
template <int KID, int R, int J>
__device__ __forceinline__ void tile_map_k(float (&kv)[R][J], const float (&acc)[R][J],
                                           const float (&acc1)[R][J], const float (&av)[R],
                                           const float (&bv)[J], const MapConst& mc) {
  constexpr int FAM = family_of(KID);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j)
      kv[i][j] = kernel_map<KID>(
          base_value<FAM>(FAM == F_L1 ? acc1[i][j] : acc[i][j], av[i], bv[j]), mc);
}

// The same for a runtime kernel id (uniform across the block).
template <int R, int J>
__device__ __forceinline__ void tile_map(int kid, float (&kv)[R][J], const float (&acc)[R][J],
                                         const float (&acc1)[R][J], const float (&av)[R],
                                         const float (&bv)[J], const MapConst& mc) {
  switch (kid) {
    case K_RBF: tile_map_k<K_RBF>(kv, acc, acc1, av, bv, mc); break;
    case K_LAPLACIAN: tile_map_k<K_LAPLACIAN>(kv, acc, acc1, av, bv, mc); break;
    case K_MATERN52: tile_map_k<K_MATERN52>(kv, acc, acc1, av, bv, mc); break;
    case K_LINEAR: tile_map_k<K_LINEAR>(kv, acc, acc1, av, bv, mc); break;
    case K_POLYNOMIAL: tile_map_k<K_POLYNOMIAL>(kv, acc, acc1, av, bv, mc); break;
    case K_SIGMOID: tile_map_k<K_SIGMOID>(kv, acc, acc1, av, bv, mc); break;
    default: tile_map_k<K_COSINE>(kv, acc, acc1, av, bv, mc); break;
  }
}

// K_KID of one pair from its family sums (acc: sum a.b, acc1: sum |a - b|)
// and the squared norms.  PRE: acc holds the clamped l2 distance already (no
// dot / cos kernel in the launch).
template <int KID, bool PRE>
__device__ __forceinline__ float pair_kernel(float acc, float acc1, float a2, float b2,
                                             const MapConst& mc) {
  constexpr int FAM = family_of(KID);
  const float base = FAM == F_L2 ? (PRE ? acc : fmaxf(fmaf(-2.0f, acc, a2 + b2), 0.0f))
                   : FAM == F_L1 ? acc1
                                 : base_value<FAM>(acc, a2, b2);
  return t1::kernel_map_t1<KID>(base, mc);
}

// One kernel's share of a group of the t = 1 sweep: o[r] += K_KID(a_r, b_j)
// * vw[j] over the thread's R x J pairs, vw = v * w_k (bf16: each K value
// and each vw rounded to bf16, the TPU kernel's operands).
template <int KID, bool PRE, bool BF16>
__device__ __forceinline__ void weighted_group(float (&o)[t1::R], const float (&acc)[t1::R][t1::J],
                                               const float (&acc1)[t1::R][t1::J],
                                               const float (&a2)[t1::R], const float (&b2)[t1::J],
                                               const float (&vw)[t1::J], const MapConst& mc) {
#pragma unroll
  for (int j = 0; j < t1::J; ++j)
#pragma unroll
    for (int r = 0; r < t1::R; ++r) {
      float kv = pair_kernel<KID, PRE>(acc[r][j], acc1[r][j], a2[r], b2[j], mc);
      if (BF16) kv = round_bf16(kv);
      o[r] = fmaf(kv, vw[j], o[r]);
    }
}

// out (m) (+)= (sum_i w_i K_i(A, B)) @ v, t == 1, on the t = 1 sweep over the
// packed B (bp: P floats a row, n_pad rows); w: a (q, 1) f32 column in
// device memory, or null for the static (q,) weights of `spec`.  Per group
// of 16 pairs a thread: the kernel's id, map constants and weight are read
// once into registers and the switch on the id taken once; with no dot or
// cos kernel (l2_pre) the dot accumulator starts at -||a||^2 / 2 and the
// clamped l2 distance max(b2 - 2 acc, 0) is formed once for all l2 kernels.
// Special-function operations a pair: one ex2 per rbf and laplacian, an ex2
// and a sqrt.approx per matern52 (four for the refit's rbf + laplacian +
// matern52).
template <typename T, bool DOTACC, bool L1ACC, int NF, bool SLAB>
__global__ void __launch_bounds__(t1::THREADS, 2)
kernel_matvec_multi_kernel(const T* __restrict__ a, const float* __restrict__ bp,
                           const float* __restrict__ w, float* __restrict__ out, int64_t m,
                           int64_t n_pad, int64_t span, int d, int P, MultiSpec spec,
                           bool l2_pre, bool accumulate) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float t1_smem[];
  __shared__ MultiTable tab;
  const int q = spec.q;
  load_table(tab, spec);
  __syncthreads();
  if (threadIdx.x < QMAX) {
    const int i = threadIdx.x;
    if (w && i < q) tab.w[i] = w[i];
  }
  __syncthreads();

  float o[t1::R] = {};
  t1::sweep<NF, SLAB, DOTACC, L1ACC>(
      a, bp, m, d, P, t1::range_begin(span), t1::range_end(span, n_pad), l2_pre, t1_smem,
      [&](float (&acc)[t1::R][t1::J], float (&acc1)[t1::R][t1::J], const float (&a2)[t1::R],
          const float (&b2)[t1::J], const float (&vv)[t1::J]) {
        if (DOTACC && l2_pre)
#pragma unroll
          for (int r = 0; r < t1::R; ++r)
#pragma unroll
            for (int j = 0; j < t1::J; ++j)
              acc[r][j] = fmaxf(fmaf(-2.0f, acc[r][j], b2[j]), 0.0f);  // folded
#pragma unroll 1
        for (int k = 0; k < q; ++k) {
          const MapConst mc = tab.mc[k];
          const float wk = tab.w[k];
          float vw[t1::J];
#pragma unroll
          for (int j = 0; j < t1::J; ++j) vw[j] = BF16 ? round_bf16(vv[j] * wk) : vv[j] * wk;
#define PK_GROUP(KID)                                                              \
  if (l2_pre)                                                                      \
    weighted_group<KID, true, BF16>(o, acc, acc1, a2, b2, vw, mc);                 \
  else                                                                             \
    weighted_group<KID, false, BF16>(o, acc, acc1, a2, b2, vw, mc)
          switch (tab.kid[k]) {
            case K_RBF: PK_GROUP(K_RBF); break;
            case K_LAPLACIAN: weighted_group<K_LAPLACIAN, false, BF16>(o, acc, acc1, a2, b2, vw, mc); break;
            case K_MATERN52: PK_GROUP(K_MATERN52); break;
            case K_LINEAR: weighted_group<K_LINEAR, false, BF16>(o, acc, acc1, a2, b2, vw, mc); break;
            case K_POLYNOMIAL: weighted_group<K_POLYNOMIAL, false, BF16>(o, acc, acc1, a2, b2, vw, mc); break;
            case K_SIGMOID: weighted_group<K_SIGMOID, false, BF16>(o, acc, acc1, a2, b2, vw, mc); break;
            default: weighted_group<K_COSINE, false, BF16>(o, acc, acc1, a2, b2, vw, mc); break;
          }
#undef PK_GROUP
        }
      });
  t1::write_rows(o, t1_smem + t1::ring_floats(NF, SLAB), out, m, accumulate);
}

// One kernel's share of a group of the weighted heads over the thread's R x
// J pairs: f32, kt += w K_KID (the pair's weighted value, formed once for
// all W columns); bf16, kt = K_KID rounded to bf16 (its product is taken
// per kernel, with each V_c w rounded to bf16).
template <int KID, bool PRE, bool BF16>
__device__ __forceinline__ void heads_tile(float (&kt)[t1::R][t1::J],
                                           const float (&acc)[t1::R][t1::J],
                                           const float (&acc1)[t1::R][t1::J],
                                           const float (&a2)[t1::R], const float (&b2)[t1::J],
                                           float w, const MapConst& mc) {
#pragma unroll
  for (int r = 0; r < t1::R; ++r)
#pragma unroll
    for (int j = 0; j < t1::J; ++j) {
      const float kv = pair_kernel<KID, PRE>(acc[r][j], acc1[r][j], a2[r], b2[j], mc);
      kt[r][j] = BF16 ? round_bf16(kv) : fmaf(w, kv, kt[r][j]);
    }
}

// heads_tile for a runtime kernel id (uniform across the block); the l2
// kernels read the folded distance when l2_pre.
template <bool BF16>
__device__ __forceinline__ void heads_tile_of(int kid, bool l2_pre, float (&kt)[t1::R][t1::J],
                                              const float (&acc)[t1::R][t1::J],
                                              const float (&acc1)[t1::R][t1::J],
                                              const float (&a2)[t1::R],
                                              const float (&b2)[t1::J], float w,
                                              const MapConst& mc) {
#define PK_TILE(KID, PRE) heads_tile<KID, PRE, BF16>(kt, acc, acc1, a2, b2, w, mc)
  switch (kid) {
    case K_RBF:
      if (l2_pre) PK_TILE(K_RBF, true);
      else PK_TILE(K_RBF, false);
      break;
    case K_LAPLACIAN: PK_TILE(K_LAPLACIAN, false); break;
    case K_MATERN52:
      if (l2_pre) PK_TILE(K_MATERN52, true);
      else PK_TILE(K_MATERN52, false);
      break;
    case K_LINEAR: PK_TILE(K_LINEAR, false); break;
    case K_POLYNOMIAL: PK_TILE(K_POLYNOMIAL, false); break;
    case K_SIGMOID: PK_TILE(K_SIGMOID, false); break;
    default: PK_TILE(K_COSINE, false); break;
  }
#undef PK_TILE
}

// Blocks an SM must hold for the weighted heads at width W: two (128
// registers for the 2 x W row sums, the two family sums and a group's
// weighted values) up to W = 4, and up to W = 12 with A's 9 feature slots
// in registers; else one (255 registers at most), where ptxas spills at 128.
__host__ __device__ constexpr int heads_min_blocks(int nf, bool slab, int w) {
  return w <= 4 || (w <= 12 && nf == 9 && !slab) ? 2 : 1;
}

// out (m, t) (+)= (sum_i w_i K_i(A, B)) @ V, 2 <= t <= W, static weights
// (the table's), on the sweep over the packed B (bp: P floats a row ending
// in the W values, n_pad rows), block (x, y) over rows [y span, +span) of
// it (split: `out` is the (S, m, t) partials).  Per group: the family sums
// once (l2_pre: the clamped l2 distance formed once for all l2 kernels),
// then per kernel its id, map constants and weight read into registers and
// the switch on the id taken once for the thread's 16 pairs.
template <typename T, bool DOTACC, bool L1ACC, int NF, bool SLAB, int W>
__global__ void __launch_bounds__(t1::THREADS, heads_min_blocks(NF, SLAB, W))
kernel_matvec_multi_heads_kernel(const T* __restrict__ a, const float* __restrict__ bp,
                                 float* __restrict__ out, int64_t m, int64_t n_pad, int64_t span,
                                 int d, int P, int t, MultiSpec spec, bool l2_pre,
                                 bool accumulate) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int SP = t1::row_floats(NF, W);  // floats a staged row; its values from SP - W
  extern __shared__ __align__(16) float t1_smem[];
  __shared__ MultiTable tab;
  const int q = spec.q;
  load_table(tab, spec);
  __syncthreads();

  float o[t1::R][W] = {};
  t1::sweep<NF, SLAB, DOTACC, L1ACC, W>(
      a, bp, m, d, P, t1::range_begin(span), t1::range_end(span, n_pad), l2_pre, t1_smem,
      [&](float (&acc)[t1::R][t1::J], float (&acc1)[t1::R][t1::J], const float (&a2)[t1::R],
          const float (&b2)[t1::J], const float* grp) {
        if (DOTACC && l2_pre)
#pragma unroll
          for (int r = 0; r < t1::R; ++r)
#pragma unroll
            for (int j = 0; j < t1::J; ++j)
              acc[r][j] = fmaxf(fmaf(-2.0f, acc[r][j], b2[j]), 0.0f);  // folded
        if constexpr (!BF16) {
          float kt[t1::R][t1::J] = {};
#pragma unroll 1
          for (int k = 0; k < q; ++k) {
            const MapConst mc = tab.mc[k];
            heads_tile_of<false>(tab.kid[k], l2_pre, kt, acc, acc1, a2, b2, tab.w[k], mc);
          }
#pragma unroll
          for (int j = 0; j < t1::J; ++j) {
            float kv[t1::R];
#pragma unroll
            for (int r = 0; r < t1::R; ++r) kv[r] = kt[r][j];
            t1::add_values<W>(o, kv, grp + j * SP + (SP - W), [](float x) { return x; });
          }
        } else {
#pragma unroll 1
          for (int k = 0; k < q; ++k) {
            const MapConst mc = tab.mc[k];
            const float wk = tab.w[k];
            float kt[t1::R][t1::J];
            heads_tile_of<true>(tab.kid[k], l2_pre, kt, acc, acc1, a2, b2, wk, mc);
#pragma unroll
            for (int j = 0; j < t1::J; ++j) {
              float kv[t1::R];
#pragma unroll
              for (int r = 0; r < t1::R; ++r) kv[r] = kt[r][j];
              t1::add_values<W>(o, kv, grp + j * SP + (SP - W),
                                [wk](float x) { return round_bf16(x * wk); });
            }
          }
        }
      });
  t1::write_cols<W>(o, t1_smem, out, m, t, accumulate);
}

// ---------------------------------------------------------------------------
// The column path (sweep_cols.cuh): the weighted matvec for t > 1 (the
// tune's matvec_cols) and the stacked matvec (the tune's sketch).
// ---------------------------------------------------------------------------

// The multi-kernel sets of the column path: the weighted matvec's q
// kernels with their weights (w: (q, t) f32 rows in device memory, or null
// for the static (q,) weights of the table), or, STACKED, entry blockIdx.z
// of the table alone, unweighted.
template <bool STACKED>
struct MultiSet {
  using Tab = MultiTable;
  static constexpr bool WEIGHTED = !STACKED;
  static constexpr bool NORMS = true;
  static constexpr int JU = 1;
  const MultiSpec& spec;
  const float* w;
  __device__ __forceinline__ int q() const { return STACKED ? 1 : spec.q; }
  __device__ __forceinline__ void load(MultiTable& tab) const { load_table(tab, spec); }
  __device__ __forceinline__ float weight(const MultiTable& tab, int k, int c0, int c,
                                         int t) const {
    return w ? w[(int64_t)k * t + c0 + c] : tab.w[k];
  }
  __device__ __forceinline__ float norm(float s) const { return s; }
  __device__ __forceinline__ void map(const MultiTable& tab, int k, float (&kv)[4][1],
                                      const float (&ac)[4][1], const float (&ac1)[4][1],
                                      const float (&av)[4], const float (&bv)[1]) const {
    const int kt = STACKED ? (int)blockIdx.z : 0;  // the table entry of kernel tile 0
    tile_map(tab.kid[kt + k], kv, ac, ac1, av, bv, tab.mc[kt + k]);
  }
};

// out (m, t) (+)= (sum_i w_i K_i(A, B)) @ V, t > 1, on the column path.
// A, B and V are f32 (for BF16, holding bf16-rounded values); w: (q, t) f32
// rows in device memory, or null for the static (q,) weights of `spec`.
template <bool BF16, bool DOTACC, bool L1ACC, int CO>
__global__ void __launch_bounds__(cols::CTHREADS, 6)
kernel_matvec_cols_kernel(const float* __restrict__ a, const float* __restrict__ b,
                          const float* __restrict__ v, const float* __restrict__ w,
                          float* __restrict__ out, int64_t m, int64_t n, int d, int t,
                          int cw, MultiSpec spec, bool v16, bool accumulate) {
  cols::body<BF16, DOTACC, L1ACC, CO>(a, b, v, out, m, n, d, t, cw, MultiSet<false>{spec, w},
                                      v16, accumulate);
}

// out (q, m, t): out[z] = K_z(A, B) @ V for the q <= QC kernels of `spec`,
// grid.z = q; a block forms only its kernel's family (the kernel's id picks
// the body, uniformly across the block).
template <bool BF16, int CO>
__global__ void __launch_bounds__(cols::CTHREADS, 6)
kernel_components_cols_kernel(const float* __restrict__ a, const float* __restrict__ b,
                              const float* __restrict__ v, float* __restrict__ out, int64_t m,
                              int64_t n, int d, int t, int cw, MultiSpec spec, bool v16) {
  const int z = blockIdx.z;
  int kid = K_RBF;
#pragma unroll
  for (int i = 0; i < QMAX; ++i)
    if (i == z) kid = spec.kid[i];
  float* oz = out + (int64_t)z * m * t;
  if (family_of(kid) == F_L1)
    cols::body<BF16, false, true, CO>(a, b, v, oz, m, n, d, t, cw,
                                      MultiSet<true>{spec, nullptr}, v16, false);
  else
    cols::body<BF16, true, false, CO>(a, b, v, oz, m, n, d, t, cw,
                                      MultiSet<true>{spec, nullptr}, v16, false);
}

// ---------------------------------------------------------------------------
// The weighted block: out (m, n) (+)= sum_k w_k K_k(A, B), static weights.
// A and B arrive packed (t1::pack_b without v): rows of P floats, the NF
// feature slots (or all features, padded to a multiple of DS) and the
// squared norm in slot P - 2, zero rows past the end.  Square warp tiles
// of BWR rows x BWS columns; lane l owns columns 4l .. 4l + 3 of its tile.
// ---------------------------------------------------------------------------

constexpr int BTHREADS = 128;
constexpr int BWARPS = BTHREADS / 32;
constexpr int BR = 4;           // A rows of a group
constexpr int BC = 4;           // columns a lane owns: one float4 of an output row
constexpr int BWS = 32 * BC;    // 128 columns a warp tile
constexpr int BWR = BWS;        // rows a warp tile: square, for the mirrored copy
constexpr int BCH = 32;         // rows of a tile the mirrored copy stages at a time
// the symmetric path's shared memory: each warp's BWS x BCH transposed chunk
constexpr size_t BSYM_SMEM = sizeof(float) * BWARPS * BWS * BCH;

// Floats of a packed row (t1::row_floats for the register widths, the
// features padded to a multiple of DS plus one chunk above DCAP), and the
// packed rows of an operand of x rows (a multiple of the tile).
inline int block_stride(int d) {
  return d <= t1::DCAP ? t1::row_floats(t1::nf_bucket(d)) : (d + t1::DS - 1) / t1::DS * t1::DS + 4;
}
inline int64_t block_rows(int64_t x) { return (x + BWS - 1) / BWS * BWS; }

// The NF feature slots and the norm of a packed row (P = row_floats(NF)),
// read as float4 through the read-only path.
template <int NF>
__device__ __forceinline__ void load_packed(float (&f)[NF], float& nrm, const float* row) {
  constexpr int P = t1::row_floats(NF);
  float x[P];
#pragma unroll
  for (int c = 0; c < P / 4; ++c) {
    const float4 y = __ldg(reinterpret_cast<const float4*>(row) + c);
    x[4 * c] = y.x; x[4 * c + 1] = y.y; x[4 * c + 2] = y.z; x[4 * c + 3] = y.w;
  }
#pragma unroll
  for (int k = 0; k < NF; ++k) f[k] = x[k];
  nrm = x[P - 2];
}

// The DS features from feature k0 of a packed row (the slab loop).
__device__ __forceinline__ void load_slab(float (&f)[t1::DS], const float* row) {
#pragma unroll
  for (int c = 0; c < t1::DS / 4; ++c) {
    const float4 y = __ldg(reinterpret_cast<const float4*>(row) + c);
    f[4 * c] = y.x; f[4 * c + 1] = y.y; f[4 * c + 2] = y.z; f[4 * c + 3] = y.w;
  }
}

// ks[r][c] += w K_KID(a_r, b_c) over a group's BR x BC pairs.  PRE: acc
// holds the clamped l2 distance already (no dot / cos kernel in the launch).
template <int KID, bool PRE>
__device__ __forceinline__ void block_group(float (&ks)[BR][BC], const float (&acc)[BR][BC],
                                            const float (&acc1)[BR][BC], const float (&a2)[BR],
                                            const float (&b2)[BC], float w, const MapConst& mc) {
#pragma unroll
  for (int r = 0; r < BR; ++r)
#pragma unroll
    for (int c = 0; c < BC; ++c)
      ks[r][c] = fmaf(w, pair_kernel<KID, PRE>(acc[r][c], acc1[r][c], a2[r], b2[c], mc), ks[r][c]);
}

// out (m, n) (+)= sum_k w_k K_k over `tiles` warp tiles (`strips` column
// strips a row band), walked by every warp of a persistent grid.  DOTACC /
// L1ACC: the accumulators to form; PRE: every kernel of the dot accumulator
// is an l2 kernel (the sum starts at -||a||^2 / 2 and the distance is formed
// once).  NF: feature slots in registers (SLAB: DS a unit, d > DCAP).  vec4:
// n % 4 == 0 and out 16-byte aligned.  sym (A and B the same rows, vec4):
// only the tiles on and above the diagonal are computed, and each one above
// it is also written transposed, BCH rows at a time through the warp's
// chunk of the dynamic shared memory (BSYM_SMEM bytes).
template <bool DOTACC, bool L1ACC, bool PRE, int NF, bool SLAB>
__global__ void __launch_bounds__(BTHREADS, (NF <= 9 && !SLAB) ? 3 : 1)
kernel_block_multi_kernel(const float* __restrict__ ap, const float* __restrict__ bp,
                          float* __restrict__ out, int64_t m, int64_t n, int d, int P,
                          int64_t strips, int64_t tiles, MultiSpec spec, bool vec4, bool sym,
                          bool accumulate) {
  extern __shared__ __align__(16) float4 block_smem[];
  __shared__ MultiTable tab;
  load_table(tab, spec);
  __syncthreads();
  const int q = spec.q;
  const int lane = threadIdx.x % 32;
  // the warp's transposed chunk: BWS rows of BCH floats (BCH / 4 = 8
  // float4, one 128-byte line), float4 u of row j at u ^ ((j / 4) % 8): no
  // bank conflict for a lane's stores (eight-way unswizzled) nor the reads
  float4* tch = block_smem + (threadIdx.x / 32) * (BWS * BCH / 4);
  const int64_t step = (int64_t)gridDim.x * BWARPS;
  for (int64_t tile = (int64_t)blockIdx.x * BWARPS + threadIdx.x / 32; tile < tiles;
       tile += step) {
    const int64_t bi = tile / strips, bj = tile % strips;
    if (sym && bi > bj) continue;  // written transposed by tile (bj, bi)
    const bool mirror = sym && bi < bj;
    const int64_t r0 = bi * BWR;
    const int64_t c0 = bj * BWS + BC * lane;  // the lane's first column
    // the lane's B rows: all feature slots (SLAB: reloaded per group) and norms
    float bf[BC][NF], b2[BC];
#pragma unroll
    for (int c = 0; c < BC; ++c) {
      const float* row = bp + (c0 + c) * P;
      if constexpr (!SLAB) load_packed<NF>(bf[c], b2[c], row);
      else b2[c] = __ldg(reinterpret_cast<const float4*>(row + P - 4)).z;
    }
#pragma unroll 1
    for (int g = 0; g < BWR; g += BR) {
      const int64_t i0 = r0 + g;
      if (i0 >= m) break;  // the rest of the band lies past the last row
      float acc[BR][BC], acc1[BR][BC], a2[BR];
      if constexpr (!SLAB) {
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          float af[NF];
          load_packed<NF>(af, a2[r], ap + (i0 + r) * P);
          const float init = PRE ? -0.5f * a2[r] : 0.0f;
#pragma unroll
          for (int c = 0; c < BC; ++c) {
            acc[r][c] = init;
            acc1[r][c] = 0.0f;
#pragma unroll
            for (int k = 0; k < NF; ++k) {
              if (DOTACC) acc[r][c] = fmaf(af[k], bf[c][k], acc[r][c]);
              if (L1ACC) acc1[r][c] += fabsf(af[k] - bf[c][k]);
            }
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          a2[r] = __ldg(reinterpret_cast<const float4*>(ap + (i0 + r) * P + P - 4)).z;
#pragma unroll
          for (int c = 0; c < BC; ++c) {
            acc[r][c] = PRE ? -0.5f * a2[r] : 0.0f;
            acc1[r][c] = 0.0f;
          }
        }
#pragma unroll 1
        for (int s = 0; s < (d + NF - 1) / NF; ++s) {
#pragma unroll
          for (int c = 0; c < BC; ++c) load_slab(bf[c], bp + (c0 + c) * P + s * NF);
#pragma unroll
          for (int r = 0; r < BR; ++r) {
            float af[NF];
            load_slab(af, ap + (i0 + r) * P + s * NF);
#pragma unroll
            for (int c = 0; c < BC; ++c)
#pragma unroll
              for (int k = 0; k < NF; ++k) {
                if (DOTACC) acc[r][c] = fmaf(af[k], bf[c][k], acc[r][c]);
                if (L1ACC) acc1[r][c] += fabsf(af[k] - bf[c][k]);
              }
          }
        }
      }
      if (DOTACC && PRE)
#pragma unroll
        for (int r = 0; r < BR; ++r)
#pragma unroll
          for (int c = 0; c < BC; ++c) acc[r][c] = fmaxf(fmaf(-2.0f, acc[r][c], b2[c]), 0.0f);

      // per kernel: its id, map constants and weight into registers, the
      // switch once for the group's 16 pairs
      float ks[BR][BC] = {};
#pragma unroll 1
      for (int k = 0; k < q; ++k) {
        const MapConst mc = tab.mc[k];
        const float wk = tab.w[k];
        switch (tab.kid[k]) {
          case K_RBF: block_group<K_RBF, PRE>(ks, acc, acc1, a2, b2, wk, mc); break;
          case K_LAPLACIAN: block_group<K_LAPLACIAN, false>(ks, acc, acc1, a2, b2, wk, mc); break;
          case K_MATERN52: block_group<K_MATERN52, PRE>(ks, acc, acc1, a2, b2, wk, mc); break;
          case K_LINEAR: block_group<K_LINEAR, false>(ks, acc, acc1, a2, b2, wk, mc); break;
          case K_POLYNOMIAL: block_group<K_POLYNOMIAL, false>(ks, acc, acc1, a2, b2, wk, mc); break;
          case K_SIGMOID: block_group<K_SIGMOID, false>(ks, acc, acc1, a2, b2, wk, mc); break;
          default: block_group<K_COSINE, false>(ks, acc, acc1, a2, b2, wk, mc); break;
        }
      }

      // each output row of the warp's strip: one float4 a lane, 512
      // consecutive bytes, streamed past the L2
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const int64_t row = i0 + r;
        if (row >= m) break;
        float* dst = out + row * n + c0;
        if (vec4) {
          if (c0 < n) {
            float4 s = make_float4(ks[r][0], ks[r][1], ks[r][2], ks[r][3]);
            if (accumulate) {
              const float4 prev = *reinterpret_cast<const float4*>(dst);
              s.x += prev.x; s.y += prev.y; s.z += prev.z; s.w += prev.w;
            }
            __stcs(reinterpret_cast<float4*>(dst), s);
          }
        } else {
#pragma unroll
          for (int c = 0; c < BC; ++c)
            if (c0 + c < n) __stcs(dst + c, accumulate ? dst[c] + ks[r][c] : ks[r][c]);
        }
      }

      // the mirrored copy: rows c0 .. c0 + 3, columns i0 .. i0 + 3 hold the
      // group's values transposed; every BCH rows the warp writes the chunk
      // out as BWS rows of BCH floats (row bj * BWS + j, columns from the
      // chunk's first row; the tile above the diagonal has all BWR rows)
      if (mirror) {
        const int ig = g % BCH / BR;
#pragma unroll
        for (int c = 0; c < BC; ++c)
          tch[(BC * lane + c) * (BCH / 4) + (ig ^ (lane % 8))] =
              make_float4(ks[0][c], ks[1][c], ks[2][c], ks[3][c]);
        if (ig == BCH / BR - 1) {
          __syncwarp();
          const int u = lane % 8;
#pragma unroll 4
          for (int it = 0; it < BWS / 4; ++it) {
            const int j = 4 * it + lane / 8;
            const int64_t row = bj * BWS + j;
            if (row < n) {
              float4 val = tch[j * (BCH / 4) + (u ^ (j / 4 % 8))];
              float* dst = out + row * n + (i0 + BR - BCH) + 4 * u;
              if (accumulate) {
                const float4 prev = *reinterpret_cast<const float4*>(dst);
                val.x += prev.x; val.y += prev.y; val.z += prev.z; val.w += prev.w;
              }
              __stcs(reinterpret_cast<float4*>(dst), val);
            }
          }
          __syncwarp();
        }
      }
    }
  }
}

// Instantiate LAUNCH(T, DOTACC, L1ACC) for the families present.
#define PK_DISPATCH_FAMILIES(LAUNCH, T) \
  if (dot && l1) {                      \
    LAUNCH(T, true, true);              \
  } else if (l1) {                      \
    LAUNCH(T, false, true);             \
  } else {                              \
    LAUNCH(T, true, false);             \
  }

// The arguments of one weighted-heads launch (kernel_matvec_multi_heads_launch).
struct HeadsArgs {
  const void *a, *b, *v;
  float* out;
  int64_t m, n;
  int d, t;
  MultiSpec spec;
  bool dot, l1, l2_pre, bf16, accumulate;
  float* scratch;
  cudaStream_t stream;
};

template <typename T, bool DA, bool LA, int W>
static cudaError_t launch_heads(const HeadsArgs& x) {
  cudaError_t err =
      t1::launch_pack<W>((const T*)x.b, (const T*)x.v, x.scratch, x.n, x.d, 1.0f, x.stream, x.t);
  if (err != cudaSuccess) return err;
  const t1::PackShape ps = t1::pack_shape(x.n, x.d, W);
  const t1::Split sp = t1::split_of(x.m, x.n, x.d);
  float* part = x.scratch + t1::pack_floats(x.n, x.d, W);  // the (S, m, t) partials of a split
  float* dst = sp.s > 1 ? part : x.out;
#define PK_HEADS(NF, SLAB)                                                                      \
  err = t1::launch_sweep(kernel_matvec_multi_heads_kernel<T, DA, LA, NF, SLAB, W>,              \
                         t1::sweep_grid(x.m, sp), t1::smem_bytes(NF, SLAB, W), x.stream,        \
                         (const T*)x.a, (const float*)x.scratch, dst, x.m, ps.rows, sp.span,    \
                         x.d, ps.stride, x.t, x.spec, x.l2_pre, x.accumulate)
  PK_T1_DISPATCH_NF(x.d, PK_HEADS)
#undef PK_HEADS
  if (err != cudaSuccess || sp.s == 1) return err;
  return t1::launch_reduce(part, x.out, x.m * x.t, sp.s, x.accumulate, x.stream);
}

// The weighted heads at width W for every family set and both precisions;
// each width is a part of its own (PK_PART below).
template <int W>
int launch_heads_width(const HeadsArgs& x) {
  cudaError_t err = cudaSuccess;
  const bool dot = x.dot, l1 = x.l1;
#define PK_LAUNCH(T, DA, LA) err = launch_heads<T, DA, LA, W>(x)
  if (x.bf16) {
    PK_DISPATCH_FAMILIES(PK_LAUNCH, __nv_bfloat16);
  } else {
    PK_DISPATCH_FAMILIES(PK_LAUNCH, float);
  }
#undef PK_LAUNCH
  return (int)err;
}

#if PK_PART > 0
// A part of the library: the weighted heads at one width.
template int launch_heads_width<t1::WIDTHS[PK_PART - 1]>(const HeadsArgs&);
#else
// Part 0: the widths are instantiated in the other parts.
extern template int launch_heads_width<2>(const HeadsArgs&);
extern template int launch_heads_width<4>(const HeadsArgs&);
extern template int launch_heads_width<8>(const HeadsArgs&);
extern template int launch_heads_width<12>(const HeadsArgs&);
extern template int launch_heads_width<16>(const HeadsArgs&);

// ---------------------------------------------------------------------------
// C launchers: launch on `stream` and return cudaGetLastError() (0 = ok).
// kids / sigmas / weights are HOST arrays of q entries; bf16 != 0 reads the
// operands as __nv_bfloat16, else as float.  d >= 1, t >= 1.
// ---------------------------------------------------------------------------

// Floats of the scratch a weighted-block launch packs A (m rows) and, unless
// `same`, B (n rows) into.
extern "C" long long kernel_block_multi_scratch_floats(long long m, long long n, int d,
                                                        int same) {
  if (m < 0 || n < 0 || d < 1) return 0;
  return (long long)((block_rows(m) + (same ? 0 : block_rows(n))) * block_stride(d));
}

// Fill the spec; false for a q out of range or an unknown kernel id.  The
// families present pick the accumulators (*dot: l2 / dot / cos, *l1: l1).
static bool make_spec(MultiSpec& s, int q, int qmax, const int* kids, const float* sigmas,
                      const float* weights, bool* dot, bool* l1) {
  if (q < 1 || q > qmax) return false;
  s.q = q;
  *dot = *l1 = false;
  for (int i = 0; i < QMAX; ++i) {
    const bool live = i < q;
    s.kid[i] = live ? kids[i] : K_RBF;
    s.sigma[i] = live ? sigmas[i] : 1.0f;
    s.w[i] = live && weights ? weights[i] : 0.0f;
    if (!live) continue;
    if (kids[i] < K_RBF || kids[i] > K_COSINE) return false;
    if (family_of(kids[i]) == F_L1) *l1 = true;
    else *dot = true;
  }
  return true;
}

// Whether every kernel of the dot accumulator is an l2 kernel (no dot or
// cos kernel): its sum then starts at -||a||^2 / 2 and the clamped l2
// distance is formed once for all l2 kernels.
static bool l2_only(int q, const int* kids) {
  for (int i = 0; i < q; ++i)
    if (family_of(kids[i]) == F_DOT || family_of(kids[i]) == F_COS) return false;
  return true;
}

template <typename T, bool DA, bool LA>
static cudaError_t launch_multi_t1(const T* a, const T* b, const T* v, const float* w, float* out,
                                   int64_t m, int64_t n, int d, const MultiSpec& spec,
                                   bool l2_pre, bool accumulate, float* scratch, cudaStream_t s) {
  cudaError_t err = t1::launch_pack(b, v, scratch, n, d, 1.0f, s);
  if (err != cudaSuccess) return err;
  const t1::PackShape ps = t1::pack_shape(n, d);
  const t1::Split sp = t1::split_of(m, n, d);
  float* part = scratch + t1::pack_floats(n, d);  // the (S, m) partials of a split
  float* dst = sp.s > 1 ? part : out;
#define PK_T1(NF, SLAB)                                                                      \
  err = t1::launch_sweep(kernel_matvec_multi_kernel<T, DA, LA, NF, SLAB>,                    \
                         t1::sweep_grid(m, sp), t1::smem_bytes(NF, SLAB), s, a,              \
                         (const float*)scratch, w, dst, m, ps.rows, sp.span, d, ps.stride,   \
                         spec, l2_pre, accumulate)
  PK_T1_DISPATCH_NF(d, PK_T1)
#undef PK_T1
  if (err != cudaSuccess || sp.s == 1) return err;
  return t1::launch_reduce(part, out, m, sp.s, accumulate, s);
}

// t == 1: w is a device (q, 1) f32 column, or null to use the host
// `weights` (q,).  accumulate != 0 adds to `out` instead of overwriting it.
// `scratch`: sweep_t1_scratch_floats(m, n, d) floats of device memory (B
// packed with its norms and v, then the partials of a launch split over n).
extern "C" int kernel_matvec_multi_launch(const void* a, const void* b, const void* v,
                                          const float* w, void* out, long long m, long long n,
                                          int d, int t, int q, const int* kids,
                                          const float* sigmas, const float* weights, int bf16,
                                          int accumulate, void* scratch, void* stream) {
  if (m < 0 || n < 0 || d < 1 || t != 1) return (int)cudaErrorInvalidValue;
  MultiSpec spec;
  bool dot, l1;
  if (!make_spec(spec, q, QMAX, kids, sigmas, weights, &dot, &l1) || (!w && !weights))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const bool l2_pre = l2_only(q, kids);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
#define PK_LAUNCH(T, DA, LA)                                                                \
  err = launch_multi_t1<T, DA, LA>((const T*)a, (const T*)b, (const T*)v, w, (float*)out, m, \
                                   n, d, spec, l2_pre, accumulate != 0, (float*)scratch, s)
  if (bf16) {
    PK_DISPATCH_FAMILIES(PK_LAUNCH, __nv_bfloat16);
  } else {
    PK_DISPATCH_FAMILIES(PK_LAUNCH, float);
  }
#undef PK_LAUNCH
  return (int)err;
}

// The weighted heads' widest t (wider V and per-column weights take the
// column path).
extern "C" int kernel_matvec_multi_heads_t_max() { return HEADS_MAX; }

// Floats of the scratch a weighted-heads launch of m rows and t columns
// needs for B of n rows and d features: the packed B with its W =
// t1::width_of(t) values a row, then the (S, m, t) partials of a launch
// split over n.  0 outside 2 <= t <= HEADS_MAX.
extern "C" long long kernel_matvec_multi_heads_scratch_floats(long long m, long long n, int d,
                                                               int t) {
  if (m < 0 || n < 0 || d < 1 || t < 2 || t > HEADS_MAX) return 0;
  return (long long)t1::scratch_floats(m, n, d, t1::width_of(t), t);
}

// 2 <= t <= HEADS_MAX with the host (q,) `weights`: the weighted heads.
// accumulate != 0 adds to `out` (m, t).  `scratch`:
// kernel_matvec_multi_heads_scratch_floats(m, n, d, t) floats of device
// memory (B packed with its norms and V, then the partials of a split).
extern "C" int kernel_matvec_multi_heads_launch(const void* a, const void* b, const void* v,
                                                void* out, long long m, long long n, int d, int t,
                                                int q, const int* kids, const float* sigmas,
                                                const float* weights, int bf16, int accumulate,
                                                void* scratch, void* stream) {
  if (m < 0 || n < 0 || d < 1 || t < 2 || t > HEADS_MAX || !weights)
    return (int)cudaErrorInvalidValue;
  MultiSpec spec;
  bool dot, l1;
  if (!make_spec(spec, q, QMAX, kids, sigmas, weights, &dot, &l1))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const HeadsArgs x{a, b, v, (float*)out, m, n, d, t, spec, dot, l1, l2_only(q, kids),
                    bf16 != 0, accumulate != 0, (float*)scratch, (cudaStream_t)stream};
  switch (t1::width_of(t)) {
    case 2: return launch_heads_width<2>(x);
    case 4: return launch_heads_width<4>(x);
    case 8: return launch_heads_width<8>(x);
    case 12: return launch_heads_width<12>(x);
    default: return launch_heads_width<16>(x);
  }
}

// The column path, t > 1: a, b, v f32 (bf16 != 0: holding bf16-rounded
// values, and each K_i and V * w_i is rounded to bf16 before their product);
// w: device (q, t) f32 rows, or null to use the host `weights` (q,) for every
// column.  The columns are split evenly over the fewest blocks of at most
// 160 (the width rounded up to a multiple of 4), and a block of at most 128
// columns runs with CO_MID columns a thread: the sketch's 100 and the
// launcher's default 120 pay for 128, not 160.
extern "C" int kernel_matvec_multi_cols_launch(const float* a, const float* b, const float* v,
                                               const float* w, float* out, long long m,
                                               long long n, int d, int t, int q, const int* kids,
                                               const float* sigmas, const float* weights,
                                               int bf16, int accumulate, void* stream) {
  if (m < 0 || n < 0 || d < 1 || t < 2) return (int)cudaErrorInvalidValue;
  MultiSpec spec;
  bool dot, l1;
  if (!make_spec(spec, q, QMAX, kids, sigmas, weights, &dot, &l1) || (!w && !weights))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const cols::Split sp = cols::col_split(t, false);
  if (sp.gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((m + cols::CM - 1) / cols::CM), (unsigned)sp.gy);
  const bool v16 = t % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  // above the 48 KB a block gets by default (q > 5 at 160 columns) the
  // launch opts in first; a refusal is returned, and nothing is launched
#define PK_LAUNCH_CO(BF, DA, LA, CO)                                                          \
  do {                                                                                        \
    const size_t bytes = cols::smem_bytes<cols::CCG * CO, MultiTable>(q);                     \
    if (bytes > 48 * 1024)                                                                    \
      err = cudaFuncSetAttribute(kernel_matvec_cols_kernel<BF, DA, LA, CO>,                   \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);    \
    if (err == cudaSuccess)                                                                   \
      kernel_matvec_cols_kernel<BF, DA, LA, CO><<<grid, cols::CTHREADS, bytes, s>>>(          \
          a, b, v, w, out, m, n, d, t, sp.cw, spec, v16, accumulate != 0);                    \
  } while (0)
#define PK_LAUNCH(BF, DA, LA)                \
  if (sp.co == cols::CO_MID)                 \
    PK_LAUNCH_CO(BF, DA, LA, cols::CO_MID);  \
  else                                       \
    PK_LAUNCH_CO(BF, DA, LA, cols::CO_WIDE)
  if (bf16) {
    PK_DISPATCH_FAMILIES(PK_LAUNCH, true);
  } else {
    PK_DISPATCH_FAMILIES(PK_LAUNCH, false);
  }
#undef PK_LAUNCH
#undef PK_LAUNCH_CO
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// out: (q, m, t) f32, q <= QC, on the column path with grid.z = q.  a, b, v
// f32 (bf16 != 0: holding bf16-rounded values, and each K_i is rounded to
// bf16 before its product with V).  The columns are split as the weighted
// column path splits them; t = 1 runs there too (no path sends it).
extern "C" int kernel_matvec_components_launch(const float* a, const float* b, const float* v,
                                               float* out, long long m, long long n, int d,
                                               int t, int q, const int* kids,
                                               const float* sigmas, int bf16, void* stream) {
  if (m < 0 || n < 0 || d < 1 || t < 1) return (int)cudaErrorInvalidValue;
  MultiSpec spec;
  bool dot, l1;
  if (!make_spec(spec, q, QC, kids, sigmas, nullptr, &dot, &l1)) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const cols::Split sp = cols::col_split(t, false);
  if (sp.gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((m + cols::CM - 1) / cols::CM), (unsigned)sp.gy, (unsigned)q);
  const bool v16 = t % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  // one kernel's tile: under the 48 KB a block gets by default
#define PK_LAUNCH_CO(BF, CO)                                                           \
  do {                                                                                 \
    const size_t bytes = cols::smem_bytes<cols::CCG * CO, MultiTable>(1);              \
    kernel_components_cols_kernel<BF, CO><<<grid, cols::CTHREADS, bytes, s>>>(         \
        a, b, v, out, m, n, d, t, sp.cw, spec, v16);                                   \
  } while (0)
#define PK_LAUNCH(BF)                  \
  if (sp.co == cols::CO_MID)           \
    PK_LAUNCH_CO(BF, cols::CO_MID);    \
  else                                 \
    PK_LAUNCH_CO(BF, cols::CO_WIDE)
  if (bf16) {
    PK_LAUNCH(true);
  } else {
    PK_LAUNCH(false);
  }
#undef PK_LAUNCH
#undef PK_LAUNCH_CO
  return (int)cudaGetLastError();
}

// Pack x (rows live rows of d features, T) into `dst` as block_rows(rows)
// packed rows of P floats with their norms.
template <typename T>
static cudaError_t pack_rows(const T* x, float* dst, int64_t rows, int d, int P, cudaStream_t s) {
  const int64_t padded = block_rows(rows);
  constexpr int PT = 256;
  t1::pack_b<T><<<(unsigned)((padded + PT - 1) / PT), PT, 0, s>>>(
      x, static_cast<const T*>(nullptr), dst, rows, padded, d, P, 1.0f, 1);
  return cudaGetLastError();
}

template <bool DA, bool LA, bool PRE, int NF, bool SLAB>
static cudaError_t launch_block_multi(const float* ap, const float* bp, float* out, int64_t m,
                                      int64_t n, int d, int P, const MultiSpec& spec, bool vec4,
                                      bool accumulate, cudaStream_t s) {
  const auto kernel = kernel_block_multi_kernel<DA, LA, PRE, NF, SLAB>;
  const int64_t strips = (n + BWS - 1) / BWS, tiles = strips * ((m + BWR - 1) / BWR);
  // the symmetric path: the same rows as A and B, float4 stores
  const bool sym = ap == bp && m == n && vec4;
  const size_t smem = sym ? BSYM_SMEM : 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BTHREADS, smem);
  if (err != cudaSuccess) return err;
  // a persistent grid: as many blocks as fit on the card at once, or fewer
  // when there are fewer warp tiles
  const int64_t blocks = std::min<int64_t>((tiles + BWARPS - 1) / BWARPS,
                                           (int64_t)sms * std::max(per_sm, 1));
  kernel<<<(unsigned)blocks, BTHREADS, smem, s>>>(ap, bp, out, m, n, d, P, strips, tiles, spec,
                                                  vec4, sym, accumulate);
  return cudaGetLastError();
}

// out: (m, n) f32; weights: host (q,).  accumulate != 0 adds to `out`.
// `scratch`: kernel_block_multi_scratch_floats(m, n, d, same) floats of
// device memory, where A and B are packed with their norms; B is packed
// once with A when it is the same operand (b == a and n == m).
extern "C" int kernel_block_multi_launch(const void* a, const void* b, void* out, long long m,
                                         long long n, int d, int q, const int* kids,
                                         const float* sigmas, const float* weights, int bf16,
                                         int accumulate, void* scratch, void* stream) {
  if (m < 0 || n < 0 || d < 1 || !weights) return (int)cudaErrorInvalidValue;
  MultiSpec spec;
  bool dot, l1;
  if (!make_spec(spec, q, QMAX, kids, sigmas, weights, &dot, &l1))
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  if (!scratch) return (int)cudaErrorInvalidValue;
  const bool pre = l2_only(q, kids);
  const bool same = a == b && m == n;
  const int P = block_stride(d);
  float* ap = (float*)scratch;
  float* bp = same ? ap : ap + block_rows(m) * P;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = bf16 ? pack_rows((const __nv_bfloat16*)a, ap, m, d, P, s)
                         : pack_rows((const float*)a, ap, m, d, P, s);
  if (err == cudaSuccess && !same)
    err = bf16 ? pack_rows((const __nv_bfloat16*)b, bp, n, d, P, s)
               : pack_rows((const float*)b, bp, n, d, P, s);
  if (err != cudaSuccess) return (int)err;
  const bool vec4 = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
#define PK_NF(NF, SLAB)                                                                      \
  err = launch_block_multi<DA, LA, PR, NF, SLAB>(ap, bp, (float*)out, m, n, d, P, spec, vec4, \
                                                 accumulate != 0, s)
#define PK_FAM(DA_, LA_, PR_)    \
  do {                           \
    constexpr bool DA = DA_;     \
    constexpr bool LA = LA_;     \
    constexpr bool PR = PR_;     \
    PK_T1_DISPATCH_NF(d, PK_NF)  \
  } while (0)
  if (!dot) {
    PK_FAM(false, true, false);
  } else if (l1) {
    if (pre) PK_FAM(true, true, true);
    else PK_FAM(true, true, false);
  } else {
    if (pre) PK_FAM(true, false, true);
    else PK_FAM(true, false, false);
  }
#undef PK_FAM
#undef PK_NF
  return (int)err;
}
#endif
