// The three weighted-sum (multi-kernel) kernels: q base kernels K_i with
// per-kernel bandwidths, evaluated from ONE pass over the (A, B) tiles.
//
// Replaces the TPU kernels of src/repro/kernels/multi.py:
//   * kernel_matvec_multi_launch (t = 1) and
//     kernel_matvec_multi_cols_launch (t > 1) <- kernel_matvec_multi_pallas
//     out = (sum_i w_i K_i(A, B)) @ V, w (q,) or per column (q, t);
//   * kernel_matvec_components_launch  <- kernel_matvec_components_pallas
//     out[i] = K_i(A, B) @ V, stacked (q, m, t);
//   * kernel_block_multi_launch        <- kernel_block_multi_pallas
//     out = sum_i w_i K_i(A, B) materialised, static weights.
//
// Design.  Common to the three kernels:
//   * Families.  The base tile is computed once per family present, as the
//     TPU kernel did: l2, dot and cos all need only sum a.b (plus the row
//     norms), so one accumulator serves them; l1 needs its own |a - b|
//     accumulator.  The kernels are templated on which of the two
//     accumulators the launch needs: three instantiations, not 7^q.
//   * Runtime q.  The kernel ids, bandwidths and static weights arrive by
//     value in a MultiSpec of at most QMAX entries (QC for the components
//     kernel, whose q x RM x TC accumulators live in registers); each block
//     copies them, with the map constants, into shared memory.  The wrapper
//     splits a larger q into groups and sums (matvec, block: a launch with
//     `accumulate` adds to the output) or concatenates (components) them.
//   * Per-column weights.  V is pre-scaled per kernel: w_ic (K_i v)[:, c]
//     == (K_i (v * w_i))[:, c], so one accumulator per (row, column) serves
//     all q kernels.
// The stacked matvec and the weighted block run on sweep_b below, the 64 x 64
// tiles and 16-lane shuffle reduction of the first port (kernel_common.cuh),
// the map chosen per kernel by a switch uniform across the block, once per
// 4 x 4 register tile.
//
// The weighted matvec has two paths.  t == 1 (the refit's G_B, residual and
// prediction) runs on the t = 1 sweep it shares with kernel_matvec.cu
// (sweep_t1.cuh: B packed once a launch with its norms and v, 256-row tiles
// staged by cp.async, the block's 64 rows of A in registers, whole row sums
// per thread).  Per 16-pair group a thread forms the family sums, then, per
// kernel, reads its id, map constants and weight once into registers, takes
// the switch on the id once and accumulates K_k * (v w_k) over the 16 pairs;
// with no dot or cos kernel the clamped l2 distance is formed once for all
// l2 kernels.  Bound: operations.  At the refit's G_B (rbf + laplacian +
// matern52, d = 9) a pair costs 2d operations for the l1 sum, d for the dot
// product and about 20 for three maps and three products, and four
// special-function operations (three ex2, one sqrt.approx), whose 16 results
// a clock an SM set a floor of ~48 ms at 5e10 pairs.
//
// t > 1 (the tune's matvec_cols, 160 columns) runs on the column path,
// kernel_matvec_cols_kernel:
//   * Kernel values once for all columns.  The TPU kernel takes all of V's
//     columns in one block, so it forms each pair's distances and q maps
//     once.  A block here owns 32 rows of A and a column block of at most
//     TCB = 160 columns (t is split evenly over the fewest such blocks; a
//     block of at most 128 columns runs with TCB = 128), so at t = 160 each
//     pair's distances and maps are formed once per 16-row B tile and
//     written to shared memory; every thread then streams its 8 rows x 10
//     columns of the output (80 f32 registers, no lane reduction) through
//     them.  Per B row and kernel: two float4 of K_k, 10 multiplies of the
//     shared V row by the weights (held in registers, three kernels at a
//     time, so one V row read serves three kernels) and 80 FMAs.
//   * Shared memory (dynamic): the V tile (16 x TCB) and the transposed B
//     slab, each double-buffered and copied by cp.async one tile ahead (no
//     register holds data in flight); the A tile; each thread's pair
//     accumulators; then q kernel tiles (16 x 32) and q weight rows.  At
//     q = 3 and 160 columns that is 41.2 KB; above 48 KB (q > 5) the
//     launcher opts in to more.  64 threads of at most 168 registers: five
//     blocks share an SM, so the 625 blocks of a 20,000-row, 160-column
//     launch run in one wave.
//   * Bound: the q x t FMAs a pair (480 at q = 3, t = 160) at the FP32
//     CUDA-core rate.  Tensor cores are not used: the f32 policy is true
//     f32, which TF32 products would break.
//   * The operands arrive as f32 (the wrapper widens bf16-rounded values),
//     so rows of any d and t are copied in 4-byte units (V in 16-byte units
//     when t % 4 == 0).
//
// Precision (the TPU kernels' bf16 semantics): with bf16 operands, the
// weighted matvec rounds each K_i tile and each V * w_i to bf16 before their
// product (accumulated in f32); the components kernel rounds only K_i (V is
// already bf16); the block rounds only the operands and keeps the weighted
// sum of f32 tiles in f32.
//
// Deterministic: no atomics; sweep_b reduces the 16 partial sums of a row by
// a fixed butterfly of shuffles, the t = 1 sweep adds its 8 warps' row sums
// in warp order, the column path needs neither (a thread owns whole sums),
// and group launches are ordered on the stream.
#include "kernel_common.cuh"
#include "sweep_t1.cuh"

using namespace pk;

constexpr int QMAX = 8;  // kernels per launch (weighted matvec, block)
constexpr int QC = 4;    // kernels per launch (components: q x RM x TC registers)
constexpr int TCC = 4;   // column chunk of the components kernel for t > 1

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

// The sweep of the stacked matvec and the weighted block: for each 64-row tile of B in
// [j_begin, j_end) the family accumulators of the thread's 4 x 4 pairs,
// then `epilogue(j0, acc, acc1, av, bv, cols)`, with V of the tile (columns
// [c0, c0 + tc)) staged in Vs when TC > 0; the block kernel has no V (TC = 0).
template <typename T, bool DOTACC, bool L1ACC, int TC, typename Epilogue>
__device__ __forceinline__ void sweep_b(const T* __restrict__ a, const T* __restrict__ b,
                                        const T* __restrict__ v, int64_t m, int64_t n, int d,
                                        int t, int c0, int tc, int64_t j_begin, int64_t j_end,
                                        float (*As)[TM], float (*Bs)[TN], float (*Vs)[TN],
                                        float* a2, float* b2, Epilogue epilogue) {
  constexpr bool NORMS = DOTACC;
  constexpr int PV = TC > 0 ? (TN * TC + THREADS - 1) / THREADS : 1;
  const int rg = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int64_t r0 = (int64_t)blockIdx.x * TM;
  const int ns = (d + DC - 1) / DC;  // slabs per B tile
  const bool a_once = ns == 1;

  if (NORMS) a_sq_norms(a2, a, r0, m, d);
  if (a_once) stage_a(As, a, r0, m, d, 0, d);

  float pb[PB], pv[PV];
  int64_t f_j0 = j_begin;
  int f_slab = 0;
  auto fetch_next = [&]() {
    const int k0 = f_slab * DC;
    fetch_b(pb, b, f_j0, n, d, k0, min(DC, d - k0));
    if constexpr (TC > 0)
      if (f_slab == 0) fetch_v<T, TC, PV>(pv, v, f_j0, n, t, c0, tc);
    if (++f_slab == ns) {
      f_slab = 0;
      f_j0 += TN;
    }
  };
  if (j_begin < j_end) fetch_next();

  for (int64_t j0 = j_begin; j0 < j_end; j0 += TN) {
    float acc[RM][JN] = {}, acc1[RM][JN] = {};
    for (int slab = 0; slab < ns; ++slab) {
      const int k0 = slab * DC, kc = min(DC, d - k0);
      __syncthreads();  // readers of the previous slab / tile are done
      commit_b(Bs, pb, kc);
      if constexpr (TC > 0)
        if (slab == 0) commit_v<TC, PV>(Vs, pv);
      if (!a_once) stage_a(As, a, r0, m, d, k0, kc);
      __syncthreads();
      if (f_j0 < j_end) fetch_next();  // in flight during the arithmetic below
      if (NORMS) b_sq_norms(b2, Bs, kc, slab == 0);
      if (DOTACC) accumulate_slab<F_DOT>(acc, As, Bs, rg, lane, kc);
      if (L1ACC) accumulate_slab<F_L1>(acc1, As, Bs, rg, lane, kc);
    }
    if (NORMS) __syncthreads();  // b2 complete

    float av[RM] = {}, bv[JN] = {};
    if (NORMS) {
      const float4 a24 = *reinterpret_cast<const float4*>(&a2[rg * RM]);
      const float4 b24 = *reinterpret_cast<const float4*>(&b2[lane * JN]);
      av[0] = a24.x; av[1] = a24.y; av[2] = a24.z; av[3] = a24.w;
      bv[0] = b24.x; bv[1] = b24.y; bv[2] = b24.z; bv[3] = b24.w;
    }
    const int cols = n - j0 < TN ? (int)(n - j0) : TN;  // live columns of this tile
    epilogue(j0, acc, acc1, av, bv, cols);
  }
}

// Zero the values of columns past the ragged end of B.
__device__ __forceinline__ void mask_cols(float (&kv)[RM][JN], int lane, int cols) {
#pragma unroll
  for (int j = 0; j < JN; ++j) {
    if (lane * JN + j < cols) continue;
#pragma unroll
    for (int i = 0; i < RM; ++i) kv[i][j] = 0.0f;
  }
}

// Round every value of the tile to bf16 (the bf16 matmul operand).
__device__ __forceinline__ void round_tile(float (&kv)[RM][JN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) kv[i][j] = round_bf16(kv[i][j]);
}

// One kernel's share of a group of the t = 1 sweep: o[r] += K_KID(a_r, b_j)
// * vw[j] over the thread's R x J pairs, vw = v * w_k (bf16: each K value
// and each vw rounded to bf16, the TPU kernel's operands).  PRE: acc holds
// the clamped l2 distance already (no dot / cos kernel in the launch).
template <int KID, bool PRE, bool BF16>
__device__ __forceinline__ void weighted_group(float (&o)[t1::R], const float (&acc)[t1::R][t1::J],
                                               const float (&acc1)[t1::R][t1::J],
                                               const float (&a2)[t1::R], const float (&b2)[t1::J],
                                               const float (&vw)[t1::J], const MapConst& mc) {
  constexpr int FAM = family_of(KID);
#pragma unroll
  for (int j = 0; j < t1::J; ++j)
#pragma unroll
    for (int r = 0; r < t1::R; ++r) {
      const float base = FAM == F_L2 ? (PRE ? acc[r][j]
                                            : fmaxf(fmaf(-2.0f, acc[r][j], a2[r] + b2[j]), 0.0f))
                       : FAM == F_L1 ? acc1[r][j]
                                     : base_value<FAM>(acc[r][j], a2[r], b2[j]);
      float kv = t1::kernel_map_t1<KID>(base, mc);
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
                           int64_t n_pad, int d, int P, MultiSpec spec, bool l2_pre,
                           bool accumulate) {
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
      a, bp, m, d, P, 0, n_pad, l2_pre, t1_smem,
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

// ---------------------------------------------------------------------------
// The column path: the weighted matvec for t > 1 (the tune's matvec_cols).
// A block of CTHREADS threads owns CM rows of A and cw <= TCB = CCG * CO
// columns of V; it walks B in tiles of CN rows.  Per tile, thread (rg, cg) = (tid /
// CCG, tid % CCG) forms the family accumulators of rows rg*CRO .. +7
// against B row cg and writes their q kernel values to ks; then it
// multiplies its CRO x CO output tile (rows rg*CRO .., columns cg*CO ..) by
// ks and by the V tile, scaled by its columns' weights in registers.
// ---------------------------------------------------------------------------

constexpr int CTHREADS = 64;
constexpr int CCG = 16;                      // column groups
constexpr int CRO = 8;                       // output rows a thread owns
constexpr int KG = 3;                        // kernels whose weights sit in registers at once
constexpr int CM = (CTHREADS / CCG) * CRO;   // 32 rows of A per block
constexpr int CN = CCG;                      // 16 rows of B per tile
constexpr int TPR = CTHREADS / CN;           // threads that copy one B / V row
constexpr int CO_MID = 8, CO_WIDE = 10;      // columns a thread owns: TCB 128 or 160

// The column path's shared memory; the q kernel tiles ks[q][CN][CM] and the
// q weight rows ws[q][TCB] of the column block follow it (dynamic).
template <int TCB>
struct alignas(16) ColsSmem {
  float vraw[2][CN][TCB];  // V tiles, double-buffered by cp.async
  float bs[2][DC][CN];     // B slabs, transposed, double-buffered by cp.async
  float as[DC][CM];        // A: all of d when d <= DC, else the current slab
  float pair[2][CRO][CTHREADS];  // each thread's dot and l1 accumulators of a tile
  float a2[CM];
  MultiTable tab;
};

template <int TCB>
constexpr size_t cols_smem_bytes(int q) {
  return sizeof(ColsSmem<TCB>) + sizeof(float) * q * (CN * CM + TCB);
}

// Copy 4 (16) bytes from device to shared memory asynchronously; with
// `full` false nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most one group of this thread's copies is in flight.
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// out (m, t) (+)= (sum_i w_i K_i(A, B)) @ V, t > 1: grid.y block y owns
// columns [y cw, min((y + 1) cw, t)), cw <= TCB.  A, B and V are f32 (for BF16, holding bf16-rounded values); w:
// (q, t) f32 rows in device memory, or null for the static (q,) weights of
// `spec`.  v16: t % 4 == 0, cw % 4 == 0 and v 16-byte aligned (V copied
// in float4).
template <bool BF16, bool DOTACC, bool L1ACC, int CO>
__global__ void __launch_bounds__(CTHREADS, 6)
kernel_matvec_cols_kernel(const float* __restrict__ a, const float* __restrict__ b,
                          const float* __restrict__ v, const float* __restrict__ w,
                          float* __restrict__ out, int64_t m, int64_t n, int d, int t,
                          int cw, MultiSpec spec, bool v16, bool accumulate) {
  constexpr int TCB = CCG * CO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ColsSmem<TCB>& S = *reinterpret_cast<ColsSmem<TCB>*>(smem_raw);
  const int q = spec.q;
  float (*ks)[CN][CM] = reinterpret_cast<float (*)[CN][CM]>(smem_raw + sizeof(ColsSmem<TCB>));
  float (*ws)[TCB] = reinterpret_cast<float (*)[TCB]>(&ks[q][0][0]);
  const int tid = threadIdx.x, rg = tid / CCG, cg = tid % CCG;
  const int64_t r0 = (int64_t)blockIdx.x * CM;
  const int c0 = blockIdx.y * cw;
  const int tc = min(cw, t - c0);
  const int ns = (d + DC - 1) / DC;  // slabs per B tile
  const bool a_once = ns == 1;

  auto stage_as = [&](int k0, int kc) {
    for (int idx = tid; idx < CM * kc; idx += CTHREADS) {
      const int r = idx % CM, k = idx / CM;
      const int64_t g = r0 + r;
      S.as[k][r] = g < m ? a[g * d + k0 + k] : 0.0f;
    }
  };
  load_table(S.tab, spec);
  if (DOTACC)
    for (int r = tid; r < CM; r += CTHREADS) {
      float s = 0.0f;
      const int64_t g = r0 + r;
      if (g < m)
        for (int k = 0; k < d; ++k) s = fmaf(a[g * d + k], a[g * d + k], s);
      S.a2[r] = s;
    }
  if (a_once) stage_as(0, d);
  __syncthreads();  // tab
  for (int idx = tid; idx < q * TCB; idx += CTHREADS) {
    const int k = idx / TCB, c = idx % TCB;
    ws[k][c] = c < tc ? (w ? w[(int64_t)k * t + c0 + c] : S.tab.w[k]) : 0.0f;
  }

  // The copy pipeline.  A unit is one B slab, with the V tile on a tile's
  // first slab; unit u + 1 is in flight while unit u is computed on.
  int64_t f_j0 = 0;
  int f_slab = 0, f_ub = 0, f_vb = 0;
  auto issue_next = [&]() {
    if (f_j0 < n) {
      const int k0 = f_slab * DC, kc = min(DC, d - k0);
      {  // B rows j0 + tid % CN, features k0 + tid / CN + TPR r
        const int jj = tid % CN;
        const int64_t g = f_j0 + jj;
        const float* brow = b + (g < n ? g : 0) * d + k0;
#pragma unroll
        for (int r = 0; r < DC / TPR; ++r) {
          const int k = tid / CN + TPR * r;
          const bool ok = k < kc && g < n;
          cp_async4(&S.bs[f_ub][k][jj], ok ? brow + k : b, ok);
        }
      }
      if (f_slab == 0) {  // V row j0 + tid / TPR, TPR threads a row
        const int jj = tid / TPR, lane = tid % TPR;
        const int64_t g = f_j0 + jj;
        const float* vrow = v + (g < n ? g : 0) * t + c0;
        if (v16) {
#pragma unroll
          for (int u = 0; u < TCB / 4 / TPR; ++u) {
            const int c = 4 * (lane + TPR * u);
            const bool ok = g < n && c < tc;
            cp_async16(&S.vraw[f_vb][jj][c], ok ? vrow + c : v, ok);
          }
        } else {
#pragma unroll
          for (int u = 0; u < TCB / TPR; ++u) {
            const int c = lane + TPR * u;
            const bool ok = g < n && c < tc;
            cp_async4(&S.vraw[f_vb][jj][c], ok ? vrow + c : v, ok);
          }
        }
      }
      f_ub ^= 1;
      if (++f_slab == ns) {
        f_slab = 0;
        f_j0 += CN;
        f_vb ^= 1;
      }
    }
    cp_async_commit();  // an empty group past the end keeps the wait uniform
  };
  issue_next();

  float o[CRO][CO] = {};
  int ub = 0, vb = 0;
  for (int64_t j0 = 0; j0 < n; j0 += CN, vb ^= 1) {
    float acc[CRO] = {}, acc1[CRO] = {}, b2 = 0.0f;
    for (int slab = 0; slab < ns; ++slab, ub ^= 1) {
      const int k0 = slab * DC, kc = min(DC, d - k0);
      // the buffer refilled next was read by the previous slab of this tile
      // (the previous tile's last slab is covered by its trailing sync)
      if (slab > 0) __syncthreads();
      issue_next();
      cp_async_wait1();
      if (!a_once) stage_as(k0, kc);
      __syncthreads();  // every thread's copies of this unit are visible
#pragma unroll 4
      for (int k = 0; k < kc; ++k) {
        float ak[CRO];
#pragma unroll
        for (int i4 = 0; i4 < CRO / 4; ++i4) {
          const float4 a4 = *reinterpret_cast<const float4*>(&S.as[k][rg * CRO + 4 * i4]);
          ak[4 * i4] = a4.x; ak[4 * i4 + 1] = a4.y; ak[4 * i4 + 2] = a4.z; ak[4 * i4 + 3] = a4.w;
        }
        const float bk = S.bs[ub][k][cg];
        if (DOTACC) b2 = fmaf(bk, bk, b2);  // the norm of B row cg, kept by each row group
#pragma unroll
        for (int i = 0; i < CRO; ++i) {
          if (DOTACC) acc[i] = fmaf(ak[i], bk, acc[i]);
          if (L1ACC) acc1[i] += fabsf(ak[i] - bk);
        }
      }
    }

    // the q kernel tiles, each pair's values formed once for all columns;
    // the accumulators go through the thread's own slots of S.pair so the
    // maps run on four pairs at a time beside the 80 output registers
#pragma unroll
    for (int i = 0; i < CRO; ++i) {
      if (DOTACC) S.pair[0][i][tid] = acc[i];
      if (L1ACC) S.pair[1][i][tid] = acc1[i];
    }
    const bool live = j0 + cg < n;  // B row cg of this tile lies before the ragged end
#pragma unroll 1
    for (int k = 0; k < q; ++k) {
#pragma unroll 1
      for (int h = 0; h < CRO; h += 4) {
        float ac[4][1], ac1[4][1], av[4], bv[1] = {b2}, kv[4][1];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ac[i][0] = DOTACC ? S.pair[0][h + i][tid] : 0.0f;
          ac1[i][0] = L1ACC ? S.pair[1][h + i][tid] : 0.0f;
          av[i] = DOTACC ? S.a2[rg * CRO + h + i] : 0.0f;
        }
        tile_map(S.tab.kid[k], kv, ac, ac1, av, bv, S.tab.mc[k]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i][0] = live ? kv[i][0] : 0.0f;
          if (BF16) kv[i][0] = round_bf16(kv[i][0]);
        }
        *reinterpret_cast<float4*>(&ks[k][cg][rg * CRO + h]) =
            make_float4(kv[0][0], kv[1][0], kv[2][0], kv[3][0]);
      }
    }
    __syncthreads();  // ks complete

    // o += K_k (V * w_k), KG kernels at a time: per B row, CO / 2 float2 of
    // V and, for each kernel, CRO / 4 float4 of K_k feed CRO x CO FMAs; the
    // weights of the group's kernels stay in registers
#pragma unroll 1
    for (int kb = 0; kb < q; kb += KG) {
      float wk[KG][CO];
#pragma unroll
      for (int g = 0; g < KG; ++g)
#pragma unroll
        for (int u = 0; u < CO / 2; ++u) {
          const float2 x = kb + g < q ? *reinterpret_cast<const float2*>(&ws[kb + g][cg * CO + 2 * u])
                                      : make_float2(0.0f, 0.0f);
          wk[g][2 * u] = x.x;
          wk[g][2 * u + 1] = x.y;
        }
      const float* vp = &S.vraw[vb][0][cg * CO];
#pragma unroll 1
      for (int j = 0; j < CN; ++j) {
        float vv[CO];
#pragma unroll
        for (int u = 0; u < CO / 2; ++u) {
          const float2 x = *reinterpret_cast<const float2*>(vp + j * TCB + 2 * u);
          vv[2 * u] = x.x;
          vv[2 * u + 1] = x.y;
        }
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          if (kb + g >= q) break;
          const float* kp = &ks[kb + g][j][rg * CRO];
          float kk[CRO];
#pragma unroll
          for (int i4 = 0; i4 < CRO / 4; ++i4) {
            const float4 k4 = *reinterpret_cast<const float4*>(kp + 4 * i4);
            kk[4 * i4] = k4.x; kk[4 * i4 + 1] = k4.y; kk[4 * i4 + 2] = k4.z; kk[4 * i4 + 3] = k4.w;
          }
          float vw[CO];
#pragma unroll
          for (int c = 0; c < CO; ++c) vw[c] = BF16 ? round_bf16(vv[c] * wk[g][c]) : vv[c] * wk[g][c];
#pragma unroll
          for (int i = 0; i < CRO; ++i)
#pragma unroll
            for (int c = 0; c < CO; ++c) o[i][c] = fmaf(kk[i], vw[c], o[i][c]);
        }
      }
    }
    __syncthreads();  // readers of ks, the V tile and the B slab are done
  }

#pragma unroll
  for (int i = 0; i < CRO; ++i) {
    const int64_t row = r0 + rg * CRO + i;
    if (row >= m) continue;
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      const int col = cg * CO + c;
      if (col >= tc) continue;
      float* dst = out + row * t + c0 + col;
      *dst = accumulate ? *dst + o[i][c] : o[i][c];
    }
  }
}

// out (q, m, t): out[k] = K_k(A, B) @ V for the q <= QC kernels of `spec`.
template <typename T, bool DOTACC, bool L1ACC, int TC>
__global__ void __launch_bounds__(THREADS)
kernel_components_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         const T* __restrict__ v, float* __restrict__ out, int64_t m,
                         int64_t n, int d, int t, MultiSpec spec) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  __shared__ __align__(16) float As[DC][TM];
  __shared__ __align__(16) float Bs[DC][TN];
  __shared__ __align__(16) float Vs[TC][TN];
  __shared__ __align__(16) float a2[TM];
  __shared__ __align__(16) float b2[TN];
  __shared__ MultiTable tab;
  const int rg = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int c0 = blockIdx.y * TC;
  const int tc = min(TC, t - c0);
  const int q = spec.q;

  load_table(tab, spec);
  __syncthreads();

  float o[QC][RM][TC] = {};
  sweep_b<T, DOTACC, L1ACC, TC>(
      a, b, v, m, n, d, t, c0, tc, 0, n, As, Bs, Vs, a2, b2,
      [&](int64_t, const float (&acc)[RM][JN], const float (&acc1)[RM][JN],
          const float (&av)[RM], const float (&bv)[JN], int cols) {
#pragma unroll
        for (int k = 0; k < QC; ++k) {
          if (k >= q) break;
          float kv[RM][JN];
          tile_map(tab.kid[k], kv, acc, acc1, av, bv, tab.mc[k]);
          mask_cols(kv, lane, cols);
          if (BF16) round_tile(kv);
#pragma unroll
          for (int c = 0; c < TC; ++c) {
            const float4 v4 = *reinterpret_cast<const float4*>(&Vs[c][lane * JN]);
#pragma unroll
            for (int i = 0; i < RM; ++i)
              o[k][i][c] = fmaf(kv[i][3], v4.w, fmaf(kv[i][2], v4.z,
                           fmaf(kv[i][1], v4.y, fmaf(kv[i][0], v4.x, o[k][i][c]))));
          }
        }
      });

#pragma unroll
  for (int k = 0; k < QC; ++k) reduce_lanes(o[k]);
  if (lane == 0) {
    const int64_t r0 = (int64_t)blockIdx.x * TM;
#pragma unroll
    for (int k = 0; k < QC; ++k) {
      if (k >= q) break;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int64_t row = r0 + rg * RM + i;
        if (row < m)
          for (int c = 0; c < tc; ++c) out[((int64_t)k * m + row) * t + c0 + c] = o[k][i][c];
      }
    }
  }
}

constexpr int STRIP = 8;  // B tiles per block of the block kernel

// out (m, n) (+)= sum_k w_k K_k(A, B), static weights in `spec`; a block
// owns TM rows x STRIP B tiles of the output.
template <typename T, bool DOTACC, bool L1ACC>
__global__ void __launch_bounds__(THREADS)
kernel_block_multi_kernel(const T* __restrict__ a, const T* __restrict__ b,
                          float* __restrict__ out, int64_t m, int64_t n, int d,
                          MultiSpec spec, bool vec4, bool accumulate) {
  __shared__ __align__(16) float As[DC][TM];
  __shared__ __align__(16) float Bs[DC][TN];
  __shared__ __align__(16) float a2[TM];
  __shared__ __align__(16) float b2[TN];
  __shared__ MultiTable tab;
  const int rg = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int64_t r0 = (int64_t)blockIdx.x * TM;
  const int64_t c_begin = (int64_t)blockIdx.y * (STRIP * TN);
  const int64_t c_end = n - c_begin < STRIP * TN ? n : c_begin + STRIP * TN;
  const int q = spec.q;

  load_table(tab, spec);  // read after the sweep's first __syncthreads()
  sweep_b<T, DOTACC, L1ACC, 0>(
      a, b, static_cast<const T*>(nullptr), m, n, d, 1, 0, 0, c_begin, c_end, As, Bs, nullptr,
      a2, b2,
      [&](int64_t j0, const float (&acc)[RM][JN], const float (&acc1)[RM][JN],
          const float (&av)[RM], const float (&bv)[JN], int) {
        float ksum[RM][JN] = {};
#pragma unroll 1
        for (int k = 0; k < q; ++k) {
          float kv[RM][JN];
          tile_map(tab.kid[k], kv, acc, acc1, av, bv, tab.mc[k]);
          const float wk = tab.w[k];
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < JN; ++j) ksum[i][j] = fmaf(wk, kv[i][j], ksum[i][j]);
        }

        const int64_t col = j0 + lane * JN;
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int64_t row = r0 + rg * RM + i;
          if (row >= m) continue;
          float* dst = out + row * n + col;
          if (vec4 && col + JN <= n) {
            float4 s = make_float4(ksum[i][0], ksum[i][1], ksum[i][2], ksum[i][3]);
            if (accumulate) {
              const float4 prev = *reinterpret_cast<const float4*>(dst);
              s.x += prev.x; s.y += prev.y; s.z += prev.z; s.w += prev.w;
            }
            *reinterpret_cast<float4*>(dst) = s;
          } else {
#pragma unroll
            for (int j = 0; j < JN; ++j)
              if (col + j < n) dst[j] = accumulate ? dst[j] + ksum[i][j] : ksum[i][j];
          }
        }
      });
}

// ---------------------------------------------------------------------------
// C launchers: launch on `stream` and return cudaGetLastError() (0 = ok).
// kids / sigmas / weights are HOST arrays of q entries; bf16 != 0 reads the
// operands as __nv_bfloat16, else as float.  d >= 1, t >= 1.
// ---------------------------------------------------------------------------

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

// Instantiate LAUNCH(T, DOTACC, L1ACC) for the families present.
#define PK_DISPATCH_FAMILIES(LAUNCH, T) \
  if (dot && l1) {                      \
    LAUNCH(T, true, true);              \
  } else if (l1) {                      \
    LAUNCH(T, false, true);             \
  } else {                              \
    LAUNCH(T, true, false);             \
  }

template <typename T, bool DA, bool LA>
static cudaError_t launch_multi_t1(const T* a, const T* b, const T* v, const float* w, float* out,
                                   int64_t m, int64_t n, int d, const MultiSpec& spec,
                                   bool l2_pre, bool accumulate, float* scratch, cudaStream_t s) {
  cudaError_t err = t1::launch_pack(b, v, scratch, n, d, 1.0f, s);
  if (err != cudaSuccess) return err;
  const t1::PackShape ps = t1::pack_shape(n, d);
  const unsigned blocks = (unsigned)((m + t1::TM - 1) / t1::TM);
#define PK_T1(NF, SLAB)                                                                      \
  err = t1::launch_sweep(kernel_matvec_multi_kernel<T, DA, LA, NF, SLAB>, blocks,            \
                         t1::smem_bytes(NF, SLAB), s, a, (const float*)scratch, w, out, m,   \
                         ps.rows, d, ps.stride, spec, l2_pre, accumulate)
  PK_T1_DISPATCH_NF(d, PK_T1)
#undef PK_T1
  return err;
}

// t == 1: w is a device (q, 1) f32 column, or null to use the host
// `weights` (q,).  accumulate != 0 adds to `out` instead of overwriting it.
// `scratch`: sweep_t1_scratch_floats(n, d) floats of device memory (B
// packed with its norms and v).
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
  bool l2_pre = true;  // every kernel of the dot accumulator is an l2 kernel
  for (int i = 0; i < q; ++i)
    if (family_of(kids[i]) == F_DOT || family_of(kids[i]) == F_COS) l2_pre = false;
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
  constexpr int TCB_WIDE = CCG * CO_WIDE;
  const int gy = (t + TCB_WIDE - 1) / TCB_WIDE;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const int cw = ((t + gy - 1) / gy + 3) / 4 * 4;  // columns a block owns
  const bool mid = cw <= CCG * CO_MID;
  const dim3 grid((unsigned)((m + CM - 1) / CM), (unsigned)gy);
  const bool v16 = t % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  // above the 48 KB a block gets by default (q > 5 at 160 columns) the
  // launch opts in first; a refusal is returned, and nothing is launched
#define PK_LAUNCH_CO(BF, DA, LA, CO)                                                          \
  do {                                                                                        \
    const size_t bytes = cols_smem_bytes<CCG * CO>(q);                                        \
    if (bytes > 48 * 1024)                                                                    \
      err = cudaFuncSetAttribute(kernel_matvec_cols_kernel<BF, DA, LA, CO>,                   \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);    \
    if (err == cudaSuccess)                                                                   \
      kernel_matvec_cols_kernel<BF, DA, LA, CO><<<grid, CTHREADS, bytes, s>>>(                \
          a, b, v, w, out, m, n, d, t, cw, spec, v16, accumulate != 0);                       \
  } while (0)
#define PK_LAUNCH(BF, DA, LA)          \
  if (mid)                             \
    PK_LAUNCH_CO(BF, DA, LA, CO_MID);  \
  else                                 \
    PK_LAUNCH_CO(BF, DA, LA, CO_WIDE)
  if (bf16) {
    PK_DISPATCH_FAMILIES(PK_LAUNCH, true);
  } else {
    PK_DISPATCH_FAMILIES(PK_LAUNCH, false);
  }
#undef PK_LAUNCH
#undef PK_LAUNCH_CO
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// out: (q, m, t) f32, q <= QC.
extern "C" int kernel_matvec_components_launch(const void* a, const void* b, const void* v,
                                               void* out, long long m, long long n, int d,
                                               int t, int q, const int* kids,
                                               const float* sigmas, int bf16, void* stream) {
  if (m < 0 || n < 0 || d < 1 || t < 1) return (int)cudaErrorInvalidValue;
  MultiSpec spec;
  bool dot, l1;
  if (!make_spec(spec, q, QC, kids, sigmas, nullptr, &dot, &l1)) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const int tcols = t == 1 ? 1 : TCC;
  const int gy = (t + tcols - 1) / tcols;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((m + TM - 1) / TM), (unsigned)gy);
  cudaStream_t s = (cudaStream_t)stream;
#define PK_LAUNCH(T, DA, LA)                                                                  \
  if (t == 1)                                                                                 \
    kernel_components_kernel<T, DA, LA, 1><<<grid, THREADS, 0, s>>>(                          \
        (const T*)a, (const T*)b, (const T*)v, (float*)out, m, n, d, t, spec);                \
  else                                                                                        \
    kernel_components_kernel<T, DA, LA, TCC><<<grid, THREADS, 0, s>>>(                        \
        (const T*)a, (const T*)b, (const T*)v, (float*)out, m, n, d, t, spec)
  if (bf16) {
    PK_DISPATCH_FAMILIES(PK_LAUNCH, __nv_bfloat16);
  } else {
    PK_DISPATCH_FAMILIES(PK_LAUNCH, float);
  }
#undef PK_LAUNCH
  return (int)cudaGetLastError();
}

// out: (m, n) f32; weights: host (q,).  accumulate != 0 adds to `out`.
extern "C" int kernel_block_multi_launch(const void* a, const void* b, void* out, long long m,
                                         long long n, int d, int q, const int* kids,
                                         const float* sigmas, const float* weights, int bf16,
                                         int accumulate, void* stream) {
  if (m < 0 || n < 0 || d < 1 || !weights) return (int)cudaErrorInvalidValue;
  MultiSpec spec;
  bool dot, l1;
  if (!make_spec(spec, q, QMAX, kids, sigmas, weights, &dot, &l1))
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  const long long gy = (n + STRIP * TN - 1) / (STRIP * TN);
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((m + TM - 1) / TM), (unsigned)gy);
  const bool vec4 = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
#define PK_LAUNCH(T, DA, LA)                                                              \
  kernel_block_multi_kernel<T, DA, LA><<<grid, THREADS, 0, s>>>(                          \
      (const T*)a, (const T*)b, (float*)out, m, n, d, spec, vec4, accumulate != 0)
  if (bf16) {
    PK_DISPATCH_FAMILIES(PK_LAUNCH, __nv_bfloat16);
  } else {
    PK_DISPATCH_FAMILIES(PK_LAUNCH, float);
  }
#undef PK_LAUNCH
  return (int)cudaGetLastError();
}
