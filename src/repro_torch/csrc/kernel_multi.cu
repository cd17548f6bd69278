// The three weighted-sum (multi-kernel) kernels: q base kernels K_i with
// per-kernel bandwidths, evaluated from ONE pass over the (A, B) tiles.
//
// Replaces the TPU kernels of src/repro/kernels/multi.py:
//   * kernel_matvec_multi_launch       <- kernel_matvec_multi_pallas
//     out = (sum_i w_i K_i(A, B)) @ V, w (q,) or per column (q, t);
//   * kernel_matvec_components_launch  <- kernel_matvec_components_pallas
//     out[i] = K_i(A, B) @ V, stacked (q, m, t);
//   * kernel_block_multi_launch        <- kernel_block_multi_pallas
//     out = sum_i w_i K_i(A, B) materialised, static weights.
//
// Design.  The tiling, staging, prefetch and shuffle reduction are those of
// kernel_matvec.cu / kernel_block.cu (kernel_common.cuh), and one sweep over
// the B tiles (sweep_b) serves all three kernels.  What is new:
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
//     The map is chosen per kernel by a switch that is uniform across the
//     block, once per 4 x 4 register tile.
//   * Per-column weights.  V is pre-scaled per kernel: w_ic (K_i v)[:, c]
//     == (K_i (v * w_i))[:, c], so one accumulator per (row, column) serves
//     all q kernels.  The block's weight rows for its column chunk sit in
//     shared memory.  A block computes the distances once per column chunk
//     (TCW columns), so a t = 160 matvec recomputes them 20 times.
//
// Bound on the H100: operations, except the block (its output write).  At
// the refit's G_B (50,000 x 10^6, d = 9, q = 3 with l2 + l1 families,
// t = 1) a pair costs ~70 f32 operations; at the tune's matvec_cols
// (20,000^2 x 160 columns) the q x t products dominate.
//
// Precision (the TPU kernels' bf16 semantics): with bf16 operands, the
// weighted matvec rounds each K_i tile and each V * w_i to bf16 before their
// product (accumulated in f32); the components kernel rounds only K_i (V is
// already bf16); the block rounds only the operands and keeps the weighted
// sum of f32 tiles in f32.
//
// Deterministic: no atomics; the 16 partial sums of a row are reduced by a
// fixed butterfly of shuffles, and group launches are ordered on the stream.
#include "kernel_common.cuh"

using namespace pk;

constexpr int QMAX = 8;  // kernels per launch (weighted matvec, block)
constexpr int QC = 4;    // kernels per launch (components: q x RM x TC registers)
constexpr int TCW = 8;   // column chunk of the weighted matvec for t > 1
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

// kv[i][j] = K_KID for the thread's RM x JN pairs, from the accumulators of
// its family (acc: sum a.b, acc1: sum |a - b|) and the squared norms.
template <int KID>
__device__ __forceinline__ void tile_map_k(float (&kv)[RM][JN], const float (&acc)[RM][JN],
                                           const float (&acc1)[RM][JN], const float (&av)[RM],
                                           const float (&bv)[JN], const MapConst& mc) {
  constexpr int FAM = family_of(KID);
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j)
      kv[i][j] = kernel_map<KID>(
          base_value<FAM>(FAM == F_L1 ? acc1[i][j] : acc[i][j], av[i], bv[j]), mc);
}

// The same for a runtime kernel id (uniform across the block).
__device__ __forceinline__ void tile_map(int kid, float (&kv)[RM][JN], const float (&acc)[RM][JN],
                                         const float (&acc1)[RM][JN], const float (&av)[RM],
                                         const float (&bv)[JN], const MapConst& mc) {
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

// The sweep shared by the three kernels: for each 64-row tile of B in
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

// out (m, t) (+)= (sum_i w_i K_i(A, B)) @ V for one column chunk per
// grid.y block; w: (q, t) f32 rows in device memory, or null for the
// static (q,) weights of `spec`.
template <typename T, bool DOTACC, bool L1ACC, int TC>
__global__ void __launch_bounds__(THREADS)
kernel_matvec_multi_kernel(const T* __restrict__ a, const T* __restrict__ b,
                           const T* __restrict__ v, const float* __restrict__ w,
                           float* __restrict__ out, int64_t m, int64_t n, int d, int t,
                           MultiSpec spec, bool accumulate) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  __shared__ __align__(16) float As[DC][TM];
  __shared__ __align__(16) float Bs[DC][TN];
  __shared__ __align__(16) float Vs[TC][TN];
  __shared__ __align__(16) float a2[TM];
  __shared__ __align__(16) float b2[TN];
  __shared__ MultiTable tab;
  __shared__ float Ws[QMAX][TC];  // the weight rows of this column chunk
  const int rg = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int c0 = blockIdx.y * TC;
  const int tc = min(TC, t - c0);
  const int q = spec.q;

  load_table(tab, spec);
  if (threadIdx.x < TC) {
    const int c = threadIdx.x;
#pragma unroll
    for (int i = 0; i < QMAX; ++i)
      Ws[i][c] = (i < q && c < tc) ? (w ? w[(int64_t)i * t + c0 + c] : spec.w[i]) : 0.0f;
  }
  __syncthreads();

  float o[RM][TC] = {};
  sweep_b<T, DOTACC, L1ACC, TC>(
      a, b, v, m, n, d, t, c0, tc, 0, n, As, Bs, Vs, a2, b2,
      [&](int64_t, const float (&acc)[RM][JN], const float (&acc1)[RM][JN],
          const float (&av)[RM], const float (&bv)[JN], int cols) {
#pragma unroll 1
        for (int k = 0; k < q; ++k) {
          float kv[RM][JN];
          tile_map(tab.kid[k], kv, acc, acc1, av, bv, tab.mc[k]);
          mask_cols(kv, lane, cols);
          if (BF16) round_tile(kv);
#pragma unroll
          for (int c = 0; c < TC; ++c) {
            const float4 v4 = *reinterpret_cast<const float4*>(&Vs[c][lane * JN]);
            const float wk = Ws[k][c];
            float vw[JN] = {v4.x * wk, v4.y * wk, v4.z * wk, v4.w * wk};
            if (BF16) {
#pragma unroll
              for (int j = 0; j < JN; ++j) vw[j] = round_bf16(vw[j]);
            }
#pragma unroll
            for (int i = 0; i < RM; ++i)
              o[i][c] = fmaf(kv[i][3], vw[3], fmaf(kv[i][2], vw[2],
                        fmaf(kv[i][1], vw[1], fmaf(kv[i][0], vw[0], o[i][c]))));
          }
        }
      });

  reduce_lanes(o);
  if (lane == 0) {
    const int64_t r0 = (int64_t)blockIdx.x * TM;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int64_t row = r0 + rg * RM + i;
      if (row < m)
        for (int c = 0; c < tc; ++c) {
          float* dst = out + row * t + c0 + c;
          *dst = accumulate ? *dst + o[i][c] : o[i][c];
        }
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

// w: device (q, t) f32 rows, or null to use the host `weights` (q,) for
// every column.  accumulate != 0 adds to `out` instead of overwriting it.
extern "C" int kernel_matvec_multi_launch(const void* a, const void* b, const void* v,
                                          const float* w, void* out, long long m, long long n,
                                          int d, int t, int q, const int* kids,
                                          const float* sigmas, const float* weights, int bf16,
                                          int accumulate, void* stream) {
  if (m < 0 || n < 0 || d < 1 || t < 1) return (int)cudaErrorInvalidValue;
  MultiSpec spec;
  bool dot, l1;
  if (!make_spec(spec, q, QMAX, kids, sigmas, weights, &dot, &l1) || (!w && !weights))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const int tcols = t == 1 ? 1 : TCW;
  const int gy = (t + tcols - 1) / tcols;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((m + TM - 1) / TM), (unsigned)gy);
  cudaStream_t s = (cudaStream_t)stream;
#define PK_LAUNCH(T, DA, LA)                                                                \
  if (t == 1)                                                                               \
    kernel_matvec_multi_kernel<T, DA, LA, 1><<<grid, THREADS, 0, s>>>(                      \
        (const T*)a, (const T*)b, (const T*)v, w, (float*)out, m, n, d, t, spec,            \
        accumulate != 0);                                                                   \
  else                                                                                      \
    kernel_matvec_multi_kernel<T, DA, LA, TCW><<<grid, THREADS, 0, s>>>(                    \
        (const T*)a, (const T*)b, (const T*)v, w, (float*)out, m, n, d, t, spec,            \
        accumulate != 0)
  if (bf16) {
    PK_DISPATCH_FAMILIES(PK_LAUNCH, __nv_bfloat16);
  } else {
    PK_DISPATCH_FAMILIES(PK_LAUNCH, float);
  }
#undef PK_LAUNCH
  return (int)cudaGetLastError();
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
