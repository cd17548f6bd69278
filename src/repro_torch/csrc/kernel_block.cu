// K(A, B) materialised: out[i, j] = k(A[i], B[j]), (m, d) x (n, d) -> (m, n) f32.
//
// Replaces the TPU kernel src/repro/kernels/kernel_block.py:kernel_block_pallas
// (body _block_body).  Where the TPU version padded A/B to 256-row tiles and
// d to the 32-wide slab, this kernel masks the ragged edges itself.
//
// Bound on the H100: the output.  Each entry costs O(d) operations and is
// written once as 4 bytes, so for the main path's K_BB (b = 50,000, d = 9,
// 10 GB of f32) the write at 3.35 TB/s is the floor (about 3 ms); a pass
// that only stores (fill_) is the yardstick on a given card.  For a column
// or a row of K (RPCholesky's pivot column, 10^6 x 1; SAP's row, 1 x n)
// the floor is reading the many rows once (36 MB at 10^6 x 9).
//
// Three routes, one launch each, chosen by the wrapper from the shape and
// from whether b is a (kernels/kernel_block.py:block_route):
//
//  * tile (block_tile_kernel, sym = false): a persistent grid of one
//    512-thread block an SM walks the 128 x 128 output tiles in row-band
//    order (block g takes every G-th tile from the g-th, G blocks).  Per
//    tile the A and B rows are staged feature-major in shared memory, KS
//    features at a time (at d <= KS the next tile's rows are loaded into
//    registers while this tile is computed); each thread forms an 8 x 4
//    register tile (rows 4ty.., 64+4ty.., columns 4tx..: three float4
//    shared loads per 32 pairs a feature), maps it and writes it into one
//    of two staging buffers of 128 rows.  Then each warp stores whole staged rows,
//    float4 a lane (512 bytes a row of a tile) with the streaming hint
//    (st.global.cs), and goes on to the next tile while its stores drain.
//    Where the 16-byte rule fails (n % 4 != 0, or an unaligned output) the
//    threads store floats, coalesced, in the same launch.  Bulk copies
//    (cp.async.bulk, shared -> global, one 512-byte row a copy, from a ring
//    of staging buffers) were measured slower on the H100 at K_BB, for the
//    tile and its mirror or for the mirror alone, and so were stores
//    without the hint (PERF.md): the stores of 512-byte tile rows,
//    not who issues them, bound the route.
//  * symmetric (the same kernel, sym = true; b is a): only the tiles on
//    and above the diagonal are computed, and each one above it is also
//    staged transposed in a second buffer (float4 of four rows of a
//    column) and stored as 128 rows of the mirror tile.  The pair work
//    halves; the writes stay m * m * 4 bytes.
//  * skinny (block_skinny_kernel): at most SK_QMAX = 64 columns (the pivot
//    column) or rows (SAP's row).  One thread an output row (column), the
//    few rows of the other operand and their norms in shared memory
//    (transposed, read as broadcast float4), the many rows read once, a
//    thread its own row's slab of KS features into registers (a warp's
//    loads cover its rows' contiguous bytes); at most 4 few rows a launch
//    keeps 4 accumulators a thread and 10 blocks an SM in flight, more keep
//    64 and 4.  Few columns: the block's output rows are one contiguous
//    range, staged in shared memory and written as whole lines; few rows:
//    each output row is written directly, consecutive threads on
//    consecutive columns.  The wrapper reads SK_QMAX from the library
//    (kernel_block_skinny_max) as its threshold: at 10^6 rows the skinny
//    routes beat the tile route at every width timed, 1 to 64
//    (tools/time_torch_kernels.py --crossover on the H100, PERF.md).  That
//    crossover was measured at 10^6 rows only; a caller sending few
//    columns against far fewer rows (the samplers' K(X, X_s), small
//    blocks) should measure it there before trusting it.
//
// Shared-memory layout of a staging buffer: row r (a row of the tile, or
// of its transpose) starts at float 132 r + 4 (r / 4), so rows stay 16-byte
// aligned for float4 accesses and both the row-wise float4 stores (lanes on
// consecutive column chunks of one row) and the transposed ones (lanes on
// rows 4 apart) meet no bank conflict.
//
// Per pair the arithmetic is the first port's: the feature sum an
// fmaf chain from 0 in feature order, the squared norms fmaf chains from 0
// in feature order, then base_value and kernel_map of kernel_common.cuh.
// Every term is symmetric in (a, b), so the mirrored copy of a tile is
// bitwise the value the full grid computes there, and every route gives
// the bits of every other.  Deterministic: no atomics, no reduction
// across threads.
//
// Built in PK_PARTS parts that compile in parallel and link into one
// library (kernels/_build.py reads the count from the #define below):
// -DPK_PART=0 is the tile routes and the C entry point, -DPK_PART=1 the
// skinny routes.
#define PK_PARTS 2
#ifndef PK_PART
#error "kernel_block.cu is built in parts: -DPK_PART=0 .. PK_PARTS - 1 (kernels/_build.py)"
#endif
#include <algorithm>

#include "kernel_common.cuh"

using namespace pk;

namespace kb {

constexpr int TT = 128;          // output tile side
constexpr int TTHREADS = 512;    // threads of a tile block: 16 x 32
constexpr int KS = 16;           // features a staged slab
constexpr int ROWF = 132;        // floats between staging rows (plus 4 every 4 rows)
__host__ __device__ constexpr int row_off(int r) { return ROWF * r + 4 * (r >> 2); }
constexpr int BUF_FLOATS = row_off(TT - 1) + TT;   // 17,016 floats, 68,064 bytes
constexpr size_t TILE_SMEM =
    sizeof(float) * ((size_t)2 * BUF_FLOATS + 2 * KS * TT + 2 * TT);  // 153,536 bytes
constexpr int PF = TT * KS / TTHREADS;  // a thread's prefetched values of an operand

constexpr int SK_THREADS = 128;  // skinny: one thread an output row (column)
constexpr int SK_QMAX = 64;      // the few rows a skinny launch takes
constexpr int SK_QSMALL = 4;     // up to this many: the small-accumulator kernel
constexpr int OSTRIDE = SK_THREADS + 1;

// The skinny routes (part 1): few = B (rows false) or A (rows true); 0 or
// cudaErrorInvalidValue for an unknown kernel id.
int launch_skinny(const void* a, const void* b, float* out, int64_t m, int64_t n, int d,
                  float sigma, int kernel_id, bool bf16, bool rows, cudaStream_t s);

}  // namespace kb

#if PK_PART == 0
namespace kb {

// Element idx of a staged slab: row idx % TT, feature idx / TT.
template <typename T>
__device__ __forceinline__ float slab_value(const T* __restrict__ src, int64_t r0, int64_t rows,
                                            int d, int k0, int idx) {
  const int64_t g = r0 + idx % TT;
  return g < rows ? to_f32(src[g * d + k0 + idx / TT]) : 0.0f;
}

// A thread's PF values of a slab of rows [r0, r0 + TT) x features [k0, k0 +
// kc) of a row-major (rows, d) matrix, all loads issued before any is used
// (load_slab), then written to s[k * TT + r] as f32 (store_slab).
template <typename T>
__device__ __forceinline__ void load_slab(float (&v)[PF], const T* __restrict__ src, int64_t r0,
                                          int64_t rows, int d, int k0, int kc) {
#pragma unroll
  for (int u = 0; u < PF; ++u) {
    const int idx = threadIdx.x + u * TTHREADS;
    if (idx < TT * kc) v[u] = slab_value(src, r0, rows, d, k0, idx);
  }
}
__device__ __forceinline__ void store_slab(float* s, const float (&v)[PF], int kc) {
#pragma unroll
  for (int u = 0; u < PF; ++u) {
    const int idx = threadIdx.x + u * TTHREADS;
    if (idx < TT * kc) s[idx] = v[u];
  }
}

// The threads store `rows` staged rows of `cols` floats from buf to dst
// (row stride n): a warp a row, float4 a lane with the streaming hint when
// vec (n % 4 == 0, dst 16-byte aligned), else a float a lane.
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float* buf, int rows,
                                           int cols, int64_t n, bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += TTHREADS / 32) {
    const float* src = buf + row_off(r);
    if (vec) {
      if (4 * lane < cols) {
        float4* to = reinterpret_cast<float4*>(dst + r * n) + lane;
        __stcs(to, *reinterpret_cast<const float4*>(src + 4 * lane));
      }
    } else {
      for (int c = lane; c < cols; c += 32) dst[r * n + c] = src[c];
    }
  }
}

// The walk of the tile routes: row band bi, the p-th tile of the band (on
// the symmetric route the tiles from the diagonal on), in row-band order.
// Tile indices are 32-bit (a tile is 128 rows: m, n < 2^38), which keeps
// the walk's state in few registers.
struct Walk {
  int bi, p, tn;
  bool sym;
  __device__ int bj() const { return (sym ? bi : 0) + p; }
  __device__ void advance(int steps) {
    p += steps;
    while (true) {
      const int len = sym ? tn - bi : tn;
      if (len <= 0 || p < len) return;
      p -= len;
      ++bi;
    }
  }
};

// The tile and symmetric routes (see the note at the top).  vec: n % 4 ==
// 0 and out 16-byte aligned (the threads' float4 stores), else the threads
// store floats.
template <typename T, int KID>
__global__ void __launch_bounds__(TTHREADS, 1)
block_tile_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ out,
                  int64_t m, int64_t n, int d, float sigma, bool sym, bool vec) {
  constexpr int FAM = family_of(KID);
  constexpr bool NORMS = needs_norms(FAM);
  extern __shared__ __align__(128) float smem[];
  float* const stage = smem;                              // 2 x BUF_FLOATS: tile, transpose
  float* const As = smem + 2 * BUF_FLOATS;                // KS x TT, feature-major
  float* const Bs = As + KS * TT;
  float* const a2 = Bs + KS * TT;                         // TT squared norms each
  float* const b2 = a2 + TT;
  // thread (ty, tx): rows 4ty .. 4ty + 3 and 64 + 4ty .., columns 4tx .. 4tx + 3
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const MapConst mc = map_const(sigma);
  const int tm = (int)((m + TT - 1) / TT);
  Walk w{0, 0, (int)((n + TT - 1) / TT), sym};
  w.advance(blockIdx.x);  // block g takes every gridDim.x-th tile from the g-th
  bool staged = false;  // As / Bs already hold this tile's first slab
  // which buffer stages the tile (the other its transpose): they swap every
  // tile.  Either order is safe, as the barrier after the pair loop orders
  // a tile's staging after the last tile's stores; fixed buffers made the
  // staging addresses loop-invariant, held in registers, and ptxas spilled
  // some instantiations at 128 registers (PERF.md).
  int flip = 0;

  while (w.bi < tm) {
    const int64_t r0 = (int64_t)w.bi * TT, c0 = (int64_t)w.bj() * TT;
    const bool mirror = sym && r0 != c0;
    Walk next = w;
    next.advance(gridDim.x);

    // the next tile's rows (all d <= KS features) in flight while this one
    // is computed, written to As / Bs once this tile's readers are done
    const bool prefetch = d <= KS && next.bi < tm;
    float pa[PF], pb[PF];
    if (prefetch) {
      load_slab(pa, a, (int64_t)next.bi * TT, m, d, 0, d);
      load_slab(pb, b, (int64_t)next.bj() * TT, n, d, 0, d);
    }

    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < d; k0 += KS) {
      const int kc = min(KS, d - k0);
      if (!(k0 == 0 && staged)) {
        float va[PF], vb[PF];
        load_slab(va, a, r0, m, d, k0, kc);
        load_slab(vb, b, c0, n, d, k0, kc);
        if (k0 > 0) __syncthreads();  // the previous slab's readers are done
        store_slab(As, va, kc);
        store_slab(Bs, vb, kc);
        __syncthreads();
      }
      if (NORMS && tid < 2 * TT) {  // fmaf chains from 0 in feature order, across slabs
        float* nrm = tid < TT ? a2 : b2;
        const float* s = tid < TT ? As : Bs;
        const int r = tid % TT;
        float q = k0 == 0 ? 0.0f : nrm[r];
        for (int k = 0; k < kc; ++k) q = fmaf(s[k * TT + r], s[k * TT + r], q);
        nrm[r] = q;
      }
#pragma unroll 2  // faster than 4 at K_BB on the H100 (PERF.md)
      for (int k = 0; k < kc; ++k) {
        const float4 alo = *reinterpret_cast<const float4*>(&As[k * TT + 4 * ty]);
        const float4 ahi = *reinterpret_cast<const float4*>(&As[k * TT + 64 + 4 * ty]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k * TT + 4 * tx]);
        const float av[8] = {alo.x, alo.y, alo.z, alo.w, ahi.x, ahi.y, ahi.z, ahi.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (FAM == F_L1) acc[i][j] += fabsf(av[i] - bv[j]);
            else acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
      }
    }

    __syncthreads();  // norms complete, As / Bs read; the last tile's staged rows stored
    float* const D = stage + flip * BUF_FLOATS;
    float* const Tr = stage + (flip ^ 1) * BUF_FLOATS;
    if (prefetch) {
      store_slab(As, pa, d);
      store_slab(Bs, pb, d);
    }
    float ar[8], bc[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) ar[i] = NORMS ? a2[(i < 4 ? 0 : 64) + 4 * ty + (i & 3)] : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) bc[j] = NORMS ? b2[4 * tx + j] : 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = kernel_map<KID>(base_value<FAM>(acc[i][j], ar[i], bc[j]), mc);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(D + row_off((i < 4 ? 0 : 64) + 4 * ty + (i & 3)) + 4 * tx) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (mirror) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* row = Tr + row_off(4 * tx + j);
        *reinterpret_cast<float4*>(row + 4 * ty) =
            make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
        *reinterpret_cast<float4*>(row + 64 + 4 * ty) =
            make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
      }
    }
    __syncthreads();  // staging (and the next tile's rows) complete

    const int wc = n - c0 < TT ? (int)(n - c0) : TT;  // live columns of the tile
    const int wr = m - r0 < TT ? (int)(m - r0) : TT;  // live rows (the mirror's columns)
    store_rows(out + r0 * n + c0, D, wr, wc, n, vec);
    if (mirror) store_rows(out + c0 * n + r0, Tr, wc, wr, n, vec);
    flip ^= 1;
    staged = prefetch;
    w = next;
  }
}

template <typename T, int KID>
static cudaError_t launch_tile(const T* a, const T* b, float* out, int64_t m, int64_t n, int d,
                               float sigma, bool sym, cudaStream_t s) {
  const auto kernel = block_tile_kernel<T, KID>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TILE_SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int64_t tm = (m + TT - 1) / TT, tn = (n + TT - 1) / TT;
  const int64_t tiles = sym ? tm * (tm + 1) / 2 : tm * tn;
  const int grid = (int)std::min<int64_t>(sms, tiles);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  kernel<<<grid, TTHREADS, TILE_SMEM, s>>>(a, b, out, m, n, d, sigma, sym, vec);
  return cudaSuccess;
}

}  // namespace kb

// Routes of kernel_block_launch (kernels/kernel_block.py: ROUTES).
enum BlockRoute { R_TILE = 0, R_SYMMETRIC = 1, R_SKINNY_COLS = 2, R_SKINNY_ROWS = 3 };

// The most columns (rows) the skinny routes take: the wrapper's threshold.
extern "C" int kernel_block_skinny_max() { return kb::SK_QMAX; }

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// bf16 != 0 reads A and B as __nv_bfloat16, else as float.  d >= 1.  route:
// R_SYMMETRIC needs b == a and n == m; R_SKINNY_COLS n <= SK_QMAX;
// R_SKINNY_ROWS m <= SK_QMAX.
extern "C" int kernel_block_launch(const void* a, const void* b, void* out, long long m,
                                   long long n, int d, float sigma, int kernel_id, int bf16,
                                   int route, void* stream) {
  if (m < 0 || n < 0 || d < 1) return (int)cudaErrorInvalidValue;
  if ((route == R_SYMMETRIC && (a != b || m != n)) ||
      (route == R_SKINNY_COLS && n > kb::SK_QMAX) || (route == R_SKINNY_ROWS && m > kb::SK_QMAX) ||
      route < R_TILE || route > R_SKINNY_ROWS)
    return (int)cudaErrorInvalidValue;
  if (kernel_id < K_RBF || kernel_id > K_COSINE) return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (route == R_SKINNY_COLS || route == R_SKINNY_ROWS) {
    err = (cudaError_t)kb::launch_skinny(a, b, (float*)out, m, n, d, sigma, kernel_id,
                                         bf16 != 0, route == R_SKINNY_ROWS, s);
  } else {
#define PK_LAUNCH(T, KID)                                                                    \
  err = kb::launch_tile<T, KID>((const T*)a, (const T*)b, (float*)out, m, n, d, sigma,      \
                                route == R_SYMMETRIC, s)
    if (bf16) {
      PK_DISPATCH_KERNEL(kernel_id, PK_LAUNCH, __nv_bfloat16)
    } else {
      PK_DISPATCH_KERNEL(kernel_id, PK_LAUNCH, float)
    }
#undef PK_LAUNCH
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#else  // PK_PART == 1: the skinny routes

namespace kb {

// The skinny routes: x holds the many rows (p of them), y the few (q <=
// QB).  ROWS false (few columns): x = A, y = B, out[i * q + j]; ROWS true
// (few rows): x = B, y = A, out[j * p + i].  A thread loads its own row's
// slab into registers, all its loads issued before any is used (a warp's
// loads cover its rows' contiguous bytes).
template <typename T, int KID, bool ROWS, int QB>
__global__ void __launch_bounds__(SK_THREADS, QB <= SK_QSMALL ? 10 : 4)
block_skinny_kernel(const T* __restrict__ x, const T* __restrict__ y, float* __restrict__ out,
                    int64_t p, int q, int d, float sigma) {
  constexpr int FAM = family_of(KID);
  constexpr bool NORMS = needs_norms(FAM);
  __shared__ __align__(16) float Yt[KS][QB];                 // feature-major
  __shared__ float y2[QB];
  __shared__ float Os[ROWS ? 1 : QB * OSTRIDE];             // column-major output staging
  const int tid = threadIdx.x;
  const int64_t p0 = (int64_t)blockIdx.x * SK_THREADS, i = p0 + tid;
  const MapConst mc = map_const(sigma);
  float acc[QB];
#pragma unroll
  for (int j = 0; j < QB; ++j) acc[j] = 0.0f;
  float x2 = 0.0f;
  for (int k0 = 0; k0 < d; k0 += KS) {
    const int kc = min(KS, d - k0);
    float xr[KS];
#pragma unroll
    for (int k = 0; k < KS; ++k) xr[k] = (k < kc && i < p) ? to_f32(x[i * d + k0 + k]) : 0.0f;
    if (k0 > 0) __syncthreads();  // the previous slab's readers of Yt are done
#pragma unroll
    for (int u = 0; u < KS * QB / SK_THREADS + (KS * QB < SK_THREADS); ++u) {
      const int idx = tid + u * SK_THREADS;
      const int j = idx % QB, k = idx / QB;
      if (k < KS) Yt[k][j] = (j < q && k < kc) ? to_f32(y[(int64_t)j * d + k0 + k]) : 0.0f;
    }
    __syncthreads();
    if (NORMS && tid < q) {  // the few rows' norms: fmaf chains from 0 in feature order
      float s = k0 == 0 ? 0.0f : y2[tid];
      for (int k = 0; k < kc; ++k) s = fmaf(Yt[k][tid], Yt[k][tid], s);
      y2[tid] = s;
    }
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if (k >= kc) break;
      const float xv = xr[k];
      if (NORMS) x2 = fmaf(xv, xv, x2);
#pragma unroll
      for (int j4 = 0; j4 < QB / 4; ++j4) {
        if (4 * j4 >= q) break;
        const float4 yv = *reinterpret_cast<const float4*>(&Yt[k][4 * j4]);
        const float yy[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (FAM == F_L1) acc[4 * j4 + u] += fabsf(xv - yy[u]);
          else acc[4 * j4 + u] = fmaf(xv, yy[u], acc[4 * j4 + u]);
        }
      }
    }
  }
  if (NORMS) __syncthreads();  // y2 complete
  const int live = p - p0 < SK_THREADS ? (int)(p - p0) : SK_THREADS;
#pragma unroll
  for (int j = 0; j < QB; ++j) {
    if (j >= q) break;
    // base_value(acc, ||a||^2, ||b||^2): a is y's row on the few-rows route
    const float v = ROWS ? kernel_map<KID>(base_value<FAM>(acc[j], NORMS ? y2[j] : 0.0f, x2), mc)
                         : kernel_map<KID>(base_value<FAM>(acc[j], x2, NORMS ? y2[j] : 0.0f), mc);
    if constexpr (ROWS) {  // consecutive threads on consecutive floats
      if (tid < live) out[j * p + i] = v;
    } else {
      if (q == 1) {
        if (tid < live) out[i] = v;
      } else {
        Os[j * OSTRIDE + tid] = v;
      }
    }
  }
  if constexpr (!ROWS) {
    if (q > 1) {
      __syncthreads();
      // the block's output rows are out[p0 * q, (p0 + live) * q): whole lines
      float* dst = out + p0 * q;
      for (int idx = tid; idx < live * q; idx += SK_THREADS) {
        const int r = idx / q, j = idx - r * q;
        dst[idx] = Os[j * OSTRIDE + r];
      }
    }
  }
}

template <typename T, int KID, bool ROWS>
static void launch_skinny_t(const T* x, const T* y, float* out, int64_t p, int q, int d,
                            float sigma, cudaStream_t s) {
  const dim3 grid((unsigned)((p + SK_THREADS - 1) / SK_THREADS));
  if (q <= SK_QSMALL)
    block_skinny_kernel<T, KID, ROWS, SK_QSMALL><<<grid, SK_THREADS, 0, s>>>(x, y, out, p, q, d,
                                                                             sigma);
  else
    block_skinny_kernel<T, KID, ROWS, SK_QMAX><<<grid, SK_THREADS, 0, s>>>(x, y, out, p, q, d,
                                                                           sigma);
}

int launch_skinny(const void* a, const void* b, float* out, int64_t m, int64_t n, int d,
                  float sigma, int kernel_id, bool bf16, bool rows, cudaStream_t s) {
#define PK_LAUNCH(T, KID)                                                                    \
  if (rows)                                                                                  \
    launch_skinny_t<T, KID, true>((const T*)b, (const T*)a, out, n, (int)m, d, sigma, s);    \
  else                                                                                       \
    launch_skinny_t<T, KID, false>((const T*)a, (const T*)b, out, m, (int)n, d, sigma, s)
  if (bf16) {
    PK_DISPATCH_KERNEL(kernel_id, PK_LAUNCH, __nv_bfloat16)
  } else {
    PK_DISPATCH_KERNEL(kernel_id, PK_LAUNCH, float)
  }
#undef PK_LAUNCH
  return 0;
}

}  // namespace kb

#endif
