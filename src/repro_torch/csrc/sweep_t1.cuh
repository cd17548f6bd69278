// The t = 1 sweep shared by kernel_matvec (out = K(A, B) v, kernel_matvec.cu)
// and the weighted matvec (out = (sum_i w_i K_i(A, B)) v, kernel_multi.cu):
// one column of V, every row of B, a block's 64 rows of A.  With a width W
// of 2 to 32 value columns it is also the multi-column sweep: kernel_matvec's
// at 2 <= t <= 32 and the weighted matvec's heads at 2 <= t <= 16 (see "W
// columns" below).
//
// What bounds it on the H100: issued instructions per pair, not bytes.  At
// the solve's G_B (50,000 x 10^6 pairs, d = 9) B is 36 MB and the work
// 5e10 pairs; every instruction spent per pair outside the distance and the
// map costs ~1.5 ms.  So the design moves everything it can out of the pair:
//
//   * Packed B.  A small kernel (pack_b) writes B once a launch as 16-byte
//     aligned rows of P floats: [b_0 .. b_{d-1}, 0 .., ||b||^2, v], the norm
//     and v in the row's last two slots.  Up to DCAP = 16 features the row
//     holds NF >= d feature slots, NF = 9 up to 9 features (the taxi data's
//     d) and 16 above, and P = round_up(NF + 2, 4) (12 at NF = 9, 20 at
//     NF = 16); above DCAP, P = round_up(d, 16) + 4.  Rows past n (to a multiple of the staged tile) are zero with
//     v = 0, so they add nothing and no pair needs a mask.  At n = 10^6 and
//     d = 9 the buffer is (10^6, 12) f32, 48 MB, allocated by the wrapper.
//     Each row's norm is computed once a launch, not once a block.
//   * Staging.  Tiles of TN_REG = 256 packed rows are copied by cp.async,
//     16 bytes a copy, into a ring of STAGES = 3 buffers in dynamic shared
//     memory: no register holds data in flight, one barrier a tile, 32-bit
//     offsets inside a tile.
//   * A in registers.  Lane l of every warp owns rows l and l + 32 of the
//     block's A tile, loaded once into registers (NF values each) with their
//     norms.  The 8 warps split each B tile: warp w takes its 32 rows, eight
//     at a time (a group of 2 x 8 = 16 pairs a thread), each B row read by
//     all 32 lanes at one address (a broadcast: P / 4 16-byte shared loads a
//     row, 1.5 a pair at d = 9).  A thread owns whole row sums over its
//     share of B; the 8 warps' sums of a row are added in warp order at the
//     end (no atomics: the result is the same from run to run).
//   * Above DCAP features a slab loop over d: tiles of TN_SLAB = 64 rows,
//     each staged DS = 16 features at a time with the row's last chunk (the
//     norm and v), A's slab reloaded into registers a unit, the pair sums
//     carried in registers across the slabs of a tile.
//
// The sweep computes, per group, the family accumulators a thread's 16 pairs
// need (sum a.b: l2 / dot / cos; sum |a - b|: l1) and hands them with the
// rows' norms and the B rows' norms and v to the caller's epilogue, which
// applies the maps and accumulates into the thread's two row sums.
//
// The split over n.  A block holds 64 rows of A, so at a few rows (a
// serving bucket of 8 to 4096 queries against n = 10^6 training rows) the
// grid of ceil(m / 64) blocks leaves most of the 132 SMs idle: m = 64 ran
// on one SM in 6.5 ms against a 0.024 ms bound.  Up to SPLIT_M rows the
// launch therefore cuts the packed rows into S ranges of whole staged
// tiles (grid.y = S): each block sweeps its range [j_begin, j_end) and
// writes its rows' sums to row blockIdx.y of an (S, m) f32 partials buffer
// (after the packed B in the scratch), and reduce_splits adds each row's S
// partials in split order.  No atomics.  S depends on n and the feature
// route only (split_of), never on m, so a row's result is bitwise the same
// whatever rows travel with it, in every bucket up to SPLIT_M.  Above
// SPLIT_M (the solve's G_B, the residual pass, a 10^4-row prediction) the
// row blocks fill the card and the launch is one range, as before.
//
// W columns.  The same sweep with W > 1 value columns (compile time; the
// pack zero-fills V's columns past the launch's t <= W): each packed row
// ends [.., ||b||^2, v_0 .. v_{W-1}], V 16-byte aligned (8 at W = 2), so
// P = round_up(NF + 1 + W, 4) at d <= DCAP and round_up(d, DS) +
// round_up(1 + W, 4) above it.  The per-row loads of the pair loop stop at
// the norm; the caller's epilogue gets the group's rows in shared memory
// and reads each B row's W values there (W / 4 broadcast float4 loads a
// row, shared by a lane's two rows of A), after forming each pair's kernel
// value once.  The thread's 2 x W row sums are added over the 8 warps in
// warp order (write_cols), through the ring's memory; a split writes (S,
// m, t) partials and reduce_splits adds them per value in split order.  S
// is split_of's, whatever W and t.  The widths are WIDTHS (a launch of t
// columns takes width_of(t)); each library builds the ones its callers
// reach, one build part a width.
#pragma once

#include <algorithm>

#include "kernel_common.cuh"

namespace pk {
namespace t1 {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int R = 2;          // rows of A a thread owns: lane l owns l and l + 32
constexpr int TM = 32 * R;    // 64 rows of A a block
constexpr int J = 8;          // B rows of one group: R x J = 16 pairs a thread
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int DCAP = 16;      // feature widths up to DCAP keep A in registers
constexpr int DS = 16;        // slab width above DCAP
constexpr int TN_REG = 256;   // B rows a staged tile (d <= DCAP)
constexpr int TN_SLAB = 64;   // B rows a staged slab unit (d > DCAP)
constexpr int64_t SPLIT_M = 4096;  // rows of A up to which n is split
constexpr int SPLIT_MAX = 264;     // ranges at most: two blocks on each of 132 SMs at m <= 64
constexpr int SPLIT_MIN_TILES = 4; // staged tiles a range at least

// The widths W the multi-column sweep is built at; a launch of t columns
// takes the smallest W >= t (the pack zero-fills V's columns t .. W - 1).
constexpr int WIDTHS[] = {2, 4, 8, 12, 16, 20, 24, 32};
constexpr int N_WIDTHS = sizeof(WIDTHS) / sizeof(WIDTHS[0]);
constexpr int width_of(int t) {  // host side: the launchers
  for (const int w : WIDTHS)
    if (t <= w) return w;
  return WIDTHS[N_WIDTHS - 1];
}

// Feature slots a launch keeps in registers (d <= DCAP): 9, the taxi data's
// d, or 16; the slots past d are zero.
__host__ __device__ constexpr int nf_bucket(int d) { return d <= 9 ? 9 : 16; }
// Floats of a staged row: NF feature slots, then the norm and the W values
// in the row's last W + 1 slots (W = 1: the last two of its last 16-byte
// chunk).
__host__ __device__ constexpr int row_floats(int nf, int w = 1) { return (nf + 1 + w + 3) / 4 * 4; }

// The packed B of a launch with W value columns: its row stride and its
// row count (the rows do not depend on W).
struct PackShape {
  int stride;
  int64_t rows;
};
inline PackShape pack_shape(int64_t n, int d, int w = 1) {
  if (d <= DCAP) return {row_floats(nf_bucket(d), w), (n + TN_REG - 1) / TN_REG * TN_REG};
  return {(d + DS - 1) / DS * DS + row_floats(0, w), (n + TN_SLAB - 1) / TN_SLAB * TN_SLAB};
}
inline int64_t pack_floats(int64_t n, int d, int w = 1) {
  const PackShape s = pack_shape(n, d, w);
  return s.rows * s.stride;
}
// The ranges of packed rows a launch of m rows sweeps: S of `span` rows
// (whole staged tiles; the last may be short).  S follows n and the
// feature route (the staged tile's rows) only, so every m up to SPLIT_M
// splits B alike; above SPLIT_M, or with too few tiles, one range.
struct Split {
  int s;
  int64_t span;
};
inline Split split_of(int64_t m, int64_t n, int d) {
  const PackShape ps = pack_shape(n, d);
  const int tn = d <= DCAP ? TN_REG : TN_SLAB;
  const int64_t tiles = ps.rows / tn;
  if (m > SPLIT_M || tiles < 2 * SPLIT_MIN_TILES) return {1, ps.rows};
  const int64_t s0 = std::min<int64_t>(SPLIT_MAX, tiles / SPLIT_MIN_TILES);
  const int64_t per = (tiles + s0 - 1) / s0;  // tiles a range
  return {(int)((tiles + per - 1) / per), per * tn};
}
// Floats of a launch's scratch (W value columns packed, t of them live):
// the packed B, then the (S, m, t) partials when the launch splits n.
inline int64_t scratch_floats(int64_t m, int64_t n, int d, int w = 1, int t = 1) {
  const Split sp = split_of(m, n, d);
  return pack_floats(n, d, w) + (sp.s > 1 ? (int64_t)sp.s * m * t : 0);
}
// Dynamic shared memory of a sweep: the ring (ring_floats); at W = 1 the
// warps' row sums follow it (WARPS x TM floats), at W > 1 they reuse it
// (WARPS x TM x W floats, after the sweep).
__host__ __device__ constexpr int ring_floats(int nf, bool slab, int w = 1) {
  return STAGES * (slab ? TN_SLAB : TN_REG) * row_floats(nf, w);
}
inline size_t smem_bytes(int nf, bool slab, int w = 1) {
  const int ring = ring_floats(nf, slab, w);
  return sizeof(float) * (size_t)(w == 1 ? ring + WARPS * TM : std::max(ring, WARPS * TM * w));
}

// Row r of the (n_pad, P) packed buffer from row r of B (n, d) and of V
// (n, t), t <= W: the norm slot holds norm_scale * ||b_r||^2, the W value
// slots V's row, zero past t.  With v null the value slots are 0 (the
// weighted block packs A and B this way, kernel_multi.cu).
template <typename T, int W = 1>
__global__ void pack_b(const T* __restrict__ b, const T* __restrict__ v, float* __restrict__ out,
                       int64_t n, int64_t rows, int d, int P, float norm_scale, int t) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const bool live = row < n;
  const T* src = b + (live ? row : 0) * d;
  const T* vrow = v + (live && v ? row : 0) * t;
  float s = 0.0f;
  if (live)
    for (int k = 0; k < d; ++k) {
      const float x = to_f32(src[k]);
      s = fmaf(x, x, s);
    }
  s *= norm_scale;
  float4* dst = reinterpret_cast<float4*>(out + row * P);
  for (int c = 0; c < P; c += 4) {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = c + i, col = k - (P - W);  // col >= 0: a value slot
      e[i] = !live             ? 0.0f
           : k < d             ? to_f32(src[k])
           : k == P - 1 - W    ? s
           : col >= 0 && col < t && v ? to_f32(vrow[col])
                               : 0.0f;
    }
    dst[c / 4] = make_float4(e[0], e[1], e[2], e[3]);
  }
}

// Copy 16 bytes from device to shared memory asynchronously (L2 only).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N groups of this thread's copies are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x and sqrt(x) by the special-function unit; matern52's map with the
// approximate square root (relative error ~2^-22, far inside the f32
// tolerance of a kernel value; checked on the card).
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
template <int KID>
__device__ __forceinline__ float kernel_map_t1(float base, const MapConst& c) {
  if (KID == K_MATERN52) {
    const float s5 = c.sqrt5_inv_sigma * sqrt_approx(base + 1e-20f);
    return (1.0f + s5 + c.five_thirds_inv_s2 * base) * ex2(-kLog2e * s5);
  }
  return kernel_map<KID>(base, c);
}

// The sweep over packed B rows [j_begin, j_end) for the block's 64 rows of
// A (a, (m, d) row-major, T = float or __nv_bfloat16).  NF: feature slots
// (SLAB: DS a unit).  DOT / L1: the accumulators to form (acc = sum a.b,
// acc1 = sum |a - b|).  fold: acc starts at -||a||^2 / 2, so an l2 distance
// is max(b2 - 2 acc, 0) (launches whose dot accumulator serves only l2
// kernels; a dot or cos kernel needs the raw sum).  `ring` is the
// dynamic shared memory (STAGES tiles).  For each group of a thread's
// R x J pairs: epi(acc, acc1, a2, b2, v) with a2 the rows' squared norms
// (only with DOT) and b2 the B rows' norm slots (as packed: scaled); v is
// the B rows' values at W = 1, and at W > 1 the group's first staged row
// in shared memory (J rows of row_floats(NF, W) floats, each ending in its
// W values).
template <int NF, bool SLAB, bool DOT, bool L1, int W = 1, typename T, typename Epi>
__device__ __forceinline__ void sweep(const T* __restrict__ a, const float* __restrict__ bp,
                                      int64_t m, int d, int P, int64_t j_begin, int64_t j_end,
                                      bool fold, float* ring, Epi&& epi) {
  constexpr int SP = row_floats(NF, W);        // floats a staged row
  constexpr int CH = SP / 4;                   // its 16-byte chunks
  constexpr int NS = SP - 1 - W;               // the norm's slot
  constexpr int CHB = W == 1 ? CH : NS / 4 + 1;  // chunks the pair loop reads: to the norm
  constexpr int TN = SLAB ? TN_SLAB : TN_REG;  // B rows a unit
  constexpr int G = TN / WARPS / J;            // groups a warp takes of a unit
  constexpr int STAGE = TN * SP;               // floats a ring buffer
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t r0 = (int64_t)blockIdx.x * TM;
  const int ns = SLAB ? (d + DS - 1) / DS : 1;  // units a tile
  const int64_t units = (j_end - j_begin) / TN * ns;

  // the thread's rows of A: all NF slots, or the slab from feature k0
  float av[R][NF];
  auto load_a = [&](int k0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t row = r0 + lane + 32 * r;
      const bool live = row < m;
      const T* src = a + (live ? row : 0) * d + k0;
#pragma unroll
      for (int k = 0; k < NF; ++k) av[r][k] = live && k0 + k < d ? to_f32(src[k]) : 0.0f;
    }
  };
  float a2[R] = {};
  if (!SLAB) {
    load_a(0);
    if (DOT)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int k = 0; k < NF; ++k) a2[r] = fmaf(av[r][k], av[r][k], a2[r]);
  } else if (DOT) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t row = r0 + lane + 32 * r;
      if (row < m)
        for (int k = 0; k < d; ++k) {
          const float x = to_f32(a[row * d + k]);
          a2[r] = fmaf(x, x, a2[r]);
        }
    }
  }
  float acc0[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc0[r] = fold ? -0.5f * a2[r] : 0.0f;

  // the copy side: unit `issued` goes to ring buffer `i_stage`; its tile
  // starts at packed row i_j0, its slab at feature i_slab * DS
  int64_t issued = 0, i_j0 = j_begin;
  int i_slab = 0, i_stage = 0;
  auto issue = [&]() {
    if (issued < units) {
      float* dst = ring + i_stage * STAGE;
      if (!SLAB) {  // the tile is one contiguous run of TN * SP floats
        const float* src = bp + i_j0 * P;
#pragma unroll
        for (int i = 0; i < TN * CH / THREADS; ++i) {
          const int c = tid + i * THREADS;
          cp_async16(dst + 4 * c, src + 4 * c);
        }
      } else {  // DS features of each row, then the row's last chunks (norm, values)
        for (int c = tid; c < TN * CH; c += THREADS) {
          const int row = c / CH, ch = c % CH;
          const int col = ch < DS / 4 ? i_slab * DS + 4 * ch : P - SP + 4 * ch;
          cp_async16(dst + row * SP + 4 * ch, bp + (i_j0 + row) * P + col);
        }
      }
      ++issued;
      if (++i_stage == STAGES) i_stage = 0;
      if (++i_slab == ns) {
        i_slab = 0;
        i_j0 += TN;
      }
    }
    cp_async_commit();  // an empty group past the end keeps the wait uniform
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue();

  float acc[R][J], acc1[R][J], b2[J], vv[J];
  int stage = 0, slab = 0;
  for (int64_t u = 0; u < units; ++u) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of unit u have landed
    __syncthreads();  // everyone's have, and everyone is done with unit u - 1
    issue();          // into unit u - 1's buffer
    if (SLAB) load_a(slab * DS);
    const float* tile = ring + stage * STAGE + warp * (TN / WARPS) * SP;
    const bool first = !SLAB || slab == 0, last = !SLAB || slab == ns - 1;
#pragma unroll 1
    for (int g = 0; g < G; ++g) {
      if (first)
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < J; ++j) {
            acc[r][j] = acc0[r];
            acc1[r][j] = 0.0f;
          }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float* row = tile + (g * J + j) * SP;
        float bv[4 * CHB];
#pragma unroll
        for (int c = 0; c < CHB; ++c) {
          const float4 x = *reinterpret_cast<const float4*>(row + 4 * c);
          bv[4 * c] = x.x; bv[4 * c + 1] = x.y; bv[4 * c + 2] = x.z; bv[4 * c + 3] = x.w;
        }
        b2[j] = bv[NS];
        if constexpr (W == 1) vv[j] = bv[SP - 1];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int k = 0; k < NF; ++k) {
            if (DOT) acc[r][j] = fmaf(av[r][k], bv[k], acc[r][j]);
            if (L1) acc1[r][j] += fabsf(av[r][k] - bv[k]);
          }
      }
      if (last) {
        if constexpr (W == 1) epi(acc, acc1, a2, b2, vv);
        else epi(acc, acc1, a2, b2, tile + g * J * SP);
      }
    }
    if (++stage == STAGES) stage = 0;
    if (SLAB && ++slab == ns) slab = 0;
  }
}

// The block's range of packed rows: [blockIdx.y span, +span) cut at n_pad.
__device__ __forceinline__ int64_t range_begin(int64_t span) { return (int64_t)blockIdx.y * span; }
__device__ __forceinline__ int64_t range_end(int64_t span, int64_t n_pad) {
  const int64_t end = range_begin(span) + span;
  return end < n_pad ? end : n_pad;
}

// out[row] (+)= the sum of the 8 warps' partial sums o of the block's rows,
// added in warp order; `red` is WARPS x TM floats of shared memory.  A
// launch split over n (gridDim.y > 1) writes row blockIdx.y of the (S, m)
// partials at `out` instead, never accumulating there.
__device__ __forceinline__ void write_rows(const float (&o)[R], float* red, float* __restrict__ out,
                                           int64_t m, bool accumulate) {
  if (gridDim.y > 1) {
    out += (int64_t)blockIdx.y * m;
    accumulate = false;
  }
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int r = 0; r < R; ++r) red[warp * TM + lane + 32 * r] = o[r];
  __syncthreads();
  if (tid < TM) {
    float s = red[tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += red[w * TM + tid];
    const int64_t row = (int64_t)blockIdx.x * TM + tid;
    if (row < m) out[row] = accumulate ? out[row] + s : s;
  }
}

// o[r][c] += kv[r] f(V_c) over the thread's R rows and the W values of a
// staged B row at vr: W / 4 broadcast float4 loads (a float2 at W = 2),
// each value shared by the lane's R rows.  f maps a loaded value (the
// weighted heads' bf16 route rounds V_c w_k to bf16 there).
template <int W, typename F>
__device__ __forceinline__ void add_values(float (&o)[R][W], const float (&kv)[R],
                                           const float* vr, F&& f) {
  if constexpr (W == 2) {
    const float2 x = *reinterpret_cast<const float2*>(vr);
    const float y0 = f(x.x), y1 = f(x.y);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      o[r][0] = fmaf(kv[r], y0, o[r][0]);
      o[r][1] = fmaf(kv[r], y1, o[r][1]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < W; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(vr + c);
      const float y[4] = {f(x.x), f(x.y), f(x.z), f(x.w)};
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[r][c + i] = fmaf(kv[r], y[i], o[r][c + i]);
    }
  }
}

// At W > 1: out (m, t) (+)= the sum of the 8 warps' row sums o (R x W a
// thread) of the block's rows, added in warp order, columns past t dropped;
// `red` (WARPS x TM x W floats) is the ring's memory, free once every warp
// is past its last tile.  A launch split over n writes block row
// blockIdx.y of the (S, m, t) partials at `out` instead, never
// accumulating there.
template <int W>
__device__ __forceinline__ void write_cols(const float (&o)[R][W], float* red,
                                           float* __restrict__ out, int64_t m, int t,
                                           bool accumulate) {
  if (gridDim.y > 1) {
    out += (int64_t)blockIdx.y * m * t;
    accumulate = false;
  }
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  __syncthreads();  // the ring is free
  // red[warp][c][row]: a warp's lanes write consecutive rows (no bank conflict)
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < W; ++c) red[(warp * W + c) * TM + lane + 32 * r] = o[r][c];
  __syncthreads();
  for (int e = tid; e < TM * W; e += THREADS) {  // e = c TM + row
    const int row = e % TM, c = e / TM;
    float s = red[e];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += red[w * TM * W + e];
    const int64_t g = (int64_t)blockIdx.x * TM + row;
    if (g < m && c < t) out[g * t + c] = accumulate ? out[g * t + c] + s : s;
  }
}

// out[i] (+)= the sum of its S partials (part: (S, count): count = m rows
// of t values), in split order.  Static: each library or part that
// includes this header has its own.
static __global__ void reduce_splits(const float* __restrict__ part, float* __restrict__ out,
                                     int64_t count, int s, bool accumulate) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float sum = part[i];
  for (int k = 1; k < s; ++k) sum += part[(int64_t)k * count + i];
  out[i] = accumulate ? out[i] + sum : sum;
}

// Pack B and V (t <= W columns) into `scratch` (pack_floats(n, d, W)
// floats) on `stream`, the norms scaled by norm_scale.
template <int W = 1, typename T>
inline cudaError_t launch_pack(const T* b, const T* v, float* scratch, int64_t n, int d,
                               float norm_scale, cudaStream_t stream, int t = 1) {
  const PackShape s = pack_shape(n, d, W);
  if (s.rows == 0) return cudaSuccess;
  if (!scratch) return cudaErrorInvalidValue;
  constexpr int PT = 256;
  pack_b<T, W><<<(unsigned)((s.rows + PT - 1) / PT), PT, 0, stream>>>(
      b, v, scratch, n, s.rows, d, s.stride, norm_scale, t);
  return cudaGetLastError();
}

}  // namespace t1
}  // namespace pk

#ifndef PK_SWEEP_NO_EXPORTS
// Floats of the scratch a t = 1 launch of m rows needs for B of n rows and
// d features (the packed B: 48 MB at n = 10^6, d = 9; and the (S, m)
// partials of a launch split over n); each library that includes this
// header exports it (a library built in parts, once).
extern "C" long long sweep_t1_scratch_floats(long long m, long long n, int d) {
  return m < 0 || n < 0 || d < 1 ? 0 : (long long)pk::t1::scratch_floats(m, n, d);
}
// The ranges S a launch of m rows splits B of n rows into (1: no split),
// at t = 1 and at every W.
extern "C" int sweep_t1_splits(long long m, long long n, int d) {
  return m < 0 || n < 0 || d < 1 ? 1 : pk::t1::split_of(m, n, d).s;
}
#endif

namespace pk {
namespace t1 {

// Static shared memory a sweep kernel may hold beside its dynamic memory
// (the weighted kernels' 224-byte table).
constexpr size_t STATIC_SMEM_MAX = 1024;

// Launch a sweep kernel over `grid` ((m row blocks, S ranges)) with `smem`
// bytes of dynamic shared memory, opting in first where it and the
// kernel's static shared memory may pass the 48 KB a block gets by default.
template <typename Kernel, typename... Args>
inline cudaError_t launch_sweep(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                                Args... args) {
  if (smem + STATIC_SMEM_MAX > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The grid of a sweep of m rows split as `sp`.
inline dim3 sweep_grid(int64_t m, const Split& sp) {
  return dim3((unsigned)((m + TM - 1) / TM), (unsigned)sp.s);
}

// After a split sweep: out (+)= the partials' sums (part: the scratch past
// the packed B; count: the values of out, m x t).
inline cudaError_t launch_reduce(const float* part, float* out, int64_t count, int s,
                                 bool accumulate, cudaStream_t stream) {
  constexpr int RT = 256;
  reduce_splits<<<(unsigned)((count + RT - 1) / RT), RT, 0, stream>>>(part, out, count, s,
                                                                      accumulate);
  return cudaGetLastError();
}

}  // namespace t1
}  // namespace pk

// Instantiate LAUNCH(NF, SLAB) for feature width d: its register bucket, or
// the slab loop above DCAP.
#define PK_T1_DISPATCH_NF(d, LAUNCH) \
  if ((d) > pk::t1::DCAP) {         \
    LAUNCH(16, true);               \
  } else if ((d) <= 9) {            \
    LAUNCH(9, false);               \
  } else {                          \
    LAUNCH(16, false);              \
  }
