// The column path shared by kernel_matvec (out = K(A, B) V at t > 1,
// kernel_matvec.cu) and the multi-kernel matvecs (kernel_multi.cu: the
// weighted matvec at t > 1, the tune's matvec_cols, 160 columns; and the
// stacked matvec, the tune's sketch, 100 columns).
//
//   * Kernel values once for all columns.  The TPU kernels take all of V's
//     columns in one block, so they form each pair's distances and maps
//     once.  A block here owns CM = 32 rows of A and a column block of cw
//     columns (t split evenly over the fewest blocks of at most TCB = 160,
//     cw rounded up to a multiple of 4; col_split), so each pair's
//     distances and maps are formed once per 16-row B tile and written to
//     shared memory; every thread then streams its 8 rows x CO columns of
//     the output (8 CO f32 registers, no lane reduction) through them.
//     Per B row and kernel tile: two float4 of K, the shared V row and
//     8 CO FMAs (the weighted matvec first multiplies the V row by the
//     column weights, held in registers three kernels at a time).
//   * The width follows t.  A block runs with the fewest columns a thread
//     CO among its caller's instantiations with 16 CO >= cw: 8 and 10 (TCB
//     128 and 160) for the multi-kernel matvecs, also 2 and 4 (TCB 32 and
//     64) for kernel_matvec, so a one-vs-all G_B of 10 heads runs 32 FMAs a
//     pair, not 128.  Columns past cw are zero in V and cost FMAs only.
//   * The kernel set (KS below) says which tiles a block forms: the
//     weighted matvec all q kernels of its MultiSpec with their weight rows;
//     the stacked matvec one kernel a grid.z slice, unweighted; kernel_matvec
//     one kernel fixed at compile time, unweighted, with no table and (rbf)
//     the scale folded into the norms, as on the t = 1 sweep.
//   * Shared memory (dynamic): the V tile (16 x TCB) and the transposed B
//     slab, each double-buffered and copied by cp.async one tile ahead (no
//     register holds data in flight); the A tile; each thread's pair
//     accumulators; the kernel set's table; then q kernel tiles (16 x 32)
//     and q weight rows (smem_bytes).  For the weighted matvec at q = 3 and
//     160 columns that is 41.2 KB; above 48 KB (q > 5) the launcher opts in
//     to more.  64 threads of at most 168 registers.
//   * Bound: the q x t FMAs a pair (480 at q = 3, t = 160; 300 for the
//     sketch; 100 for pcg-nystrom's rank-100 sketch) at the FP32 CUDA-core
//     rate.  Tensor cores are not used: the f32 policy is true f32, which
//     TF32 products would break.
//   * The operands arrive as f32 (the wrappers widen bf16-rounded values),
//     so rows of any d and t are copied in 4-byte units (V in 16-byte units
//     when t % 4 == 0).
//   * Deterministic: a thread owns whole output values and adds B rows in
//     order; no atomics.
#pragma once

#include "kernel_common.cuh"

namespace pk {
namespace cols {

// A block of CTHREADS threads owns CM rows of A and cw <= TCB = CCG * CO
// columns of V; it walks B in tiles of CN rows.  Per tile, thread (rg, cg) =
// (tid / CCG, tid % CCG) forms the family accumulators of rows rg*CRO .. +7
// against B row cg and writes their kernel values to the tiles ks; then it
// multiplies its CRO x CO output tile (rows rg*CRO .., columns cg*CO ..) by
// ks and by the V tile.
constexpr int CTHREADS = 64;
constexpr int CCG = 16;                      // column groups
constexpr int CRO = 8;                       // output rows a thread owns
constexpr int KG = 3;                        // kernels whose weights sit in registers at once
constexpr int CM = (CTHREADS / CCG) * CRO;   // 32 rows of A per block
constexpr int CN = CCG;                      // 16 rows of B per tile
constexpr int TPR = CTHREADS / CN;           // threads that copy one B / V row
constexpr int CO_MID = 8, CO_WIDE = 10;      // columns a thread owns: TCB 128 or 160
constexpr int CO_TWO = 2, CO_FOUR = 4;       // the narrow widths: TCB 32 or 64
constexpr int TCB_WIDE = CCG * CO_WIDE;

// The table of a kernel set without one (kernel_matvec's compile-time kernel).
struct NoTable {};

// The column path's shared memory, with the kernel set's table Tab; the q
// kernel tiles ks[q][CN][CM] and the q weight rows ws[q][TCB] of the column
// block follow it (dynamic).
template <int TCB, typename Tab>
struct alignas(16) Smem {
  float vraw[2][CN][TCB];  // V tiles, double-buffered by cp.async
  float bs[2][DC][CN];     // B slabs, transposed, double-buffered by cp.async
  float as[DC][CM];        // A: all of d when d <= DC, else the current slab
  float pair[2][CRO][CTHREADS];  // each thread's dot and l1 accumulators of a tile
  float a2[CM];
  Tab tab;
};

// Dynamic shared memory of a launch: q kernel tiles and q weight rows (read
// only by a weighted kernel set).
template <int TCB, typename Tab>
constexpr size_t smem_bytes(int q) {
  return sizeof(Smem<TCB, Tab>) + sizeof(float) * q * (CN * CM + TCB);
}

// The column split of a launch (host): t over gy, the fewest column blocks
// of at most TCB_WIDE columns, each of cw columns (rounded up to a multiple
// of 4, so a 16-byte V copy stays in its block), and co, the columns a
// thread owns: the smallest width with CCG * co >= cw, among 8 and 10, and
// 2 and 4 too when `narrow`.  The launcher refuses gy > 65535.
struct Split {
  int gy, cw, co;
};
inline Split col_split(int t, bool narrow) {
  const int gy = (t + TCB_WIDE - 1) / TCB_WIDE;
  const int cw = ((t + gy - 1) / gy + 3) / 4 * 4;  // columns a block owns
  const int co = narrow && cw <= CCG * CO_TWO    ? CO_TWO
               : narrow && cw <= CCG * CO_FOUR   ? CO_FOUR
               : cw <= CCG * CO_MID              ? CO_MID
                                                 : CO_WIDE;
  return {gy, cw, co};
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

// out (m, t) (+)= the kernel set's tiles applied to V, t > 1: grid.y block y
// owns columns [y cw, min((y + 1) cw, t)), cw <= TCB = CCG * CO.  A, B and V
// are f32 (for BF16, holding bf16-rounded values; each kernel value, and
// each V * w of a weighted set, is rounded to bf16 before its product).
// v16: t % 4 == 0, cw % 4 == 0 and v 16-byte aligned (V copied in float4).
// accumulate: a weighted set adds to out.
//
// The kernel set KS:
//   KS::Tab                    its table in shared memory (NoTable: none)
//   KS::WEIGHTED               the tiles are summed with weight rows ws
//   KS::NORMS                  the dot accumulator needs the squared norms
//   KS::JU                     B rows a step of the FMA loop (unrolled)
//   q()                        its kernel tiles
//   load(tab)                  thread 0 fills the table (read after a barrier)
//   weight(tab, k, c0, c, t)   tile k's weight at column c0 + c of V
//   norm(s)                    the norm kept for a squared norm s
//   map(tab, k, kv, ac, ac1, av, bv)  tile k's values of four pairs
template <bool BF16, bool DOTACC, bool L1ACC, int CO, class KS>
__device__ __forceinline__ void body(const float* __restrict__ a, const float* __restrict__ b,
                                     const float* __restrict__ v, float* __restrict__ out,
                                     int64_t m, int64_t n, int d, int t, int cw, const KS& kset,
                                     bool v16, bool accumulate) {
  constexpr int TCB = CCG * CO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<TCB, typename KS::Tab>& S = *reinterpret_cast<Smem<TCB, typename KS::Tab>*>(smem_raw);
  const int q = kset.q();
  float (*ks)[CN][CM] =
      reinterpret_cast<float (*)[CN][CM]>(smem_raw + sizeof(Smem<TCB, typename KS::Tab>));
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
  kset.load(S.tab);
  if (DOTACC && KS::NORMS)
    for (int r = tid; r < CM; r += CTHREADS) {
      float s = 0.0f;
      const int64_t g = r0 + r;
      if (g < m)
        for (int k = 0; k < d; ++k) s = fmaf(a[g * d + k], a[g * d + k], s);
      S.a2[r] = kset.norm(s);
    }
  if (a_once) stage_as(0, d);
  __syncthreads();  // tab
  if (KS::WEIGHTED)
    for (int idx = tid; idx < q * TCB; idx += CTHREADS) {
      const int k = idx / TCB, c = idx % TCB;
      ws[k][c] = c < tc ? kset.weight(S.tab, k, c0, c, t) : 0.0f;
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
        if (DOTACC && KS::NORMS) b2 = fmaf(bk, bk, b2);  // the norm of B row cg, kept by each row group
#pragma unroll
        for (int i = 0; i < CRO; ++i) {
          if (DOTACC) acc[i] = fmaf(ak[i], bk, acc[i]);
          if (L1ACC) acc1[i] += fabsf(ak[i] - bk);
        }
      }
    }

    // the q kernel tiles, each pair's values formed once for all columns;
    // the accumulators go through the thread's own slots of S.pair so the
    // maps run on four pairs at a time beside the output registers
#pragma unroll
    for (int i = 0; i < CRO; ++i) {
      if (DOTACC) S.pair[0][i][tid] = acc[i];
      if (L1ACC) S.pair[1][i][tid] = acc1[i];
    }
    const bool live = j0 + cg < n;  // B row cg of this tile lies before the ragged end
    const float bn = kset.norm(b2);
#pragma unroll 1
    for (int k = 0; k < q; ++k) {
#pragma unroll 1
      for (int h = 0; h < CRO; h += 4) {
        float ac[4][1], ac1[4][1], av[4], bv[1] = {bn}, kv[4][1];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ac[i][0] = DOTACC ? S.pair[0][h + i][tid] : 0.0f;
          ac1[i][0] = L1ACC ? S.pair[1][h + i][tid] : 0.0f;
          av[i] = DOTACC && KS::NORMS ? S.a2[rg * CRO + h + i] : 0.0f;
        }
        kset.map(S.tab, k, kv, ac, ac1, av, bv);
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
    // weights of the group's kernels stay in registers (unweighted: o += K V)
#pragma unroll 1
    for (int kb = 0; kb < q; kb += KG) {
      float wk[KG][CO];
      if (KS::WEIGHTED)
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
      for (int j0 = 0; j0 < CN; j0 += KS::JU)
#pragma unroll
      for (int ju = 0; ju < KS::JU; ++ju) {
        const int j = j0 + ju;
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
          for (int c = 0; c < CO; ++c)
            vw[c] = !KS::WEIGHTED ? vv[c] : BF16 ? round_bf16(vv[c] * wk[g][c]) : vv[c] * wk[g][c];
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
      *dst = KS::WEIGHTED && accumulate ? *dst + o[i][c] : o[i][c];
    }
  }
}

}  // namespace cols
}  // namespace pk
