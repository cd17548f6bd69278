// K(A, B) materialised: out[i, j] = k(A[i], B[j]), (m, d) x (n, d) -> (m, n) f32.
//
// Replaces the TPU kernel src/repro/kernels/kernel_block.py:kernel_block_pallas
// (body _block_body).  Where the TPU version padded A/B to 256-row tiles and
// d to the 32-wide slab, this kernel masks the ragged edges itself.
//
// Bound on the H100: the output.  Each entry costs O(d) operations and is
// written once as 4 bytes, so for the main path's K_BB (b = 50,000, d = 9,
// 10 GB of f32) the write at 3.35 TB/s is the floor (about 3 ms).  The design
// keeps everything else off that path: each block stages a 64-row tile of A
// once and walks a strip of STRIP 64-column tiles of B, the next B slab
// loaded into registers while the current one is computed (so no block waits
// on device memory between its stores); each thread holds a 4 x 4 register
// tile of 4 rows by 4 consecutive columns and stores each row's 4 values as
// one float4 where the row is 16-byte aligned (n % 4 == 0), so 16 threads
// write 256 consecutive bytes of a row.
#include "kernel_common.cuh"

using namespace pk;

constexpr int STRIP = 8;  // B tiles per block

template <typename T, int KID>
__global__ void __launch_bounds__(THREADS)
kernel_block_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ out,
                    int64_t m, int64_t n, int d, float sigma, bool vec4) {
  constexpr int FAM = family_of(KID);
  constexpr bool NORMS = needs_norms(FAM);
  __shared__ __align__(16) float As[DC][TM];
  __shared__ __align__(16) float Bs[DC][TN];
  __shared__ __align__(16) float a2[TM];
  __shared__ __align__(16) float b2[TN];
  const int rg = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int64_t r0 = (int64_t)blockIdx.x * TM;
  const int64_t c_begin = (int64_t)blockIdx.y * (STRIP * TN);
  const MapConst mc = map_const(sigma);
  const int ns = (d + DC - 1) / DC;  // slabs per B tile
  const bool a_once = ns == 1;
  const int64_t c_end = n - c_begin < STRIP * TN ? n : c_begin + STRIP * TN;

  if (NORMS) a_sq_norms(a2, a, r0, m, d);
  if (a_once) stage_a(As, a, r0, m, d, 0, d);

  // the slab in flight: rows [f_j0, f_j0 + TN), features from f_slab * DC
  float pb[PB];
  int64_t f_j0 = c_begin;
  int f_slab = 0;
  auto fetch_next = [&]() {
    const int k0 = f_slab * DC;
    fetch_b(pb, b, f_j0, n, d, k0, min(DC, d - k0));
    if (++f_slab == ns) {
      f_slab = 0;
      f_j0 += TN;
    }
  };
  fetch_next();

  for (int64_t j0 = c_begin; j0 < c_end; j0 += TN) {
    float acc[RM][JN] = {};
    for (int slab = 0; slab < ns; ++slab) {
      const int k0 = slab * DC, kc = min(DC, d - k0);
      __syncthreads();  // readers of the previous slab / tile are done
      commit_b(Bs, pb, kc);
      if (!a_once) stage_a(As, a, r0, m, d, k0, kc);
      __syncthreads();
      if (f_j0 < c_end) fetch_next();  // in flight during the arithmetic below
      if (NORMS) b_sq_norms(b2, Bs, kc, slab == 0);
      accumulate_slab<FAM>(acc, As, Bs, rg, lane, kc);
    }
    if (NORMS) __syncthreads();  // b2 complete

    const float4 a24 = *reinterpret_cast<const float4*>(&a2[rg * RM]);
    const float4 b24 = *reinterpret_cast<const float4*>(&b2[lane * JN]);
    const float av[RM] = {a24.x, a24.y, a24.z, a24.w};
    const float bv[JN] = {b24.x, b24.y, b24.z, b24.w};
    const int64_t col = j0 + lane * JN;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int64_t row = r0 + rg * RM + i;
      float k[JN];
#pragma unroll
      for (int j = 0; j < JN; ++j) k[j] = kernel_map<KID>(base_value<FAM>(acc[i][j], av[i], bv[j]), mc);
      if (row >= m) continue;
      float* dst = out + row * n + col;
      if (vec4 && col + JN <= n) {
        *reinterpret_cast<float4*>(dst) = make_float4(k[0], k[1], k[2], k[3]);
      } else {
#pragma unroll
        for (int j = 0; j < JN; ++j)
          if (col + j < n) dst[j] = k[j];
      }
    }
  }
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// bf16 != 0 reads A and B as __nv_bfloat16, else as float.  d >= 1.
extern "C" int kernel_block_launch(const void* a, const void* b, void* out, long long m,
                                   long long n, int d, float sigma, int kernel_id, int bf16,
                                   void* stream) {
  if (m < 0 || n < 0 || d < 1) return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  const long long gy = (n + STRIP * TN - 1) / (STRIP * TN);
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((m + TM - 1) / TM), (unsigned)gy);
  const bool vec4 = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
#define PK_LAUNCH(T, KID)                                                              \
  kernel_block_kernel<T, KID><<<grid, THREADS, 0, s>>>((const T*)a, (const T*)b,     \
                                                       (float*)out, m, n, d, sigma, vec4)
  if (bf16) {
    PK_DISPATCH_KERNEL(kernel_id, PK_LAUNCH, __nv_bfloat16)
  } else {
    PK_DISPATCH_KERNEL(kernel_id, PK_LAUNCH, float)
  }
#undef PK_LAUNCH
  return (int)cudaGetLastError();
}
