// Batched small-matrix Cholesky and triangular solve, one matrix per CTA.
//
// Replaces the Pallas TPU kernels sampling_gpmpc_tpu/ops/batch_linalg.py::
// _chol_kernel (lower Cholesky, upper triangle zeroed) and ::_tri_kernel
// (L X = R, or L' X = R), which put the batch on the TPU's 128-wide lane
// axis.  Here each matrix is one CTA working in the (B, n, n) row-major
// layout: the TPU's moveaxis/lane padding glue is gone.
//
// chol_kernel (the body is sgp::chol_matrix in common.cuh, shared with
// batched_chol.cu): a right-looking blocked Cholesky in 32-column panels,
// the factor gp_hall.cu runs (sgp::factor_panel).  The lower triangle of
// A_i goes by cp.async into 32x32 lower tiles of dynamic shared memory
// (row stride 33, so a column read is conflict-free; 88,704 B at n = 180,
// hence the opt-in above 48 KB); each panel is one warp's register
// Cholesky of the diagonal tile, per-row register solves below it and 4x4
// register-tiled trailing updates, about three barriers per panel (18 at
// n = 180 where the earlier column sweep took 179).  The write-out zeroes
// the upper triangle.  Only the lower triangle is read: for a symmetric
// input the TPU kernel's row read is the same numbers.  A non-positive
// pivot at column j0 gives NaN from that column on, and, as the TPU
// kernel's masked rank-1 update does (NaN * 0 in its rows > j0, columns <
// j0), NaN in the earlier columns of every row below j0; rows up to j0
// keep their finite entries.  The launch shape follows n (common.cuh):
// a 128-thread CTA per matrix up to n = 64 (two panels), 512 threads
// above.
//
// tri_solve_kernel: a blocked substitution in 32-row panels over the same
// tiles.  The lower triangle of L_i goes by cp.async into 32x32 lower
// tiles (as chol_matrix loads it; the rows past n that pad the last tile
// are identity rows), the right-hand side into an n x m block padded to
// whole tiles with zero rows.  Per panel, forward over the panels for
// L X = R and backward for L' X = R: (a) the diagonal tile solves the
// panel's 32 rows of X, one warp per column (lane i holds row i, x_j
// passes by a shuffle) while the columns are no more than the warps, else
// one thread per column with the 32 rows in registers; L' is read as rows
// of L by swapping the tile's indices, so no transpose is copied; (b)
// every later row block takes the panel's contribution, one thread per
// (row, column) with the panel's 32 solved entries of its column in
// registers.  Two barriers a panel (12 at n = 180 where the earlier column
// sweep took 180).  Each element gets exactly the column sweep's updates
// in the same order, each __fsub_rn(x, __fmul_rn(f, x_j)) with x_j = x /
// L_jj: the result is the column sweep's bit for bit.  The TPU kernel's
// masked update spreads a non-finite x_j through its whole column (a
// coefficient 0 times NaN); here step (a) flags a column when one of its
// solved entries is not finite, and the write-out sets every row of a
// flagged column NaN.  The launch shape follows n and m
// (ops/batch_linalg.py tri_launch_shape): with a single right-hand side up
// to n = 64 a CTA of one warp, so 16 matrices share an SM and the loads of
// some overlap the panels of others; 128 threads for more columns, 256
// above n = 64.
//
// What bounds them on the H100: bytes.  At the forward-sampling shape
// (B = 12,000 matrices of n = 50) one Cholesky moves 181 MB (the lower
// triangle read once, the whole factor written once), 54 us at 3.35 TB/s,
// against 5e8 flop (7.5 us at 67 TFLOP/s); a solve with m = 1 moves 66 MB
// (the factor's lower triangle and the right-hand side read, the solution
// written), 20 us, against 3e7 flop.  Both kernels keep several matrices
// resident per SM at that shape, each thread's copies in flight at once
// (cp.async), so the loads of some matrices overlap the panels of others;
// at n = 180 (B = 60, fewer CTAs than SMs) the chain of panels sets their
// time.
#include "common.cuh"

namespace {

template <int NT>
__global__ void __launch_bounds__(NT)
chol_kernel(const float* __restrict__ A, float* __restrict__ L, int n) {
  extern __shared__ float sm[];
  const size_t off = (size_t)blockIdx.x * n * n;
  sgp::chol_matrix(A + off, L + off, n, 0.f, false, sm);
}

// One panel k of the blocked substitution on the tiles M and the padded
// right-hand side sX (np x m), forward (rows below the panel) or backward
// (rows above it); bad[c] flags a column with a non-finite solved entry.
template <bool FWD>
__device__ void tri_panel(const sgp::Tiles& M, float* sX, int* bad, int k, int n,
                          int np, int m, bool warp_diag) {
  using sgp::TB;
  using sgp::TLD;
  const int tid = threadIdx.x, nt = blockDim.x, r0 = k * TB;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const float* D = M.tile(k, k);
  // (a) the diagonal tile, either one warp per column, lane i holding row
  // i of the panel and x_j passed by a shuffle (few columns: 32 times fewer
  // warp instructions), or one thread per column holding the panel's rows
  // in registers (many columns); the same operations in the same order
  if (warp_diag) {
    for (int c = warp; c < m; c += nw) {
      float x = sX[(r0 + lane) * m + c];
      if (FWD) {
#pragma unroll
        for (int j = 0; j < TB; ++j) {
          const float xj = __shfl_sync(0xffffffffu, x, j) / D[j * TLD + j];
          if (lane == j) x = xj;
          else if (lane > j) x = __fsub_rn(x, __fmul_rn(D[lane * TLD + j], xj));
        }
      } else {
#pragma unroll
        for (int j = TB - 1; j >= 0; --j) {
          const float xj = __shfl_sync(0xffffffffu, x, j) / D[j * TLD + j];
          if (lane == j) x = xj;
          else if (lane < j) x = __fsub_rn(x, __fmul_rn(D[j * TLD + lane], xj));
        }
      }
      sX[(r0 + lane) * m + c] = x;
      if (__any_sync(0xffffffffu, r0 + lane < n && !isfinite(x)) && lane == 0)
        bad[c] = 1;
    }
  }
  for (int c = warp_diag ? m : tid; c < m; c += nt) {
    float x[TB];
#pragma unroll
    for (int j = 0; j < TB; ++j) x[j] = sX[(r0 + j) * m + c];
    if (FWD) {
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        x[j] = x[j] / D[j * TLD + j];
#pragma unroll
        for (int r = j + 1; r < TB; ++r)
          x[r] = __fsub_rn(x[r], __fmul_rn(D[r * TLD + j], x[j]));
      }
    } else {
#pragma unroll
      for (int j = TB - 1; j >= 0; --j) {
        x[j] = x[j] / D[j * TLD + j];
#pragma unroll
        for (int r = 0; r < j; ++r)
          x[r] = __fsub_rn(x[r], __fmul_rn(D[j * TLD + r], x[j]));
      }
    }
    bool flag = false;
#pragma unroll
    for (int j = 0; j < TB; ++j) {
      flag |= r0 + j < n && !isfinite(x[j]);
      sX[(r0 + j) * m + c] = x[j];
    }
    if (flag) bad[c] = 1;
  }
  __syncthreads();
  // (b) the later row blocks: x_r -= sum_j f_rj x_j in the sweep's order
  const int first = FWD ? r0 + TB : 0, nrows = FWD ? np - r0 - TB : r0;
  if (nrows <= 0) return;
  const int mc = m < nt ? m : nt, groups = nt / mc;
  const int g = tid / mc;
  if (g < groups) {
    for (int c = tid % mc; c < m; c += mc) {
      float x[TB];
#pragma unroll
      for (int j = 0; j < TB; ++j) x[j] = sX[(r0 + j) * m + c];
      for (int rr = g; rr < nrows; rr += groups) {
        const int r = first + rr;
        float acc = sX[r * m + c];
        if (FWD) {
          const float* f = M.tile(r / TB, k) + (r % TB) * TLD;   // L[r][r0 + j]
#pragma unroll
          for (int j = 0; j < TB; ++j) acc = __fsub_rn(acc, __fmul_rn(f[j], x[j]));
        } else {
          const float* f = M.tile(k, r / TB) + r % TB;           // L[r0 + j][r]
#pragma unroll
          for (int j = TB - 1; j >= 0; --j)
            acc = __fsub_rn(acc, __fmul_rn(f[j * TLD], x[j]));
        }
        sX[r * m + c] = acc;
      }
    }
  }
  __syncthreads();
}

template <int NT>
__global__ void __launch_bounds__(NT)
tri_solve_kernel(const float* __restrict__ L, const float* __restrict__ R,
                 float* __restrict__ X, int n, int m, int lower, int warp_diag) {
  using sgp::TB;
  using sgp::TLD;
  extern __shared__ float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = NT / 32;
  const int nt_t = (n + TB - 1) / TB, np = nt_t * TB;
  const sgp::Tiles M{sm};
  float* sX = sm + nt_t * (nt_t + 1) / 2 * sgp::TILE_FLOATS;   // np x m
  int* bad = (int*)(sX + np * m);                               // m flags
  const float* Li = L + (size_t)blockIdx.x * n * n;
  const float* Ri = R + (size_t)blockIdx.x * n * m;
  for (int a = warp; a < np; a += nw) {
    const int I = a / TB, r = a % TB;
    for (int J = 0; J <= I; ++J) {
      const int c = J * TB + lane;
      float* dst = M.tile(I, J) + r * TLD + lane;
      if (a < n && c <= a) sgp::cp_async4(dst, Li + (size_t)a * n + c);
      else *dst = (a >= n && c == a) ? 1.f : 0.f;
    }
  }
  for (int e = tid; e < n * m; e += NT) sgp::cp_async4(sX + e, Ri + e);
  for (int e = n * m + tid; e < np * m; e += NT) sX[e] = 0.f;
  for (int c = tid; c < m; c += NT) bad[c] = 0;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (lower) {
    for (int k = 0; k < nt_t; ++k)
      tri_panel<true>(M, sX, bad, k, n, np, m, warp_diag);
  } else {
    for (int k = nt_t - 1; k >= 0; --k)
      tri_panel<false>(M, sX, bad, k, n, np, m, warp_diag);
  }
  const float qnan = __int_as_float(0x7fc00000);
  float* Xi = X + (size_t)blockIdx.x * n * m;
  for (int e = tid; e < n * m; e += NT) Xi[e] = bad[e % m] ? qnan : sX[e];
}

}  // namespace

extern "C" int batch_chol(const float* A, float* L, int B, int n, int smem_bytes,
                          void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n <= sgp::CHOL_SMALL_N)
    return sgp::launch_batched(chol_kernel<sgp::CHOL_SMALL_THREADS>, B,
                               sgp::CHOL_SMALL_THREADS, smem_bytes, s, A, L, n);
  return sgp::launch_batched(chol_kernel<sgp::CHOL_THREADS>, B, sgp::CHOL_THREADS,
                             smem_bytes, s, A, L, n);
}

extern "C" int batch_tri_solve(const float* L, const float* R, float* X, int B,
                               int n, int m, int lower, int nt, int warp_diag,
                               int smem_bytes, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (nt) {
#define SGP_TRI(NT)                                                              \
  case NT:                                                                       \
    return sgp::launch_batched(tri_solve_kernel<NT>, B, NT, smem_bytes, s, L, R, X, \
                               n, m, lower, warp_diag);
    SGP_TRI(32) SGP_TRI(64) SGP_TRI(128) SGP_TRI(256) SGP_TRI(512)
#undef SGP_TRI
  }
  return (int)cudaErrorInvalidValue;
}
