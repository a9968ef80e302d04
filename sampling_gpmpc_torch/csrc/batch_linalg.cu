// Batched small-matrix Cholesky and triangular solve, one matrix per CTA.
//
// Replaces the Pallas TPU kernels sampling_gpmpc_tpu/ops/batch_linalg.py::
// _chol_kernel (lower Cholesky, upper triangle zeroed) and ::_tri_kernel
// (L X = R, or L' X = R), which put the batch on the TPU's 128-wide lane
// axis.  Here each matrix is one CTA working in the (B, n, n) row-major
// layout: the TPU's moveaxis/lane padding glue is gone.
//
// chol_kernel (the body is sgp::chol_matrix in common.cuh, shared with
// batched_chol.cu): the lower triangle of A_i goes to dynamic shared memory
// (row stride n + 1, so a column read is conflict-free; 131,760 B at
// n = 180, hence the opt-in above 48 KB), sgp::chol_lower factors it
// right-looking with one barrier per column, and the write-out
// zeroes the upper triangle.  Only the lower triangle is read: for a
// symmetric input the TPU kernel's row read is the same numbers.  A
// non-positive pivot at column j0 gives NaN from that column on, and, as
// the TPU kernel's masked rank-1 update does (NaN * 0 in its rows > j0,
// columns < j0), NaN in the earlier columns of every row below j0; rows
// up to j0 keep their finite entries.
//
// tri_solve_kernel: the lower triangle of L_i and the n x m right-hand
// side sit in shared memory.  Column-oriented substitution, forward for
// L X = R and backward for L' X = R, where L' is read by swapped index
// (row j of L), so no transpose is copied.  Each column step every thread
// divides the pivot row itself and updates the other rows (one barrier per
// column); each row's own division happens once, at the end.  The update
// runs over every row with the TPU kernel's mask (coefficient 0 outside
// it), so a non-finite x_j spreads through the whole solution as there.
//
// What bounds them on the H100: bytes.  At the forward-sampling shape
// (B = 12,000 matrices of n = 50) one Cholesky moves 181 MB (the lower
// triangle read once, the whole factor written once), 54 us at 3.35 TB/s,
// against 5e8 flop (7.5 us at 67 TFLOP/s); a solve with m = 1 moves 66 MB
// (the factor's lower triangle and the right-hand side read, the solution
// written), 20 us, against 3e7 flop.  One CTA per matrix gives 12,000 CTAs
// of 10-11 KB of shared
// memory at that shape, several resident per SM; at n = 180 the 130 KB
// tile leaves one CTA per SM and the n dependent column steps dominate.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
chol_kernel(const float* __restrict__ A, float* __restrict__ L, int n) {
  extern __shared__ float sm[];
  const size_t off = (size_t)blockIdx.x * n * n;
  sgp::chol_matrix(A + off, L + off, n, 0.f, false, sm);
}

__global__ void __launch_bounds__(256)
tri_solve_kernel(const float* __restrict__ L, const float* __restrict__ R,
                 float* __restrict__ X, int n, int m, int lower) {
  extern __shared__ float sm[];
  const int i = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lda = n + 1, nm = n * m;
  float* sL = sm;                 // n x lda, lower triangle
  float* sX = sL + n * lda;       // n x m
  const float* Li = L + (size_t)i * n * n;
  const float* Ri = R + (size_t)i * nm;
  for (int e = tid; e < n * n; e += nt) {
    const int a = e / n, b = e % n;
    if (b <= a) sL[a * lda + b] = Li[e];
  }
  for (int e = tid; e < nm; e += nt) sX[e] = Ri[e];
  __syncthreads();
  for (int s = 0; s < n; ++s) {
    const int j = lower ? s : n - 1 - s;
    const float piv = sL[j * lda + j];
    for (int e = tid; e < nm; e += nt) {
      const int a = e / m, c = e % m;
      if (a == j) continue;          // the pivot row waits for the end
      const bool in = lower ? (a > j) : (a < j);
      const float f = in ? (lower ? sL[a * lda + j] : sL[j * lda + a]) : 0.f;
      const float xj = sX[j * m + c] / piv;
      sX[e] = __fsub_rn(sX[e], __fmul_rn(f, xj));
    }
    __syncthreads();
  }
  float* Xi = X + (size_t)i * nm;
  for (int e = tid; e < nm; e += nt) {
    const int a = e / m;
    Xi[e] = sX[e] / sL[a * lda + a];
  }
}

int threads_for(int work) {
  const int t = ((work < 256 ? work : 256) + 31) / 32 * 32;
  return t < 32 ? 32 : t;
}

}  // namespace

extern "C" int batch_chol(const float* A, float* L, int B, int n, int smem_bytes,
                          void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  chol_kernel<<<B, 256, smem_bytes, (cudaStream_t)stream>>>(A, L, n);
  return (int)cudaGetLastError();
}

extern "C" int batch_tri_solve(const float* L, const float* R, float* X, int B,
                               int n, int m, int lower, int smem_bytes,
                               void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tri_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  tri_solve_kernel<<<B, threads_for(n * m), smem_bytes, (cudaStream_t)stream>>>(
      L, R, X, n, m, lower);
  return (int)cudaGetLastError();
}
