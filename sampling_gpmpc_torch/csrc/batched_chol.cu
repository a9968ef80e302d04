// Cholesky of A + jitter I for a batch of small SPD matrices, one per CTA.
//
// Replaces the Pallas TPU kernel sampling_gpmpc_tpu/ops/pallas_chol.py::
// _chol_kernel (launched by batched_cholesky(use_pallas=True)): a per-
// matrix right-looking factorization whose column reads are masked
// reductions and whose factor accumulates as rank-1 outer products (Pallas
// on the TPU has no dynamic slice of a value).  On the H100 a column is
// just a strided read of shared memory, so the kernel is the plain right-
// looking sweep of sgp::chol_matrix (common.cuh, shared with
// batch_linalg.cu's chol_kernel): the lower triangle of A_i plus jitter on
// its diagonal goes to dynamic shared memory, sgp::chol_lower factors it
// with one barrier per column, and the write-out zeroes the upper
// triangle.  Only the lower triangle is read (the TPU kernel reads columns
// from the diagonal down, the same entries).
//
// A non-positive pivot at column j0: the TPU kernel's outer products carry
// NaN * 0 into every column of the rows from j0 down (its factor update
// L += lcol cmask' and its trailing update A -= l l'), so those rows of the
// factor are NaN in every column, the upper triangle included, while rows
// above j0 keep their finite entries.  The write-out reproduces that.
//
// What bounds it on the H100: bytes, as for batch_linalg.cu's Cholesky
// (the lower triangle read once and the whole factor written once; n^3/3
// flop each is far below the float32 rate at these sizes).  One CTA per
// matrix; at n = 180 the 131,760 B tile needs the opt-in above 48 KB.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
batched_chol_kernel(const float* __restrict__ A, float* __restrict__ L, int n,
                    float jitter) {
  extern __shared__ float sm[];
  const size_t off = (size_t)blockIdx.x * n * n;
  sgp::chol_matrix(A + off, L + off, n, jitter, true, sm);
}

}  // namespace

extern "C" int batched_chol(const float* A, float* L, int B, int n, float jitter,
                            int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      batched_chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  batched_chol_kernel<<<B, 256, smem_bytes, (cudaStream_t)stream>>>(A, L, n, jitter);
  return (int)cudaGetLastError();
}
