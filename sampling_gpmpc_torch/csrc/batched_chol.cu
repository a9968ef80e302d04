// Cholesky of A + jitter I for a batch of small SPD matrices, one per CTA.
//
// Replaces the Pallas TPU kernel sampling_gpmpc_tpu/ops/pallas_chol.py::
// _chol_kernel (launched by batched_cholesky(use_pallas=True)): a per-
// matrix right-looking factorization whose column reads are masked
// reductions and whose factor accumulates as rank-1 outer products (Pallas
// on the TPU has no dynamic slice of a value).  On the H100 the kernel is
// the right-looking blocked Cholesky of sgp::chol_matrix (common.cuh,
// shared with batch_linalg.cu's chol_kernel and, through
// sgp::factor_panel, with gp_hall.cu): the lower triangle of A_i goes into
// 32x32 lower tiles of dynamic shared memory with the jitter added on its
// diagonal, each 32-column panel is a warp's register Cholesky of the
// diagonal tile, per-row register solves below it and 4x4 register-tiled
// trailing updates (about three barriers per panel), and the write-out
// zeroes the upper triangle.  Only the lower triangle is read (the TPU
// kernel reads columns from the diagonal down, the same entries).
//
// A non-positive pivot at column j0: the TPU kernel's outer products carry
// NaN * 0 into every column of the rows from j0 down (its factor update
// L += lcol cmask' and its trailing update A -= l l'), so those rows of the
// factor are NaN in every column, the upper triangle included, while rows
// above j0 keep their finite entries.  The write-out reproduces that.
//
// What bounds it on the H100: bytes, as for batch_linalg.cu's Cholesky
// (the lower triangle read once and the whole factor written once; n^3/3
// flop each is far below the float32 rate at these sizes).  One matrix per
// CTA, 128 threads up to n = 64 and 512 above, as there; the tiles take
// 88,704 B at n = 180 and 152,064 B at n = 239 (the opt-in above 48 KB).
#include "common.cuh"

namespace {

template <int NT>
__global__ void __launch_bounds__(NT)
batched_chol_kernel(const float* __restrict__ A, float* __restrict__ L, int n,
                    float jitter) {
  extern __shared__ float sm[];
  const size_t off = (size_t)blockIdx.x * n * n;
  sgp::chol_matrix(A + off, L + off, n, jitter, true, sm);
}

}  // namespace

extern "C" int batched_chol(const float* A, float* L, int B, int n, float jitter,
                            int smem_bytes, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n <= sgp::CHOL_SMALL_N)
    return sgp::launch_batched(batched_chol_kernel<sgp::CHOL_SMALL_THREADS>, B,
                               sgp::CHOL_SMALL_THREADS, smem_bytes, s, A, L, n,
                               jitter);
  return sgp::launch_batched(batched_chol_kernel<sgp::CHOL_THREADS>, B,
                             sgp::CHOL_THREADS, smem_bytes, s, A, L, n, jitter);
}
