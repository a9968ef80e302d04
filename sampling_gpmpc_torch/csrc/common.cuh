// Block-level helpers shared by the port's CUDA kernels (gp_sample.cu,
// gp_hall.cu, ipm.cu, batch_linalg.cu, batched_chol.cu): warp/block
// reductions, NaN-propagating min/max
// (jnp.maximum / jnp.clip semantics, which the plain torch versions
// reproduce with torch.maximum / torch.minimum), an in-shared-memory
// right-looking Cholesky with one __syncthreads() per column, the batched
// Cholesky kernels' per-matrix body, and the GP kernels' shared draw +
// override tail.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sgp {

// NaN-propagating max/min: fmaxf/fminf drop NaN, jnp/torch keep it.
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nclip(float x, float lo, float hi) {
  return nmin(nmax(x, lo), hi);
}

struct SumOp { __device__ float operator()(float a, float b) const { return a + b; } };
struct MaxOp { __device__ float operator()(float a, float b) const { return nmax(a, b); } };
struct MinOp { __device__ float operator()(float a, float b) const { return fminf(a, b); } };

template <class Op>
__device__ __forceinline__ float warp_reduce(float v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Reduce one value per thread over the whole block; every thread gets the
// result.  `red` is >= 33 floats of shared memory.  Starts and ends with a
// barrier, so back-to-back calls may share `red`.
template <class Op>
__device__ float block_reduce(float v, float* red, Op op, float init) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_reduce(v, op);
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    float x = lane < nw ? red[lane] : init;
    x = warp_reduce(x, op);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  return red[32];
}

// In-place lower Cholesky of the n x n matrix whose lower triangle sits in
// shared memory A (row stride lda); the upper triangle is neither read nor
// written.  Right-looking, with the next column finalized during the
// trailing update (look-ahead) so each column costs one barrier; `lbuf`
// holds 2*n floats (the current and the next column, double-buffered),
// and a column reaches A one step after it is final, because during its
// step every thread still reads the previous values of the trailing block.
// A non-positive pivot yields NaN, which propagates to every later column
// (callers map non-finite results to their fallback, as the TPU kernels do).
__device__ void chol_lower(float* A, int n, int lda, float* lbuf) {
  const int tid = threadIdx.x, nt = blockDim.x;
  __syncthreads();
  {
    const float r = 1.0f / sqrtf(A[0]);
    for (int a = tid; a < n; a += nt) lbuf[a] = A[a * lda] * r;
  }
  __syncthreads();
  for (int j = 0; j < n - 1; ++j) {
    const float* l = lbuf + (j & 1) * n;
    float* ln = lbuf + ((j + 1) & 1) * n;
    const int j1 = j + 1, m = n - j1;
    const float piv = A[j1 * lda + j1] - l[j1] * l[j1];
    const float r = 1.0f / sqrtf(piv);
    for (int a = j + tid; a < n; a += nt) A[a * lda + j] = l[a];
    for (int e = tid; e < m * m; e += nt) {
      const int a = j1 + e / m, b = j1 + e % m;
      if (b > a) continue;
      if (b == j1) {
        ln[a] = (a == j1 ? piv : A[a * lda + b] - l[a] * l[b]) * r;
      } else {
        A[a * lda + b] = A[a * lda + b] - l[a] * l[b];
      }
    }
    __syncthreads();
  }
  const float* l = lbuf + ((n - 1) & 1) * n;
  for (int a = n - 1 + tid; a < n; a += nt) A[a * lda + n - 1] = l[a];
  __syncthreads();
}

// Lower Cholesky of one n x n matrix Ai (row-major in global memory) plus
// jitter on its diagonal, by the whole block, into Li with the upper
// triangle zeroed.  Only the lower triangle of Ai is read; it is factored
// in `sm` (n (n + 1) + 2 n floats of shared memory, row stride n + 1, so a
// column read is conflict-free) by chol_lower.  A non-positive pivot at
// column j0 writes the NaN pattern of the TPU kernel being replaced:
// nan_whole_rows false (batch_linalg) turns NaN the columns < j0 of every
// row > j0, the rest of the lower triangle keeping chol_lower's values
// (NaN from column j0 on); true (pallas_chol) turns every entry of the
// rows >= j0 NaN, the upper triangle included.
__device__ void chol_matrix(const float* __restrict__ Ai, float* __restrict__ Li,
                            int n, float jitter, bool nan_whole_rows, float* sm) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lda = n + 1;
  float* sA = sm;                 // n x lda, lower triangle
  float* lbuf = sA + n * lda;     // 2 n (column buffers of chol_lower)
  for (int e = tid; e < n * n; e += nt) {
    const int a = e / n, b = e % n;
    if (b <= a) sA[a * lda + b] = Ai[e] + (a == b ? jitter : 0.f);
  }
  chol_lower(sA, n, lda, lbuf);   // barriers on entry and exit
  int j0 = n;                     // first failed pivot, n if none
  for (int j = 0; j < n; ++j) {
    if (!isfinite(sA[j * lda + j])) { j0 = j; break; }
  }
  const float qnan = __int_as_float(0x7fc00000);
  for (int e = tid; e < n * n; e += nt) {
    const int a = e / n, b = e % n;
    float v = b <= a ? sA[a * lda + b] : 0.f;
    if (nan_whole_rows ? a >= j0 : (b <= a && a > j0 && b < j0)) v = qnan;
    Li[e] = v;
  }
}

// Pathwise draw y = mean + L eps and the override tail of one sample, in
// exactly pallas_gp._override_tail's order: relative variance floor, zero
// variance -> mean (Ty>1: all tasks of the point), min-dist -> nearest
// train row, beta clip, non-finite -> mean.  L (lower, row stride ldl),
// mean and var (the posterior variance, floored here in place) sit in
// shared memory; close/ynear are null when the min-dist override is off.
// Every thread of the block must call it (one barrier inside).
__device__ void draw_override_tail(const float* L, int ldl, const float* mean,
                                   float* var, const float* eps,
                                   const float* pv, const float* close,
                                   const float* ynear, float* dg, int Ht,
                                   int ty, float beta, float var_zero,
                                   float rel_floor) {
  const int tid = threadIdx.x, nt = blockDim.x;
  // variance floors first: the zero-variance group test reads neighbours
  for (int t = tid; t < Ht; t += nt) {
    float v = nmax(var[t], 0.f);
    if (rel_floor > 0.f && v < rel_floor * pv[t]) v = 0.f;
    var[t] = v;
  }
  __syncthreads();
  for (int t = tid; t < Ht; t += nt) {
    float d = 0.f;
    for (int s = 0; s <= t; ++s) d = fmaf(eps[s], L[t * ldl + s], d);
    const float mu = mean[t];
    const float v = var[t];
    float y = mu + d;
    if (var_zero >= 0.f) {
      if (ty <= 1) {
        if (v <= var_zero) y = mu;
      } else {
        const int g0 = (t / ty) * ty;
        int cnt = 0;
        for (int u = g0; u < g0 + ty; ++u) cnt += (var[u] <= var_zero);
        if (cnt >= ty) y = mu;
      }
    }
    if (close != nullptr && close[t] > 0.f) y = ynear[t];
    const float sd = sqrtf(v);
    y = nclip(y, mu - beta * sd, mu + beta * sd);
    dg[t] = isfinite(y) ? y : mu;
  }
}

}  // namespace sgp
