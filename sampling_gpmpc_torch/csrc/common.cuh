// Block-level helpers shared by the port's CUDA kernels (gp_sample.cu,
// gp_hall.cu, ipm.cu, batch_linalg.cu, batched_chol.cu): warp
// reductions, NaN-propagating min/max
// (jnp.maximum / jnp.clip semantics, which the plain torch versions
// reproduce with torch.maximum / torch.minimum), an in-shared-memory
// right-looking Cholesky with one __syncthreads() per column (ipm), the
// right-looking blocked Cholesky in 32-column panels over 32x32 lower
// tiles (gp_sample, gp_hall, and the batched Cholesky kernels' per-matrix
// body chol_matrix; the tiles may sit in shared or in global memory), and
// the GP kernels' shared draw + override tail.
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

constexpr int TB = 32;              // blocked factor's tile and panel width
constexpr int TLD = TB + 1;         // tile row stride: column reads are conflict-free
constexpr int TILE_FLOATS = TB * TLD;

// The lower triangle of an n x n matrix as 32x32 tiles, tile (I, J), I >= J,
// at index I (I + 1) / 2 + J, in shared memory or, where they do not fit
// there, in a global workspace (the same code serves both).
struct Tiles {
  float* T;
  __device__ float* tile(int I, int J) const {
    return T + (I * (I + 1) / 2 + J) * TILE_FLOATS;
  }
  __device__ float& at(int r, int c) const {
    return tile(r / TB, c / TB)[(r % TB) * TLD + c % TB];
  }
};

// In-place lower Cholesky of an n x n matrix (n <= 32) whose lower triangle
// sits in shared memory A (row stride lda), by one warp with the rows in
// registers (lane i holds row i; column j's entries come from the other
// lanes by shuffles): no barrier and no shared-memory traffic inside the
// sweep.  The same right-looking arithmetic as chol_lower: column j is
// scaled by 1/sqrt(pivot), the diagonal becomes pivot/sqrt(pivot); a
// non-positive pivot yields NaN from that column on.  Only the lower
// triangle is read and written.  Every lane of the warp must call it.
__device__ __forceinline__ void warp_chol32(float* A, int lda, int n) {
  const int lane = threadIdx.x & 31;
  float a[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) a[c] = (c <= lane && lane < n) ? A[lane * lda + c] : 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j < n) {
      const float d = __shfl_sync(0xffffffffu, a[j], j);
      const float r = 1.0f / sqrtf(d);
      a[j] = lane == j ? d * r : a[j] * r;
#pragma unroll
      for (int c = j + 1; c < 32; ++c) {
        const float lc = __shfl_sync(0xffffffffu, a[j], c);
        if (c < n) a[c] = fmaf(-a[j], lc, a[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 32; ++c)
    if (c <= lane && lane < n) A[lane * lda + c] = a[c];
  __syncwarp();
}

// The q-th lower tile (a, b), a >= b, of a triangle of tiles, q = a (a + 1)
// / 2 + b.
__device__ __forceinline__ void lower_tile(int q, int& a, int& b) {
  a = (int)((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
  while ((a + 1) * (a + 2) / 2 <= q) ++a;
  while (a * (a + 1) / 2 > q) --a;
  b = q - a * (a + 1) / 2;
}

// One panel of the right-looking blocked Cholesky of the tiles M by the
// whole block: columns 32k .. 32k+nc-1 of the rows < nrows (nc < 32 only on
// a last panel, which has no rows below it).  Three block barriers:
// (a) one warp factors the diagonal tile with its rows in registers
// (warp_chol32); (b) one thread per row below solves that row against it in
// registers; (c) the trailing lower tiles take P_I P_J' as 4x4
// register-tiled FFMA, 64 threads per tile.  Tile entries past nrows must
// be finite (they are read by (c) and written only there).
__device__ void factor_panel(const Tiles& M, int k, int nrows) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int c0 = k * TB, nc = min(TB, nrows - c0);
  float* D = M.tile(k, k);
  // (a) the diagonal tile in one warp, its rows in registers
  if (tid < 32) warp_chol32(D, TLD, nc);
  __syncthreads();
  const int nrow_below = nrows - c0 - TB;
  if (nrow_below <= 0) return;
  // (b) every row below the tile: x <- x L_kk^-T, in registers
  for (int rr = tid; rr < nrow_below; rr += nt) {
    const int r = c0 + TB + rr;
    float* row = M.tile(r / TB, k) + (r % TB) * TLD;
    float x[TB];
#pragma unroll
    for (int j = 0; j < TB; ++j) x[j] = row[j];
#pragma unroll
    for (int j = 0; j < TB; ++j) {
      x[j] = x[j] / D[j * TLD + j];
#pragma unroll
      for (int c = j + 1; c < TB; ++c) x[c] = fmaf(-x[j], D[c * TLD + j], x[c]);
    }
#pragma unroll
    for (int j = 0; j < TB; ++j) row[j] = x[j];
  }
  __syncthreads();
  // (c) trailing lower tiles (I, J), k < J <= I: T_IJ -= P_I P_J'
  const int tl = (nrows + TB - 1) / TB, m = tl - k - 1;
  const int jobs = m * (m + 1) / 2 * 64;
  for (int e = tid; e < jobs; e += nt) {
    const int t = e % 64;
    int a, b;
    lower_tile(e / 64, a, b);
    const int I = k + 1 + a, J = k + 1 + b;
    const float* PI = M.tile(I, k);
    const float* PJ = M.tile(J, k);
    float* O = M.tile(I, J);
    const int ty = t / 8, tx = t % 8;
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < TB; ++kk) {
      float pa[4], pb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) pa[u] = PI[(ty + 8 * u) * TLD + kk];
#pragma unroll
      for (int v = 0; v < 4; ++v) pb[v] = PJ[(tx + 8 * v) * TLD + kk];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(pa[u], pb[v], acc[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) O[(ty + 8 * u) * TLD + tx + 8 * v] -= acc[u][v];
  }
  __syncthreads();
}

// The first jitter on row t of a GP stage's covariance: the configured
// jitter, or jitter_rel times the prior variance of the row's task where
// that is larger, so that it stays above the float32 rounding of the
// covariance (ops/gp_sample.py::row_jitter).
__device__ __forceinline__ float row_jitter(float jitter, float jitter_rel,
                                            const float* pv, int t) {
  return fmaxf(jitter, jitter_rel * pv[t]);
}

// exact.safe_cholesky's float32 retry of a covariance factored in the
// tiles M by factor_panel, its block from row and column c0 (a tile
// boundary) to row n, each row a counted from c0 factored with its first
// jitter jit0(a) on the diagonal: while the factor failed (a non-positive
// pivot leaves the last diagonal entry M(n-1, n-1) non-finite) and ten
// times the jitter stays within max(1e-3 x the mean of var[0, n - c0),
// 1e-2) (the largest row's jitter, ten times that of the last try), the
// block is rebuilt from base(a, c) (its lower entries before the factor,
// holding jit0 on the diagonal where `added`) with every row's jitter
// multiplied by ten and factored again.  A block that fails at every
// jitter is rebuilt at the first jitter and factored once more: the first
// factor, NaN from the failing column on, for the non-finite -> mean
// backstop.  A rebuild writes the block's tiles whole, zero above the
// diagonal and past row n (factor_panel reads them and needs them finite).
// Every thread calls it after the first factor's closing barrier; the
// loop's condition is the same in every thread (shared values read after a
// barrier, the sums in one order).  The products are rounded on their own
// (__fmul_rn), never fused with the sums, as the plain version
// ops/gp_sample.py::factor_retried rounds them.
template <class Base, class Jit>
__device__ void factor_retry(const Tiles& M, int c0, int n, const Base& base, bool added,
                             const float* var, const Jit& jit0) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int t0 = c0 / TB, tl = (n + TB - 1) / TB, m = n - c0;
  const int ntile = (tl - t0) * (tl - t0 + 1) / 2;
  float mult = 1.f, cap = -1.f, jmax = 0.f;
  // a NaN or an infinity fails the comparison
  while (!(fabsf(M.at(n - 1, n - 1)) <= 3.402823466e38f)) {
    if (cap < 0.f) {
      float s = 0.f;
      for (int t = 0; t < m; ++t) {
        s += var[t];
        jmax = fmaxf(jmax, jit0(t));
      }
      cap = fmaxf(1e-3f * (s / (float)m), 1e-2f);
    }
    const bool more = __fmul_rn(__fmul_rn(mult, 10.f), jmax) <= cap;
    if (!more && mult == 1.f) return;
    mult = more ? __fmul_rn(mult, 10.f) : 1.f;
    for (int e = tid; e < ntile * TILE_FLOATS; e += nt) {
      int I, J;
      lower_tile(e / TILE_FLOATS, I, J);
      const int r = (e % TILE_FLOATS) / TLD, cc = (e % TILE_FLOATS) % TLD;
      const int a = I * TB + r, c = J * TB + cc;
      float v = 0.f;
      if (cc < TB && a < m && c <= a) {
        v = base(a, c);
        if (a == c) {
          const float j = jit0(a);
          v = v + (__fmul_rn(mult, j) - (added ? j : 0.f));
        }
      }
      M.tile(t0 + I, t0 + J)[r * TLD + cc] = v;
    }
    __syncthreads();
    for (int k = t0; k < tl; ++k) factor_panel(M, k, n);   // ends in a barrier
    if (!more) return;
  }
}

// Copy 4 bytes from global to shared memory without a register in between
// (cp.async): a thread keeps all its copies in flight at once.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

// The batched Cholesky kernels' launch shape, chosen from n: one matrix per
// CTA; while the factor has one or two panels (n <= 64) a CTA of 128
// threads, which measured faster on an H100 than 32 or 64 across the n <=
// 64 shapes (more warps for the loads and the write-out, 12,672 B of tiles
// at n = 50), and 512 threads above, which measured faster than 128 or 256
// (more threads for the trailing tiles of the early panels).
constexpr int CHOL_SMALL_N = 64;
constexpr int CHOL_SMALL_THREADS = 128;
constexpr int CHOL_THREADS = 512;

// Lower Cholesky of one n x n matrix Ai (row-major in global memory) plus
// jitter on its diagonal, by the whole block, into Li.  Only the lower
// triangle of Ai is read: its rows go, one warp per row and lanes over the
// columns (coalesced), straight into the 32x32 lower tiles in `sm` (t (t +
// 1) / 2 tiles of shared memory, t = ceil(n / 32)) by cp.async, the tiles'
// other entries (above the diagonal, the rows past n that pad the last
// tile) are zeroed, and the jitter is added on the diagonal.  factor_panel then factors it
// panel by panel (about three barriers per 32 columns), with the rows past
// n outside every panel.  The write-out takes each row of the n x n factor
// by one warp, upper triangle zero.
//
// A non-positive pivot gives a non-finite diagonal from its column j0 on;
// j0, the first non-finite diagonal, is found by a warp ballot in every
// warp, and the write-out sets the NaN pattern of the TPU kernel being
// replaced from j0 alone, whatever the factor holds there: nan_whole_rows
// false (batch_linalg) turns NaN every lower entry of the rows > j0 and the
// diagonal entry of row j0 (NaN from column j0 on, and in the columns < j0
// of every row > j0); true (pallas_chol) turns every entry of the rows >=
// j0 NaN, the upper triangle included.  Rows < j0 hold the factor.
__device__ void chol_matrix(const float* __restrict__ Ai, float* __restrict__ Li,
                            int n, float jitter, bool nan_whole_rows, float* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int ntile = (n + TB - 1) / TB;
  const Tiles M{sm};
  for (int a = warp; a < ntile * TB; a += nw) {
    const int I = a / TB, r = a % TB;
    for (int J = 0; J <= I; ++J) {
      const int c = J * TB + lane;
      float* dst = M.tile(I, J) + r * TLD + lane;
      if (a < n && c <= a) cp_async4(dst, Ai + (size_t)a * n + c);
      else *dst = 0.f;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  for (int a = warp; a < n; a += nw)          // the thread that copied (a, a)
    if (lane == a % TB) M.at(a, a) += jitter;
  __syncthreads();
  for (int k = 0; k < ntile; ++k) factor_panel(M, k, n);   // ends in a barrier

  int j0 = n;                     // first failed pivot, n if none
  for (int b = 0; b < n; b += TB) {
    const int j = b + lane;
    const unsigned bad = __ballot_sync(0xffffffffu, j < n && !isfinite(M.at(j, j)));
    if (bad) {
      j0 = b + __ffs(bad) - 1;
      break;
    }
  }
  const float qnan = __int_as_float(0x7fc00000);
  for (int a = warp; a < n; a += nw) {
    const float* src = M.tile(a / TB, 0) + (a % TB) * TLD;
    float* dst = Li + (size_t)a * n;
    for (int J = 0, c = lane; c < n; ++J, c += TB) {
      float v = c <= a ? src[J * TILE_FLOATS + lane] : 0.f;
      if (nan_whole_rows ? a >= j0 : (c <= a && (a > j0 || (a == j0 && c == a))))
        v = qnan;
      dst[c] = v;
    }
  }
}

// Launch a batched Cholesky or triangular-solve kernel, one matrix per CTA
// of nt threads with smem bytes of dynamic shared memory (the opt-in above
// 48 KB, and the whole of the SM's unified memory for shared memory, so the
// small CTAs fit 16 to an SM); returns the launch's cudaError_t.
template <class Kernel, class... Args>
int launch_batched(Kernel kernel, int B, int nt, int smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, nt, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Pathwise draw y = mean + L eps and the override tail of one sample, in
// exactly pallas_gp._override_tail's order: relative variance floor, zero
// variance -> mean (Ty>1: all tasks of the point), min-dist -> nearest
// train row, beta clip, non-finite -> mean.  L (lower, read as L(t, s) for
// s <= t through the accessor), mean and var (the posterior variance,
// floored here in place) sit in shared memory; close/ynear are null when
// the min-dist override is off.  Every thread of the block must call it
// (one barrier inside).
template <class LAt>
__device__ void draw_override_tail_at(const LAt& L, const float* mean,
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
    for (int s = 0; s <= t; ++s) d = fmaf(eps[s], L(t, s), d);
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

// The lower factor held in Tiles from row and column `off` on, as
// draw_override_tail_at reads it.
struct TiledAt {
  Tiles M;
  int off;
  __device__ float operator()(int t, int s) const { return M.at(off + t, off + s); }
};

}  // namespace sgp
