// Structured soft-constraint QP: prepare kernel + Mehrotra loop kernel.
//
// Replaces the Pallas TPU kernels of sampling_gpmpc_tpu/ops/pallas_ipm.py:
//   ipm_prepare_kernel  <- _prepare_kernel (row equilibration, qscale, the
//       central-path cold start at mu0 = qscale, the duals-only warm start
//       mapped into the new row scaling with staleness tau and the
//       complementarity band [ws_floor, ws_cap]*mu_ws, and the warm/cold
//       choice by their KKT residuals at u = 0);
//   ipm_mehrotra_kernel <- _kernel driven by _run_chunks (Schur matrix
//       H + Gh' diag(w_h) Gh + Gs' diag(w_eff) Gs with the soft slacks
//       eliminated, Jacobi scaling + reg, Cholesky, predictor and corrector
//       solves, 0.99 step to the boundary, sigma = (mu_aff/mu)^3, non-finite
//       step rejection, best iterate by relative KKT residual, stall exit,
//       exact max_iter cap).
// The TPU's CHUNK re-invocation and (8,128) padding are scalar-pipeline /
// tiling workarounds with no counterpart here: the whole loop runs in one
// launch with the exact single-loop semantics (one iteration counter, one
// stall counter, one global best residual), and no row is padded, so the
// TPU's pad conventions (slack 1, dual 0, zero G columns) are moot.
//
// Layout: G is stored TRANSPOSED, Gt (nU, m), written scaled by the prepare
// kernel, so every matvec and the Schur sums walk m with consecutive
// threads on consecutive addresses.  State rows: h = [th, lh] (2, m_h),
// s = [tU, tL, sl, su, lU, lL, nl, nu] (8, m_s); dh = [d, 1/(1+|d|)];
// sd = [lo, hi, zl, zu, Zl, Zu, 1/(1+|hi|), 1/(1+|lo|)].
//
// What bounds the loop on the H100: per Mehrotra iteration it reads G about
// nine times (Schur pass, stationarity, four matvecs for the two Newton
// directions, KKT), ~4 B * nU * (m_h + m_s) each; at the flagship shape
// (nU=17, m_h=7174, m_s=70) G is ~490 KB.  One CTA on one SM of 132 reads
// it from L2 at that SM's share of the bandwidth, behind ~30 block
// barriers per iteration.  The design spreads one QP over a thread-block
// cluster of 16 CTAs (a non-portable size the H100 co-schedules): each CTA
// owns a contiguous slice of the hard and of the soft rows and
// keeps, for the whole loop, its columns of Gth/Gts and its rows of the
// state, the deltas and the per-row weights in its own shared memory
// (~31 KB of G per CTA at the flagship shape), so every matvec and the
// Schur pass read G from the SM's own shared memory.  Where a slice does
// not fit (a wide QP: nU=20, m_h ~ 52,000), the same code reads G and the
// state rows from global memory (the Schur pass stages G in chunks).
// Partial sums cross the cluster through distributed shared memory: each
// CTA publishes its partials (the nU x nU Schur sums, the nU-vectors of the
// matvecs, the scalar reductions) in its shared memory, cluster.sync()
// publishes them, and every CTA adds every rank's partials in rank order, so
// every CTA holds the same Schur matrix, factor, du and scalars and takes
// the same decisions; each CTA loads every rank's partial at once, so a
// reduction costs about one DSMEM latency.  The nU-sized work (Jacobi
// scaling, the Cholesky and the two triangular solves) runs redundantly in
// each CTA (nU <= 128); up to WARP_CHOL_MAX the factor and the solves take
// one warp, without per-row warp reductions.  256 threads a CTA, so a
// thread may hold 255 registers.  Per iteration: 8
// cluster barriers (Schur + stationarity, two directions, two step lengths,
// mu_aff, the finiteness vote, KKT + mu).
//
// The prepare kernel moves each input once: it reads G (row-major, ~490 KB
// at the pendulum's QP, ~300 KB at the car's) and writes it transposed and
// scaled, plus a few floats per row; its bound is those bytes (~0.3 us).
// Its first design ran on one CTA of one SM: each thread walked one row of
// G (a warp's loads 32 rows apart), and the warm start's three matvecs
// re-read the transposed G from global memory one warp per column.  This
// design runs it on the loop kernel's cluster with the same row slices
// (row_slice), 512 threads a CTA:
//   pass 1: each CTA's rows of G_h and of G_s are one contiguous block of
//       the input; it comes in chunks by 16-byte cp.async, one chunk ahead
//       of the one being worked on, is transposed in shared memory (odd row
//       stride, the staged rows read in order), and its row maxima are
//       taken there; the scaled transpose goes to Gth/Gts with consecutive
//       threads on consecutive rows;
//   reduction 1: qscale (max|g|, max zl') over the cluster;
//   pass 2 + reduction 2 (warm start only): one pass over the slice forms
//       the staleness vector G'(lam_w) and the cold start's stationarity
//       vector, primal residual and complementarity sum;
//   pass 3 + reduction 3: the warm candidate from tau, its stationarity
//       vector, primal residual and complementarity sum;
//   then every CTA, holding the same reduced values, takes the same
//   warm/cold decision and writes its rows of the chosen start straight to
//   h0/s0, and rank 0 writes qscale and the one-word `warm` flag.
// A cold call (no carried duals) runs pass 1 and reduction 1 only.
// Reductions go through distributed shared memory in rank order
// (reduce_over_cluster, shared with the loop kernel).  Where the slice's
// transposed columns, row values and warm candidate fit shared memory
// (prepare_layout in ops/ipm.py: both closed loops' QPs), they stay there
// and passes 2-3 read them in place; else (RES = false: nU=20, m_h=52,000)
// pass 1 stages fixed-size chunks, passes 2-3 read Gth/Gts back from global
// memory chunk by chunk, and the warm candidate is written to h0/s0 in pass
// 3 (overwritten by the cold start if rejected).  The branch is a template
// argument, so every shared-memory access compiles as one.
//
// QPs with no soft rows (m_s = 0: the pendulum configs, the residual car)
// run a hard-only build of both kernels (template argument SOFT = false),
// the counterpart of the `if m_s` branches of the JAX package's XLA body
// (ocp/qp.py::solve_qp_soft; its Pallas gate refuses m_s = 0): the soft
// slice length is a compile-time 0, so no soft row is staged, reduced or
// stepped; m_total = m_h; qscale = 1 + max|g| needs no cluster reduction;
// the staging buffers carry one row input (d_h) instead of six.  No dummy
// soft row is padded in: that would change m_total, mu and the iterates.
// This source builds two libraries (ops/build.py), each instantiating one
// value of SOFT, so that the two compile in parallel: IPM_SOFT = 1 (the
// default, library `ipm`) and IPM_SOFT = 0 (library `ipm_hard`).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#ifndef IPM_SOFT
#define IPM_SOFT 1
#endif

namespace {

constexpr bool kSoft = IPM_SOFT != 0;   // the kernels' build in this library

constexpr int NT_LOOP = 256;    // loop kernel: up to 255 registers a thread
// Schur pairs per thread: ceil(nU (nU + 1) / 2 / NT_LOOP); the loop kernel
// is instantiated for up to 3 (nU <= 38: the closed loops' QPs, few
// registers) and for up to 33 (nU <= 128)
constexpr int MAXP_SMALL = 3;
constexpr int MAXP = 33;
constexpr int CL = 16;            // CTAs of the cluster that runs one QP
// One-warp Cholesky and solves up to this nU (one row a lane), the
// block-wide ones above it: on the H100 the one-warp path is the faster at
// both closed loops' nU (17 and 30), the block-wide one runs for nU > 32.
constexpr int WARP_CHOL_MAX = 32;
constexpr int PUB = 136;  // floats of one publish buffer: nU + 2 <= 130
constexpr int SMEM_OPT_IN = 232448;

// out[p] = sum_i G[p*ld + i] v[i] over rows i < rows: one warp per p,
// lanes along the rows.
__device__ void gtv(const float* __restrict__ G, int ld, const float* __restrict__ v,
                    int nU, int rows, float* out) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int p = w; p < nU; p += nw) {
    const float* row = G + (size_t)p * ld;
    float acc = 0.f;
    for (int i = lane; i < rows; i += 32) acc = fmaf(row[i], v[i], acc);
    acc = sgp::warp_reduce(acc, sgp::SumOp());
    if (lane == 0) out[p] = acc;
  }
}

// (G u)[i] of row i, G stored transposed with row stride ld.
__device__ __forceinline__ float g_row(const float* __restrict__ G, int ld,
                                       const float* u, int nU, int i) {
  float acc = 0.f;
  for (int p = 0; p < nU; ++p) acc = fmaf(G[(size_t)p * ld + i], u[p], acc);
  return acc;
}

// (H u)[p] with symmetric H, summed as dot(u, H[:, p]).
__device__ __forceinline__ float h_row(const float* __restrict__ H,
                                       const float* u, int nU, int p) {
  float acc = 0.f;
  for (int q = 0; q < nU; ++q) acc = fmaf(u[q], H[q * nU + p], acc);
  return acc;
}

// Lower-triangle pairs (p >= q) owned by this thread: k = tid + j * blockDim.
template <int MP>
struct Pairs {
  int p[MP], q[MP], n;
  __device__ Pairs(int nU) : n(0) {
    const int npairs = nU * (nU + 1) / 2;
#pragma unroll
    for (int j = 0; j < MP; ++j) {
      const int k = threadIdx.x + j * blockDim.x;
      int a = 0;
      if (k < npairs) {
        a = (int)((sqrtf(8.f * k + 1.f) - 1.f) * 0.5f);
        while ((a + 1) * (a + 2) / 2 <= k) ++a;
        while (a * (a + 1) / 2 > k) --a;
        n = j + 1;
      }
      p[j] = a;
      q[j] = k < npairs ? k - a * (a + 1) / 2 : 0;
    }
  }
};

// s + sum_c (a[c] w[c]) b[c], in four independent partial sums (the loads
// of four rows in flight at once).
__device__ __forceinline__ float weighted_dot(const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              const float* __restrict__ w, int m,
                                              float s) {
  float s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int c = 0;
  for (; c + 4 <= m; c += 4) {
    s = fmaf(a[c] * w[c], b[c], s);
    s1 = fmaf(a[c + 1] * w[c + 1], b[c + 1], s1);
    s2 = fmaf(a[c + 2] * w[c + 2], b[c + 2], s2);
    s3 = fmaf(a[c + 3] * w[c + 3], b[c + 3], s3);
  }
  for (; c < m; ++c) s = fmaf(a[c] * w[c], b[c], s);
  return (s + s1) + (s2 + s3);
}

// acc[j] += sum_i (G[p_j][i] w[i]) G[q_j][i] over rows i < m.  Resident
// (G and w in shared memory): read in place.  Streamed: stage `chunk` rows
// of G at a time in shared memory (sG: nU x (chunk+1), sW: chunk).
template <int MP>
__device__ void schur_acc(const float* __restrict__ G, int ld,
                          const float* __restrict__ w, int nU, int m, bool resident,
                          int chunk, float* sG, float* sW, const Pairs<MP>& pr,
                          float* acc) {
  if (resident) {
#pragma unroll
    for (int j = 0; j < MP; ++j) {
      if (j < pr.n) {
        acc[j] = weighted_dot(G + pr.p[j] * ld, G + pr.q[j] * ld, w, m, acc[j]);
      }
    }
    return;
  }
  const int tid = threadIdx.x, nt = blockDim.x, lds = chunk + 1;
  for (int i0 = 0; i0 < m; i0 += chunk) {
    const int cn = min(chunk, m - i0);
    __syncthreads();
    for (int e = tid; e < nU * cn; e += nt) {
      const int p = e / cn, c = e % cn;
      sG[p * lds + c] = G[(size_t)p * ld + i0 + c];
    }
    for (int c = tid; c < cn; c += nt) sW[c] = w[i0 + c];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MP; ++j) {
      if (j < pr.n) {
        acc[j] = weighted_dot(sG + pr.p[j] * lds, sG + pr.q[j] * lds, sW, cn, acc[j]);
      }
    }
  }
  __syncthreads();
}

// Reduce one value per thread over the whole block with one barrier; every
// thread gets the result (each warp reduces the warps' partials in the same
// order).  `red` holds two slots of 32 floats used in turn (`par` flips), so
// a slot is rewritten only after a later barrier, when every thread has
// read it.
template <class Op>
__device__ float block_reduce1(float v, float* red, int& par, Op op, float init) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  float* slot = red + 32 * par;
  par ^= 1;
  v = sgp::warp_reduce(v, op);
  if (lane == 0) slot[w] = v;
  __syncthreads();
  return sgp::warp_reduce(lane < nw ? slot[lane] : init, op);
}

// This CTA's rows of one QP spread over a cluster of CL CTAs: hard rows
// [hb, hb + nh), soft rows [sb, sb + ns); contiguous, in rank order, at
// most ceil(m / CL) each, possibly empty (m < CL).  Both kernels slice the
// rows this way.
// SOFT = false (a QP with no soft rows, m_s = 0): no soft slice, its
// length a compile-time 0, so every soft loop of either kernel compiles
// away.
struct RowSlice {
  int hb, nh, sb, ns;
};
template <bool SOFT>
__device__ __forceinline__ RowSlice row_slice(int m_h, int m_s, int rank) {
  RowSlice r;
  r.hb = (int)((long long)m_h * rank / CL);
  r.nh = (int)((long long)m_h * (rank + 1) / CL) - r.hb;
  r.sb = SOFT ? (int)((long long)m_s * rank / CL) : 0;
  r.ns = SOFT ? (int)((long long)m_s * (rank + 1) / CL) - r.sb : 0;
  return r;
}

// Cluster-wide reduction of n values this CTA holds in shared `vals`:
// entries [0, nsum) summed, [nsum, nsum + nmax) NaN-max'ed, the rest
// min'ed, over the ranks in order; every CTA gets the same result in
// `vals`.  `pub` holds two publish buffers of `stride` floats that
// alternate (`par` flips), so a buffer is rewritten only after a later
// cluster barrier, when every rank has read it.
__device__ __forceinline__ void reduce_over_cluster(cg::cluster_group& cluster, float* pub,
                                               int stride, int& par, float* vals, int n,
                                               int nsum, int nmax) {
  const int tid = threadIdx.x, nt = blockDim.x;
  __syncthreads();
  float* mine = pub + par * stride;
  for (int e = tid; e < n; e += nt) mine[e] = vals[e];
  cluster.sync();
  for (int e = tid; e < n; e += nt) {
    float x[CL];                // every rank's load in flight at once
#pragma unroll
    for (int r = 0; r < CL; ++r) x[r] = cluster.map_shared_rank(mine, r)[e];
    float acc = x[0];
#pragma unroll
    for (int r = 1; r < CL; ++r)
      acc = e < nsum ? acc + x[r]
                     : (e < nsum + nmax ? sgp::nmax(acc, x[r]) : fminf(acc, x[r]));
    vals[e] = acc;
  }
  __syncthreads();
  par ^= 1;
}

// Solve L L' x = b in place (x holds b), L lower in shared memory; one warp.
__device__ void chol_solve_warp(const float* L, int ld, int n, float* x) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < n; ++j) {
    float acc = 0.f;
    for (int k = lane; k < j; k += 32) acc = fmaf(L[j * ld + k], x[k], acc);
    acc = sgp::warp_reduce(acc, sgp::SumOp());
    const float y = (x[j] - acc) / L[j * ld + j];
    __syncwarp();
    if (lane == 0) x[j] = y;
    __syncwarp();
  }
  for (int j = n - 1; j >= 0; --j) {
    float acc = 0.f;
    for (int k = j + 1 + lane; k < n; k += 32) acc = fmaf(L[k * ld + j], x[k], acc);
    acc = sgp::warp_reduce(acc, sgp::SumOp());
    const float z = (x[j] - acc) / L[j * ld + j];
    __syncwarp();
    if (lane == 0) x[j] = z;
    __syncwarp();
  }
}

// In-place lower Cholesky of an n x n matrix (n <= 32) in shared memory A
// (row stride lda) by one warp, right-looking: column j scaled by
// 1/sqrt(pivot) (the diagonal becomes pivot/sqrt(pivot)), then lane c
// updates column c of the trailing block down its rows.  rdiag[j] =
// 1/L[j][j] for chol_solve_warp32.  A non-positive pivot yields NaN from
// that column on.  Every lane of the warp must call it.
__device__ void chol_warp32(float* A, int lda, int n, float* rdiag) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < n; ++j) {
    __syncwarp();
    const float d = A[j * lda + j];
    const float r = 1.0f / sqrtf(d);
    __syncwarp();
    if (lane == j) {
      A[j * lda + j] = d * r;
      rdiag[j] = 1.0f / (d * r);
    } else if (lane > j && lane < n) {
      A[lane * lda + j] *= r;
    }
    __syncwarp();
    if (lane > j && lane < n) {
      const float lc = A[lane * lda + j];
      for (int i = lane; i < n; ++i)
        A[i * lda + lane] = fmaf(-A[i * lda + j], lc, A[i * lda + lane]);
    }
  }
  __syncwarp();
}

// The same solve for n <= 32 against chol_warp32's factor, lane i holding
// b_i: forward and back substitution column by column (each x_j broadcast
// by a shuffle, the column of L read from shared memory), no warp
// reduction per row.
__device__ void chol_solve_warp32(const float* L, int ld, int n, const float* rdiag,
                                  float* x) {
  const int lane = threadIdx.x & 31;
  float b = lane < n ? x[lane] : 0.f;
  for (int j = 0; j < n; ++j) {
    const float yj = __shfl_sync(0xffffffffu, b, j) * rdiag[j];
    if (lane == j) b = yj;
    else if (lane > j && lane < n) b = fmaf(-L[lane * ld + j], yj, b);
  }
  for (int j = n - 1; j >= 0; --j) {
    const float xj = __shfl_sync(0xffffffffu, b, j) * rdiag[j];
    if (lane == j) b = xj;
    else if (lane < j) b = fmaf(-L[j * ld + lane], xj, b);
  }
  if (lane < n) x[lane] = b;
  __syncwarp();
}

// Right-hand-side pieces of one soft row (ocp/qp.py::direction); s, sx, ca
// are row blocks of stride m_s.
struct SoftB {
  float bU, bL, bPl, bPu, cl, cu;
};
__device__ __forceinline__ SoftB soft_b(const float* s, const float* sx, const float* ca,
                                        int m_s, int j, float sig_mu) {
  const float tU = s[j], tL = s[m_s + j], sl = s[2 * m_s + j], su = s[3 * m_s + j];
  const float lU = s[4 * m_s + j], lL = s[5 * m_s + j], nl = s[6 * m_s + j],
              nu = s[7 * m_s + j];
  float cU = 0.f, cL = 0.f, cPl = 0.f, cPu = 0.f;
  if (ca != nullptr) {   // corrector: products of the affine deltas
    cU = ca[4 * m_s + j] * ca[j];
    cL = ca[5 * m_s + j] * ca[m_s + j];
    cPl = ca[6 * m_s + j] * ca[2 * m_s + j];
    cPu = ca[7 * m_s + j] * ca[3 * m_s + j];
  }
  SoftB b;
  b.bU = (lU * tU - sig_mu + cU) / tU;
  b.bL = (lL * tL - sig_mu + cL) / tL;
  b.bPl = (nl * sl - sig_mu + cPl) / sl;
  b.bPu = (nu * su - sig_mu + cPu) / su;
  const float w_U = sx[j], w_L = sx[m_s + j];
  const float rp_U = sx[4 * m_s + j], rp_L = sx[5 * m_s + j];
  const float r2 = sx[6 * m_s + j], r3 = sx[7 * m_s + j];
  b.cl = -r2 - b.bL - b.bPl + w_L * rp_L;
  b.cu = -r3 - b.bU - b.bPu + w_U * rp_U;
  return b;
}

__device__ __forceinline__ float hard_b(const float* h, const float* ca, int m_h,
                                        int i, float sig_mu) {
  const float th = h[i], lh = h[m_h + i];
  const float c = ca != nullptr ? ca[m_h + i] * ca[i] : 0.f;
  return (lh * th - sig_mu + c) / th;
}

// One QP on one cluster.  `resident`: G slices and state rows in shared
// memory (else read from global memory, `work` holding the state rows);
// MP: Schur pairs per thread; SOFT = false: the hard-only QP (m_s = 0, the
// XLA body of ocp/qp.py::solve_qp_soft with its `if m_s` terms absent:
// m_total = m_h, no soft residual, Schur weight, direction or step pair).
template <int MP, bool SOFT>
__global__ void __launch_bounds__(NT_LOOP, 1)
ipm_mehrotra_kernel(const float* __restrict__ H, const float* __restrict__ g,
                    const float* __restrict__ Gth, const float* __restrict__ dh,
                    const float* __restrict__ Gts, const float* __restrict__ sd,
                    const float* __restrict__ h0, const float* __restrict__ s0,
                    const float* __restrict__ qs, float* bu, float* bh, float* bs,
                    float* bres, int* bit, float* work, int nU, int m_h, int m_s,
                    float tol, float reg, int max_iter, int stall_iters,
                    float stall_rtol, float mu_grind, int chunk, int resident) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x, ldm = nU + 1, nv = nU + 8;
  const RowSlice rs = row_slice<SOFT>(m_h, m_s, rank);
  const int hb = rs.hb, nh = rs.nh, sb = rs.sb, ns = rs.ns;
  const int hmax = (m_h + CL - 1) / CL, smax = SOFT ? (m_s + CL - 1) / CL : 0;

  extern __shared__ float sm[];
  float* sM = sm;                          // nU x ldm: Schur, then its factor
  float* sP = sM + nU * ldm;               // nU x ldm: this CTA's Schur partial
  float* pub = sP + nU * ldm;              // 2 x PUB: published partials
  float* su = pub + 2 * PUB;               // current u (nv each from here)
  float* sdA = su + nv;                    // affine du
  float* sdC = sdA + nv;                   // corrector du
  float* sr1 = sdC + nv;                   // stationarity residual
  float* sinv = sr1 + nv;                  // Jacobi scaling
  float* sx = sinv + nv;                   // rhs / solution / KKT partials
  float* vA = sx + nv;
  float* vB = vA + nv;
  float* lbuf = vB + nv;                   // 2 nU: chol_lower's columns, or
                                           //   the factor's 1/diagonal
  float* red = lbuf + 2 * nU;              // 64: two block-reduction slots
  float* sv = red + 64;                    // 8: scalar slots
  float* tail = sv + 8;

  const float* gh;                         // this CTA's columns of Gth / Gts
  const float* gs = nullptr;
  int ldh, lds = 1;
  float *sG = nullptr, *sW = nullptr, *st;
  if (resident) {
    // odd row strides: the Schur pass reads rows p and q of one column at
    // once in every lane, which an even stride would put on few banks
    ldh = nh | 1;
    float* sGh = tail;                     // nU x ldh
    st = sGh + nU * (hmax | 1);
    for (int e = tid; e < nU * nh; e += nt)
      sGh[(e / nh) * ldh + e % nh] = Gth[(size_t)(e / nh) * m_h + hb + e % nh];
    gh = sGh;
    if (SOFT) {
      lds = ns | 1;
      float* sGs = st;                     // nU x lds
      st = sGs + nU * (smax | 1);
      for (int e = tid; e < nU * ns; e += nt)
        sGs[(e / ns) * lds + e % ns] = Gts[(size_t)(e / ns) * m_s + sb + e % ns];
      gs = sGs;
    }
  } else {
    sG = tail;                             // nU x (chunk+1)
    sW = sG + nU * (chunk + 1);            // chunk
    st = work + 9 * (size_t)hb + 36 * (size_t)sb;
    gh = Gth + hb; ldh = m_h;
    if (SOFT) { gs = Gts + sb; lds = m_s; }
  }
  // this CTA's state rows (row blocks of stride nh / ns)
  float* ch = st;                          // th, lh
  float* cs = ch + 2 * nh;                 // tU tL sl su lU lL nl nu
  float* dAh = cs + 8 * ns;                // affine deltas
  float* dAs = dAh + 2 * nh;
  float* dCh = dAs + 8 * ns;               // corrector deltas
  float* dCs = dCh + 2 * nh;
  float* wh = dCs + 8 * ns;                // lh / th
  float* rph = wh + nh;                    // Gh u + th - d
  float* tmph = rph + nh;
  float* sxg = tmph + nh;                  // 11 rows: w_U w_L w_Pl w_Pu rp_U
  float* tmps = sxg + 11 * ns;             //   rp_L r2 r3 Dl Du w_eff

  const float* dvec = dh + hb;
  const float* wrel = dh + m_h + hb;
  const float* sdl = SOFT ? sd + sb : nullptr;   // row blocks of stride m_s
  const float qscale = qs[0], mu0 = qscale;
  const float m_total = (float)(SOFT ? m_h + 4 * m_s : m_h);
  const Pairs<MP> pr(nU);

  for (int i = tid; i < nh; i += nt) {
    ch[i] = h0[hb + i];
    ch[nh + i] = h0[m_h + hb + i];
    bh[hb + i] = h0[hb + i];
    bh[m_h + hb + i] = h0[m_h + hb + i];
  }
  for (int e = tid; e < 8 * ns; e += nt) {
    const size_t k = (size_t)(e / ns) * m_s + sb + e % ns;
    cs[e] = s0[k];
    bs[k] = s0[k];
  }
  for (int p = tid; p < nU; p += nt) {
    su[p] = 0.f;
    if (rank == 0) bu[p] = 0.f;
  }
  __syncthreads();

  int par = 0, rpar = 0;
  auto cluster_reduce = [&](float* vals, int n, int nsum, int nmax) {
    reduce_over_cluster(cluster, pub, PUB, par, vals, n, nsum, nmax);
  };
  // one block-reduced scalar (same in every thread) across the cluster
  auto cluster_scalar = [&](float v, int op) {   // op: 0 sum, 1 max, 2 min
    float* slot = sv + 4 * par;
    if (tid == 0) slot[0] = v;
    cluster_reduce(slot, 1, op == 0, op == 1);
    return slot[0];
  };

  // this CTA's complementarity sum of (state + a * delta); deltas may be null
  auto compl_local = [&](float a, const float* ddh, const float* dds) {
    float acc = 0.f;
    for (int i = tid; i < nh; i += nt) {
      float t = ch[i], l = ch[nh + i];
      if (ddh != nullptr) { t += a * ddh[i]; l += a * ddh[nh + i]; }
      acc += t * l;
    }
    for (int j = tid; j < ns; j += nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float v = cs[r * ns + j], w = cs[(r + 4) * ns + j];
        if (dds != nullptr) { v += a * dds[r * ns + j]; w += a * dds[(r + 4) * ns + j]; }
        acc += v * w;
      }
    }
    return block_reduce1(acc, red, rpar, sgp::SumOp(), 0.f);
  };
  auto compl_sum = [&](float a, const float* ddh, const float* dds) {
    return cluster_scalar(compl_local(a, ddh, dds), 0);
  };

  // out = this CTA's partial of Gh' a + sgn Gs' b over its rows
  auto gt_partial = [&](const float* a, const float* b, float sgn, float* out) {
    __syncthreads();
    gtv(gh, ldh, a, nU, nh, vA);
    if (SOFT) gtv(gs, lds, b, nU, ns, vB);
    __syncthreads();
    for (int p = tid; p < nU; p += nt) out[p] = SOFT ? vA[p] + sgn * vB[p] : vA[p];
  };
  // out = this CTA's partial of Gh' lh + Gs' (lU - lL)
  auto stationarity_partial = [&](float* out) {
    for (int j = tid; j < ns; j += nt) tmps[j] = cs[4 * ns + j] - cs[5 * ns + j];
    gt_partial(ch + nh, tmps, 1.f, out);
  };

  // KKT residual and complementarity sum of the current state, in one
  // cluster reduction
  auto kkt = [&](float* compl_out) {
    stationarity_partial(sx);
    float rp = 0.f;
    for (int i = tid; i < nh; i += nt) {
      const float gu = g_row(gh, ldh, su, nU, i);
      rp = sgp::nmax(rp, fabsf(gu + ch[i] - dvec[i]) * wrel[i]);
    }
    for (int j = tid; j < ns; j += nt) {
      const float gsu = g_row(gs, lds, su, nU, j);
      const float rU = gsu - cs[3 * ns + j] + cs[j] - sdl[m_s + j];
      const float rL = -gsu - cs[2 * ns + j] + cs[ns + j] + sdl[j];
      rp = sgp::nmax(rp, sgp::nmax(fabsf(rU) * sdl[6 * m_s + j],
                                   fabsf(rL) * sdl[7 * m_s + j]));
    }
    rp = block_reduce1(rp, red, rpar, sgp::MaxOp(), 0.f);
    const float c = compl_local(0.f, nullptr, nullptr);
    if (tid == 0) { sx[nU] = c; sx[nU + 1] = rp; }
    cluster_reduce(sx, nU + 2, nU + 1, 1);
    float r = 0.f;
    for (int p = tid; p < nU; p += nt)
      r = sgp::nmax(r, fabsf(h_row(H, su, nU, p) + g[p] + sx[p]));
    const float r_stat = block_reduce1(r, red, rpar, sgp::MaxOp(), 0.f) / qscale;
    const float cs_ = sx[nU], r_prim = sx[nU + 1];
    *compl_out = cs_;
    return sgp::nmax(sgp::nmax(r_stat, r_prim), cs_ / (m_total * qscale));
  };

  auto factorize = [&]() {
    for (int i = tid; i < nh; i += nt) {
      const float th = ch[i];
      wh[i] = ch[nh + i] / th;
      rph[i] = g_row(gh, ldh, su, nU, i) + th - dvec[i];
    }
    for (int j = tid; j < ns; j += nt) {
      const float tU = cs[j], tL = cs[ns + j], sl = cs[2 * ns + j], su_ = cs[3 * ns + j];
      const float lU = cs[4 * ns + j], lL = cs[5 * ns + j], nl = cs[6 * ns + j],
                  nu = cs[7 * ns + j];
      const float lo = sdl[j], hi = sdl[m_s + j], zl = sdl[2 * m_s + j],
                  zu = sdl[3 * m_s + j];
      const float Zl = sdl[4 * m_s + j], Zu = sdl[5 * m_s + j];
      const float w_U = lU / tU, w_L = lL / tL, w_Pl = nl / sl, w_Pu = nu / su_;
      const float gsu = g_row(gs, lds, su, nU, j);
      const float Dl = Zl + w_L + w_Pl, Du = Zu + w_U + w_Pu;
      sxg[j] = w_U;
      sxg[ns + j] = w_L;
      sxg[2 * ns + j] = w_Pl;
      sxg[3 * ns + j] = w_Pu;
      sxg[4 * ns + j] = gsu - su_ + tU - hi;
      sxg[5 * ns + j] = -gsu - sl + tL + lo;
      sxg[6 * ns + j] = Zl * sl + zl - lL - nl;
      sxg[7 * ns + j] = Zu * su_ + zu - lU - nu;
      sxg[8 * ns + j] = Dl;
      sxg[9 * ns + j] = Du;
      sxg[10 * ns + j] = w_U + w_L - w_U * w_U / Du - w_L * w_L / Dl;
    }
    stationarity_partial(sr1);   // its first barrier publishes wh and sxg
    float acc[MP];
#pragma unroll
    for (int j = 0; j < MP; ++j) acc[j] = 0.f;
    schur_acc(gh, ldh, wh, nU, nh, resident, chunk, sG, sW, pr, acc);
    if (SOFT) schur_acc(gs, lds, sxg + 10 * ns, nU, ns, resident, chunk, sG, sW, pr, acc);
#pragma unroll
    for (int j = 0; j < MP; ++j)
      if (j < pr.n) sP[pr.p[j] * ldm + pr.q[j]] = acc[j];
    // the cluster barrier of this reduction also publishes every sP
    cluster_reduce(sr1, nU, nU, 0);
    for (int p = tid; p < nU; p += nt) sr1[p] = h_row(H, su, nU, p) + g[p] + sr1[p];
#pragma unroll
    for (int j = 0; j < MP; ++j)
      if (j < pr.n) {
        const int o = pr.p[j] * ldm + pr.q[j];
        float x[CL];
#pragma unroll
        for (int r = 0; r < CL; ++r) x[r] = cluster.map_shared_rank(sP, r)[o];
        float s = H[pr.p[j] * nU + pr.q[j]];
#pragma unroll
        for (int r = 0; r < CL; ++r) s += x[r];
        sM[o] = s;
      }
    __syncthreads();
    for (int p = tid; p < nU; p += nt) {
      const float d = sM[p * ldm + p];
      sinv[p] = 1.0f / sqrtf(d < 1e-30f ? 1e-30f : d);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MP; ++j)
      if (j < pr.n) {
        const int p = pr.p[j], q = pr.q[j];
        sM[p * ldm + q] = sinv[p] * sM[p * ldm + q] * sinv[q] + (p == q ? reg : 0.f);
      }
    if (nU <= WARP_CHOL_MAX) {
      __syncthreads();
      if (tid < 32) chol_warp32(sM, ldm, nU, lbuf);
      __syncthreads();
    } else {
      sgp::chol_lower(sM, nU, ldm, lbuf);
    }
  };

  // Newton direction against the current factorization; `ca` = the affine
  // deltas (corrector) or null (predictor).
  auto direction = [&](float sig_mu, const float* cah, const float* cas,
                       float* du, float* ddh, float* dds) {
    for (int i = tid; i < nh; i += nt)
      tmph[i] = hard_b(ch, cah, nh, i, sig_mu) - wh[i] * rph[i];
    for (int j = tid; j < ns; j += nt) {
      const SoftB b = soft_b(cs, sxg, cas, ns, j, sig_mu);
      const float w_U = sxg[j], w_L = sxg[ns + j];
      const float rp_U = sxg[4 * ns + j], rp_L = sxg[5 * ns + j];
      const float Dl = sxg[8 * ns + j], Du = sxg[9 * ns + j];
      tmps[j] = -b.bU + b.bL + w_U * rp_U - w_L * rp_L - w_U * b.cu / Du + w_L * b.cl / Dl;
    }
    gt_partial(tmph, tmps, -1.f, sx);
    cluster_reduce(sx, nU, nU, 0);
    for (int p = tid; p < nU; p += nt) sx[p] = sinv[p] * (-sr1[p] + sx[p]);
    __syncthreads();
    if (tid < 32) {
      if (nU <= WARP_CHOL_MAX) chol_solve_warp32(sM, ldm, nU, lbuf, sx);
      else chol_solve_warp(sM, ldm, nU, sx);
    }
    __syncthreads();
    for (int p = tid; p < nU; p += nt) du[p] = sinv[p] * sx[p];
    __syncthreads();
    for (int i = tid; i < nh; i += nt) {
      const float dth = -g_row(gh, ldh, du, nU, i) - rph[i];
      ddh[i] = dth;
      ddh[nh + i] = -hard_b(ch, cah, nh, i, sig_mu) - wh[i] * dth;
    }
    for (int j = tid; j < ns; j += nt) {
      const SoftB b = soft_b(cs, sxg, cas, ns, j, sig_mu);
      const float w_U = sxg[j], w_L = sxg[ns + j], w_Pl = sxg[2 * ns + j],
                  w_Pu = sxg[3 * ns + j];
      const float rp_U = sxg[4 * ns + j], rp_L = sxg[5 * ns + j];
      const float Dl = sxg[8 * ns + j], Du = sxg[9 * ns + j];
      const float gsdu = g_row(gs, lds, du, nU, j);
      const float dsl = (b.cl - w_L * gsdu) / Dl;
      const float dsu = (b.cu + w_U * gsdu) / Du;
      const float dtU = -gsdu + dsu - rp_U;
      const float dtL = gsdu + dsl - rp_L;
      dds[j] = dtU;
      dds[ns + j] = dtL;
      dds[2 * ns + j] = dsl;
      dds[3 * ns + j] = dsu;
      dds[4 * ns + j] = -b.bU - w_U * dtU;
      dds[5 * ns + j] = -b.bL - w_L * dtL;
      dds[6 * ns + j] = -b.bPl - w_Pl * dsl;
      dds[7 * ns + j] = -b.bPu - w_Pu * dsu;
    }
    __syncthreads();
  };

  auto max_step = [&](const float* ddh, const float* dds) {
    float r = INFINITY;
    for (int e = tid; e < 2 * nh; e += nt)
      if (ddh[e] < 0.f) r = fminf(r, -ch[e] / ddh[e]);
    for (int e = tid; e < 8 * ns; e += nt)
      if (dds[e] < 0.f) r = fminf(r, -cs[e] / dds[e]);
    r = block_reduce1(r, red, rpar, sgp::MinOp(), INFINITY);
    r = cluster_scalar(r, 2);
    return 0.99f * fminf(1.f, r);
  };

  float sbest = INFINITY;
  int since = 0, it = 0;
  bool stop = false;
  float mu = compl_sum(0.f, nullptr, nullptr) / m_total;
  while (it < max_iter && !stop) {
    factorize();
    direction(0.f, nullptr, nullptr, sdA, dAh, dAs);
    const float a_aff = max_step(dAh, dAs);
    const float mu_aff = compl_sum(a_aff, dAh, dAs) / m_total;
    const float q = mu_aff / mu;
    const float sigma = sgp::nclip(q * q * q, 0.f, 1.f);
    direction(sigma * mu, dAh, dAs, sdC, dCh, dCs);
    const float alpha = max_step(dCh, dCs);

    float fin = 1.f;
    for (int p = tid; p < nU; p += nt) if (!isfinite(su[p] + alpha * sdC[p])) fin = 0.f;
    for (int e = tid; e < 2 * nh; e += nt) if (!isfinite(ch[e] + alpha * dCh[e])) fin = 0.f;
    for (int e = tid; e < 8 * ns; e += nt) if (!isfinite(cs[e] + alpha * dCs[e])) fin = 0.f;
    fin = block_reduce1(fin, red, rpar, sgp::MinOp(), 1.f);
    const bool ok = cluster_scalar(fin, 2) > 0.5f;
    if (ok) {
      for (int p = tid; p < nU; p += nt) su[p] = su[p] + alpha * sdC[p];
      for (int e = tid; e < 2 * nh; e += nt) ch[e] = ch[e] + alpha * dCh[e];
      for (int e = tid; e < 8 * ns; e += nt) cs[e] = cs[e] + alpha * dCs[e];
    }
    __syncthreads();
    // the complementarity sum of the (possibly unchanged) state is the next
    // iteration's mu; a rejected step's residual counts as infinite
    float csum;
    const float res_k = kkt(&csum);
    const float res = ok ? res_k : INFINITY;
    const bool meaningful = res < sbest * (1.f - stall_rtol);
    const float mu_new = csum / m_total;
    const bool grinding = mu_new < mu_grind * mu0;
    since = (meaningful || !grinding) ? 0 : since + 1;
    if (res < sbest) {
      if (rank == 0)
        for (int p = tid; p < nU; p += nt) bu[p] = su[p];
      for (int i = tid; i < nh; i += nt) {
        bh[hb + i] = ch[i];
        bh[m_h + hb + i] = ch[nh + i];
      }
      for (int e = tid; e < 8 * ns; e += nt)
        bs[(size_t)(e / ns) * m_s + sb + e % ns] = cs[e];
      sbest = res;
    }
    const bool live = ok && (mu_new > 1e-14f * mu0);
    stop = !live || sbest <= tol || since >= stall_iters;
    mu = mu_new;
    ++it;
  }
  if (rank == 0 && tid == 0) {
    bres[0] = sbest;
    bit[0] = it;
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
}

// ---------------------------------------------------------------------------
// The prepare kernel (see the header): one QP on a cluster of CL CTAs with
// the loop kernel's row slices.

constexpr int NT_PREP = 512;
constexpr int PUB_PREP = 264;   // floats of one publish buffer: 2 nU + 2 <= 258

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

// Start copying the n contiguous floats at src into shared memory at `raw`
// (16-byte aligned, 3 floats of slack) by cp.async: 16-byte copies for the
// aligned body, 4-byte ones for the head and the tail.  Returns where
// src[0] lands: raw plus the source's float offset modulo 4, so the copy
// and the source share their alignment.
__device__ float* stage_async(float* raw, const float* src, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ph = (int)((reinterpret_cast<size_t>(src) >> 2) & 3);
  float* dst = raw + ph;
  const int head = min(n, (4 - ph) & 3);
  const int nb = (n - head) >> 2;
  for (int k = tid; k < head; k += nt) sgp::cp_async4(dst + k, src + k);
  for (int q = tid; q < nb; q += nt) cp_async16(dst + head + 4 * q, src + head + 4 * q);
  for (int k = head + 4 * nb + tid; k < n; k += nt) sgp::cp_async4(dst + k, src + k);
  return dst;
}

// RES: the CTA keeps its scaled columns of Gth/Gts, its rows' scales and
// the warm candidate in shared memory (prepare_layout's resident branch);
// else the matvecs read Gth/Gts back from global memory, the per-row
// values come back from the outputs, and the warm candidate goes straight
// to h0/s0 (overwritten by the cold start when it is rejected).
template <bool RES, bool SOFT>
__global__ void __launch_bounds__(NT_PREP, 1)
ipm_prepare_kernel(const float* __restrict__ H, const float* __restrict__ g,
                   const float* __restrict__ Gh, const float* __restrict__ d_h,
                   const float* __restrict__ Gs, const float* __restrict__ lo,
                   const float* __restrict__ hi, const float* __restrict__ zl,
                   const float* __restrict__ zu, const float* __restrict__ Zl,
                   const float* __restrict__ Zu, const float* u_w, const float* sl_w,
                   const float* su_w, const float* lh_w, const float* lU_w,
                   const float* lL_w, const float* nl_w, const float* nu_w,
                   const unsigned char* flag, float* Gth, float* Gts, float* dho,
                   float* sdo, float* h0, float* s0, float* qs, float* sch, float* scs,
                   int* warm, int nU, int m_h, int m_s, float ws_floor, float ws_cap,
                   int chunk) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, nw = nt >> 5;
  const RowSlice rows = row_slice<SOFT>(m_h, m_s, rank);
  const int hb = rows.hb, nh = rows.nh, sb = rows.sb, ns = rows.ns;
  const int hmax = (m_h + CL - 1) / CL, smax = SOFT ? (m_s + CL - 1) / CL : 0;
  const int CH = RES ? max(hmax, smax) : chunk;   // rows per staged chunk
  // one staging buffer: the chunk's rows of G, then its rows of the row
  // inputs (d_h, or lo hi zl zu Zl Zu: 6 x CH, 1 x CH when hard-only); each
  // a multiple of 16 bytes
  const int side_n = ((SOFT ? 6 : 1) * CH + 3) & ~3;
  const int raw_n = ((CH * nU + 4 + 3) & ~3) + side_n;
  const float m_total = (float)(SOFT ? m_h + 4 * m_s : m_h);

  extern __shared__ __align__(16) float psm[];
  float* raw0 = psm;                       // two staging buffers
  float* raw1 = raw0 + raw_n;
  float* pub = raw1 + raw_n;               // 2 x PUB_PREP: published partials
  float* vals = pub + 2 * PUB_PREP;        // 2 nU + 8: reduced vectors, scalars
  float* red = vals + 2 * nU + 8;          // 64: two block-reduction slots
  float* rsc = red + 64;                   // CH: the chunk's row scales
  float* t1 = rsc + CH;                    // CH: per-row vectors of a matvec
  float* t2 = t1 + CH;
  float* tail = t2 + CH;

  float *sGh = nullptr, *sGs = nullptr, *sT = nullptr;
  float *hsc = nullptr, *hds = nullptr, *hwr = nullptr;
  float *ssc = nullptr, *slo = nullptr, *shi = nullptr, *swU = nullptr, *swL = nullptr;
  const float *Hsc, *Hds, *Hwr, *Ssc, *Slo, *Shi, *SwU, *SwL;   // per-row values
  float *Ch, *Cs;                          // the warm candidate's rows
  int ldch, ldcs;
  const int ldh = nh | 1, lds = ns | 1;    // resident columns' odd row strides
  if (RES) {
    float* p = tail;
    sGh = p; p += nU * (hmax | 1);
    sGs = p; p += SOFT ? nU * (smax | 1) : 0;
    hsc = p; p += hmax; hds = p; p += hmax; hwr = p; p += hmax;
    ssc = p; p += smax; slo = p; p += smax; shi = p; p += smax;
    swU = p; p += smax; swL = p; p += smax;
    Ch = p; p += 2 * hmax;
    Cs = p;
    ldch = hmax; ldcs = smax;
    Hsc = hsc; Hds = hds; Hwr = hwr;
    Ssc = ssc; Slo = slo; Shi = shi; SwU = swU; SwL = swL;
  } else {
    sT = tail;                             // nU x (CH | 1): one chunk transposed
    Hsc = sch + hb; Hds = dho + hb; Hwr = dho + m_h + hb;
    Ssc = scs + sb; Slo = sdo + sb; Shi = sdo + m_s + sb;
    SwU = sdo + 6 * m_s + sb; SwL = sdo + 7 * m_s + sb;
    Ch = h0 + hb; Cs = s0 + sb;
    ldch = m_h; ldcs = m_s;
  }

  // ---- pass 1: equilibration.  Chunks of CH rows, hard then soft, staged
  // by cp.async one chunk ahead; each chunk is transposed in shared memory
  // (reading the staged rows in order), its row maxima taken there, and its
  // scaled transpose written to Gth / Gts with consecutive threads on
  // consecutive rows.
  const int nch_h = (nh + CH - 1) / CH, nch = nch_h + (ns + CH - 1) / CH;
  auto chunk_rows = [&](int c, int& r0, int& n) {
    const bool hard = c < nch_h;
    r0 = (hard ? c : c - nch_h) * CH;
    n = min(CH, (hard ? nh : ns) - r0);
    return hard;
  };
  auto start_chunk = [&](int c, float* raw) {
    int r0, n;
    const bool hard = chunk_rows(c, r0, n);
    float* side = raw + raw_n - side_n;
    if (hard || !SOFT) {
      for (int k = tid; k < n; k += nt) sgp::cp_async4(side + k, d_h + hb + r0 + k);
    } else {
      const float* in[6] = {lo, hi, zl, zu, Zl, Zu};
#pragma unroll
      for (int q = 0; q < 6; ++q)
        for (int k = tid; k < n; k += nt) sgp::cp_async4(side + q * CH + k, in[q] + sb + r0 + k);
    }
    float* rows_at = stage_async(
        raw, hard ? Gh + (size_t)(hb + r0) * nU : Gs + (size_t)(sb + r0) * nU, n * nU);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    return rows_at;
  };
  float zmax = 0.f;
  float* cur = nch > 0 ? start_chunk(0, raw0) : nullptr;
  for (int c = 0; c < nch; ++c) {
    float* nxt = nullptr;
    if (c + 1 < nch) {
      nxt = start_chunk(c + 1, (c & 1) ? raw0 : raw1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    __syncthreads();
    int r0, n;
    const bool hard = chunk_rows(c, r0, n);
    float* T = RES ? (hard ? sGh : sGs) : sT;   // resident: r0 = 0
    const int ldt = RES ? (hard ? ldh : lds) : (n | 1);
    const float* side = ((c & 1) ? raw1 : raw0) + raw_n - side_n;
    {  // element e = k nU + p of the staged rows, (k, p) walked without division
      int k = tid / nU, p = tid - k * nU;
      const int dk = nt / nU, dp = nt - dk * nU;
      for (int e = tid; e < n * nU; e += nt) {
        T[p * ldt + k] = cur[e];
        k += dk;
        p += dp;
        if (p >= nU) { p -= nU; ++k; }
      }
    }
    __syncthreads();
    for (int k = tid; k < n; k += nt) {
      float a = 0.f;
      for (int p = 0; p < nU; ++p) a = sgp::nmax(a, fabsf(T[p * ldt + k]));
      const float sc = sgp::nmax(a, 1e-10f);
      rsc[k] = sc;
      const int i = r0 + k;
      if (hard || !SOFT) {
        const float ds = side[k] / sc, wr = 1.f / (1.f + fabsf(ds));
        sch[hb + i] = sc;
        dho[hb + i] = ds;
        dho[m_h + hb + i] = wr;
        if (RES) { hsc[i] = sc; hds[i] = ds; hwr[i] = wr; }
      } else {
        const int j = sb + i;
        const float l = side[k] / sc, h = side[CH + k] / sc, z = side[2 * CH + k] * sc;
        const float wU = 1.f / (1.f + fabsf(h)), wL = 1.f / (1.f + fabsf(l));
        scs[j] = sc;
        sdo[j] = l;
        sdo[m_s + j] = h;
        sdo[2 * m_s + j] = z;
        sdo[3 * m_s + j] = side[3 * CH + k] * sc;
        sdo[4 * m_s + j] = side[4 * CH + k] * sc * sc;
        sdo[5 * m_s + j] = side[5 * CH + k] * sc * sc;
        sdo[6 * m_s + j] = wU;
        sdo[7 * m_s + j] = wL;
        zmax = sgp::nmax(zmax, z);
        if (RES) { ssc[i] = sc; slo[i] = l; shi[i] = h; swU[i] = wU; swL[i] = wL; }
      }
    }
    __syncthreads();
    float* Gt = hard ? Gth + hb + r0 : Gts + sb + r0;
    const int ldg = hard ? m_h : m_s;
    {  // element e = p n + k of the transposed chunk, walked without division
      int p = tid / n, k = tid - p * n;
      const int dp = nt / n, dk = nt - dp * n;
      for (int e = tid; e < n * nU; e += nt) {
        const float v = T[p * ldt + k] / rsc[k];
        Gt[(size_t)p * ldg + k] = v;
        if (RES) T[p * ldt + k] = v;
        p += dp;
        k += dk;
        if (k >= n) { k -= n; ++p; }
      }
    }
    __syncthreads();                       // T, rsc and this buffer are reused
    cur = nxt;
  }

  // ---- reduction 1: qscale = 1 + max|g| + max(0, max zl'), every CTA
  // (hard-only: 1 + max|g|, g is the same in every CTA)
  int par = 0, rpar = 0;
  float gm = 0.f;
  for (int p = tid; p < nU; p += nt) gm = sgp::nmax(gm, fabsf(g[p]));
  gm = block_reduce1(gm, red, rpar, sgp::MaxOp(), 0.f);
  float qscale = 1.f + gm;
  if (SOFT) {
    zmax = block_reduce1(zmax, red, rpar, sgp::MaxOp(), 0.f);
    if (tid == 0) { vals[0] = gm; vals[1] = zmax; }
    reduce_over_cluster(cluster, pub, PUB_PREP, par, vals, 2, 0, 2);
    qscale = 1.f + vals[0] + vals[1];
  }
  const float mu0 = qscale;

  // One pass over this CTA's rows, hard then soft, in chunks of CH rows:
  // row(k, i, hard) fills t1[k] (and t2[k]) for row i of the slice, then
  // vals[p] (and vals[nU + p]) += (G' t)[p], one warp per p, lanes along
  // the rows.
  auto gt_pass = [&](int nvec, auto&& row) {
    __syncthreads();                       // every thread has read vals
    for (int e = tid; e < nvec * nU; e += nt) vals[e] = 0.f;
    for (int hard = 1; hard >= (SOFT ? 0 : 1); --hard) {
      const int m = hard ? nh : ns;
      for (int r0 = 0; r0 < m; r0 += CH) {
        const int n = min(CH, m - r0);
        for (int k = tid; k < n; k += nt) row(k, r0 + k, hard != 0);
        __syncthreads();
        const float* G;
        int ld;
        if (RES) {
          G = hard ? sGh : sGs;
          ld = hard ? ldh : lds;
        } else {
          G = hard ? Gth + hb + r0 : Gts + sb + r0;
          ld = hard ? m_h : m_s;
        }
        for (int p = wid; p < nU; p += nw) {
          const float* col = G + (size_t)p * ld;
          float a1 = 0.f, a2 = 0.f;
          for (int k = lane; k < n; k += 32) {
            const float gv = col[k];
            a1 = fmaf(gv, t1[k], a1);
            if (nvec == 2) a2 = fmaf(gv, t2[k], a2);
          }
          a1 = sgp::warp_reduce(a1, sgp::SumOp());
          if (nvec == 2) a2 = sgp::warp_reduce(a2, sgp::SumOp());
          if (lane == 0) {
            vals[p] += a1;
            if (nvec == 2) vals[nU + p] += a2;
          }
        }
        __syncthreads();
      }
    }
  };

  bool valid = false;
  if (u_w != nullptr) {
    // ---- pass 2 + reduction 2: the staleness vector G' lam_w of the
    // carried duals in this call's scaling, and the cold start's
    // stationarity vector, primal residual and complementarity sum
    float rp = 0.f, cp = 0.f;
    gt_pass(2, [&](int k, int i, bool hard) {
      if (hard || !SOFT) {
        const float ds = Hds[i], th = sgp::nmax(ds, 1.f), lc = mu0 / th;
        t1[k] = lh_w[hb + i] * Hsc[i];
        t2[k] = lc;
        rp = sgp::nmax(rp, fabsf(th - ds) * Hwr[i]);
        cp += th * lc;
      } else {
        const int j = sb + i;
        const float c = Ssc[i], l = Slo[i], h = Shi[i];
        const float tU = sgp::nmax(h + 1.f, 1.f), tL = sgp::nmax(-l + 1.f, 1.f);
        const float lU = mu0 / tU, lL = mu0 / tL;
        t1[k] = lU_w[j] * c - lL_w[j] * c;
        t2[k] = lU - lL;
        rp = sgp::nmax(rp, sgp::nmax(fabsf(tU - 1.f - h) * SwU[i],
                                     fabsf(tL - 1.f + l) * SwL[i]));
        cp += tU * lU + tL * lL + mu0 + mu0;
      }
    });
    rp = block_reduce1(rp, red, rpar, sgp::MaxOp(), 0.f);
    cp = block_reduce1(cp, red, rpar, sgp::SumOp(), 0.f);
    if (tid == 0) { vals[2 * nU] = cp; vals[2 * nU + 1] = rp; }
    reduce_over_cluster(cluster, pub, PUB_PREP, par, vals, 2 * nU + 2, 2 * nU + 1, 1);
    const float cp_cold = vals[2 * nU], rp_cold = vals[2 * nU + 1];
    float r = 0.f, rc = 0.f;
    for (int p = tid; p < nU; p += nt) {
      r = sgp::nmax(r, fabsf(h_row(H, u_w, nU, p) + g[p] + vals[p]));
      rc = sgp::nmax(rc, fabsf(g[p] + vals[nU + p]));
    }
    const float rq = block_reduce1(r, red, rpar, sgp::MaxOp(), 0.f) / qscale;
    const float rs_cold = block_reduce1(rc, red, rpar, sgp::MaxOp(), 0.f) / qscale;
    const float k_cold = sgp::nmax(sgp::nmax(rs_cold, rp_cold), cp_cold / (m_total * qscale));

    // ---- pass 3 + reduction 3: the warm candidate (staleness tau, the
    // complementarity band) and its stationarity, primal residual and
    // complementarity sum
    const float tau = sgp::nclip(rq, 1e-4f, 1.f);
    const float mu_ws = mu0 * tau;
    const float flo = ws_floor * mu_ws, fhi = ws_cap * mu_ws;
    float rpw = 0.f, cpw = 0.f;
    gt_pass(1, [&](int k, int i, bool hard) {
      if (hard || !SOFT) {
        const float ds = Hds[i];
        const float th = sgp::nmax(ds, tau * (1.f + fabsf(ds)));
        const float lh = sgp::nclip(lh_w[hb + i] * Hsc[i], flo / th, fhi / th);
        Ch[i] = th;
        Ch[ldch + i] = lh;
        t1[k] = lh;
        rpw = sgp::nmax(rpw, fabsf(th - ds) * Hwr[i]);
        cpw += th * lh;
      } else {
        const int j = sb + i;
        const float c = Ssc[i], l = Slo[i], h = Shi[i];
        const float sl = sgp::nmax(sl_w[j] / c, tau), su = sgp::nmax(su_w[j] / c, tau);
        const float tU = sgp::nmax(h + su, tau * (1.f + fabsf(h)));
        const float tL = sgp::nmax(-l + sl, tau * (1.f + fabsf(l)));
        const float lU = sgp::nclip(lU_w[j] * c, flo / tU, fhi / tU);
        const float lL = sgp::nclip(lL_w[j] * c, flo / tL, fhi / tL);
        const float nl = sgp::nclip(nl_w[j] * c, flo / sl, fhi / sl);
        const float nu = sgp::nclip(nu_w[j] * c, flo / su, fhi / su);
        float* s = Cs + i;
        s[0] = tU;
        s[ldcs] = tL;
        s[2 * ldcs] = sl;
        s[3 * ldcs] = su;
        s[4 * ldcs] = lU;
        s[5 * ldcs] = lL;
        s[6 * ldcs] = nl;
        s[7 * ldcs] = nu;
        t1[k] = lU - lL;
        rpw = sgp::nmax(rpw, sgp::nmax(fabsf(tU - su - h) * SwU[i],
                                       fabsf(tL - sl + l) * SwL[i]));
        cpw += tU * lU + tL * lL + sl * nl + su * nu;
      }
    });
    rpw = block_reduce1(rpw, red, rpar, sgp::MaxOp(), 0.f);
    cpw = block_reduce1(cpw, red, rpar, sgp::SumOp(), 0.f);
    if (tid == 0) { vals[nU] = cpw; vals[nU + 1] = rpw; }
    reduce_over_cluster(cluster, pub, PUB_PREP, par, vals, nU + 2, nU + 1, 1);
    const float cp_warm = vals[nU], rp_warm = vals[nU + 1];
    float rw = 0.f;
    for (int p = tid; p < nU; p += nt) rw = sgp::nmax(rw, fabsf(g[p] + vals[p]));
    const float rs_warm = block_reduce1(rw, red, rpar, sgp::MaxOp(), 0.f) / qscale;
    const float k_warm = sgp::nmax(sgp::nmax(rs_warm, rp_warm), cp_warm / (m_total * qscale));
    valid = (flag == nullptr || flag[0] != 0) && rq < 1e-2f && k_warm <= k_cold;
  }

  // ---- the chosen start, this CTA's rows straight to h0 / s0
  if (valid) {
    if (RES) {
      for (int i = tid; i < nh; i += nt) {
        h0[hb + i] = Ch[i];
        h0[m_h + hb + i] = Ch[ldch + i];
      }
      for (int e = tid; e < 8 * ns; e += nt) {
        const int r = e / ns, j = e - r * ns;
        s0[(size_t)r * m_s + sb + j] = Cs[r * ldcs + j];
      }
    }
  } else {
    // the central-path cold start at the dual scale (s * lam = mu0 per pair)
    for (int i = tid; i < nh; i += nt) {
      const float th = sgp::nmax(Hds[i], 1.f);
      h0[hb + i] = th;
      h0[m_h + hb + i] = mu0 / th;
    }
    for (int j = tid; j < ns; j += nt) {
      const float tU = sgp::nmax(Shi[j] + 1.f, 1.f), tL = sgp::nmax(-Slo[j] + 1.f, 1.f);
      float* s = s0 + sb + j;
      s[0] = tU;
      s[m_s] = tL;
      s[2 * m_s] = 1.f;
      s[3 * m_s] = 1.f;
      s[4 * m_s] = mu0 / tU;
      s[5 * m_s] = mu0 / tL;
      s[6 * m_s] = mu0;
      s[7 * m_s] = mu0;
    }
  }
  if (rank == 0 && tid == 0) {
    qs[0] = qscale;
    warm[0] = valid ? 1 : 0;
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
}

template <class K>
cudaError_t cluster_attributes(K* kernel, int smem_bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  return err;
}

cudaLaunchConfig_t cluster_config(int smem_bytes, int threads, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Whether the card co-schedules a cluster of CL CTAs of `kernel` at the
// largest shared memory (1), not (0), or a negative cudaError_t.
template <class K>
int co_schedules(K* kernel, int threads) {
  cudaError_t err = cluster_attributes(kernel, SMEM_OPT_IN);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(SMEM_OPT_IN, threads, 0, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return n >= 1 ? 1 : 0;
}

}  // namespace

// The cluster size both kernels launch with, CL = 16, if the card can
// co-schedule a cluster of 16 CTAs of every build of both in this library
// at the largest shared memory; else 0, or a negative cudaError_t.
extern "C" int ipm_cluster_size() {
  const int ok[4] = {co_schedules(ipm_mehrotra_kernel<MAXP_SMALL, kSoft>, NT_LOOP),
                     co_schedules(ipm_mehrotra_kernel<MAXP, kSoft>, NT_LOOP),
                     co_schedules(ipm_prepare_kernel<true, kSoft>, NT_PREP),
                     co_schedules(ipm_prepare_kernel<false, kSoft>, NT_PREP)};
  for (int v : ok)
    if (v != 1) return v;
  return CL;
}

extern "C" int ipm_prepare(const float* H, const float* g, const float* Gh,
                           const float* d_h, const float* Gs, const float* lo,
                           const float* hi, const float* zl, const float* zu,
                           const float* Zl, const float* Zu, const float* u_w,
                           const float* sl_w, const float* su_w, const float* lh_w,
                           const float* lU_w, const float* lL_w, const float* nl_w,
                           const float* nu_w, const unsigned char* flag, float* Gth,
                           float* Gts, float* dho, float* sdo, float* h0, float* s0,
                           float* qs, float* sch, float* scs, int* warm, int nU, int m_h,
                           int m_s, float ws_floor, float ws_cap, int chunk, int resident,
                           int smem_bytes, void* stream) {
  if (nU < 1 || nU > 128 || m_h < 1 || (m_s > 0) != kSoft || 2 * nU + 2 > PUB_PREP ||
      (!resident && chunk < 1))
    return (int)cudaErrorInvalidValue;
  auto kernel = resident ? ipm_prepare_kernel<true, kSoft> : ipm_prepare_kernel<false, kSoft>;
  cudaError_t err = cluster_attributes(kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(smem_bytes, NT_PREP, (cudaStream_t)stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, H, g, Gh, d_h, Gs, lo, hi, zl, zu, Zl, Zu, u_w,
                           sl_w, su_w, lh_w, lU_w, lL_w, nl_w, nu_w, flag, Gth, Gts, dho,
                           sdo, h0, s0, qs, sch, scs, warm, nU, m_h, m_s, ws_floor,
                           ws_cap, chunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int ipm_mehrotra(const float* H, const float* g, const float* Gth,
                            const float* dh, const float* Gts, const float* sd,
                            const float* h0, const float* s0, const float* qs,
                            float* bu, float* bh, float* bs, float* bres, int* bit,
                            float* work, int nU, int m_h, int m_s, float tol, float reg,
                            int max_iter, int stall_iters, float stall_rtol,
                            float mu_grind, int chunk, int resident, int smem_bytes,
                            void* stream) {
  if (nU < 1 || nU > 128 || m_h < 1 || (m_s > 0) != kSoft || nU + 2 > PUB)
    return (int)cudaErrorInvalidValue;
  const bool small = nU * (nU + 1) / 2 <= MAXP_SMALL * NT_LOOP;
  auto kernel = small ? ipm_mehrotra_kernel<MAXP_SMALL, kSoft>
                      : ipm_mehrotra_kernel<MAXP, kSoft>;
  cudaError_t err = cluster_attributes(kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(smem_bytes, NT_LOOP, (cudaStream_t)stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, H, g, Gth, dh, Gts, sd, h0, s0, qs, bu, bh, bs,
                           bres, bit, work, nU, m_h, m_s, tol, reg, max_iter, stall_iters,
                           stall_rtol, mu_grind, chunk, resident);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
