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
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 1024;        // prepare kernel
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
// MP: Schur pairs per thread.
template <int MP>
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
  // this CTA's rows: hard [hb, hb + nh), soft [sb, sb + ns)
  const int hb = (int)((long long)m_h * rank / CL);
  const int sb = (int)((long long)m_s * rank / CL);
  const int nh = (int)((long long)m_h * (rank + 1) / CL) - hb;
  const int ns = (int)((long long)m_s * (rank + 1) / CL) - sb;
  const int hmax = (m_h + CL - 1) / CL, smax = (m_s + CL - 1) / CL;

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
  const float* gs;
  int ldh, lds;
  float *sG = nullptr, *sW = nullptr, *st;
  if (resident) {
    // odd row strides: the Schur pass reads rows p and q of one column at
    // once in every lane, which an even stride would put on few banks
    ldh = nh | 1;
    lds = ns | 1;
    float* sGh = tail;                     // nU x ldh
    float* sGs = sGh + nU * (hmax | 1);    // nU x lds
    st = sGs + nU * (smax | 1);
    for (int e = tid; e < nU * nh; e += nt)
      sGh[(e / nh) * ldh + e % nh] = Gth[(size_t)(e / nh) * m_h + hb + e % nh];
    for (int e = tid; e < nU * ns; e += nt)
      sGs[(e / ns) * lds + e % ns] = Gts[(size_t)(e / ns) * m_s + sb + e % ns];
    gh = sGh; gs = sGs;
  } else {
    sG = tail;                             // nU x (chunk+1)
    sW = sG + nU * (chunk + 1);            // chunk
    st = work + 9 * (size_t)hb + 36 * (size_t)sb;
    gh = Gth + hb; ldh = m_h; gs = Gts + sb; lds = m_s;
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
  const float* sdl = sd + sb;              // row blocks of stride m_s
  const float qscale = qs[0], mu0 = qscale;
  const float m_total = (float)(m_h + 4 * m_s);
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

  // Cluster-wide reduction of n values this CTA holds in shared `vals`:
  // entries [0, nsum) summed, [nsum, nsum + nmax) NaN-max'ed, the rest
  // min'ed, over the ranks in order; every CTA gets the same result in
  // `vals`.  The two publish buffers alternate, so a buffer is rewritten
  // only after a later cluster barrier, when every rank has read it.
  int par = 0, rpar = 0;
  auto cluster_reduce = [&](float* vals, int n, int nsum, int nmax) {
    __syncthreads();
    float* mine = pub + par * PUB;
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
    gtv(gs, lds, b, nU, ns, vB);
    __syncthreads();
    for (int p = tid; p < nU; p += nt) out[p] = vA[p] + sgn * vB[p];
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
    schur_acc(gs, lds, sxg + 10 * ns, nU, ns, resident, chunk, sG, sW, pr, acc);
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

__global__ void __launch_bounds__(NT, 1)
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
                   float* work, int nU, int m_h, int m_s, float ws_floor, float ws_cap) {
  __shared__ float red[40];
  __shared__ float vA[128], vB[128];
  const int tid = threadIdx.x, nt = blockDim.x;
  const float m_total = (float)(m_h + 4 * m_s);

  // per-row inf-norm equilibration; G is written transposed and scaled
  for (int i = tid; i < m_h; i += nt) {
    const float* row = Gh + (size_t)i * nU;
    float a = 0.f;
    for (int p = 0; p < nU; ++p) a = sgp::nmax(a, fabsf(row[p]));
    const float sc = sgp::nmax(a, 1e-10f);
    sch[i] = sc;
    for (int p = 0; p < nU; ++p) Gth[(size_t)p * m_h + i] = row[p] / sc;
    const float ds = d_h[i] / sc;
    dho[i] = ds;
    dho[m_h + i] = 1.f / (1.f + fabsf(ds));
  }
  float zmax = 0.f;
  for (int j = tid; j < m_s; j += nt) {
    const float* row = Gs + (size_t)j * nU;
    float a = 0.f;
    for (int p = 0; p < nU; ++p) a = sgp::nmax(a, fabsf(row[p]));
    const float sc = sgp::nmax(a, 1e-10f);
    scs[j] = sc;
    for (int p = 0; p < nU; ++p) Gts[(size_t)p * m_s + j] = row[p] / sc;
    const float l = lo[j] / sc, h = hi[j] / sc, z = zl[j] * sc;
    sdo[j] = l;
    sdo[m_s + j] = h;
    sdo[2 * m_s + j] = z;
    sdo[3 * m_s + j] = zu[j] * sc;
    sdo[4 * m_s + j] = Zl[j] * sc * sc;
    sdo[5 * m_s + j] = Zu[j] * sc * sc;
    sdo[6 * m_s + j] = 1.f / (1.f + fabsf(h));
    sdo[7 * m_s + j] = 1.f / (1.f + fabsf(l));
    zmax = sgp::nmax(zmax, z);
  }
  float gmax = 0.f;
  for (int p = tid; p < nU; p += nt) gmax = sgp::nmax(gmax, fabsf(g[p]));
  gmax = sgp::block_reduce(gmax, red, sgp::MaxOp(), 0.f);
  zmax = sgp::block_reduce(zmax, red, sgp::MaxOp(), 0.f);
  const float qscale = 1.f + gmax + zmax, mu0 = qscale;
  if (tid == 0) qs[0] = qscale;

  // central-path cold start at the dual scale (s * lam = mu0 per pair)
  float* hc = work;                 // cold candidate (2, m_h)
  float* sc8 = hc + 2 * m_h;        // cold candidate (8, m_s)
  float* tmph = sc8 + 8 * m_s;
  float* tmps = tmph + m_h;
  for (int i = tid; i < m_h; i += nt) {
    const float th = fmaxf(dho[i], 1.f);
    hc[i] = th;
    hc[m_h + i] = mu0 / th;
  }
  for (int j = tid; j < m_s; j += nt) {
    const float tU = sgp::nmax(sdo[m_s + j] + 1.f, 1.f);
    const float tL = sgp::nmax(-sdo[j] + 1.f, 1.f);
    sc8[j] = tU;
    sc8[m_s + j] = tL;
    sc8[2 * m_s + j] = 1.f;
    sc8[3 * m_s + j] = 1.f;
    sc8[4 * m_s + j] = mu0 / tU;
    sc8[5 * m_s + j] = mu0 / tL;
    sc8[6 * m_s + j] = mu0;
    sc8[7 * m_s + j] = mu0;
  }
  bool valid = false;
  if (u_w != nullptr) {
    // carried (unscaled) duals into this call's row scaling; staleness =
    // stationarity of the carried pair (u_w, lam_w) under the current data
    for (int i = tid; i < m_h; i += nt) tmph[i] = lh_w[i] * sch[i];
    for (int j = tid; j < m_s; j += nt) tmps[j] = lU_w[j] * scs[j] - lL_w[j] * scs[j];
    __syncthreads();
    gtv(Gth, m_h, tmph, nU, m_h, vA);
    gtv(Gts, m_s, tmps, nU, m_s, vB);
    __syncthreads();
    float r = 0.f;
    for (int p = tid; p < nU; p += nt)
      r = sgp::nmax(r, fabsf(h_row(H, u_w, nU, p) + g[p] + vA[p] + vB[p]));
    const float rq = sgp::block_reduce(r, red, sgp::MaxOp(), 0.f) / qscale;
    const float tau = sgp::nclip(rq, 1e-4f, 1.f);
    const float mu_ws = mu0 * tau;
    const float flo = ws_floor * mu_ws, fhi = ws_cap * mu_ws;
    for (int i = tid; i < m_h; i += nt) {
      const float ds = dho[i];
      const float th = sgp::nmax(ds, tau * (1.f + fabsf(ds)));
      h0[i] = th;
      h0[m_h + i] = sgp::nclip(lh_w[i] * sch[i], flo / th, fhi / th);
    }
    for (int j = tid; j < m_s; j += nt) {
      const float c = scs[j], l = sdo[j], h = sdo[m_s + j];
      const float sl = sgp::nmax(sl_w[j] / c, tau), su = sgp::nmax(su_w[j] / c, tau);
      const float tU = sgp::nmax(h + su, tau * (1.f + fabsf(h)));
      const float tL = sgp::nmax(-l + sl, tau * (1.f + fabsf(l)));
      s0[j] = tU;
      s0[m_s + j] = tL;
      s0[2 * m_s + j] = sl;
      s0[3 * m_s + j] = su;
      s0[4 * m_s + j] = sgp::nclip(lU_w[j] * c, flo / tU, fhi / tU);
      s0[5 * m_s + j] = sgp::nclip(lL_w[j] * c, flo / tL, fhi / tL);
      s0[6 * m_s + j] = sgp::nclip(nl_w[j] * c, flo / sl, fhi / sl);
      s0[7 * m_s + j] = sgp::nclip(nu_w[j] * c, flo / su, fhi / su);
    }
    __syncthreads();

    // KKT residual at u = 0 of a start candidate (h, s)
    auto kkt0 = [&](const float* h, const float* s) {
      for (int j = tid; j < m_s; j += nt) tmps[j] = s[4 * m_s + j] - s[5 * m_s + j];
      __syncthreads();
      gtv(Gth, m_h, h + m_h, nU, m_h, vA);
      gtv(Gts, m_s, tmps, nU, m_s, vB);
      __syncthreads();
      float rs = 0.f;
      for (int p = tid; p < nU; p += nt) rs = sgp::nmax(rs, fabsf(g[p] + vA[p] + vB[p]));
      const float r_stat = sgp::block_reduce(rs, red, sgp::MaxOp(), 0.f) / qscale;
      float rp = 0.f, cp = 0.f;
      for (int i = tid; i < m_h; i += nt) {
        rp = sgp::nmax(rp, fabsf(h[i] - dho[i]) * dho[m_h + i]);
        cp += h[i] * h[m_h + i];
      }
      for (int j = tid; j < m_s; j += nt) {
        const float tU = s[j], tL = s[m_s + j], sl = s[2 * m_s + j], su = s[3 * m_s + j];
        rp = sgp::nmax(rp, sgp::nmax(fabsf(tU - su - sdo[m_s + j]) * sdo[6 * m_s + j],
                                     fabsf(tL - sl + sdo[j]) * sdo[7 * m_s + j]));
        cp += tU * s[4 * m_s + j] + tL * s[5 * m_s + j] + sl * s[6 * m_s + j] +
              su * s[7 * m_s + j];
      }
      const float r_prim = sgp::block_reduce(rp, red, sgp::MaxOp(), 0.f);
      const float c = sgp::block_reduce(cp, red, sgp::SumOp(), 0.f);
      return sgp::nmax(sgp::nmax(r_stat, r_prim), c / (m_total * qscale));
    };
    const float k_warm = kkt0(h0, s0);
    const float k_cold = kkt0(hc, sc8);
    valid = (flag == nullptr || flag[0] != 0) && rq < 1e-2f && k_warm <= k_cold;
  }
  if (!valid) {
    __syncthreads();
    for (int e = tid; e < 2 * m_h; e += nt) h0[e] = hc[e];
    for (int e = tid; e < 8 * m_s; e += nt) s0[e] = sc8[e];
  }
}

}  // namespace

extern "C" int ipm_prepare(const float* H, const float* g, const float* Gh,
                           const float* d_h, const float* Gs, const float* lo,
                           const float* hi, const float* zl, const float* zu,
                           const float* Zl, const float* Zu, const float* u_w,
                           const float* sl_w, const float* su_w, const float* lh_w,
                           const float* lU_w, const float* lL_w, const float* nl_w,
                           const float* nu_w, const unsigned char* flag, float* Gth,
                           float* Gts, float* dho, float* sdo, float* h0, float* s0,
                           float* qs, float* sch, float* scs, float* work, int nU,
                           int m_h, int m_s, float ws_floor, float ws_cap, void* stream) {
  if (nU > 128) return (int)cudaErrorInvalidValue;
  ipm_prepare_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      H, g, Gh, d_h, Gs, lo, hi, zl, zu, Zl, Zu, u_w, sl_w, su_w, lh_w, lU_w, lL_w,
      nl_w, nu_w, flag, Gth, Gts, dho, sdo, h0, s0, qs, sch, scs, work, nU, m_h, m_s,
      ws_floor, ws_cap);
  return (int)cudaGetLastError();
}

namespace {

template <int MP>
cudaError_t loop_attributes(int smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      ipm_mehrotra_kernel<MP>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ipm_mehrotra_kernel<MP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  return err;
}

cudaLaunchConfig_t loop_config(int smem_bytes, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, 1, 1);
  cfg.blockDim = dim3(NT_LOOP, 1, 1);
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

}  // namespace

// The cluster size the loop kernel launches with, 16, if the card can
// co-schedule a cluster of 16 of its CTAs at the largest shared memory;
// else 0, or a negative cudaError_t.
extern "C" int ipm_mehrotra_cluster_size() {
  cudaError_t err = loop_attributes<MAXP_SMALL>(SMEM_OPT_IN);
  if (err == cudaSuccess) err = loop_attributes<MAXP>(SMEM_OPT_IN);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = loop_config(SMEM_OPT_IN, 0, attr);
  int n_small = 0, n = 0;
  err = cudaOccupancyMaxActiveClusters(&n_small, ipm_mehrotra_kernel<MAXP_SMALL>, &cfg);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, ipm_mehrotra_kernel<MAXP>, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return n_small >= 1 && n >= 1 ? CL : 0;
}

extern "C" int ipm_mehrotra(const float* H, const float* g, const float* Gth,
                            const float* dh, const float* Gts, const float* sd,
                            const float* h0, const float* s0, const float* qs,
                            float* bu, float* bh, float* bs, float* bres, int* bit,
                            float* work, int nU, int m_h, int m_s, float tol, float reg,
                            int max_iter, int stall_iters, float stall_rtol,
                            float mu_grind, int chunk, int resident, int smem_bytes,
                            void* stream) {
  if (nU > 128 || nU + 2 > PUB) return (int)cudaErrorInvalidValue;
  const bool small = nU * (nU + 1) / 2 <= MAXP_SMALL * NT_LOOP;
  cudaError_t err = small ? loop_attributes<MAXP_SMALL>(smem_bytes)
                          : loop_attributes<MAXP>(smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = loop_config(smem_bytes, (cudaStream_t)stream, attr);
  if (small)
    err = cudaLaunchKernelEx(&cfg, ipm_mehrotra_kernel<MAXP_SMALL>, H, g, Gth, dh, Gts, sd,
                             h0, s0, qs, bu, bh, bs, bres, bit, work, nU, m_h, m_s, tol,
                             reg, max_iter, stall_iters, stall_rtol, mu_grind, chunk,
                             resident);
  else
    err = cudaLaunchKernelEx(&cfg, ipm_mehrotra_kernel<MAXP>, H, g, Gth, dh, Gts, sd, h0,
                             s0, qs, bu, bh, bs, bres, bit, work, nU, m_h, m_s, tol, reg,
                             max_iter, stall_iters, stall_rtol, mu_grind, chunk, resident);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
