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
// What bounds it on the H100: one CTA (1024 threads, one SM of 132) runs
// each QP, so the loop is bound by that SM's share of L2 bandwidth and by
// its barriers, not by the card.  Per Mehrotra iteration it streams Gt about
// nine times (Schur pass, stationarity, four matvecs for the two Newton
// directions, KKT), ~4 B * nU * (m_h + m_s) each; at the flagship shape
// (nU=17, m_h=7174, m_s=70) Gt is ~490 KB and stays L2-resident across
// iterations.  The Schur pass stages chunks of Gt in shared memory so each
// element is read once per pass; the (nU, nU) Schur matrix and its Cholesky
// live in shared memory; every reduction (residual maxima, complementarity
// sums, step ratios) is a block reduction, so the loop never returns to the
// host.  Spreading one QP over a cluster of CTAs is later work.
#include "common.cuh"

namespace {

constexpr int NT = 1024;
constexpr int MAXP = 9;   // Schur pairs per thread: ceil(128*129/2 / 1024)

// out[p] = sum_i Gt[p*m + i] v[i]: one warp per p, lanes along m.
__device__ void gtv(const float* __restrict__ Gt, const float* __restrict__ v,
                    int nU, int m, float* out) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int p = w; p < nU; p += nw) {
    const float* row = Gt + (size_t)p * m;
    float acc = 0.f;
    for (int i = lane; i < m; i += 32) acc = fmaf(row[i], v[i], acc);
    acc = sgp::warp_reduce(acc, sgp::SumOp());
    if (lane == 0) out[p] = acc;
  }
}

// (G u)[i] of row i, G stored transposed.
__device__ __forceinline__ float g_row(const float* __restrict__ Gt,
                                       const float* u, int nU, int m, int i) {
  float acc = 0.f;
  for (int p = 0; p < nU; ++p) acc = fmaf(Gt[(size_t)p * m + i], u[p], acc);
  return acc;
}

// (H u)[p] with symmetric H, summed as dot(u, H[:, p]).
__device__ __forceinline__ float h_row(const float* __restrict__ H,
                                       const float* u, int nU, int p) {
  float acc = 0.f;
  for (int q = 0; q < nU; ++q) acc = fmaf(u[q], H[q * nU + p], acc);
  return acc;
}

// Lower-triangle pairs (p >= q) owned by this thread: k = tid + j*NT.
struct Pairs {
  int p[MAXP], q[MAXP], n;
  __device__ Pairs(int nU) : n(0) {
    const int npairs = nU * (nU + 1) / 2;
#pragma unroll
    for (int j = 0; j < MAXP; ++j) {
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

// acc[j] += sum_i (Gt[p_j][i] w[i]) Gt[q_j][i], staging `chunk` rows of G
// at a time in shared memory (sG: nU x (chunk+1), sW: chunk).
__device__ void schur_acc(const float* __restrict__ Gt, const float* __restrict__ w,
                          int nU, int m, int chunk, float* sG, float* sW,
                          const Pairs& pr, float* acc) {
  const int tid = threadIdx.x, nt = blockDim.x, ld = chunk + 1;
  for (int i0 = 0; i0 < m; i0 += chunk) {
    const int cn = min(chunk, m - i0);
    __syncthreads();
    for (int e = tid; e < nU * cn; e += nt) {
      const int p = e / cn, c = e % cn;
      sG[p * ld + c] = Gt[(size_t)p * m + i0 + c];
    }
    for (int c = tid; c < cn; c += nt) sW[c] = w[i0 + c];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAXP; ++j) {
      if (j < pr.n) {
        const float* a = sG + pr.p[j] * ld;
        const float* b = sG + pr.q[j] * ld;
        float s = acc[j];
        for (int c = 0; c < cn; ++c) s = fmaf(a[c] * sW[c], b[c], s);
        acc[j] = s;
      }
    }
  }
  __syncthreads();
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

// Right-hand-side pieces of one soft row (ocp/qp.py::direction).
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

__global__ void __launch_bounds__(NT, 1)
ipm_mehrotra_kernel(const float* __restrict__ H, const float* __restrict__ g,
                    const float* __restrict__ Gth, const float* __restrict__ dh,
                    const float* __restrict__ Gts, const float* __restrict__ sd,
                    const float* __restrict__ h0, const float* __restrict__ s0,
                    const float* __restrict__ qs, float* bu, float* bh, float* bs,
                    float* bres, int* bit, float* work, int nU, int m_h, int m_s,
                    float tol, float reg, int max_iter, int stall_iters,
                    float stall_rtol, float mu_grind, int chunk) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x, nt = blockDim.x, ldm = nU + 1;
  float* sM = sm;                          // nU x ldm: Schur, then its factor
  float* sG = sM + nU * ldm;               // nU x (chunk+1)
  float* sW = sG + nU * (chunk + 1);       // chunk
  float* su = sW + chunk;                  // current u
  float* sdA = su + nU;                    // affine du
  float* sdC = sdA + nU;                   // corrector du
  float* sr1 = sdC + nU;                   // stationarity residual
  float* sinv = sr1 + nU;                  // Jacobi scaling
  float* sx = sinv + nU;                   // rhs / solution
  float* vA = sx + nU;
  float* vB = vA + nU;
  float* lbuf = vB + nU;                   // 2 nU
  float* red = lbuf + 2 * nU;              // 40

  const int nh2 = 2 * m_h, ns8 = 8 * m_s;
  float* ch = work;                        // current state
  float* cs = ch + nh2;
  float* dAh = cs + ns8;                   // affine deltas
  float* dAs = dAh + nh2;
  float* dCh = dAs + ns8;                  // corrector deltas
  float* dCs = dCh + nh2;
  float* wh = dCs + ns8;                   // lh / th
  float* rph = wh + m_h;                   // Gh u + th - d
  float* tmph = rph + m_h;
  float* sxg = tmph + m_h;                 // 11 rows: w_U w_L w_Pl w_Pu rp_U
  float* tmps = sxg + 11 * m_s;            //   rp_L r2 r3 Dl Du w_eff

  const float* dvec = dh;
  const float* wrel = dh + m_h;
  const float qscale = qs[0], mu0 = qscale;
  const float m_total = (float)(m_h + 4 * m_s);
  const Pairs pr(nU);

  for (int e = tid; e < nh2; e += nt) { ch[e] = h0[e]; bh[e] = h0[e]; }
  for (int e = tid; e < ns8; e += nt) { cs[e] = s0[e]; bs[e] = s0[e]; }
  for (int p = tid; p < nU; p += nt) { su[p] = 0.f; bu[p] = 0.f; }
  __syncthreads();

  // complementarity sum of (state + a * delta); delta pointers may be null
  auto compl_sum = [&](float a, const float* ddh, const float* dds) {
    float acc = 0.f;
    for (int i = tid; i < m_h; i += nt) {
      float t = ch[i], l = ch[m_h + i];
      if (ddh != nullptr) { t += a * ddh[i]; l += a * ddh[m_h + i]; }
      acc += t * l;
    }
    for (int j = tid; j < m_s; j += nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float v = cs[r * m_s + j], w = cs[(r + 4) * m_s + j];
        if (dds != nullptr) { v += a * dds[r * m_s + j]; w += a * dds[(r + 4) * m_s + j]; }
        acc += v * w;
      }
    }
    return sgp::block_reduce(acc, red, sgp::SumOp(), 0.f);
  };

  // out = H u + g + Gh' lh + Gs' (lU - lL)
  auto stationarity = [&](float* out) {
    for (int j = tid; j < m_s; j += nt) tmps[j] = cs[4 * m_s + j] - cs[5 * m_s + j];
    __syncthreads();
    gtv(Gth, ch + m_h, nU, m_h, vA);
    gtv(Gts, tmps, nU, m_s, vB);
    __syncthreads();
    for (int p = tid; p < nU; p += nt) out[p] = h_row(H, su, nU, p) + g[p] + vA[p] + vB[p];
    __syncthreads();
  };

  auto kkt = [&]() {
    stationarity(sx);
    float r = 0.f;
    for (int p = tid; p < nU; p += nt) r = sgp::nmax(r, fabsf(sx[p]));
    const float r_stat = sgp::block_reduce(r, red, sgp::MaxOp(), 0.f) / qscale;
    float rp = 0.f;
    for (int i = tid; i < m_h; i += nt) {
      const float gu = g_row(Gth, su, nU, m_h, i);
      rp = sgp::nmax(rp, fabsf(gu + ch[i] - dvec[i]) * wrel[i]);
    }
    for (int j = tid; j < m_s; j += nt) {
      const float gsu = g_row(Gts, su, nU, m_s, j);
      const float rU = gsu - cs[3 * m_s + j] + cs[j] - sd[m_s + j];
      const float rL = -gsu - cs[2 * m_s + j] + cs[m_s + j] + sd[j];
      rp = sgp::nmax(rp, sgp::nmax(fabsf(rU) * sd[6 * m_s + j],
                                   fabsf(rL) * sd[7 * m_s + j]));
    }
    const float r_prim = sgp::block_reduce(rp, red, sgp::MaxOp(), 0.f);
    const float c = compl_sum(0.f, nullptr, nullptr) / (m_total * qscale);
    return sgp::nmax(sgp::nmax(r_stat, r_prim), c);
  };

  auto factorize = [&]() {
    for (int i = tid; i < m_h; i += nt) {
      const float th = ch[i];
      wh[i] = ch[m_h + i] / th;
      rph[i] = g_row(Gth, su, nU, m_h, i) + th - dvec[i];
    }
    for (int j = tid; j < m_s; j += nt) {
      const float tU = cs[j], tL = cs[m_s + j], sl = cs[2 * m_s + j], su_ = cs[3 * m_s + j];
      const float lU = cs[4 * m_s + j], lL = cs[5 * m_s + j], nl = cs[6 * m_s + j],
                  nu = cs[7 * m_s + j];
      const float lo = sd[j], hi = sd[m_s + j], zl = sd[2 * m_s + j], zu = sd[3 * m_s + j];
      const float Zl = sd[4 * m_s + j], Zu = sd[5 * m_s + j];
      const float w_U = lU / tU, w_L = lL / tL, w_Pl = nl / sl, w_Pu = nu / su_;
      const float gsu = g_row(Gts, su, nU, m_s, j);
      const float Dl = Zl + w_L + w_Pl, Du = Zu + w_U + w_Pu;
      sxg[j] = w_U;
      sxg[m_s + j] = w_L;
      sxg[2 * m_s + j] = w_Pl;
      sxg[3 * m_s + j] = w_Pu;
      sxg[4 * m_s + j] = gsu - su_ + tU - hi;
      sxg[5 * m_s + j] = -gsu - sl + tL + lo;
      sxg[6 * m_s + j] = Zl * sl + zl - lL - nl;
      sxg[7 * m_s + j] = Zu * su_ + zu - lU - nu;
      sxg[8 * m_s + j] = Dl;
      sxg[9 * m_s + j] = Du;
      sxg[10 * m_s + j] = w_U + w_L - w_U * w_U / Du - w_L * w_L / Dl;
    }
    stationarity(sr1);   // its first barrier publishes wh and sxg
    float accH[MAXP], accS[MAXP];
#pragma unroll
    for (int j = 0; j < MAXP; ++j) { accH[j] = 0.f; accS[j] = 0.f; }
    schur_acc(Gth, wh, nU, m_h, chunk, sG, sW, pr, accH);
    schur_acc(Gts, sxg + 10 * m_s, nU, m_s, chunk, sG, sW, pr, accS);
#pragma unroll
    for (int j = 0; j < MAXP; ++j)
      if (j < pr.n)
        sM[pr.p[j] * ldm + pr.q[j]] = H[pr.p[j] * nU + pr.q[j]] + accH[j] + accS[j];
    __syncthreads();
    for (int p = tid; p < nU; p += nt) {
      const float d = sM[p * ldm + p];
      sinv[p] = 1.0f / sqrtf(d < 1e-30f ? 1e-30f : d);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAXP; ++j)
      if (j < pr.n) {
        const int p = pr.p[j], q = pr.q[j];
        sM[p * ldm + q] = sinv[p] * sM[p * ldm + q] * sinv[q] + (p == q ? reg : 0.f);
      }
    sgp::chol_lower(sM, nU, ldm, lbuf);
  };

  // Newton direction against the current factorization; `ca` = the affine
  // deltas (corrector) or null (predictor).
  auto direction = [&](float sig_mu, const float* cah, const float* cas,
                       float* du, float* ddh, float* dds) {
    for (int i = tid; i < m_h; i += nt)
      tmph[i] = hard_b(ch, cah, m_h, i, sig_mu) - wh[i] * rph[i];
    for (int j = tid; j < m_s; j += nt) {
      const SoftB b = soft_b(cs, sxg, cas, m_s, j, sig_mu);
      const float w_U = sxg[j], w_L = sxg[m_s + j];
      const float rp_U = sxg[4 * m_s + j], rp_L = sxg[5 * m_s + j];
      const float Dl = sxg[8 * m_s + j], Du = sxg[9 * m_s + j];
      tmps[j] = -b.bU + b.bL + w_U * rp_U - w_L * rp_L - w_U * b.cu / Du + w_L * b.cl / Dl;
    }
    __syncthreads();
    gtv(Gth, tmph, nU, m_h, vA);
    gtv(Gts, tmps, nU, m_s, vB);
    __syncthreads();
    for (int p = tid; p < nU; p += nt) sx[p] = sinv[p] * (-sr1[p] + vA[p] - vB[p]);
    __syncthreads();
    if (tid < 32) chol_solve_warp(sM, ldm, nU, sx);
    __syncthreads();
    for (int p = tid; p < nU; p += nt) du[p] = sinv[p] * sx[p];
    __syncthreads();
    for (int i = tid; i < m_h; i += nt) {
      const float dth = -g_row(Gth, du, nU, m_h, i) - rph[i];
      ddh[i] = dth;
      ddh[m_h + i] = -hard_b(ch, cah, m_h, i, sig_mu) - wh[i] * dth;
    }
    for (int j = tid; j < m_s; j += nt) {
      const SoftB b = soft_b(cs, sxg, cas, m_s, j, sig_mu);
      const float w_U = sxg[j], w_L = sxg[m_s + j], w_Pl = sxg[2 * m_s + j],
                  w_Pu = sxg[3 * m_s + j];
      const float rp_U = sxg[4 * m_s + j], rp_L = sxg[5 * m_s + j];
      const float Dl = sxg[8 * m_s + j], Du = sxg[9 * m_s + j];
      const float gsdu = g_row(Gts, du, nU, m_s, j);
      const float dsl = (b.cl - w_L * gsdu) / Dl;
      const float dsu = (b.cu + w_U * gsdu) / Du;
      const float dtU = -gsdu + dsu - rp_U;
      const float dtL = gsdu + dsl - rp_L;
      dds[j] = dtU;
      dds[m_s + j] = dtL;
      dds[2 * m_s + j] = dsl;
      dds[3 * m_s + j] = dsu;
      dds[4 * m_s + j] = -b.bU - w_U * dtU;
      dds[5 * m_s + j] = -b.bL - w_L * dtL;
      dds[6 * m_s + j] = -b.bPl - w_Pl * dsl;
      dds[7 * m_s + j] = -b.bPu - w_Pu * dsu;
    }
    __syncthreads();
  };

  auto max_step = [&](const float* ddh, const float* dds) {
    float r = INFINITY;
    for (int e = tid; e < nh2; e += nt)
      if (ddh[e] < 0.f) r = fminf(r, -ch[e] / ddh[e]);
    for (int e = tid; e < ns8; e += nt)
      if (dds[e] < 0.f) r = fminf(r, -cs[e] / dds[e]);
    r = sgp::block_reduce(r, red, sgp::MinOp(), INFINITY);
    return 0.99f * fminf(1.f, r);
  };

  float sbest = INFINITY;
  int since = 0, it = 0;
  bool stop = false;
  while (it < max_iter && !stop) {
    const float mu = compl_sum(0.f, nullptr, nullptr) / m_total;
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
    for (int e = tid; e < nh2; e += nt) if (!isfinite(ch[e] + alpha * dCh[e])) fin = 0.f;
    for (int e = tid; e < ns8; e += nt) if (!isfinite(cs[e] + alpha * dCs[e])) fin = 0.f;
    const bool ok = sgp::block_reduce(fin, red, sgp::MinOp(), 1.f) > 0.5f;
    if (ok) {
      for (int p = tid; p < nU; p += nt) su[p] = su[p] + alpha * sdC[p];
      for (int e = tid; e < nh2; e += nt) ch[e] = ch[e] + alpha * dCh[e];
      for (int e = tid; e < ns8; e += nt) cs[e] = cs[e] + alpha * dCs[e];
    }
    __syncthreads();
    const float res = ok ? kkt() : INFINITY;
    const bool meaningful = res < sbest * (1.f - stall_rtol);
    const float mu_new = compl_sum(0.f, nullptr, nullptr) / m_total;
    const bool grinding = mu_new < mu_grind * mu0;
    since = (meaningful || !grinding) ? 0 : since + 1;
    if (res < sbest) {
      for (int p = tid; p < nU; p += nt) bu[p] = su[p];
      for (int e = tid; e < nh2; e += nt) bh[e] = ch[e];
      for (int e = tid; e < ns8; e += nt) bs[e] = cs[e];
      sbest = res;
    }
    const bool live = ok && (mu_new > 1e-14f * mu0);
    stop = !live || sbest <= tol || since >= stall_iters;
    ++it;
  }
  if (tid == 0) {
    bres[0] = sbest;
    bit[0] = it;
  }
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
    gtv(Gth, tmph, nU, m_h, vA);
    gtv(Gts, tmps, nU, m_s, vB);
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
      gtv(Gth, h + m_h, nU, m_h, vA);
      gtv(Gts, tmps, nU, m_s, vB);
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

extern "C" int ipm_mehrotra(const float* H, const float* g, const float* Gth,
                            const float* dh, const float* Gts, const float* sd,
                            const float* h0, const float* s0, const float* qs,
                            float* bu, float* bh, float* bs, float* bres, int* bit,
                            float* work, int nU, int m_h, int m_s, float tol, float reg,
                            int max_iter, int stall_iters, float stall_rtol,
                            float mu_grind, int chunk, int smem_bytes, void* stream) {
  if (nU > 128) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ipm_mehrotra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  ipm_mehrotra_kernel<<<1, NT, smem_bytes, (cudaStream_t)stream>>>(
      H, g, Gth, dh, Gts, sd, h0, s0, qs, bu, bh, bs, bres, bit, work, nU, m_h, m_s,
      tol, reg, max_iter, stall_iters, stall_rtol, mu_grind, chunk);
  return (int)cudaGetLastError();
}
