// Fused hall-block GP function-sample stage (SQP iterations >= 1), one output.
//
// Replaces the Pallas TPU kernel sampling_gpmpc_tpu/ops/pallas_gp.py::_hall_kernel
// (launched by sample_hall_one).  Per sample i, with the masked kernel blocks
// evaluated outside (Kxr_i Ht x Rr, Kxh_i Ht x Rh, Ktt_i, Arh_i Rr x Rh,
// Ahh_i Rh x Rh with noise and identity fill, yh_i) and the fixed real factor
// as Linv = L_r^-1 and w_r = L_r^-1 y_r:
//   C   = Linv Arh_i                 V_r = Linv Kxr_i'
//   S   = Ahh_i - C'C + jitter I     L_s = chol(S)
//   W   = [Kxh_i - V_r'C; yh_i - w_r C] L_s^-T       (rows Vh', w_h)
//   cov = Ktt_i - V_r'V_r - Vh'Vh + jitter I,  var = diag(cov) - jitter
//   mean = w_r V_r + w_h Vh,  L = chol(cov),  y = mean + L eps_i
//   then the override tail (sgp::draw_override_tail).
// Only the first nh = hall_n * Ty hall rows take part: the rows past the
// fill are identity rows of S with zero couplings (empty slots are masked),
// so their Cholesky and substitution steps are exact no-ops for everything
// read later and their W columns are exactly zero (pallas_gp.py:315-319).
// No escalating-jitter retry: a non-positive pivot gives NaN, which lands on
// the non-finite -> mean backstop.
//
// What bounds it on the H100.  At the car shape (ns=20, Ht=60, Rr=180,
// nh=180) the products C, V_r, C'C, V_r'C and V_r'V_r are ~26 MFLOP per
// sample, ~0.5 GFLOP per launch set: ~8 us at the float32 rate, while the
// inputs (mostly Arh and Ahh at the 240-row capacity) are ~9 MB, ~3 us at
// HBM rate: operation-bound on paper.  In practice the two Cholesky sweeps
// and the substitution sweep are chains of nh + nh + Ht dependent column
// steps of one CTA each, so the stage is latency-bound.  The design:
//   1. hall_gemm_kernel (two launches) runs the products as batched 32x32
//      tiles over every (sample, tile) at once, into a per-sample workspace
//      in global memory (~7 MB at the car shape, L2-resident): launch 1
//      forms C and V_r', launch 2 the Schur block S, W's first Ht rows and
//      Ktt - V_r'V_r, each with its base block subtracted in the epilogue;
//   2. gp_hall_factor_kernel, one CTA per sample, loads S (nh x nh), W and
//      the covariance into shared memory (~191 KB at nh=180, opt-in), forms
//      W's last row and the real-data mean, factors S, runs the
//      substitution, folds, factors the covariance, draws and writes dg
//      once.  Every sweep is right-looking with the next column finalized
//      during the update (one barrier per column).
// A fill whose factor stage does not fit one CTA's shared memory (nh above
// ~200 at Ht=60, e.g. the full 240-row capacity) is refused by the wrapper
// (ops/gp_hall.py check_supported).  The TPU's VMEM chunking over samples
// (_hall_ns_chunk) is not needed.
#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int GEMM_THREADS = 256;
constexpr int FACTOR_THREADS = 512;
constexpr int MAX_JOBS = 3;

// out[b][m][n] = base[b][m][n] + alpha * sum_k A[b](m, k) B[b](k, n)
//               + (m == n ? diag : 0)
// with every operand addressed by its strides (a transposed operand is a
// swap of strides) and base optional.
struct GemmJob {
  const float* A; long long sAb; int sAm, sAk;
  const float* B; long long sBb; int sBk, sBn;
  const float* D; long long sDb; int sDm;
  float* O; long long sOb; int sOm;
  int M, N, K;
  float alpha, diag;
  int tiles_m, tiles_n, first_tile;
};

struct GemmJobs {
  GemmJob job[MAX_JOBS];
  int n;
};

__global__ void __launch_bounds__(GEMM_THREADS)
hall_gemm_kernel(GemmJobs jobs, int nbatch) {
  __shared__ float As[TILE][TILE + 1];   // As[k][m]
  __shared__ float Bs[TILE][TILE + 1];   // Bs[k][n]
  int q = 0;
  while (q + 1 < jobs.n && (int)blockIdx.x >= jobs.job[q + 1].first_tile) ++q;
  const GemmJob& jb = jobs.job[q];
  const int per_b = jb.tiles_m * jb.tiles_n;
  const int local = blockIdx.x - jb.first_tile;
  const int b = local / per_b, rem = local % per_b;
  const int m0 = (rem / jb.tiles_n) * TILE, n0 = (rem % jb.tiles_n) * TILE;
  if (b >= nbatch) return;
  const float* A = jb.A + b * jb.sAb;
  const float* B = jb.B + b * jb.sBb;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  for (int k0 = 0; k0 < jb.K; k0 += TILE) {
    for (int e = tid; e < TILE * TILE; e += GEMM_THREADS) {
      // the fast index follows the operand's unit stride (coalesced loads)
      int mm, kk;
      if (jb.sAk == 1) { kk = e % TILE; mm = e / TILE; }
      else { mm = e % TILE; kk = e / TILE; }
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < jb.M && k < jb.K)
                       ? A[(long long)m * jb.sAm + (long long)k * jb.sAk] : 0.f;
      int nn;
      if (jb.sBk == 1) { kk = e % TILE; nn = e / TILE; }
      else { nn = e % TILE; kk = e / TILE; }
      const int n = n0 + nn, k2 = k0 + kk;
      Bs[kk][nn] = (n < jb.N && k2 < jb.K)
                       ? B[(long long)k2 * jb.sBk + (long long)n * jb.sBn] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TILE; ++kk) {
      const float a0 = As[kk][ty], a1 = As[kk][ty + 16];
      const float b0 = Bs[kk][tx], b1 = Bs[kk][tx + 16];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
  for (int u = 0; u < 2; ++u) {
    const int m = m0 + ty + 16 * u;
    if (m >= jb.M) continue;
    for (int v = 0; v < 2; ++v) {
      const int n = n0 + tx + 16 * v;
      if (n >= jb.N) continue;
      const float base = jb.D ? jb.D[b * jb.sDb + (long long)m * jb.sDm + n] : 0.f;
      float out = base + jb.alpha * acc[u][v];
      if (m == n) out += jb.diag;
      jb.O[b * jb.sOb + (long long)m * jb.sOm + n] = out;
    }
  }
}

__global__ void __launch_bounds__(FACTOR_THREADS)
gp_hall_factor_kernel(const float* __restrict__ Sw, const float* __restrict__ Ww,
                      const float* __restrict__ Gw, const float* __restrict__ Cw,
                      const float* __restrict__ VTw, const float* __restrict__ yh,
                      const float* __restrict__ w_r, const float* __restrict__ eps,
                      const float* __restrict__ pv, const float* __restrict__ close,
                      const float* __restrict__ ynear, float* __restrict__ dg,
                      int Ht, int Rr, int Rh, int nh, int ty, float jitter,
                      float beta, float var_zero, float rel_floor) {
  extern __shared__ float sm[];
  const int i = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lds = nh + 1, ldw = nh + 1, ldh = Ht + 1;
  float* sS = sm;                      // nh x lds: S, then L_s (lower)
  float* sW = sS + nh * lds;           // (Ht + 1) x ldw: W, then W L_s^-T
  float* sC = sW + (Ht + 1) * ldw;     // Ht x ldh: cov, then L (lower)
  float* sMean = sC + Ht * ldh;        // Ht
  float* sVar = sMean + Ht;            // Ht
  float* sL2 = sVar + Ht;              // 2 max(nh, Ht) column buffers

  const float* S_i = Sw + (size_t)i * nh * nh;
  const float* W_i = Ww + (size_t)i * Ht * nh;
  const float* G_i = Gw + (size_t)i * Ht * Ht;
  const float* C_i = Cw + (size_t)i * Rr * nh;
  const float* VT_i = VTw + (size_t)i * Ht * Rr;
  for (int e = tid; e < nh * nh; e += nt) {
    const int a = e / nh, c = e % nh;
    if (c <= a) sS[a * lds + c] = S_i[e];
  }
  for (int e = tid; e < Ht * nh; e += nt) sW[(e / nh) * ldw + e % nh] = W_i[e];
  for (int e = tid; e < Ht * Ht; e += nt) {
    const int a = e / Ht, c = e % Ht;
    if (c <= a) sC[a * ldh + c] = G_i[e];
  }
  // W's last row yh - w_r C and the real-data mean w_r V_r
  const float* yh_i = yh + (size_t)i * Rh;
  for (int c = tid; c < nh; c += nt) {
    float acc = 0.f;
    for (int r = 0; r < Rr; ++r) acc = fmaf(w_r[r], C_i[(size_t)r * nh + c], acc);
    sW[Ht * ldw + c] = yh_i[c] - acc;
  }
  for (int t = tid; t < Ht; t += nt) {
    const float* vt = VT_i + (size_t)t * Rr;
    float acc = 0.f;
    for (int r = 0; r < Rr; ++r) acc = fmaf(vt[r], w_r[r], acc);
    sMean[t] = acc;
  }
  __syncthreads();

  if (nh > 0) {
    sgp::chol_lower(sS, nh, lds, sL2);    // barriers on entry and exit

    // W <- W L_s^-T, right-looking over columns: column j is final when
    // step j starts; step j subtracts it from every later column and
    // finalizes column j+1 (its last update) in the same pass.
    const int nw = Ht + 1;
    for (int t = tid; t < nw; t += nt) sW[t * ldw] = sW[t * ldw] / sS[0];
    __syncthreads();
    for (int j = 0; j + 1 < nh; ++j) {
      const int m = nh - 1 - j;
      const float djn = sS[(j + 1) * lds + j + 1];
      for (int e = tid; e < nw * m; e += nt) {
        const int t = e / m, k = j + 1 + e % m;
        float v = sW[t * ldw + k] - sW[t * ldw + j] * sS[k * lds + j];
        if (k == j + 1) v = v / djn;
        sW[t * ldw + k] = v;
      }
      __syncthreads();
    }
  }

  // fold: cov -= Vh'Vh (+ jitter on the diagonal), mean += w_h Vh
  for (int e = tid; e < Ht * Ht; e += nt) {
    const int a = e / Ht, c = e % Ht;
    if (c > a) continue;
    const float* wa = sW + a * ldw;
    const float* wc = sW + c * ldw;
    float g = 0.f;
    for (int k = 0; k < nh; ++k) g = fmaf(wa[k], wc[k], g);
    const float s = sC[a * ldh + c] - g + (a == c ? jitter : 0.f);
    sC[a * ldh + c] = s;
    if (a == c) sVar[a] = s - jitter;
  }
  for (int t = tid; t < Ht; t += nt) {
    const float* wt = sW + t * ldw;
    const float* wy = sW + Ht * ldw;
    float acc = 0.f;
    for (int k = 0; k < nh; ++k) acc = fmaf(wt[k], wy[k], acc);
    sMean[t] += acc;
  }
  sgp::chol_lower(sC, Ht, ldh, sL2);       // barriers on entry and exit

  const size_t row = (size_t)i * Ht;
  sgp::draw_override_tail(sC, ldh, sMean, sVar, eps + row, pv,
                          close ? close + row : nullptr,
                          ynear ? ynear + row : nullptr, dg + row, Ht, ty, beta,
                          var_zero, rel_floor);
}

GemmJob job(const float* A, long long sAb, int sAm, int sAk, const float* B,
            long long sBb, int sBk, int sBn, const float* D, long long sDb,
            int sDm, float* O, long long sOb, int sOm, int M, int N, int K,
            float alpha, float diag) {
  GemmJob j{A, sAb, sAm, sAk, B, sBb, sBk, sBn, D, sDb, sDm, O, sOb, sOm,
            M, N, K, alpha, diag, (M + TILE - 1) / TILE, (N + TILE - 1) / TILE, 0};
  return j;
}

cudaError_t launch_gemms(GemmJobs jobs, int ns, cudaStream_t stream) {
  int tiles = 0;
  for (int q = 0; q < jobs.n; ++q) {
    jobs.job[q].first_tile = tiles;
    tiles += ns * jobs.job[q].tiles_m * jobs.job[q].tiles_n;
  }
  if (tiles > 0) hall_gemm_kernel<<<tiles, GEMM_THREADS, 0, stream>>>(jobs, ns);
  return cudaGetLastError();
}

}  // namespace

// Workspace (float32, ns * (Rr*nh + Ht*Rr + nh*nh + Ht*nh + Ht*Ht)): C, V_r',
// S, W's first Ht rows, Ktt - V_r'V_r, per sample.
extern "C" int gp_hall_sample(const float* Kxr, const float* Kxh, const float* Ktt,
                              const float* Arh, const float* Ahh, const float* yh,
                              const float* eps, const float* Linv, const float* w_r,
                              const float* pv, const float* close, const float* ynear,
                              float* dg, float* work, int ns, int Ht, int Rr, int Rh,
                              int nh, int ty, float jitter, float beta, float var_zero,
                              float rel_floor, int smem_bytes, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  float* C = work;
  float* VT = C + (size_t)ns * Rr * nh;
  float* S = VT + (size_t)ns * Ht * Rr;
  float* W = S + (size_t)ns * nh * nh;
  float* G = W + (size_t)ns * Ht * nh;
  const long long HR = (long long)Ht * Rr, RN = (long long)Rr * nh;

  GemmJobs first{};
  first.n = 2;
  // C = Linv Arh_i[:, :nh]
  first.job[0] = job(Linv, 0, Rr, 1, Arh, (long long)Rr * Rh, Rh, 1, nullptr, 0, 0,
                     C, RN, nh, Rr, nh, Rr, 1.f, 0.f);
  // V_r' = Kxr_i Linv'
  first.job[1] = job(Kxr, HR, Rr, 1, Linv, 0, 1, Rr, nullptr, 0, 0, VT, HR, Rr,
                     Ht, Rr, Rr, 1.f, 0.f);
  cudaError_t err = launch_gemms(first, ns, stream);
  if (err != cudaSuccess) return (int)err;

  GemmJobs second{};
  second.n = 3;
  // S = Ahh_i[:nh, :nh] - C'C + jitter I
  second.job[0] = job(C, RN, 1, nh, C, RN, nh, 1, Ahh, (long long)Rh * Rh, Rh, S,
                      (long long)nh * nh, nh, nh, nh, Rr, -1.f, jitter);
  // W[:Ht] = Kxh_i[:, :nh] - V_r'C
  second.job[1] = job(VT, HR, Rr, 1, C, RN, nh, 1, Kxh, (long long)Ht * Rh, Rh, W,
                      (long long)Ht * nh, nh, Ht, nh, Rr, -1.f, 0.f);
  // Ktt_i - V_r'V_r
  second.job[2] = job(VT, HR, Rr, 1, VT, HR, 1, Rr, Ktt, (long long)Ht * Ht, Ht, G,
                      (long long)Ht * Ht, Ht, Ht, Ht, Rr, -1.f, 0.f);
  err = launch_gemms(second, ns, stream);
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(gp_hall_factor_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  gp_hall_factor_kernel<<<ns, FACTOR_THREADS, smem_bytes, stream>>>(
      S, W, G, C, VT, yh, w_r, eps, pv, close, ynear, dg, Ht, Rr, Rh, nh, ty,
      jitter, beta, var_zero, rel_floor);
  return (int)cudaGetLastError();
}
