// Fused hall-block GP function-sample stage (SQP iterations >= 1), every GP
// output in one launch set.
//
// Replaces the Pallas TPU kernel sampling_gpmpc_tpu/ops/pallas_gp.py::_hall_kernel
// (launched by sample_hall_one, once per output).  Per output o and sample
// i, with the masked kernel blocks evaluated outside (Kxr Ht x Rr, Kxh
// Ht x Rh, Ktt, Arh Rr x Rh, Ahh Rh x Rh with noise and identity fill, yh)
// and the fixed real factor of output o as Linv = L_r^-1 and w_r = L_r^-1 y_r:
//   C = Linv Arh,  V_r = Linv Kxr',  S = Ahh - C'C + jitter I,
//   B = [Kxh - V_r'C; yh - w_r C],   K = [[Ktt - V_r'V_r + J, -V_r'w_r],
//                                         [-w_r'V_r, 0]]
// and one blocked Cholesky of the bordered matrix M = [[S, B'], [B, K]]:
//   its first nh columns give L_s and, below them, B L_s^-T = [Vh'; w_h];
//   their trailing update leaves cov = Ktt - V_r'V_r - Vh'Vh + J in
//   the K block and -mean (mean = w_r V_r + w_h Vh) in its bordering row;
//   the next Ht columns, bordering row left out, give L = chol(cov);
// then y = mean + L eps and the override tail (sgp::draw_override_tail_at).
// Only the first nh = hall_n * Ty hall rows take part: the rows past the
// fill are identity rows of S with zero couplings (empty slots are masked),
// whose elimination steps are exact no-ops for everything read later
// (pallas_gp.py:315-319).  A non-positive pivot gives NaN, which spreads
// through the later columns exactly as in a column-by-column sweep.  J is
// diagonal: row t's jitter is the configured jitter, or jitter_rel times
// the prior variance of the row's task where that is larger
// (sgp::row_jitter), above the float32 rounding of the covariance, so that
// rounding does not decide whether its factor fails.  A covariance factor
// that fails is retried with ten times the jitter, as gp/exact.py's
// safe_cholesky does in float32 (sgp::factor_retry, from the covariance
// block as the hall columns left it, kept in the workspace's Ktt -
// V_r'V_r region; the TPU kernel has no retry), and one that fails at
// every jitter, or a Schur pivot's NaN, lands on the non-finite -> mean
// backstop.
//
// What bounds it on the H100.  At the car shape (3 outputs x ns=20, Ht=60,
// Rr=180, nh=180) the products C, V_r, C'C, V_r'C and V_r'V_r are ~26 MFLOP
// per (output, sample), ~1.6 GFLOP per stage: ~24 us at the float32 rate,
// against ~27 MB of inputs (~8 us at HBM rate): operation-bound on paper.
// The factorization is a chain of dependent steps, so the design cuts the
// chain and keeps every step busy:
//   1. hall_gemm_kernel (two launches) runs the products as batched 64x64
//      output tiles, 4x4 register tiles per thread, over every (output,
//      sample, tile) at once, into a workspace in global memory (~22 MB at
//      the car shape, L2-resident): launch 1 forms C and V_r', launch 2 the
//      lower tiles of S, B (its last row yh - w_r C too), the lower tiles
//      of Ktt - V_r'V_r and the real-data mean V_r'w_r, each with its base
//      block subtracted in the epilogue;
//   2. gp_hall_factor_kernel, one CTA per (output, sample), holds the lower
//      triangle of M as 32x32 tiles (row stride 33: column reads are
//      conflict-free) in opt-in shared memory, ~152 KB at nh=180, S's last
//      tile padded to a whole tile by identity rows so the covariance
//      starts on a tile boundary.  Each 32-column panel is three steps with
//      one block barrier each (sgp::factor_panel in common.cuh, shared with
//      the batched Cholesky kernels): one warp factors the diagonal tile
//      with its rows in registers (warp_chol32); one thread per row below
//      solves that row against it in registers; the trailing lower tiles
//      take P_I P_J' as 4x4 register-tiled FFMA, 64 threads per tile.  ~24
//      barriers at nh=180 where a column sweep takes ~420.
// A stage whose tiles do not fit one CTA's shared memory (nh above 224 at
// Ht=60; every fill of the 2D pendulum's Ht=120, Rh=360 stage past nh=0;
// every fill of params_car_samples' Ht=400 stage) keeps them in a
// per-(output, sample) region of the global workspace (1.5 / 3.1 / 5.6 MB at
// Ht=400, nh = 400 / 800 / 1200: 44-168 MB a stage, past the 50 MB L2).
// One CTA per factor there ran ~1 % of the card: 30 CTAs on 132 SMs, each
// trailing tile a depth-32 product by 64 threads on unstaged stride-33
// loads.  So the global branch runs the hall columns as a short sequence of
// launches, each over every (output, sample) of the stage at once:
//   3. gp_hall_fill_kernel, one CTA per (tile, factor), writes the lower
//      tiles of M (the same entries the shared branch writes, zero above
//      the diagonal and past the matrix) into the workspace;
//   4. per panel of 64 hall columns (two tiles; one where the hall
//      columns' last tile is left over), two launches:
//      gp_hall_panel_kernel, one CTA per (two tile rows below the panel,
//      factor), loads the panel's diagonal block, factors it (redundantly
//      in every CTA: ~0.1 MFLOP, no sync between CTAs; the hall columns'
//      L_s is never read again, so it is not written back) and solves its
//      rows, bordering row included, against it; gp_hall_update_kernel, one
//      CTA per (lower 64x64 output block past the panel, factor), takes
//      T_IJ -= P_I P_J' as 4x4 register-tiled FFMA at depth 32 x the
//      panel's tiles, its two panel blocks staged whole-tile (coalesced) in
//      shared memory, as hall_gemm_kernel runs the products.  Panels of 64
//      columns halve the trailing matrix's passes through memory (it is
//      read and written once a panel) and the launches against 32: the
//      params_car_samples stage at nh = 400 / 800 / 1200 took 2.91 / 5.18 /
//      8.87 ms in panels of 64 columns, 2.93 / 5.44 / 9.66 ms in panels of
//      32, the single-CTA factor 7.97 / 24.75 / 59.58 ms (H100 80GB HBM3,
//      700 W; the whole launch set, products included);
//   5. gp_hall_finish_kernel, one CTA per factor, runs the shared branch's
//      body from the hall columns' end on (factor_finish: mean and variance
//      rows, the covariance copied over G_i for the retry, the covariance
//      columns by factor_panel, factor_retry, the draw and the override
//      tail) on the tiles in the workspace, FINISH_THREADS threads.  The
//      covariance columns stay in it: 0.64 ms a stage at Ht=400, ~1.9 ms a
//      plan, and the retry keeps its pivots on the device unchanged.
// The branch is chosen from the shapes alone (ops/gp_hall.py
// factor_tiles_global; the panel width is ops/gp_hall.py
// GLOBAL_PANEL_TILES, passed in); the car's fills all keep their tiles in
// shared memory.  Full float32 throughout: no TF32.
//
// The blocks from the points (gp_hall_points; replaces no TPU kernel: the
// JAX package leaves the blocks to XLA's fusion, as the port's plain
// version, gp_hall.hall_blocks_plain, leaves them to ~210 small torch
// launches a stage).  hall_blocks_kernel evaluates the closed forms of
// gp/kernel.py from the real, hall and test points of every (output,
// sample) at once, one thread per (row point, column point) pair, which
// forms k and delta once and writes that pair's Ty x Ty task block
// (point-major), masked, into the stage's workspace in front of the
// regions above: Kxr, Kxh, Ktt, Arh, Ahh (noise on the diagonal, identity
// fill on masked rows), yh, the eps rows and prior_var.  Only the first
// hn = hall_n filled hall points are evaluated, the blocks stored with
// row stride nh (= hn Ty): the launches above read no column past nh.
// Each entry is rounded in kernel.py's order (the __f*_rn intrinsics keep
// nvcc from contracting a product into an FMA), so its float32 value is
// the torch path's to expf's ulp.  ~22 MB of writes at the car's nh =
// 180 (~7 us at HBM rate) and ~20 flop per written float: memory-bound,
// coalesced by the column point across a warp.
#include "common.cuh"

namespace {

constexpr int GT = 64;              // product output tile
constexpr int GK = 16;              // product depth step
constexpr int GEMM_THREADS = 256;
constexpr int FACTOR_THREADS = 256;
constexpr int FILL_THREADS = 256;
constexpr int PANEL_THREADS = 2 * sgp::TB;  // a row each, two tile rows
constexpr int UPDATE_THREADS = 256;        // 64x64 outputs, 4x4 each
constexpr int FINISH_THREADS = 1024;
constexpr int MAX_JOBS = 5;
constexpr int BLOCKS_THREADS = 256;
constexpr int MAX_D = 8;            // ops/gp_hall.py MAX_D
using sgp::factor_panel;
using sgp::TB;
using sgp::TILE_FLOATS;
using sgp::TLD;
using sgp::warp_chol32;
using sgp::Tiles;

// out[b][m][n] = base[b][m][n] + alpha * sum_k A[b](m, k) B[b](k, n)
//               + (m == n ? diag : 0)
// with every operand addressed by its strides (a transposed operand is a
// swap of strides); operand X of batch b sits at X + (b / dX) * sXb (dX = 1
// for a per-sample block, ns for a per-output one); base optional; lower
// skips the output tiles wholly above the diagonal (their entries are
// never read).
struct GemmJob {
  const float* A; long long sAb; int dA, sAm, sAk;
  const float* B; long long sBb; int dB, sBk, sBn;
  const float* D; long long sDb; int sDm;
  float* O; long long sOb; int sOm;
  int M, N, K;
  float alpha, diag;
  int lower;
  int tiles_m, tiles_n, first_tile;
};

struct GemmJobs {
  GemmJob job[MAX_JOBS];
  int n;
};

__global__ void __launch_bounds__(GEMM_THREADS)
hall_gemm_kernel(GemmJobs jobs, int nbatch) {
  __shared__ float As[GK][GT + 4];   // As[k][m]
  __shared__ float Bs[GK][GT + 4];   // Bs[k][n]
  int q = 0;
  while (q + 1 < jobs.n && (int)blockIdx.x >= jobs.job[q + 1].first_tile) ++q;
  const GemmJob& jb = jobs.job[q];
  const int per_b = jb.tiles_m * jb.tiles_n;
  const int local = blockIdx.x - jb.first_tile;
  const int b = local / per_b, rem = local % per_b;
  const int m0 = (rem / jb.tiles_n) * GT, n0 = (rem % jb.tiles_n) * GT;
  if (b >= nbatch || (jb.lower && n0 > m0 + GT - 1)) return;
  const float* A = jb.A + (b / jb.dA) * jb.sAb;
  const float* B = jb.B + (b / jb.dB) * jb.sBb;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

  for (int k0 = 0; k0 < jb.K; k0 += GK) {
#pragma unroll
    for (int r = 0; r < GT * GK / GEMM_THREADS; ++r) {
      const int e = tid + r * GEMM_THREADS;
      // the fast index follows the operand's unit stride (coalesced loads)
      int mm, kk;
      if (jb.sAk == 1) { kk = e % GK; mm = e / GK; }
      else { mm = e % GT; kk = e / GT; }
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < jb.M && k < jb.K)
                       ? A[(long long)m * jb.sAm + (long long)k * jb.sAk] : 0.f;
      int nn;
      if (jb.sBk == 1) { kk = e % GK; nn = e / GK; }
      else { nn = e % GT; kk = e / GT; }
      const int n = n0 + nn, k2 = k0 + kk;
      Bs[kk][nn] = (n < jb.N && k2 < jb.K)
                       ? B[(long long)k2 * jb.sBk + (long long)n * jb.sBn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = As[kk][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) bb[v] = Bs[kk][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], bb[v], acc[u][v]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int m = m0 + ty + 16 * u;
    if (m >= jb.M) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int n = n0 + tx + 16 * v;
      if (n >= jb.N) continue;
      const float base = jb.D ? jb.D[b * jb.sDb + (long long)m * jb.sDm + n] : 0.f;
      float out = base + jb.alpha * acc[u][v];
      if (m == n) out += jb.diag;
      jb.O[b * jb.sOb + (long long)m * jb.sOm + n] = out;
    }
  }
}

// The bordered matrix's sizes at fill nh: S padded to whole tiles (nhp),
// the covariance's end (n2), the bordering row's end (ntot), its tiles.
struct Geom {
  int nhp, n2, ntot, nt_tiles, ntile;
  __host__ __device__ Geom(int Ht, int nh)
      : nhp((nh + TB - 1) / TB * TB), n2(nhp + Ht), ntot(n2 + 1),
        nt_tiles((ntot + TB - 1) / TB), ntile(nt_tiles * (nt_tiles + 1) / 2) {}
};

// Both branches from the hall columns' end on, by the whole block: the mean
// and variance rows, the covariance as the hall columns left it over G_i
// (for a retry), the covariance columns (bordering row left out) retried
// with more jitter while the factor fails, then the draw and the override
// tail.  close, ynear and dg at the factor's rows; sEps filled before.
__device__ void factor_finish(const Tiles& M, int nhp, int Ht, float* G_i,
                              float* sMean, float* sVar, const float* sEps,
                              const float* pvo, float jitter, float jitter_rel,
                              const float* close, const float* ynear, float* dg,
                              int ty, float beta, float var_zero, float rel_floor) {
  const int tid = threadIdx.x, nt = blockDim.x, n2 = nhp + Ht;
  const auto jit0 = [&](int t) { return sgp::row_jitter(jitter, jitter_rel, pvo, t); };
  for (int t = tid; t < Ht; t += nt) {
    sMean[t] = -M.at(n2, nhp + t);
    sVar[t] = M.at(nhp + t, nhp + t) - jit0(t);
  }
  // the covariance as the hall columns left it, for a retry, over G_i
  // (read into the tiles above)
  for (int e = tid; e < Ht * Ht; e += nt) {
    const int a = e / Ht, c = e % Ht;
    if (c <= a) G_i[e] = M.at(nhp + a, nhp + c);
  }
  __syncthreads();
  for (int k = nhp / TB; k * TB < n2; ++k) factor_panel(M, k, n2);
  sgp::factor_retry(M, nhp, n2, [&](int a, int c) { return G_i[(size_t)a * Ht + c]; },
                    true, sVar, jit0);
  sgp::draw_override_tail_at(sgp::TiledAt{M, nhp}, sMean, sVar, sEps, pvo, close,
                             ynear, dg, Ht, ty, beta, var_zero, rel_floor);
}

// The shared-memory branch: one CTA per (output, sample) holds M's tiles and
// the three rows in shared memory and runs the whole factor.
__global__ void __launch_bounds__(FACTOR_THREADS)
gp_hall_factor_kernel(const float* __restrict__ Sw, const float* __restrict__ Ww,
                      float* __restrict__ Gw, const float* __restrict__ Bw,
                      const float* __restrict__ MRw, const float* __restrict__ eps,
                      const float* __restrict__ pv, const float* __restrict__ close,
                      const float* __restrict__ ynear, float* __restrict__ dg, int ns,
                      int Ht, int nh, int ty, float jitter, float jitter_rel, float beta,
                      float var_zero, float rel_floor) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, o = b / ns, tid = threadIdx.x, nt = blockDim.x;
  const Geom g(Ht, nh);
  const int nhp = g.nhp, n2 = g.n2, ntot = g.ntot, ntile = g.ntile;
  float* T = sm;
  const Tiles M{T};
  float* sMean = sm + ntile * TILE_FLOATS;     // Ht
  float* sVar = sMean + Ht;                    // Ht
  float* sEps = sVar + Ht;                     // Ht

  const float* S_i = Sw + (size_t)b * nh * nh;
  const float* W_i = Ww + (size_t)b * Ht * nh;
  float* G_i = Gw + (size_t)b * Ht * Ht;
  const float* B_i = Bw + (size_t)b * nh;
  const float* MR_i = MRw + (size_t)b * Ht;
  const float* pvo = pv + (size_t)o * Ht;
  for (int e = tid; e < ntile * TILE_FLOATS; e += nt) T[e] = 0.f;
  for (int t = tid; t < Ht; t += nt) sEps[t] = eps[(size_t)b * Ht + t];
  __syncthreads();
  for (int e = tid; e < nh * nh; e += nt) {
    const int a = e / nh, c = e % nh;
    if (c <= a) M.at(a, c) = S_i[e];
  }
  for (int a = nh + tid; a < nhp; a += nt) M.at(a, a) = 1.f;
  for (int e = tid; e < Ht * nh; e += nt) M.at(nhp + e / nh, e % nh) = W_i[e];
  for (int e = tid; e < Ht * Ht; e += nt) {
    const int a = e / Ht, c = e % Ht;
    if (c <= a)
      M.at(nhp + a, nhp + c) =
          G_i[e] + (a == c ? sgp::row_jitter(jitter, jitter_rel, pvo, a) : 0.f);
  }
  // the bordering row: yh - w_r C under S, -V_r'w_r under the covariance
  for (int c = tid; c < nh; c += nt) M.at(n2, c) = B_i[c];
  for (int t = tid; t < Ht; t += nt) M.at(n2, nhp + t) = -MR_i[t];
  __syncthreads();

  // the hall columns, bordering row included
  for (int k = 0; k < nhp / TB; ++k) factor_panel(M, k, ntot);
  const size_t row = (size_t)b * Ht;
  factor_finish(M, nhp, Ht, G_i, sMean, sVar, sEps, pvo, jitter, jitter_rel,
                close ? close + row : nullptr, ynear ? ynear + row : nullptr, dg + row,
                ty, beta, var_zero, rel_floor);
}

// The global-tile branch, step 3: one CTA per (lower tile of M, factor)
// writes the tile whole, with the entries the shared branch writes (S, the
// identity rows padding S to whole tiles, B, Ktt - V_r'V_r + J, the
// bordering row) and zero elsewhere (above the diagonal, past the matrix,
// the row stride's pad column).
__global__ void __launch_bounds__(FILL_THREADS)
gp_hall_fill_kernel(const float* __restrict__ Sw, const float* __restrict__ Ww,
                    const float* __restrict__ Gw, const float* __restrict__ Bw,
                    const float* __restrict__ MRw, const float* __restrict__ pv,
                    float* __restrict__ gtiles, int ns, int Ht, int nh, float jitter,
                    float jitter_rel) {
  const int b = blockIdx.y, o = b / ns;
  const Geom g(Ht, nh);
  const int nhp = g.nhp, n2 = g.n2;
  int I, J;
  sgp::lower_tile(blockIdx.x, I, J);
  float* T = gtiles + ((size_t)b * g.ntile + blockIdx.x) * TILE_FLOATS;
  const float* S_i = Sw + (size_t)b * nh * nh;
  const float* W_i = Ww + (size_t)b * Ht * nh;
  const float* G_i = Gw + (size_t)b * Ht * Ht;
  const float* B_i = Bw + (size_t)b * nh;
  const float* MR_i = MRw + (size_t)b * Ht;
  const float* pvo = pv + (size_t)o * Ht;
  for (int e = threadIdx.x; e < TILE_FLOATS; e += blockDim.x) {
    const int cc = e % TLD, a = I * TB + e / TLD, c = J * TB + cc;
    float v = 0.f;
    if (cc < TB && c <= a) {
      if (a < nh) {
        v = S_i[(size_t)a * nh + c];
      } else if (a < nhp) {
        v = a == c ? 1.f : 0.f;
      } else if (a < n2) {
        const int t = a - nhp;
        if (c < nh) v = W_i[(size_t)t * nh + c];
        else if (c >= nhp)
          v = G_i[(size_t)t * Ht + c - nhp] +
              (a == c ? sgp::row_jitter(jitter, jitter_rel, pvo, t) : 0.f);
      } else if (a == n2) {
        if (c < nh) v = B_i[c];
        else if (c >= nhp && c < n2) v = -MR_i[c - nhp];
      }
    }
    T[e] = v;
  }
}

// Copy one tile (TILE_FLOATS floats) from global to shared memory by the
// whole block, coalesced, every copy in flight at once (cp.async): the
// caller waits (copies_done) before reading.
__device__ __forceinline__ void copy_tile(float* dst, const float* src) {
  for (int e = threadIdx.x; e < TILE_FLOATS; e += blockDim.x)
    sgp::cp_async4(dst + e, src + e);
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The panel's diagonal block, np (1 or 2) tiles wide, factored in shared
// memory D (tiles (0,0), (1,0), (1,1) at D + q TILE_FLOATS) with factor_panel's
// steps: the first tile by one warp, the second tile's rows solved against
// it, the second diagonal tile updated and factored.  Ends in a barrier.
__device__ void factor_diag_block(float* D, int np) {
  const int tid = threadIdx.x;
  if (tid < 32) warp_chol32(D, TLD, TB);
  __syncthreads();
  if (np < 2) return;
  float* P = D + TILE_FLOATS;
  float* D1 = D + 2 * TILE_FLOATS;
  if (tid < TB) {
    float x[TB];
#pragma unroll
    for (int j = 0; j < TB; ++j) x[j] = P[tid * TLD + j];
#pragma unroll
    for (int j = 0; j < TB; ++j) {
      x[j] = x[j] / D[j * TLD + j];
#pragma unroll
      for (int c = j + 1; c < TB; ++c) x[c] = fmaf(-x[j], D[c * TLD + j], x[c]);
    }
#pragma unroll
    for (int j = 0; j < TB; ++j) P[tid * TLD + j] = x[j];
  }
  __syncthreads();
  for (int e = tid; e < TB * TB; e += blockDim.x) {
    const int r = e / TB, c = e % TB;
    float acc = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < TB; ++kk) acc = fmaf(P[r * TLD + kk], P[c * TLD + kk], acc);
    D1[r * TLD + c] -= acc;
  }
  __syncthreads();
  if (tid < 32) warp_chol32(D1, TLD, TB);
  __syncthreads();
}

// Step 4a: one CTA per (two tile rows below the panel of np tiles from tile
// k, factor), one thread a row: the panel's diagonal block factored, this
// CTA's rows (those before the bordering row's end; the padding rows stay
// zero) solved against it, x <- x L^-T, in registers, written back.
__global__ void __launch_bounds__(PANEL_THREADS)
gp_hall_panel_kernel(float* __restrict__ gtiles, int Ht, int nh, int k, int np) {
  __shared__ float D[3 * TILE_FLOATS];
  __shared__ float R[2][2][TILE_FLOATS];       // [tile row][panel tile]
  const Geom g(Ht, nh);
  const Tiles M{gtiles + (size_t)blockIdx.y * g.ntile * TILE_FLOATS};
  const int I0 = k + np + 2 * blockIdx.x;
  const int nrow = min(2, g.nt_tiles - I0);
  for (int q = 0; q < np * (np + 1) / 2; ++q) {
    int i, j;
    sgp::lower_tile(q, i, j);
    copy_tile(D + q * TILE_FLOATS, M.tile(k + i, k + j));
  }
  for (int i = 0; i < nrow; ++i)
    for (int p = 0; p < np; ++p) copy_tile(R[i][p], M.tile(I0 + i, k + p));
  copies_done();
  factor_diag_block(D, np);
  const int i = threadIdx.x / TB, r = threadIdx.x % TB;
  if (i < nrow && (I0 + i) * TB + r < g.ntot) {
    float* x0 = R[i][0] + r * TLD;
    float* x1 = R[i][1] + r * TLD;
    float x[TB];
#pragma unroll
    for (int j = 0; j < TB; ++j) x[j] = x0[j];
#pragma unroll
    for (int j = 0; j < TB; ++j) {
      x[j] = x[j] / D[j * TLD + j];
#pragma unroll
      for (int c = j + 1; c < TB; ++c) x[c] = fmaf(-x[j], D[c * TLD + j], x[c]);
    }
#pragma unroll
    for (int j = 0; j < TB; ++j) x0[j] = x[j];
    if (np == 2) {
      // the second panel tile: less P_0 L_10', then against L_11
      const float* P = D + TILE_FLOATS;
      const float* D1 = D + 2 * TILE_FLOATS;
      float y[TB];
#pragma unroll
      for (int c = 0; c < TB; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < TB; ++j) acc = fmaf(x[j], P[c * TLD + j], acc);
        y[c] = x1[c] - acc;
      }
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        y[j] = y[j] / D1[j * TLD + j];
#pragma unroll
        for (int c = j + 1; c < TB; ++c) y[c] = fmaf(-y[j], D1[c * TLD + j], y[c]);
      }
#pragma unroll
      for (int j = 0; j < TB; ++j) x1[j] = y[j];
    }
  }
  __syncthreads();
  for (int i2 = 0; i2 < nrow; ++i2)
    for (int p = 0; p < np; ++p) {
      float* dst = M.tile(I0 + i2, k + p);
      for (int e = threadIdx.x; e < TILE_FLOATS; e += blockDim.x) dst[e] = R[i2][p][e];
    }
}

// Step 4b: one CTA per (lower 64x64 output block of the tiles past the
// panel of NP tiles from tile k, factor): the two block rows' panel tiles
// staged whole in shared memory (a diagonal block stages one), then T_IJ -=
// P_I P_J' over the panel's 32 NP columns, 4x4 outputs a thread as in
// hall_gemm_kernel (rows ty + 16u, columns tx + 16v), the lower tiles only.
template <int NP>
__global__ void __launch_bounds__(UPDATE_THREADS)
gp_hall_update_kernel(float* __restrict__ gtiles, int Ht, int nh, int k) {
  __shared__ float Ps[2][2][NP][TILE_FLOATS];   // [I or J][tile row][panel tile]
  const Geom g(Ht, nh);
  const Tiles M{gtiles + (size_t)blockIdx.y * g.ntile * TILE_FLOATS};
  int a, c;
  sgp::lower_tile(blockIdx.x, a, c);
  const int I0 = k + NP + 2 * a, J0 = k + NP + 2 * c;
  const int ni = min(2, g.nt_tiles - I0), nj = min(2, g.nt_tiles - J0);
  const int sj = a == c ? 0 : 1;               // a diagonal block stages one
  for (int i = 0; i < ni; ++i)
    for (int p = 0; p < NP; ++p) copy_tile(Ps[0][i][p], M.tile(I0 + i, k + p));
  if (sj)
    for (int j = 0; j < nj; ++j)
      for (int p = 0; p < NP; ++p) copy_tile(Ps[1][j][p], M.tile(J0 + j, k + p));
  copies_done();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll 8
    for (int kk = 0; kk < TB; ++kk) {
      float pa[4], pb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) pa[u] = Ps[0][u >> 1][p][(ty + 16 * (u & 1)) * TLD + kk];
#pragma unroll
      for (int v = 0; v < 4; ++v) pb[v] = Ps[sj][v >> 1][p][(tx + 16 * (v & 1)) * TLD + kk];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(pa[u], pb[v], acc[u][v]);
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = u >> 1;
    if (i >= ni) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = v >> 1;
      if (j >= nj || J0 + j > I0 + i) continue;
      M.tile(I0 + i, J0 + j)[(ty + 16 * (u & 1)) * TLD + tx + 16 * (v & 1)] -= acc[u][v];
    }
  }
}

// Step 5: one CTA per (output, sample) finishes the factor on its tiles in
// the workspace (factor_finish); shared memory holds the three rows.
__global__ void __launch_bounds__(FINISH_THREADS)
gp_hall_finish_kernel(float* __restrict__ Gw, const float* __restrict__ eps,
                      const float* __restrict__ pv, const float* __restrict__ close,
                      const float* __restrict__ ynear, float* __restrict__ dg,
                      float* __restrict__ gtiles, int ns, int Ht, int nh, int ty,
                      float jitter, float jitter_rel, float beta, float var_zero,
                      float rel_floor) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, o = b / ns;
  const Geom g(Ht, nh);
  const Tiles M{gtiles + (size_t)b * g.ntile * TILE_FLOATS};
  float* sMean = sm;
  float* sVar = sMean + Ht;
  float* sEps = sVar + Ht;
  const size_t row = (size_t)b * Ht;
  for (int t = threadIdx.x; t < Ht; t += blockDim.x) sEps[t] = eps[row + t];
  factor_finish(M, g.nhp, Ht, Gw + (size_t)b * Ht * Ht, sMean, sVar, sEps,
                pv + (size_t)o * Ht, jitter, jitter_rel, close ? close + row : nullptr,
                ynear ? ynear + row : nullptr, dg + row, ty, beta, var_zero, rel_floor);
}

// The points and blocks of gp_hall_points (layouts there).
struct HallPoints {
  const float *real_Z, *m_r, *hall_Z, *hall_Y, *Xt, *eps, *ls, *os, *noise;
  float *Kxr, *Kxh, *Ktt, *Arh, *Ahh, *yh, *eps_o, *pv;
  int no, ns, N, Mh, H, D, ty, hn;
};

// A task row or column's mask: 1, the real mask, or "not NaN" of a hall
// observation.
struct Mask {
  const float* m;     // real mask, or null
  const float* y;     // hall observations (NaN: masked), or null
  __device__ float at(int t) const {
    if (m) return m[t];
    if (y) return isnan(y[t]) ? 0.f : 1.f;
    return 1.f;
  }
};

// One (row point x, column point z) pair's Ty x Ty block of output o's
// kernel, at out + (r Ty) ld + c Ty, each entry (v [+ noise]) * m_row *
// m_col [+ 1 - m_row] (hh: the hall-hall block, noise and identity fill
// on its diagonal), in gp/kernel.py's order of operations:
//   rbf_grad: diff = x - z, delta = diff / l^2, k = s exp(-0.5 sum diff delta),
//     [k, k delta_e; -k delta_d, k (I_de / l_d^2 - delta_d delta_e)];
//   rbf (ty = 1): diff = (x - z) / l, k = s exp(-0.5 sum diff diff).
__device__ void pair_block(float* out, int ld, int r, int c, const float* x,
                           const float* z, const float* ls, float os, int D, int ty,
                           Mask rm, Mask cm, bool hh, const float* noise) {
  float il2[MAX_D], delta[MAX_D];
  float s = 0.f;
  for (int d = 0; d < D; ++d) {
    const float l = ls[d];
    if (ty > 1) {
      il2[d] = __fdiv_rn(1.f, __fmul_rn(l, l));
      const float diff = __fsub_rn(x[d], z[d]);
      delta[d] = __fmul_rn(diff, il2[d]);
      s = __fadd_rn(s, __fmul_rn(diff, delta[d]));
    } else {
      const float diff = __fdiv_rn(__fsub_rn(x[d], z[d]), l);
      s = __fadd_rn(s, __fmul_rn(diff, diff));
    }
  }
  const float k = __fmul_rn(os, expf(__fmul_rn(-0.5f, s)));
  const bool diag = hh && r == c;
  for (int a = 0; a < ty; ++a) {
    const float mr = rm.at(r * ty + a);
    const float da = a ? delta[a - 1] : 0.f;
    float* row = out + (size_t)(r * ty + a) * ld + (size_t)c * ty;
    for (int b = 0; b < ty; ++b) {
      float v;
      if (a == 0) v = b == 0 ? k : __fmul_rn(k, delta[b - 1]);
      else if (b == 0) v = __fmul_rn(-k, da);
      else v = __fmul_rn(k, __fsub_rn(a == b ? il2[a - 1] : 0.f,
                                      __fmul_rn(da, delta[b - 1])));
      const bool dd = diag && a == b;
      if (hh) v = __fadd_rn(v, dd ? noise[a] : 0.f);
      v = __fmul_rn(__fmul_rn(v, mr), cm.at(c * ty + b));
      if (hh) v = __fadd_rn(v, dd ? __fsub_rn(1.f, mr) : 0.f);
      row[b] = v;
    }
  }
}

// One thread per (row point, column point) pair of every block, then one
// per hall point (yh) and per test point (eps rows; prior_var on sample
// 0), for the (output, sample) pair b = blockIdx.x / chunks.
__global__ void __launch_bounds__(BLOCKS_THREADS)
hall_blocks_kernel(HallPoints p, int chunks) {
  const int b = blockIdx.x / chunks, o = b / p.ns, i = b % p.ns;
  long long e = (long long)(blockIdx.x % chunks) * BLOCKS_THREADS + threadIdx.x;
  const int N = p.N, hn = p.hn, H = p.H, D = p.D, ty = p.ty;
  const int Rr = N * ty, nh = hn * ty, Ht = H * ty;
  const float* Zr = p.real_Z;
  const float* Zh = p.hall_Z + ((size_t)i * p.no + o) * p.Mh * D;
  const float* Yh = p.hall_Y + ((size_t)i * p.no + o) * p.Mh * ty;
  const float* X = p.Xt + (size_t)i * H * D;
  const float* ls = p.ls + (size_t)o * D;
  const float os = p.os[o];
  const Mask none{nullptr, nullptr}, mr{p.m_r + (size_t)o * Rr, nullptr},
      mh{nullptr, Yh};
  // Arh: real x hall
  if (e < (long long)N * hn) {
    const int r = e / hn, c = e % hn;
    pair_block(p.Arh + (size_t)b * Rr * nh, nh, r, c, Zr + (size_t)r * D,
               Zh + (size_t)c * D, ls, os, D, ty, mr, mh, false, nullptr);
    return;
  }
  e -= (long long)N * hn;
  // Ahh: hall x hall, noise and identity fill on the diagonal
  if (e < (long long)hn * hn) {
    const int r = e / hn, c = e % hn;
    pair_block(p.Ahh + (size_t)b * nh * nh, nh, r, c, Zh + (size_t)r * D,
               Zh + (size_t)c * D, ls, os, D, ty, mh, mh, true, p.noise);
    return;
  }
  e -= (long long)hn * hn;
  // Kxr: test x real
  if (e < (long long)H * N) {
    const int r = e / N, c = e % N;
    pair_block(p.Kxr + (size_t)b * Ht * Rr, Rr, r, c, X + (size_t)r * D,
               Zr + (size_t)c * D, ls, os, D, ty, none, mr, false, nullptr);
    return;
  }
  e -= (long long)H * N;
  // Kxh: test x hall
  if (e < (long long)H * hn) {
    const int r = e / hn, c = e % hn;
    pair_block(p.Kxh + (size_t)b * Ht * nh, nh, r, c, X + (size_t)r * D,
               Zh + (size_t)c * D, ls, os, D, ty, none, mh, false, nullptr);
    return;
  }
  e -= (long long)H * hn;
  // Ktt: test x test
  if (e < (long long)H * H) {
    const int r = e / H, c = e % H;
    pair_block(p.Ktt + (size_t)b * Ht * Ht, Ht, r, c, X + (size_t)r * D,
               X + (size_t)c * D, ls, os, D, ty, none, none, false, nullptr);
    return;
  }
  e -= (long long)H * H;
  // yh = nan_to_num(y) m_h
  if (e < hn) {
    for (int a = 0; a < ty; ++a) {
      const int t = (int)e * ty + a;
      float y = Yh[t];
      const float m = isnan(y) ? 0.f : 1.f;
      if (isnan(y)) y = 0.f;
      else if (isinf(y)) y = copysignf(3.402823466e38f, y);
      p.yh[(size_t)b * nh + t] = __fmul_rn(y, m);
    }
    return;
  }
  e -= hn;
  // the eps rows; prior_var: s for the value, s / l_d^2 for gradient d
  if (e < H) {
    for (int a = 0; a < ty; ++a) {
      const int t = (int)e * ty + a;
      p.eps_o[(size_t)b * Ht + t] = p.eps[((size_t)i * p.no + o) * Ht + t];
      if (i == 0)
        p.pv[(size_t)o * Ht + t] =
            a == 0 ? os : __fdiv_rn(os, __fmul_rn(ls[a - 1], ls[a - 1]));
    }
  }
}

GemmJob job(const float* A, long long sAb, int dA, int sAm, int sAk, const float* B,
            long long sBb, int dB, int sBk, int sBn, const float* D, long long sDb,
            int sDm, float* O, long long sOb, int sOm, int M, int N, int K,
            float alpha, float diag, int lower) {
  GemmJob j{A, sAb, dA, sAm, sAk, B, sBb, dB, sBk, sBn, D, sDb, sDm, O, sOb, sOm,
            M, N, K, alpha, diag, lower, (M + GT - 1) / GT, (N + GT - 1) / GT, 0};
  return j;
}

cudaError_t launch_gemms(GemmJobs jobs, int nb, cudaStream_t stream) {
  int tiles = 0;
  for (int q = 0; q < jobs.n; ++q) {
    jobs.job[q].first_tile = tiles;
    tiles += nb * jobs.job[q].tiles_m * jobs.job[q].tiles_n;
  }
  if (tiles > 0) hall_gemm_kernel<<<tiles, GEMM_THREADS, 0, stream>>>(jobs, nb);
  return cudaGetLastError();
}

// The two product launches and the factor's launches, from the blocks (Rh
// their hall row stride): panel_tiles 0, the shared-memory branch's one
// launch; 1 or 2, the global-tile branch's, in panels of that many tiles.
int launch_stage(const float* Kxr, const float* Kxh, const float* Ktt, const float* Arh,
                 const float* Ahh, const float* yh, const float* eps, const float* Linv,
                 const float* w_r, const float* pv, const float* close,
                 const float* ynear, float* dg, float* work, int no, int ns, int Ht,
                 int Rr, int Rh, int nh, int ty, float jitter, float jitter_rel,
                 float beta, float var_zero, float rel_floor, int smem_bytes,
                 int panel_tiles, cudaStream_t stream) {
  if (panel_tiles < 0 || panel_tiles > 2) return (int)cudaErrorInvalidValue;
  const int nb = no * ns;
  float* C = work;
  float* VT = C + (size_t)nb * Rr * nh;
  float* S = VT + (size_t)nb * Ht * Rr;
  float* W = S + (size_t)nb * nh * nh;
  float* G = W + (size_t)nb * Ht * nh;
  float* Bl = G + (size_t)nb * Ht * Ht;
  float* MR = Bl + (size_t)nb * nh;
  const long long HR = (long long)Ht * Rr, RN = (long long)Rr * nh;
  const long long RR = (long long)Rr * Rr;

  GemmJobs first{};
  first.n = 2;
  // C = Linv Arh[:, :nh]
  first.job[0] = job(Linv, RR, ns, Rr, 1, Arh, (long long)Rr * Rh, 1, Rh, 1, nullptr, 0,
                     0, C, RN, nh, Rr, nh, Rr, 1.f, 0.f, 0);
  // V_r' = Kxr Linv'
  first.job[1] = job(Kxr, HR, 1, Rr, 1, Linv, RR, ns, 1, Rr, nullptr, 0, 0, VT, HR, Rr,
                     Ht, Rr, Rr, 1.f, 0.f, 0);
  cudaError_t err = launch_gemms(first, nb, stream);
  if (err != cudaSuccess) return (int)err;

  GemmJobs second{};
  second.n = 5;
  // S = Ahh[:nh, :nh] - C'C + jitter I (lower tiles)
  second.job[0] = job(C, RN, 1, 1, nh, C, RN, 1, nh, 1, Ahh, (long long)Rh * Rh, Rh, S,
                      (long long)nh * nh, nh, nh, nh, Rr, -1.f, jitter, 1);
  // B[:Ht] = Kxh[:, :nh] - V_r'C
  second.job[1] = job(VT, HR, 1, Rr, 1, C, RN, 1, nh, 1, Kxh, (long long)Ht * Rh, Rh, W,
                      (long long)Ht * nh, nh, Ht, nh, Rr, -1.f, 0.f, 0);
  // Ktt - V_r'V_r (lower tiles)
  second.job[2] = job(VT, HR, 1, Rr, 1, VT, HR, 1, 1, Rr, Ktt, (long long)Ht * Ht, Ht, G,
                      (long long)Ht * Ht, Ht, Ht, Ht, Rr, -1.f, 0.f, 1);
  // B's last row yh[:nh] - w_r C (one output row)
  second.job[3] = job(w_r, Rr, ns, 0, 1, C, RN, 1, nh, 1, yh, Rh, 0, Bl, nh, 0, 1, nh,
                      Rr, -1.f, 0.f, 0);
  // the real-data mean V_r'w_r (one output column)
  second.job[4] = job(VT, HR, 1, Rr, 1, w_r, Rr, ns, 1, 0, nullptr, 0, 0, MR, Ht, 1, Ht,
                      1, Rr, 1.f, 0.f, 0);
  err = launch_gemms(second, nb, stream);
  if (err != cudaSuccess) return (int)err;

  if (!panel_tiles) {
    err = cudaFuncSetAttribute(gp_hall_factor_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    gp_hall_factor_kernel<<<nb, FACTOR_THREADS, smem_bytes, stream>>>(
        S, W, G, Bl, MR, eps, pv, close, ynear, dg, ns, Ht, nh, ty, jitter, jitter_rel,
        beta, var_zero, rel_floor);
    return (int)cudaGetLastError();
  }
  // the global-tile branch: the tiles after the workspace's regions above
  float* gt = MR + (size_t)nb * Ht;
  const Geom g(Ht, nh);
  const int ht = g.nhp / TB;                           // hall column tiles
  gp_hall_fill_kernel<<<dim3(g.ntile, nb), FILL_THREADS, 0, stream>>>(
      S, W, G, Bl, MR, pv, gt, ns, Ht, nh, jitter, jitter_rel);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int k = 0; k < ht; k += panel_tiles) {
    const int np = min(panel_tiles, ht - k);
    const int nblk = (g.nt_tiles - k - np + 1) / 2;   // 64-row blocks below
    gp_hall_panel_kernel<<<dim3(nblk, nb), PANEL_THREADS, 0, stream>>>(gt, Ht, nh, k,
                                                                      np);
    const dim3 grid(nblk * (nblk + 1) / 2, nb);
    if (np == 2)
      gp_hall_update_kernel<2><<<grid, UPDATE_THREADS, 0, stream>>>(gt, Ht, nh, k);
    else
      gp_hall_update_kernel<1><<<grid, UPDATE_THREADS, 0, stream>>>(gt, Ht, nh, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(gp_hall_finish_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  gp_hall_finish_kernel<<<nb, FINISH_THREADS, smem_bytes, stream>>>(
      G, eps, pv, close, ynear, dg, gt, ns, Ht, nh, ty, jitter, jitter_rel, beta,
      var_zero, rel_floor);
  return (int)cudaGetLastError();
}

// The blocks' regions in blocks (gp_hall_blocks' layout) and the points.
HallPoints hall_points(const float* real_Z, const float* m_r, const float* hall_Z,
                       const float* hall_Y, const float* Xt, const float* eps,
                       const float* ls, const float* os, const float* noise,
                       float* blocks, int no, int ns, int N, int Mh, int H, int D,
                       int ty, int hn) {
  const size_t nb = (size_t)no * ns, Rr = (size_t)N * ty, nh = (size_t)hn * ty,
               Ht = (size_t)H * ty;
  HallPoints p{real_Z, m_r, hall_Z, hall_Y, Xt, eps, ls, os, noise};
  p.Kxr = blocks;
  p.Kxh = p.Kxr + nb * Ht * Rr;
  p.Ktt = p.Kxh + nb * Ht * nh;
  p.Arh = p.Ktt + nb * Ht * Ht;
  p.Ahh = p.Arh + nb * Rr * nh;
  p.yh = p.Ahh + nb * nh * nh;
  p.eps_o = p.yh + nb * nh;
  p.pv = p.eps_o + nb * Ht;
  p.no = no; p.ns = ns; p.N = N; p.Mh = Mh; p.H = H; p.D = D; p.ty = ty; p.hn = hn;
  return p;
}

cudaError_t launch_blocks(const HallPoints& p, cudaStream_t stream) {
  const long long per_b = (long long)p.N * p.hn + (long long)p.hn * p.hn +
                          (long long)p.H * p.N + (long long)p.H * p.hn +
                          (long long)p.H * p.H + p.hn + p.H;
  const int chunks = (int)((per_b + BLOCKS_THREADS - 1) / BLOCKS_THREADS);
  const long long ctas = (long long)p.no * p.ns * chunks;
  if (ctas > 0)
    hall_blocks_kernel<<<(unsigned)ctas, BLOCKS_THREADS, 0, stream>>>(p, chunks);
  return cudaGetLastError();
}

}  // namespace

// Inputs stacked over no outputs (leading axis): Kxr (no, ns, Ht, Rr), Kxh
// (no, ns, Ht, Rh), Ktt (no, ns, Ht, Ht), Arh (no, ns, Rr, Rh), Ahh (no, ns,
// Rh, Rh), yh (no, ns, Rh), eps (no, ns, Ht), Linv (no, Rr, Rr), w_r (no,
// Rr), pv (no, Ht), close/ynear (no, ns, Ht) or null; dg (no, ns, Ht).
// Workspace (float32, no * ns * (Rr*nh + Ht*Rr + nh*nh + Ht*nh + Ht*Ht + nh
// + Ht), plus no * ns * tile_floats when panel_tiles > 0): C, V_r', S, B's
// first Ht rows, Ktt - V_r'V_r, B's last row yh - w_r C and the real-data
// mean V_r'w_r, per (output, sample), then the factor's tiles when they do
// not fit shared memory (tile_floats each; panel_tiles, 1 or 2, the global
// branch's panel width in tiles; smem_bytes then holds only the three
// rows).
extern "C" int gp_hall_sample(const float* Kxr, const float* Kxh, const float* Ktt,
                              const float* Arh, const float* Ahh, const float* yh,
                              const float* eps, const float* Linv, const float* w_r,
                              const float* pv, const float* close, const float* ynear,
                              float* dg, float* work, int no, int ns, int Ht, int Rr,
                              int Rh, int nh, int ty, float jitter, float jitter_rel,
                              float beta, float var_zero, float rel_floor,
                              int smem_bytes, int panel_tiles, void* stream) {
  return launch_stage(Kxr, Kxh, Ktt, Arh, Ahh, yh, eps, Linv, w_r, pv, close, ynear, dg,
                      work, no, ns, Ht, Rr, Rh, nh, ty, jitter, jitter_rel, beta,
                      var_zero, rel_floor, smem_bytes, panel_tiles,
                      (cudaStream_t)stream);
}

// The blocks of the stage from the points, into blocks: real_Z (N, D), m_r
// (no, Rr = N ty), hall_Z (ns, no, Mh, D), hall_Y (ns, no, Mh, ty) (NaN:
// masked), Xt (ns, H, D), eps (ns, no, H, ty), ls (no, D), os (no), noise
// (ty); hn filled hall points of each (output, sample), nh = hn ty.  Per
// (output, sample): Kxr (Ht, Rr), Kxh (Ht, nh), Ktt (Ht, Ht), Arh (Rr, nh),
// Ahh (nh, nh), yh (nh), the eps rows (Ht), each region after the last
// one's nb blocks (ops/gp_hall.py block_views), then prior_var (no, Ht).
extern "C" int gp_hall_blocks(const float* real_Z, const float* m_r, const float* hall_Z,
                              const float* hall_Y, const float* Xt, const float* eps,
                              const float* ls, const float* os, const float* noise,
                              float* blocks, int no, int ns, int N, int Mh, int H, int D,
                              int ty, int hn, void* stream) {
  const HallPoints p = hall_points(real_Z, m_r, hall_Z, hall_Y, Xt, eps, ls, os, noise,
                                   blocks, no, ns, N, Mh, H, D, ty, hn);
  return (int)launch_blocks(p, (cudaStream_t)stream);
}

// The whole stage from the points: gp_hall_blocks into the front of the
// workspace, then gp_hall_sample's launches (Rh = nh) on them and on the
// real factor Linv (no, Rr, Rr), w_r (no, Rr), close/ynear (no, ns, Ht) or
// null; dg (no, ns, Ht).  Workspace: the blocks, then gp_hall_sample's
// workspace at nh.
extern "C" int gp_hall_points(const float* real_Z, const float* m_r, const float* hall_Z,
                              const float* hall_Y, const float* Xt, const float* eps,
                              const float* ls, const float* os, const float* noise,
                              const float* Linv, const float* w_r, const float* close,
                              const float* ynear, float* dg, float* work, int no, int ns,
                              int N, int Mh, int H, int D, int ty, int hn, float jitter,
                              float jitter_rel, float beta, float var_zero,
                              float rel_floor, int smem_bytes, int panel_tiles,
                              void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const HallPoints p = hall_points(real_Z, m_r, hall_Z, hall_Y, Xt, eps, ls, os, noise,
                                   work, no, ns, N, Mh, H, D, ty, hn);
  const cudaError_t err = launch_blocks(p, stream);
  if (err != cudaSuccess) return (int)err;
  const int nh = hn * ty, Ht = H * ty;
  return launch_stage(p.Kxr, p.Kxh, p.Ktt, p.Arh, p.Ahh, p.yh, p.eps_o, Linv, w_r, p.pv,
                      close, ynear, dg, p.pv + (size_t)no * Ht, no, ns, Ht, N * ty, nh,
                      nh, ty, jitter, jitter_rel, beta, var_zero, rel_floor,
                      smem_bytes, panel_tiles, stream);
}
