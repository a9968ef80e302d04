// Fused empty-hallucination GP function-sample stage, every GP output in
// one launch.
//
// Replaces the Pallas TPU kernel sampling_gpmpc_tpu/ops/pallas_gp.py::_kernel
// (launched by sample_empty_one, once per output).  Per output o and
// sample i, with the kernel blocks Kx_i (Ht x R, masked) and Ktt_i (Ht x
// Ht) evaluated outside:
//   V = Linv Kx_i'          mean = Kx_i alpha
//   cov = Ktt_i - V'V + J,  var = diag(cov) - diag(J)
//   L = chol(cov)           y = mean + L eps_i
//   override tail (sgp::draw_override_tail_at, common.cuh), in exactly
//   _override_tail's order: relative variance floor, zero variance -> mean
//   (Ty>1: all tasks of the point), min-dist -> nearest train row, beta
//   clip, non-finite -> mean.
// The triangular solve against the fixed real factor is a matmul with
// Linv.  J is diagonal: row t's jitter is the configured jitter, or
// jitter_rel times the prior variance of the row's task where that is
// larger (sgp::row_jitter), above the float32 rounding of Ktt_i - V'V, so
// that rounding does not decide whether the factor fails.  A failed
// factorization is retried with ten times the jitter, as gp/exact.py's
// safe_cholesky does in float32 (sgp::factor_retry; the TPU kernel has no
// retry); one that fails at every jitter propagates NaN into the sample
// and lands on the non-finite -> mean backstop.
//
// What bounds it on the H100.  At the car shape (3 outputs x ns=20, Ht=60,
// R=180) the products are ~4.6 MFLOP per (output, sample), ~0.28 GFLOP a
// launch (~4 us at the float32 rate) against ~2.8 MB of inputs (~1 us at
// HBM rate): operation-bound on paper, and in practice bound by the chain
// of dependent steps inside each CTA, since the 60 (output, sample) pairs
// fill fewer than half of the 132 SMs.  The design keeps every step busy
// and cuts the chain:
//   1. One CTA of 256 threads per (output, sample), all outputs in one
//      launch.  The lower tiles of the covariance (32x32 tiles at row
//      stride 33, sgp::Tiles) start at zero; Ktt_i's lower triangle goes by
//      cp.async into tiles of its own while the products run.
//   2. V' = Kx_i Linv' is formed 64 of its columns (64 rows of V) at a time
//      as 64x64 output tiles, each thread a 4x4 register tile of FFMA, over
//      32-deep chunks of Kx_i and of Linv staged in shared memory by
//      cp.async, double-buffered (the next chunk's copies fly while this
//      one is multiplied); the first block's pass over Kx_i also forms the
//      mean Kx_i alpha from the staged chunks and a staged chunk of alpha,
//      all threads taking a quarter of a row's depth.  Each finished
//      64-column block P of V' adds P P' straight into the covariance's
//      tiles (tile_gram, 64 threads per tile), each entry of V'V one FMA
//      chain over V's rows in order, as a GEMM and the earlier design sum
//      it (the posterior variance cancels 3-4 of float32's digits, so the
//      kernel follows its plain version's order where it can).  Neither
//      all of V nor all of Kx_i is ever held: shared memory grows with
//      Ht^2, not with Ht*R, so any R runs.
//   3. cov = (Ktt_i - V'V) + J and var = diag(cov) - diag(J), in the
//      plain version's order, then sgp::factor_panel per 32 columns (the
//      blocked Cholesky of gp_hall and the batched Cholesky kernels; about
//      three barriers a panel: 6 at Ht=60 where the earlier column sweep
//      took 60), then the draw and the override tail read the factor in
//      the tiles.
// The 256 threads are what the product's 64x64 tile takes at 4x4 a thread.
// Regions that do not fit one CTA's shared memory (Ktt_i's tiles from
// Ht = 161 on, the covariance's from 225, the V' block from 705) sit in a
// per-CTA region of a global workspace instead; the staged chunks always
// stay in shared memory.  The wrapper (ops/gp_sample.py sample_layout)
// picks the regions from the shapes alone.  Full float32 throughout: no
// TF32.
#include "common.cuh"

namespace {

constexpr int NT = 256;            // threads per CTA
constexpr int PT = 64;             // product tile: rows of Kx_i and of Linv per step
constexpr int PK = 32;             // product depth per staged chunk
constexpr int SLD = PK + 1;        // staged row stride
constexpr int PLD = PT + 1;        // row stride of the V' block P
// one stage: a chunk of Kx_i, of Linv and of alpha
constexpr int STAGE_FLOATS = 2 * PT * SLD + PK;
using sgp::cp_async4;
using sgp::TB;
using sgp::TILE_FLOATS;
using sgp::TLD;
using sgp::Tiles;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One thread's share of the Gram sums of one 32x32 tile, O += P_I P_J' over
// the depth of a V' block (rows of P_I, P_J at stride PLD), continuing each
// entry's single FMA chain from the blocks before, so that an entry of V'V
// is one chain over all of V's rows in order, as a GEMM's per-entry dot
// product runs: 64 threads per tile (t in [0, 64)), a 4x4 register tile
// each.
__device__ __forceinline__ void tile_gram(float* O, const float* PI,
                                          const float* PJ, int t) {
  const int ty = t / 8, tx = t % 8;
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = O[(ty + 8 * u) * TLD + tx + 8 * v];
#pragma unroll 8
  for (int kk = 0; kk < PT; ++kk) {
    float pa[4], pb[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) pa[u] = PI[(ty + 8 * u) * PLD + kk];
#pragma unroll
    for (int v = 0; v < 4; ++v) pb[v] = PJ[(tx + 8 * v) * PLD + kk];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(pa[u], pb[v], acc[u][v]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) O[(ty + 8 * u) * TLD + tx + 8 * v] = acc[u][v];
}

// SHARED: every region in shared memory, known to the compiler (shared
// loads and stores); otherwise each region where its flag says (generic
// loads and stores).
template <bool SHARED>
__global__ void __launch_bounds__(NT)
gp_sample_kernel(const float* __restrict__ Kx, const float* __restrict__ Ktt,
                 const float* __restrict__ eps, const float* __restrict__ Linv,
                 const float* __restrict__ alpha, const float* __restrict__ pv,
                 const float* __restrict__ close, const float* __restrict__ ynear,
                 float* __restrict__ dg, float* __restrict__ work, int ns, int Ht,
                 int R, int ty, float jitter, float jitter_rel, float beta,
                 float var_zero, float rel_floor, int rows_global, int p_global, int tiles_global,
                 int ktt_global, long long work_stride) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, o = b / ns, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = NT / 32;
  const int nt_t = (Ht + TB - 1) / TB, htp = nt_t * TB;
  const int ntile = nt_t * (nt_t + 1) / 2;
  // regions: the two stages and the mean's partial sums in shared memory,
  // then the rows, the V' block, the tiles and Ktt_i's tiles, each in
  // shared memory or in this CTA's workspace region
  float* stage = sm;
  float* mpart = sm + 2 * STAGE_FLOATS;        // 4 x PT
  float* snext = mpart + 4 * PT;
  float* gnext = work + b * work_stride;
  auto place = [&](int glob, int n) {
    float*& next = !SHARED && glob ? gnext : snext;
    float* p = next;
    next += n;
    return p;
  };
  float* sMean = place(rows_global, 3 * Ht);
  float* sVar = sMean + Ht;
  float* sEps = sVar + Ht;
  float* P = place(p_global, htp * PLD);
  float* T = place(tiles_global, ntile * TILE_FLOATS);
  const Tiles M{T};
  const Tiles K{place(ktt_global, ntile * TILE_FLOATS)};

  const float* Kx_i = Kx + (size_t)b * Ht * R;
  const float* Ktt_i = Ktt + (size_t)b * Ht * Ht;
  const float* Li = Linv + (size_t)o * R * R;
  const float* al = alpha + (size_t)o * R;

  // 1. the tiles M <- 0 (they collect V'V), Ktt_i's lower triangle into
  // the tiles K by cp.async (rows by warps, lanes over columns), the draws
  for (int e = tid; e < ntile * TILE_FLOATS; e += NT) T[e] = 0.f;
  for (int a = warp; a < Ht; a += nw)
    for (int c = lane; c <= a; c += 32) {
      float* dst = &K.at(a, c);
      if (!SHARED && ktt_global) *dst = Ktt_i[(size_t)a * Ht + c];
      else cp_async4(dst, Ktt_i + (size_t)a * Ht + c);
    }
  cp_async_commit();
  for (int t = tid; t < Ht; t += NT) sEps[t] = eps[(size_t)b * Ht + t];

  // 2. V' in 64-column blocks P, each P P' added into the tiles; the first
  // pass over Kx_i (the first block) also forms the mean
  const int nq = (R + PT - 1) / PT, ntb = (Ht + PT - 1) / PT;
  const int nk = (R + PK - 1) / PK, per_q = ntb * nk, nsteps = nq * per_q;
  auto load_stage = [&](int s) {
    const int q = s / per_q, tb = (s % per_q) / nk, p = s % nk;
    float* As = stage + (s & 1) * STAGE_FLOATS;   // Kx_i rows x depth
    float* Bs = As + PT * SLD;                    // Linv rows x depth
    float* Al = Bs + PT * SLD;                    // alpha, first block only
    for (int e = tid; e < PT * PK; e += NT) {
      const int rr = e / PK, kk = e % PK, k = p * PK + kk;
      const int t = tb * PT + rr, r = q * PT + rr;
      float* da = As + rr * SLD + kk;
      float* db = Bs + rr * SLD + kk;
      if (t < Ht && k < R) cp_async4(da, Kx_i + (size_t)t * R + k);
      else *da = 0.f;
      if (r < R && k < R) cp_async4(db, Li + (size_t)r * R + k);
      else *db = 0.f;
    }
    if (q == 0 && tid < PK) {
      const int k = p * PK + tid;
      if (k < R) cp_async4(Al + tid, al + k);
      else Al[tid] = 0.f;
    }
    cp_async_commit();
  };
  load_stage(0);
  __syncthreads();
  const int tx = tid % 16, ty4 = tid / 16;
  float acc[4][4], macc = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
  for (int s = 0; s < nsteps; ++s) {
    // the other buffer was last read in step s - 1, whose end barrier every
    // thread has passed
    if (s + 1 < nsteps) {
      load_stage(s + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    __syncthreads();
    const float* As = stage + (s & 1) * STAGE_FLOATS;
    const float* Bs = As + PT * SLD;
#pragma unroll 8
    for (int kk = 0; kk < PK; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = As[(ty4 + 16 * u) * SLD + kk];
#pragma unroll
      for (int v = 0; v < 4; ++v) bb[v] = Bs[(tx + 16 * v) * SLD + kk];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], bb[v], acc[u][v]);
    }
    // the mean: thread (row tid % PT, quarter tid / PT of the depth)
    const bool first = s < per_q, last_k = s % nk == nk - 1;
    if (first) {
      const float* Al = Bs + PT * SLD;
      const int rr = tid % PT, k0 = (tid / PT) * (PK / 4);
#pragma unroll
      for (int kk = k0; kk < k0 + PK / 4; ++kk)
        macc = fmaf(As[rr * SLD + kk], Al[kk], macc);
      if (last_k) {
        mpart[tid] = macc;
        macc = 0.f;
      }
    }
    const int t0 = ((s % per_q) / nk) * PT;
    if (last_k) {                           // this block of rows of P is done
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + ty4 + 16 * u;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (t < htp) P[t * PLD + tx + 16 * v] = acc[u][v];
          acc[u][v] = 0.f;
        }
      }
    }
    if (s % per_q == per_q - 1) {           // P holds 64 columns of V'
      __syncthreads();
      for (int e = tid; e < ntile * 64; e += NT) {
        int I, J;
        sgp::lower_tile(e / 64, I, J);
        tile_gram(M.tile(I, J), P + I * TB * PLD, P + J * TB * PLD, e % 64);
      }
    }
    __syncthreads();
    if (first && last_k && tid < PT && t0 + tid < Ht)
      sMean[t0 + tid] = ((mpart[tid] + mpart[PT + tid]) + mpart[2 * PT + tid])
                        + mpart[3 * PT + tid];
  }

  // 3. cov = (Ktt_i - V'V) + J and the variance, in the plain
  // version's order (each thread adds the Ktt_i entries it copied), Ktt_i
  // - V'V kept in the tiles K for a retry; the blocked factor, retried with
  // more jitter while it fails (sgp::factor_retry), the draw and the
  // override tail
  const float* pvo = pv + (size_t)o * Ht;
  for (int a = warp; a < Ht; a += nw)
    for (int c = lane; c <= a; c += 32) {
      float v = K.at(a, c) - M.at(a, c);
      K.at(a, c) = v;
      if (a == c) {
        const float j = sgp::row_jitter(jitter, jitter_rel, pvo, a);
        v = v + j;
        sVar[a] = v - j;
      }
      M.at(a, c) = v;
    }
  __syncthreads();
  for (int k = 0; k < nt_t; ++k) sgp::factor_panel(M, k, Ht);   // ends in a barrier
  sgp::factor_retry(M, 0, Ht, [&](int a, int c) { return K.at(a, c); }, false, sVar,
                    [&](int a) { return sgp::row_jitter(jitter, jitter_rel, pvo, a); });
  const size_t row = (size_t)b * Ht;
  sgp::draw_override_tail_at(sgp::TiledAt{M, 0}, sMean, sVar, sEps,
                             pvo, close ? close + row : nullptr,
                             ynear ? ynear + row : nullptr, dg + row, Ht, ty, beta,
                             var_zero, rel_floor);
}

}  // namespace

// Inputs stacked over no outputs (leading axis): Kx (no, ns, Ht, R), Ktt
// (no, ns, Ht, Ht), eps (no, ns, Ht), Linv (no, R, R), alpha (no, R), pv
// (no, Ht), close/ynear (no, ns, Ht) or null; dg (no, ns, Ht).  The regions
// flagged global sit in work, work_stride floats per (output, sample), in
// the order rows, V' block, tiles, Ktt_i's tiles; smem_bytes holds the
// stages, the mean's partial sums and the other regions.
extern "C" int gp_sample_empty(const float* Kx, const float* Ktt, const float* eps,
                               const float* Linv, const float* alpha, const float* pv,
                               const float* close, const float* ynear, float* dg,
                               float* work, int no, int ns, int Ht, int R, int ty,
                               float jitter, float jitter_rel, float beta,
                               float var_zero, float rel_floor, int rows_global, int p_global,
                               int tiles_global, int ktt_global,
                               long long work_stride, int smem_bytes,
                               void* stream) {
  const bool shared = !(rows_global || p_global || tiles_global || ktt_global);
  auto kernel = shared ? gp_sample_kernel<true> : gp_sample_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<no * ns, NT, smem_bytes, (cudaStream_t)stream>>>(
      Kx, Ktt, eps, Linv, alpha, pv, close, ynear, dg, work, ns, Ht, R, ty, jitter,
      jitter_rel, beta, var_zero, rel_floor, rows_global, p_global, tiles_global, ktt_global,
      work_stride);
  return (int)cudaGetLastError();
}
