// Fused empty-hallucination GP function-sample stage, one output.
//
// Replaces the Pallas TPU kernel sampling_gpmpc_tpu/ops/pallas_gp.py::_kernel
// (launched by sample_empty_one).  Per sample i, with the kernel blocks
// Kx_i (Ht x R, masked) and Ktt_i (Ht x Ht) evaluated outside:
//   V = Linv Kx_i'          G = V'V (lower triangle, so exactly symmetric)
//   mean = Kx_i alpha       cov = Ktt_i - G + jitter I,  var = diag(cov) - jitter
//   L = chol(cov)           y = mean + L eps_i
//   override tail (sgp::draw_override_tail, common.cuh), in exactly
//   _override_tail's order: relative variance floor, zero variance -> mean
//   (Ty>1: all tasks of the point), min-dist -> nearest train row, beta
//   clip, non-finite -> mean.
// No escalating-jitter retry: a failed factorization propagates NaN into
// the sample and lands on the non-finite -> mean backstop, as on the TPU.
//
// What bounds it on the H100: almost nothing.  At the flagship shape
// (ns=70, Ht=51, R=108) one sample is ~1.8 MFLOP and reads ~22 KB of Kx plus
// the 47 KB Linv; the whole launch is ~0.13 GFLOP and ~2.3 MB, a few
// microseconds at the card's rates.  It is latency-bound: the Cholesky is a
// chain of Ht dependent column steps, each one barrier.  One CTA per sample
// keeps Kx_i, V and the covariance tile in opt-in dynamic shared memory;
// Linv, read-only and shared by every CTA, is read straight from global
// memory (it stays in L1/L2: 130 KB at the car's R=180), so shared memory
// grows with Ht*R and not with R*R and the car shape (Ht=60, R=180) takes
// ~103 KB.  The TPU's VMEM chunking over samples (_ns_chunk) is not needed:
// samples are independent CTAs.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
gp_sample_empty_kernel(const float* __restrict__ Kx, const float* __restrict__ Ktt,
                       const float* __restrict__ eps, const float* __restrict__ Linv,
                       const float* __restrict__ alpha, const float* __restrict__ pv,
                       const float* __restrict__ close, const float* __restrict__ ynear,
                       float* __restrict__ dg, int Ht, int R, int ty, float jitter,
                       float beta, float var_zero, float rel_floor) {
  extern __shared__ float sm[];
  const int i = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int ldk = R + 1, ldh = Ht + 1;
  float* sKx = sm;                   // Ht x ldk
  float* sV = sKx + Ht * ldk;        // R x ldh
  float* sC = sV + R * ldh;          // Ht x ldh: cov, then L (lower)
  float* sMean = sC + Ht * ldh;      // Ht
  float* sVar = sMean + Ht;          // Ht
  float* sL2 = sVar + Ht;            // 2 Ht (Cholesky column buffers)

  const float* Kx_i = Kx + (size_t)i * Ht * R;
  const float* Ktt_i = Ktt + (size_t)i * Ht * Ht;
  for (int e = tid; e < Ht * R; e += nt) sKx[(e / R) * ldk + e % R] = Kx_i[e];
  __syncthreads();

  // V[r][t] = sum_k Linv[r][k] Kx[t][k];  mean[t] = sum_k alpha[k] Kx[t][k]
  for (int e = tid; e < R * Ht; e += nt) {
    const int r = e / Ht, t = e % Ht;
    const float* lr = Linv + (size_t)r * R;
    const float* kt = sKx + t * ldk;
    float acc = 0.f;
    for (int k = 0; k < R; ++k) acc = fmaf(__ldg(lr + k), kt[k], acc);
    sV[r * ldh + t] = acc;
  }
  for (int t = tid; t < Ht; t += nt) {
    const float* kt = sKx + t * ldk;
    float acc = 0.f;
    for (int k = 0; k < R; ++k) acc = fmaf(alpha[k], kt[k], acc);
    sMean[t] = acc;
  }
  __syncthreads();

  // lower triangle of cov = Ktt - V'V + jitter I
  for (int e = tid; e < Ht * Ht; e += nt) {
    const int a = e / Ht, b = e % Ht;
    if (b > a) continue;
    float g = 0.f;
    for (int r = 0; r < R; ++r) g = fmaf(sV[r * ldh + a], sV[r * ldh + b], g);
    const float s = Ktt_i[a * Ht + b] - g + (a == b ? jitter : 0.f);
    sC[a * ldh + b] = s;
    if (a == b) sVar[a] = s - jitter;
  }
  sgp::chol_lower(sC, Ht, ldh, sL2);   // barriers on entry and exit

  const size_t row = (size_t)i * Ht;
  sgp::draw_override_tail(sC, ldh, sMean, sVar, eps + row, pv,
                          close ? close + row : nullptr,
                          ynear ? ynear + row : nullptr, dg + row, Ht, ty, beta,
                          var_zero, rel_floor);
}

}  // namespace

extern "C" int gp_sample_empty(const float* Kx, const float* Ktt, const float* eps,
                               const float* Linv, const float* alpha, const float* pv,
                               const float* close, const float* ynear, float* dg,
                               int ns, int Ht, int R, int ty, float jitter, float beta,
                               float var_zero, float rel_floor, int smem_bytes,
                               void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gp_sample_empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  gp_sample_empty_kernel<<<ns, 256, smem_bytes, (cudaStream_t)stream>>>(
      Kx, Ktt, eps, Linv, alpha, pv, close, ynear, dg, Ht, R, ty, jitter, beta,
      var_zero, rel_floor);
  return (int)cudaGetLastError();
}
