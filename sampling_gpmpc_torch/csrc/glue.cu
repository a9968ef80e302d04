// Condensing and QP assembly of one SQP iteration in one launch, and
// (glue_advance_kernel, at the end) the consumption of its step.
//
// Replaces no Pallas TPU kernel: the JAX package leaves condensing and
// assembly (sampling_gpmpc_tpu/ocp/condense.py, ocp/assemble.py) to XLA's
// fusion.  In the port the same chain ran as ~140 small torch ops a
// SQP iteration (ops/glue.py::assemble_plain, which stays as this
// kernel's plain version), each a launch the host issues and the card
// idles on.  From the linearization rows [value | d/dx | d/du] of every
// sample and stage (Env.assemble_val_jac) and the iterate, it computes in
// float32:
//   the feedback chain rule      A <- A + B K                (use_feedback)
//   the residuals                r_k = val_k - X_{k+1},  dx0 = x - X_0
//   the condensing               [Gamma | T]_{k+1} = A_k [Gamma | T]_k
//                                                    + [B_k e_k' | r_k]
//   the cost                     H_U = sum_ik Gamma' Hx_ik Gamma + kron(I_H, 2 Qu + lm I)
//                                g_U = sum_ik Gamma' grad_ik + 2 Ubar Qu
//   the hard rows                input box, state box (no ellipses), feedback
//                                rows K Gamma + selector, as [G; -G], [hi; -lo]
//   the soft rows                terminal ellipse, obstacle ellipses, soft
//                                state box, with their z/Z penalty vectors
// in exactly the row order of ocp/assemble.py and ocp/qp.py::boxes_to_rows.
//
// What bounds it on the H100.  The outputs are the whole work: at the
// 1D pendulum's shape (ns = 70, H = 17, nx = 2, nU = 17) ~0.7 MB of rows
// and Gamma, well under a microsecond at HBM rate, and ~0.2 MFLOP.  What
// takes time is the recursion's chain of H dependent stages in each
// sample.  So:
//   1. One CTA of 256 threads per sample (a CTA walks samples i, i + grid,
//      ... when ns exceeds the grid).  The OCP data a stage reads (weights,
//      references, bounds, gains) is staged in shared memory once per CTA,
//      the sample's linearization rows and iterate once per sample, so a
//      stage waits on no global load; the nx x (nU + 1) carry
//      [Gamma_k | T_k] is double-buffered there, and only its first k nu
//      columns (Gamma_k's nonzero ones) and T are ever computed.
//   2. Each stage writes Gamma_k and T_k once and, from the same carry, the
//      sample's rows straight into their final places: both signs of the
//      hard rows and of d_h, the feedback rows, the soft rows and their
//      penalties.  Two barriers a stage: the stage's small vectors
//      (xpred, A_k, r_k, grad, M = Hx Gamma_k), then everything else.
//   3. The cost sums take one of two branches, fixed per launch from the
//      shape (ops/glue.py::layout).  Narrow (nU <= 64, every pendulum
//      shape, params_car): the sample's upper triangle of
//      sum_k Gamma' Hx Gamma and its sum_k Gamma' grad accumulate in
//      shared memory, each entry by one thread per stage, and land in the
//      sample's slot of the workspace; the last CTA to finish (an integer
//      ticket after __threadfence, reset by that CTA) sums the ns slots in
//      sample order, one thread per entry with eight loads in flight.
//      That sum is O(kn^2 nx) a stage on the recursion's serial path, so
//      for wide QPs (params_car_residual's nU = 100, params_car_samples'
//      200) the stages instead write M = [Hx Gamma_k | grad_k] beside
//      Gamma_k, and a second launch (glue_gram_kernel) forms H_U = Gamma' M
//      and g_U as a Gram product over the ns (H + 1) nx rows: one CTA per
//      32 x 32 tile of H_U's upper triangle, rows summed in order.
//   4. Both branches are deterministic, without float atomics, and add the
//      input block at the end (unless a sample-axis group adds it after its
//      psum), writing H_U symmetric.  Block 0 writes the
//      sample-independent input-box rows.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;

struct GlueArgs {
  // inputs
  const float* comb;  // (ns, H, nx, 1 + nx + nu) [value | d/dx | d/du]
  const float* X;     // (H + 1, ns, nx) iterate
  const float* U;     // (H, nu)
  const float* st;    // (nx,) measured state
  const float* Qs;    // (nx, nx)
  const float* Qe;    // (nx, nx)
  const float* Qu;    // (nu, nu)
  const float* xref;  // (H + 1, nx)
  const float* w;     // (ns,) cost weights
  const float* lm;    // () Levenberg-Marquardt
  const float* u_lo;  // (nu,)
  const float* u_hi;
  const float* x_lo;  // (H + 1, nx)
  const float* x_hi;
  const float* fb_lo;  // (H, nu)
  const float* fb_hi;
  const float* K;      // (nu, nx)
  const float* x_eq;   // (nx,)
  const float* P;      // (nx, nx) terminal metric
  const float* delta_sq;  // ()
  const float* ell;       // (n_ell, 5)
  const float* pen[8];    // () zl, zu, Zl, Zu terminal, then path
  // outputs
  float* H_U;    // (nU, nU)
  float* g;      // (nU,)
  float* C_h;    // (2 n_hard, nU)
  float* d_h;    // (2 n_hard,)
  float* G_s;    // (m_s, nU)
  float* lo_s;   // (m_s,) and hi_s, zl, zu, Zl, Zu alike
  float* hi_s;
  float* zl;
  float* zu;
  float* Zl;
  float* Zu;
  float* T;      // (ns, H + 1, nx)
  float* Gamma;  // (ns, H + 1, nx, nU)
  float* work;   // narrow: ns slots of nU * nU + nU; wide: M, (ns, H + 1,
                 // nx, nU + 1)
  int* ticket;   // 0 between launches
  int ns, H, nx, nu, n_ell;
  int feedback, terminal, with_block;
};

// GRAM: the wide branch (header, 3): the stages write M for
// glue_gram_kernel instead of summing the cost in shared memory
template <bool GRAM>
__global__ void __launch_bounds__(NT) glue_condense_kernel(const GlueArgs a) {
  extern __shared__ float sm[];
  __shared__ int s_last;
  const int ns = a.ns, H = a.H, nx = a.nx, nu = a.nu, n_ell = a.n_ell;
  const int nU = H * nu, ldc = nU + 1, W = 1 + nx + nu;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t slot_n = (size_t)nU * nU + nU;
  // hard rows before their negations: input box, state box, feedback
  const size_t n_hard = (size_t)nU + (n_ell == 0 ? (size_t)ns * H * nx : 0) +
                        (a.feedback ? (size_t)ns * H * nu : 0);
  const size_t base_fb = (size_t)nU + (n_ell == 0 ? (size_t)ns * H * nx : 0);
  const size_t base_e = a.terminal ? ns : 0;  // soft: terminal, ellipses, box
  const size_t base_s = base_e + (size_t)ns * (H + 1) * n_ell;
  const float lm = *a.lm;

  // shared memory, in ops/glue.py::layout's order
  float* s_comb = sm;                         // H nx W
  float* s_X = s_comb + H * nx * W;           // (H + 1) nx
  float* s_cur = s_X + (H + 1) * nx;          // nx ldc
  float* s_nxt = s_cur + nx * ldc;            // nx ldc
  float* s_M = s_nxt + nx * ldc;              // nx nU: Hx Gamma_k
  float* s_A = s_M + nx * nU;                 // nx nx: A_k with the feedback
  float* s_B = s_A + nx * nx;                 // nx nu
  float* s_r = s_B + nx * nu;                 // nx
  float* s_xp = s_r + nx;                     // nx: xpred = Xbar_k + T_k
  float* s_gr = s_xp + nx;                    // nx: the cost's gradient
  float* s_J = s_gr + nx;                     // nx: terminal row's J
  float* s_c = s_J + nx;                      // 1: terminal row's constant
  // the OCP data a stage reads, staged once per CTA
  float* s_Qs = s_c + 1;                      // nx nx
  float* s_Qe = s_Qs + nx * nx;               // nx nx
  float* s_P = s_Qe + nx * nx;                // nx nx
  float* s_K = s_P + nx * nx;                 // nu nx
  float* s_xeq = s_K + nu * nx;               // nx
  float* s_xref = s_xeq + nx;                 // (H + 1) nx
  float* s_xlo = s_xref + (H + 1) * nx;       // (H + 1) nx
  float* s_xhi = s_xlo + (H + 1) * nx;        // (H + 1) nx
  float* s_fblo = s_xhi + (H + 1) * nx;       // H nu
  float* s_fbhi = s_fblo + H * nu;            // H nu
  float* s_U = s_fbhi + H * nu;               // H nu
  float* s_ell = s_U + H * nu;                // n_ell 5
  float* s_acc = s_ell + n_ell * 5;           // nU^2 + nU, narrow only
  {
    const float* src[] = {a.Qs, a.Qe, a.P, a.K, a.x_eq, a.xref, a.x_lo,
                          a.x_hi, a.fb_lo, a.fb_hi, a.U, a.ell};
    const int len[] = {nx * nx, nx * nx, nx * nx, nu * nx, nx, (H + 1) * nx,
                       (H + 1) * nx, (H + 1) * nx, H * nu, H * nu, H * nu,
                       n_ell * 5};
    float* dst = s_Qs;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      for (int e = tid; e < len[j]; e += NT) dst[e] = src[j][e];
      dst += len[j];
    }
  }
  float pen[8];
  for (int j = 0; j < 8; ++j) pen[j] = *a.pen[j];
  const float delta_sq = *a.delta_sq;

  __syncthreads();

  if (blockIdx.x == 0) {
    // the input box: selector rows, sample-independent
    for (int e = tid; e < nU * nU; e += NT) {
      const int r = e / nU, c = e - r * nU;
      const float v = r == c ? 1.f : 0.f;
      a.C_h[(size_t)r * nU + c] = v;
      a.C_h[(n_hard + r) * nU + c] = -v;
    }
    for (int r = tid; r < nU; r += NT) {
      const float ub = a.U[r];
      a.d_h[r] = a.u_hi[r % nu] - ub;
      a.d_h[n_hard + r] = -(a.u_lo[r % nu] - ub);
    }
  }

  for (int i = blockIdx.x; i < ns; i += gridDim.x) {
    float* slot = a.work + (size_t)i * slot_n;
    // wide: this sample's rows of M, one per stage and state
    float* Mi = a.work + (size_t)i * (H + 1) * nx * ldc;
    const float wi = a.w[i];
    const float* ci = a.comb + (size_t)i * H * nx * W;
    for (int e = tid; e < H * nx * W; e += NT) s_comb[e] = ci[e];
    for (int e = tid; e < (H + 1) * nx; e += NT) {
      const int k = e / nx, p = e - k * nx;
      s_X[e] = a.X[((size_t)k * ns + i) * nx + p];
    }
    for (int e = tid; e < 2 * nx * ldc; e += NT) {
      // [Gamma_0 | T_0] = [0 | x - X_0]
      const int p = e / ldc;
      s_cur[e] = (e - p * ldc == nU && p < nx)
                     ? a.st[p] - a.X[(size_t)i * nx + p] : 0.f;
    }
    if (!GRAM)
      for (size_t e = tid; e < slot_n; e += NT) s_acc[e] = 0.f;
    __syncthreads();

    float* cur = s_cur;
    float* nxt = s_nxt;
    for (int k = 0; k <= H; ++k) {
      const int kn = k * nu;  // Gamma_k's nonzero columns
      const float* Xk = s_X + k * nx;
      const float* Qk = k < H ? s_Qs : s_Qe;
      // phase 1: the stage's small vectors and M = Hx Gamma_k
      if (tid < nx) {
        const int p = tid;
        const float Tp = cur[p * ldc + nU];
        s_xp[p] = Xk[p] + Tp;
        if (k >= 1) {
          float q = 0.f;
          for (int b = 0; b < nx; ++b)
            q += Qk[p * nx + b] * ((Xk[b] + cur[b * ldc + nU]) - s_xref[k * nx + b]);
          s_gr[p] = 2.f * wi * q + lm * Tp;
        }
        if (k < H) {
          const float* row = s_comb + (k * nx + p) * W;
          s_r[p] = row[0] - s_X[(k + 1) * nx + p];
          for (int b = 0; b < nx; ++b) {
            float v = row[1 + b];
            if (a.feedback) {
              float bk = 0.f;
              for (int j = 0; j < nu; ++j) bk += row[1 + nx + j] * s_K[j * nx + b];
              v = v + bk;
            }
            s_A[p * nx + b] = v;
          }
          for (int j = 0; j < nu; ++j) s_B[p * nu + j] = row[1 + nx + j];
        }
      }
      if (k == H && a.terminal && tid == 0) {
        // (x_H - xf)' P (x_H - xf) linearized at the iterate
        float q0 = 0.f, c = 0.f;
        for (int b = 0; b < nx; ++b) {
          float jb = 0.f;
          for (int p = 0; p < nx; ++p)
            jb += (2.f * (Xk[p] - s_xeq[p])) * s_P[p * nx + b];
          s_J[b] = jb;
        }
        for (int p = 0; p < nx; ++p) {
          float t = 0.f;
          for (int b = 0; b < nx; ++b) t += s_P[p * nx + b] * (Xk[b] - s_xeq[b]);
          q0 += (Xk[p] - s_xeq[p]) * t;
        }
        for (int p = 0; p < nx; ++p) c += s_J[p] * cur[p * ldc + nU];
        s_c[0] = q0 + c;
      }
      // wide: M_k's nU columns to global, zeros past Gamma_k's kn
      for (int e = tid; e < nx * (GRAM ? nU : kn); e += NT) {
        const int w = GRAM ? nU : kn;
        const int p = e / w, c = e - p * w;
        float m = 0.f;
        if (c < kn)
          for (int b = 0; b < nx; ++b) {
            float h = 2.f * wi * Qk[p * nx + b];
            if (b == p) h += lm;
            m += h * cur[b * ldc + c];
          }
        if (GRAM)
          Mi[((size_t)k * nx + p) * ldc + c] = m;
        else
          s_M[p * nU + c] = m;
      }
      __syncthreads();

      // phase 2: Gamma_k and T_k, the stage's rows, the cost, the next carry
      float* Gk = a.Gamma + ((size_t)i * (H + 1) + k) * nx * nU;
      for (int e = tid; e < nx * nU; e += NT) {
        const int p = e / nU, c = e - p * nU;
        Gk[e] = cur[p * ldc + c];
      }
      if (tid < nx)
        a.T[((size_t)i * (H + 1) + k) * nx + tid] = cur[tid * ldc + nU];

      if (k >= 1) {
        // the state box, stages 1..H: hard without ellipses, else soft
        const size_t r0 = n_ell == 0 ? nU + ((size_t)i * H + k - 1) * nx
                                     : base_s + ((size_t)i * H + k - 1) * nx;
        float* G = n_ell == 0 ? a.C_h : a.G_s;
        for (int e = tid; e < nx * nU; e += NT) {
          const int p = e / nU, c = e - p * nU;
          const float v = cur[p * ldc + c];
          G[(r0 + p) * nU + c] = v;
          if (n_ell == 0) a.C_h[(n_hard + r0 + p) * nU + c] = -v;
        }
        if (tid < nx) {
          const float lo = s_xlo[k * nx + tid] - s_xp[tid];
          const float hi = s_xhi[k * nx + tid] - s_xp[tid];
          if (n_ell == 0) {
            a.d_h[r0 + tid] = hi;
            a.d_h[n_hard + r0 + tid] = -lo;
          } else {
            a.lo_s[r0 + tid] = lo;
            a.hi_s[r0 + tid] = hi;
            a.zl[r0 + tid] = pen[4];
            a.zu[r0 + tid] = pen[5];
            a.Zl[r0 + tid] = pen[6];
            a.Zu[r0 + tid] = pen[7];
          }
        }
      }
      if (a.feedback && k < H) {
        // realized input -K(x_eq - x) + u_k: rows K Gamma_k + selector
        const size_t r0 = base_fb + ((size_t)i * H + k) * nu;
        for (int e = tid; e < nu * nU; e += NT) {
          const int j = e / nU, c = e - j * nU;
          float v = 0.f;
          for (int p = 0; p < nx; ++p) v += s_K[j * nx + p] * cur[p * ldc + c];
          if (c == kn + j) v += 1.f;
          a.C_h[(r0 + j) * nU + c] = v;
          a.C_h[(n_hard + r0 + j) * nU + c] = -v;
        }
        if (tid < nu) {
          const int j = tid;
          float kx = 0.f;
          for (int p = 0; p < nx; ++p) kx += (s_xeq[p] - s_xp[p]) * s_K[j * nx + p];
          const float hb = s_U[k * nu + j] - kx;
          a.d_h[r0 + j] = s_fbhi[k * nu + j] - hb;
          a.d_h[n_hard + r0 + j] = -(s_fblo[k * nu + j] - hb);
        }
      }
      if (a.terminal && k == H) {
        for (int c = tid; c < nU; c += NT) {
          float v = 0.f;
          for (int p = 0; p < nx; ++p) v += s_J[p] * cur[p * ldc + c];
          a.G_s[(size_t)i * nU + c] = v;
        }
        if (tid == 0) {
          a.lo_s[i] = 0.f - s_c[0];
          a.hi_s[i] = delta_sq - s_c[0];
          a.zl[i] = pen[0];
          a.zu[i] = pen[1];
          a.Zl[i] = pen[2];
          a.Zu[i] = pen[3];
        }
      }
      if (n_ell > 0) {
        // obstacle ellipses (X - x0)^2 / a + (Y - y0)^2 / b >= f, stages 0..H
        const size_t r0 = base_e + ((size_t)i * (H + 1) + k) * n_ell;
        for (int e = tid; e < n_ell * nU; e += NT) {
          const int q = e / nU, c = e - q * nU;
          const float* el = s_ell + q * 5;
          const float px = s_xp[0] - el[0], py = s_xp[1] - el[1];
          const float jx = 2.f * px / el[2], jy = 2.f * py / el[3];
          a.G_s[(r0 + q) * nU + c] = jx * cur[c] + jy * cur[ldc + c];
          if (c == 0) {
            a.lo_s[r0 + q] = el[4] - (px * px / el[2] + py * py / el[3]);
            a.hi_s[r0 + q] = 1e8f;
            a.zl[r0 + q] = pen[4];
            a.zu[r0 + q] = pen[5];
            a.Zl[r0 + q] = pen[6];
            a.Zu[r0 + q] = pen[7];
          }
        }
      }
      if (GRAM) {
        // M's last column: the cost's gradient (none at stage 0)
        if (tid < nx) Mi[((size_t)k * nx + tid) * ldc + nU] = k >= 1 ? s_gr[tid] : 0.f;
      } else if (k >= 1) {
        // this sample's upper triangle of Gamma' Hx Gamma and Gamma' grad
        for (int u = warp; u < kn; u += NW)
          for (int v = u + lane; v < kn; v += 32) {
            float s = 0.f;
            for (int p = 0; p < nx; ++p) s += cur[p * ldc + u] * s_M[p * nU + v];
            s_acc[(size_t)u * nU + v] += s;
          }
        for (int u = tid; u < kn; u += NT) {
          float s = 0.f;
          for (int p = 0; p < nx; ++p) s += cur[p * ldc + u] * s_gr[p];
          s_acc[(size_t)nU * nU + u] += s;
        }
      }
      if (k < H) {
        // [Gamma | T]_{k+1}: its first (k + 1) nu columns and T
        const int kn1 = kn + nu;
        for (int e = tid; e < nx * (kn1 + 1); e += NT) {
          const int p = e / (kn1 + 1), c0 = e - p * (kn1 + 1);
          const int c = c0 == kn1 ? nU : c0;
          float v = 0.f;
          for (int b = 0; b < nx; ++b) v += s_A[p * nx + b] * cur[b * ldc + c];
          if (c == nU)
            v += s_r[p];
          else if (c >= kn)
            v += s_B[p * nu + c - kn];
          nxt[p * ldc + c] = v;
        }
      }
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    if (!GRAM)
      for (size_t e = tid; e < slot_n; e += NT) slot[e] = s_acc[e];
    __syncthreads();
  }
  if (GRAM) return;

  // the last CTA to arrive sums the slots in sample order
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int e = tid; e < nU * nU + nU; e += NT) {
    const int u = e < nU * nU ? e / nU : e - nU * nU;
    const int v = e < nU * nU ? e - u * nU : -1;
    if (v >= 0 && v < u) continue;
    const float* w = a.work + (v < 0 ? (size_t)nU * nU + u : (size_t)u * nU + v);
    float s = 0.f;
#pragma unroll 8
    for (int i = 0; i < ns; ++i) s += __ldcg(w + i * slot_n);
    if (v < 0) {
      if (a.with_block) {
        const int k = u / nu, j = u - k * nu;
        float q = 0.f;
        for (int l = 0; l < nu; ++l) q += (2.f * s_U[k * nu + l]) * a.Qu[l * nu + j];
        s += q;
      }
      a.g[u] = s;
    } else {
      if (a.with_block && u / nu == v / nu) {
        float hu = 2.f * a.Qu[(u % nu) * nu + v % nu];
        hu += u == v ? lm : 0.f;
        s += hu;
      }
      a.H_U[(size_t)u * nU + v] = s;
      a.H_U[(size_t)v * nU + u] = s;
    }
  }
  if (tid == 0) *a.ticket = 0;
}


// The wide branch's cost (header, 3): H_U = Gamma' M and g_U = Gamma' grad
// over the R = ns (H + 1) nx rows of Gamma (R x nU) and M (R x (nU + 1),
// grad its last column), as one product Gamma' M whose column nU is g_U.
// One CTA per TS x TS tile (bu, bv), bu <= bv, of the upper triangle;
// each thread owns four entries (four rows u, one column v) and sums the
// rows in order, TS at a time through shared memory, the next TS rows
// loaded into registers while the current ones are used.
constexpr int TS = 32;

__global__ void __launch_bounds__(NT) glue_gram_kernel(const GlueArgs a) {
  __shared__ float sG[TS][TS];
  __shared__ float sM[TS][TS];
  const int nU = a.H * a.nu, ldm = nU + 1, nu = a.nu;
  const int R = a.ns * (a.H + 1) * a.nx;
  const int ntv = (nU + TS) / TS;  // tiles over M's nU + 1 columns
  int bu = 0, rem = blockIdx.x;
  while (rem >= ntv - bu) {
    rem -= ntv - bu;
    ++bu;
  }
  const int bv = bu + rem;
  const int tid = threadIdx.x, lane = tid & 31, ug = tid >> 5;
  const int cu = bu * TS + lane, cv = bv * TS + lane;  // columns loaded
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float rg[4], rm[4];
  auto load = [&](int r0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + ug + 8 * q;
      rg[q] = r < R && cu < nU ? a.Gamma[(size_t)r * nU + cu] : 0.f;
      rm[q] = r < R && cv < ldm ? a.work[(size_t)r * ldm + cv] : 0.f;
    }
  };
  load(0);
  for (int r0 = 0; r0 < R; r0 += TS) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sG[ug + 8 * q][lane] = rg[q];
      sM[ug + 8 * q][lane] = rm[q];
    }
    __syncthreads();
    if (r0 + TS < R) load(r0 + TS);
#pragma unroll 8
    for (int r = 0; r < TS; ++r) {
      const float m = sM[r][lane];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += sG[r][ug * 4 + j] * m;
    }
    __syncthreads();
  }
  const float lm = *a.lm;
  const int v = cv;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int u = bu * TS + ug * 4 + j;
    if (u >= nU || v > nU) continue;
    float s = acc[j];
    if (v == nU) {
      if (a.with_block) {
        const int k = u / nu, jj = u - k * nu;
        float q = 0.f;
        for (int l = 0; l < nu; ++l) q += (2.f * a.U[k * nu + l]) * a.Qu[l * nu + jj];
        s += q;
      }
      a.g[u] = s;
    } else if (u <= v) {
      if (a.with_block && u / nu == v / nu) {
        float hu = 2.f * a.Qu[(u % nu) * nu + v % nu];
        hu += u == v ? lm : 0.f;
        s += hu;
      }
      a.H_U[(size_t)u * nU + v] = s;
      a.H_U[(size_t)v * nU + u] = s;
    }
  }
}


// The SQP step's consumption (ocp/sqp.py::consume_step), from the QP's
// solution to the next iterate and scalars, in one launch.  Replaces no
// Pallas TPU kernel: the JAX package leaves the step to XLA's fusion.  In
// the port it ran as ~57 small torch ops an SQP iteration (the candidate
// X + (T + Gamma dU)', two pairs of norms, the stall / recover rules of the
// under-relaxation, the selections under the QP's status), each a launch
// the host issued while the card idled; consume_step stays as its plain
// version (the CPU and a sample-axis group take it).
//
// What bounds it on the H100: latency.  It reads Gamma once (~170 KB at
// the 1D pendulum's shape, 154 KB in the car, most of it still in L2 from
// glue_condense_kernel) and writes the iterate (~10 KB), but no element of
// the new iterate can be chosen before the two norms over all of dX are
// summed.  So one CTA of ADV_NT threads:
//   1. the state's scalars are loaded first; each thread forms the
//      candidate of its rows straight from global memory: the row's dot
//      with dU (the same dU entry in every lane at a time: one broadcast
//      load), then T + it, then X + that, each rounded as torch rounds them
//      (__f*_rn: nvcc contracts nothing); it writes the candidate to the
//      output, which doubles as the workspace, and adds its squares of dX =
//      X_cand - X and of X over the first H stages, and of dU and U, to
//      four float32 sums;
//   2. a fixed tree (warp shuffles, then one warp over the warps' sums)
//      reduces them: the same bits every launch, no atomics;
//   3. every thread applies the stall / recover rules to the sums, and
//      where the step is not taken whole (alpha < 1) or the QP failed
//      rewrites the iterate: X + alpha dX, or X itself.  Thread 0 writes
//      the scalars.
// The inputs are never written: the caller keeps the entering iterate.
constexpr int ADV_NT = 1024;

struct AdvanceArgs {
  const float* X;      // (H + 1, ns, nx) the iterate entering the iteration
  const float* U;      // (H, nu)
  const float* T;      // (ns, H + 1, nx)
  const float* Gamma;  // (ns, H + 1, nx, nU)
  const float* z;      // (nU,) the QP's step dU
  const long long* status;  // () the QP's status, 0 = solved
  const void* iters;        // () the QP's iterations, int32 or int64
  const float* best_step;   // () the state's scalars
  const int* stall_count;
  const int* mono_count;
  const float* alpha;
  const void* qp_iters;     // () int32 or int64
  // outputs
  float* X_out;
  float* U_out;
  float* x_diff;
  float* u_diff;
  unsigned char* done;
  float* best_out;
  int* stall_out;
  int* mono_out;
  float* alpha_out;
  unsigned char* valid;
  void* qp_iters_out;  // int64 where either input is
  int ns, H, nx, nu;
  int stall_window, recover_window;
  int iters64, qp_iters64;
  float tol, shrink, min_alpha;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long read_int(const void* p, int wide) {
  return wide ? *(const long long*)p : (long long)*(const int*)p;
}

__global__ void __launch_bounds__(ADV_NT) glue_advance_kernel(const AdvanceArgs a) {
  __shared__ float s_part[4][ADV_NT / 32];
  __shared__ float s_sum[4];
  const int ns = a.ns, H = a.H, nx = a.nx, nU = a.H * a.nu;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = (H + 1) * ns * nx;
  // the state's scalars, loaded first: their latency hides behind 1
  const float best = *a.best_step, alpha = *a.alpha;
  const bool ok = *a.status == 0;
  const int stall_in = *a.stall_count, mono_in = *a.mono_count;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // |dX|^2, |X|^2, |dU|^2, |U|^2

  // 1. the candidate, written to the outputs
  for (int e = tid; e < nU; e += ADV_NT) {
    const float u = a.U[e];
    const float uc = __fadd_rn(u, a.z[e]);
    a.U_out[e] = uc;
    const float du = __fsub_rn(uc, u);
    acc[2] = fmaf(du, du, acc[2]);
    acc[3] = fmaf(u, u, acc[3]);
  }
  for (int row = tid; row < rows; row += ADV_NT) {  // (i, k, p) in Gamma's order
    const int ik = row / nx, p = row - ik * nx;
    const int i = ik / (H + 1), k = ik - i * (H + 1);
    const int e = (k * ns + i) * nx + p;  // X's (k, i, p)
    const float x = a.X[e], t = a.T[row];
    const float* g = a.Gamma + (size_t)row * nU;
    float d = 0.f;
#pragma unroll 8
    for (int u = 0; u < nU; ++u) d = fmaf(g[u], a.z[u], d);
    const float xc = __fadd_rn(x, __fadd_rn(t, d));
    a.X_out[e] = xc;
    if (k < H) {
      const float dx = __fsub_rn(xc, x);
      acc[0] = fmaf(dx, dx, acc[0]);
      acc[1] = fmaf(x, x, acc[1]);
    }
  }

  // 2. the four sums, in a fixed order
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float v = warp_sum(acc[j]);
    if (lane == 0) s_part[j][warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = warp_sum(s_part[j][lane]);
      if (lane == 0) s_sum[j] = v;
    }
  }
  __syncthreads();

  // 3. consume_step's rules on the sums, then the iterate chosen
  const float x_diff = __fdiv_rn(__fsqrt_rn(s_sum[0]),
                                 __fadd_rn(__fsqrt_rn(s_sum[1]), 1e-6f));
  const float u_diff = __fdiv_rn(__fsqrt_rn(s_sum[2]),
                                 __fadd_rn(__fsqrt_rn(s_sum[3]), 1e-6f));
  const float sn = __fadd_rn(x_diff, u_diff);
  const bool improved = sn < __fmul_rn(a.shrink, best);
  int count = improved ? 0 : stall_in + 1;
  const bool engage = count >= a.stall_window && sn >= best;
  int mono = sn < best ? mono_in + 1 : 0;
  const bool recover = !engage && mono >= a.recover_window && alpha < 1.f;
  const float alpha_new =
      engage ? fmaxf(__fmul_rn(alpha, 0.5f), a.min_alpha)
             : (recover ? fminf(__fmul_rn(alpha, 2.f), 1.f) : alpha);
  if (engage) count = 0;
  if (engage || recover) mono = 0;
  if (!ok || alpha_new != 1.f) {
    // the candidate back (2's barriers made every thread's writes seen)
    for (int e = tid; e < rows; e += ADV_NT) {
      const float x = a.X[e];
      a.X_out[e] = ok ? __fadd_rn(x, __fmul_rn(alpha_new, __fsub_rn(a.X_out[e], x))) : x;
    }
    for (int e = tid; e < nU; e += ADV_NT) {
      const float u = a.U[e];
      a.U_out[e] = ok ? __fadd_rn(u, __fmul_rn(alpha_new, __fsub_rn(a.U_out[e], u))) : u;
    }
  }
  if (tid == 0) {
    *a.x_diff = x_diff;
    *a.u_diff = u_diff;
    *a.done = x_diff < a.tol && u_diff < a.tol;
    // torch.minimum: NaN if either is
    const float lo = (sn != sn || best != best) ? __fadd_rn(sn, best) : fminf(best, sn);
    *a.best_out = ok ? lo : best;
    *a.stall_out = ok ? count : stall_in;
    *a.mono_out = ok ? mono : mono_in;
    *a.alpha_out = ok ? alpha_new : alpha;
    *a.valid = ok;
    const long long n = read_int(a.qp_iters, a.qp_iters64) + read_int(a.iters, a.iters64);
    if (a.iters64 || a.qp_iters64)
      *(long long*)a.qp_iters_out = n;
    else
      *(int*)a.qp_iters_out = (int)n;
  }
}

}  // namespace

// ptrs: AdvanceArgs' 12 inputs and 11 outputs in order; dims: ns, H, nx, nu,
// stall_window, recover_window, iters64, qp_iters64, the CUDA device; fargs:
// tol, shrink, min_alpha.  One launch on the stream, on its device.
extern "C" int glue_advance(void* const* ptrs, const int* dims,
                            const float* fargs, void* stream) {
  AdvanceArgs a;
  a.X = (const float*)ptrs[0];
  a.U = (const float*)ptrs[1];
  a.T = (const float*)ptrs[2];
  a.Gamma = (const float*)ptrs[3];
  a.z = (const float*)ptrs[4];
  a.status = (const long long*)ptrs[5];
  a.iters = ptrs[6];
  a.best_step = (const float*)ptrs[7];
  a.stall_count = (const int*)ptrs[8];
  a.mono_count = (const int*)ptrs[9];
  a.alpha = (const float*)ptrs[10];
  a.qp_iters = ptrs[11];
  a.X_out = (float*)ptrs[12];
  a.U_out = (float*)ptrs[13];
  a.x_diff = (float*)ptrs[14];
  a.u_diff = (float*)ptrs[15];
  a.done = (unsigned char*)ptrs[16];
  a.best_out = (float*)ptrs[17];
  a.stall_out = (int*)ptrs[18];
  a.mono_out = (int*)ptrs[19];
  a.alpha_out = (float*)ptrs[20];
  a.valid = (unsigned char*)ptrs[21];
  a.qp_iters_out = ptrs[22];
  a.ns = dims[0];
  a.H = dims[1];
  a.nx = dims[2];
  a.nu = dims[3];
  a.stall_window = dims[4];
  a.recover_window = dims[5];
  a.iters64 = dims[6];
  a.qp_iters64 = dims[7];
  a.tol = fargs[0];
  a.shrink = fargs[1];
  a.min_alpha = fargs[2];
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return (int)err;
  if (cur != dims[8] && (err = cudaSetDevice(dims[8])) != cudaSuccess)
    return (int)err;
  glue_advance_kernel<<<1, ADV_NT, 0, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (cur != dims[8]) cudaSetDevice(cur);
  return (int)err;
}

// ptrs: GlueArgs' 21 inputs in order, its 8 penalties, its 14 outputs (the
// workspace last) and the ticket; dims: ns, H, nx, nu, n_ell, feedback, terminal,
// with_block, gram, grid, smem_bytes, gram_grid.  The wide branch (gram)
// launches glue_gram_kernel after the condensing, on the same stream.
extern "C" int glue_condense(void* const* ptrs, const int* dims, void* stream) {
  GlueArgs a;
  const float** in[] = {&a.comb, &a.X, &a.U, &a.st, &a.Qs, &a.Qe, &a.Qu,
                        &a.xref, &a.w, &a.lm, &a.u_lo, &a.u_hi, &a.x_lo,
                        &a.x_hi, &a.fb_lo, &a.fb_hi, &a.K, &a.x_eq, &a.P,
                        &a.delta_sq, &a.ell};
  int n = 0;
  for (const float** p : in) *p = (const float*)ptrs[n++];
  for (int j = 0; j < 8; ++j) a.pen[j] = (const float*)ptrs[n++];
  float** out[] = {&a.H_U, &a.g, &a.C_h, &a.d_h, &a.G_s, &a.lo_s, &a.hi_s,
                   &a.zl, &a.zu, &a.Zl, &a.Zu, &a.T, &a.Gamma, &a.work};
  for (float** p : out) *p = (float*)ptrs[n++];
  a.ticket = (int*)ptrs[n++];
  a.ns = dims[0];
  a.H = dims[1];
  a.nx = dims[2];
  a.nu = dims[3];
  a.n_ell = dims[4];
  a.feedback = dims[5];
  a.terminal = dims[6];
  a.with_block = dims[7];
  const int gram = dims[8], grid = dims[9], smem = dims[10];
  auto kernel = gram ? glue_condense_kernel<true> : glue_condense_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(a);
  if (gram) glue_gram_kernel<<<dims[11], NT, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
