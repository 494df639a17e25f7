// Fused L-BFGS equation-discovery sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel symmetry_ode_discovery_tpu/ops/pallas_lbfgs.py::_kernel
// (launched by pallas_lbfgs_sweep). Each lane is one (dataset, seed) run of the
// whole discovery protocol: 100 epochs of torch-style fixed-lr L-BFGS (at most
// 20 iterations each) with the inner-loop stall breaks, convergence-triggered
// sequential thresholding, optimizer resets and the NaN stop. The loss is the
// normal-equation quadratic form
//     mse  = (sum_i Xm_i S Xm_i^T - 2 <Xm, B> + q) / (N d),  Xm = Xi * mask
//     loss = w_x * mse + w_reg * |theta|_1,   vec(Xi) = Mmap theta (row-major)
// so a lane's whole state is a few KB: S (p x p), B, Mmap, theta and the
// curvature history.
//
// What bounds it on this card: latency, not bytes or FLOPs. A lane is a chain
// of up to 100 x 20 dependent iterations, each a handful of tiny matvecs and
// 2 + 2*hist_len warp-wide reductions (two per history pair in the two-loop
// recursion); it reads a few KB once and does ~10 kFLOP per iteration.
//
// Design: one warp per lane, up to LPC lanes per CTA (Mmap staged once per
// CTA, the only __syncthreads, before the iterations). Thread t of a warp
// owns parameters and vec(Xi) entries t + 32 j, j < NJ (NJ by template from
// the width, up to 128). Everything a lane touches stays in its warp's
// shared memory for the kernel's life; the matvec exchanges go through it
// under __syncwarp. The curvature history is a ring: the two-loop walks it
// from a head index, and an append when full overwrites the oldest pair.
// Alphas, and the epoch-end thetas, live in the warp's shared memory. The
// inner loop is left as soon as
// the lane freezes for the epoch (the TPU kernel runs all 20 iterations
// masked). The two-loop takes two pairs an iteration in ping-pong
// registers, the next pair read while this one's reduction runs.
//
// Reductions keep the first CUDA design's trees (one 128-thread block per
// lane): per slice of 32 a 5-level xor butterfly, then the four slices as
// (a + b) + (c + e), max for the max entries (NaN-propagating, as jnp.max).
// The butterfly's levels 16-8-4 are gathered from 7 lanes by independent
// shuffles and 2-1 from 3, so a reduction costs two shuffle latencies on the
// chain, not five. Slices past the width are +0 here; there they were the
// butterflies of pad threads, -0 in two sums (y.s and g.d) whose sign of
// zero reaches no output. The loss sums and the break tests' sums form one
// 8-value reduction, taken once the gradient is known. So theta, mask and
// stop epoch keep their bits.
//
// Numerics: f32 throughout, IEEE division and square root, no FMA contraction
// (build with --fmad=false, never --use_fast_math): the one-ulp loss-change
// test and the ys > 1e-10 guard depend on per-operation rounding.

#include <cuda_runtime.h>

#define MAX_W 128     // max parameters and max d*p
#define MAX_HIST 64
#define LPC 4         // lanes (warps) per CTA, at most
#define SMEM_MAX 232448

struct SweepCfg {
  int d, p, n, nv, epochs, inner, hist, st_freq, n_beta, use_l1;
  float lr, w_x, w_reg, thr, tol;
};

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// One level group of the 32-wide xor butterfly: levels STEP * 2^(R-1) down
// to STEP. The thread gathers the values of threads t ^ (STEP d), d < 2^R, by
// independent shuffles (one shuffle's latency, not R) and combines them as
// the butterfly does, its own value first (max entries are not commutative
// in the sign of zero or a NaN's payload).
template <int R, int STEP, bool MAX>
__device__ __forceinline__ float gather_levels(float v) {
  float x[1 << R];
  x[0] = v;
#pragma unroll
  for (int d = 1; d < (1 << R); ++d) x[d] = __shfl_xor_sync(0xffffffffu, v, STEP * d);
#pragma unroll
  for (int off = (1 << R) / 2; off >= 1; off >>= 1) {
#pragma unroll
    for (int d = 0; d < off; ++d) x[d] = MAX ? nan_max(x[d], x[d + off]) : x[d] + x[d + off];
  }
  return x[0];
}

// Warp reduction of K values, each over the NJ slices a thread holds: bit k
// of MAXMASK selects max (NaN-propagating) instead of sum. v[k][j] is the
// thread's leaf of slice j; out[k] the result, the same in every thread. Per
// slice the 5-level butterfly's order (levels 16-8-4 gathered from 7 lanes,
// then 2-1 from 3), then the slices as (a + b) + (c + e).
template <int K, int NJ, unsigned MAXMASK>
__device__ __forceinline__ void warp_reduce(const float (&v)[K][NJ], float (&out)[K]) {
  float b[K][4];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < NJ) {
        const bool mx = (MAXMASK >> k) & 1u;
        b[k][j] = mx ? gather_levels<2, 1, true>(gather_levels<3, 4, true>(v[k][j % NJ]))
                     : gather_levels<2, 1, false>(gather_levels<3, 4, false>(v[k][j % NJ]));
      } else {
        b[k][j] = 0.f;  // a slice past the width
      }
    }
#pragma unroll
  for (int k = 0; k < K; ++k)
    out[k] = ((MAXMASK >> k) & 1u) ? nan_max(nan_max(b[k][0], b[k][1]), nan_max(b[k][2], b[k][3]))
                                   : (b[k][0] + b[k][1]) + (b[k][2] + b[k][3]);
}

// One-value reduction (a sum), as warp_reduce<1, NJ, 0>.
template <int NJ>
__device__ __forceinline__ float warp_sum(const float (&leaf)[NJ]) {
  float v[1][NJ], out[1];
#pragma unroll
  for (int j = 0; j < NJ; ++j) v[0][j] = leaf[j];
  warp_reduce<1, NJ, 0u>(v, out);
  return out[0];
}

// The history pair and weight in slot idx, the thread's columns.
template <int NJ>
__device__ __forceinline__ void load_pair(const float* sh, const float* yh, const float* rho,
                                          int idx, const int (&e)[NJ], float (&s)[NJ],
                                          float (&y)[NJ], float& r) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    s[j] = sh[idx * 32 * NJ + e[j]];
    y[j] = yh[idx * 32 * NJ + e[j]];
  }
  r = rho[idx];
}

// First-loop step at chronological position k: a = rho (s . q), q -= a y.
template <int NJ>
__device__ __forceinline__ void step_down(int k, const float (&s)[NJ], const float (&y)[NJ],
                                          float rho_k, float (&q)[NJ], const bool (&pv)[NJ],
                                          float* al, int t) {
  float leaf[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) leaf[j] = pv[j] ? s[j] * q[j] : 0.f;
  const float a = rho_k * warp_sum<NJ>(leaf);
  if (t == 0) al[k] = a;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (pv[j]) q[j] = q[j] - a * y[j];
}

// Second-loop step: beta = rho (y . r), r += s (alpha - beta).
template <int NJ>
__device__ __forceinline__ void step_up(const float (&s)[NJ], const float (&y)[NJ], float rho_k,
                                        float alpha, float (&r)[NJ], const bool (&pv)[NJ]) {
  float leaf[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) leaf[j] = pv[j] ? y[j] * r[j] : 0.f;
  const float beta = rho_k * warp_sum<NJ>(leaf);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (pv[j]) r[j] = r[j] + s[j] * (alpha - beta);
}

// xv[j] = (Mmap theta)[e_j], summed over parameters in order; theta goes
// through the warp's th_s.
template <int NJ>
__device__ __forceinline__ void vec_of_theta(float (&xv)[NJ], const float (&theta)[NJ],
                                             const int (&e)[NJ], const bool (&vv)[NJ],
                                             float* th_s, const float* Mm, int n, int ms) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) th_s[e[j]] = theta[j];
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NJ; ++j) xv[j] = 0.f;
  for (int i = 0; i < n; ++i) {
    const float th = th_s[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (vv[j]) xv[j] = xv[j] + Mm[e[j] * ms + i] * th;
  }
}

// Floats of one lane's shared region.
__host__ __device__ inline int lane_floats(int p, int m, int np) {
  return p * p + 2 * m * np + 2 * m + 5 * np;
}

template <int NJ>
__global__ void __launch_bounds__(32 * LPC)
lbfgs_sweep_kernel(SweepCfg c, int lanes, const float* __restrict__ S_g,
                   const float* __restrict__ B_g, const float* __restrict__ q_g,
                   const float* __restrict__ ne_g, const float* __restrict__ theta0_g,
                   const float* __restrict__ mmap_g, float* __restrict__ theta_out,
                   float* __restrict__ mask_out, int* __restrict__ stop_out,
                   int* __restrict__ work_out) {
  constexpr int NP = 32 * NJ;
  const float TOL_GRAD = 1e-7f;    // torch LBFGS tolerance_grad
  const float TOL_CHANGE = 1e-9f;  // torch LBFGS tolerance_change
  const float ULP = 1.1920928955078125e-07f;  // 2^-23

  extern __shared__ float smem[];
  const int n = c.n, nv = c.nv, p = c.p, m = c.hist;
  const int ms = n + 1;  // Mmap's row stride: odd, so rows and columns read without conflicts
  float* Mm = smem;  // (nv, n), row stride ms, shared by the CTA's lanes
  for (int i = threadIdx.x; i < nv * n; i += blockDim.x) Mm[(i / n) * ms + i % n] = mmap_g[i];
  __syncthreads();  // the only block barrier

  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int lane = blockIdx.x * (blockDim.x >> 5) + w;
  if (lane >= lanes) return;
  float* Ss = Mm + nv * ms + w * lane_floats(p, m, NP);  // (p, p)
  float* sh = Ss + p * p;        // (m, NP) curvature pairs s, column e owned by its thread
  float* yh = sh + m * NP;       // (m, NP) curvature pairs y
  float* rho = yh + m * NP;      // (m)
  float* al = rho + m;           // (m) alphas, by chronological position
  float* th_s = al + m;          // (NP) theta, for the matvec
  float* xm_s = th_s + NP;       // (NP) masked vec(Xi)
  float* gv_s = xm_s + NP;       // (NP) gradient w.r.t. vec(Xi)
  // (NP) theta at the last epoch end and at the last thresholding after a
  // converged epoch, read once an epoch: kept here, not in registers that
  // the division and square-root subroutines would have to save
  float* prev = gv_s + NP;
  float* pprev = prev + NP;

  for (int i = t; i < p * p; i += 32) Ss[i] = S_g[(size_t)lane * p * p + i];
  for (int i = t; i < 2 * m * NP; i += 32) sh[i] = 0.f;
  for (int i = t; i < m; i += 32) rho[i] = 0.f;

  int e[NJ], bi[NJ], br[NJ];
  bool pv[NJ], vv[NJ];
  float Bt[NJ], theta[NJ], maskv[NJ], prev_g[NJ], d_dir[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    e[j] = t + 32 * j;
    pv[j] = e[j] < n;   // thread owns a parameter
    vv[j] = e[j] < nv;  // thread owns a vec(Xi) entry
    bi[j] = vv[j] ? e[j] / p : 0;
    br[j] = vv[j] ? e[j] % p : 0;
    Bt[j] = vv[j] ? B_g[(size_t)lane * nv + e[j]] : 0.f;
    theta[j] = pv[j] ? theta0_g[(size_t)lane * n + e[j]] : 0.f;
    maskv[j] = vv[j] ? 1.f : 0.f;
    prev[e[j]] = pprev[e[j]] = theta[j];
    prev_g[j] = d_dir[j] = 0.f;
  }
  const float qv = q_g[lane];
  const float inv_nd = 1.0f / ne_g[lane];
  const float gscale = (2.0f * c.w_x) * inv_nd;

  float prev_loss = 1e30f, H = 1.f;
  int hist_len = 0, head = 0, n_iter = 0, since_thresh = 0, stop = c.epochs;
  int evals = 0, slots = 0;
  __syncwarp();

  for (int ep = 0; ep < c.epochs; ++ep) {
    for (int i = 0; i < c.inner; ++i) {
      // ---- loss and gradient ----
      float xv[NJ], xm[NJ], Sx[NJ], g[NJ], y[NJ];
      vec_of_theta<NJ>(xv, theta, e, vv, th_s, Mm, n, ms);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        xm[j] = xv[j] * maskv[j];
        xm_s[e[j]] = xm[j];
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        Sx[j] = 0.f;
        if (vv[j])
          for (int k = 0; k < p; ++k) Sx[j] = Sx[j] + xm_s[bi[j] * p + k] * Ss[k * p + br[j]];
        gv_s[e[j]] = gscale * (Sx[j] - Bt[j]) * maskv[j];
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NJ; ++j) g[j] = 0.f;
      for (int v = 0; v < nv; ++v) {
        const float gv = gv_s[v];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (pv[j]) g[j] = g[j] + gv * Mm[v * ms + e[j]];
      }
      if (c.use_l1) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (pv[j]) g[j] = g[j] + c.w_reg * sign_of(theta[j]);
      }
      ++evals;

      // ---- loss sums, torch break conditions, curvature terms: one reduction ----
      float r8[8][NJ], s8[8];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        y[j] = g[j] - prev_g[j];
        r8[0][j] = fabsf(g[j]);
        r8[1][j] = fabsf(d_dir[j]);
        r8[2][j] = xm[j] * Sx[j];
        r8[3][j] = xm[j] * Bt[j];
        r8[4][j] = pv[j] ? fabsf(theta[j]) : 0.f;
        r8[5][j] = y[j] * d_dir[j];
        r8[6][j] = y[j] * y[j];
        r8[7][j] = fabsf(g[j]);
      }
      warp_reduce<8, NJ, 3u>(r8, s8);
      float loss = c.w_x * ((s8[2] - 2.0f * s8[3] + qv) * inv_nd);
      if (c.use_l1) loss = loss + c.w_reg * s8[4];
      const float ys = s8[5], yy = s8[6], g1 = s8[7];
      const bool opt_cond = s8[0] <= TOL_GRAD;
      const bool step_small = s8[1] <= TOL_CHANGE;
      const bool loss_small =
          fabsf(loss - prev_loss) < nan_max(TOL_CHANGE, fabsf(loss) * ULP);
      // a lane frozen for the epoch stays unchanged until the epoch ends
      if (opt_cond || (i > 0 && (step_small || loss_small))) break;

      const bool is_first = n_iter == 0;
      if (!is_first && ys > 1e-10f) {
        // append (s, y): the next free slot, or over the oldest pair when full
        int pos = head;
        if (hist_len < m) {
          pos = head + hist_len < m ? head + hist_len : head + hist_len - m;
          ++hist_len;
        } else {
          head = head + 1 < m ? head + 1 : 0;
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (pv[j]) {
            sh[pos * NP + e[j]] = d_dir[j];
            yh[pos * NP + e[j]] = y[j];
          }
        if (t == 0) rho[pos] = (ys != 0.f) ? 1.0f / ys : 0.f;
        H = (yy > 0.f) ? ys / yy : 1.f;
        __syncwarp();  // rho
      }

      // ---- direction: steepest descent after a reset, else two-loop ----
      float dir[NJ];
      float step;
      if (is_first) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) dir[j] = -g[j];
        step = nan_min(1.f, 1.f / nan_max(g1, 1e-30f)) * c.lr;
      } else {
        // newest -> oldest, then oldest -> newest; the pair of chronological
        // position k sits in slot head + k (mod m). Two positions an
        // iteration in ping-pong registers: the next pair is read while this
        // one's reduction runs.
        float r[NJ], sa[NJ], ya[NJ], sb[NJ], yb[NJ], ra, rb;
#pragma unroll
        for (int j = 0; j < NJ; ++j) r[j] = -g[j];
        if (hist_len > 0) {
          int k = hist_len - 1, idx = head + k < m ? head + k : head + k - m;
          load_pair<NJ>(sh, yh, rho, idx, e, sa, ya, ra);
          for (;; k -= 2) {
            if (k == 0) {
              step_down<NJ>(0, sa, ya, ra, r, pv, al, t);
              break;
            }
            idx = idx == 0 ? m - 1 : idx - 1;
            load_pair<NJ>(sh, yh, rho, idx, e, sb, yb, rb);
            step_down<NJ>(k, sa, ya, ra, r, pv, al, t);
            if (k == 1) {
              step_down<NJ>(0, sb, yb, rb, r, pv, al, t);
              break;
            }
            idx = idx == 0 ? m - 1 : idx - 1;
            load_pair<NJ>(sh, yh, rho, idx, e, sa, ya, ra);
            step_down<NJ>(k - 1, sb, yb, rb, r, pv, al, t);
          }
        }
        __syncwarp();  // alphas
#pragma unroll
        for (int j = 0; j < NJ; ++j) r[j] = r[j] * H;
        if (hist_len > 0) {
          int idx = head;
          float aa = al[0], ab;
          load_pair<NJ>(sh, yh, rho, idx, e, sa, ya, ra);
          for (int k = 0;; k += 2) {
            if (k == hist_len - 1) {
              step_up<NJ>(sa, ya, ra, aa, r, pv);
              break;
            }
            idx = idx + 1 < m ? idx + 1 : 0;
            load_pair<NJ>(sh, yh, rho, idx, e, sb, yb, rb);
            ab = al[k + 1];
            step_up<NJ>(sa, ya, ra, aa, r, pv);
            if (k + 1 == hist_len - 1) {
              step_up<NJ>(sb, yb, rb, ab, r, pv);
              break;
            }
            idx = idx + 1 < m ? idx + 1 : 0;
            load_pair<NJ>(sh, yh, rho, idx, e, sa, ya, ra);
            aa = al[k + 2];
            step_up<NJ>(sb, yb, rb, ab, r, pv);
          }
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) dir[j] = r[j];
        step = c.lr;
        slots += hist_len;
      }
      float gtd_leaf[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) gtd_leaf[j] = g[j] * dir[j];
      const bool gtd_break = warp_sum<NJ>(gtd_leaf) > -TOL_CHANGE;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        d_dir[j] = dir[j] * step;
        if (!gtd_break) theta[j] = theta[j] + d_dir[j];
        prev_g[j] = g[j];
      }
      prev_loss = loss;
      ++n_iter;
      if (gtd_break) break;  // torch breaks without stepping; updates stand
    }

    // ---- epoch end: convergence, NaN stop, thresholding ----
    float r5[5][NJ], s5[5];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float dd1 = theta[j] - prev[e[j]], dd2 = theta[j] - pprev[e[j]];
      const bool in_beta = c.n_beta < 0 || e[j] < c.n_beta;
      r5[0][j] = (pv[j] && in_beta) ? dd1 * dd1 : 0.f;
      r5[1][j] = (pv[j] && !in_beta) ? dd1 * dd1 : 0.f;
      r5[2][j] = (pv[j] && in_beta) ? dd2 * dd2 : 0.f;
      r5[3][j] = (pv[j] && !in_beta) ? dd2 * dd2 : 0.f;
      r5[4][j] = (theta[j] != theta[j]) ? 1.f : 0.f;
    }
    warp_reduce<5, NJ, 0u>(r5, s5);
    const float delta = c.n_beta < 0 ? sqrtf(s5[0]) : sqrtf(s5[0]) + sqrtf(s5[1]);
    const float delta2 = c.n_beta < 0 ? sqrtf(s5[2]) : sqrtf(s5[2]) + sqrtf(s5[3]);
    const bool nan = s5[4] > 0.f;
    const bool conv = delta < c.tol;
    const bool final_conv = conv && delta2 < c.tol;
    ++since_thresh;
    const bool st_hit = c.st_freq > 0 && since_thresh % c.st_freq == 0;
    if (!nan && !final_conv && (conv || st_hit)) {
      float xv[NJ];
      vec_of_theta<NJ>(xv, theta, e, vv, th_s, Mm, n, ms);
      __syncwarp();  // th_s is read before the next write
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (!(fabsf(xv[j]) > c.thr)) maskv[j] = 0.f;
        prev_g[j] = 0.f;
        d_dir[j] = 0.f;
        if (conv) pprev[e[j]] = theta[j];
      }
      hist_len = 0;
      head = 0;
      n_iter = 0;
      H = 1.f;
      since_thresh = 0;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) prev[e[j]] = theta[j];
    if (final_conv || nan) {
      stop = ep;
      break;
    }
  }

#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (pv[j]) theta_out[(size_t)lane * n + e[j]] = theta[j];
    if (vv[j]) mask_out[(size_t)lane * nv + e[j]] = maskv[j];
  }
  if (t == 0) {
    stop_out[lane] = stop;
    if (work_out) {
      work_out[2 * lane] = evals;
      work_out[2 * lane + 1] = slots;
    }
  }
}

template <int NJ>
static int launch(const SweepCfg& c, int lanes, size_t mm_floats, const void* S, const void* B,
                  const void* q, const void* n_elems, const void* theta0, const void* mmap,
                  void* theta_out, void* mask_out, void* stop_out, void* work_out,
                  cudaStream_t stream) {
  const size_t per_lane = (size_t)lane_floats(c.p, c.hist, 32 * NJ);
  int lpc = lanes < LPC ? lanes : LPC;
  while (lpc > 1 && sizeof(float) * (mm_floats + lpc * per_lane) > SMEM_MAX) --lpc;
  const size_t smem = sizeof(float) * (mm_floats + lpc * per_lane);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(lbfgs_sweep_kernel<NJ>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  lbfgs_sweep_kernel<NJ><<<(lanes + lpc - 1) / lpc, 32 * lpc, smem, stream>>>(
      c, lanes, (const float*)S, (const float*)B, (const float*)q, (const float*)n_elems,
      (const float*)theta0, (const float*)mmap, (float*)theta_out, (float*)mask_out,
      (int*)stop_out, (int*)work_out);
  return (int)cudaGetLastError();
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// work_out may be null; otherwise it receives, per lane, the number of loss
// and gradient evaluations and of history pairs visited by the two-loop.
extern "C" int lbfgs_sweep_launch(const void* S, const void* B, const void* q,
                                  const void* n_elems, const void* theta0, const void* mmap,
                                  void* theta_out, void* mask_out, void* stop_out,
                                  void* work_out, int lanes, int d, int p, int n,
                                  int epochs, int inner, int hist, int st_freq, int n_beta,
                                  int use_l1, float lr, float w_x, float w_reg, float thr,
                                  float tol, void* stream) {
  const int nv = d * p;
  if (lanes < 1 || n < 1 || n > MAX_W || nv < 1 || nv > MAX_W || hist < 1 || hist > MAX_HIST)
    return (int)cudaErrorInvalidValue;
  SweepCfg c{d, p, n, nv, epochs, inner, hist, st_freq, n_beta, use_l1, lr, w_x, w_reg, thr, tol};
  const size_t mm_floats = (size_t)nv * (n + 1);
  const int width = n > nv ? n : nv;
  cudaStream_t st = (cudaStream_t)stream;
#define K1_ARGS c, lanes, mm_floats, S, B, q, n_elems, theta0, mmap, theta_out, mask_out, \
                stop_out, work_out, st
  if (width <= 32) return launch<1>(K1_ARGS);
  if (width <= 64) return launch<2>(K1_ARGS);
  if (width <= 96) return launch<3>(K1_ARGS);
  return launch<4>(K1_ARGS);
#undef K1_ARGS
}
