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
// ~10 + 2*hist_len block-wide reductions (two per history pair in the
// two-loop recursion); it reads a few KB once and does ~10 kFLOP per
// iteration. Design: one 128-thread block per lane (thread t owns parameter t
// and vec(Xi) entry t), everything the lane touches kept in shared memory for
// the kernel's life, reductions as warp shuffles plus a 4-slot shared array
// (one __syncthreads each, double-buffered), and the inner loop left as soon
// as the lane freezes for the epoch (the TPU kernel runs all 20 iterations
// masked). Lanes run in parallel across the 132 SMs, several blocks per SM.
// Still to do for speed: several lanes per block or a warp per lane (fewer
// barriers), and batching the dependent reductions.
//
// Numerics: f32 throughout, IEEE division and square root, no FMA contraction
// (build with --fmad=false, never --use_fast_math): the one-ulp loss-change
// test and the ys > 1e-10 guard depend on per-operation rounding. Max
// reductions propagate NaN, as jnp.max does.

#include <cuda_runtime.h>

#define NT 128         // threads per block = max parameters = max d*p
#define NWARP (NT / 32)
#define MAX_HIST 64
#define RED_SLOTS 8    // values per combined reduction

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

// Block-wide reduction of K values at once: bit k of MAXMASK selects max
// (NaN-propagating) instead of sum. Every thread gets the same result.
template <int K, unsigned MAXMASK>
__device__ __forceinline__ void block_reduce(float (&v)[K], float* red, int& buf) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float o = __shfl_xor_sync(0xffffffffu, v[k], off);
      v[k] = ((MAXMASK >> k) & 1u) ? nan_max(v[k], o) : v[k] + o;
    }
  }
  float* r = red + buf * (NWARP * RED_SLOTS);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) r[warp * RED_SLOTS + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float a = r[k], b = r[RED_SLOTS + k];
    const float c = r[2 * RED_SLOTS + k], e = r[3 * RED_SLOTS + k];
    v[k] = ((MAXMASK >> k) & 1u) ? nan_max(nan_max(a, b), nan_max(c, e))
                                 : (a + b) + (c + e);
  }
  buf ^= 1;  // the next reduction writes the other buffer: no second barrier
}

__global__ void __launch_bounds__(NT)
lbfgs_sweep_kernel(SweepCfg c, const float* __restrict__ S_g, const float* __restrict__ B_g,
                   const float* __restrict__ q_g, const float* __restrict__ ne_g,
                   const float* __restrict__ theta0_g, const float* __restrict__ mmap_g,
                   float* __restrict__ theta_out, float* __restrict__ mask_out,
                   int* __restrict__ stop_out, int* __restrict__ work_out) {
  const float TOL_GRAD = 1e-7f;    // torch LBFGS tolerance_grad
  const float TOL_CHANGE = 1e-9f;  // torch LBFGS tolerance_change
  const float ULP = 1.1920928955078125e-07f;  // 2^-23

  extern __shared__ float smem[];
  const int lane = blockIdx.x, t = threadIdx.x;
  const int n = c.n, nv = c.nv, p = c.p, m = c.hist;
  const int np = (n + 31) & ~31;
  float* Mm = smem;             // (nv, n) row-major
  float* Ss = Mm + nv * n;      // (p, p)
  float* sh = Ss + p * p;       // (m, np) curvature pairs s, column t owned by thread t
  float* yh = sh + m * np;      // (m, np) curvature pairs y
  float* rho = yh + m * np;     // (m)
  float* th_s = rho + m;        // (NT) theta, for the matvec
  float* xm_s = th_s + NT;      // (NT) masked vec(Xi)
  float* gv_s = xm_s + NT;      // (NT) gradient w.r.t. vec(Xi)
  float* red = gv_s + NT;       // (2, NWARP, RED_SLOTS)

  for (int i = t; i < nv * n; i += NT) Mm[i] = mmap_g[i];
  for (int i = t; i < p * p; i += NT) Ss[i] = S_g[(size_t)lane * p * p + i];
  for (int i = t; i < 2 * m * np; i += NT) sh[i] = 0.f;
  for (int i = t; i < m; i += NT) rho[i] = 0.f;

  const bool pv = t < n;    // thread owns a parameter
  const bool vv = t < nv;   // thread owns a vec(Xi) entry
  const int bi = vv ? t / p : 0, br = vv ? t % p : 0;
  const float Bt = vv ? B_g[(size_t)lane * nv + t] : 0.f;
  const float qv = q_g[lane];
  const float inv_nd = 1.0f / ne_g[lane];
  const float gscale = (2.0f * c.w_x) * inv_nd;

  float theta = pv ? theta0_g[(size_t)lane * n + t] : 0.f;
  float maskv = vv ? 1.f : 0.f;
  float prev = theta, pprev = theta, prev_g = 0.f, d_dir = 0.f;
  float prev_loss = 1e30f, H = 1.f;
  int hist_len = 0, n_iter = 0, since_thresh = 0, stop = c.epochs;
  int evals = 0, slots = 0, buf = 0;
  float alpha[MAX_HIST];
  __syncthreads();

  for (int e = 0; e < c.epochs; ++e) {
    for (int i = 0; i < c.inner; ++i) {
      // ---- loss and gradient ----
      th_s[t] = theta;
      __syncthreads();
      float xv = 0.f;
      if (vv)
        for (int j = 0; j < n; ++j) xv = xv + Mm[t * n + j] * th_s[j];
      const float xm = xv * maskv;
      xm_s[t] = xm;
      __syncthreads();
      float Sx = 0.f;
      if (vv)
        for (int j = 0; j < p; ++j) Sx = Sx + xm_s[bi * p + j] * Ss[j * p + br];
      float r3[3] = {xm * Sx, xm * Bt, pv ? fabsf(theta) : 0.f};
      block_reduce<3, 0u>(r3, red, buf);
      float loss = c.w_x * ((r3[0] - 2.0f * r3[1] + qv) * inv_nd);
      gv_s[t] = gscale * (Sx - Bt) * maskv;
      __syncthreads();
      float g = 0.f;
      if (pv)
        for (int v = 0; v < nv; ++v) g = g + gv_s[v] * Mm[v * n + t];
      if (c.use_l1) {
        loss = loss + c.w_reg * r3[2];
        if (pv) g = g + c.w_reg * sign_of(theta);
      }
      ++evals;

      // ---- torch break conditions, curvature terms ----
      const float y = g - prev_g;
      float r5[5] = {fabsf(g), fabsf(d_dir), y * d_dir, y * y, fabsf(g)};
      block_reduce<5, 3u>(r5, red, buf);
      const float ys = r5[2], yy = r5[3], g1 = r5[4];
      const bool opt_cond = r5[0] <= TOL_GRAD;
      const bool step_small = r5[1] <= TOL_CHANGE;
      const bool loss_small =
          fabsf(loss - prev_loss) < nan_max(TOL_CHANGE, fabsf(loss) * ULP);
      // a lane frozen for the epoch stays unchanged until the epoch ends
      if (opt_cond || (i > 0 && (step_small || loss_small))) break;

      const bool is_first = n_iter == 0;
      if (!is_first && ys > 1e-10f) {
        // append (s, y), dropping the oldest pair when full
        if (hist_len >= m) {
          if (pv)
            for (int k = 0; k < m - 1; ++k) {
              sh[k * np + t] = sh[(k + 1) * np + t];
              yh[k * np + t] = yh[(k + 1) * np + t];
            }
          if (t == 0)
            for (int k = 0; k < m - 1; ++k) rho[k] = rho[k + 1];
        }
        const int pos = hist_len < m - 1 ? hist_len : m - 1;
        if (pv) {
          sh[pos * np + t] = d_dir;
          yh[pos * np + t] = y;
        }
        if (t == 0) rho[pos] = (ys != 0.f) ? 1.0f / ys : 0.f;
        if (hist_len < m) ++hist_len;
        H = (yy > 0.f) ? ys / yy : 1.f;
        __syncthreads();  // rho
      }

      // ---- direction: steepest descent after a reset, else two-loop ----
      float dir;
      float step;
      if (is_first) {
        dir = -g;
        step = nan_min(1.f, 1.f / nan_max(g1, 1e-30f)) * c.lr;
      } else {
        float qd = -g;
        for (int k = hist_len - 1; k >= 0; --k) {
          float a[1] = {pv ? sh[k * np + t] * qd : 0.f};
          block_reduce<1, 0u>(a, red, buf);
          alpha[k] = rho[k] * a[0];
          if (pv) qd = qd - alpha[k] * yh[k * np + t];
        }
        float r = qd * H;
        for (int k = 0; k < hist_len; ++k) {
          float b[1] = {pv ? yh[k * np + t] * r : 0.f};
          block_reduce<1, 0u>(b, red, buf);
          const float beta = rho[k] * b[0];
          if (pv) r = r + sh[k * np + t] * (alpha[k] - beta);
        }
        dir = r;
        step = c.lr;
        slots += hist_len;
      }
      float gtd[1] = {g * dir};
      block_reduce<1, 0u>(gtd, red, buf);
      const bool gtd_break = gtd[0] > -TOL_CHANGE;
      d_dir = dir * step;
      if (!gtd_break) theta = theta + d_dir;
      prev_g = g;
      prev_loss = loss;
      ++n_iter;
      if (gtd_break) break;  // torch breaks without stepping; updates stand
    }

    // ---- epoch end: convergence, NaN stop, thresholding ----
    const float dd1 = theta - prev, dd2 = theta - pprev;
    const bool in_beta = c.n_beta < 0 || t < c.n_beta;
    float r5[5] = {(pv && in_beta) ? dd1 * dd1 : 0.f, (pv && !in_beta) ? dd1 * dd1 : 0.f,
                   (pv && in_beta) ? dd2 * dd2 : 0.f, (pv && !in_beta) ? dd2 * dd2 : 0.f,
                   (theta != theta) ? 1.f : 0.f};
    block_reduce<5, 0u>(r5, red, buf);
    const float delta = c.n_beta < 0 ? sqrtf(r5[0]) : sqrtf(r5[0]) + sqrtf(r5[1]);
    const float delta2 = c.n_beta < 0 ? sqrtf(r5[2]) : sqrtf(r5[2]) + sqrtf(r5[3]);
    const bool nan = r5[4] > 0.f;
    const bool conv = delta < c.tol;
    const bool final_conv = conv && delta2 < c.tol;
    ++since_thresh;
    const bool st_hit = c.st_freq > 0 && since_thresh % c.st_freq == 0;
    if (!nan && !final_conv && (conv || st_hit)) {
      th_s[t] = theta;
      __syncthreads();
      float xv = 0.f;
      if (vv)
        for (int j = 0; j < n; ++j) xv = xv + Mm[t * n + j] * th_s[j];
      __syncthreads();
      if (!(fabsf(xv) > c.thr)) maskv = 0.f;
      hist_len = 0;
      n_iter = 0;
      H = 1.f;
      prev_g = 0.f;
      d_dir = 0.f;
      since_thresh = 0;
      if (conv) pprev = theta;
    }
    prev = theta;
    if (final_conv || nan) {
      stop = e;
      break;
    }
  }

  if (pv) theta_out[(size_t)lane * n + t] = theta;
  if (vv) mask_out[(size_t)lane * nv + t] = maskv;
  if (t == 0) {
    stop_out[lane] = stop;
    if (work_out) {
      work_out[2 * lane] = evals;
      work_out[2 * lane + 1] = slots;
    }
  }
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
  if (lanes < 1 || n < 1 || n > NT || nv < 1 || nv > NT || hist < 1 || hist > MAX_HIST)
    return (int)cudaErrorInvalidValue;
  SweepCfg c{d, p, n, nv, epochs, inner, hist, st_freq, n_beta, use_l1, lr, w_x, w_reg, thr, tol};
  const int np = (n + 31) & ~31;
  const size_t smem =
      sizeof(float) * ((size_t)nv * n + (size_t)p * p + 2 * (size_t)hist * np + hist +
                       3 * NT + 2 * NWARP * RED_SLOTS);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lbfgs_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  lbfgs_sweep_kernel<<<lanes, NT, smem, (cudaStream_t)stream>>>(
      c, (const float*)S, (const float*)B, (const float*)q, (const float*)n_elems,
      (const float*)theta0, (const float*)mmap, (float*)theta_out, (float*)mask_out,
      (int*)stop_out, (int*)work_out);
  return (int)cudaGetLastError();
}
