// Two-loop L-BFGS direction over a chronological memory, for Hopper (sm_90a).
//
// Replaces the TPU kernel symmetry_ode_discovery_tpu/ops/pallas_lbfgs_dir.py
// _dir_kernel (:47), launched by _dir_call (:79) under --lbfgs_dir_backend
// pallas. Per lane it computes d = H g in optax's operation order:
//
//   q = g
//   for k = m-1 .. 0:  a_k = rho_k (s_k . q);   q = q - a_k y_k
//   r = gamma q
//   for k = 0 .. m-1:  b = rho_k (y_k . r);     r = r + s_k (a_k - b)
//
// with (s_k, y_k, rho_k) oldest first and rho_k = 0 for empty slots, which
// makes a slot's update a no-op as in optax's zero-initialised memory.
//
// What bounds it: latency. The work is 8 m n FLOP per lane (m = 100, n = 16
// on the flagship path: 12.8 kFLOP) and 2 m n floats of memory, but the 2 m
// dot products form one dependent chain. One CTA per lane, one thread per
// parameter (n <= 128, so at most four warps); the memory is staged in shared
// memory once and read twice, and each dot is a warp butterfly plus, above 32
// parameters, one exchange through shared memory. The lanes of a chunk run
// in parallel on separate SMs. Built without FMA contraction, so each update is
// the multiply and the subtract of the reference.

#include <cuda_runtime.h>

#define MAX_N 128

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Sum over the block; every thread gets the same value.
__device__ __forceinline__ float block_sum(float v, float* red, int nwarps) {
    v = warp_sum(v);
    if (nwarps == 1) return v;
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float t = 0.f;
    for (int w = 0; w < nwarps; ++w) t += red[w];
    return t;
}

__global__ void lbfgs_dir_kernel(const float* __restrict__ g, const float* __restrict__ s,
                                 const float* __restrict__ y, const float* __restrict__ rho,
                                 const float* __restrict__ gamma, float* __restrict__ out,
                                 int m, int n) {
    extern __shared__ float smem[];
    float* S = smem;              // m * n
    float* Y = S + m * n;         // m * n
    float* R = Y + m * n;         // m
    float* A = R + m;             // m alphas
    float* red = A + m;           // one float per warp
    const int lane = blockIdx.x, i = threadIdx.x;
    const int nwarps = blockDim.x >> 5;
    const size_t base = (size_t)lane * m * n;
    for (int t = i; t < m * n; t += blockDim.x) {
        S[t] = s[base + t];
        Y[t] = y[base + t];
    }
    for (int t = i; t < m; t += blockDim.x) R[t] = rho[(size_t)lane * m + t];
    __syncthreads();
    const bool live = i < n;
    float q = live ? g[(size_t)lane * n + i] : 0.f;
    for (int k = m - 1; k >= 0; --k) {
        const float sk = live ? S[k * n + i] : 0.f;
        const float a = R[k] * block_sum(sk * q, red, nwarps);
        if (i == 0) A[k] = a;
        const float yk = live ? Y[k * n + i] : 0.f;
        q = q - a * yk;
    }
    __syncthreads();
    float r = q * gamma[lane];
    for (int k = 0; k < m; ++k) {
        const float yk = live ? Y[k * n + i] : 0.f;
        const float b = R[k] * block_sum(yk * r, red, nwarps);
        const float sk = live ? S[k * n + i] : 0.f;
        r = r + sk * (A[k] - b);
    }
    if (live) out[(size_t)lane * n + i] = r;
}

// g (lanes, n), s and y (lanes, m, n) oldest first, rho (lanes, m), gamma
// (lanes,), out (lanes, n); all float32 on the device. Returns the CUDA error
// of the launch (0 on success).
extern "C" int lbfgs_dir_launch(const float* g, const float* s, const float* y, const float* rho,
                                const float* gamma, float* out, int lanes, int m, int n,
                                void* stream) {
    if (lanes < 1 || m < 1 || n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
    const int threads = ((n + 31) / 32) * 32;
    const size_t smem = (size_t)(2 * m * n + 2 * m + threads / 32) * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(lbfgs_dir_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    lbfgs_dir_kernel<<<lanes, threads, smem, (cudaStream_t)stream>>>(g, s, y, rho, gamma, out, m, n);
    return (int)cudaGetLastError();
}
