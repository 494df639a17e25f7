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
// dot products form one dependent chain. The design shortens each link:
//
// - One warp per lane (one CTA of 32 threads), no block barrier anywhere.
// - Each dot product sums in the order of a 32-wide xor butterfly per slice
//   of 32 parameters (the order of the kernel's first, one-thread-per-
//   parameter design), then adds the slices from 0.f in order. T threads
//   hold a slice: thread t the parameters t + T j, so the butterfly's
//   levels with offset >= T are register adds; the T partial sums are then
//   gathered by T - 1 independent shuffles and added in the butterfly's
//   order, one shuffle latency on the chain where the levels would cost
//   log2(T). The other threads of the warp repeat the first T's work. Up to
//   16 parameters the slice is 16 wide: its first level is the add of +0
//   that the old design's upper half-warp made. Same tree, same bits,
//   whatever T.
// - The lane's memory is staged into shared memory by bulk copies (TMA,
//   cp.async.bulk, completing on mbarriers), newest slots first, in NST
//   pieces: the first loop starts when the newest piece has landed. The
//   misaligned ends of a slab (a lane's slab starts at lane m n 4 bytes)
//   are a few plain loads.
// - The loops take two slots an iteration in ping-pong registers: the next
//   slot's s, y, rho (and alpha) are read while this slot's reduction runs,
//   and no register copy sits on the chain. Alphas live in shared memory,
//   one column per thread.
//
// Pads (parameters >= n) hold +0 in s, y, q and r throughout, so every pad
// leaf is +0, as the plain version has no pads. The old design's pad
// threads held -0 in r when gamma < 0 and NaN once a step's a_k was not
// finite: the two designs' bits can differ only where a slice's sum is
// exactly zero (its sign) or not finite. Built without FMA contraction, so
// each update is the multiply and the subtract of the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_N 128
#define NST 4  // staging pieces, newest first

// Threads that hold a slice. Of 2, 4, 8 and 16, 8 gave the shortest step at
// n = 16 on the card: fewer shuffles, but not yet the per-thread work of 2.
#define T_SLICE 8

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
            "selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done)
            : "r"(smem_u32(bar))
            : "memory");
    } while (!done);
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src, int floats,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
        "l"(src), "r"(floats * 4), "r"(smem_u32(bar))
        : "memory");
}

// A slab of `total` floats at global `base`, copied to shared `dst` (which
// has base's address mod 16). Its 16-byte-aligned interior is cut at the
// first aligned float of slots K_c = m (NST - c) / NST; piece c holds slots
// [K_{c+1}, K_c), so piece 0 is the newest. part(c) is the cut: piece c is
// floats [part(c+1), part(c)); part(0) and part(NST) are the interior's ends.
struct Slab {
    const float* base;
    int total, lo, hi;
    __device__ Slab(const float* b, int tot) : base(b), total(tot) {
        lo = min(up(0), total);
        hi = max(lo, tot - (int)((((uintptr_t)(b + tot)) & 15) >> 2));
    }
    __device__ int up(int i) const {
        return i + (int)(((16 - (((uintptr_t)(base + i)) & 15)) & 15) >> 2);
    }
    __device__ int part(int c, int m, int n) const {
        if (c <= 0) return hi;
        if (c >= NST) return lo;
        return min(max(up((m * (NST - c) / NST) * n), lo), hi);
    }
    // The < 16-byte ends, one float per thread of threads [t0, t0 + 6).
    __device__ void ends(float* dst, int t, int t0) const {
        const int i = t - t0;
        if (i >= 0 && i < 3 && i < lo) dst[i] = base[i];
        if (i >= 3 && i < 6 && hi + i - 3 < total) dst[hi + i - 3] = base[hi + i - 3];
    }
};

// Sum of one slice's leaves v[j] (parameter t + T j of the slice) in the
// xor-butterfly order over NE leaves; every thread of a T-group gets it.
// The levels with offset >= T are register adds; for the others the group's
// T partial sums are gathered by T - 1 independent shuffles (one shuffle's
// latency, not log2 T) and added in the butterfly's order.
template <int NE, int T>
__device__ __forceinline__ float slice_sum(float (&v)[NE / T]) {
    if (NE == 16) {
#pragma unroll
        for (int j = 0; j < NE / T; ++j) v[j] = v[j] + 0.f;  // the +0 of leaves 16..31
    }
#pragma unroll
    for (int off = NE / 2; off >= T; off >>= 1) {
#pragma unroll
        for (int j = 0; j < off / T; ++j) v[j] = v[j] + v[j + off / T];
    }
    float x[T];  // x[d]: the partial sum of the thread t ^ d
    x[0] = v[0];
#pragma unroll
    for (int d = 1; d < T; ++d) x[d] = __shfl_xor_sync(0xffffffffu, v[0], d);
#pragma unroll
    for (int off = T / 2; off >= 1; off >>= 1) {
#pragma unroll
        for (int d = 0; d < off; ++d) x[d] = x[d] + x[d + off];
    }
    return x[0];
}

// Waits for the pieces until slot k's floats of s and y are in shared
// memory (piece 0, which holds rho, always).
__device__ __forceinline__ void ensure(uint64_t* bars, const Slab& Ss, const Slab& Ys, int m,
                                       int n, int k, int& waited, int& present) {
    while (waited < NST && (k * n < present || waited == 0)) {
        mbar_wait(&bars[waited]);
        ++waited;
        present = waited < NST ? max(Ss.part(waited, m, n), Ys.part(waited, m, n)) : 0;
    }
}

// Slot k's s and y of the thread's parameters (+0 for pads).
template <int NW, int J>
__device__ __forceinline__ void load(const float* S, const float* Y, int k, int n,
                                     const int (&e)[NW][J], const bool (&live)[NW][J],
                                     float (&ds)[NW][J], float (&dy)[NW][J]) {
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < J; ++j) {
            ds[w][j] = live[w][j] ? S[k * n + e[w][j]] : 0.f;
            dy[w][j] = live[w][j] ? Y[k * n + e[w][j]] : 0.f;
        }
}

// a . b over the lane: each slice's butterfly, the slices added from 0.f.
template <int NE, int NW, int T>
__device__ __forceinline__ float dot(const float (&a)[NW][NE / T], const float (&b)[NW][NE / T]) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
        float v[NE / T];
#pragma unroll
        for (int j = 0; j < NE / T; ++j) v[j] = a[w][j] * b[w][j];
        const float bw = slice_sum<NE, T>(v);
        tot = NW == 1 ? bw : tot + bw;
    }
    return tot;
}

// First-loop step at slot k: a_k = rho_k (s_k . q), q -= a_k y_k (pads keep +0).
template <int NE, int NW, int T>
__device__ __forceinline__ void step_down(int k, const float (&sk)[NW][NE / T],
                                          const float (&yk)[NW][NE / T], float rk,
                                          float (&q)[NW][NE / T], const bool (&live)[NW][NE / T],
                                          float* A, int t) {
    const float a = rk * dot<NE, NW, T>(sk, q);
    A[k * 32 + t] = a;
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < NE / T; ++j)
            if (live[w][j]) q[w][j] = q[w][j] - a * yk[w][j];
}

// Second-loop step: b = rho_k (y_k . r), r += s_k (a_k - b).
template <int NE, int NW, int T>
__device__ __forceinline__ void step_up(const float (&sk)[NW][NE / T],
                                        const float (&yk)[NW][NE / T], float rk, float ak,
                                        float (&r)[NW][NE / T], const bool (&live)[NW][NE / T]) {
    const float b = rk * dot<NE, NW, T>(yk, r);
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < NE / T; ++j)
            if (live[w][j]) r[w][j] = r[w][j] + sk[w][j] * (ak - b);
}

// NE leaves a slice (16 up to 16 parameters, else 32), NW slices, T threads a slice.
template <int NE, int NW, int T>
__global__ void __launch_bounds__(32)
    lbfgs_dir_kernel(const float* __restrict__ g, const float* __restrict__ s,
                     const float* __restrict__ y, const float* __restrict__ rho,
                     const float* __restrict__ gamma, float* __restrict__ out, int m, int n) {
    constexpr int J = NE / T;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
    const int lane = blockIdx.x, t = threadIdx.x, tt = t & (T - 1);
    const int mn = m * n;
    const Slab Ss(s + (size_t)lane * mn, mn), Ys(y + (size_t)lane * mn, mn),
        Rs(rho + (size_t)lane * m, m);
    // regions: barriers, then rho, s, y (each at its slab's address mod 16), alphas
    unsigned char* p = smem_raw + 64;
    float* R = reinterpret_cast<float*>(p + (((uintptr_t)Rs.base) & 15));
    p += ((m * 4 + 16 + 15) & ~15);
    float* S = reinterpret_cast<float*>(p + (((uintptr_t)Ss.base) & 15));
    p += ((mn * 4 + 16 + 15) & ~15);
    float* Y = reinterpret_cast<float*>(p + (((uintptr_t)Ys.base) & 15));
    p += ((mn * 4 + 16 + 15) & ~15);
    float* A = reinterpret_cast<float*>(p);  // (m, 32)

    if (t == 0) {
        for (int c = 0; c < NST; ++c) mbar_init(&bars[c]);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        for (int c = 0; c < NST; ++c) {
            const int s0 = Ss.part(c + 1, m, n), s1 = Ss.part(c, m, n);
            const int y0 = Ys.part(c + 1, m, n), y1 = Ys.part(c, m, n);
            const int r = c == 0 ? Rs.hi - Rs.lo : 0;
            mbar_expect(&bars[c], 4 * ((s1 - s0) + (y1 - y0) + r));
            if (s1 > s0) bulk_load(S + s0, Ss.base + s0, s1 - s0, &bars[c]);
            if (y1 > y0) bulk_load(Y + y0, Ys.base + y0, y1 - y0, &bars[c]);
            if (r > 0) bulk_load(R + Rs.lo, Rs.base + Rs.lo, r, &bars[c]);
        }
    }
    Ss.ends(S, t, 0);
    Ys.ends(Y, t, 8);
    Rs.ends(R, t, 16);

    int e[NW][J];
    bool live[NW][J];
    float q[NW][J], sa[NW][J], ya[NW][J], sb[NW][J], yb[NW][J];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < J; ++j) {
            e[w][j] = 32 * w + tt + T * j;
            live[w][j] = e[w][j] < n;
            q[w][j] = live[w][j] ? g[(size_t)lane * n + e[w][j]] : 0.f;
        }
    const float gam = gamma[lane];
    __syncwarp();  // the plain loads of the slabs' ends

    int waited = 0;  // pieces waited so far
    int present = max(Ss.part(0, m, n), Ys.part(0, m, n));  // first float of s and y there
    // First loop, newest -> oldest, two slots an iteration in ping-pong
    // registers: slot k's pair is read while slot k + 1's step runs.
    ensure(bars, Ss, Ys, m, n, m - 1, waited, present);
    load<NW, J>(S, Y, m - 1, n, e, live, sa, ya);
    float ra = R[m - 1], rb;
    for (int k = m - 1;; k -= 2) {
        if (k == 0) {
            step_down<NE, NW, T>(0, sa, ya, ra, q, live, A, t);
            break;
        }
        ensure(bars, Ss, Ys, m, n, k - 1, waited, present);
        load<NW, J>(S, Y, k - 1, n, e, live, sb, yb);
        rb = R[k - 1];
        step_down<NE, NW, T>(k, sa, ya, ra, q, live, A, t);
        if (k == 1) {
            step_down<NE, NW, T>(0, sb, yb, rb, q, live, A, t);
            break;
        }
        ensure(bars, Ss, Ys, m, n, k - 2, waited, present);
        load<NW, J>(S, Y, k - 2, n, e, live, sa, ya);
        ra = R[k - 2];
        step_down<NE, NW, T>(k - 1, sb, yb, rb, q, live, A, t);
    }

    // Second loop, oldest -> newest (every piece has landed), the same way.
    float r[NW][J];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < J; ++j) r[w][j] = live[w][j] ? q[w][j] * gam : 0.f;
    load<NW, J>(S, Y, 0, n, e, live, sa, ya);
    ra = R[0];
    float aa = A[t], ab;
    for (int k = 0;; k += 2) {
        if (k == m - 1) {
            step_up<NE, NW, T>(sa, ya, ra, aa, r, live);
            break;
        }
        load<NW, J>(S, Y, k + 1, n, e, live, sb, yb);
        rb = R[k + 1];
        ab = A[(k + 1) * 32 + t];
        step_up<NE, NW, T>(sa, ya, ra, aa, r, live);
        if (k + 1 == m - 1) {
            step_up<NE, NW, T>(sb, yb, rb, ab, r, live);
            break;
        }
        load<NW, J>(S, Y, k + 2, n, e, live, sa, ya);
        ra = R[k + 2];
        aa = A[(k + 2) * 32 + t];
        step_up<NE, NW, T>(sb, yb, rb, ab, r, live);
    }
    if (t < T) {
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
            for (int j = 0; j < J; ++j)
                if (live[w][j]) out[(size_t)lane * n + e[w][j]] = r[w][j];
    }
}

static size_t smem_bytes(int m, int n) {
    return 64 + (size_t)((m * 4 + 16 + 15) & ~15) + 2 * (size_t)((m * n * 4 + 16 + 15) & ~15) +
           (size_t)m * 32 * 4;
}

template <int NE, int NW, int T>
static int launch(const float* g, const float* s, const float* y, const float* rho,
                  const float* gamma, float* out, int lanes, int m, int n, cudaStream_t stream) {
    const size_t smem = smem_bytes(m, n);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            lbfgs_dir_kernel<NE, NW, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    lbfgs_dir_kernel<NE, NW, T><<<lanes, 32, smem, stream>>>(g, s, y, rho, gamma, out, m, n);
    return (int)cudaGetLastError();
}

// g (lanes, n), s and y (lanes, m, n) oldest first, rho (lanes, m), gamma
// (lanes,), out (lanes, n); all float32 on the device. Returns the CUDA error
// of the launch (0 on success).
extern "C" int lbfgs_dir_launch(const float* g, const float* s, const float* y, const float* rho,
                                const float* gamma, float* out, int lanes, int m, int n,
                                void* stream) {
    if (lanes < 1 || m < 1 || n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (n <= 16) return launch<16, 1, T_SLICE>(g, s, y, rho, gamma, out, lanes, m, n, st);
    if (n <= 32) return launch<32, 1, T_SLICE>(g, s, y, rho, gamma, out, lanes, m, n, st);
    if (n <= 64) return launch<32, 2, T_SLICE>(g, s, y, rho, gamma, out, lanes, m, n, st);
    if (n <= 96) return launch<32, 3, T_SLICE>(g, s, y, rho, gamma, out, lanes, m, n, st);
    return launch<32, 4, T_SLICE>(g, s, y, rho, gamma, out, lanes, m, n, st);
}
