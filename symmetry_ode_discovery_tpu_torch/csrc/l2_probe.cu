// The card's L2 read rate, as the bf16 chain kernels (csrc/symmpen.cu) meet
// it: every CTA of K2/K3 streams the chain's hidden weights (2 MiB at the LV
// shape) out of L2, so that rate sets a floor under their time.
//
// Replaces no TPU kernel and runs on no path of the port: chip_smoke.py times
// it beside K2/K3 bf16 to reckon that floor. Every CTA reads the whole buffer
// (resident in the 50 MB L2 after the first pass) with 16-byte loads that
// bypass L1, and each thread writes one word so the loads are kept.

#include <cuda_runtime.h>
#include <stdint.h>

#define PROBE_THREADS 512

__global__ void __launch_bounds__(PROBE_THREADS)
    l2_read_kernel(const uint4* __restrict__ buf, int n16, unsigned* __restrict__ out) {
    unsigned x = 0;
#pragma unroll 8
    for (int i = threadIdx.x; i < n16; i += PROBE_THREADS) {
        unsigned a, b, c, d;
        asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(a), "=r"(b), "=r"(c), "=r"(d)
                     : "l"(buf + i));
        x ^= a ^ b ^ c ^ d;
    }
    out[blockIdx.x * PROBE_THREADS + threadIdx.x] = x;
}

// ctas CTAs each read `bytes` (a multiple of 16) of buf (16-byte aligned);
// out holds ctas * l2_probe_threads() words. Returns the CUDA error of the
// launch (0 on success).
extern "C" int l2_read_launch(const void* buf, long long bytes, unsigned* out, int ctas,
                              void* stream) {
    if (bytes < 16 || bytes % 16 || bytes / 16 > 0x7fffffff || ctas < 1)
        return (int)cudaErrorInvalidValue;
    l2_read_kernel<<<ctas, PROBE_THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const uint4*>(buf), (int)(bytes / 16), out);
    return (int)cudaGetLastError();
}

extern "C" int l2_probe_threads() { return PROBE_THREADS; }
