// Frozen-autoencoder chains of the EquivSINDy-r penalty, for Hopper (sm_90a).
//
// Replaces the TPU kernels of symmetry_ode_discovery_tpu/ops/pallas_symmpen.py:
//   K2  _enc_fwd_kernel (:185) and _enc_bwd_kernel (:191), via make_enc_apply
//   K3  _dec_jvp_kernel (:197) and _dec_jvp_bwd_kernel (:215), via make_dec_jvp
// The TPU kernels run one row tile per grid step with every weight resident in
// VMEM. Here one CTA owns a tile of TR = 32 rows and runs a whole chain (all
// layers) for it, so activations never leave the SM:
//
//   mode 0  chain forward        out = A_K(relu(... relu(A_0 x)))          (K2 fwd)
//   mode 1  decoder JVP          primal p_k = a_k W_k + b_k gives the masks
//                                m_k = [p_k > 0]; tangent t_{k+1} = m_k . (t_k W_k);
//                                out = t_K W_K                              (K3 fwd)
//   mode 2  masked transpose     forward once for the masks, then
//                                out = ((c W_K^T) . m_{K-1}) W_{K-1}^T ...  (K2 and
//                                K3 backward; the JVP's gradient in z is 0)
//
// What bounds it: operations. Each chain is 2 * (2*512 + 4*512*512 + 512*2)
// = 2.10 MFLOP per row at the shipped width (four 512x512 layers and the
// 2-wide ends) in f32 without TF32 or tensor cores (the reference's numerics),
// against 67 TFLOP/s of f32 FMA on the H100 SXM. The weights (4.2 MB) stay in
// the 50 MB L2; each CTA streams them once per layer in K-blocks of KB rows
// through shared memory, so a CTA does 32 rows x 2 FLOP per 4 weight bytes.
// The design keeps the tile's activations in shared memory (32 x 512 f32 =
// 64 KB, twice for the JVP's primal and tangent) and each thread's 8 x 8
// outputs in registers, a plain register-tiled SIMT product with FMA
// accumulation.
//
// Hidden width: any h from 1 to 512 (512 for the LV checkpoint, 128 for
// selkov), read at run time and padded to the 512-wide tile inside the
// kernel. Weight loads past h read as 0 and every epilogue stores 0 (mask
// bit 0) in columns c >= h, so the padded columns stay exactly 0 and add
// nothing to any sum; the K loop stops at h rounded up to a K-block. A
// narrow chain still runs 512 columns per layer (4x the columns at h = 128).
// The template flag FULL (h == 512) compiles every guard away, so the LV
// chain runs the unguarded code. Other widths stage weights as guarded
// float4 when h % 4 == 0 (selkov's 128), else one guarded float at a time;
// the scalar loader made width 128 about 1.4x slower on the card, so both
// stay, and the card tests run each (widths 128, 200 and 201).
// The ReLU masks are computed once, by one device function shared
// by every mode, and kept as bits in shared memory; the thread that computes an
// output of a layer is always the thread that applies its mask, so forward and
// backward make the same p > 0 decision bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define H 512        // tile width: the largest hidden width the kernel takes
#define TR 32        // rows per CTA
#define NT 256       // threads per CTA: 4 row groups x 64 column groups
#define KB 16        // weight rows per shared-memory K-block
#define MAXW 10      // at most n_layers + 1 weight matrices
#define MAXD 8       // at most 8 input or output features

struct Chain {
    const float* Wf[MAXW];  // W_k, (d_k, d_{k+1}) row-major: k-major for the forward product
    const float* Wb[MAXW];  // W_k^T, (d_{k+1}, d_k) row-major: k-major for the transposed product
    const float* b[MAXW];
    int n_w, d_in, d_out, h;  // h: hidden width, 1..H
};

// column j (0..7) of thread column group tx: two float4 groups, 256 apart
__device__ __forceinline__ int col_of(int tx, int j) {
    return (j < 4) ? tx * 4 + j : 256 + tx * 4 + (j - 4);
}

__device__ __forceinline__ void zero_acc(float acc[8][8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// acc[i][j] = sum_{t < din} in[row, t] * W[t, col] for the thread's 8 rows and
// 8 columns; rows past `rows` and columns past h read as 0. W is (din, h)
// row-major.
template <bool FULL>
__device__ __forceinline__ void small_in(const float* __restrict__ in, const float* __restrict__ W,
                                         int row0, int rows, int din, int h, float acc[8][8],
                                         int ty, int tx) {
    zero_acc(acc);
    for (int t = 0; t < din; ++t) {
        float w[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = col_of(tx, j);
            w[j] = (FULL || c < h) ? __ldg(W + t * h + c) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int r = row0 + ty * 8 + i;
            const float a = (r < rows) ? __ldg(in + (size_t)r * din + t) : 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, w[j], acc[i][j]);
        }
    }
}

// acc = act (TR x H, stored k-major: act[k * TR + r]) times W (h x h, k-major),
// W streamed through `wblk` (KB x H) in K-blocks, zero past h in either index.
// Starts and ends with a barrier, so the caller may overwrite act in place
// afterwards.
template <bool FULL>
__device__ __forceinline__ void gemm_hh(const float* __restrict__ W, const float* act, float* wblk,
                                        int h, float acc[8][8], int tid, int ty, int tx) {
    zero_acc(acc);
    const float4* act4 = reinterpret_cast<const float4*>(act);
    const float4* w4 = reinterpret_cast<const float4*>(wblk);
    for (int kb = 0; kb < h; kb += KB) {
        __syncthreads();
        if constexpr (FULL) {
            const float4* src = reinterpret_cast<const float4*>(W + (size_t)kb * H);
            float4* dst = reinterpret_cast<float4*>(wblk);
#pragma unroll
            for (int q = tid; q < KB * H / 4; q += NT) dst[q] = __ldg(src + q);
        } else if ((h & 3) == 0) {  // rows of W are float4-aligned: a group is all in or all out
            float4* dst = reinterpret_cast<float4*>(wblk);
#pragma unroll
            for (int q = tid; q < KB * H / 4; q += NT) {
                const int k = kb + q / (H / 4), c = (q % (H / 4)) * 4;
                dst[q] = (k < h && c < h)
                             ? __ldg(reinterpret_cast<const float4*>(W + (size_t)k * h + c))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
            }
        } else {
            for (int q = tid; q < KB * H; q += NT) {
                const int k = kb + q / H, c = q % H;
                wblk[q] = (k < h && c < h) ? __ldg(W + (size_t)k * h + c) : 0.f;
            }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) {
            const float4 a0 = act4[(kb + kk) * (TR / 4) + ty * 2];
            const float4 a1 = act4[(kb + kk) * (TR / 4) + ty * 2 + 1];
            const float4 w0 = w4[kk * (H / 4) + tx];
            const float4 w1 = w4[kk * (H / 4) + 64 + tx];
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
        }
    }
    __syncthreads();
}

// Writes the thread's 8 x 8 outputs into act (k-major). AFFINE: p = acc + b,
// record m = [p > 0] as layer l's mask bits, store relu(p) (NaN stays NaN, as
// jnp.maximum and torch.relu keep it). Otherwise: store m_l ? acc : 0.
// Columns c >= h store 0 with mask bits 0 (acc there may hold 0 * NaN).
template <bool AFFINE, bool FULL>
__device__ __forceinline__ void epilogue(const float acc[8][8], const float* __restrict__ bias,
                                         float* act, unsigned char* maskb, int l, int h, int ty,
                                         int tx) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int c = col_of(tx, j);
        unsigned char* mb = maskb + ((size_t)l * H + c) * 4 + ty;
        float v[8];
        if (!FULL && c >= h) {
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = 0.f;
            if constexpr (AFFINE) *mb = 0;
        } else if constexpr (AFFINE) {
            const float bb = __ldg(bias + c);
            unsigned int bits = 0;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float p = acc[i][j] + bb;
                if (p > 0.f) bits |= 1u << i;
                v[i] = (p <= 0.f) ? 0.f : p;
            }
            *mb = (unsigned char)bits;
        } else {
            const unsigned int bits = *mb;
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = ((bits >> i) & 1u) ? acc[i][j] : 0.f;
        }
        float4* dst = reinterpret_cast<float4*>(act + c * TR + ty * 8);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
}

// out[row, j] = sum_{k < h} act[k, r] * W[k, j] (+ bias[j]) for j < dn; W is
// (h, dn) row-major. Eight lanes share one output and reduce by a fixed
// butterfly.
__device__ __forceinline__ void reduce_out(const float* __restrict__ W, const float* __restrict__ bias,
                                           const float* act, float* __restrict__ out,
                                           int row0, int rows, int dn, int h, int tid) {
    const int g = tid & 7;
    for (int o = tid >> 3; o < TR * dn; o += NT / 8) {
        const int r = o / dn, j = o - (o / dn) * dn;
        float s = 0.f;
        for (int k = g; k < h; k += 8) s = fmaf(act[k * TR + r], __ldg(W + k * dn + j), s);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        if (g == 0 && row0 + r < rows) out[(size_t)(row0 + r) * dn + j] = bias ? s + __ldg(bias + j) : s;
    }
}

// The primal chain up to the last hidden layer, recording every mask: act
// holds the last hidden activation afterwards. One function for every mode.
template <bool FULL>
__device__ __forceinline__ void primal_hidden(const Chain& ch, const float* __restrict__ x,
                                              float* act, float* wblk, unsigned char* maskb,
                                              int row0, int rows, int tid, int ty, int tx,
                                              float acc[8][8]) {
    const int h = FULL ? H : ch.h;
    small_in<FULL>(x, ch.Wf[0], row0, rows, ch.d_in, h, acc, ty, tx);
    epilogue<true, FULL>(acc, ch.b[0], act, maskb, 0, h, ty, tx);
    for (int l = 1; l < ch.n_w - 1; ++l) {
        gemm_hh<FULL>(ch.Wf[l], act, wblk, h, acc, tid, ty, tx);
        epilogue<true, FULL>(acc, ch.b[l], act, maskb, l, h, ty, tx);
    }
}

template <bool FULL>
__global__ void __launch_bounds__(NT) symmpen_kernel(Chain ch, int mode, const float* __restrict__ in0,
                                                     const float* __restrict__ in1,
                                                     float* __restrict__ out, int rows) {
    extern __shared__ float4 smem4[];
    float* act = reinterpret_cast<float*>(smem4);
    float* wblk = act + H * TR;
    unsigned char* maskb = reinterpret_cast<unsigned char*>(wblk + KB * H);
    float* tan = reinterpret_cast<float*>(maskb + MAXW * H * 4);  // mode 1 only
    const int tid = threadIdx.x, ty = tid >> 6, tx = tid & 63;
    const int row0 = blockIdx.x * TR;
    const int K = ch.n_w - 1, h = FULL ? H : ch.h;
    float acc[8][8];

    primal_hidden<FULL>(ch, in0, act, wblk, maskb, row0, rows, tid, ty, tx, acc);
    if (mode == 0) {
        __syncthreads();
        reduce_out(ch.Wf[K], ch.b[K], act, out, row0, rows, ch.d_out, h, tid);
    } else if (mode == 1) {
        // tangent chain, masked by the primal's masks layer by layer
        small_in<FULL>(in1, ch.Wf[0], row0, rows, ch.d_in, h, acc, ty, tx);
        epilogue<false, FULL>(acc, nullptr, tan, maskb, 0, h, ty, tx);
        for (int l = 1; l < K; ++l) {
            gemm_hh<FULL>(ch.Wf[l], tan, wblk, h, acc, tid, ty, tx);
            epilogue<false, FULL>(acc, nullptr, tan, maskb, l, h, ty, tx);
        }
        __syncthreads();
        reduce_out(ch.Wf[K], nullptr, tan, out, row0, rows, ch.d_out, h, tid);
    } else {
        // masked transpose chain from the cotangent in1 (rows, d_out)
        small_in<FULL>(in1, ch.Wb[K], row0, rows, ch.d_out, h, acc, ty, tx);
        epilogue<false, FULL>(acc, nullptr, act, maskb, K - 1, h, ty, tx);
        for (int l = K - 1; l >= 1; --l) {
            gemm_hh<FULL>(ch.Wb[l], act, wblk, h, acc, tid, ty, tx);
            epilogue<false, FULL>(acc, nullptr, act, maskb, l - 1, h, ty, tx);
        }
        __syncthreads();
        reduce_out(ch.Wb[0], nullptr, act, out, row0, rows, ch.d_in, h, tid);
    }
}

static size_t smem_bytes(int mode) {
    size_t b = (size_t)(H * TR + KB * H) * sizeof(float) + (size_t)MAXW * H * 4;
    if (mode == 1) b += (size_t)H * TR * sizeof(float);
    return b;
}

// mode 0: in0 = x (rows, d_in), out (rows, d_out); mode 1: in0 = z, in1 = u
// (rows, d_in), out (rows, d_out); mode 2: in0 (rows, d_in), in1 = cotangent
// (rows, d_out), out (rows, d_in). Wf, Wb, b: n_w device pointers each; every
// hidden layer is h wide, 1 <= h <= 512. Returns the CUDA error of the launch
// (0 on success).
extern "C" int symmpen_launch(int mode, const float* in0, const float* in1, float* out, int rows,
                              const uint64_t* Wf, const uint64_t* Wb, const uint64_t* b,
                              int n_w, int d_in, int d_out, int h, void* stream) {
    if (n_w < 2 || n_w > MAXW || d_in < 1 || d_in > MAXD || d_out < 1 || d_out > MAXD ||
        h < 1 || h > H || mode < 0 || mode > 2 || rows < 1)
        return (int)cudaErrorInvalidValue;
    Chain ch;
    for (int k = 0; k < n_w; ++k) {
        ch.Wf[k] = reinterpret_cast<const float*>(Wf[k]);
        ch.Wb[k] = reinterpret_cast<const float*>(Wb[k]);
        ch.b[k] = reinterpret_cast<const float*>(b[k]);
    }
    for (int k = n_w; k < MAXW; ++k) ch.Wf[k] = ch.Wb[k] = ch.b[k] = nullptr;
    ch.n_w = n_w;
    ch.d_in = d_in;
    ch.d_out = d_out;
    ch.h = h;
    const size_t smem = smem_bytes(mode);
    static bool smem_set = false;
    if (!smem_set) {
        cudaError_t err = cudaFuncSetAttribute(
            symmpen_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(1));
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(symmpen_kernel<false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes(1));
        if (err != cudaSuccess) return (int)err;
        smem_set = true;
    }
    const int grid = (rows + TR - 1) / TR;
    if (h == H)
        symmpen_kernel<true><<<grid, NT, smem, (cudaStream_t)stream>>>(ch, mode, in0, in1, out, rows);
    else
        symmpen_kernel<false><<<grid, NT, smem, (cudaStream_t)stream>>>(ch, mode, in0, in1, out, rows);
    return (int)cudaGetLastError();
}
