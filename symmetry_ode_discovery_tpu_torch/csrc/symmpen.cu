// Frozen-autoencoder chains of the EquivSINDy-r penalty, for Hopper (sm_90a).
//
// Replaces the TPU kernels of symmetry_ode_discovery_tpu/ops/pallas_symmpen.py:
//   K2  _enc_fwd_kernel (:185) and _enc_bwd_kernel (:191), via make_enc_apply
//   K3  _dec_jvp_kernel (:197) and _dec_jvp_bwd_kernel (:215), via make_dec_jvp
// One CTA owns a tile of rows and runs a whole chain (every layer) for it, so
// activations never leave the SM:
//
//   mode 0  chain forward      out = A_K(relu(... relu(A_0 x))); writes the
//                              masks m_k = [p_k > 0] of every hidden layer   (K2 fwd)
//   mode 1  decoder JVP        primal p_k = a_k W_k + b_k and tangent
//                              t_{k+1} = m_k . (t_k W_k) side by side, one
//                              weight fetch for both; out = t_K W_K; writes
//                              the primal's masks                           (K3 fwd)
//   mode 2  masked transpose   out = ((c W_K^T) . m_{K-1}) W_{K-1}^T ... with
//                              the masks the forward wrote; no primal chain  (K2 and K3
//                              backward; the JVP's gradient in z is 0)
//
// What bounds it: operations. One chain pass is 2 * (2*512 + 4*512*512 +
// 512*2) = 2.10 MFLOP per row at the LV width, in f32 on the FMA pipe (no
// TF32, no tensor cores: the reference's numerics), against 67 TFLOP/s on the
// H100 SXM. The weights (4.2 MB a chain) stay in the 50 MB L2 and are
// streamed through shared memory by every CTA; what the design does about it:
//   - The backward reads the forward's masks (1 bit per hidden unit and row,
//     320 bytes a row at the LV shape) instead of re-running the primal
//     chain: a closure makes 5 chain passes where it made 7.
//   - Every CTA holds TR * W = 32768 activations (128 KB): 64 rows at width
//     W = 512, 128 at 256, 256 at 128. A weight byte fetched from L2 feeds
//     TR / 2 FLOPs (32 at width 512). Mode 1 fills the tile with 32 primal
//     and 32 tangent rows of the same 32 data rows, so both products of a
//     layer share each weight fetch and the tangent's mask is in the
//     registers that computed the primal.
//   - Weights are staged in K-blocks of KB rows through a ring of STAGES
//     shared-memory buffers by cp.async, one block ahead, across layer
//     boundaries: the copy of the next block overlaps this block's FMAs
//     (2,048 per thread at W = 512) and the layer's epilogue. One CTA fits
//     an SM (192 KB of shared memory at W = 512); the ring hides L2.
//   - Each thread owns 8 rows x 16 columns (128 accumulators): per step of k
//     it reads 2 + 4 float4 from shared memory for 128 FMAs.
//   - The tile width W (128, 256, 512) is a template parameter the wrapper
//     picks from the hidden width h, so a narrow chain runs its own columns.
//
// Hidden width: any h from 1 to W (512 for the LV checkpoint, 128 for selkov).
// Weight loads past h read as 0 (cp.async's zero fill) and every epilogue
// stores 0 (mask bit 0) in columns c >= h, so the padded columns stay exactly
// 0 and add nothing to any sum; the K loop stops at h rounded up to a
// K-block. FULL (h == W: the LV checkpoint's 512 and selkov's 128) compiles
// every guard away and stages weights 16 bytes at a time; other widths stage
// them 4 bytes at a time.
//
// bf16 mode (template BF; the JAX kernels' dtype=bfloat16): the rounding
// points of the JAX bodies. The wrapper passes the folded f32 weights rounded
// to bf16, every hidden width zero-padded to W (so rows are 16-byte aligned
// at any h and the FULL instance runs; padded columns stay exactly 0 and
// their mask bits 0); inputs are rounded to bf16 as they are read;
// activations (after ReLU, after a mask, before each transposed hop) are
// rounded to bf16 as they are stored in the tile, which is bf16; weights are
// staged in bf16, half the bytes of the cp.async ring. Each bf16 x bf16
// product is formed in f32, where it is exact, and summed in f32 FMAs; bias,
// masks [p > 0] of the f32 pre-activation, accumulators and outputs are f32.
// So only the order of the sums parts it from the plain version. The tensor
// cores are a later step on the same tiles.
//
// Layouts. Activations are k-major in shared memory, row groups of 4 (f32) or
// 8 (bf16: 16 bytes) XOR-ed with (k / 4) % 4 or % 8, so the epilogue's column
// stores spread over the banks.
// Masks: one 16-bit word per (hidden layer, data row, column group tx), bit
// j for column (j / 4) * (W / 4) + 4 tx + j % 4: the columns of the thread
// that computes and consumes them in every mode, so the word is written and
// read whole and row-indexed (modes 1 and 2 tile rows differently).
// Deterministic: fixed-order sums, no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define NT 256       // threads per CTA
#define RT 8         // tile rows per thread
#define CT 16        // columns per thread: 4 float4 groups W / 4 apart
#define KB 16        // weight rows per K-block
#define STAGES 2     // K-blocks in the ring
#define MAXW 10      // at most n_layers + 1 weight matrices
#define MAXD 8       // at most 8 input or output features

// the element type of weights and activations: f32, or bf16 when BF
template <bool BF>
using Elem = typename std::conditional<BF, __nv_bfloat16, float>::type;

template <int W, bool BF = false>
struct Tile {
    static constexpr int CG = W / CT;    // column groups = mask words per row
    static constexpr int RG = NT / CG;   // row groups
    static constexpr int TR = RG * RT;   // tile rows: 64, 128, 256 at W = 512, 256, 128
    static constexpr int BLK = KB * W;   // elements per weight stage
    static constexpr size_t SMEM = (size_t)(TR * W + STAGES * BLK) * sizeof(Elem<BF>);
};

struct Chain {
    const void* Wf[MAXW];  // W_k, (d_k, d_{k+1}) row-major: k-major for the forward product
    const void* Wb[MAXW];  // W_k^T, (d_{k+1}, d_k) row-major: k-major for the transposed product
    const float* b[MAXW];
    int n_w, d_in, d_out, h;  // h: hidden width, 1..W (W in bf16: the weights are padded)
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

// v as the chain in BF holds it: rounded to bf16 (round to nearest even)
template <bool BF>
__device__ __forceinline__ float rnd(float v) {
    if constexpr (BF) return __bfloat162float(__float2bfloat16_rn(v));
    return v;
}

// the two bf16 halves of a 32-bit word, as f32 (exact)
__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// two f32 values rounded to bf16 and packed, the first in the low half
__device__ __forceinline__ unsigned bf_pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
}

// column j (0..15) of column group tx
template <int W>
__device__ __forceinline__ int col_of(int tx, int j) {
    return (j >> 2) * (W / 4) + tx * 4 + (j & 3);
}

// shared-memory index of activation (k, tile row t)
template <int W, bool BF>
__device__ __forceinline__ int act_at(int k, int t) {
    if constexpr (BF) return k * Tile<W>::TR + (((t >> 3) ^ ((k >> 2) & 7)) << 3) + (t & 7);
    return k * Tile<W>::TR + (((t >> 2) ^ ((k >> 2) & 3)) << 2) + (t & 3);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(in ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(in ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of rows kb .. kb + KB - 1 of Wm (h x h, row-major) into
// dst (KB x W); past h in either index the copy fills 0.
template <int W, bool FULL, bool BF>
__device__ __forceinline__ void load_block(Elem<BF>* dst, const Elem<BF>* __restrict__ Wm, int kb,
                                           int h, int tid) {
    constexpr int V = 16 / sizeof(Elem<BF>);  // elements per 16-byte copy
    if constexpr (FULL) {
        const Elem<BF>* src = Wm + (size_t)kb * W;
#pragma unroll
        for (int q = tid; q < KB * W / V; q += NT) cp_async16(dst + V * q, src + V * q, true);
    } else {  // f32 only (bf16 weights come padded to W)  // rows of Wm need not be 16-byte aligned: one float at a time
        for (int q = tid; q < KB * W; q += NT) {
            const int k = kb + q / W, c = q % W;
            const bool in = k < h && c < h;
            cp_async4(reinterpret_cast<float*>(dst) + q, in ? Wm + (size_t)k * h + c : Wm, in);
        }
    }
}

__device__ __forceinline__ void zero_acc(float acc[RT][CT]) {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;
}

// acc[i][j] = sum_{t < din} in(slot i, t) * Wm[t, col j]: slots 0-3 read rows
// r_lo .. r_lo + 3 of in_lo, slots 4-7 rows r_hi .. r_hi + 3 of in_hi (f32,
// rounded to bf16 in BF); rows past `rows` and columns past h read as 0. Wm
// is (din, h) row-major.
template <int W, bool FULL, bool BF>
__device__ __forceinline__ void small_in(const float* __restrict__ in_lo,
                                         const float* __restrict__ in_hi, int r_lo, int r_hi,
                                         int rows, int din, const Elem<BF>* __restrict__ Wm, int h,
                                         float acc[RT][CT], int tx) {
    zero_acc(acc);
    for (int t = 0; t < din; ++t) {
        float w[CT];
#pragma unroll
        for (int j = 0; j < CT; ++j) {
            const int c = col_of<W>(tx, j);
            w[j] = (FULL || c < h) ? ldg_f(Wm + t * h + c) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RT; ++i) {
            const int r = (i < 4 ? r_lo : r_hi) + (i & 3);
            const float* src = i < 4 ? in_lo : in_hi;
            const float a = (r < rows) ? rnd<BF>(__ldg(src + (size_t)r * din + t)) : 0.f;
#pragma unroll
            for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(a, w[j], acc[i][j]);
        }
    }
}

// acc += act[k0 .. k0 + KB) x wblk (KB x W), for the thread's 8 rows and 16
// columns. k0 is a multiple of KB, so the swizzle (k >> 2) & 3 is kk's own.
template <int W>
__device__ __forceinline__ void mma_block(const float* act, const float* wblk, int k0,
                                          float acc[RT][CT], int tx, int ty) {
    constexpr int TR = Tile<W>::TR;
    const float4* a4 = reinterpret_cast<const float4*>(act + k0 * TR);
    const float4* w4 = reinterpret_cast<const float4*>(wblk);
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
        const int s = (kk >> 2) & 3;
        const float4 p = a4[kk * (TR / 4) + ((ty * 2) ^ s)];
        const float4 q = a4[kk * (TR / 4) + ((ty * 2 + 1) ^ s)];
        const float a[RT] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
        float w[CT];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
            const float4 v = w4[kk * (W / 4) + g * (W / 16) + tx];
            w[4 * g] = v.x;
            w[4 * g + 1] = v.y;
            w[4 * g + 2] = v.z;
            w[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
}

// The bf16 tile: one 16-byte load gives the thread's 8 rows, one 8-byte load
// each of its 4 column groups; each value widened to f32 (exact), the f32
// FMAs as above. The swizzle (k >> 2) & 7 depends on k0 too.
template <int W>
__device__ __forceinline__ void mma_block(const __nv_bfloat16* act, const __nv_bfloat16* wblk,
                                          int k0, float acc[RT][CT], int tx, int ty) {
    constexpr int TR = Tile<W>::TR;
    const uint4* a16 = reinterpret_cast<const uint4*>(act + k0 * TR);
    const uint2* w8 = reinterpret_cast<const uint2*>(wblk);
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
        const int s = ((k0 + kk) >> 2) & 7;
        const uint4 p = a16[kk * (TR / 8) + (ty ^ s)];
        const float a[RT] = {bf_lo(p.x), bf_hi(p.x), bf_lo(p.y), bf_hi(p.y),
                             bf_lo(p.z), bf_hi(p.z), bf_lo(p.w), bf_hi(p.w)};
        float w[CT];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
            const uint2 v = w8[kk * (W / 4) + g * (W / 16) + tx];
            w[4 * g] = bf_lo(v.x);
            w[4 * g + 1] = bf_hi(v.x);
            w[4 * g + 2] = bf_lo(v.y);
            w[4 * g + 3] = bf_hi(v.y);
        }
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
}

// the thread's 8 values of column c into act (tile rows 8 ty .. 8 ty + 7)
template <int W>
__device__ __forceinline__ void store_col(float* act, int c, int ty, const float v[RT]) {
    float4* dst = reinterpret_cast<float4*>(act + c * Tile<W>::TR);
    const int s = (c >> 2) & 3;
    dst[(ty * 2) ^ s] = make_float4(v[0], v[1], v[2], v[3]);
    dst[(ty * 2 + 1) ^ s] = make_float4(v[4], v[5], v[6], v[7]);
}

// bf16: the 8 values rounded to bf16 (the chain's rounding point) in one
// 16-byte store
template <int W>
__device__ __forceinline__ void store_col(__nv_bfloat16* act, int c, int ty, const float v[RT]) {
    uint4* dst = reinterpret_cast<uint4*>(act + c * Tile<W>::TR);
    dst[ty ^ ((c >> 2) & 7)] = make_uint4(bf_pack(v[0], v[1]), bf_pack(v[2], v[3]),
                                          bf_pack(v[4], v[5]), bf_pack(v[6], v[7]));
}

// Modes 0 and 1, after the product of hidden layer l: p = acc + b_l. Each
// primal slot stores relu(p) (NaN stays NaN, as jnp.maximum and torch.relu
// keep it) and records m = [p > 0]; with JVP, tangent slot i + 4 (the data
// row of primal slot i) stores m ? acc : 0. The thread's mask words go to
// mwords (layer l's plane), data rows drow0 .. drow0 + NP - 1. Columns c >= h
// store 0 with bit 0 (acc there may hold 0 * NaN).
template <int W, bool FULL, bool JVP, class E>
__device__ __forceinline__ void epi_fwd(const float acc[RT][CT], const float* __restrict__ bias,
                                        E* act, uint16_t* __restrict__ mwords, int drow0,
                                        int rows, int h, int tx, int ty) {
    constexpr int NP = JVP ? RT / 2 : RT;
    unsigned bits[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) bits[i] = 0u;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
        const int c = col_of<W>(tx, j);
        float v[RT];
        if (!FULL && c >= h) {
#pragma unroll
            for (int i = 0; i < RT; ++i) v[i] = 0.f;
        } else {
            const float bb = __ldg(bias + c);
#pragma unroll
            for (int i = 0; i < NP; ++i) {
                const float p = acc[i][j] + bb;
                const bool m = p > 0.f;
                bits[i] |= (unsigned)m << j;
                v[i] = (p <= 0.f) ? 0.f : p;
                if constexpr (JVP) v[i + NP] = m ? acc[i + NP][j] : 0.f;
            }
        }
        store_col<W>(act, c, ty, v);
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
        const int r = drow0 + i;
        if (r < rows) mwords[(size_t)r * Tile<W>::CG + tx] = (uint16_t)bits[i];
    }
}

// the thread's mask words of one layer's plane, two rows per register
template <int W>
__device__ __forceinline__ void load_masks(const uint16_t* __restrict__ mwords, int drow0, int rows,
                                           int tx, unsigned mw[RT / 2]) {
#pragma unroll
    for (int i = 0; i < RT; i += 2) {
        const int r = drow0 + i;
        const unsigned lo = r < rows ? __ldg(mwords + (size_t)r * Tile<W>::CG + tx) : 0u;
        const unsigned hi = r + 1 < rows ? __ldg(mwords + (size_t)(r + 1) * Tile<W>::CG + tx) : 0u;
        mw[i / 2] = lo | (hi << 16);
    }
}

// Mode 2: store m ? acc : 0 with the forward's mask bits (0 past h).
template <int W, class E>
__device__ __forceinline__ void epi_bwd(const float acc[RT][CT], const unsigned mw[RT / 2],
                                        E* act, int tx, int ty) {
#pragma unroll
    for (int j = 0; j < CT; ++j) {
        float v[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
            v[i] = ((mw[i / 2] >> ((i & 1) * 16 + j)) & 1u) ? acc[i][j] : 0.f;
        store_col<W>(act, col_of<W>(tx, j), ty, v);
    }
}

// out[row, j] = sum_{k < h} act[k, slot] * Wm[k, j] (+ bias[j]) for j < dn;
// Wm is (h, dn) row-major. With JVP only the tangent slots are read (data row
// d in slot 8 (d / 4) + 4 + d % 4). Eight lanes share one output and reduce
// by a fixed butterfly.
template <int W, bool BF>
__device__ __forceinline__ void reduce_out(const Elem<BF>* __restrict__ Wm,
                                           const float* __restrict__ bias, const Elem<BF>* act,
                                           float* __restrict__ out, int row0, int rows, int dn,
                                           int h, int tid, bool jvp) {
    const int g = tid & 7;
    const int nrows = jvp ? Tile<W>::TR / 2 : Tile<W>::TR;
    for (int o = tid >> 3; o < nrows * dn; o += NT / 8) {
        const int d = o / dn, j = o - d * dn;
        const int t = jvp ? (d >> 2) * 8 + 4 + (d & 3) : d;
        float s = 0.f;
        for (int k = g; k < h; k += 8)
            s = fmaf(to_f(act[act_at<W, BF>(k, t)]), ldg_f(Wm + k * dn + j), s);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        if (g == 0 && row0 + d < rows) out[(size_t)(row0 + d) * dn + j] = bias ? s + __ldg(bias + j) : s;
    }
}

template <int W, bool FULL, bool BF>
__global__ void __launch_bounds__(NT, 1)
    symmpen_kernel(Chain ch, int mode, const float* __restrict__ in0, const float* __restrict__ in1,
                   float* __restrict__ out, uint16_t* __restrict__ masks, int rows) {
    using T = Tile<W>;
    using E = Elem<BF>;
    extern __shared__ float4 smem4[];
    E* act = reinterpret_cast<E*>(smem4);
    E* wbuf = act + T::TR * W;
    auto Wf = [&](int k) { return static_cast<const E*>(ch.Wf[k]); };
    auto Wb = [&](int k) { return static_cast<const E*>(ch.Wb[k]); };
    const int tid = threadIdx.x, tx = tid % T::CG, ty = tid / T::CG;
    const int h = FULL ? W : ch.h;
    const int K = ch.n_w - 1;  // the output layer; hidden layers 0 .. K-1
    const bool jvp = mode == 1;
    const int np = jvp ? RT / 2 : RT;  // data rows per thread
    const int row0 = blockIdx.x * T::RG * np;
    const int drow0 = row0 + ty * np;
    const size_t plane = (size_t)rows * T::CG;  // mask words per hidden layer

    // The h x h products in order (modes 0, 1: W_1 .. W_{K-1}; mode 2:
    // W_{K-1}^T .. W_1^T) as one stream of K-blocks, STAGES - 1 ahead.
    const int nkb = (h + KB - 1) / KB, nblk = (K - 1) * nkb;
    auto fetch = [&](int blk) {
        if (blk < nblk) {
            const int s = blk / nkb;
            load_block<W, FULL, BF>(wbuf + (blk % STAGES) * T::BLK,
                                    mode == 2 ? Wb(K - 1 - s) : Wf(1 + s), (blk - s * nkb) * KB,
                                    h, tid);
        }
        cp_async_commit();
    };
#pragma unroll
    for (int b = 0; b < STAGES - 1; ++b) fetch(b);

    float acc[RT][CT];
    unsigned mw[RT / 2];
    if (mode == 2) {
        load_masks<W>(masks + (K - 1) * plane, drow0, rows, tx, mw);
        small_in<W, FULL, BF>(in0, in0, drow0, drow0 + 4, rows, ch.d_out, Wb(K), h, acc, tx);
        epi_bwd<W>(acc, mw, act, tx, ty);
    } else if (jvp) {
        small_in<W, FULL, BF>(in0, in1, drow0, drow0, rows, ch.d_in, Wf(0), h, acc, tx);
        epi_fwd<W, FULL, true>(acc, ch.b[0], act, masks, drow0, rows, h, tx, ty);
    } else {
        small_in<W, FULL, BF>(in0, in0, drow0, drow0 + 4, rows, ch.d_in, Wf(0), h, acc, tx);
        epi_fwd<W, FULL, false>(acc, ch.b[0], act, masks, drow0, rows, h, tx, ty);
    }
    for (int s = 0; s < K - 1; ++s) {
        if (mode == 2) load_masks<W>(masks + (K - 2 - s) * plane, drow0, rows, tx, mw);
        zero_acc(acc);
        for (int kb = 0; kb < nkb; ++kb) {
            const int blk = s * nkb + kb;
            cp_async_wait<STAGES - 2>();
            __syncthreads();  // block blk landed for every thread; block blk - 1's stage is free
            fetch(blk + STAGES - 1);
            mma_block<W>(act, wbuf + (blk % STAGES) * T::BLK, kb * KB, acc, tx, ty);
        }
        __syncthreads();  // every thread has read this layer's input
        if (mode == 2)
            epi_bwd<W>(acc, mw, act, tx, ty);
        else if (jvp)
            epi_fwd<W, FULL, true>(acc, ch.b[1 + s], act, masks + (1 + s) * plane, drow0, rows, h,
                                   tx, ty);
        else
            epi_fwd<W, FULL, false>(acc, ch.b[1 + s], act, masks + (1 + s) * plane, drow0, rows, h,
                                    tx, ty);
    }
    __syncthreads();
    if (mode == 2)
        reduce_out<W, BF>(Wb(0), nullptr, act, out, row0, rows, ch.d_in, h, tid, false);
    else
        reduce_out<W, BF>(Wf(K), jvp ? nullptr : ch.b[K], act, out, row0, rows, ch.d_out, h, tid,
                          jvp);
}

// data rows one CTA takes: primal and tangent rows share the tile in mode 1
template <int W>
static int data_rows(int mode) {
    return mode == 1 ? Tile<W>::TR / 2 : Tile<W>::TR;
}

template <int W, bool FULL, bool BF = false>
static int launch(const Chain& ch, int mode, const float* in0, const float* in1, float* out,
                  uint16_t* masks, int rows, cudaStream_t stream) {
    using T = Tile<W, BF>;
    static bool smem_set = false;
    if (!smem_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            symmpen_kernel<W, FULL, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)T::SMEM);
        if (err != cudaSuccess) return (int)err;
        smem_set = true;
    }
    const int drows = data_rows<W>(mode);
    symmpen_kernel<W, FULL, BF><<<(rows + drows - 1) / drows, NT, T::SMEM, stream>>>(
        ch, mode, in0, in1, out, masks, rows);
    return (int)cudaGetLastError();
}

// mode 0: in0 = x (rows, d_in), out (rows, d_out); mode 1: in0 = z, in1 = u
// (rows, d_in), out (rows, d_out); both write masks. mode 2: in0 = cotangent
// (rows, d_out), out (rows, d_in), reads masks. masks: (n_w - 1) planes of
// rows x W / 16 16-bit words. Wf, Wb, b: n_w device pointers each; every
// hidden layer is h wide, 1 <= h <= W, W the tile width (128, 256 or 512).
// bf16 = 0: f32 weights of width h. bf16 = 1: bf16 weights and f32 biases
// with every hidden width zero-padded to W. Inputs and outputs are f32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int symmpen_launch(int mode, const float* in0, const float* in1, float* out,
                              void* masks, int rows, const uint64_t* Wf, const uint64_t* Wb,
                              const uint64_t* b, int n_w, int d_in, int d_out, int h, int W,
                              int bf16, void* stream) {
    if (n_w < 2 || n_w > MAXW || d_in < 1 || d_in > MAXD || d_out < 1 || d_out > MAXD || h < 1 ||
        h > W || (W != 128 && W != 256 && W != 512) || mode < 0 || mode > 2 || rows < 1)
        return (int)cudaErrorInvalidValue;
    Chain ch;
    for (int k = 0; k < n_w; ++k) {
        ch.Wf[k] = reinterpret_cast<const void*>(Wf[k]);
        ch.Wb[k] = reinterpret_cast<const void*>(Wb[k]);
        ch.b[k] = reinterpret_cast<const float*>(b[k]);
    }
    for (int k = n_w; k < MAXW; ++k) ch.Wf[k] = ch.Wb[k] = ch.b[k] = nullptr;
    ch.n_w = n_w;
    ch.d_in = d_in;
    ch.d_out = d_out;
    ch.h = h;
    uint16_t* m = static_cast<uint16_t*>(masks);
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16) {  // the padded weights: every width is the tile's
        ch.h = W;
        if (W == 512) return launch<512, true, true>(ch, mode, in0, in1, out, m, rows, st);
        if (W == 256) return launch<256, true, true>(ch, mode, in0, in1, out, m, rows, st);
        return launch<128, true, true>(ch, mode, in0, in1, out, m, rows, st);
    }
    const bool full = h == W;
    if (W == 512)
        return full ? launch<512, true>(ch, mode, in0, in1, out, m, rows, st)
                    : launch<512, false>(ch, mode, in0, in1, out, m, rows, st);
    if (W == 256)
        return full ? launch<256, true>(ch, mode, in0, in1, out, m, rows, st)
                    : launch<256, false>(ch, mode, in0, in1, out, m, rows, st);
    return full ? launch<128, true>(ch, mode, in0, in1, out, m, rows, st)
                : launch<128, false>(ch, mode, in0, in1, out, m, rows, st);
}

// Data rows one CTA of `mode` takes at tile width W (128, 256 or 512), or -1.
extern "C" int symmpen_row_tile(int W, int mode) {
    if (mode < 0 || mode > 2) return -1;
    if (W == 512) return data_rows<512>(mode);
    if (W == 256) return data_rows<256>(mode);
    if (W == 128) return data_rows<128>(mode);
    return -1;
}
