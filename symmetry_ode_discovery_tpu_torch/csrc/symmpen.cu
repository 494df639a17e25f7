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
// Two designs share the row tiles and the mask format: FMA tiles (every f32
// mode) and tensor-core tiles (every bf16 mode, `chain_tc`, further below).
//
// FMA tiles (f32). What bounds them: operations. One chain pass is 2 * (2*512 +
// 4*512*512 + 512*2) = 2.10 MFLOP per row at the LV width, in f32 on the FMA
// pipe (no TF32: the reference's numerics), against 67 TFLOP/s on the H100
// SXM. The weights (4.2 MB a chain) stay in the 50 MB L2 and are streamed
// through shared memory by every CTA; what the design does about it:
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
//     it reads 2 + 4 float4 from shared memory for 128 FMAs, summing k in
//     order, as cuBLAS's f32 product does.
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
// bf16 (template BF; the JAX kernels' dtype=bfloat16): the rounding points of
// the JAX bodies. The wrapper passes the folded f32 weights rounded to bf16,
// every hidden width zero-padded to W (so rows are 16-byte aligned at any h
// and padded columns stay exactly 0, their mask bits 0); inputs are rounded
// to bf16 as they are read; activations (after ReLU, after a mask, before
// each transposed hop) are rounded to bf16 as they are stored in the tile,
// which is bf16. Bias, masks [p > 0] of the f32 pre-activation, accumulators
// and outputs are f32. Every W x W product of every mode runs on the tensor
// cores, as the reference's own jnp.dot(bf16, bf16,
// preferred_element_type=f32) runs on the MXU: its sums are in the tensor
// cores' order, not the plain chain's (an f32 product on bf16 values, in k
// order), so a forward flips the odd mask whose pre-activation lies within
// rounding of 0, and the rows such a mask gates (in the tangent and in the
// backwards) move with it; the smoke run's bf16 gate counts them
// (chip_smoke.py, ops/symmpen.py::mask_flips). The forwards, which decide the
// masks, add each k-step's tensor-core sum into the accumulator in f32
// (round to nearest; mma_kblock_fold), which flips about a quarter of the
// bits the tensor cores' own accumulation flips; mode 2 reads the masks and
// accumulates in the tensor cores.
//
// Layouts (FMA tiles). Activations are k-major in shared memory, row groups
// of 4 XOR-ed with (k / 4) % 4, so the epilogue's column stores spread over
// the banks.
// Masks: one 16-bit word per (hidden layer, data row, column group tx), bit
// j for column (j / 4) * (W / 4) + 4 tx + j % 4: the columns of the thread
// that computes and consumes them in every FMA mode, so the word is written
// and read whole and row-indexed (modes 1 and 2 tile rows differently); the
// tensor-core tiles write and read the same words (two lanes' columns each).
//
// Tensor-core tiles (bf16). mma.sync.m16n8k16 bf16 x bf16 with f32
// accumulators at 989 TFLOP/s dense: the operations bound is 1/15 of f32's,
// and what bounds the design is the issue of mma.sync and the stream of
// weights out of L2 (2 MiB of hidden weights a CTA and pass at the LV
// shape). So:
//   - The tile keeps 64 rows at W = 512 (128 at 256, 256 at 128), 64 KB of
//     bf16: the 64 x 512 f32 accumulator block is half the register file,
//     which bounds the row tile. The 8 warps split it into 64 x 64 blocks:
//     NWC = W / 64 warps across the columns, 8 / NWC across the rows. Per
//     k-step of 16 a warp loads 4 A fragments (ldmatrix.x4, one per 16-row
//     m-tile) and 8 B fragments (4 ldmatrix.x4.trans, two 8-column n-tiles
//     each) for 32 mma.sync: each A fragment serves 8 n-tiles, each B
//     fragment 4 m-tiles; 128 f32 accumulators a thread.
//   - The forwards walk W_1 .. W_{K-1}, mode 2 their transposes W_{K-1}^T ..
//     W_1^T; each is k-major (d_k, d_{k+1}), so one weight stream serves all
//     three modes. The first layer (d_in or d_out wide, at most 8) and the
//     last run on FMAs (small_in_bf16, reduce_out_bf16).
//   - Mode 1 places each data row's primal and tangent 8 rows apart in an
//     m-tile (primal rows 16 m .. 16 m + 7, their tangents 16 m + 8 ..), so
//     a lane holds p and t W of the same (row, column) in C fragment
//     elements 0-1 and 2-3: the epilogue masks the tangent in registers by
//     the bit the primal just set. TR / 2 data rows a CTA, as in the FMA
//     tiles.
//   - The forwards' epilogue runs in registers on the C fragments: the f32
//     bias, the mask bit [p > 0] of the f32 pre-activation, ReLU, the
//     rounding to bf16 and the store into the tile; a lane's bits fill half
//     of each of its two mask words, the other half is its neighbour's
//     (lane ^ 1), so the pair swaps halves by one shuffle and each writes
//     one whole word.
//   - Activations are row-major, a row W bf16 in 16-byte chunks, chunk c of
//     row t at chunk c ^ (t % 8): the 8 row addresses of each ldmatrix phase
//     fall in 8 distinct 16-byte bank groups, and so do the epilogue's 4-byte
//     stores of C-fragment pairs (8 rows x 4 lanes of one chunk).
//   - A warp's 8 n-tiles are 2 in each quarter of the columns (n-tile j at
//     column (j / 2) * W / 4 + 16 wc + 8 (j % 2)), so the lanes of a warp hold
//     every column of the mask words of their rows: each lane pair reads and
//     writes two whole words a row.
//   - Weights stream through a ring of BSTAGES K-blocks of BKB rows by
//     cp.async.bulk, one bulk copy a row into rows padded by 16 bytes (the 8
//     rows of an ldmatrix.trans phase then fall in distinct bank groups),
//     completing on an mbarrier per stage; each warp frees a stage on a second
//     mbarrier when it has read it, and warp 0 refills the stage freed one
//     block earlier, across layer boundaries. 4 stages of 32 rows are 130 KB
//     at W = 512: 195 KB of shared memory with the tile.
//   - Clusters of CLUSTER CTAs (a compile-time constant, 1 or 2; 2 measured
//     faster on the card): each CTA of the pair bulk-copies half the rows of
//     every K-block with .multicast::cluster into both, so a pair reads each
//     weight byte from L2 once; a stage is refilled when both CTAs' warps
//     have freed it. The grid is rounded up to whole clusters; a CTA past the
//     rows computes zeros and stores nothing.
// Deterministic: fixed-order sums, no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256       // threads per CTA
#define RT 8         // tile rows per thread
#define CT 16        // columns per thread: 4 float4 groups W / 4 apart
#define KB 16        // weight rows per K-block
#define STAGES 2     // K-blocks in the ring
#define MAXW 10      // at most n_layers + 1 weight matrices
#define MAXD 8       // at most 8 input or output features
#define NWARP (NT / 32)
#define BKB 32       // bf16: weight rows per K-block
#define BSTAGES 4    // bf16: K-blocks in the bulk-copy ring
#define CLUSTER 2    // bf16: CTAs per cluster (1 or 2), sharing each K-block by multicast

template <int W>
struct Tile {
    static constexpr int CG = W / CT;    // column groups = mask words per row
    static constexpr int RG = NT / CG;   // row groups
    static constexpr int TR = RG * RT;   // tile rows: 64, 128, 256 at W = 512, 256, 128
    static constexpr int BLK = KB * W;   // elements per weight stage
    static constexpr size_t SMEM = (size_t)(TR * W + STAGES * BLK) * sizeof(float);
};

template <int W>
struct BfTile {
    static constexpr int NWC = W / 64;               // warps across the columns: 8, 4, 2
    static constexpr int TR = 64 * (NWARP / NWC);    // tile rows: 64, 128, 256
    static constexpr int CG = W / 16;                // mask words per row
    static constexpr int ROWB = 2 * W;               // bytes of an activation row
    static constexpr int WROWB = 2 * W + 16;         // bytes of a staged weight row (padded)
    static constexpr int STAGEB = BKB * WROWB;       // bytes of a stage
    static constexpr int ACTB = TR * ROWB;           // bytes of the activation tile (64 KB)
    static constexpr size_t SMEM = (size_t)ACTB + BSTAGES * STAGEB + 2 * BSTAGES * 8;
};
static_assert(BfTile<512>::TR == Tile<512>::TR && BfTile<256>::TR == Tile<256>::TR &&
                  BfTile<128>::TR == Tile<128>::TR,
              "both designs take the same rows a CTA");
static_assert(CLUSTER == 1 || CLUSTER == 2, "CLUSTER is 1 or 2");
static_assert(BKB % 16 == 0 && BKB % CLUSTER == 0 && BKB / CLUSTER <= 32,
              "a K-block is whole k-steps of 16, each CTA's rows one per lane of warp 0");

struct Chain {
    const void* Wf[MAXW];  // W_k, (d_k, d_{k+1}) row-major: k-major for the forward product
    const void* Wb[MAXW];  // W_k^T, (d_{k+1}, d_k) row-major: k-major for the transposed product
    const float* b[MAXW];
    int n_w, d_in, d_out, h;  // h: hidden width, 1..W (W in bf16: the weights are padded)
};

// v rounded to bf16 (round to nearest even), as f32
__device__ __forceinline__ float bf_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
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
template <int W>
__device__ __forceinline__ int act_at(int k, int t) {
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
template <int W, bool FULL>
__device__ __forceinline__ void load_block(float* dst, const float* __restrict__ Wm, int kb, int h,
                                           int tid) {
    if constexpr (FULL) {
        const float* src = Wm + (size_t)kb * W;
#pragma unroll
        for (int q = tid; q < KB * W / 4; q += NT) cp_async16(dst + 4 * q, src + 4 * q, true);
    } else {  // rows of Wm need not be 16-byte aligned: one float at a time
        for (int q = tid; q < KB * W; q += NT) {
            const int k = kb + q / W, c = q % W;
            const bool in = k < h && c < h;
            cp_async4(dst + q, in ? Wm + (size_t)k * h + c : Wm, in);
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
// r_lo .. r_lo + 3 of in_lo, slots 4-7 rows r_hi .. r_hi + 3 of in_hi; rows
// past `rows` and columns past h read as 0. Wm is (din, h) row-major.
template <int W, bool FULL>
__device__ __forceinline__ void small_in(const float* __restrict__ in_lo,
                                         const float* __restrict__ in_hi, int r_lo, int r_hi,
                                         int rows, int din, const float* __restrict__ Wm, int h,
                                         float acc[RT][CT], int tx) {
    zero_acc(acc);
    for (int t = 0; t < din; ++t) {
        float w[CT];
#pragma unroll
        for (int j = 0; j < CT; ++j) {
            const int c = col_of<W>(tx, j);
            w[j] = (FULL || c < h) ? __ldg(Wm + t * h + c) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RT; ++i) {
            const int r = (i < 4 ? r_lo : r_hi) + (i & 3);
            const float* src = i < 4 ? in_lo : in_hi;
            const float a = (r < rows) ? __ldg(src + (size_t)r * din + t) : 0.f;
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

// the thread's 8 values of column c into act (tile rows 8 ty .. 8 ty + 7)
template <int W>
__device__ __forceinline__ void store_col(float* act, int c, int ty, const float v[RT]) {
    float4* dst = reinterpret_cast<float4*>(act + c * Tile<W>::TR);
    const int s = (c >> 2) & 3;
    dst[(ty * 2) ^ s] = make_float4(v[0], v[1], v[2], v[3]);
    dst[(ty * 2 + 1) ^ s] = make_float4(v[4], v[5], v[6], v[7]);
}

// Modes 0 and 1, after the product of hidden layer l: p = acc + b_l. Each
// primal slot stores relu(p) (NaN stays NaN, as jnp.maximum and torch.relu
// keep it) and records m = [p > 0]; with JVP, tangent slot i + 4 (the data
// row of primal slot i) stores m ? acc : 0. The thread's mask words go to
// mwords (layer l's plane), data rows drow0 .. drow0 + NP - 1. Columns c >= h
// store 0 with bit 0 (acc there may hold 0 * NaN).
template <int W, bool FULL, bool JVP>
__device__ __forceinline__ void epi_fwd(const float acc[RT][CT], const float* __restrict__ bias,
                                        float* act, uint16_t* __restrict__ mwords, int drow0,
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
template <int W>
__device__ __forceinline__ void epi_bwd(const float acc[RT][CT], const unsigned mw[RT / 2],
                                        float* act, int tx, int ty) {
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
template <int W>
__device__ __forceinline__ void reduce_out(const float* __restrict__ Wm,
                                           const float* __restrict__ bias, const float* act,
                                           float* __restrict__ out, int row0, int rows, int dn,
                                           int h, int tid, bool jvp) {
    const int g = tid & 7;
    const int nrows = jvp ? Tile<W>::TR / 2 : Tile<W>::TR;
    for (int o = tid >> 3; o < nrows * dn; o += NT / 8) {
        const int d = o / dn, j = o - d * dn;
        const int t = jvp ? (d >> 2) * 8 + 4 + (d & 3) : d;
        float s = 0.f;
        for (int k = g; k < h; k += 8) s = fmaf(act[act_at<W>(k, t)], __ldg(Wm + k * dn + j), s);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        if (g == 0 && row0 + d < rows) out[(size_t)(row0 + d) * dn + j] = bias ? s + __ldg(bias + j) : s;
    }
}

template <int W, bool FULL>
__device__ __forceinline__ void chain_fma(const Chain& ch, int mode, const float* __restrict__ in0,
                                          const float* __restrict__ in1, float* __restrict__ out,
                                          uint16_t* __restrict__ masks, int rows, float4* smem4) {
    using T = Tile<W>;
    float* act = reinterpret_cast<float*>(smem4);
    float* wbuf = act + T::TR * W;
    auto Wf = [&](int k) { return static_cast<const float*>(ch.Wf[k]); };
    auto Wb = [&](int k) { return static_cast<const float*>(ch.Wb[k]); };
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
            load_block<W, FULL>(wbuf + (blk % STAGES) * T::BLK,
                                mode == 2 ? Wb(K - 1 - s) : Wf(1 + s), (blk - s * nkb) * KB, h,
                                tid);
        }
        cp_async_commit();
    };
#pragma unroll
    for (int b = 0; b < STAGES - 1; ++b) fetch(b);

    float acc[RT][CT];
    unsigned mw[RT / 2];
    if (mode == 2) {
        load_masks<W>(masks + (K - 1) * plane, drow0, rows, tx, mw);
        small_in<W, FULL>(in0, in0, drow0, drow0 + 4, rows, ch.d_out, Wb(K), h, acc, tx);
        epi_bwd<W>(acc, mw, act, tx, ty);
    } else if (jvp) {
        small_in<W, FULL>(in0, in1, drow0, drow0, rows, ch.d_in, Wf(0), h, acc, tx);
        epi_fwd<W, FULL, true>(acc, ch.b[0], act, masks, drow0, rows, h, tx, ty);
    } else {
        small_in<W, FULL>(in0, in0, drow0, drow0 + 4, rows, ch.d_in, Wf(0), h, acc, tx);
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
        reduce_out<W>(Wb(0), nullptr, act, out, row0, rows, ch.d_in, h, tid, false);
    else
        reduce_out<W>(Wf(K), jvp ? nullptr : ch.b[K], act, out, row0, rows, ch.d_out, h, tid, jvp);
}

// ---------------------------------------------------------------------------
// bf16: tensor-core tiles (mma.sync), bulk-copied weight ring, clusters
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of bulk copies on the barrier's phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
}

// one arrival on the barrier at the same offset in CTA `cta` of the cluster
// (this CTA's own when CLUSTER is 1). The default (CTA-scope) release, as
// CUTLASS's cluster pipelines arrive: a stage's readers arrive after the
// mma.sync that consumed their ldmatrix results, so their reads are done; a
// cluster-scope release compiles to a MEMBAR.GPU a warp and block.
__device__ __forceinline__ void mbar_arrive(uint32_t bar, uint32_t cta) {
    if constexpr (CLUSTER > 1) {
        uint32_t remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(bar), "r"(cta));
        asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote) : "memory");
    } else {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
    }
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// bytes from global src to shared dst (both 16-byte aligned), completing on
// bar; with CLUSTER 2 into every CTA of the pair, at the same offsets
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    if constexpr (CLUSTER > 1) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
            " [%0], [%1], %2, [%3], %4;" ::"r"(dst),
            "l"(src), "r"(bytes), "r"(bar), "h"((uint16_t)((1u << CLUSTER) - 1))
            : "memory");
    } else {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];" ::"r"(dst),
            "l"(src), "r"(bytes), "r"(bar)
            : "memory");
    }
}

// every thread of the cluster (of the CTA when CLUSTER is 1)
__device__ __forceinline__ void cluster_sync() {
    if constexpr (CLUSTER > 1) {
        asm volatile("barrier.cluster.arrive.release.aligned;\n"
                     "barrier.cluster.wait.acquire.aligned;" ::
                         : "memory");
    } else {
        __syncthreads();
    }
}

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r = 0;
    if constexpr (CLUSTER > 1) asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

// four 8 x 8 bf16 matrices, lanes 8 i .. 8 i + 7 giving the row addresses of
// matrix i; .trans: each thread gets the transposed matrices' elements
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// c += a (16 x 16, row) x b (16 x 8, col), bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's place in the tile: rows 64 wr .. 64 wr + 63 (4 m-tiles of 16),
// its 8 n-tiles; the lane's fragment row g (and g + 8) and column pair tig.
template <int W>
struct Frag {
    int wr, wc, g, tig;
    __device__ Frag(int tid) {
        const int warp = tid >> 5, lane = tid & 31;
        wc = warp % BfTile<W>::NWC;
        wr = warp / BfTile<W>::NWC;
        g = lane >> 2;
        tig = lane & 3;
    }
    // the first column of n-tile j
    __device__ int ncol(int j) const { return (j >> 1) * (W / 4) + 16 * wc + 8 * (j & 1); }
    // the lane's column of n-tile j (and the next)
    __device__ int col(int j) const { return ncol(j) + 2 * tig; }
    // tile row of m-tile mi, fragment half hi (0: row g, 1: row g + 8)
    __device__ int row(int mi, int hi) const { return 64 * wr + 16 * mi + g + 8 * hi; }
    // mode 1: the data row (in the CTA) of m-tile mi, its primal in fragment
    // half 0 and its tangent in half 1
    __device__ int jrow(int mi) const { return 32 * wr + 8 * mi + g; }
    // the first of the lane's two mask words of a row (the other is 2 above)
    __device__ int tx0() const { return 4 * wc + (tig >> 1); }
    // bit of column col(j) in its word (+1 for the next column), the word
    // of n-tile j in the high half when j is odd: bit(j) + lane_bit()
    static __device__ int bit(int j) { return 16 * (j & 1) + 4 * (j >> 1); }
    __device__ int lane_bit() const { return 2 * (tig & 1); }
};

// threadIdx.x read where it is used: the epilogues build their fragment
// coordinates from it, so the compiler cannot hoist their 64 addresses out of
// the layer loop and keep them live across the products (they would spill)
__device__ __forceinline__ int local_tid() {
    int t;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
    return t;
}

// byte offset of the 4 bytes at (tile row t, column c, c even) of the
// swizzled row-major activation tile
template <int W>
__device__ __forceinline__ uint32_t act_off(int t, int c) {
    return t * BfTile<W>::ROWB + ((((c >> 3) ^ (t & 7))) << 4) + ((c & 7) << 1);
}

typedef float Acc[4][8][4];  // [m-tile][n-tile][C fragment]

// the tile's first layer: acc = in x Wm, Wm (din, W) bf16, the inputs rounded
// to bf16 (0 past `rows`), f32 FMAs. Fragment row (mi, hi) reads data row
// row0 + its tile row of in_lo; with JVP (mode 1) the primal half reads data
// row row0 + jrow(mi) of in_lo, the tangent half the same row of in_hi.
template <int W, bool JVP>
__device__ __forceinline__ void small_in_bf16(const float* __restrict__ in_lo,
                                              const float* __restrict__ in_hi, int row0, int rows,
                                              int din, const __nv_bfloat16* __restrict__ Wm,
                                              Acc& acc) {
    const Frag<W> f(local_tid());
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
    for (int t = 0; t < din; ++t) {
        float w[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const unsigned v = __ldg(reinterpret_cast<const unsigned*>(Wm + t * W + f.col(j)));
            w[j][0] = bf_lo(v);
            w[j][1] = bf_hi(v);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
                const int r = row0 + (JVP ? f.jrow(mi) : f.row(mi, hi));
                const float* src = (JVP && hi) ? in_hi : in_lo;
                const float a = r < rows ? bf_round(__ldg(src + (size_t)r * din + t)) : 0.f;
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e)
                        acc[mi][j][2 * hi + e] = fmaf(a, w[j][e], acc[mi][j][2 * hi + e]);
            }
    }
}

// acc += act[:, k0 .. k0 + BKB) x stage (BKB x W): two k-steps of 16, each 4
// ldmatrix.x4 (A, one per m-tile), 4 ldmatrix.x4.trans (B, two n-tiles each)
// and 32 mma.sync, the tensor core adding acc into each step's sum itself
// (mode 2)
template <int W>
__device__ __forceinline__ void mma_kblock(uint32_t act_s, uint32_t stage_s, int k0, Acc& acc,
                                           const Frag<W>& f, int lane) {
#pragma unroll
    for (int ks = 0; ks < BKB; ks += 16) {
        uint32_t a[4][4], b[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
            const int t = 64 * f.wr + 16 * mi + (lane & 15);
            const int c = ((k0 + ks) >> 3) + (lane >> 4);
            ldsm_x4(act_s + t * BfTile<W>::ROWB + ((c ^ (t & 7)) << 4), a[mi]);
        }
        const int kr = ks + (lane & 7) + (lane & 8);
#pragma unroll
        for (int q = 0; q < 4; ++q)
            ldsm_x4_trans(stage_s + kr * BfTile<W>::WROWB + 2 * f.ncol(2 * q + (lane >> 4)), b[q]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int j = 0; j < 8; ++j)
                mma_bf16(acc[mi][j], a[mi], b[j >> 1][2 * (j & 1)], b[j >> 1][2 * (j & 1) + 1]);
    }
}

// mma_kblock for the forwards, which decide the masks: each mma.sync sums its
// k-step into zeroed registers and an f32 add (round to nearest) takes that
// sum into acc, so acc is rounded as an f32 sum of 16-term partial sums is
// (on the LV checkpoint's encoder this flips a quarter of the mask bits the
// tensor cores' own accumulation flips). The sums' registers fit beside the
// 128 of acc with each A fragment loaded just before its 8 products and the
// two k-steps a loop: unrolled, ptxas overlaps their fragments and spills.
template <int W>
__device__ __forceinline__ void mma_kblock_fold(uint32_t act_s, uint32_t stage_s, int k0,
                                                Acc& acc, const Frag<W>& f, int lane) {
#pragma unroll 1
    for (int ks = 0; ks < BKB; ks += 16) {
        uint32_t b[4][4];
        const int kr = ks + (lane & 7) + (lane & 8);
#pragma unroll
        for (int q = 0; q < 4; ++q)
            ldsm_x4_trans(stage_s + kr * BfTile<W>::WROWB + 2 * f.ncol(2 * q + (lane >> 4)), b[q]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
            const int t = 64 * f.wr + 16 * mi + (lane & 15);
            const int c = ((k0 + ks) >> 3) + (lane >> 4);
            uint32_t a[4];
            ldsm_x4(act_s + t * BfTile<W>::ROWB + ((c ^ (t & 7)) << 4), a);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                float d[4] = {0.f, 0.f, 0.f, 0.f};
                mma_bf16(d, a, b[j >> 1][2 * (j & 1)], b[j >> 1][2 * (j & 1) + 1]);
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mi][j][e] += d[e];
            }
        }
    }
}

// the lane's mask words of one layer's plane (the FMA forward's format): the
// two words of fragment row (mi, hi) in mw[mi][hi], word tx0 low, tx0 + 2
// high (0 past rows)
template <int W>
__device__ __forceinline__ void load_masks_bf16(const uint16_t* __restrict__ mwords, int row0,
                                                int rows, unsigned (&mw)[4][2]) {
    constexpr int CG = BfTile<W>::CG;
    const Frag<W> f(local_tid());
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
            const int r = row0 + f.row(mi, hi);
            const uint16_t* p = mwords + (size_t)r * CG + f.tx0();
            mw[mi][hi] = r < rows ? (unsigned)__ldg(p) | ((unsigned)__ldg(p + 2) << 16) : 0u;
        }
}

// Mode 2: store m ? acc : 0 (rounded to bf16) with the forward's mask bits
// (0 past h and past rows).
template <int W>
__device__ __forceinline__ void epi_bwd_bf16(const Acc& acc, const unsigned (&mw)[4][2],
                                             unsigned char* act) {
    const Frag<W> f(local_tid());
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
        const unsigned m[2] = {mw[mi][0] >> f.lane_bit(), mw[mi][1] >> f.lane_bit()};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
                v[e] = ((m[e >> 1] >> (Frag<W>::bit(j) + (e & 1))) & 1u) ? acc[mi][j][e] : 0.f;
            const int c = f.col(j);
            *reinterpret_cast<unsigned*>(act + act_off<W>(f.row(mi, 0), c)) = bf_pack(v[0], v[1]);
            *reinterpret_cast<unsigned*>(act + act_off<W>(f.row(mi, 1), c)) = bf_pack(v[2], v[3]);
        }
    }
}

// Modes 0 and 1, after the product of hidden layer l, in registers on the C
// fragments: p = acc + b_l (f32) on the primal elements, the mask bit
// [p > 0] of the f32 p, relu(p) (NaN stays NaN) rounded to bf16 into the
// tile; with JVP the tangent elements (fragment half 1, 8 rows below their
// primal) store m ? acc : 0 by the bit just set. Each lane holds half the bits
// of its two mask words of a row (lane_bit), its neighbour lane ^ 1 the other
// half: one shuffle gives both lanes the whole words, and the even lane
// writes word tx0, the odd one word tx0 + 2, of layer l's plane (data rows
// past `rows` write nothing). Padded columns hold p = 0: bit 0, value 0.
template <int W, bool JVP>
__device__ __forceinline__ void epi_fwd_bf16(const Acc& acc, const float* __restrict__ bias,
                                             unsigned char* act, uint16_t* __restrict__ mwords,
                                             int row0, int rows) {
    constexpr int CG = BfTile<W>::CG;
    const Frag<W> f(local_tid());
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
        unsigned bits[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = f.col(j);
            const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + c));
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int b = Frag<W>::bit(j) + (e & 1);
                if (JVP && e >= 2) {
                    v[e] = ((bits[0] >> b) & 1u) ? acc[mi][j][e] : 0.f;
                } else {
                    const float p = acc[mi][j][e] + ((e & 1) ? bb.y : bb.x);
                    bits[e >> 1] |= (unsigned)(p > 0.f) << b;
                    v[e] = (p <= 0.f) ? 0.f : p;
                }
            }
            *reinterpret_cast<unsigned*>(act + act_off<W>(f.row(mi, 0), c)) = bf_pack(v[0], v[1]);
            *reinterpret_cast<unsigned*>(act + act_off<W>(f.row(mi, 1), c)) = bf_pack(v[2], v[3]);
        }
        const int odd = f.tig & 1;
#pragma unroll
        for (int hi = 0; hi < (JVP ? 1 : 2); ++hi) {
            unsigned w = bits[hi] << f.lane_bit();
            w |= __shfl_xor_sync(0xffffffffu, w, 1);
            const int r = row0 + (JVP ? f.jrow(mi) : f.row(mi, hi));
            if (r < rows) mwords[(size_t)r * CG + f.tx0() + 2 * odd] = (uint16_t)(w >> (16 * odd));
        }
    }
}

// out[row, j] = sum_{k < W} act[t, k] * Wm[k, j] (+ bias[j] in mode 0) for
// j < dn, Wm (W, dn) bf16 (padded rows 0); tile row t is the row's own, in
// mode 1 its tangent row (16 (d / 8) + 8 + d % 8 for the CTA's data row d).
// Eight lanes share one row, 16 bytes of it a step, and reduce by a fixed
// butterfly.
template <int W, int MODE>
__device__ __forceinline__ void reduce_out_bf16(const __nv_bfloat16* __restrict__ Wm,
                                                const float* __restrict__ bias,
                                                const unsigned char* act, float* __restrict__ out,
                                                int row0, int rows, int dn, int tid) {
    constexpr int NROWS = MODE == 1 ? BfTile<W>::TR / 2 : BfTile<W>::TR;
    const int g = tid & 7;
    for (int d = tid >> 3; d < NROWS; d += NT / 8) {
        const int t = MODE == 1 ? 16 * (d >> 3) + 8 + (d & 7) : d;
        const uint4* rowp = reinterpret_cast<const uint4*>(act + t * BfTile<W>::ROWB);
        float s[MAXD];
#pragma unroll
        for (int j = 0; j < MAXD; ++j) s[j] = 0.f;
        for (int c = g; c < W / 8; c += 8) {
            const uint4 v = rowp[c ^ (t & 7)];
            const float a[8] = {bf_lo(v.x), bf_hi(v.x), bf_lo(v.y), bf_hi(v.y),
                                bf_lo(v.z), bf_hi(v.z), bf_lo(v.w), bf_hi(v.w)};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < MAXD; ++j)
                    if (j < dn)
                        s[j] = fmaf(a[i], __bfloat162float(__ldg(Wm + (8 * c + i) * dn + j)), s[j]);
        }
#pragma unroll
        for (int j = 0; j < MAXD; ++j) {
            if (j < dn) {
                s[j] += __shfl_xor_sync(0xffffffffu, s[j], 4);
                s[j] += __shfl_xor_sync(0xffffffffu, s[j], 2);
                s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
                if constexpr (MODE == 0) s[j] += __ldg(bias + j);
                if (g == 0 && row0 + d < rows) out[(size_t)(row0 + d) * dn + j] = s[j];
            }
        }
    }
}

// Every bf16 mode, the W x W products on the tensor cores: MODE 0 the chain
// forward, 1 the decoder JVP (primal and tangent rows in one tile), both
// writing the masks; 2 the masked transpose chain out = ((c W_K^T) .
// m_{K-1}) W_{K-1}^T ... W_0^T with the forward's masks.
template <int W, int MODE>
__device__ __forceinline__ void chain_tc(const Chain& ch, const float* __restrict__ in0,
                                         const float* __restrict__ in1, float* __restrict__ out,
                                         uint16_t* __restrict__ masks, int rows,
                                         unsigned char* smem) {
    using T = BfTile<W>;
    using E = __nv_bfloat16;
    constexpr bool JVP = MODE == 1;
    auto Wf = [&](int k) { return static_cast<const E*>(ch.Wf[k]); };
    auto Wb = [&](int k) { return static_cast<const E*>(ch.Wb[k]); };
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const Frag<W> f(tid);
    const int K = ch.n_w - 1;  // the output layer; hidden layers 0 .. K-1
    const int row0 = blockIdx.x * (JVP ? T::TR / 2 : T::TR);
    const size_t plane = (size_t)rows * T::CG;  // mask words per hidden layer
    unsigned char* act = smem;
    const uint32_t act_s = smem_u32(act);
    const uint32_t wbuf_s = act_s + T::ACTB;
    const uint32_t full_s = wbuf_s + BSTAGES * T::STAGEB;  // BSTAGES barriers: stage landed
    const uint32_t empty_s = full_s + 8 * BSTAGES;         // BSTAGES barriers: stage read
    const uint32_t rank = cluster_rank();

    // The W x W products in order (forwards: W_1 .. W_{K-1}; mode 2: W_{K-1}^T
    // .. W_1^T) as one stream of K-blocks; block blk in stage blk % BSTAGES.
    // Warp 0 issues: this CTA's BKB / CLUSTER rows, one bulk copy a lane, and
    // the arrival that expects the whole block's bytes.
    const int nkb = W / BKB, nblk = (K - 1) * nkb;
    auto issue = [&](int blk) {
        const int s = blk % BSTAGES;
        const E* Wm = MODE == 2 ? Wb(K - 1 - blk / nkb) : Wf(1 + blk / nkb);
        if (lane == 0) mbar_expect_tx(full_s + 8 * s, BKB * W * 2);
        constexpr int PER = BKB / CLUSTER;
        if (lane < PER) {
            const int r = rank * PER + lane;
            bulk_copy(wbuf_s + s * T::STAGEB + r * T::WROWB,
                      Wm + (size_t)((blk % nkb) * BKB + r) * W, W * 2, full_s + 8 * s);
        }
    };
    if (tid == 0) {
        for (int s = 0; s < BSTAGES; ++s) {
            mbar_init(full_s + 8 * s, 1);
            mbar_init(empty_s + 8 * s, NWARP * CLUSTER);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster_sync();  // the barriers are initialised in every CTA of the cluster
    if (warp == 0)
        for (int b = 0; b < BSTAGES && b < nblk; ++b) issue(b);

    Acc acc;
    unsigned mw[4][2];
    if constexpr (MODE == 2) {
        load_masks_bf16<W>(masks + (K - 1) * plane, row0, rows, mw);
        small_in_bf16<W, false>(in0, in0, row0, rows, ch.d_out, Wb(K), acc);
        epi_bwd_bf16<W>(acc, mw, act);
    } else {
        small_in_bf16<W, JVP>(in0, JVP ? in1 : in0, row0, rows, ch.d_in, Wf(0), acc);
        epi_fwd_bf16<W, JVP>(acc, ch.b[0], act, masks, row0, rows);
    }
    __syncthreads();  // the first layer's activations (cotangents) are in the tile
    for (int s = 0; s < K - 1; ++s) {
        if constexpr (MODE == 2) load_masks_bf16<W>(masks + (K - 2 - s) * plane, row0, rows, mw);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
        for (int kb = 0; kb < nkb; ++kb) {
            const int blk = s * nkb + kb, st = blk % BSTAGES;
            mbar_wait(full_s + 8 * st, (blk / BSTAGES) & 1);
            if constexpr (MODE == 2)
                mma_kblock<W>(act_s, wbuf_s + st * T::STAGEB, kb * BKB, acc, f, lane);
            else
                mma_kblock_fold<W>(act_s, wbuf_s + st * T::STAGEB, kb * BKB, acc, f, lane);
            __syncwarp();
            if (lane < CLUSTER) mbar_arrive(empty_s + 8 * st, lane);  // this warp read stage st
            // refill the stage freed one block earlier once every warp of the
            // cluster has read it
            const int done = blk - 1, next = done + BSTAGES;
            if (warp == 0 && done >= 0 && next < nblk) {
                mbar_wait(empty_s + 8 * (done % BSTAGES), (done / BSTAGES) & 1);
                issue(next);
            }
        }
        __syncthreads();  // every warp has read this layer's input
        if constexpr (MODE == 2)
            epi_bwd_bf16<W>(acc, mw, act);
        else
            epi_fwd_bf16<W, JVP>(acc, ch.b[1 + s], act, masks + (1 + s) * plane, row0, rows);
        __syncthreads();  // the next layer's input is in the tile
    }
    if constexpr (MODE == 2)
        reduce_out_bf16<W, 2>(Wb(0), nullptr, act, out, row0, rows, ch.d_in, tid);
    else
        reduce_out_bf16<W, MODE>(Wf(K), ch.b[K], act, out, row0, rows, ch.d_out, tid);
    cluster_sync();  // no CTA leaves while its pair may still arrive on its barriers
}

// f32 (BF false): every mode on the FMA tiles. bf16: the forwards (FWD, modes 0
// and 1) and mode 2 are entries of their own, each compiled alone: in one
// entry with the forwards, mode 2 ran 7% slower at width 512 and 25% at 128
// on an H100 (the same code, compiled beside the forwards' loop).
template <int W, bool FULL, bool BF, bool FWD>
__global__ void __launch_bounds__(NT, 1)
    symmpen_kernel(Chain ch, int mode, const float* __restrict__ in0, const float* __restrict__ in1,
                   float* __restrict__ out, uint16_t* __restrict__ masks, int rows) {
    extern __shared__ float4 smem4[];
    if constexpr (BF) {
        unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
        if constexpr (!FWD)
            chain_tc<W, 2>(ch, in0, in1, out, masks, rows, smem);
        else if (mode == 1)
            chain_tc<W, 1>(ch, in0, in1, out, masks, rows, smem);
        else
            chain_tc<W, 0>(ch, in0, in1, out, masks, rows, smem);
    } else {
        chain_fma<W, FULL>(ch, mode, in0, in1, out, masks, rows, smem4);
    }
}

// data rows one CTA takes: primal and tangent rows share the tile in mode 1
template <int W>
static int data_rows(int mode) {
    return mode == 1 ? Tile<W>::TR / 2 : Tile<W>::TR;
}

// the kernel's dynamic shared memory limit, set once per instantiation
template <int W, bool FULL, bool BF, bool FWD>
static int set_smem_limit() {
    static bool done = false;
    if (!done) {
        const size_t smem = BF ? BfTile<W>::SMEM : Tile<W>::SMEM;
        const cudaError_t err = cudaFuncSetAttribute(symmpen_kernel<W, FULL, BF, FWD>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                     (int)smem);
        if (err != cudaSuccess) return (int)err;
        done = true;
    }
    return 0;
}

// the FMA tiles (every f32 mode)
template <int W, bool FULL>
static int launch(const Chain& ch, int mode, const float* in0, const float* in1, float* out,
                  uint16_t* masks, int rows, cudaStream_t stream) {
    const int err = set_smem_limit<W, FULL, false, false>();
    if (err) return err;
    const int drows = data_rows<W>(mode);
    symmpen_kernel<W, FULL, false, false><<<(rows + drows - 1) / drows, NT, Tile<W>::SMEM, stream>>>(
        ch, mode, in0, in1, out, masks, rows);
    return (int)cudaGetLastError();
}

// every bf16 mode on the tensor cores (FWD: modes 0 and 1): the grid rounded
// up to whole clusters of CLUSTER CTAs
template <int W, bool FWD>
static int launch_tc(const Chain& ch, int mode, const float* in0, const float* in1, float* out,
                     uint16_t* masks, int rows, cudaStream_t stream) {
    const int err = set_smem_limit<W, true, true, FWD>();
    if (err) return err;
    const int ctas = (rows + data_rows<W>(mode) - 1) / data_rows<W>(mode);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((ctas + CLUSTER - 1) / CLUSTER * CLUSTER);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = BfTile<W>::SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, symmpen_kernel<W, true, true, FWD>, ch, mode,
                                             in0, in1, out, masks, rows);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
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
        if (mode == 2) {
            if (W == 512) return launch_tc<512, false>(ch, mode, in0, in1, out, m, rows, st);
            if (W == 256) return launch_tc<256, false>(ch, mode, in0, in1, out, m, rows, st);
            return launch_tc<128, false>(ch, mode, in0, in1, out, m, rows, st);
        }
        if (W == 512) return launch_tc<512, true>(ch, mode, in0, in1, out, m, rows, st);
        if (W == 256) return launch_tc<256, true>(ch, mode, in0, in1, out, m, rows, st);
        return launch_tc<128, true>(ch, mode, in0, in1, out, m, rows, st);
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

// CTAs per cluster of the bf16 launches (every f32 launch is one CTA a cluster).
extern "C" int symmpen_cluster() { return CLUSTER; }
