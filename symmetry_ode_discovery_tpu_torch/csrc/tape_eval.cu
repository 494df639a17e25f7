// Postfix tape evaluation and its constant gradient, for Hopper (sm_90a).
//
// Replaces the TPU kernels of symmetry_ode_discovery_tpu/symgp/pallas_eval.py:
//   K5  _tape_kernel (:50), via eval_tapes_pallas (:153)
//   K6  _tape_grad_kernel (:222), via eval_tapes_pallas_grad (:416) and
//       make_diff_eval_pallas (:468)
//
// A tape is a postfix program of L slots (opcode, variable index, constant)
// run by a stack machine of depth D on every data row. The TPU kernels
// evaluate a tile of tapes at once with one-hot selects over the D stack
// slots and over the opcodes, because Mosaic has no dynamic indexing.
//
// What bounds it on this card. K5 writes one f32 prediction per (tape, row)
// and does one f32 operation per live step and row: at the shipped sizes
// (20 x 1024 tapes of 25 slots, about 4.3 of them not PAD, 2,500 rows) the
// 205 MB of predictions bound it (~0.06 ms at 3.35 TB/s). An interpreter
// that walks all L slots per row, with the arity, clamps and op-table test
// redone at each, is bound instead by instruction issue (about 24 warp
// instructions per slot and row). K6 moves little (tapes, 512-1,024 rows,
// gbar); its time is the latency of each tape's fixed work (staging,
// decoding, the reduction) and of its rows' serial steps.
//
// The design. The control flow depends on the opcodes alone, so each tape is
// decoded once per CTA, not once per row: warp t walks tape t's non-PAD
// slots (a ballot screens 32 slots at a time) and its lane 0 runs the
// stack-pointer recurrence, writing a compact program of the tape's live
// steps into shared memory. A step carries its resolved opcode and where
// each operand lives; PAD slots, clamps, arities and the op table are gone
// from the per-row loop, and nothing is zeroed per row (a slot read before
// it is written has no producer and reads 0). The first rows' inputs are
// loaded while the tapes are staged and decoded.
//
//   K5  tape_eval_kernel: a CTA decodes TAPES tapes, then its warps share the
//       (tape, 128-row pass) items of those tapes, stepping through them
//       without integer division. Each thread carries R = 4 rows at a row
//       stride of 32, so the warp's stores stay coalesced and each step is
//       dispatched once for 4 rows (the bf16 instance: 8 rows, below). The decoder turns VAR and out-of-table
//       steps into reads of fixed slots (the row's inputs, staged once per
//       pass; a slot of zeros), keeps the last step's value in registers (a
//       step whose operand is the step just before reads it there) and marks
//       which values must be stored to the thread's shared-memory stack at
//       all; each step is one case of a switch over its kind. A tape that
//       overflows (a leaf pushed with the stack full) is NaN on every row
//       and is not evaluated. The next item's inputs are loaded while the
//       current one runs.
//   K6  tape_grad_kernel: a CTA decodes its tapes; a tape's rows go to
//       `parts` warps (4 from 512 rows, 2 from 256, else 1: at the shipped
//       512- and 1,024-row shapes the CTAs then fill the card in several
//       waves), one row per lane per pass. The decoder records, for each
//       live step, the step that produced each operand (the last writer of
//       the slot it reads); VAR steps are not run (their producer is the
//       row's input entry). The forward keeps every live step's value; the
//       reverse sends each step's cotangent to its operands' producers with
//       the JAX kernel's partials (:361-392); where both operands of a binary
//       op have one producer (an underflow), both partials reach it, a first
//       then b. A CONST step's cotangent is never reset, so it is the lane's
//       running sum over its rows. Shared memory per warp is two columns of
//       L + 1 + n_vars floats a lane (values, cotangents: the steps, an entry
//       of zeros, the inputs), so several tapes stay resident per SM; the
//       next row's inputs and gbar are loaded while the current row runs.
//       Row sums run in a fixed order: each lane adds its rows' partials
//       to the running sum row by row (rows r, r + 32 * parts, ..., r = 32 *
//       part + lane, in increasing order; within a row, in reverse step
//       order), the 32 lane sums of a warp meet in an xor butterfly
//       (offsets 16, 8, 4, 2, 1), then the tape's first warp adds the parts'
//       sums in part order.
//       No atomics, so two runs give the same bits.
//
// Semantics, as the JAX interpreter (symgp/tape.py eval_tapes): DIV gives 1
// where |den| <= 1e-9; EXP clips its operand to [-40, 40] (NaN stays NaN);
// a leaf pushed with the stack full makes the tape's output NaN (and its
// gradient seed 0); PAD is a no-op; reads below slot 0 clamp to slot 0 and
// writes clamp into [0, D-1]; a slot never written reads 0; a live opcode
// outside the op table yields 0, with the arity jnp.asarray(ARITY)[op]
// gives (a negative opcode wraps once, then the index clamps to [0, 10]).
// The reference adds +0.0f to every stack read (a where-mask then a sum),
// so -0 reads as +0: here each value that can be -0 (MUL, DIV, SIN, COS,
// NEG results, constants, inputs) gets its +0.0f when it is produced; sums
// and differences of such values are never -0, EXP never is. Each row's
// arithmetic is the reference's operations in its order, so K5 matches the
// plain interpreter bit for bit. Build with --fmad=false and IEEE division;
// expf/sinf/cosf at full precision (no fast math). Rows past N are never
// read or written.
//
// K5's bf16 mode (tape_eval_kernel<true>; eval_tapes_pallas on bf16 X and
// consts, the reference's fitness dtype): bf16 rows and constants in, bf16
// predictions out, every value kept as bf16 pairs (__nv_bfloat162), never
// widened to f32 between steps. Like the f32 instance it is bound by
// instruction issue, not bytes, so the design spends its instructions on
// two rows at once: each lane carries 8 rows as four bf16x2 pairs, so a
// stack slot of a lane is 16 bytes (the f32 slot's size: one shared-memory
// access, the same layout and tapes per CTA), a warp's pass covers 256 rows
// and each step's decode, dispatch and operand addressing is paid once per
// 8 rows. ADD, SUB and MUL are one packed instruction per two rows
// (__hadd2_rn, __hsub2_rn, __hmul2_rn: add/sub/mul.rn.bf16x2, each correctly
// rounded, so equal by the double-rounding theorem, 24 >= 2 * 8 + 2 bits, to
// the f32 operation rounded to bf16 that the plain interpreter's bf16
// tensors compute); NEG is __hneg2. DIV, EXP, SIN and COS run per element
// in f32, as before: safe_div, clip40, expf/sinf/cosf at full precision,
// then __floats2bfloat162_rn, the values the plain version computes on the
// card. The canonical +0 of MUL, DIV, SIN, COS, NEG, the constants and the
// inputs is a packed __hadd2_rn with +0 after the rounding (a product that
// underflows rounds to -0; the _rn forms keep ptxas from fusing the product
// and that add into one fma, which would keep the -0). Rows to lanes: pair
// k of lane l in pass p holds rows p * 256 + 64 k + 2 l and the row after
// it, so a pair is two neighbouring rows: with n_vars = 2 (every GP task)
// both rows' inputs are one 8-byte load and two byte permutes, and a pair
// of predictions is one 4-byte store, neighbouring lanes on neighbouring
// addresses (128 bytes a warp store). Where X or the output is not aligned
// for that (an odd N), or n_vars is not 2, the rows go one bf16 at a time.
// Only n_vars = 2 prefetches the next item's inputs (four 8-byte words): a
// prefetch of 16-bit loads would take a register per row and variable.
// K6 stays f32: the constant gradient is f32 in the reference too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define WARP 32
#define TAPES 4                // tapes (and warps) per CTA, at most
#define R5 4                   // K5 f32: rows per thread per pass
#define R5BF 8                 // K5 bf16: rows per thread per pass (four bf16x2 pairs)
#define SLOT5 16               // K5: bytes of a lane's stack slot (a float4 or 4 pairs)
#define MAXD 64                // deepest stack the kernels take
#define MAXL 4095              // longest tape the launchers take
#define MAXV 128               // most variables (K5 slot indices fit 8 bits)
#define PREF 4                 // inputs a row loads ahead, while the rows before it run
#define SMEM_LIMIT (227 * 1024)

enum { PAD = 0, CONST = 1, VAR = 2, ADD = 3, SUB = 4, MUL = 5, DIV = 6, EXP = 7, SIN = 8,
       COS = 9, NEG = 10, ZERO = 11 };

// K5 step code: the kind in bits 0-3, then whether operand a (K5_AR) or b
// (K5_BR) is the previous step's value and whether the result is stored
// (K5_ST)
#define K5_AR 16
#define K5_BR 32
#define K5_ST 64

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// jnp.asarray(ARITY)[op]: a negative opcode wraps once, then the index clamps
__device__ __forceinline__ int arity_of(int op) {
    const int i = clampi(op < 0 ? op + NEG + 1 : op, 0, NEG);
    return i >= EXP ? 1 : (i >= ADD ? 2 : 0);
}

// the opcode itself when the interpreter computes it, else ZERO
__device__ __forceinline__ int resolve(int op, unsigned table_mask) {
    return (op >= 0 && op <= NEG && ((table_mask >> op) & 1u)) ? op : ZERO;
}

// jnp.clip: NaN stays NaN (fminf/fmaxf would drop it)
__device__ __forceinline__ float clip40(float a) {
    return (a < -40.f) ? -40.f : ((a > 40.f) ? 40.f : a);
}

__device__ __forceinline__ float safe_div(float b, float a) {
    return (fabsf(a) > 1e-9f) ? b / a : 1.f;
}

// one live step of an arity >= 1 kind on one row, canonical (+0 for -0)
__device__ __forceinline__ float apply(int kind, float a, float b) {
    switch (kind) {
        case ADD: return b + a;
        case SUB: return b - a;
        case MUL: return b * a + 0.f;
        case DIV: return safe_div(b, a) + 0.f;
        case EXP: return expf(clip40(a));
        case SIN: return sinf(a) + 0.f;
        case COS: return cosf(a) + 0.f;
        default: return -a + 0.f;  // NEG
    }
}

template <int K>
__device__ __forceinline__ float4 map4(float4 a, float4 b) {
    return make_float4(apply(K, a.x, b.x), apply(K, a.y, b.y), apply(K, a.z, b.z),
                       apply(K, a.w, b.w));
}

// K5's element type: the rows, constants and predictions
template <bool BF>
using Elem = typename std::conditional<BF, __nv_bfloat16, float>::type;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---- K5 bf16: a lane's 8 rows of one value as four bf16x2 pairs ----

typedef __nv_bfloat162 bf2;

struct bf8 {
    bf2 p[4];
};

__device__ __forceinline__ bf2 u2b(unsigned u) { return *reinterpret_cast<const bf2*>(&u); }
__device__ __forceinline__ unsigned b2u(bf2 b) { return *reinterpret_cast<const unsigned*>(&b); }

__device__ __forceinline__ bf8 ld8(const unsigned char* p) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    return bf8{{u2b(u.x), u2b(u.y), u2b(u.z), u2b(u.w)}};
}

__device__ __forceinline__ void st8(unsigned char* p, const bf8& v) {
    *reinterpret_cast<uint4*>(p) = make_uint4(b2u(v.p[0]), b2u(v.p[1]), b2u(v.p[2]), b2u(v.p[3]));
}

__device__ __forceinline__ bf8 splat8(unsigned u) { return bf8{{u2b(u), u2b(u), u2b(u), u2b(u)}}; }

// -0 to +0 in both halves (x + +0 under round to nearest), every other value as it is
__device__ __forceinline__ bf2 canon2(bf2 v) { return __hadd2_rn(v, u2b(0u)); }

// the f32 operation of a per-element kind on one row of bf16 operands
template <int K>
__device__ __forceinline__ float apply_f(float a, float b) {
    if constexpr (K == DIV) return safe_div(b, a);
    else if constexpr (K == EXP) return expf(clip40(a));
    else if constexpr (K == SIN) return sinf(a);
    else return cosf(a);  // COS
}

// one live step of kind K on two rows, canonical (+0 for -0): ADD, SUB, MUL
// and NEG packed; DIV, EXP, SIN and COS per element in f32, then rounded to
// bf16 (sums and differences of canonical values are never -0, exp is
// positive)
template <int K>
__device__ __forceinline__ bf2 apply2(bf2 a, bf2 b) {
    if constexpr (K == ADD) {
        return __hadd2_rn(b, a);
    } else if constexpr (K == SUB) {
        return __hsub2_rn(b, a);
    } else if constexpr (K == MUL) {
        return canon2(__hmul2_rn(b, a));
    } else if constexpr (K == NEG) {
        return canon2(__hneg2(a));
    } else {
        const float2 af = __bfloat1622float2(a), bf = __bfloat1622float2(b);
        const bf2 r = __floats2bfloat162_rn(apply_f<K>(af.x, bf.x), apply_f<K>(af.y, bf.y));
        return K == EXP ? r : canon2(r);
    }
}

template <int K>
__device__ __forceinline__ bf8 map8(const bf8& a, const bf8& b) {
    return bf8{{apply2<K>(a.p[0], b.p[0]), apply2<K>(a.p[1], b.p[1]), apply2<K>(a.p[2], b.p[2]),
                apply2<K>(a.p[3], b.p[3])}};
}

// Shared memory of one CTA: the decoded programs and their headers first,
// then a region per warp; the staged tapes and the decoder's last-writer
// table live in the warps' regions until the programs are decoded.
struct Layout {
    size_t hdr, region, total;
};

__host__ __device__ static size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

__host__ __device__ static Layout layout(int tapes, int warps, int L, int D, size_t region_per_warp) {
    Layout s;
    s.hdr = align16((size_t)tapes * L * 16);
    s.region = s.hdr + (size_t)tapes * 16;
    const size_t stage = (size_t)tapes * (3 * L + D) * 4;
    const size_t region = (size_t)warps * region_per_warp;
    s.total = s.region + (region > stage ? region : stage);
    return s;
}

// K5: per warp, D stack slots, one slot of zeros and n_vars input slots,
// each SLOT5 bytes per lane (4 f32 rows, or 8 bf16 rows)
__host__ __device__ static Layout k5_layout(int tapes, int L, int D, int n_vars) {
    return layout(tapes, tapes, L, D, (size_t)(D + 1 + n_vars) * WARP * SLOT5);
}

// K6: per warp, two columns (values, cotangents) of L + 1 + n_vars entries
// a lane: the steps, an entry of zeros, the row's inputs
__host__ __device__ static Layout k6_layout(int tapes, int warps, int L, int D, int n_vars) {
    return layout(tapes, warps, L, D, (size_t)2 * (L + 1 + n_vars) * WARP * 4);
}

// the most tapes per CTA (<= TAPES) whose shared memory fits, 0 if none
static int k5_tapes(int L, int D, int n_vars) {
    for (int t = TAPES; t >= 1; --t)
        if (k5_layout(t, L, D, n_vars).total <= SMEM_LIMIT) return t;
    return 0;
}

// K6 splits a tape's rows over `parts` warps (4 from 512 rows, 2 from 256:
// the 512- and 1,024-row shapes then fill the card in several waves) and
// takes TAPES / parts tapes a CTA, fewer warps if shared memory is short
static int k6_shape(int L, int D, int n_vars, int N, int* tapes, int* parts) {
    const int want = N >= 512 ? 4 : (N >= 256 ? 2 : 1);
    for (int warps = TAPES; warps >= 1; warps /= 2) {
        const int p = want < warps ? want : warps;
        if (k6_layout(warps / p, warps, L, D, n_vars).total <= SMEM_LIMIT) {
            *tapes = warps / p;
            *parts = p;
            return 1;
        }
    }
    return 0;
}

// Stage the CTA's nt tapes (contiguous in ops/args/consts) into shared
// memory, the constants as f32 (bf16 widens exactly).
template <class C>
__device__ __forceinline__ void stage_tapes(int* s_op, int* s_arg, float* s_c,
                                            const int* __restrict__ ops,
                                            const int* __restrict__ args,
                                            const C* __restrict__ consts, long long t0, int nt,
                                            int L) {
    const size_t base = (size_t)t0 * L;
    for (int i = threadIdx.x; i < nt * L; i += blockDim.x) {
        s_op[i] = ops[base + i];
        s_arg[i] = args[base + i];
        s_c[i] = to_f(consts[base + i]);
    }
}

// The warp walks the tape's non-PAD slots in order: one ballot screens each
// 32 slots, and lane 0 runs body(l, op) on the live ones (the control flow
// depends on the opcodes alone, so the walk is once per tape, not per row).
template <class F>
__device__ __forceinline__ void walk_live(const int* op_t, int L, int lane, F body) {
    for (int c = 0; c < L; c += WARP) {
        unsigned live = __ballot_sync(0xffffffffu, c + lane < L && op_t[c + lane] != PAD);
        if (lane == 0)
            for (; live; live &= live - 1) {
                const int l = c + __ffs(live) - 1;
                body(l, op_t[l]);
            }
    }
}

// ---- K5 ----

// An operand read from a slot whose last writer is `lw` (packed: executed
// step + 1 in bits 8+, 0 for none; the slot holding its value in bits 0-7),
// by step n: the previous step's register (the flag is set), or the slot's
// byte offset in the lane's column, slots of sb bytes (and then the writer
// stores its value).
__device__ __forceinline__ int k5_operand(int lw, int n, int4* pg, int* code, int reg_flag,
                                          int sb) {
    const int ex = (lw >> 8) - 1;
    if (ex >= 0 && ex == n - 1) {
        *code |= reg_flag;
        return 0;
    }
    if (ex >= 0) pg[ex].x |= K5_ST;
    return (lw & 0xff) * WARP * sb;
}

// Warp t decodes tape t of the CTA, of unit `unit`, into pg[0..n): each
// step is (code, a's byte offset or, for CONST, the canonical constant's
// f32 bits, b's byte offset, the written slot's byte offset). Header: (n,
// bad, unit, the output's byte offset, or 1 when the output is the last
// step's register).
__device__ void k5_decode(int t, int unit, int lane, int L, int D, int n_vars,
                          unsigned table_mask, const int* s_op, const int* s_arg,
                          const float* s_c, int* lastw, int4* pg, int4* hdr, int sb) {
    const int* op_t = s_op + t * L;
    int* lw = lastw + t * D;
    for (int s = lane; s < D; s += WARP) lw[s] = D;  // no writer: the slot of zeros
    __syncwarp();
    int sp = 0, n = 0, bad = 0;
    walk_live(op_t, L, lane, [&](int l, int op) {
        const int ar = arity_of(op);
        bad |= (ar == 0 && sp >= D);
        const int kind = resolve(op, table_mask);
        const int w = clampi(sp - ar, 0, D - 1);
        if (kind == VAR) {
            lw[w] = D + 1 + clampi(s_arg[t * L + l], 0, n_vars - 1);
        } else if (kind == ZERO) {
            lw[w] = D;
        } else {
            int code = kind, a = 0, b = 0;
            if (kind == CONST) {
                a = __float_as_int(s_c[t * L + l] + 0.f);
            } else {
                a = k5_operand(lw[clampi(sp - 1, 0, D - 1)], n, pg, &code, K5_AR, sb);
                if (ar == 2)
                    b = k5_operand(lw[clampi(sp - 2, 0, D - 1)], n, pg, &code, K5_BR, sb);
            }
            pg[n] = make_int4(code, a, b, w * WARP * sb);
            lw[w] = ((n + 1) << 8) | w;
            ++n;
        }
        sp = clampi(sp + 1 - ar, 0, D);
    });
    if (lane == 0) {
        int out_reg = 0;
        const int out = k5_operand(lw[clampi(sp - 1, 0, D - 1)], n, pg, &out_reg, 1, sb);
        hdr[t] = make_int4(n, bad, unit, out | out_reg);
    }
}

__device__ __forceinline__ float4 ld4(const unsigned char* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(unsigned char* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}

// One step of kind K on the lane's 4 f32 rows: operands from the previous
// step's value (flags K5_AR, K5_BR) or the lane's column.
template <int K>
__device__ __forceinline__ float4 k5_step(const unsigned char* col, const int4& d,
                                          const float4& tos) {
    if (K == CONST) {
        const float c = __int_as_float(d.y);
        return make_float4(c, c, c, c);
    }
    const float4 a = (d.x & K5_AR) ? tos : ld4(col + d.y);
    const float4 b = (K <= DIV && !(d.x & K5_BR)) ? ld4(col + d.z) : tos;
    return map4<K>(a, b);
}

// The same on the lane's 8 bf16 rows.
template <int K>
__device__ __forceinline__ bf8 k5_step_bf(const unsigned char* col, const int4& d,
                                          const bf8& tos) {
    if constexpr (K == CONST) {
        return splat8((unsigned)d.y);
    } else {
        const bf8 a = (d.x & K5_AR) ? tos : ld8(col + d.y);
        const bf8 b = (K <= DIV && !(d.x & K5_BR)) ? ld8(col + d.z) : tos;
        return map8<K>(a, b);
    }
}

// K5 in bf16. Pair k of lane l in pass p holds rows p * 256 + 2 * WARP * k
// + 2 l and the row after it (low half, high half); every value is four
// bf16x2 pairs.
__device__ __forceinline__ void k5_bf16(const int* __restrict__ ops, const int* __restrict__ args,
                                        const __nv_bfloat16* __restrict__ consts,
                                        const __nv_bfloat16* __restrict__ X,
                                        __nv_bfloat16* __restrict__ out, long long n_tapes, int P,
                                        int L, int N, int n_vars, int D, unsigned table_mask) {
    constexpr int ROWS = WARP * R5BF;
    extern __shared__ __align__(16) unsigned char smem[];
    const int tapes = blockDim.x / WARP;
    const Layout lay = k5_layout(tapes, L, D, n_vars);
    const int4* prog = reinterpret_cast<const int4*>(smem);
    const int4* hdr = reinterpret_cast<const int4*>(smem + lay.hdr);
    const long long t0 = (long long)blockIdx.x * tapes;
    const int nt = (int)(n_tapes - t0 < tapes ? n_tapes - t0 : tapes);

    const int w = threadIdx.x / WARP, lane = threadIdx.x % WARP;
    const int passes = (N + ROWS - 1) / ROWS;
    auto next = [&](int& ti, int& pi) {
        for (pi += tapes; pi >= passes; pi -= passes) ++ti;
    };
    // unit u's rows as 16-bit words; with n_vars = 2 and 8-byte alignment a
    // pair's two rows are one 8-byte word (x0, x1 of each row)
    auto rows_of = [&](int u) {
        return reinterpret_cast<const unsigned short*>(X + (size_t)u * N * n_vars);
    };
    auto packed = [&](const unsigned short* x) {
        return n_vars == 2 && (reinterpret_cast<uintptr_t>(x) & 7) == 0;
    };
    // the next item's inputs where packed, loaded while this item runs; the
    // first item's while the tapes are staged and decoded
    uint2 nx[4];
    auto prefetch = [&](int ti, int pi, int u) {
        const unsigned short* x = rows_of(u);
        if (ti >= nt || !packed(x)) return;
        const int r0 = pi * ROWS + 2 * lane;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int r = r0 + 2 * WARP * k;
            const unsigned* p = reinterpret_cast<const unsigned*>(x) + r;
            nx[k] = r + 1 < N ? *reinterpret_cast<const uint2*>(p)
                              : make_uint2(r < N ? *p : 0u, 0u);
        }
    };
    int t = w / passes, pass = w % passes;
    prefetch(t, pass, (int)((t0 + t) / P));

    int* s_op = reinterpret_cast<int*>(smem + lay.region);
    int* s_arg = s_op + tapes * L;
    float* s_c = reinterpret_cast<float*>(s_arg + tapes * L);
    stage_tapes(s_op, s_arg, s_c, ops, args, consts, t0, nt, L);
    __syncthreads();
    if (w < nt) {
        int4* pg = reinterpret_cast<int4*>(smem) + w * L;
        int4* hdr_w = reinterpret_cast<int4*>(smem + lay.hdr);
        k5_decode(w, (int)((t0 + w) / P), lane, L, D, n_vars, table_mask, s_op, s_arg, s_c,
                  reinterpret_cast<int*>(s_c + tapes * L), pg, hdr_w, SLOT5);
        __syncwarp();
        // a constant as the bf16 pair (c, c) (exact: c is a bf16 value)
        for (int i = lane; i < hdr_w[w].x; i += WARP)
            if ((pg[i].x & 15) == CONST)
                pg[i].y = (int)b2u(__float2bfloat162_rn(__int_as_float(pg[i].y)));
    }
    __syncthreads();

    // this lane's column of the warp's stack, SLOT5 bytes (8 rows) per slot
    // at byte offset slot * WARP * SLOT5, the lane's own as in f32
    const int slots = D + 1 + n_vars;
    unsigned char* col = smem + lay.region + ((size_t)w * slots * WARP + lane) * SLOT5;
    auto slot = [&](int i) { return col + (size_t)i * WARP * SLOT5; };
    st8(slot(D), splat8(0u));
    while (t < nt) {
        const int4 h = hdr[t];
        const int r0 = pass * ROWS + 2 * lane;
        const unsigned short* x = rows_of(h.z);
        if (packed(x)) {
            bf8 x0, x1;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                x0.p[k] = canon2(u2b(__byte_perm(nx[k].x, nx[k].y, 0x5410)));
                x1.p[k] = canon2(u2b(__byte_perm(nx[k].x, nx[k].y, 0x7632)));
            }
            st8(slot(D + 1), x0);
            st8(slot(D + 2), x1);
        } else {
            for (int v = 0; v < n_vars; ++v) {
                bf8 q;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int r = r0 + 2 * WARP * k;
                    const unsigned lo = r < N ? x[(size_t)r * n_vars + v] : 0u;
                    const unsigned hi = r + 1 < N ? x[(size_t)(r + 1) * n_vars + v] : 0u;
                    q.p[k] = canon2(u2b(lo | hi << 16));
                }
                st8(slot(D + 1 + v), q);
            }
        }
        int tn = t, pn = pass;
        next(tn, pn);
        if (tn < nt) prefetch(tn, pn, hdr[tn].z);
        bf8 y;
        if (h.y) {  // overflow: NaN on every row
            y = splat8(0x7fc07fc0u);
        } else {
            const int4* pg = prog + t * L;
            bf8 tos = splat8(0u);
            int4 d = pg[0];
            for (int i = 0; i < h.x; ++i) {
                const int4 dn = pg[i + 1 < h.x ? i + 1 : i];  // the next step, ahead
                switch (d.x & 15) {
                    case CONST: tos = k5_step_bf<CONST>(col, d, tos); break;
                    case ADD: tos = k5_step_bf<ADD>(col, d, tos); break;
                    case SUB: tos = k5_step_bf<SUB>(col, d, tos); break;
                    case MUL: tos = k5_step_bf<MUL>(col, d, tos); break;
                    case DIV: tos = k5_step_bf<DIV>(col, d, tos); break;
                    case EXP: tos = k5_step_bf<EXP>(col, d, tos); break;
                    case SIN: tos = k5_step_bf<SIN>(col, d, tos); break;
                    case COS: tos = k5_step_bf<COS>(col, d, tos); break;
                    default: tos = k5_step_bf<NEG>(col, d, tos); break;
                }
                if (d.x & K5_ST) st8(col + d.w, tos);
                d = dn;
            }
            y = (h.w & 1) ? tos : ld8(col + h.w);
        }
        // a pair is one 4-byte store where the tape's row 0 is 4-byte aligned
        unsigned short* o = reinterpret_cast<unsigned short*>(out + (size_t)(t0 + t) * N);
        const bool whole = (reinterpret_cast<uintptr_t>(o) & 3) == 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int r = r0 + 2 * WARP * k;
            const unsigned v = b2u(y.p[k]);
            if (whole && r + 1 < N) {
                *reinterpret_cast<unsigned*>(o + r) = v;
            } else {
                if (r < N) o[r] = (unsigned short)v;
                if (r + 1 < N) o[r + 1] = (unsigned short)(v >> 16);
            }
        }
        t = tn;
        pass = pn;
    }
}

// grid ceil(U * P / tapes), tapes * 32 threads; smem k5_layout
template <bool BF>
__global__ void __launch_bounds__(TAPES * WARP) tape_eval_kernel(
    const int* __restrict__ ops, const int* __restrict__ args, const Elem<BF>* __restrict__ consts,
    const Elem<BF>* __restrict__ X, Elem<BF>* __restrict__ out, long long n_tapes, int P, int L,
    int N, int n_vars, int D, unsigned table_mask) {
    if constexpr (BF) {
        k5_bf16(ops, args, consts, X, out, n_tapes, P, L, N, n_vars, D, table_mask);
    } else {
        // f32: each thread carries R5 rows at a row stride of 32
        constexpr int ROWS = WARP * R5;
        extern __shared__ __align__(16) unsigned char smem[];
        const int tapes = blockDim.x / WARP;
        const Layout lay = k5_layout(tapes, L, D, n_vars);
        int4* prog = reinterpret_cast<int4*>(smem);
        int4* hdr = reinterpret_cast<int4*>(smem + lay.hdr);
        int* s_op = reinterpret_cast<int*>(smem + lay.region);
        int* s_arg = s_op + tapes * L;
        float* s_c = reinterpret_cast<float*>(s_arg + tapes * L);
        int* lastw = reinterpret_cast<int*>(s_c + tapes * L);
        const long long t0 = (long long)blockIdx.x * tapes;
        const int nt = (int)(n_tapes - t0 < tapes ? n_tapes - t0 : tapes);

        const int w = threadIdx.x / WARP, lane = threadIdx.x % WARP;
        // warp w takes the items w, w + tapes, ... of the CTA's (tape, pass)
        // items in tape-major order; (t, pass) step on without a division
        const int passes = (N + ROWS - 1) / ROWS;
        auto next = [&](int& ti, int& pi) {
            for (pi += tapes; pi >= passes; pi -= passes) ++ti;
        };
        // the next item's first PREF inputs (unit u's rows), loaded while
        // this item runs; the first item's while the tapes are staged and
        // decoded
        float nx[PREF][R5];
        auto prefetch = [&](int ti, int pi, int u) {
            if (ti >= nt) return;
            const int row0 = pi * ROWS + lane;
            const float* x = X + (size_t)u * N * n_vars;
#pragma unroll
            for (int v = 0; v < PREF; ++v)
#pragma unroll
                for (int j = 0; j < R5; ++j) {
                    const int row = row0 + j * WARP;
                    nx[v][j] = (v < n_vars && row < N) ? x[(size_t)row * n_vars + v] : 0.f;
                }
        };
        int t = w / passes, pass = w % passes;
        prefetch(t, pass, (int)((t0 + t) / P));

        stage_tapes(s_op, s_arg, s_c, ops, args, consts, t0, nt, L);
        __syncthreads();
        if (w < nt)
            k5_decode(w, (int)((t0 + w) / P), lane, L, D, n_vars, table_mask, s_op, s_arg, s_c,
                      lastw, prog + w * L, hdr, SLOT5);
        __syncthreads();

        // this lane's column of the warp's stack, SLOT5 bytes (4 rows) per
        // slot at byte offset slot * WARP * SLOT5; every access below is to
        // the lane's own column, so the warp needs no barrier
        const int slots = D + 1 + n_vars;
        unsigned char* col = smem + lay.region + ((size_t)w * slots * WARP + lane) * SLOT5;
        auto slot = [&](int i) { return col + (size_t)i * WARP * SLOT5; };
        const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
        st4(slot(D), zero4);
        while (t < nt) {
            const int4 h = hdr[t];
            const int row0 = pass * ROWS + lane;
            const float* x = X + (size_t)h.z * N * n_vars;
#pragma unroll
            for (int v = 0; v < PREF; ++v)
                if (v < n_vars)
                    st4(slot(D + 1 + v), make_float4(nx[v][0] + 0.f, nx[v][1] + 0.f,
                                                     nx[v][2] + 0.f, nx[v][3] + 0.f));
            for (int v = PREF; v < n_vars; ++v) {
                float q[R5];
#pragma unroll
                for (int j = 0; j < R5; ++j) {
                    const int row = row0 + j * WARP;
                    q[j] = row < N ? x[(size_t)row * n_vars + v] + 0.f : 0.f;
                }
                st4(slot(D + 1 + v), make_float4(q[0], q[1], q[2], q[3]));
            }
            int tn = t, pn = pass;
            next(tn, pn);
            if (tn < nt) prefetch(tn, pn, hdr[tn].z);
            float4 y;
            if (h.y) {  // overflow: NaN on every row
                const float nan = __int_as_float(0x7fc00000);
                y = make_float4(nan, nan, nan, nan);
            } else {
                const int4* pg = prog + t * L;
                float4 tos = zero4;
                int4 d = pg[0];
                for (int i = 0; i < h.x; ++i) {
                    const int4 dn = pg[i + 1 < h.x ? i + 1 : i];  // the next step, ahead
                    switch (d.x & 15) {
                        case CONST: tos = k5_step<CONST>(col, d, tos); break;
                        case ADD: tos = k5_step<ADD>(col, d, tos); break;
                        case SUB: tos = k5_step<SUB>(col, d, tos); break;
                        case MUL: tos = k5_step<MUL>(col, d, tos); break;
                        case DIV: tos = k5_step<DIV>(col, d, tos); break;
                        case EXP: tos = k5_step<EXP>(col, d, tos); break;
                        case SIN: tos = k5_step<SIN>(col, d, tos); break;
                        case COS: tos = k5_step<COS>(col, d, tos); break;
                        default: tos = k5_step<NEG>(col, d, tos); break;
                    }
                    if (d.x & K5_ST) st4(col + d.w, tos);
                    d = dn;
                }
                y = (h.w & 1) ? tos : ld4(col + h.w);
            }
            const float yv[R5] = {y.x, y.y, y.z, y.w};
            float* o = out + (size_t)(t0 + t) * N;
#pragma unroll
            for (int j = 0; j < R5; ++j)
                if (row0 + j * WARP < N) o[row0 + j * WARP] = yv[j];
            t = tn;
            pass = pn;
        }
    }
}

// ---- K6 ----

// Warp t decodes tape t of the CTA into pg[0..n), one step per CONST and
// per in-table op: (kind | slot << 4, a's and b's entry as a byte offset in
// the lane's column, the canonical constant). An operand with no producer
// (a slot never written, or written by an out-of-table op) reads the entry
// of zeros; a VAR producer is the row's input entry, so VAR steps are not
// run. Header: (n, bad, the output's entry as a byte offset, 0).
__device__ void k6_decode(int t, int lane, int L, int D, int n_vars, unsigned table_mask,
                          const int* s_op, const int* s_arg, const float* s_c, int* lastw,
                          int4* pg, int4* hdr) {
    const int* op_t = s_op + t * L;
    int* lw = lastw + t * D;
    for (int s = lane; s < D; s += WARP) lw[s] = L;  // no writer: the entry of zeros
    __syncwarp();
    int sp = 0, n = 0, bad = 0;
    walk_live(op_t, L, lane, [&](int l, int op) {
        const int ar = arity_of(op);
        bad |= (ar == 0 && sp >= D);
        const int kind = resolve(op, table_mask);
        const int w = clampi(sp - ar, 0, D - 1);
        if (kind == VAR) {
            lw[w] = L + 1 + clampi(s_arg[t * L + l], 0, n_vars - 1);
        } else if (kind == ZERO) {
            lw[w] = L;
        } else {
            int a = L, b = L, c = 0;
            if (kind == CONST) {
                c = __float_as_int(s_c[t * L + l] + 0.f);
            } else {
                a = lw[clampi(sp - 1, 0, D - 1)];
                if (ar == 2) b = lw[clampi(sp - 2, 0, D - 1)];
            }
            pg[n] = make_int4(kind | (l << 4), a * WARP * 4, b * WARP * 4, c);
            lw[w] = n;
            ++n;
        }
        sp = clampi(sp + 1 - ar, 0, D);
    });
    if (lane == 0) hdr[t] = make_int4(n, bad, lw[clampi(sp - 1, 0, D - 1)] * WARP * 4, 0);
}

__device__ __forceinline__ float& at(unsigned char* col, int off) {
    return *reinterpret_cast<float*>(col + off);
}

// grid ceil(U * P / tapes), tapes * parts * 32 threads; smem k6_layout
__global__ void __launch_bounds__(TAPES * WARP) tape_grad_kernel(
    const int* __restrict__ ops, const int* __restrict__ args, const float* __restrict__ consts,
    const float* __restrict__ X, const float* __restrict__ gbar, float* __restrict__ gc,
    long long n_tapes, int P, int L, int N, int n_vars, int D, unsigned table_mask, int parts) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int warps = blockDim.x / WARP;
    const int tapes = warps / parts;
    const Layout lay = k6_layout(tapes, warps, L, D, n_vars);
    int4* prog = reinterpret_cast<int4*>(smem);
    int4* hdr = reinterpret_cast<int4*>(smem + lay.hdr);
    int* s_op = reinterpret_cast<int*>(smem + lay.region);
    int* s_arg = s_op + tapes * L;
    float* s_c = reinterpret_cast<float*>(s_arg + tapes * L);
    int* lastw = reinterpret_cast<int*>(s_c + tapes * L);
    const long long t0 = (long long)blockIdx.x * tapes;
    const int nt = (int)(n_tapes - t0 < tapes ? n_tapes - t0 : tapes);

    // warp w takes rows part * 32 + lane, then every parts * 32 further, of
    // tape w / parts
    const int w = threadIdx.x / WARP, lane = threadIdx.x % WARP;
    const int t = w / parts, part = w % parts;
    const long long tape = t0 + t;
    const float* x = X + (size_t)((t < nt ? tape : t0) / P) * N * n_vars;
    const float* gb_t = gbar + (size_t)tape * N;
    // the next row's gbar and first PREF inputs, loaded while this row runs;
    // the first row's while the tapes are staged and decoded
    float nx[PREF], ng = 0.f;
    auto prefetch = [&](int row) {
        if (row >= N) return;
        ng = gb_t[row];
#pragma unroll
        for (int v = 0; v < PREF; ++v)
            nx[v] = v < n_vars ? x[(size_t)row * n_vars + v] : 0.f;
    };
    const int stride = parts * WARP;
    if (t < nt) prefetch(part * WARP + lane);

    stage_tapes(s_op, s_arg, s_c, ops, args, consts, t0, nt, L);
    __syncthreads();
    if (w < nt)
        k6_decode(w, lane, L, D, n_vars, table_mask, s_op, s_arg, s_c, lastw, prog + w * L, hdr);
    __syncthreads();

    // the lane's columns: V (values) then G (cotangents; a CONST step's is
    // the lane's running sum over its rows, never reset)
    const int E = L + 1 + n_vars;
    float* region = reinterpret_cast<float*>(smem + lay.region) + (size_t)w * 2 * E * WARP;
    unsigned char* V = reinterpret_cast<unsigned char*>(region + lane);
    unsigned char* G = V + (size_t)E * WARP * 4;
    const int4 h = t < nt ? hdr[t] : make_int4(0, 0, 0, 0);
    const int n = h.x;
    const int4* pg = prog + t * L;
    if (t < nt) {
        for (int i = 0; i < n; ++i) at(G, i * WARP * 4) = 0.f;
        at(V, L * WARP * 4) = 0.f;
        // rows past N do nothing (lanes leave the loop), so they add nothing
        for (int row = part * WARP + lane; row < N; row += stride) {
#pragma unroll
            for (int v = 0; v < PREF; ++v)
                if (v < n_vars) at(V, (L + 1 + v) * WARP * 4) = nx[v] + 0.f;
            for (int v = PREF; v < n_vars; ++v)
                at(V, (L + 1 + v) * WARP * 4) = x[(size_t)row * n_vars + v] + 0.f;
            const float seed = h.y ? 0.f : ng;
            prefetch(row + stride);
            int4 d = pg[0];
            for (int i = 0; i < n; ++i) {
                const int4 dn = pg[i + 1 < n ? i + 1 : i];
                const int kind = d.x & 15;
                if (kind == CONST) {
                    at(V, i * WARP * 4) = __int_as_float(d.w);
                } else {
                    at(V, i * WARP * 4) = apply(kind, at(V, d.y), at(V, d.z));
                    at(G, i * WARP * 4) = 0.f;
                }
                d = dn;
            }
            at(G, h.z) += seed;
            if (n > 0) d = pg[n - 1];
            for (int i = n - 1; i >= 0; --i) {
                const int4 dn = pg[i > 0 ? i - 1 : 0];
                const int kind = d.x & 15;
                if (kind != CONST) {
                    const float g = at(G, i * WARP * 4) + 0.f;
                    const float a = at(V, d.y), b = at(V, d.z);
                    float ga = 0.f, gbv = 0.f;
                    switch (kind) {
                        case ADD: ga = g; gbv = g; break;
                        case SUB: ga = -g; gbv = g; break;
                        case MUL: ga = g * b; gbv = g * a; break;
                        case DIV: {
                            const bool ok = fabsf(a) > 1e-9f;
                            const float den = ok ? a : 1.f;
                            ga = ok ? (-g * b) / (den * den) : 0.f;
                            gbv = ok ? g / den : 0.f;
                            break;
                        }
                        case EXP: {  // the forward's expf(clip40(a)), inside the clip
                            const bool inr = a >= -40.f && a <= 40.f;
                            ga = inr ? g * at(V, i * WARP * 4) : 0.f;
                            break;
                        }
                        case SIN: ga = g * cosf(a); break;
                        case COS: ga = -g * sinf(a); break;
                        default: ga = -g; break;  // NEG
                    }
                    // a producer-less operand's or an input's entry of G is
                    // never read, so what lands there is dropped
                    at(G, d.y) += ga;
                    at(G, d.z) += gbv;
                }
                d = dn;
            }
        }
    }
    // each warp's sums over its lanes (xor butterfly, fixed order) into its
    // region as a row of L floats (0 in non-CONST slots); then the tape's
    // first warp adds its parts' rows in part order and writes gc
    __syncwarp();
    for (int l = lane; l < L; l += WARP) region[l] = 0.f;
    __syncwarp();
    for (int i = 0; i < n; ++i) {
        const int4 d = pg[i];
        if ((d.x & 15) != CONST) continue;
        float v = at(G, i * WARP * 4);
#pragma unroll
        for (int off = WARP / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) region[d.x >> 4] = v;
    }
    __syncthreads();
    if (t < nt && part == 0)
        for (int l = lane; l < L; l += WARP) {
            float v = region[l];
            for (int k = 1; k < parts; ++k) v += region[(size_t)k * 2 * E * WARP + l];
            gc[(size_t)tape * L + l] = v;
        }
}

// ---- launchers ----

static int check_args(int U, int P, int L, int N, int n_vars, int D) {
    if (U < 1 || P < 1 || L < 1 || L > MAXL || N < 1 || n_vars < 1 || n_vars > MAXV || D < 1 ||
        D > MAXD)
        return 1;
    return 0;
}

static cudaError_t allow_smem(const void* fn, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Geometry of a launch of K5 (kernel 5; bf16 = 1 for its bf16 mode) or K6
// (6) on N rows: the tapes per CTA and the rows one warp covers per pass
// (K5: 128 in f32, 256 in bf16; K6: 32 times the warps that share a tape).
// Returns 0, or
// cudaErrorInvalidValue when the kernel does not take these sizes.
extern "C" int tape_eval_geometry(int kernel, int bf16, int L, int D, int n_vars, int N,
                                  int* tapes_per_cta, int* rows_per_pass) {
    if (check_args(1, 1, L, N, n_vars, D) || (bf16 && kernel != 5))
        return (int)cudaErrorInvalidValue;
    int tapes = 0, parts = 1;
    if (kernel == 5) {
        tapes = k5_tapes(L, D, n_vars);
    } else if (!k6_shape(L, D, n_vars, N, &tapes, &parts)) {
        tapes = 0;
    }
    if (tapes < 1) return (int)cudaErrorInvalidValue;
    *tapes_per_cta = tapes;
    *rows_per_pass = kernel == 5 ? WARP * (bf16 ? R5BF : R5) : parts * WARP;
    return 0;
}

template <bool BF>
static int k5_launch(const int* ops, const int* args, const void* consts, const void* X, void* out,
                     int U, int P, int L, int N, int n_vars, int D, unsigned table_mask,
                     cudaStream_t stream) {
    using E = Elem<BF>;
    if (check_args(U, P, L, N, n_vars, D)) return (int)cudaErrorInvalidValue;
    const int tapes = k5_tapes(L, D, n_vars);
    if (tapes < 1) return (int)cudaErrorInvalidValue;
    const long long n_tapes = (long long)U * P;
    const long long blocks = (n_tapes + tapes - 1) / tapes;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    const size_t smem = k5_layout(tapes, L, D, n_vars).total;
    cudaError_t err = allow_smem((const void*)tape_eval_kernel<BF>, smem);
    if (err != cudaSuccess) return (int)err;
    tape_eval_kernel<BF><<<(unsigned)blocks, tapes * WARP, smem, stream>>>(
        ops, args, static_cast<const E*>(consts), static_cast<const E*>(X), static_cast<E*>(out),
        n_tapes, P, L, N, n_vars, D, table_mask);
    return (int)cudaGetLastError();
}

// K5. ops, args: (U, P, L) int32; consts (U, P, L), X (U, N, n_vars) and out
// (U, P, N) all f32 (bf16 = 0) or all bf16 (bf16 = 1). table_mask: bit k set
// when opcode k is in the op table. Returns the CUDA error of the launch (0
// on success).
extern "C" int tape_eval_launch(const int* ops, const int* args, const void* consts, const void* X,
                                void* out, int U, int P, int L, int N, int n_vars, int D,
                                unsigned table_mask, int bf16, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16)
        return k5_launch<true>(ops, args, consts, X, out, U, P, L, N, n_vars, D, table_mask, st);
    return k5_launch<false>(ops, args, consts, X, out, U, P, L, N, n_vars, D, table_mask, st);
}

// K6. As K5, plus gbar (U, P, N) f32; gc (U, P, L) f32 receives
// d sum(gbar * eval) / d consts, 0 in non-CONST slots.
extern "C" int tape_grad_launch(const int* ops, const int* args, const float* consts,
                                const float* X, const float* gbar, float* gc, int U, int P, int L,
                                int N, int n_vars, int D, unsigned table_mask, void* stream) {
    if (check_args(U, P, L, N, n_vars, D)) return (int)cudaErrorInvalidValue;
    int tapes = 0, parts = 1;
    if (!k6_shape(L, D, n_vars, N, &tapes, &parts)) return (int)cudaErrorInvalidValue;
    const long long n_tapes = (long long)U * P;
    const long long blocks = (n_tapes + tapes - 1) / tapes;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    const int warps = tapes * parts;
    const size_t smem = k6_layout(tapes, warps, L, D, n_vars).total;
    cudaError_t err = allow_smem((const void*)tape_grad_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    tape_grad_kernel<<<(unsigned)blocks, warps * WARP, smem, (cudaStream_t)stream>>>(
        ops, args, consts, X, gbar, gc, n_tapes, P, L, N, n_vars, D, table_mask, parts);
    return (int)cudaGetLastError();
}
