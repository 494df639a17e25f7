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
// slots and over the opcodes, because Mosaic has no dynamic indexing. Here
// every thread of a CTA walks the same tape on its own row, so the opcode and
// the stack pointer are uniform across the CTA: dispatch is a real switch and
// the stack is a column of shared memory indexed by the uniform pointer.
//
//   K5  tape_eval_kernel: one CTA per (tape, tile of TR rows); the tape's
//       slots are staged in shared memory once per CTA; out (U, P, N).
//   K6  tape_grad_kernel: one CTA per tape, looping over all row tiles. Per
//       row a forward replay saves the slot each step overwrites; the
//       reverse sweep then restores it and pushes the operand cotangents
//       with the partials of the JAX kernel (:361-392). Each thread sums its
//       rows' CONST cotangents per slot; a fixed-order tree over the CTA
//       then gives the row sum. No atomics, so two runs give the same bits.
//
// Semantics, as the JAX interpreter (symgp/tape.py eval_tapes): DIV gives 1
// where |den| <= 1e-9; EXP clips its operand to [-40, 40]; a leaf pushed
// with the stack full makes the tape's output NaN (and its gradient seed
// 0); PAD is a no-op; reads below slot 0 clamp to slot 0; a live opcode
// outside the op table yields 0. Stack reads add +0.0f, as the reference's
// where-mask-then-sum does, so -0 reads as +0 and outputs match bit for bit.
// Build with --fmad=false and IEEE division; expf/sinf/cosf at full
// precision (no fast math).
//
// What bounds it: on the GP path it moves tapes (12 bytes a slot), rows
// and predictions once, and does one f32 operation per live step and row;
// at the shipped sizes (20 x 1024 tapes, 2,500 rows, ~8 live steps) the
// 205 MB of predictions make K5 bytes-bound (~0.06 ms at 3.35 TB/s). Rows
// past N are never read or written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TR 128        // rows per CTA (K5) and per row tile (K6)
#define MAXD 64       // deepest stack the kernels take

enum { PAD = 0, CONST = 1, VAR = 2, ADD = 3, SUB = 4, MUL = 5, DIV = 6, EXP = 7, SIN = 8,
       COS = 9, NEG = 10 };

__device__ __forceinline__ int arity_of(int op) {
    op = op < 0 ? 0 : (op > NEG ? NEG : op);
    return op >= EXP ? 1 : (op >= ADD ? 2 : 0);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// jnp.clip: NaN stays NaN (fminf/fmaxf would drop it)
__device__ __forceinline__ float clip40(float a) {
    return (a < -40.f) ? -40.f : ((a > 40.f) ? 40.f : a);
}

// The result of one live step; `in_table` says whether the op table holds op.
__device__ __forceinline__ float op_result(int op, bool in_table, float a, float b, float cval,
                                           float var_val) {
    if (!in_table) return 0.f;
    switch (op) {
        case CONST: return cval;
        case VAR: return var_val;
        case ADD: return b + a;
        case SUB: return b - a;
        case MUL: return b * a;
        case DIV: return (fabsf(a) > 1e-9f) ? b / a : 1.f;
        case EXP: return expf(clip40(a));
        case SIN: return sinf(a);
        case COS: return cosf(a);
        case NEG: return -a;
        default: return 0.f;
    }
}

// Shared memory of both kernels: the tape's slots, then per-row columns.
struct TapeSlots {
    int* op;
    int* arg;
    float* c;
};

__device__ __forceinline__ void stage_tape(TapeSlots& t, const int* __restrict__ ops,
                                           const int* __restrict__ args,
                                           const float* __restrict__ consts, size_t tape, int L) {
    for (int l = threadIdx.x; l < L; l += blockDim.x) {
        t.op[l] = ops[tape * L + l];
        t.arg[l] = args[tape * L + l];
        t.c[l] = consts[tape * L + l];
    }
}

// grid (U * P, ceil(N / TR)), TR threads; smem 3 L words + D * TR floats
__global__ void __launch_bounds__(TR) tape_eval_kernel(
    const int* __restrict__ ops, const int* __restrict__ args, const float* __restrict__ consts,
    const float* __restrict__ X, float* __restrict__ out, int P, int L, int N, int n_vars, int D,
    unsigned table_mask) {
    extern __shared__ int smem[];
    TapeSlots t{smem, smem + L, reinterpret_cast<float*>(smem + 2 * L)};
    float* stack = reinterpret_cast<float*>(smem + 3 * L);  // stack[d * TR + tid]
    const size_t tape = blockIdx.x;
    const int u = (int)(tape / P);
    stage_tape(t, ops, args, consts, tape, L);
    __syncthreads();
    const int tid = threadIdx.x;
    const int row = blockIdx.y * TR + tid;
    if (row >= N) return;
    const float* x = X + ((size_t)u * N + row) * n_vars;
    for (int d = 0; d < D; ++d) stack[d * TR + tid] = 0.f;
    int sp = 0;
    bool bad = false;
    for (int l = 0; l < L; ++l) {
        const int op = t.op[l];
        if (op == PAD) continue;
        const int ar = arity_of(op);
        const float a = stack[clampi(sp - 1, 0, D - 1) * TR + tid] + 0.f;
        const float b = stack[clampi(sp - 2, 0, D - 1) * TR + tid] + 0.f;
        const float v = (op == VAR) ? x[clampi(t.arg[l], 0, n_vars - 1)] : 0.f;
        const bool in_table = op >= 0 && op <= NEG && ((table_mask >> op) & 1u);
        const float r = op_result(op, in_table, a, b, t.c[l], v);
        bad |= (ar == 0 && sp >= D);
        stack[clampi(sp - ar, 0, D - 1) * TR + tid] = r;
        sp = clampi(sp + 1 - ar, 0, D);
    }
    const float y = stack[clampi(sp - 1, 0, D - 1) * TR + tid] + 0.f;
    out[tape * N + row] = bad ? __int_as_float(0x7fc00000) : y;
}

// grid (U * P), TR threads; smem: 3 L words, L stack pointers, 2 words
// (final sp, bad), then per row column: stack, gstack (D each), saved and
// the CONST sums (L each).
__global__ void __launch_bounds__(TR) tape_grad_kernel(
    const int* __restrict__ ops, const int* __restrict__ args, const float* __restrict__ consts,
    const float* __restrict__ X, const float* __restrict__ gbar, float* __restrict__ gc, int P,
    int L, int N, int n_vars, int D, unsigned table_mask) {
    extern __shared__ int smem[];
    TapeSlots t{smem, smem + L, reinterpret_cast<float*>(smem + 2 * L)};
    int* sps = smem + 3 * L;        // stack pointer before step l
    int* fin = sps + L;             // fin[0]: final sp, fin[1]: bad
    float* stack = reinterpret_cast<float*>(fin + 2);
    float* gstack = stack + D * TR;
    float* saved = gstack + D * TR;  // saved[l * TR + tid]
    float* gsum = saved + L * TR;    // gsum[l * TR + tid]
    const size_t tape = blockIdx.x;
    const int u = (int)(tape / P);
    const int tid = threadIdx.x;
    stage_tape(t, ops, args, consts, tape, L);
    __syncthreads();
    if (tid == 0) {  // the control flow depends on the opcodes alone
        int sp = 0, bad = 0;
        for (int l = 0; l < L; ++l) {
            sps[l] = sp;
            const int op = t.op[l];
            if (op == PAD) continue;
            const int ar = arity_of(op);
            bad |= (ar == 0 && sp >= D);
            sp = clampi(sp + 1 - ar, 0, D);
        }
        fin[0] = sp;
        fin[1] = bad;
    }
    for (int l = 0; l < L; ++l) gsum[l * TR + tid] = 0.f;
    __syncthreads();
    const int i_out = clampi(fin[0] - 1, 0, D - 1);
    const bool bad = fin[1] != 0;

    for (int row0 = 0; row0 < N; row0 += TR) {
        const int row = row0 + tid;
        if (row >= N) break;  // rows past N contribute exactly 0
        const float* x = X + ((size_t)u * N + row) * n_vars;
        // forward replay, saving the slot each live step overwrites
        for (int d = 0; d < D; ++d) stack[d * TR + tid] = 0.f;
        for (int l = 0; l < L; ++l) {
            const int op = t.op[l];
            if (op == PAD) continue;
            const int sp = sps[l], ar = arity_of(op);
            const float a = stack[clampi(sp - 1, 0, D - 1) * TR + tid] + 0.f;
            const float b = stack[clampi(sp - 2, 0, D - 1) * TR + tid] + 0.f;
            const float v = (op == VAR) ? x[clampi(t.arg[l], 0, n_vars - 1)] : 0.f;
            const bool in_table = op >= 0 && op <= NEG && ((table_mask >> op) & 1u);
            const int w = clampi(sp - ar, 0, D - 1);
            saved[l * TR + tid] = stack[w * TR + tid] + 0.f;
            stack[w * TR + tid] = op_result(op, in_table, a, b, t.c[l], v);
        }
        // seed: d out / d stack[i_out]; a bad tape gets exactly 0
        for (int d = 0; d < D; ++d) gstack[d * TR + tid] = 0.f;
        gstack[i_out * TR + tid] = bad ? 0.f : gbar[tape * N + row];
        // reverse sweep
        for (int l = L - 1; l >= 0; --l) {
            const int op = t.op[l];
            if (op == PAD) continue;
            const int sp = sps[l], ar = arity_of(op);
            const int w = clampi(sp - ar, 0, D - 1);
            const float g = gstack[w * TR + tid] + 0.f;
            gstack[w * TR + tid] = 0.f;
            stack[w * TR + tid] = saved[l * TR + tid];
            const int i1 = clampi(sp - 1, 0, D - 1), i2 = clampi(sp - 2, 0, D - 1);
            const float a = stack[i1 * TR + tid] + 0.f;
            const float b = stack[i2 * TR + tid] + 0.f;
            const bool in_table = op >= 0 && op <= NEG && ((table_mask >> op) & 1u);
            float ga = 0.f, gb = 0.f;
            if (in_table) {
                switch (op) {
                    case CONST: gsum[l * TR + tid] += g; break;
                    case ADD: ga = g; gb = g; break;
                    case SUB: ga = -g; gb = g; break;
                    case MUL: ga = g * b; gb = g * a; break;
                    case DIV: {
                        const bool ok = fabsf(a) > 1e-9f;
                        const float den = ok ? a : 1.f;
                        ga = ok ? (-g * b) / (den * den) : 0.f;
                        gb = ok ? g / den : 0.f;
                        break;
                    }
                    case EXP: {
                        const bool inr = a >= -40.f && a <= 40.f;
                        ga = inr ? g * expf(clip40(a)) : 0.f;
                        break;
                    }
                    case SIN: ga = g * cosf(a); break;
                    case COS: ga = -g * sinf(a); break;
                    case NEG: ga = -g; break;
                    default: break;
                }
            }
            if (ar >= 1) gstack[i1 * TR + tid] += ga;
            if (ar == 2) gstack[i2 * TR + tid] += gb;
        }
    }
    // fixed-order tree over the CTA's threads, every CONST slot at once
    for (int s = TR / 2; s > 0; s >>= 1) {
        __syncthreads();
        if (tid < s)
            for (int l = 0; l < L; ++l)
                if (t.op[l] == CONST) gsum[l * TR + tid] += gsum[l * TR + tid + s];
    }
    __syncthreads();
    for (int l = tid; l < L; l += TR) gc[tape * L + l] = (t.op[l] == CONST) ? gsum[l * TR] : 0.f;
}

static size_t eval_smem(int L, int D) { return (size_t)3 * L * 4 + (size_t)D * TR * 4; }

static size_t grad_smem(int L, int D) {
    return (size_t)(4 * L + 2) * 4 + (size_t)(2 * D + 2 * L) * TR * 4;
}

static int check_args(int U, int P, int L, int N, int n_vars, int D) {
    if (U < 1 || P < 1 || L < 1 || N < 1 || n_vars < 1 || D < 1 || D > MAXD) return 1;
    if ((long long)U * P > 2147483647LL) return 1;
    return 0;
}

static cudaError_t allow_smem(const void* fn, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// K5. ops, args: (U, P, L) int32; consts (U, P, L) f32; X (U, N, n_vars)
// f32; out (U, P, N) f32. table_mask: bit k set when opcode k is in the
// op table. Returns the CUDA error of the launch (0 on success).
extern "C" int tape_eval_launch(const int* ops, const int* args, const float* consts,
                                const float* X, float* out, int U, int P, int L, int N, int n_vars,
                                int D, unsigned table_mask, void* stream) {
    if (check_args(U, P, L, N, n_vars, D)) return (int)cudaErrorInvalidValue;
    const int tiles = (N + TR - 1) / TR;
    if (tiles > 65535) return (int)cudaErrorInvalidValue;
    const size_t smem = eval_smem(L, D);
    cudaError_t err = allow_smem((const void*)tape_eval_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)(U * P), (unsigned)tiles);
    tape_eval_kernel<<<grid, TR, smem, (cudaStream_t)stream>>>(ops, args, consts, X, out, P, L, N,
                                                              n_vars, D, table_mask);
    return (int)cudaGetLastError();
}

// K6. As K5, plus gbar (U, P, N) f32; gc (U, P, L) f32 receives
// d sum(gbar * eval) / d consts, 0 in non-CONST slots.
extern "C" int tape_grad_launch(const int* ops, const int* args, const float* consts,
                                const float* X, const float* gbar, float* gc, int U, int P, int L,
                                int N, int n_vars, int D, unsigned table_mask, void* stream) {
    if (check_args(U, P, L, N, n_vars, D)) return (int)cudaErrorInvalidValue;
    const size_t smem = grad_smem(L, D);
    cudaError_t err = allow_smem((const void*)tape_grad_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    tape_grad_kernel<<<(unsigned)(U * P), TR, smem, (cudaStream_t)stream>>>(
        ops, args, consts, X, gbar, gc, P, L, N, n_vars, D, table_mask);
    return (int)cudaGetLastError();
}
