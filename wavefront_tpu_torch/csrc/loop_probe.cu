// Loop-body probe for Hopper: the cost of the small bodies a tracer event
// is made of, carried through a long dependent loop, and five one-shot
// primitive checks.
//
// Replaces the TPU kernels of tools/event_lab.py: `kern` inside
// _loop_kernel (a (rows, 128) int32 state carried through `iters`
// iterations of a body) with the tool's bodies
//   issue   64 chained `a = a + 1`                         (bench_issue)
//   onehot  s = sum over r < NR of table[r, code];
//           code = (code + s % 2 + 1) % 128; acc += s       (bench_onehot;
//           NR = 64 is its i32 and outer variants, NR = 8 its i16 one)
//   zsel    per channel c < 8 pick row `code & 7` of 8 values and sum the
//           picks into s; same code and acc update          (bench_zsel)
// and the five kernels of probe_support (try_compile): int16 and int8
// compares with a row iota, a bf16 square, a per-lane row pick
// a[idx % 8, j], and a lane roll by one.  The TPU variants differ in how a
// one-hot is built for the matrix unit; that question does not exist here.
// What matters on this card is where the looked-up data lives and how a
// lane indexes it, so each body comes in these forms, all computing the
// same integers:
//   onehot  table in shared memory | global memory through __ldg |
//           constant memory (lanes of a warp read different addresses, so
//           the constant cache serialises them)
//   zsel    select tree on registers | runtime-indexed array in local
//           memory | a row of a shared-memory table
// In the TPU tool every row of a zsel channel holds the lane's code; here
// row z of channel c holds code + offset[c][z], with the offsets an input,
// so the pick is real work; zero offsets give the tool's integers.
//
// What bounds it: `issue` by the rate of dependent integer operations (the
// addend and an XOR mask between the adds are kernel arguments, so neither
// the compiler nor the assembler can fold the chain: 128 operations an
// iteration), the rest by the latency and bandwidth of the memory they
// read.  A group of rows * 128 lanes is one thread block with the lanes
// in registers, LPT to a thread.
//
// The onehot forms read the table column-major: a code's NR bytes lie
// together (64 B for NR 64, 8 B for NR 8) and are read as four 16-byte
// chunks or one 8-byte chunk, summed with __dp4a on unsigned operands
// (bytes 0..255; the sum is exact).  Read a byte at a time, the table's
// 64 loads a lane-iteration held the shared form at 97% of the card's
// shared-memory rate for byte loads; wide loads move the same 64 bytes in
// 4 loads.  A wide load is served a quarter-warp (16 B) or a half-warp
// (8 B) at a time, one 128-byte row of the 32 banks a clock, and lanes of
// one phase that fall in one 16-byte (8-byte) bank group wait for each
// other.  So the shared form of the 64-row table holds two copies, and
// each lane picks its copy and its chunk order so that the lanes of a
// quarter-warp fall in distinct groups whatever their codes: the second
// copy starts 64 B further along; a column spans half a bank row, its
// 16-byte chunks are groups 4*(code & 1) + c in the first copy and
// 4*(~code & 1) + c in the second; lane l reads copy (code ^ (l >> 2)) & 1
// and at step k chunk (k + l) & 3, so it meets group
// 4*((l >> 2) & 1) + ((k + l) & 3): distinct for the 8 lanes of a
// quarter-warp (16.1 KB of shared memory, staged once a launch).  The
// 8-row table is one column-major copy (1 KB): sixteen copies shifted so
// that a half-warp's 8-byte loads fall in distinct groups measured slower,
// the 8-row form being held by its instructions, not by its loads
// (PERF.md).  The global (__ldg) and constant forms read a column-major
// copy that the launch makes first (one small transposing kernel; one
// copy, chunks in the same staggered order): they differ from the shared
// form in where the table lives, and in the copies, which only shared
// memory's banks ask for.  Every iteration still reads all NR bytes of
// its code's column; nothing is hoisted out of the dependent loop.  The
// 64-row shared form runs at 90% of its shared-memory floor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Variant {
    ADD_CHAIN = 0,
    ONEHOT_SMEM = 1, ONEHOT_LDG = 2, ONEHOT_CONST = 3,
    ZSEL_TREE = 4, ZSEL_LOCAL = 5, ZSEL_SMEM = 6,
};

constexpr int TABLE_BYTES = 64 * 128;
__constant__ __align__(16) uint8_t c_table[TABLE_BYTES];

// the shared form's copies of an (NR, 128) table (source note)
template <int NR>
struct Copies {
    static constexpr int N = NR == 64 ? 2 : 1;
    static constexpr int STRIDE = NR * 128 + (NR == 64 ? 64 : 0);
    static constexpr int BYTES = N * STRIDE;
};

__device__ __forceinline__ unsigned add4(uint32_t w, unsigned s) {
    return __dp4a(w, 0x01010101u, s);
}

__device__ __forceinline__ unsigned add16(uint4 v) {
    // two independent chains, so that no add waits for three others
    return add4(v.x, add4(v.y, 0u)) + add4(v.z, add4(v.w, 0u));
}

__device__ __forceinline__ unsigned add8(uint2 v) {
    return add4(v.x, add4(v.y, 0u));
}

// s = sum over r < NR of table[r, code] from a column-major table at
// `cols` (code * NR + r), chunks in the order given by `rot`; 0 when code
// is outside [0, 128) (the one-hot of such a code is empty)
template <int NR, typename Chunk16, typename Chunk8>
__device__ __forceinline__ int column_sum(int code, int rot, Chunk16 c16,
                                          Chunk8 c8) {
    if ((unsigned)code >= 128u) return 0;
    if constexpr (NR == 64) {
        unsigned s = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) s += add16(c16(code * 64 + ((k + rot) & 3) * 16));
        return (int)s;
    } else {
        return (int)add8(c8(code * 8));
    }
}

__device__ __forceinline__ int pick_tree(const int* v, int z) {
    const int a = (z & 1) ? v[1] : v[0], b = (z & 1) ? v[3] : v[2];
    const int c = (z & 1) ? v[5] : v[4], d = (z & 1) ? v[7] : v[6];
    const int e = (z & 2) ? b : a, f = (z & 2) ? d : c;
    return (z & 4) ? f : e;
}

// the column-major copy of a row-major (nr, 128) table: cols[code * nr + r]
__global__ void column_major_kernel(const uint8_t* __restrict__ table,
                                    uint8_t* __restrict__ cols, int nr)
{
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k < nr * 128) cols[(k & 127) * nr + (k >> 7)] = table[k];
}

template <int V, int NR, int LPT>
__global__ void __launch_bounds__(512) loop_kernel(
    const int* __restrict__ code0, const int* __restrict__ acc0,
    const uint8_t* __restrict__ table, const int* __restrict__ offsets,
    int* __restrict__ code_out, int* __restrict__ acc_out,
    int iters, int lanes, int one, int zero)
{
    __shared__ __align__(16) uint8_t s_table[
        V == ONEHOT_SMEM ? Copies<NR>::BYTES : 16];
    __shared__ int s_off[V == ZSEL_SMEM ? 64 : 1];
    if constexpr (V == ONEHOT_SMEM) {
        // eight rows of a code's column a thread: byte loads that are
        // coalesced across the warp's codes, one 8-byte store a copy
        for (int k = threadIdx.x; k < NR * 16; k += blockDim.x) {
            const int code = k & 127, h = k >> 7;
            uint32_t lo = 0, hi = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                lo |= (uint32_t)table[(8 * h + i) * 128 + code] << (8 * i);
                hi |= (uint32_t)table[(8 * h + 4 + i) * 128 + code] << (8 * i);
            }
            const uint2 u = make_uint2(lo, hi);
#pragma unroll
            for (int q = 0; q < Copies<NR>::N; ++q)
                *reinterpret_cast<uint2*>(
                    s_table + q * Copies<NR>::STRIDE + code * NR + 8 * h) = u;
        }
    }
    if constexpr (V == ZSEL_SMEM) {
        for (int k = threadIdx.x; k < 64; k += blockDim.x)
            s_off[k] = offsets[k];
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const size_t base = (size_t)blockIdx.x * lanes + threadIdx.x;
    int code[LPT];
    unsigned acc[LPT];
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
        code[l] = code0[base + l * blockDim.x];
        acc[l] = V == ADD_CHAIN ? 0u : (unsigned)acc0[base + l * blockDim.x];
    }
    int off[(V == ZSEL_TREE || V == ZSEL_LOCAL) ? 64 : 1];
    if constexpr (V == ZSEL_TREE || V == ZSEL_LOCAL) {
#pragma unroll
        for (int k = 0; k < 64; ++k) off[k] = offsets[k];
    }

    auto step = [&]() {
        if constexpr (V == ADD_CHAIN) {
            // 64 adds per lane, each followed by an XOR with a zero the
            // assembler cannot see: it merges a bare chain of adds of one
            // addend (64 adds came out as 32 instructions).  The lanes'
            // chains are interleaved.
#pragma unroll
            for (int k = 0; k < 64; ++k) {
#pragma unroll
                for (int l = 0; l < LPT; ++l)
                    code[l] = (code[l] + one) ^ zero;
            }
        } else {
#pragma unroll
            for (int l = 0; l < LPT; ++l) {
                int s = 0;
                if constexpr (V == ONEHOT_SMEM) {
                    // the copy and chunk order of the source note
                    const uint8_t* t = s_table;
                    if constexpr (NR == 64)
                        t += ((code[l] ^ (lane >> 2)) & 1) * Copies<NR>::STRIDE;
                    s = column_sum<NR>(
                        code[l], lane,
                        [&](int k) { return *reinterpret_cast<const uint4*>(t + k); },
                        [&](int k) { return *reinterpret_cast<const uint2*>(t + k); });
                }
                if constexpr (V == ONEHOT_LDG)
                    s = column_sum<NR>(
                        code[l], lane,
                        [&](int k) { return __ldg(reinterpret_cast<const uint4*>(table + k)); },
                        [&](int k) { return __ldg(reinterpret_cast<const uint2*>(table + k)); });
                if constexpr (V == ONEHOT_CONST)
                    s = column_sum<NR>(
                        code[l], lane,
                        [&](int k) { return *reinterpret_cast<const uint4*>(c_table + k); },
                        [&](int k) { return *reinterpret_cast<const uint2*>(c_table + k); });
                if constexpr (V == ZSEL_TREE) {
#pragma unroll
                    for (int c = 0; c < 8; ++c) {
                        int v[8];
#pragma unroll
                        for (int z = 0; z < 8; ++z) v[z] = code[l] + off[c * 8 + z];
                        s += pick_tree(v, code[l] & 7);
                    }
                }
                if constexpr (V == ZSEL_LOCAL) {
#pragma unroll
                    for (int c = 0; c < 8; ++c) {
                        // volatile keeps the array in local memory: left to
                        // itself the compiler turns the indexed read of eight
                        // known registers into the select chain of zsel_tree
                        volatile int v[8];
#pragma unroll
                        for (int z = 0; z < 8; ++z) v[z] = code[l] + off[c * 8 + z];
                        s += v[code[l] & 7];
                    }
                }
                if constexpr (V == ZSEL_SMEM) {
#pragma unroll
                    for (int c = 0; c < 8; ++c)
                        s += code[l] + s_off[c * 8 + (code[l] & 7)];
                }
                // s >= 0, so s % 2 is its low bit; & 127 is the floor modulo
                code[l] = (code[l] + (s & 1) + 1) & 127;
                acc[l] += (unsigned)s;
            }
        }
    };
    if constexpr (V == ONEHOT_SMEM || V == ONEHOT_LDG || V == ONEHOT_CONST) {
        // one iteration a pass, so that the machine code's loop is one
        // iteration of the body (probe_check counts its loads)
#pragma unroll 1
        for (int it = 0; it < iters; ++it) step();
    } else {
        for (int it = 0; it < iters; ++it) step();
    }
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
        code_out[base + l * blockDim.x] = code[l];
        if (V != ADD_CHAIN) acc_out[base + l * blockDim.x] = (int)acc[l];
    }
}

bool group_shape(int lanes, int* threads, int* lpt) {
    if (lanes < 32 || lanes % 32 != 0) return false;
    *threads = lanes < 512 ? lanes : 512;
    if (lanes % *threads != 0) return false;
    *lpt = lanes / *threads;
    return *lpt == 1 || *lpt == 2 || *lpt == 4 || *lpt == 8;
}

template <int V, int NR>
void launch(int lpt, int groups, int threads, cudaStream_t s,
            const int* code, const int* acc, const uint8_t* table,
            const int* offsets, int* code_out, int* acc_out, int iters,
            int lanes)
{
    switch (lpt) {
    case 1: loop_kernel<V, NR, 1><<<groups, threads, 0, s>>>(
        code, acc, table, offsets, code_out, acc_out, iters, lanes, 1, 0); break;
    case 2: loop_kernel<V, NR, 2><<<groups, threads, 0, s>>>(
        code, acc, table, offsets, code_out, acc_out, iters, lanes, 1, 0); break;
    case 4: loop_kernel<V, NR, 4><<<groups, threads, 0, s>>>(
        code, acc, table, offsets, code_out, acc_out, iters, lanes, 1, 0); break;
    default: loop_kernel<V, NR, 8><<<groups, threads, 0, s>>>(
        code, acc, table, offsets, code_out, acc_out, iters, lanes, 1, 0); break;
    }
}

// ---- the five primitives of probe_support ----

// out[i, j] = (int16 or int8)(a[i, j]) == (same type)(i), a: (128, 128)
template <typename T>
__global__ void narrow_cmp_kernel(const int* __restrict__ a,
                                  int* __restrict__ out)
{
    const int i = blockIdx.x, j = threadIdx.x;
    out[i * 128 + j] = (T)a[i * 128 + j] == (T)i ? 1 : 0;
}

// out = int(bf16(a) * bf16(a)), both roundings to nearest even
__global__ void bf16_square_kernel(const int* __restrict__ a,
                                   int* __restrict__ out)
{
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    const __nv_bfloat16 b = __float2bfloat16_rn((float)a[e]);
    out[e] = (int)__bfloat162float(__hmul(b, b));
}

// out[i, j] = int(a[idx[i, j] mod 8, j]), a: (8, 128) float32.  A warp
// holds 4 columns x 8 rows, row i of column j in lane (j & 3) * 8 + i, and
// picks by a shuffle from a runtime lane.
__global__ void row_pick_kernel(const float* __restrict__ a,
                                const int* __restrict__ idx,
                                int* __restrict__ out)
{
    const int lane = threadIdx.x & 31;
    const int j = (blockIdx.x * blockDim.x + threadIdx.x) / 32 * 4 + (lane >> 3);
    const int i = lane & 7;
    const float mine = a[i * 128 + j];
    const int src = (lane & 24) | (idx[i * 128 + j] & 7);
    out[i * 128 + j] = (int)__shfl_sync(0xffffffffu, mine, src);
}

// out[i, j] = int(a[i, (j - 1) mod 128]), a: (8, 128) float32: a shuffle
// from the lane below; lane 0 of a warp takes its word from memory
__global__ void lane_roll_kernel(const float* __restrict__ a,
                                 int* __restrict__ out)
{
    const int i = blockIdx.x, j = threadIdx.x, lane = j & 31;
    const float mine = a[i * 128 + j];
    float got = __shfl_sync(0xffffffffu, mine, (lane + 31) & 31);
    if (lane == 0) got = a[i * 128 + ((j + 127) & 127)];
    out[i * 128 + j] = (int)got;
}

}  // namespace

// code, acc, code_out, acc_out: (groups, lanes) int32 (acc and acc_out
// unused by `issue`); table: (nr, 128) uint8 with nr 8 or 64 (onehot);
// cols: nr * 128 bytes of scratch, 16-byte aligned, for the column-major
// copy of the global and constant forms (else unused);
// offsets: (8, 8) int32 (zsel).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a variant, nr, alignment or group size it
// does not take.
extern "C" int lp_loop(int variant, int nr, const int* code, const int* acc,
                       const uint8_t* table, uint8_t* cols,
                       const int* offsets, int* code_out, int* acc_out,
                       int iters, int groups, int lanes, void* stream)
{
    int threads, lpt;
    if (!group_shape(lanes, &threads, &lpt)) return (int)cudaErrorInvalidValue;
    if (groups <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const bool onehot = variant >= ONEHOT_SMEM && variant <= ONEHOT_CONST;
    if (onehot && nr != 8 && nr != 64) return (int)cudaErrorInvalidValue;
    if (variant == ONEHOT_LDG || variant == ONEHOT_CONST) {
        if ((reinterpret_cast<uintptr_t>(cols) & 15u) != 0)
            return (int)cudaErrorInvalidValue;
        column_major_kernel<<<(nr * 128 + 255) / 256, 256, 0, s>>>(table, cols, nr);
        table = cols;
    }
    if (variant == ONEHOT_CONST) {
        cudaError_t err = cudaMemcpyToSymbolAsync(
            c_table, cols, nr * 128, 0, cudaMemcpyDeviceToDevice, s);
        if (err != cudaSuccess) return (int)err;
    }
#define GO(V, NR) launch<V, NR>(lpt, groups, threads, s, code, acc, table, \
                                offsets, code_out, acc_out, iters, lanes)
    switch (variant) {
    case ADD_CHAIN: GO(ADD_CHAIN, 8); break;
    case ONEHOT_SMEM: if (nr == 64) GO(ONEHOT_SMEM, 64); else GO(ONEHOT_SMEM, 8); break;
    case ONEHOT_LDG: if (nr == 64) GO(ONEHOT_LDG, 64); else GO(ONEHOT_LDG, 8); break;
    case ONEHOT_CONST: if (nr == 64) GO(ONEHOT_CONST, 64); else GO(ONEHOT_CONST, 8); break;
    case ZSEL_TREE: GO(ZSEL_TREE, 8); break;
    case ZSEL_LOCAL: GO(ZSEL_LOCAL, 8); break;
    case ZSEL_SMEM: GO(ZSEL_SMEM, 8); break;
    default: return (int)cudaErrorInvalidValue;
    }
#undef GO
    return (int)cudaGetLastError();
}

// which: 0 int16 compare, 1 int8 compare, 2 bf16 square (a, out:
// (128, 128) int32); 3 row pick (a: (8, 128) float32, b: (8, 128) int32
// indices, out: (8, 128) int32); 4 lane roll (a: (8, 128) float32).
extern "C" int lp_primitive(int which, const void* a, const void* b,
                            int* out, void* stream)
{
    cudaStream_t s = (cudaStream_t)stream;
    switch (which) {
    case 0: narrow_cmp_kernel<int16_t><<<128, 128, 0, s>>>((const int*)a, out); break;
    case 1: narrow_cmp_kernel<int8_t><<<128, 128, 0, s>>>((const int*)a, out); break;
    case 2: bf16_square_kernel<<<64, 256, 0, s>>>((const int*)a, out); break;
    case 3: row_pick_kernel<<<8, 128, 0, s>>>((const float*)a, (const int*)b, out); break;
    case 4: lane_roll_kernel<<<8, 128, 0, s>>>((const float*)a, out); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
