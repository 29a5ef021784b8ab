// Voxel-extraction probe for Hopper: what one dependent voxel read costs
// from a whole-scene table in global memory against from a 32x32-column
// window staged in shared memory.
//
// Replaces the TPU kernels tools/roofline.py::_cur_kernel (called by
// bench_cur) and ::_win_kernel (called by bench_win).  Both carry lanes
// (cx, cz, acc) through `iters` iterations of
//     s = XOR over channels c of table[c, cz, cx];  acc += s;
//     cx = (cx + 1) mod width
// where the next cx takes the read's result into a select, so each read
// waits for the one before it.  `cur` reads one (nc*gz, gx) table of the
// whole scene; `win` reads the window that all lanes of a group agree on
// (the smallest window index any lane stands in, chosen anew every 8
// iterations) from a table pre-tiled into (nwx*nwz, nc*8, 128) blocks,
// row c*8 + (zrel & 7), column ((zrel >> 3) << 5) + xl; a lane outside
// that window reads 0.  The one-hot matrix products, the bf16 tables and
// the (rows, 128) tiles are the TPU's means; the integers in `acc` are
// the semantics.  Tables here are uint8 holding 0..254.
//
// What holds them on this card (PERF.md): `cur` L1's sectors, each lane's
// channel byte its own 32-byte sector of a table spread over the scene;
// `win` the instructions of its dependent step and its consensus barriers,
// well above the floor its shared loads set.  Every lane-iteration reads
// nc channel bytes of its own voxel, at an address that hangs on the
// previous iteration's result: `cur` from L2/L1 with ordinary byte loads,
// `win` from the window staged in shared memory (a lane outside the
// window reads slot 0 and keeps 0, with no branch around the load).  The
// design keeps that chain to the read and little else:
//   * the channel loop runs to the compile-time MAX_NC, each step
//     predicated on the run-time nc, so a lane's nc loads go out together
//     (looped to nc, each load waited behind the XOR before it); `cur`
//     reads channels past MAX_NC, which no lab row has, in a loop after;
//   * the next cx wraps by a compare and a select while cx + 1 lies in
//     [0, width]; any other value (a lane that starts off the table) takes
//     the floor modulo on a branch of its own, so no step divides;
//   * `win` stages the window voxel-major: voxel (zrel, xl) holds its nc
//     channel bytes together, zero-padded to an 8-byte slot (nc <= 8) or a
//     16-byte one (nc <= 16; zero is neutral to XOR), so a read is one
//     8- or 16-byte shared load and an XOR fold.  Read channel-planar, the
//     nc byte loads of a warp fell on random words of 1 KB planes and each
//     waited for its bank conflicts, nc times;
//   * `win` agrees on its window with one barrier: each warp's minimum
//     (__reduce_min_sync) goes into a shared atomicMin, in one of three
//     slots used in turn (thread 0 resets the slot two rounds ahead, which
//     no thread can touch before the next barrier), and the window is
//     staged again only when the consensus moved: the lab's `win` rows
//     therefore time that saving too.  A stage reads the window's rows as
//     4-byte words, each thread four voxels, and transposes them in
//     registers (__byte_perm) into the slots; a second barrier follows it.
//     Copying the next round's window ahead by cp.async into a second
//     buffer (predicted from the lanes 8 steps on) and transposing it from
//     there measured 6% slower: the stages are a few percent of the time,
//     and the prediction costs every round a second reduction.
// A group of lanes is one thread block (the TPU kernel's whole tile: the
// consensus minimum is a block reduction), each thread keeping LPT lanes
// in registers; many groups in one launch fill the card.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int MAX_NC = 16;

// The value the reads are compared with before the next cx is chosen.  No
// XOR of bytes equals it, so cx always steps by one; it reaches the kernels
// as an argument, so the compiler cannot know that and has to make every
// read wait for the one before it.
constexpr int NEVER = -123456;

__device__ __forceinline__ int floor_mod(int a, int m) {
    const int r = a % m;
    return r < 0 ? r + m : r;
}

// (x + 1) mod m for any x (m >= 1): a compare and a select while x + 1
// lies in [0, m], the division on a branch of its own for other values
__device__ __forceinline__ int step_mod(int x, int m) {
    const int n = (int)((unsigned)x + 1u);
    if (__builtin_expect((unsigned)n <= (unsigned)m, 1)) return n == m ? 0 : n;
    return floor_mod(n, m);
}

// the same with the in-range result selected before the branch: the window
// kernel's steps ran 6% faster so; the scene kernel at two lanes a thread
// and the window kernel at eight spilled registers so (PERF.md)
__device__ __forceinline__ int step_mod_select(int x, int m) {
    const int n = (int)((unsigned)x + 1u);
    int r = n == m ? 0 : n;
    if (__builtin_expect((unsigned)n > (unsigned)m, 0)) r = floor_mod(n, m);
    return r;
}

template <int LPT>
__global__ void __launch_bounds__(512) cur_kernel(
    const uint8_t* __restrict__ table, const int* __restrict__ cx0,
    const int* __restrict__ cz0, int* __restrict__ out,
    int gx, int gz, int nc, int iters, int lanes, int never)
{
    const size_t base = (size_t)blockIdx.x * lanes + threadIdx.x;
    int cx[LPT], cz[LPT];
    unsigned acc[LPT];
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
        cx[l] = cx0[base + l * blockDim.x];
        cz[l] = cz0[base + l * blockDim.x];
        acc[l] = 0;
    }
    const size_t plane = (size_t)gz * gx;
    // one iteration a pass: the machine code's loop is one iteration
#pragma unroll 1
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int l = 0; l < LPT; ++l) {
            int s = 0;
            if ((unsigned)cx[l] < (unsigned)gx && (unsigned)cz[l] < (unsigned)gz) {
                const uint8_t* p = table + (size_t)cz[l] * gx + cx[l];
#pragma unroll
                for (int c = 0; c < MAX_NC; ++c)
                    if (c < nc) s ^= (int)p[c * plane];
                for (int c = MAX_NC; c < nc; ++c) s ^= (int)p[c * plane];
            }
            cx[l] = s == never ? cz[l] : step_mod(cx[l], gx);
            acc[l] += (unsigned)s;
        }
    }
#pragma unroll
    for (int l = 0; l < LPT; ++l) out[base + l * blockDim.x] = (int)acc[l];
}

// a window's voxel slot: nc <= 8 channel bytes in a uint2, <= 16 in a uint4
template <int SLOT> struct SlotOf { using T = uint2; };
template <> struct SlotOf<16> { using T = uint4; };

__device__ __forceinline__ unsigned fold(uint2 v) { return v.x ^ v.y; }
__device__ __forceinline__ unsigned fold(uint4 v) {
    return (v.x ^ v.y) ^ (v.z ^ v.w);
}

// byte i of each of the four words a, b, c, d, in that order
__device__ __forceinline__ uint32_t byte_column(uint32_t a, uint32_t b,
                                                uint32_t c, uint32_t d,
                                                int i) {
    const uint32_t sel = (uint32_t)i | ((uint32_t)(i + 4) << 4);
    return __byte_perm(__byte_perm(a, b, sel), __byte_perm(c, d, sel), 0x5410);
}

template <int LPT, int SLOT>
__global__ void __launch_bounds__(512) win_kernel(
    const uint8_t* __restrict__ tw, const int* __restrict__ cx0,
    const int* __restrict__ cz0, int* __restrict__ out,
    int nwx, int nwz, int nc, int iters, int lanes, int never)
{
    using Slot = typename SlotOf<SLOT>::T;
    constexpr int WORDS = SLOT / 4;
    __shared__ Slot win[1024];      // voxel zrel * 32 + xl
    __shared__ int consensus[3];

    const size_t base = (size_t)blockIdx.x * lanes + threadIdx.x;
    int cx[LPT], cz[LPT];
    unsigned acc[LPT];
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
        cx[l] = cx0[base + l * blockDim.x];
        cz[l] = cz0[base + l * blockDim.x];
        acc[l] = 0;
    }
    if (threadIdx.x < 3) consensus[threadIdx.x] = INT_MAX;
    __syncthreads();
    const int width = nwx * 32;
    const int block_bytes = nc * 1024;
    bool have = false;
    int staged = 0;

#pragma unroll 1
    for (int i = 0, round = 0; i < iters; i += 8, ++round) {
        // the window all lanes of the group agree on
        int w = INT_MAX;
#pragma unroll
        for (int l = 0; l < LPT; ++l)
            w = min(w, (cx[l] >> 5) * nwz + (cz[l] >> 5));
        w = __reduce_min_sync(0xffffffffu, w);
        const int slot = round % 3;
        if ((threadIdx.x & 31) == 0) atomicMin(&consensus[slot], w);
        __syncthreads();
        w = consensus[slot];
        if (threadIdx.x == 0) consensus[(round + 2) % 3] = INT_MAX;
        const int x0 = (w >= 0 ? w / nwz : -((-w + nwz - 1) / nwz)) * 32;
        const int z0 = floor_mod(w, nwz) * 32;
        if (!have || w != staged) {
            // stage its block; a window index outside the table reads the
            // nearest block (an in-range index is the caller's to give)
            const int wc = min(max(w, 0), nwx * nwz - 1);
            const uint8_t* src = tw + (size_t)wc * block_bytes;
            // thread k: voxels xl = 4 * (k & 7) + 0..3 of row zrel = k >> 3,
            // a 4-byte word of each channel's row c * 8 + (zrel & 7)
            for (int k = threadIdx.x; k < 256; k += blockDim.x) {
                const int zrel = k >> 3;
                const uint8_t* row = src + (zrel & 7) * 128
                    + (zrel >> 3) * 32 + (k & 7) * 4;
                uint32_t ch[SLOT];
#pragma unroll
                for (int c = 0; c < SLOT; ++c)
                    ch[c] = c < nc ? *reinterpret_cast<const uint32_t*>(
                                         row + c * 1024) : 0u;
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                    uint32_t part[WORDS];
#pragma unroll
                    for (int g = 0; g < WORDS; ++g)
                        part[g] = byte_column(ch[4 * g], ch[4 * g + 1],
                                              ch[4 * g + 2], ch[4 * g + 3], v);
                    Slot out_slot;
                    if constexpr (SLOT == 8) {
                        out_slot = make_uint2(part[0], part[1]);
                    } else {
                        out_slot = make_uint4(part[0], part[1], part[2], part[3]);
                    }
                    win[zrel * 32 + (k & 7) * 4 + v] = out_slot;
                }
            }
            __syncthreads();
            staged = w;
            have = true;
        }

        // eight lanes a thread are enough to interleave without unrolling
        // the steps (unrolled, the 16-byte slots spill)
#pragma unroll (LPT >= 8 ? 1 : 8)
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int l = 0; l < LPT; ++l) {
                // a lane outside the window reads slot 0 and keeps 0: no
                // branch around the load
                const int xl = cx[l] - x0, zrel = cz[l] - z0;
                const bool in = (unsigned)xl < 32u && (unsigned)zrel < 32u;
                unsigned x = fold(win[in ? zrel * 32 + xl : 0]);
                x ^= x >> 16;
                const int s = in ? (int)((x ^ (x >> 8)) & 0xffu) : 0;
                if constexpr (LPT >= 8) {
                    cx[l] = s == never ? cz[l] : step_mod(cx[l], width);
                } else {
                    const int next = step_mod_select(cx[l], width);
                    cx[l] = s == never ? cz[l] : next;
                }
                acc[l] += (unsigned)s;
            }
        }
    }
#pragma unroll
    for (int l = 0; l < LPT; ++l) out[base + l * blockDim.x] = (int)acc[l];
}

// threads per block and lanes per thread of a group of `lanes` lanes:
// up to 512 threads, then 2, 4 or 8 lanes a thread
bool group_shape(int lanes, int* threads, int* lpt) {
    if (lanes < 32 || lanes % 32 != 0) return false;
    *threads = lanes < 512 ? lanes : 512;
    if (lanes % *threads != 0) return false;
    *lpt = lanes / *threads;
    return *lpt == 1 || *lpt == 2 || *lpt == 4 || *lpt == 8;
}

}  // namespace

#define LAUNCH_BY_LPT(kernel, ...)                                        \
    switch (lpt) {                                                        \
    case 1: kernel<1><<<groups, threads, 0, s>>>(__VA_ARGS__); break;     \
    case 2: kernel<2><<<groups, threads, 0, s>>>(__VA_ARGS__); break;     \
    case 4: kernel<4><<<groups, threads, 0, s>>>(__VA_ARGS__); break;     \
    default: kernel<8><<<groups, threads, 0, s>>>(__VA_ARGS__); break;    \
    }

// the window kernel for a voxel slot of SLOT bytes
template <int SLOT>
void launch_win(int lpt, int groups, int threads, cudaStream_t s,
                const uint8_t* tw, const int* cx, const int* cz, int* out,
                int nwx, int nwz, int nc, int iters, int lanes)
{
#define WIN(LPT) win_kernel<LPT, SLOT><<<groups, threads, 0, s>>>( \
        tw, cx, cz, out, nwx, nwz, nc, iters, lanes, NEVER)
    switch (lpt) {
    case 1: WIN(1); break;
    case 2: WIN(2); break;
    case 4: WIN(4); break;
    default: WIN(8); break;
    }
#undef WIN
}

// table: (nc*gz, gx) uint8; cx, cz, out: (groups, lanes) int32.
// Returns cudaGetLastError() (cudaErrorInvalidValue for a group size the
// kernel does not take).
extern "C" int ep_extract_cur(const uint8_t* table, const int* cx,
                              const int* cz, int* out, int gx, int gz,
                              int nc, int iters, int groups, int lanes,
                              void* stream)
{
    int threads, lpt;
    if (!group_shape(lanes, &threads, &lpt) || gx < 1 || gz < 1 || nc < 1)
        return (int)cudaErrorInvalidValue;
    if (groups <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    LAUNCH_BY_LPT(cur_kernel, table, cx, cz, out, gx, gz, nc, iters, lanes,
                  NEVER)
    return (int)cudaGetLastError();
}

// tw: (nwx*nwz, nc*8, 128) uint8, 16-byte aligned; cx, cz, out:
// (groups, lanes) int32.  iters rounds up to a multiple of 8.
extern "C" int ep_extract_win(const uint8_t* tw, const int* cx,
                              const int* cz, int* out, int nwx, int nwz,
                              int nc, int iters, int groups, int lanes,
                              void* stream)
{
    int threads, lpt;
    if (!group_shape(lanes, &threads, &lpt) || nwx < 1 || nwz < 1 || nc < 1
            || nc > MAX_NC || (reinterpret_cast<uintptr_t>(tw) & 15u) != 0)
        return (int)cudaErrorInvalidValue;
    if (groups <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    // a voxel's channels in an 8-byte slot up to 8 channels, else 16 bytes
    if (nc <= 8)
        launch_win<8>(lpt, groups, threads, s, tw, cx, cz, out, nwx, nwz, nc,
                      iters, lanes);
    else
        launch_win<16>(lpt, groups, threads, s, tw, cx, cz, out, nwx, nwz, nc,
                       iters, lanes);
    return (int)cudaGetLastError();
}
