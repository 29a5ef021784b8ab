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
// What bounds them on this card: load latency.  Every lane-iteration is
// nc byte loads whose address hangs on the previous iteration's result;
// `cur` takes them from L2/L1 with ordinary loads, `win` from shared
// memory after the block has copied the window's nc*1024 bytes in with
// 16-byte loads.  A group of lanes is one thread block (the TPU kernel's
// whole tile: the consensus minimum is a block reduction), each thread
// keeping LPT lanes in registers; many groups in one launch fill the card.

#include <cuda_runtime.h>
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
    const int plane = gz * gx;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int l = 0; l < LPT; ++l) {
            int s = 0;
            if ((unsigned)cx[l] < (unsigned)gx && (unsigned)cz[l] < (unsigned)gz) {
                const uint8_t* p = table + cz[l] * gx + cx[l];
                for (int c = 0; c < nc; ++c) s ^= (int)p[c * plane];
            }
            cx[l] = s == never ? cz[l] : floor_mod(cx[l] + 1, gx);
            acc[l] += (unsigned)s;
        }
    }
#pragma unroll
    for (int l = 0; l < LPT; ++l) out[base + l * blockDim.x] = (int)acc[l];
}

template <int LPT>
__global__ void __launch_bounds__(512) win_kernel(
    const uint8_t* __restrict__ tw, const int* __restrict__ cx0,
    const int* __restrict__ cz0, int* __restrict__ out,
    int nwx, int nwz, int nc, int iters, int lanes, int never)
{
    __shared__ __align__(16) uint8_t blk[MAX_NC * 8 * 128];
    __shared__ int warp_min[16];
    __shared__ int window;

    const size_t base = (size_t)blockIdx.x * lanes + threadIdx.x;
    int cx[LPT], cz[LPT];
    unsigned acc[LPT];
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
        cx[l] = cx0[base + l * blockDim.x];
        cz[l] = cz0[base + l * blockDim.x];
        acc[l] = 0;
    }
    const int width = nwx * 32;
    const int block_bytes = nc * 8 * 128;
    const int warps = (blockDim.x + 31) >> 5;

    for (int i = 0; i < iters; i += 8) {
        // the window all lanes of the group agree on
        int w = 0x7fffffff;
#pragma unroll
        for (int l = 0; l < LPT; ++l)
            w = min(w, (cx[l] >> 5) * nwz + (cz[l] >> 5));
        w = __reduce_min_sync(0xffffffffu, w);
        if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = w;
        __syncthreads();
        if (threadIdx.x == 0) {
            int m = warp_min[0];
            for (int k = 1; k < warps; ++k) m = min(m, warp_min[k]);
            window = m;
        }
        __syncthreads();
        w = window;
        const int x0 = (w >= 0 ? w / nwz : -((-w + nwz - 1) / nwz)) * 32;
        const int z0 = floor_mod(w, nwz) * 32;
        // stage its block; a window index outside the table reads the
        // nearest block (an in-range index is the caller's to give)
        const int wc = min(max(w, 0), nwx * nwz - 1);
        const uint4* src = reinterpret_cast<const uint4*>(
            tw + (size_t)wc * block_bytes);
        uint4* dst = reinterpret_cast<uint4*>(blk);
        for (int k = threadIdx.x; k < block_bytes / 16; k += blockDim.x)
            dst[k] = src[k];
        __syncthreads();

        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int l = 0; l < LPT; ++l) {
                const int xl = cx[l] - x0, zrel = cz[l] - z0;
                int s = 0;
                if ((unsigned)xl < 32u && (unsigned)zrel < 32u) {
                    const uint8_t* p = blk + (zrel & 7) * 128
                        + ((zrel >> 3) << 5) + xl;
                    for (int c = 0; c < nc; ++c) s ^= (int)p[c * 1024];
                }
                cx[l] = s == never ? cz[l] : floor_mod(cx[l] + 1, width);
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
    LAUNCH_BY_LPT(win_kernel, tw, cx, cz, out, nwx, nwz, nc, iters, lanes,
                  NEVER)
    return (int)cudaGetLastError();
}
