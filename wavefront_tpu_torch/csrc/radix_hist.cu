// Radix-sort digit histogram for Hopper: 256-bin counts of one 8-bit digit
// of 32-bit keys (and, in one read of the keys, of all four digits), and
// optionally their inclusive prefix sums, the spine of an LSD radix pass.
//
// Replaces the TPU kernel tools/radix_lab.py::hist_kernel (called by
// hist_pass(), whose radix_hist() takes the spine with a cumsum).  That
// kernel builds a (256, tile) one-hot of the digit, multiplies it by a
// column of ones on the matrix unit and adds the result into one (1, 256)
// float32 block across a sequential grid.  The one-hot product, the
// float32 counts, the 2048-key tiles and the zero padding are the TPU's
// means; what it computes is the count of keys per digit value, and that
// is what this kernel returns, as int32, with no padding.
//
// What bounds it on this card: bytes.  Each key is read once (4 B) and
// 256 counts (1,024 in one read) are written; at 2,073,600 keys that is
// 8.3 MB, 0.0025 ms at the card's memory rate.  What holds it (PERF.md,
// measured on an H100): the shared-memory atomics, one a key and digit,
// and the global atomics that add the blocks' totals, which queue on the
// output's words.  The design:
//
//  * Lane columns.  A block of 1024 threads counts into one histogram in
//    shared memory held as 32 lane columns: lane l of every warp counts
//    bin b (d * 256 + digit value) at word b * 32 + l, so a warp's 32
//    atomics always hit 32 banks, whatever its digits.  With one copy a
//    warp, lanes of different values collide in banks: the same time for
//    one digit, 1.17x for four.  The block sums each bin's 32 columns in a
//    rotated order that keeps those reads conflict-free too.
//  * One block a SM (the four-digit columns take 128 KB): 132 blocks add
//    their totals into the output, not the 507 of the first design.  Each
//    of those global atomics queues at its word in L2, and with all 256
//    values present in every block their number, not the bank conflicts,
//    made spread keys cost 2.4x coherent ones in the first design.
//  * One device operation a call, with nothing filled before it.  The
//    block that takes the first start ticket (atomicInc, which wraps back
//    to 0 at the grid's size) zeroes the output and raises a flag to the
//    call's generation; every block waits for the flag before it adds its
//    totals, by then long raised.  Waiting only on a block that has
//    started cannot deadlock.  For the spine, the block that takes the
//    last end ticket turns the counts into prefix sums in place.  The
//    tickets and the flag (WORK_WORDS int32) outlive a call: the caller
//    keeps them for each device and stream (kernels/radix_hist.py), so
//    that two launches never share them at once, zeroes them once, by the
//    memset that `fresh` asks for on a stream's first launch, and gives
//    each launch a generation other than the last one's.  A launch that is
//    refused never touches them.  A memset of the output before the kernel
//    measured 1.0-1.1 us more a call, and a last block that sums copies of
//    a kept accumulator 0.9-2.5 us more.
//
// Keys are read 16 bytes a thread from the first 16-byte boundary on, with
// the (at most 3) keys before it and the tail read one at a time.  Integer
// adds keep the result independent of the order in which blocks finish.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 1024;
constexpr int WARPS = BLOCK / 32;
// the workspace: the start ticket, the end ticket and the flag
constexpr int START = 0;
constexpr int TICKET = 1;
constexpr int FLAG = 2;
constexpr int WORK_WORDS = 3;
constexpr int MAX_DEVICES = 64;

// ND digits a key: digit d is (key >> (shift + 8 d)) & 255 and counts into
// bin d * 256 + digit, in lane `lane`'s column
template <int ND>
__device__ __forceinline__ void count_key(int* cols, uint32_t k, int shift,
                                          int lane) {
#pragma unroll
    for (int d = 0; d < ND; ++d)
        atomicAdd(&cols[((d * 256 + ((k >> (shift + 8 * d)) & 255u)) << 5)
                        | lane], 1);
}

template <int ND>
__global__ void __launch_bounds__(BLOCK) hist_kernel(
    const uint32_t* __restrict__ keys, int n, int shift, int spine,
    int* __restrict__ work, int gen, int* __restrict__ out)
{
    constexpr int BINS = ND * 256;
    extern __shared__ int4 cols4[];                  // BINS * 32 columns
    int* cols = reinterpret_cast<int*>(cols4);
    __shared__ int warp_sum[WARPS];
    __shared__ bool chosen;
    const int lane = threadIdx.x & 31;

    // the keys before the first 16-byte boundary, the 16-byte body, the tail
    const int head = min(n, (int)(((16u - ((uintptr_t)keys & 15u)) & 15u)
                                  >> 2));
    const int n4 = (n - head) >> 2;
    const uint4* keys4 = reinterpret_cast<const uint4*>(keys + head);
    const int tid = blockIdx.x * BLOCK + threadIdx.x;
    const int stride = gridDim.x * BLOCK;

    // a thread's first load and the start ticket go out before the columns
    // are zeroed; the block that takes the first ticket zeroes the output
    // and raises the flag to this call's generation
    uint4 v = tid < n4 ? __ldg(keys4 + tid) : uint4{};
    if (threadIdx.x == 0)
        chosen = atomicInc(reinterpret_cast<unsigned*>(work + START),
                           gridDim.x - 1) == 0;
    for (int k = threadIdx.x; k < BINS * 32 / 4; k += BLOCK)
        cols4[k] = make_int4(0, 0, 0, 0);
    __syncthreads();
    if (chosen) {
        for (int b = threadIdx.x; b < BINS; b += BLOCK) out[b] = 0;
        __syncthreads();
        if (threadIdx.x == 0)
            cuda::atomic_ref<int, cuda::thread_scope_device>(work[FLAG])
                .store(gen, cuda::memory_order_release);
    }

    for (int i = tid; i < n4; i += stride) {
        count_key<ND>(cols, v.x, shift, lane);
        count_key<ND>(cols, v.y, shift, lane);
        count_key<ND>(cols, v.z, shift, lane);
        count_key<ND>(cols, v.w, shift, lane);
        if (i + stride < n4) v = __ldg(keys4 + i + stride);
    }
    if (tid < head) count_key<ND>(cols, keys[tid], shift, lane);
    for (int i = head + 4 * n4 + tid; i < n; i += stride)
        count_key<ND>(cols, keys[i], shift, lane);

    // the output is zeroed once the flag holds this call's generation: the
    // block's last thread waits for it, and the barrier orders every
    // thread's adds after the wait
    if (threadIdx.x == BLOCK - 1) {
        cuda::atomic_ref<int, cuda::thread_scope_device> f(work[FLAG]);
        while (f.load(cuda::memory_order_acquire) != gen) {
        }
    }
    __syncthreads();

    // the block's totals, bin b's 32 columns read from column b + k so that
    // a warp's 32 bins read 32 banks, added into the output
    for (int b = threadIdx.x; b < BINS; b += BLOCK) {
        int s = 0;
#pragma unroll 8
        for (int k = 0; k < 32; ++k) s += cols[(b << 5) | ((b + k) & 31)];
        if (s != 0) atomicAdd(&out[b], s);
    }
    if (!spine) return;

    // the spine: the last block to take the end ticket turns the counts
    // into their prefix sums.  The barrier orders the block's adds before
    // thread 0's release; its acquire, and the barrier, order the last
    // block's reads after every other block's adds.
    __syncthreads();
    if (threadIdx.x == 0) {
        cuda::atomic_ref<int, cuda::thread_scope_device> t(work[TICKET]);
        chosen = t.fetch_add(1, cuda::memory_order_acq_rel)
            == (int)gridDim.x - 1;
        if (chosen) t.store(0, cuda::memory_order_relaxed);
    }
    __syncthreads();
    if (!chosen) return;
    for (int base = 0; base < BINS; base += BLOCK) {
        const int b = base + threadIdx.x;
        int c = b < BINS ? __ldcg(&out[b]) : 0;
        // inclusive scan of each 256-bin row: within the warp, then the
        // sums of the row's earlier warps (8 warps a row)
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int up = __shfl_up_sync(0xffffffffu, c, o);
            if (lane >= o) c += up;
        }
        const int warp = threadIdx.x >> 5;
        if (lane == 31) warp_sum[warp] = c;
        __syncthreads();
        for (int w = warp & ~7; w < warp; ++w) c += warp_sum[w];
        __syncthreads();
        if (b < BINS) out[b] = c;
    }
}

template <int ND>
int launch(const uint32_t* keys, int n, int shift, int spine, int* out,
           int* work, int fresh, int gen, cudaStream_t stream)
{
    if (n < 0) return (int)cudaErrorInvalidValue;
    constexpr int SMEM = ND * 256 * 32 * (int)sizeof(int);
    // one block a SM, the SMs read once per device (the caller makes the
    // tensors' device current: _build.Launcher), when the shared memory
    // past 48 KB is asked for
    static int sms[MAX_DEVICES] = {};
    cudaError_t e;
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (sms[dev] == 0
        && ((e = cudaFuncSetAttribute(
                 hist_kernel<ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                 SMEM)) != cudaSuccess
            || (e = cudaDeviceGetAttribute(
                    &sms[dev], cudaDevAttrMultiProcessorCount, dev))
                   != cudaSuccess))
        return (int)e;
    // at least one 16-byte load a thread; one block when there are no keys
    const int want = (int)(((long long)n + 4 * BLOCK - 1) / (4 * BLOCK));
    const int blocks = max(1, min(want, sms[dev]));
    if (fresh && (e = cudaMemsetAsync(work, 0, WORK_WORDS * sizeof(int),
                                      stream)) != cudaSuccess)
        return (int)e;
    hist_kernel<ND><<<blocks, BLOCK, SMEM, stream>>>(keys, n, shift, spine,
                                                      work, gen, out);
    return (int)cudaGetLastError();
}

}  // namespace

// keys: (n,) 32-bit keys; out: (256,) int32: the counts of digit
// (key >> shift) & 255, or with `spine` their inclusive prefix sums.
// work: WORK_WORDS int32 that only launches on this stream use, zero
// unless `fresh` (then zeroed here first) but for the flag, which holds
// the generation of the stream's last launch; gen: this launch's, never
// the last one's.  Returns cudaGetLastError() or the error of the set-up.
extern "C" int rh_digit_histogram(const uint32_t* keys, int n, int shift,
                                  int spine, int* out, int* work, int fresh,
                                  int gen, void* stream)
{
    if (shift < 0 || shift > 24) return (int)cudaErrorInvalidValue;
    return launch<1>(keys, n, shift, spine, out, work, fresh, gen,
                     (cudaStream_t)stream);
}

// All four digits in one read of the keys; out: (4, 256) int32, row d
// counting digit (key >> 8 d) & 255 (with `spine`, its prefix sums).
extern "C" int rh_digit_histograms4(const uint32_t* keys, int n, int spine,
                                    int* out, int* work, int fresh, int gen,
                                    void* stream)
{
    return launch<4>(keys, n, 0, spine, out, work, fresh, gen,
                     (cudaStream_t)stream);
}
