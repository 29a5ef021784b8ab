// Radix-sort digit histogram for Hopper: 256-bin counts of one 8-bit digit
// of 32-bit keys (and, in one read of the keys, of all four digits).
//
// Replaces the TPU kernel tools/radix_lab.py::hist_kernel (called by
// hist_pass()).  That kernel builds a (256, tile) one-hot of the digit,
// multiplies it by a column of ones on the matrix unit and adds the
// result into one (1, 256) float32 block across a sequential grid.  The
// one-hot product, the float32 counts, the 2048-key tiles and the zero
// padding are the TPU's means; what it computes is the count of keys per
// digit value, and that is what this kernel returns, as int32, with no
// padding.
//
// What bounds it on this card: bytes.  Each key is read once (4 B) and 256
// counts are written; at 2,073,600 keys that is 8.3 MB, 0.0025 ms at the
// card's memory rate.  Blocks run in no order, so nothing is carried from
// one to the next: every warp counts into its own 256-bin histogram in
// shared memory (shared-memory atomics; a private copy per warp keeps
// warps from contending when many keys share a digit, as the renderer's
// coherence keys do), the block sums its warps' copies, and adds each
// non-zero bin to the output with one global atomic.  The adds are
// integer, so the order in which blocks arrive cannot change the result.
// Keys are read 16 bytes a thread where the pointer allows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;

// ND digits per key: digit d is (key >> (shift + 8 d)) & 255 and counts
// into out[d * 256 ...].
template <int ND>
__device__ __forceinline__ void count_key(int* h, uint32_t k, int shift) {
#pragma unroll
    for (int d = 0; d < ND; ++d)
        atomicAdd(&h[d * 256 + ((k >> (shift + 8 * d)) & 255u)], 1);
}

template <int ND>
__global__ void __launch_bounds__(BLOCK) hist_kernel(
    const uint32_t* __restrict__ keys, int n, int shift,
    int* __restrict__ out)
{
    __shared__ int hist[WARPS][ND * 256];
    for (int k = threadIdx.x; k < WARPS * ND * 256; k += BLOCK)
        (&hist[0][0])[k] = 0;
    __syncthreads();
    int* h = hist[threadIdx.x >> 5];

    const int tid = blockIdx.x * BLOCK + threadIdx.x;
    const int nthreads = gridDim.x * BLOCK;
    const bool aligned = (reinterpret_cast<uintptr_t>(keys) & 15u) == 0;
    const int n4 = aligned ? n / 4 : 0;
    const uint4* keys4 = reinterpret_cast<const uint4*>(keys);
    for (int i = tid; i < n4; i += nthreads) {
        const uint4 k = keys4[i];
        count_key<ND>(h, k.x, shift);
        count_key<ND>(h, k.y, shift);
        count_key<ND>(h, k.z, shift);
        count_key<ND>(h, k.w, shift);
    }
    for (int i = n4 * 4 + tid; i < n; i += nthreads)
        count_key<ND>(h, keys[i], shift);
    __syncthreads();

    for (int b = threadIdx.x; b < ND * 256; b += BLOCK) {
        int sum = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += hist[w][b];
        if (sum != 0) atomicAdd(&out[b], sum);
    }
}

int grid_for(int n) {
    // enough blocks to fill 132 SMs several times over, and no more than
    // the keys give 4 vector loads a thread
    const int want = (n + BLOCK * 16 - 1) / (BLOCK * 16);
    return want < 1 ? 1 : (want > 132 * 8 ? 132 * 8 : want);
}

}  // namespace

// keys: (n,) 32-bit keys; out: (256,) int32, zeroed by the caller; counts
// of digit (key >> shift) & 255.  Returns cudaGetLastError().
extern "C" int rh_digit_histogram(const uint32_t* keys, int n, int shift,
                                  int* out, void* stream)
{
    if (shift < 0 || shift > 24) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    hist_kernel<1><<<grid_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
        keys, n, shift, out);
    return (int)cudaGetLastError();
}

// All four digits in one read of the keys; out: (4, 256) int32, zeroed by
// the caller, row d counting digit (key >> 8 d) & 255.
extern "C" int rh_digit_histograms4(const uint32_t* keys, int n, int* out,
                                    void* stream)
{
    if (n <= 0) return 0;
    hist_kernel<4><<<grid_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
        keys, n, 0, out);
    return (int)cudaGetLastError();
}
