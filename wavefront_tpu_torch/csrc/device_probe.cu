// Device probe kernels for Hopper: a dependent add chain, a per-lane row
// gather from a table, and a copy through dynamic shared memory of a
// chosen size.
//
// Replaces the three TPU kernels of tools/tpu_probe.py::micro_suite: `k`
// (called by f_p: 4096 dependent adds of the input), `kg` (called by f_g2:
// acc = sum over k < 64 of t[(i + k) % R, lane], a per-lane sublane
// gather) and `kv` (called by f_v: an (8, 128) copy through a scratch
// buffer of a chosen size, to find the largest the compiler accepts).
// The (8, 128) tiles, the sublane gather instruction and the VMEM scratch
// are the TPU's means; the sums and the copy are the semantics.
//
// What bounds them on this card:
//   loop_add         operations: iters dependent float32 adds per element,
//                    one thread per element.  Built without fast math, so
//                    the compiler may not fold the chain into a multiply;
//                    the addend is loaded at run time.
//   row_gather_sum   cache bandwidth: reps gathers per element, none
//                    depending on another, from an (R, 128) int32 table in
//                    global memory (4 KB to 2 MB: L2-resident), one thread
//                    per element, consecutive lanes on consecutive words.
//   smem_copy        nothing: it exists to ask the launch for `bytes` of
//                    dynamic shared memory (cudaFuncSetAttribute lifts the
//                    48 KB default up to the 227 KB a block may have) and
//                    to prove the far end of it is addressable: the copy
//                    goes through the buffer's last n floats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256) loop_add_kernel(
    const float* __restrict__ x, float* __restrict__ out, int n, int iters)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float v = x[i];
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < iters; ++k) acc = acc + v;
    out[i] = acc;
}

__global__ void __launch_bounds__(256) row_gather_kernel(
    const int* __restrict__ table, const int* __restrict__ idx,
    int* __restrict__ out, int rows, int reps)
{
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= rows * 128) return;
    const int lane = e & 127;
    int r = idx[e] % rows;
    if (r < 0) r += rows;            // floor modulo, as the plain version
    unsigned acc = 0;
    for (int k = 0; k < reps; ++k) {
        acc += (unsigned)table[r * 128 + lane];
        r = r + 1 == rows ? 0 : r + 1;
    }
    out[e] = (int)acc;
}

__global__ void __launch_bounds__(1024) smem_copy_kernel(
    const float* __restrict__ in, float* __restrict__ out, int n, int first)
{
    extern __shared__ float buf[];
    const int t = threadIdx.x;
    if (t < n) buf[first + t] = in[t];
    __syncthreads();
    // each thread reads the word its neighbour wrote, so the value has to
    // pass through shared memory
    const int j = t + 1 == n ? 0 : t + 1;
    if (t < n) out[j] = buf[first + j];
}

}  // namespace

// out[i] = x[i] added to 0.0f `iters` times.  Returns cudaGetLastError().
extern "C" int dp_loop_add(const float* x, float* out, int n, int iters,
                           void* stream)
{
    if (n <= 0) return 0;
    loop_add_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        x, out, n, iters);
    return (int)cudaGetLastError();
}

// table, idx, out: (rows, 128) int32.
// out[i, l] = sum over k < reps of table[(idx[i, l] + k) mod rows, l].
extern "C" int dp_row_gather_sum(const int* table, const int* idx, int* out,
                                 int rows, int reps, void* stream)
{
    if (rows <= 0) return 0;
    const int n = rows * 128;
    row_gather_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        table, idx, out, rows, reps);
    return (int)cudaGetLastError();
}

// Copy n <= 1024 floats through the last n floats of `bytes` of dynamic
// shared memory.  Returns the error of cudaFuncSetAttribute or of the
// launch (0 when both were accepted); a refusal leaves no error pending.
extern "C" int dp_smem_copy(const float* in, float* out, int n, int bytes,
                            void* stream)
{
    if (n < 1 || n > 1024 || bytes < n * 4) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        smem_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
    }
    smem_copy_kernel<<<1, 1024, bytes, (cudaStream_t)stream>>>(
        in, out, n, bytes / 4 - n);
    return (int)cudaGetLastError();
}
