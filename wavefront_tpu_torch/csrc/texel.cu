// Atlas texel fetch for Hopper: nearest/clamp lookup of selected channels.
//
// Replaces the TPU kernel wavefront_tpu/kernels/texel.py::_kernel (called
// by texel_fetch()).  Per ray: clamp the texture slot, turn (u, v) into a
// texel column and row, and copy the selected channels of that texel's
// 12-float row into a channel-major (nch, N) output.  The TPU kernel's
// one-hot matrix product, its 3-term bf16 split of the atlas and its
// log2(size) select tree exist because a TPU kernel cannot gather; here the
// texel is a direct load, exact in float32 by construction.
//
// What bounds it on this card: bytes.  Each ray reads 12 (tex, u, v) and
// writes 4 per channel, 32 at the shade's 8 channels; the atlas
// (T x 16 x 16 x 12 floats, a few hundred KB) stays in L2.  One thread per
// ray: the three input loads and every per-channel store are coalesced
// across the warp, and the only scattered access is the texel row itself.
// The channel loop runs to the compile-time maximum (MAX_CHANNELS, each
// step predicated on the run-time count), so it unrolls and no load of
// the row need wait behind the store of the channel before it; the loop
// to the run-time count took 1.5x the time, and reading the row as 16-byte
// vectors bought nothing over the unrolled loads (PERF.md).
//
// Float-to-int: __float2int_rz saturates and maps NaN to 0, so after the
// clamp a non-finite or huge u or v lands on texel 0 (NaN, negative) or
// size-1 (positive), never out of bounds; kernels/texel.py::texel_plain
// states the same rule in PyTorch.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_CHANNELS = 12;

struct Channels {
    int n;
    int idx[MAX_CHANNELS];
};

__global__ void __launch_bounds__(256) texel_kernel(
    const float* __restrict__ atlas, int n_tex, int size, int row,
    const int* __restrict__ tex, const float* __restrict__ u,
    const float* __restrict__ v, float* __restrict__ out, int n, Channels ch)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float fs = (float)size;
    const int t = min(max(tex[i], 0), n_tex - 1);
    const int ti = min(max(__float2int_rz(u[i] * fs), 0), size - 1);
    const int tj = min(max(__float2int_rz(v[i] * fs), 0), size - 1);
    const float* texel = atlas + ((size_t)(t * size + tj) * size + ti) * row;
#pragma unroll
    for (int k = 0; k < MAX_CHANNELS; ++k)
        if (k < ch.n) out[(size_t)k * n + i] = __ldg(texel + ch.idx[k]);
}

}  // namespace

// atlas: (n_tex, size, size, row) float32; tex/u/v: (n,); out: (nch, n);
// channels: nch indices into a texel row, each in [0, row).  Returns
// cudaGetLastError() (cudaErrorInvalidValue for a bad channel list).
extern "C" int texel_launch(
    const float* atlas, int n_tex, int size, int row, const int* tex,
    const float* u, const float* v, float* out, int n,
    const int* channels, int nch, void* stream)
{
    if (nch < 1 || nch > MAX_CHANNELS || n_tex < 1 || size < 1)
        return (int)cudaErrorInvalidValue;
    Channels ch;
    ch.n = nch;
    for (int k = 0; k < MAX_CHANNELS; ++k) {
        ch.idx[k] = k < nch ? channels[k] : 0;
        if (ch.idx[k] < 0 || ch.idx[k] >= row) return (int)cudaErrorInvalidValue;
    }
    if (n <= 0) return 0;
    const int block = 256;
    texel_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
        atlas, n_tex, size, row, tex, u, v, out, n, ch);
    return (int)cudaGetLastError();
}
