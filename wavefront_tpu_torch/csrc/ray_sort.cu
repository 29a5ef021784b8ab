// The bounce sort's key and permute for Hopper: one kernel builds each
// ray's 32-bit coherence key, one moves the whole ray state into the
// sorted order.  `torch.sort` orders the keys in between.
//
// Replaces no TPU kernel: the JAX package builds its key
// (wavefront_tpu/kernels/window_trace.py::_coherence_key) and permutes its
// rays with plain jnp ops, which XLA fuses.  In PyTorch's eager mode the
// same key is 57 elementwise ops a bounce on int64 and the permute 13
// gathers, each a launch the host must issue, and each gather reads the
// int64 permutation again.
//
// ray_key_kernel: what bounds it on this card is bytes: 24 in (origin and
// direction, float32) and 4 out a ray, 28 B, 58 MB at 2,073,600 rays, or
// 0.017 ms at 3.35 TB/s.  One thread a ray: six coalesced loads, the key
// in registers, one coalesced store.  It writes the key of
// kernels/window_trace.py::coherence_key shifted right by 5 (its low five
// bits are always 0), as an int32 below 2^27: the dead flag at bit 26,
// the 32^3 window at 17-25, the direction class at 8-16, the fine cell at
// 0-7.  A 32-bit key halves the radix sort's passes, and a stable sort
// of it gives the 64-bit key's permutation.
//
// The arithmetic repeats coherence_key's float32 operations one for one
// (build with -fmad=false): the origin shift o - float(grid_origin), each
// scalar a float32 constant converted from the double PyTorch was given,
// atan2f, a clamp and then truncation toward zero.  A dead ray has all
// three direction components == 0 (so -0.0 is dead).  A NaN quantises to
// 0, as PyTorch's float-to-int conversion does on the card.
//
// ray_permute_kernel: what bounds it is bytes: the int64 permutation read
// once, and each column read at the permuted slot and written in order,
// 112 B a ray for the frame's 13 float32 and int32 columns, or 0.069 ms at
// 2,073,600 rays.  One thread an output slot reads perm[i] once, issues
// every load of its columns before any store, so that the scattered reads
// overlap, then writes each column coalesced.  A scattered read of 4
// bytes still moves a 32-byte sector; the renderer's bounce permutations
// are partly ordered (rays of one window and direction class stay near
// each other), so neighbouring threads mostly share sectors.  Up to 16
// columns of 2 or 4 bytes each, passed by value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_COLUMNS = 16;

struct KeyGrid {
    float gox, goy, goz;   // the grid's world origin
    int nwx, nky, nwz;     // 32-voxel windows along x, y and z
};

struct Columns {
    const void* src[MAX_COLUMNS];
    void* dst[MAX_COLUMNS];
};

// coherence_key's q(v, hi): v.clamp(0, hi) then truncation toward zero
__device__ __forceinline__ int quant(float v, float hi) {
    return __float2int_rz(fminf(fmaxf(v, 0.0f), hi));
}

__global__ void __launch_bounds__(256) ray_key_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    KeyGrid g, int* __restrict__ key, int n)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float x = ox[i] - g.gox, y = oy[i] - g.goy, z = oz[i] - g.goz;
    const float ux = dx[i], uy = dy[i], uz = dz[i];
    const int dead = ux == 0.0f && uy == 0.0f && uz == 0.0f;
    const float cw = 1.0f / 32.0f;
    const int wx = quant(x * cw, (float)(g.nwx - 1));
    const int wy = quant(y * cw, (float)(g.nky - 1));
    const int wz = quant(z * cw, (float)(g.nwz - 1));
    const int win = min((wy * g.nwx + wx) * g.nwz + wz, 511);
    const int dyq = quant((uy + 1.0f) * (float)3.99, 7.0f);
    const int angq = quant((atan2f(uz, ux) + (float)3.1416) * (float)10.14,
                           63.0f);
    const int xq = quant(x * 0.25f, 127.0f) & 7;
    const int yq = quant(y * 0.25f, 127.0f) & 3;
    const int zq = quant(z * 0.25f, 127.0f) & 7;
    key[i] = (dead << 26) | (win << 17) | (dyq << 14) | (angq << 8)
             | (xq << 5) | (zq << 2) | yq;
}

// column k is 4 bytes wide when bit k of `wide` is set, else 2
__global__ void __launch_bounds__(256) ray_permute_kernel(
    const long long* __restrict__ perm, Columns c, int ncol, unsigned wide,
    int n)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long j = perm[i];
    uint32_t v[MAX_COLUMNS];
#pragma unroll
    for (int k = 0; k < MAX_COLUMNS; ++k) {
        if (k < ncol)
            v[k] = (wide >> k) & 1u
                ? __ldg(static_cast<const uint32_t*>(c.src[k]) + j)
                : (uint32_t)__ldg(static_cast<const uint16_t*>(c.src[k]) + j);
    }
#pragma unroll
    for (int k = 0; k < MAX_COLUMNS; ++k) {
        if (k < ncol) {
            if ((wide >> k) & 1u)
                static_cast<uint32_t*>(c.dst[k])[i] = v[k];
            else
                static_cast<uint16_t*>(c.dst[k])[i] = (uint16_t)v[k];
        }
    }
}

}  // namespace

// o*/d*: (n,) float32; go*: the grid's origin; nwx, nky, nwz: its windows
// a side (ceil(g / 32), y of max(gy, 1)); key: (n,) int32.  Returns
// cudaGetLastError().
extern "C" int rs_key(const float* ox, const float* oy, const float* oz,
                      const float* dx, const float* dy, const float* dz,
                      float gox, float goy, float goz, int nwx, int nky,
                      int nwz, int* key, int n, void* stream)
{
    if (nwx < 1 || nky < 1 || nwz < 1) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    const KeyGrid g{gox, goy, goz, nwx, nky, nwz};
    const int block = 256;
    ray_key_kernel<<<(n + block - 1) / block, block, 0,
                     (cudaStream_t)stream>>>(ox, oy, oz, dx, dy, dz, g, key,
                                             n);
    return (int)cudaGetLastError();
}

// perm: (n,) int64, each in [0, n); ptrs: ncol source pointers, then ncol
// destination pointers, each column (n,) of 4 bytes (bit k of `wide` set)
// or 2.  out[k][i] = src[k][perm[i]].  Returns cudaGetLastError().
extern "C" int rs_permute(const long long* perm, const void* const* ptrs,
                          int ncol, unsigned wide, int n, void* stream)
{
    if (ncol < 1 || ncol > MAX_COLUMNS) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    Columns c;
    for (int k = 0; k < MAX_COLUMNS; ++k) {
        c.src[k] = k < ncol ? ptrs[k] : nullptr;
        c.dst[k] = k < ncol ? const_cast<void*>(ptrs[ncol + k]) : nullptr;
    }
    const int block = 256;
    ray_permute_kernel<<<(n + block - 1) / block, block, 0,
                         (cudaStream_t)stream>>>(perm, c, ncol, wide, n);
    return (int)cudaGetLastError();
}
