// What the light-BVH kernels share: the node table's index fields, the box
// importance of a node, core/rng.py's murmur3 on uint32, and the size of a
// persistent grid.  Included by nee_sweep.cu (S3's reverse walk),
// light_walk.cu (S4's forward walk) and shade.cu (K2's draws); each source
// builds into a library of its own (kernels/_build.py hashes this header
// into each includer's library name).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// a node table's uint32 index fields come as int64, 0xFFFFFFFF for none
constexpr long long SENTINEL = 0xFFFFFFFFll;

// node k's index field, -1 for none (the sentinel or a negative)
__device__ __forceinline__ int node_index(const long long* a, int k) {
    const long long v = __ldg(a + k);
    return (v == SENTINEL || v < 0) ? -1 : (int)v;
}

// torch.maximum: a NaN on either side gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// nodeImportance (reference raytrace.rs:193-220) of node k, bounds mn, mx
// (M, 3) and power (M,), from point p with normal n: the eight corners
// whose offset along n reaches eps, times power over the squared distance
// to the centre, at least the squared diagonal (wavefront.py::
// aabb_importance, guard off, its float32 operations one for one)
__device__ __forceinline__ float box_importance(
    const float* mn, const float* mx, const float* power, int k, float px,
    float py, float pz, float nx, float ny, float nz, float eps)
{
    const float mnx = __ldg(mn + 3 * k), mny = __ldg(mn + 3 * k + 1),
                mnz = __ldg(mn + 3 * k + 2);
    const float mxx = __ldg(mx + 3 * k), mxy = __ldg(mx + 3 * k + 1),
                mxz = __ldg(mx + 3 * k + 2);
    const float pw = __ldg(power + k);
    const float d0x = (mnx - px) * nx, d1x = (mxx - px) * nx;
    const float d0y = (mny - py) * ny, d1y = (mxy - py) * ny;
    const float d0z = (mnz - pz) * nz, d1z = (mxz - pz) * nz;
    float visible = 0.0f;
#pragma unroll
    for (int ix = 0; ix < 2; ++ix) {
#pragma unroll
        for (int iy = 0; iy < 2; ++iy) {
            const float sxy = (ix ? d1x : d0x) + (iy ? d1y : d0y);
            visible += (sxy + d0z >= eps) ? 1.0f : 0.0f;
            visible += (sxy + d1z >= eps) ? 1.0f : 0.0f;
        }
    }
    const float ex = mxx - mnx, ey = mxy - mny, ez = mxz - mnz;
    const float diag_sq = (ex * ex + ey * ey) + ez * ez;
    const float cx = 0.5f * (mnx + mxx) - px;
    const float cy = 0.5f * (mny + mxy) - py;
    const float cz = 0.5f * (mnz + mxz) - pz;
    const float dist_sq = max_nan(diag_sq, (cx * cx + cy * cy) + cz * cz);
    return pw / dist_sq * (visible * 0.125f);
}

// core/rng.py::combine and finalizef on uint32
__device__ __forceinline__ uint32_t m3_combine(uint32_t h, uint32_t k) {
    h ^= k * 0x1B873593u;
    h = (h << 13) | (h >> 19);
    return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ float m3_finalizef(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return __uint_as_float((h & 0x007FFFFFu) | 0x3F800000u) - 1.0f;
}

// the blocks of `Block` threads of kernel K resident at once on the current
// device, at least 1: a persistent grid's size, read once for each device
// (the caller makes the device current: _build.Launcher)
template <auto K, int Block>
cudaError_t resident_blocks(int* blocks)
{
    constexpr int MAX_DEVICES = 64;
    static int resident[MAX_DEVICES] = {};
    cudaError_t e;
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (resident[dev] == 0) {
        int sms = 0, per_sm = 0;
        if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess)
            return e;
        if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, K, Block, 0)) != cudaSuccess)
            return e;
        resident[dev] = per_sm * sms > 1 ? per_sm * sms : 1;
    }
    *blocks = resident[dev];
    return cudaSuccess;
}
